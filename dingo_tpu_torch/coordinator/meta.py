"""Schema / table / index metadata layer on the coordinator (port of
dingo_tpu/coordinator/meta.py).

Reference: CoordinatorControl's schema+table meta and MetaService RPCs
(src/coordinator/coordinator_control.h:187 schema/table state;
src/server/meta_service.cc CreateTable/DropTable/GetTables/...). The
reference seeds default schemas (root/meta/dingo) and stores table
definitions whose partitions map to regions; the SDK then speaks in
tables rather than raw regions.

Here a table is a named definition whose partitions each own one region:
vector/document partitions own an id-window region (vector key codec),
plain TABLE partitions own a raw key-range region. Region placement,
replication, split/merge stay CoordinatorControl's job — dropping a table
drops its regions.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Tuple

from dingo_tpu_torch.common import persist
from dingo_tpu_torch.coordinator.control import CoordinatorControl
from dingo_tpu_torch.engine.raw_engine import CF_META, RawEngine
from dingo_tpu_torch.index import codec as vcodec
from dingo_tpu_torch.index.base import IndexParameter
from dingo_tpu_torch.raft import wire
from dingo_tpu_torch.store.region import RegionType

_PREFIX_SCHEMA = b"meta/schema/"
_PREFIX_TABLE = b"meta/table/"
_KEY_TABLE_ID = b"meta/next_table_id"
_KEY_META_REV = b"meta/revision"

#: in-memory meta-event ring size; watchers older than the ring get a
#: resync signal instead of replay (meta churn is low, 1024 is ~forever)
_EVENT_RING = 1024

#: reference's built-in schemas (coordinator seeds root/meta/dingo)
DEFAULT_SCHEMAS = ("root", "meta", "dingo")


class MetaError(RuntimeError):
    pass


class MetaExistsError(MetaError):
    """Name collision (schema/table already registered). Distinct class so
    idempotent callers (BR restore re-runs) can skip collisions without
    string-matching — every other MetaError stays fatal for them."""


@persist.register
@dataclasses.dataclass
class ColumnDefinition:
    name: str
    sql_type: str = "VARCHAR"
    nullable: bool = True
    primary: bool = False


@persist.register
@dataclasses.dataclass
class PartitionDefinition:
    partition_id: int
    #: vector/document partitions: [id_lo, id_hi) vector-id window
    id_lo: int = 0
    id_hi: int = 0
    #: plain TABLE partitions: raw key range
    start_key: bytes = b""
    end_key: bytes = b""
    region_id: int = 0


@persist.register
@dataclasses.dataclass
class TableDefinition:
    table_id: int
    schema_name: str
    name: str
    table_type: RegionType = RegionType.STORE
    columns: List[ColumnDefinition] = dataclasses.field(default_factory=list)
    partitions: List[PartitionDefinition] = dataclasses.field(
        default_factory=list
    )
    index_parameter: Optional[IndexParameter] = None
    replication: int = 0


class MetaControl:
    """Schema/table registry persisted in the coordinator's meta CF."""

    def __init__(self, engine: RawEngine, control: CoordinatorControl):
        self.engine = engine
        self.control = control
        self._lock = threading.Lock()
        self.schemas: Dict[str, List[str]] = {}     # schema -> table names
        self.tables: Dict[str, TableDefinition] = {}  # "schema.table" -> def
        self._creating: set = set()   # names reserved by in-flight creates
        self._next_table_id = 1
        #: meta-watch state (reference meta-watch RPCs + crontab entry,
        #: src/server/meta_service.cc; server.cc:506-700): change events
        #: carry a monotonic meta revision so SDK caches can invalidate
        #: without polling. The ring is memory-only — a restarted
        #: coordinator replays nothing and watchers resync.
        self._meta_revision = 1
        self._events: List[dict] = []
        self._watchers: List[Tuple[int, Callable[[dict], None]]] = []
        self._recover()
        for s in DEFAULT_SCHEMAS:
            if s not in self.schemas:
                self._put_schema(s)

    # -- persistence ---------------------------------------------------------
    def _recover(self) -> None:
        blob = self.engine.get(CF_META, _KEY_TABLE_ID)
        if blob:
            self._next_table_id = wire.decode(blob)
        blob = self.engine.get(CF_META, _KEY_META_REV)
        if blob:
            # revision survives restart (monotonic); the event ring does
            # not — watchers from pre-restart revisions get a resync
            self._meta_revision = wire.decode(blob)
        for k, v in self.engine.scan(CF_META, _PREFIX_SCHEMA,
                                     _PREFIX_SCHEMA + b"\xff"):
            self.schemas[wire.decode(v)] = []
        for k, v in self.engine.scan(CF_META, _PREFIX_TABLE,
                                     _PREFIX_TABLE + b"\xff"):
            t = persist.loads(v)
            self.tables[f"{t.schema_name}.{t.name}"] = t
            self.schemas.setdefault(t.schema_name, []).append(t.name)

    def _put_schema(self, name: str) -> None:
        self.schemas[name] = self.schemas.get(name, [])
        self.engine.put(CF_META, _PREFIX_SCHEMA + name.encode(),
                        wire.encode(name))

    def _put_table(self, t: TableDefinition) -> None:
        self.engine.put(
            CF_META, _PREFIX_TABLE + str(t.table_id).encode(),
            persist.dumps(t),
        )

    # -- schemas -------------------------------------------------------------
    def create_schema(self, name: str) -> None:
        if not name:
            raise MetaError("empty schema name")
        with self._lock:
            if name in self.schemas:
                raise MetaExistsError(f"schema {name!r} exists")
            self._put_schema(name)
            self._emit("create_schema", name)

    def drop_schema(self, name: str) -> None:
        with self._lock:
            if name not in self.schemas:
                raise MetaError(f"schema {name!r} not found")
            in_flight = any(k.startswith(name + ".") for k in self._creating)
            if self.schemas[name] or in_flight:
                raise MetaError(f"schema {name!r} not empty")
            if name in DEFAULT_SCHEMAS:
                raise MetaError(f"schema {name!r} is built-in")
            del self.schemas[name]
            self.engine.delete(CF_META, _PREFIX_SCHEMA + name.encode())
            self._emit("drop_schema", name)

    def get_schemas(self) -> List[str]:
        with self._lock:
            return sorted(self.schemas)

    # -- tables --------------------------------------------------------------
    def create_table(
        self,
        schema_name: str,
        name: str,
        partitions: List[PartitionDefinition],
        columns: Optional[List[ColumnDefinition]] = None,
        index_parameter: Optional[IndexParameter] = None,
        table_type: Optional[RegionType] = None,
        replication: int = 0,
    ) -> TableDefinition:
        """CreateTable (meta_service.cc): allocate the table id, create one
        region per partition, persist the definition."""
        if table_type is None:
            table_type = (
                RegionType.INDEX if index_parameter is not None
                else RegionType.STORE
            )
        key = f"{schema_name}.{name}"
        with self._lock:
            if schema_name not in self.schemas:
                raise MetaError(f"schema {schema_name!r} not found")
            if key in self.tables or key in self._creating:
                raise MetaExistsError(f"table {key} exists")
            if not partitions:
                raise MetaError("table needs >= 1 partition")
            # reserve the name: region creation below runs outside the lock
            # (it is slow), and a concurrent same-name create must fail now
            self._creating.add(key)
            table_id = self._next_table_id
            self._next_table_id += 1
            self.engine.put(CF_META, _KEY_TABLE_ID,
                            wire.encode(self._next_table_id))
        created = []
        try:
            for p in partitions:
                if table_type in (RegionType.INDEX, RegionType.DOCUMENT):
                    start = vcodec.encode_vector_key(p.partition_id, p.id_lo)
                    end = vcodec.encode_vector_key(p.partition_id, p.id_hi)
                else:
                    start, end = p.start_key, p.end_key
                # overlap rejection happens inside create_region (under
                # the control lock, so concurrent creates cannot race it)
                d = self.control.create_region(
                    start, end,
                    partition_id=p.partition_id,
                    region_type=table_type,
                    index_parameter=index_parameter,
                    replication=replication or None,
                )
                p.region_id = d.region_id
                created.append(d.region_id)
        except Exception:
            for rid in created:
                self.control.drop_region(rid)
            with self._lock:
                self._creating.discard(key)
            raise
        t = TableDefinition(
            table_id=table_id,
            schema_name=schema_name,
            name=name,
            table_type=table_type,
            columns=columns or [],
            partitions=partitions,
            index_parameter=index_parameter,
            replication=replication,
        )
        with self._lock:
            self._creating.discard(key)
            self.tables[key] = t
            self.schemas[schema_name].append(name)
            self._put_table(t)
            self._emit("create_table", schema_name, name, t.table_id)
        return t

    def import_table(self, t: TableDefinition) -> TableDefinition:
        """Register an externally built definition (restore path): assigns
        a fresh table id, persists the id counter and the definition under
        the same invariants create_table maintains. Partition region ids
        must already point at live regions."""
        key = f"{t.schema_name}.{t.name}"
        with self._lock:
            if t.schema_name not in self.schemas:
                self._put_schema(t.schema_name)
            if key in self.tables or key in self._creating:
                raise MetaExistsError(f"table {key} exists")
            t.table_id = self._next_table_id
            self._next_table_id += 1
            self.engine.put(CF_META, _KEY_TABLE_ID,
                            wire.encode(self._next_table_id))
            self.tables[key] = t
            self.schemas[t.schema_name].append(t.name)
            self._put_table(t)
            self._emit("create_table", t.schema_name, t.name, t.table_id)
        return t

    def drop_table(self, schema_name: str, name: str) -> None:
        key = f"{schema_name}.{name}"
        with self._lock:
            t = self.tables.get(key)
            if t is None:
                raise MetaError(f"table {key} not found")
            del self.tables[key]
            self.schemas[schema_name].remove(name)
            self.engine.delete(
                CF_META, _PREFIX_TABLE + str(t.table_id).encode()
            )
            self._emit("drop_table", schema_name, name, t.table_id)
        for p in t.partitions:
            self.control.drop_region(p.region_id)

    def get_table(self, schema_name: str, name: str) -> Optional[TableDefinition]:
        with self._lock:
            return self.tables.get(f"{schema_name}.{name}")

    def get_tables(self, schema_name: str) -> List[TableDefinition]:
        with self._lock:
            return [t for t in self.tables.values()
                    if t.schema_name == schema_name]

    # -- meta watch (meta_service.cc meta-watch analog) ----------------------
    @property
    def meta_revision(self) -> int:
        with self._lock:
            return self._meta_revision

    def _emit(self, event: str, schema: str, table: str = "",
              table_id: int = 0) -> None:
        """Record + fan out one change event. Caller holds self._lock."""
        self._meta_revision += 1
        self.engine.put(CF_META, _KEY_META_REV,
                        wire.encode(self._meta_revision))
        ev = {
            "event": event,
            "schema": schema,
            "table": table,
            "table_id": table_id,
            "revision": self._meta_revision,
        }
        self._events.append(ev)
        if len(self._events) > _EVENT_RING:
            del self._events[: len(self._events) - _EVENT_RING]
        still_waiting = []
        for start, cb in self._watchers:
            if ev["revision"] >= start:
                try:
                    cb(ev)
                except Exception:
                    pass
            else:
                still_waiting.append((start, cb))
        self._watchers = still_waiting

    def watch(self, start_revision: int,
              callback: Callable[[dict], None]) -> None:
        """One-time meta watch: fires with the OLDEST event at/after
        start_revision (replayed from the ring when already past), a
        {"event": "resync"} signal when that history is gone (restart or
        ring overflow — re-list and watch from the current revision), or
        registers for the next future event."""
        with self._lock:
            if start_revision <= self._meta_revision:
                # replay only when the ring still covers [start, now] —
                # revisions are contiguous, so a first retained event
                # above start means events were evicted (or predate this
                # process) and a partial replay would silently lose them
                if self._events and \
                        self._events[0]["revision"] <= start_revision:
                    for ev in self._events:
                        if ev["revision"] >= start_revision:
                            callback(ev)
                            return
                callback({
                    "event": "resync",
                    "schema": "",
                    "table": "",
                    "table_id": 0,
                    "revision": self._meta_revision,
                })
                return
            self._watchers.append((start_revision, callback))

    def cancel_watch(self, callback: Callable) -> bool:
        with self._lock:
            for pair in self._watchers:
                if pair[1] is callback:
                    self._watchers.remove(pair)
                    return True
            return False
