"""Region runtime object + store meta manager (port of
dingo_tpu/store/region.py).

Reference: store::Region (src/meta/store_meta_manager.h:57 — definition,
epoch, range, state, vector/document index wrappers) and StoreRegionMeta
persisted via TransformKvAble into the meta CF (:428). RegionChangeRecorder
(:259) keeps an audit trail of state transitions.

A region builds its vector index on the device it is given (``device``
None = the CUDA device; DeviceUnavailable without one). A DOCUMENT
region holds a host DocumentIndex.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
import time
from typing import Dict, List, Optional, Tuple

from dingo_tpu_torch.common import persist
from dingo_tpu_torch.common.device import resolve_device
from dingo_tpu_torch.engine.raw_engine import CF_META, RawEngine
from dingo_tpu_torch.index import codec as vcodec
from dingo_tpu_torch.index.base import IndexParameter, IndexType
from dingo_tpu_torch.index.wrapper import VectorIndexWrapper
from dingo_tpu_torch.ops.distance import Metric

# typed persistence: only registered types deserialize (common/persist.py)
persist.register(IndexParameter)
persist.register(IndexType)
persist.register(Metric)


@persist.register
class RegionState(enum.Enum):
    """pb::common::StoreRegionState."""

    NEW = "new"
    NORMAL = "normal"
    STANDBY = "standby"     # split child before switch
    SPLITTING = "splitting"
    MERGING = "merging"
    DELETING = "deleting"
    DELETED = "deleted"
    ORPHAN = "orphan"
    TOMBSTONE = "tombstone"


@persist.register
class RegionType(enum.Enum):
    STORE = "store"
    INDEX = "index"
    DOCUMENT = "document"


@persist.register
@dataclasses.dataclass
class RegionEpoch:
    """pb::common::RegionEpoch: conf_version bumps on peer changes,
    version bumps on range changes (split/merge)."""

    conf_version: int = 1
    version: int = 1

    def as_tuple(self) -> Tuple[int, int]:
        return (self.conf_version, self.version)


@persist.register
@dataclasses.dataclass
class RegionDefinition:
    """pb::common::RegionDefinition subset."""

    region_id: int
    start_key: bytes
    end_key: bytes
    partition_id: int = 0
    peers: List[int] = dataclasses.field(default_factory=list)  # store ids
    epoch: RegionEpoch = dataclasses.field(default_factory=RegionEpoch)
    region_type: RegionType = RegionType.STORE
    index_parameter: Optional[IndexParameter] = None
    #: DOCUMENT regions: column name -> type ("text"/"i64"/"f64"/"bytes"/
    #: "bool") — validated on add, backs range/eq predicates
    document_schema: Optional[Dict[str, str]] = None


class Region:
    """store::Region (store_meta_manager.h:57)."""

    def __init__(self, definition: RegionDefinition, device=None):
        self._lock = threading.RLock()
        self.device = resolve_device(device)
        self.definition = definition
        self.state = RegionState.NEW
        self.leader_store_id = 0
        self.vector_index_wrapper: Optional[VectorIndexWrapper] = None
        self.document_index = None   # DocumentIndex for DOCUMENT regions
        if definition.region_type is RegionType.INDEX:
            assert definition.index_parameter is not None
            self.vector_index_wrapper = VectorIndexWrapper(
                definition.region_id, definition.index_parameter,
                device=self.device,
            )
        elif definition.region_type is RegionType.DOCUMENT:
            from dingo_tpu_torch.document import DocumentIndex

            self.document_index = DocumentIndex(
                definition.region_id, schema=definition.document_schema)
        self.change_log: List[Tuple[float, str]] = []  # RegionChangeRecorder

    @property
    def id(self) -> int:
        return self.definition.region_id

    @property
    def range(self) -> Tuple[bytes, bytes]:
        return (self.definition.start_key, self.definition.end_key)

    @property
    def epoch(self) -> RegionEpoch:
        return self.definition.epoch

    def set_state(self, state: RegionState, reason: str = "") -> None:
        with self._lock:
            self.state = state
            self.change_log.append(
                (time.time(), f"{state.value}: {reason}")
            )

    def contains_key(self, key: bytes) -> bool:
        s, e = self.range
        return s <= key and (not e or key < e)

    def id_window(self) -> Tuple[int, int]:
        return vcodec.range_to_vector_ids(*self.range)

    def serialize(self) -> bytes:
        return persist.dumps(
            {"definition": self.definition, "state": self.state}
        )

    @classmethod
    def deserialize(cls, blob: bytes, device=None) -> "Region":
        d = persist.loads(blob)
        region = cls(d["definition"], device=device)
        region.state = d["state"]
        return region


_META_REGION_PREFIX = b"META_REGION_"


class StoreMetaManager:
    """Region registry persisted in the meta CF (StoreRegionMeta).

    Recovery order note: the reference initializes VectorIndexManager before
    StoreMetaManager because region recovery may trigger index loads
    (main.cc:1074-1076); our recover() takes the index manager callback for
    the same reason."""

    def __init__(self, engine: RawEngine, device=None):
        self._engine = engine
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        self._regions: Dict[int, Region] = {}

    def add_region(self, region: Region) -> None:
        with self._lock:
            self._regions[region.id] = region
            self._persist(region)

    def update_region(self, region: Region) -> None:
        with self._lock:
            self._persist(region)

    def delete_region(self, region_id: int) -> None:
        with self._lock:
            self._regions.pop(region_id, None)
            self._engine.delete(
                CF_META, _META_REGION_PREFIX + str(region_id).encode()
            )

    def get_region(self, region_id: int) -> Optional[Region]:
        with self._lock:
            return self._regions.get(region_id)

    def get_all_regions(self) -> List[Region]:
        with self._lock:
            return list(self._regions.values())

    def _persist(self, region: Region) -> None:
        self._engine.put(
            CF_META,
            _META_REGION_PREFIX + str(region.id).encode(),
            region.serialize(),
        )

    def recover(self) -> int:
        """Reload regions from the meta CF after restart."""
        n = 0
        for key, blob in self._engine.scan(
            CF_META, _META_REGION_PREFIX, _META_REGION_PREFIX + b"\xff"
        ):
            region = Region.deserialize(blob, device=self.device)
            with self._lock:
                self._regions[region.id] = region
            n += 1
        return n
