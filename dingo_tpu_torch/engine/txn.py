"""Percolator transactions over the data / lock / write column families
(port of dingo_tpu/engine/txn.py).

Reference: src/engine/txn_engine_helper.{h,cc} (8,439 LoC) — Prewrite
(txn_engine_helper.h:199), Commit (:209), PessimisticLock/Rollback
(:189-195), CheckTxnStatus (:217), ResolveLock (:226), HeartBeat (:235),
BatchRollback, Gc (:243-280), TxnIterator scans. The Percolator model:

  data  CF — key@start_ts   -> user value
  lock  CF — key            -> lock record (lock_ts, primary, op, ttl, ...)
  write CF — key@commit_ts  -> write record (start_ts, op Put/Delete/Rollback)

Conflict checks run leader-side (the service layer in the reference), and
the resulting CF mutations are replicated through raft as one atomic batch
(TxnRaftData -> handler/raft_apply_handler_txn.cc analog in engine/apply.py),
so every replica applies identical bytes.
"""

from __future__ import annotations

import dataclasses
import enum
import time

from dingo_tpu_torch.raft import wire
from typing import Dict, List, Optional, Sequence, Tuple

from dingo_tpu_torch.engine.raw_engine import (
    CF_TXN_DATA,
    CF_TXN_LOCK,
    CF_TXN_WRITE,
    RawEngine,
)
from dingo_tpu_torch.engine.concurrency import ConcurrencyManager
from dingo_tpu_torch.engine.write_data import TxnRaftData
from dingo_tpu_torch.mvcc.codec import MAX_TS, Codec
from dingo_tpu_torch.store.region import Region
from dingo_tpu_torch.trace import TRACER


class TxnError(Exception):
    pass


class KeyIsLocked(TxnError):
    def __init__(self, key: bytes, lock: "LockRecord"):
        super().__init__(f"key {key!r} locked by ts {lock.lock_ts}")
        self.key = key
        self.lock = lock


class WriteConflict(TxnError):
    def __init__(self, key: bytes, start_ts: int, conflict_ts: int):
        super().__init__(
            f"write conflict on {key!r}: start_ts {start_ts} < commit {conflict_ts}"
        )
        self.key = key
        self.conflict_ts = conflict_ts


class TxnNotFound(TxnError):
    pass


class LockTypeMismatch(TxnError):
    pass


class Op(enum.Enum):
    PUT = "put"
    DELETE = "delete"
    LOCK = "lock"               # prewrite of a read-locked key
    PESSIMISTIC = "pessimistic"  # pessimistic pre-lock
    ROLLBACK = "rollback"


@dataclasses.dataclass
class Mutation:
    op: Op
    key: bytes
    value: bytes = b""


@dataclasses.dataclass
class LockRecord:
    lock_ts: int
    primary: bytes
    op: Op
    ttl_ms: int = 3000
    for_update_ts: int = 0
    create_ms: int = 0

    def expired(self, now_ms: Optional[int] = None) -> bool:
        now_ms = now_ms or int(time.time() * 1000)
        return now_ms > self.create_ms + self.ttl_ms


@dataclasses.dataclass
class WriteRecord:
    start_ts: int
    op: Op


def _enc_lock(lock: "LockRecord") -> bytes:
    return wire.encode({
        "lock_ts": lock.lock_ts, "primary": lock.primary,
        "op": lock.op.value, "ttl_ms": lock.ttl_ms,
        "for_update_ts": lock.for_update_ts, "create_ms": lock.create_ms,
    })


def _dec_lock(blob: bytes) -> "LockRecord":
    d = wire.decode(blob)
    return LockRecord(
        lock_ts=d["lock_ts"], primary=d["primary"], op=Op(d["op"]),
        ttl_ms=d["ttl_ms"], for_update_ts=d["for_update_ts"],
        create_ms=d["create_ms"],
    )


def _enc_write(rec: "WriteRecord") -> bytes:
    return wire.encode({"start_ts": rec.start_ts, "op": rec.op.value})


def _dec_write(blob: bytes) -> "WriteRecord":
    d = wire.decode(blob)
    return WriteRecord(start_ts=d["start_ts"], op=Op(d["op"]))


def _lock_key(key: bytes) -> bytes:
    return Codec.encode_bytes(key)


class TxnEngine:
    """Leader-side txn logic; mutations replicate via engine.write()."""

    def __init__(self, engine, region: Region):
        """engine: MonoStoreEngine or RaftStoreEngine."""
        self.engine = engine
        self.raw: RawEngine = engine.raw
        self.region = region
        #: serializes check-then-write critical sections per key
        #: (reference ConcurrencyManager + Latches)
        self.cm = ConcurrencyManager()

    # -- low-level reads ----------------------------------------------------
    def get_lock(self, key: bytes) -> Optional[LockRecord]:
        blob = self.raw.get(CF_TXN_LOCK, _lock_key(key))
        return _dec_lock(blob) if blob else None

    def _writes_desc(self, key: bytes, from_ts: int):
        """Write records for key with commit_ts <= from_ts, newest first."""
        start = Codec.encode_key(key, from_ts)
        end = Codec.encode_key(key, 0)
        for k, v in self.raw.scan(CF_TXN_WRITE, start, end + b"\x00"):
            _, commit_ts = Codec.decode_key(k)
            yield commit_ts, _dec_write(v)

    # -- replicated batch helper -------------------------------------------
    def _apply(self, puts, deletes) -> None:
        self.engine.write(self.region, TxnRaftData(puts=puts, deletes=deletes))

    def _region_range(
        self, start_key: bytes = b"", end_key: bytes = b""
    ) -> Tuple[bytes, Optional[bytes]]:
        """Encoded scan bounds = request range clamped to the REGION's
        range. The txn CFs are shared by every region on the store, so an
        unclamped scan would leak other regions' records into per-region
        RPCs (duplicate ScanLock results, cross-region GC)."""
        rstart = self.region.definition.start_key
        rend = self.region.definition.end_key
        start = max(start_key, rstart) if start_key else rstart
        if end_key and rend:
            end = min(end_key, rend)
        else:
            end = end_key or rend
        return (
            Codec.encode_bytes(start),
            Codec.encode_bytes(end) if end else None,
        )

    # -- Percolator ops ------------------------------------------------------
    def prewrite(
        self,
        mutations: Sequence[Mutation],
        primary: bytes,
        start_ts: int,
        lock_ttl_ms: int = 3000,
        for_update_ts: int = 0,
    ) -> None:
        """TxnEngineHelper::Prewrite (txn_engine_helper.h:199)."""
        with TRACER.start_span("txn.prewrite") as span:
            span.set_attr("mutations", len(mutations))
            with self.cm.with_keys([m.key for m in mutations]):
                self._prewrite_locked(mutations, primary, start_ts,
                                      lock_ttl_ms, for_update_ts)

    def _prewrite_locked(self, mutations, primary, start_ts, lock_ttl_ms,
                         for_update_ts):
        puts, deletes = [], []
        for m in mutations:
            lock = self.get_lock(m.key)
            if lock is not None and lock.lock_ts != start_ts:
                raise KeyIsLocked(m.key, lock)
            if lock is None or lock.op is not Op.PESSIMISTIC:
                # optimistic path: committed-after-start or rollback@start
                for commit_ts, rec in self._writes_desc(m.key, MAX_TS):
                    if rec.op is Op.ROLLBACK and rec.start_ts == start_ts:
                        raise WriteConflict(m.key, start_ts, commit_ts)
                    if commit_ts > start_ts and rec.op is not Op.ROLLBACK:
                        raise WriteConflict(m.key, start_ts, commit_ts)
                    if commit_ts <= start_ts:
                        break
            new_lock = LockRecord(
                lock_ts=start_ts,
                primary=primary,
                op=m.op,
                ttl_ms=lock_ttl_ms,
                for_update_ts=for_update_ts,
                create_ms=int(time.time() * 1000),
            )
            puts.append((CF_TXN_LOCK, _lock_key(m.key), _enc_lock(new_lock)))
            if m.op is Op.PUT:
                puts.append(
                    (CF_TXN_DATA, Codec.encode_key(m.key, start_ts), m.value)
                )
        self._apply(puts, deletes)

    def commit(self, keys: Sequence[bytes], start_ts: int, commit_ts: int) -> None:
        """TxnEngineHelper::Commit (:209)."""
        with TRACER.start_span("txn.commit") as span:
            span.set_attr("keys", len(keys))
            with self.cm.with_keys(keys):
                self._commit_locked(keys, start_ts, commit_ts)

    def _commit_locked(self, keys, start_ts, commit_ts):
        puts, deletes = [], []
        for key in keys:
            lock = self.get_lock(key)
            if lock is None or lock.lock_ts != start_ts:
                # idempotency: already committed or rolled back?
                for cts, rec in self._writes_desc(key, MAX_TS):
                    if rec.start_ts == start_ts:
                        if rec.op is Op.ROLLBACK:
                            raise TxnNotFound(f"txn {start_ts} rolled back")
                        break  # already committed
                else:
                    raise TxnNotFound(f"no lock/write for txn {start_ts}")
                continue
            if lock.op is Op.PESSIMISTIC:
                # never prewritten: there is no data row to expose
                # (reference returns ELOCK_TYPE_MISMATCH; resolve_lock rolls
                # bare pessimistic locks back instead of committing them)
                raise LockTypeMismatch(
                    f"key {key!r} holds a bare pessimistic lock"
                )
            rec = WriteRecord(start_ts=start_ts, op=(
                Op.DELETE if lock.op is Op.DELETE else Op.PUT
            ))
            puts.append((
                CF_TXN_WRITE,
                Codec.encode_key(key, commit_ts),
                _enc_write(rec),
            ))
            deletes.append((CF_TXN_LOCK, _lock_key(key)))
        self._apply(puts, deletes)

    def batch_rollback(self, keys: Sequence[bytes], start_ts: int) -> None:
        """Write rollback tombstones so a late prewrite of this txn fails."""
        with self.cm.with_keys(keys):
            self._batch_rollback_locked(keys, start_ts)

    def _batch_rollback_locked(self, keys, start_ts):
        puts, deletes = [], []
        for key in keys:
            lock = self.get_lock(key)
            if lock is not None and lock.lock_ts == start_ts:
                deletes.append((CF_TXN_LOCK, _lock_key(key)))
                deletes.append((CF_TXN_DATA, Codec.encode_key(key, start_ts)))
            puts.append((
                CF_TXN_WRITE,
                Codec.encode_key(key, start_ts),
                _enc_write(WriteRecord(start_ts=start_ts, op=Op.ROLLBACK)),
            ))
        self._apply(puts, deletes)

    def pessimistic_lock(
        self,
        keys: Sequence[bytes],
        primary: bytes,
        start_ts: int,
        for_update_ts: int,
        ttl_ms: int = 3000,
    ) -> None:
        """TxnEngineHelper::PessimisticLock (:189)."""
        with self.cm.with_keys(keys):
            self._pessimistic_lock_locked(keys, primary, start_ts,
                                          for_update_ts, ttl_ms)

    def _pessimistic_lock_locked(self, keys, primary, start_ts,
                                 for_update_ts, ttl_ms):
        puts = []
        for key in keys:
            lock = self.get_lock(key)
            if lock is not None and lock.lock_ts != start_ts:
                raise KeyIsLocked(key, lock)
            for commit_ts, rec in self._writes_desc(key, MAX_TS):
                if rec.op is Op.ROLLBACK:
                    continue  # keep looking for a real committed write
                if commit_ts > for_update_ts:
                    raise WriteConflict(key, for_update_ts, commit_ts)
                break
            puts.append((
                CF_TXN_LOCK,
                _lock_key(key),
                _enc_lock(LockRecord(
                    lock_ts=start_ts, primary=primary, op=Op.PESSIMISTIC,
                    ttl_ms=ttl_ms, for_update_ts=for_update_ts,
                    create_ms=int(time.time() * 1000),
                )),
            ))
        self._apply(puts, [])

    def pessimistic_rollback(
        self, keys: Sequence[bytes], start_ts: int
    ) -> None:
        deletes = []
        for key in keys:
            lock = self.get_lock(key)
            if lock is not None and lock.lock_ts == start_ts and \
                    lock.op is Op.PESSIMISTIC:
                deletes.append((CF_TXN_LOCK, _lock_key(key)))
        if deletes:
            self._apply([], deletes)

    def check_txn_status(
        self, primary: bytes, lock_ts: int, caller_start_ts: int
    ) -> Dict:
        """TxnEngineHelper::CheckTxnStatus (:217): resolve the fate of a
        possibly-crashed txn via its primary lock."""
        lock = self.get_lock(primary)
        if lock is not None and lock.lock_ts == lock_ts:
            if lock.expired():
                self.batch_rollback([primary], lock_ts)
                return {"action": "rolled_back", "commit_ts": 0}
            return {"action": "locked", "ttl_ms": lock.ttl_ms, "commit_ts": 0}
        for commit_ts, rec in self._writes_desc(primary, MAX_TS):
            if rec.start_ts == lock_ts:
                if rec.op is Op.ROLLBACK:
                    return {"action": "rolled_back", "commit_ts": 0}
                return {"action": "committed", "commit_ts": commit_ts}
        # no lock, no write: the txn never reached the primary
        self.batch_rollback([primary], lock_ts)
        return {"action": "lock_not_exist_rollback", "commit_ts": 0}

    def resolve_lock(
        self,
        start_ts: int,
        commit_ts: int,
        keys: Optional[Sequence[bytes]] = None,
    ) -> int:
        """TxnEngineHelper::ResolveLock (:226): commit (commit_ts > 0) or
        roll back (== 0) leftover locks of txn start_ts."""
        if keys is None:
            keys = []
            for k, blob in self.raw.scan(CF_TXN_LOCK, *self._region_range()):
                lock: LockRecord = _dec_lock(blob)
                if lock.lock_ts == start_ts:
                    keys.append(Codec.decode_bytes(k)[0])
        if not keys:
            return 0
        if commit_ts > 0:
            committable = []
            for key in keys:
                lock = self.get_lock(key)
                if lock is not None and lock.lock_ts == start_ts and \
                        lock.op is Op.PESSIMISTIC:
                    self.pessimistic_rollback([key], start_ts)
                else:
                    committable.append(key)
            if committable:
                self.commit(committable, start_ts, commit_ts)
        else:
            self.batch_rollback(keys, start_ts)
        return len(keys)

    def heart_beat(self, primary: bytes, start_ts: int,
                   advise_ttl_ms: int) -> int:
        """TxnEngineHelper::HeartBeat (:235): extend the primary lock TTL."""
        lock = self.get_lock(primary)
        if lock is None or lock.lock_ts != start_ts:
            raise TxnNotFound(f"no lock for txn {start_ts}")
        lock.ttl_ms = max(lock.ttl_ms, advise_ttl_ms)
        lock.create_ms = int(time.time() * 1000)
        self._apply([(CF_TXN_LOCK, _lock_key(primary), _enc_lock(lock))], [])
        return lock.ttl_ms

    # -- reads ---------------------------------------------------------------
    def get(self, key: bytes, read_ts: int) -> Optional[bytes]:
        """Snapshot-isolated point read."""
        with TRACER.start_span("txn.get"):
            return self._get_impl(key, read_ts)

    def _get_impl(self, key: bytes, read_ts: int) -> Optional[bytes]:
        lock = self.get_lock(key)
        if (
            lock is not None
            and lock.op is not Op.PESSIMISTIC
            and lock.lock_ts <= read_ts
        ):
            raise KeyIsLocked(key, lock)
        for commit_ts, rec in self._writes_desc(key, read_ts):
            if rec.op is Op.PUT:
                return self.raw.get(
                    CF_TXN_DATA, Codec.encode_key(key, rec.start_ts)
                )
            if rec.op is Op.DELETE:
                return None
            # ROLLBACK / LOCK records: keep looking at older versions
        return None

    def scan(
        self, start_key: bytes, end_key: bytes, read_ts: int, limit: int = 0
    ) -> List[Tuple[bytes, bytes]]:
        """Snapshot scan over the write CF (TxnIterator analog)."""
        with TRACER.start_span("txn.scan") as span:
            out = self._scan_impl(start_key, end_key, read_ts, limit)
            span.set_attr("rows", len(out))
            return out

    def _scan_impl(
        self, start_key: bytes, end_key: bytes, read_ts: int, limit: int = 0
    ) -> List[Tuple[bytes, bytes]]:
        out: List[Tuple[bytes, bytes]] = []
        current: Optional[bytes] = None
        resolved = False
        enc_start = Codec.encode_bytes(start_key)
        enc_end = Codec.encode_bytes(end_key) if end_key else None
        # Locks gate the whole range — including keys with no write record
        # yet (a first-write lock must still fail the snapshot scan).
        for k, blob in self.raw.scan(CF_TXN_LOCK, enc_start, enc_end):
            lock: LockRecord = _dec_lock(blob)
            if lock.op is not Op.PESSIMISTIC and lock.lock_ts <= read_ts:
                raise KeyIsLocked(Codec.decode_bytes(k)[0], lock)
        for k, v in self.raw.scan(CF_TXN_WRITE, enc_start, enc_end):
            key, commit_ts = Codec.decode_key(k)
            if key != current:
                current = key
                resolved = False
            if resolved or commit_ts > read_ts:
                continue
            rec: WriteRecord = _dec_write(v)
            if rec.op is Op.PUT:
                value = self.raw.get(
                    CF_TXN_DATA, Codec.encode_key(key, rec.start_ts)
                )
                out.append((key, value if value is not None else b""))
                resolved = True
                if limit and len(out) >= limit:
                    break
            elif rec.op is Op.DELETE:
                resolved = True
            # ROLLBACK: continue scanning older versions of this key
        return out

    def scan_lock(
        self,
        start_key: bytes = b"",
        end_key: bytes = b"",
        max_ts: int = MAX_TS,
        limit: int = 0,
    ) -> List[Tuple[bytes, "LockRecord"]]:
        """TxnEngineHelper::ScanLockInfo (store_service.h TxnScanLock):
        leftover locks in [start_key, end_key) with lock_ts <= max_ts —
        the orphan-lock discovery primitive ResolveLock clients use."""
        out: List[Tuple[bytes, LockRecord]] = []
        enc_start, enc_end = self._region_range(start_key, end_key)
        for k, blob in self.raw.scan(CF_TXN_LOCK, enc_start, enc_end):
            lock = _dec_lock(blob)
            if lock.lock_ts > max_ts:
                continue
            out.append((Codec.decode_bytes(k)[0], lock))
            if limit and len(out) >= limit:
                break
        return out

    def batch_get(
        self, keys: Sequence[bytes], read_ts: int
    ) -> List[Tuple[bytes, Optional[bytes]]]:
        """TxnBatchGet: snapshot point reads; raises KeyIsLocked like get."""
        return [(key, self.get(key, read_ts)) for key in keys]

    def check_secondary_locks(
        self, keys: Sequence[bytes], start_ts: int
    ) -> Dict:
        """TxnCheckSecondaryLocks (store_service.h): async-commit support —
        report the state of txn start_ts's secondary keys on this region.
        Returns {"locks": [(key, LockRecord)...], "commit_ts": N} where
        commit_ts > 0 means some key already committed at that ts, and a
        key with neither lock nor write means the txn was rolled back
        (reported in "missing")."""
        locks: List[Tuple[bytes, LockRecord]] = []
        missing: List[bytes] = []
        commit_ts = 0
        for key in keys:
            lock = self.get_lock(key)
            if lock is not None and lock.lock_ts == start_ts:
                locks.append((key, lock))
                continue
            found = False
            for cts, rec in self._writes_desc(key, MAX_TS):
                if rec.start_ts == start_ts:
                    found = True
                    if rec.op is not Op.ROLLBACK:
                        commit_ts = max(commit_ts, cts)
                    break
            if not found:
                missing.append(key)
        return {"locks": locks, "commit_ts": commit_ts, "missing": missing}

    def delete_range(self, start_key: bytes, end_key: bytes) -> None:
        """TxnDeleteRange (admin op): physically drop [start_key, end_key)
        from all three txn CFs — bypasses MVCC, replicated like any write."""
        enc_start, enc_end = self._region_range(start_key, end_key)
        deletes = []
        for cf in (CF_TXN_DATA, CF_TXN_LOCK, CF_TXN_WRITE):
            for k, _ in self.raw.scan(cf, enc_start, enc_end):
                deletes.append((cf, k))
        if deletes:
            self._apply([], deletes)

    def dump(
        self, start_key: bytes = b"", end_key: bytes = b"", limit: int = 0
    ) -> Dict:
        """TxnDump (debug): raw contents of the three txn CFs in a range."""
        enc_start, enc_end = self._region_range(start_key, end_key)
        out: Dict = {"locks": [], "writes": [], "datas": []}
        for k, blob in self.raw.scan(CF_TXN_LOCK, enc_start, enc_end):
            lock = _dec_lock(blob)
            out["locks"].append({
                "key": Codec.decode_bytes(k)[0], "lock_ts": lock.lock_ts,
                "primary": lock.primary, "op": lock.op.value,
                "ttl_ms": lock.ttl_ms, "for_update_ts": lock.for_update_ts,
            })
            if limit and len(out["locks"]) >= limit:
                break
        for k, v in self.raw.scan(CF_TXN_WRITE, enc_start, enc_end):
            key, commit_ts = Codec.decode_key(k)
            rec = _dec_write(v)
            out["writes"].append({
                "key": key, "commit_ts": commit_ts,
                "start_ts": rec.start_ts, "op": rec.op.value,
            })
            if limit and len(out["writes"]) >= limit:
                break
        for k, v in self.raw.scan(CF_TXN_DATA, enc_start, enc_end):
            key, start_ts = Codec.decode_key(k)
            out["datas"].append({
                "key": key, "start_ts": start_ts, "value": v,
            })
            if limit and len(out["datas"]) >= limit:
                break
        return out

    # -- GC -------------------------------------------------------------------
    def gc(self, safe_ts: int) -> int:
        """TxnEngineHelper::Gc / DoGcCoreTxn (:243-280): for each key keep
        the newest write <= safe_ts (unless DELETE), drop older versions,
        rollback records, and orphaned data rows."""
        doomed_writes: List[bytes] = []
        doomed_data: List[bytes] = []
        current: Optional[bytes] = None
        kept_newest = False
        for k, v in self.raw.scan(CF_TXN_WRITE, *self._region_range()):
            key, commit_ts = Codec.decode_key(k)
            if key != current:
                current = key
                kept_newest = False
            rec: WriteRecord = _dec_write(v)
            if commit_ts > safe_ts:
                continue
            if rec.op is Op.ROLLBACK:
                doomed_writes.append(k)
                continue
            if not kept_newest:
                kept_newest = True
                if rec.op is Op.DELETE:
                    # a delete at/below the safe point hides the key entirely
                    doomed_writes.append(k)
                continue
            doomed_writes.append(k)
            if rec.op is Op.PUT:
                doomed_data.append(Codec.encode_key(key, rec.start_ts))
        deletes = [(CF_TXN_WRITE, k) for k in doomed_writes]
        deletes += [(CF_TXN_DATA, k) for k in doomed_data]
        if deletes:
            self._apply([], deletes)
        return len(deletes)
