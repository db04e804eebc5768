"""MVCC reader: version resolution at a read timestamp
(port of dingo_tpu/mvcc/reader.py).

Reference: mvcc::Reader (src/mvcc/reader.h:29) + mvcc::Iterator — reads scan
the encoded keyspace where versions of one user key are adjacent (newest
first thanks to the inverted ts suffix), pick the first version <= read_ts,
and honor value flags (kDelete hides the key; kPutTTL hides it after expiry).
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from dingo_tpu_torch.engine.raw_engine import RawEngine
from dingo_tpu_torch.mvcc.codec import Codec, ValueFlag


def _now_ms() -> int:
    return int(time.time() * 1000)


class Reader:
    def __init__(self, engine: RawEngine, cf: str):
        self.engine = engine
        self.cf = cf

    def kv_get(self, user_key: bytes, ts: int) -> Optional[bytes]:
        """Newest visible version at `ts` (reader.h KvGet)."""
        start = Codec.encode_key(user_key, ts)       # versions <= ts
        end = Codec.encode_key(user_key, 0)          # oldest version
        for k, v in self.engine.scan(self.cf, start, end + b"\x00"):
            flag, payload, ttl = Codec.unpackage_value(v)
            if flag is ValueFlag.DELETE:
                return None
            if flag is ValueFlag.PUT_TTL and ttl <= _now_ms():
                return None
            return payload
        return None

    def kv_scan(
        self,
        start_key: bytes,
        end_key: bytes,
        ts: int,
        limit: int = 0,
        keys_only: bool = False,
    ) -> List[Tuple[bytes, bytes]]:
        """Visible (user_key, value) pairs in [start_key, end_key)."""
        out: List[Tuple[bytes, bytes]] = []
        for uk, payload in self.iter_visible(start_key, end_key, ts):
            out.append((uk, b"" if keys_only else payload))
            if limit and len(out) >= limit:
                break
        return out

    def iter_visible(
        self, start_key: bytes, end_key: bytes, ts: int
    ) -> Iterator[Tuple[bytes, bytes]]:
        """Iterate newest-visible versions, skipping deletes/expired TTLs
        (mvcc::Iterator semantics)."""
        enc_start = Codec.encode_bytes(start_key)
        enc_end = Codec.encode_bytes(end_key) if end_key else None
        current: Optional[bytes] = None
        decode_key = Codec.decode_key
        unpackage = Codec.unpackage_value
        for k, v in self.engine.scan(self.cf, enc_start, enc_end):
            try:
                uk, kts = decode_key(k)
            except ValueError:
                continue
            if uk == current:
                continue  # older version of a key we've already resolved
            if kts > ts:
                continue  # too new; a later (older-ts) row may be visible
            current = uk
            flag, payload, ttl = unpackage(v)
            if flag is ValueFlag.DELETE:
                continue
            if flag is ValueFlag.PUT_TTL and ttl <= _now_ms():
                continue
            yield uk, payload

    def kv_count(self, start_key: bytes, end_key: bytes, ts: int) -> int:
        return sum(1 for _ in self.iter_visible(start_key, end_key, ts))

    #: batch-get window heuristic: one range scan when the covering window
    #: holds at most this many engine rows per requested key (+ slack)
    _BATCH_SCAN_FACTOR = 4

    def kv_batch_get(
        self, user_keys: Iterable[bytes], ts: int
    ) -> Dict[bytes, Optional[bytes]]:
        """Multi-get: newest visible version for many keys in one call
        (rocksdb MultiGet analog). Dense key sets resolve with a single
        range scan over the covering window (one engine iterator instead
        of an N+1 per-key loop — the VectorReader backfill pattern);
        sparse sets fall back to per-key point lookups so a handful of
        scattered ids can't trigger a whole-region walk. The density test
        uses the engine's O(log n) row count for the window."""
        uniq = sorted(set(user_keys))
        out: Dict[bytes, Optional[bytes]] = {k: None for k in uniq}
        if not uniq:
            return out
        end = uniq[-1] + b"\x00"     # immediate successor: inclusive last
        try:
            window_rows = self.engine.count(
                self.cf,
                Codec.encode_bytes(uniq[0]),
                Codec.encode_bytes(end),
            )
        except Exception:  # noqa: BLE001 — engines without cheap count
            window_rows = None
        budget = self._BATCH_SCAN_FACTOR * len(uniq) + 64
        if window_rows is not None and window_rows <= budget:
            wanted = set(uniq)
            for uk, payload in self.iter_visible(uniq[0], end, ts):
                if uk in wanted:
                    out[uk] = payload
            return out
        for k in uniq:
            out[k] = self.kv_get(k, ts)
        return out


class Writer:
    """Versioned writes (the non-txn KvPut path: storage.cc stamps a TSO ts
    and appends a new version; deletes write tombstone versions)."""

    def __init__(self, engine: RawEngine, cf: str):
        self.engine = engine
        self.cf = cf

    def kv_put(self, user_key: bytes, value: bytes, ts: int,
               ttl_ms: int = 0) -> None:
        flag = ValueFlag.PUT_TTL if ttl_ms else ValueFlag.PUT
        self.engine.put(
            self.cf,
            Codec.encode_key(user_key, ts),
            Codec.package_value(value, flag, ttl_ms),
        )

    def kv_delete(self, user_key: bytes, ts: int) -> None:
        self.engine.put(
            self.cf,
            Codec.encode_key(user_key, ts),
            Codec.package_value(b"", ValueFlag.DELETE),
        )
