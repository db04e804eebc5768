"""GC safe point management (port of
dingo_tpu/engine/gc.py).

Reference: src/engine/gc_safe_point.{h,cc} (gc_safe_point.h:28-92) +
gc_task_tracker — the coordinator computes and pushes a GC safe timestamp
(per tenant); stores run MVCC GC below it (TxnEngineHelper::Gc +
DoGcCoreNonTxn for plain versioned keys).
"""

from __future__ import annotations

import threading
from typing import Dict

from dingo_tpu_torch.engine.raw_engine import (
    CF_DEFAULT,
    CF_VECTOR_SCALAR,
    RawEngine,
    WriteBatch,
)
from dingo_tpu_torch.mvcc.codec import Codec, ValueFlag


class GCSafePointManager:
    def __init__(self):
        self._lock = threading.Lock()
        self._safe_ts: Dict[int, int] = {0: 0}   # tenant -> safe ts
        self.gc_stopped = False

    def update(self, safe_ts: int, tenant: int = 0) -> None:
        """Coordinator push (only moves forward)."""
        with self._lock:
            self._safe_ts[tenant] = max(self._safe_ts.get(tenant, 0), safe_ts)

    def get(self, tenant: int = 0) -> int:
        with self._lock:
            return self._safe_ts.get(tenant, 0)

    def gc_non_txn(self, engine: RawEngine, tenant: int = 0,
                   cfs=(CF_DEFAULT, CF_VECTOR_SCALAR)) -> int:
        """DoGcCoreNonTxn: for each user key keep only the newest version at
        or below the safe point (drop it too if it is a delete tombstone);
        versions above the safe point are untouched."""
        safe_ts = self.get(tenant)
        if safe_ts == 0 or self.gc_stopped:
            return 0
        removed = 0
        for cf in cfs:
            doomed = []
            current = None
            kept_newest = False
            for k, v in engine.scan(cf):
                try:
                    user_key, ts = Codec.decode_key(k)
                except ValueError:
                    continue
                if user_key != current:
                    current = user_key
                    kept_newest = False
                if ts > safe_ts:
                    continue
                flag, _, _ = Codec.unpackage_value(v)
                if not kept_newest:
                    kept_newest = True
                    if flag is ValueFlag.DELETE:
                        doomed.append(k)   # fully dead below the safe point
                    continue
                doomed.append(k)
            if doomed:
                batch = WriteBatch()
                for k in doomed:
                    batch.delete(cf, k)
                engine.write(batch)
                removed += len(doomed)
        return removed
