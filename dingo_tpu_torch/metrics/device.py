"""Device memory accounting (port of dingo_tpu/metrics/device.py).

Two views, both best-effort and safe without a card:

- device_memory_stats(): process-level figures from the caching
  allocator (``torch.cuda.memory_stats``: bytes in use, the card's total,
  the peak), summed over the visible cards. Without a card: zeros, never
  an exception.
- live_device_bytes_by_owner(pairs): the bytes of the distinct tensor
  storages reachable from an index, per owner, through
  ``index/base.py::tensor_bytes`` (the walk enters only the port's own
  objects and plain containers, so an engine holding the keyspace as
  Python bytes is never walked).
"""

from __future__ import annotations

from typing import Dict

from dingo_tpu_torch.index.base import tensor_bytes


def device_memory_stats() -> Dict[str, int]:
    """Summed allocator stats over the visible cards (zeros without one)."""
    out = {
        "devices": 0,
        "bytes_in_use": 0,
        "bytes_limit": 0,
        "peak_bytes_in_use": 0,
    }
    try:
        import torch

        if not torch.cuda.is_available():
            return out
        n = torch.cuda.device_count()
    except Exception:  # noqa: BLE001 — no runtime at all
        return out
    for d in range(n):
        try:
            ms = torch.cuda.memory_stats(d)
            limit = torch.cuda.get_device_properties(d).total_memory
        except Exception:  # noqa: BLE001
            continue
        out["devices"] += 1
        out["bytes_in_use"] += int(ms.get("allocated_bytes.all.current", 0))
        out["bytes_limit"] += int(limit)
        out["peak_bytes_in_use"] += int(ms.get("allocated_bytes.all.peak", 0))
    return out


def live_device_bytes_by_owner(owned_roots) -> Dict[str, int]:
    """Per-owner bytes over a SHARED dedup set: walk the (owner, root)
    pairs in order and charge each distinct storage to the FIRST owner
    that reaches it, so the owner columns sum to the index's bytes."""
    seen = (set(), set())
    return {owner: tensor_bytes(root, seen) for owner, root in owned_roots}
