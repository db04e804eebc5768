"""k-selection helpers (port of dingo_tpu/ops/topk.py).

Masking contract: invalid slots (tombstones, filter-rejected ids, padding)
carry score -inf and id -1; every exit maps a -inf pick to -1, so the host
layer drops it and a region with fewer than k candidates returns fewer
results.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

NEG_INF = float("-inf")


def topk_scores(
    scores: torch.Tensor,
    k: int,
    valid: Optional[torch.Tensor] = None,
    ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k per row of a 'larger is better' score matrix.

    scores: [b, n]; valid: [n] or [b, n] bool; ids: [n] external ids.
    Returns (scores[b, k] descending, ids[b, k] int32) with -1 on -inf
    picks."""
    b, n = scores.shape
    if valid is not None:
        scores = torch.where(valid, scores,
                             torch.full_like(scores, NEG_INF))
    if k > n:
        pad = torch.full((b, k - n), NEG_INF, dtype=scores.dtype,
                         device=scores.device)
        scores = torch.cat([scores, pad], dim=1)
        if ids is not None:
            ids = torch.cat([ids, torch.full((k - n,), -1, dtype=ids.dtype,
                                             device=ids.device)])
    vals, idx = torch.topk(scores, k, dim=1)
    out = idx if ids is None else ids[idx]
    out = torch.where(torch.isneginf(vals), torch.full_like(out, -1), out)
    return vals, out.to(torch.int32)


def merge_topk(
    scores_a: torch.Tensor,
    ids_a: torch.Tensor,
    scores_b: torch.Tensor,
    ids_b: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two per-row top-k result sets into one."""
    scores = torch.cat([scores_a, scores_b], dim=1)
    ids = torch.cat([ids_a, ids_b], dim=1)
    vals, idx = torch.topk(scores, k, dim=1)
    out = torch.gather(ids, 1, idx)
    out = torch.where(torch.isneginf(vals), torch.full_like(out, -1), out)
    return vals, out


class HostFetch:
    """One device-to-host copy group for a reply's whole fetch tuple.

    Each CUDA tensor copies into a pinned host buffer with a non-blocking
    copy on the current stream, and one CUDA event is recorded after the
    last copy; ``get()`` waits on that event once and hands back numpy
    arrays. CPU tensors (and host values) pass through. This keeps the
    one-sync-per-reply contract of the JAX package's begin_host_fetch."""

    __slots__ = ("_items", "_event")

    def __init__(self, arrays):
        items = []
        event = None
        for a in arrays:
            if a is None:
                continue
            if isinstance(a, torch.Tensor) and a.is_cuda:
                buf = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
                buf.copy_(a, non_blocking=True)
                items.append(buf)
                event = event or torch.cuda.Event()
            else:
                items.append(a)
        if event is not None:
            event.record()
        self._items = items
        self._event = event

    def get(self) -> tuple:
        if self._event is not None:
            self._event.synchronize()
        return tuple(
            a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            for a in self._items
        )


def begin_host_fetch(*arrays) -> HostFetch:
    """Start ONE D2H copy group for a reply; None entries are dropped, so
    the caller indexes ``get()``'s result positionally over its non-None
    arguments."""
    return HostFetch(arrays)
