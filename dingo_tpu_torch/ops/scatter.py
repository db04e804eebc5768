"""Point updates of the incrementally maintained IVF view (port of
dingo_tpu/ops/scatter.py).

The JAX package scatters into donated buffers padded to pow2 batches to
bound its compile cache; torch updates the tensors in place with
``index_put_`` and needs neither. Callers hold the owning store's
device_lock across every call, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from dingo_tpu_torch.ops.devfault import DEVFAULT

#: scatter batches larger than this go to the caller's full-rebuild path
#: (a write that big amortizes a dense rebuild anyway)
MAX_SCATTER_BATCH = 8192


def scatter_bucket_update(dst: torch.Tensor, b_idx, r_idx, vals
                          ) -> torch.Tensor:
    """dst[b_idx[i], r_idx[i]] = vals[i] in place on a [B, cap, ...] view
    array; returns dst."""
    DEVFAULT.maybe_fail("ops.scatter.bucket_rows")
    return _index_put(dst, b_idx, r_idx, vals)


def _index_put(dst: torch.Tensor, b_idx, r_idx, vals) -> torch.Tensor:
    if len(b_idx) == 0:
        return dst
    dev = dst.device
    bi = torch.as_tensor(np.asarray(b_idx, np.int64), device=dev)
    ri = torch.as_tensor(np.asarray(r_idx, np.int64), device=dev)
    if not isinstance(vals, torch.Tensor):
        vals = torch.as_tensor(np.asarray(vals))
    v = vals.to(device=dev, dtype=dst.dtype)
    dst.index_put_((bi, ri), v)
    return dst


def scatter_bucket_dim_update(dst: torch.Tensor, b_idx, r_idx, vals
                              ) -> torch.Tensor:
    """dst[b_idx[i], :, r_idx[i]] = vals[i] in place on a dimension-blocked
    [A, n_blocks, cap] view array (one row touches every block; vals is
    [n, n_blocks]); returns dst."""
    DEVFAULT.maybe_fail("ops.scatter.bucket_dim_rows")
    _index_put(dst.permute(0, 2, 1), b_idx, r_idx, vals)
    return dst


def pad_buckets(arr: torch.Tensor, new_b: int, fill=0) -> torch.Tensor:
    """Grow a [B, ...] tensor to [new_b, ...] (spill-bucket allocation
    outran the physical allocation); growth is rare (alloc ladder)."""
    b = arr.shape[0]
    if new_b <= b:
        return arr
    pad = torch.full((new_b - b,) + tuple(arr.shape[1:]), fill,
                     dtype=arr.dtype, device=arr.device)
    return torch.cat([arr, pad])
