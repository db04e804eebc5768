"""Dimension-blocked (PDX-style vertical) scan layout helpers (port of
dingo_tpu/ops/blocked.py).

The pruned scans accumulate partial distances one block of dimensions at
a time and drop candidates whose bound already cannot beat the running
k-th best:

  * data  [n_blocks, n, block_d]  the FLAT store's mirror (the IVF bucket
          arrays stay [B, cap, d]: a kernel reads one block's slice of a
          row, which is contiguous there too)
  * bsq   [n_blocks, n] f32       per-block squared norms of the rows, the
          metadata both bounds need:
            L2 partial = qpsq[j] - 2*cumdot + xpsq[j]   (lower bound of the
                         final distance: the remaining blocks add >= 0)
            IP bound   = cumdot + sqrt(qtail[j] * xtail[j])
                         (Cauchy-Schwarz on the unseen suffix)

Blocking is a reshape and a transpose (plus zero padding of a trailing
partial block), so flat <-> blocked round-trips bit-exactly; zero pads add
0 to every block norm and every partial dot. Everything here is plain
torch on the tensor's device.
"""

from __future__ import annotations

from typing import Optional

import torch


def resolve_dim_block(dim: int, dim_block: Optional[int] = None
                      ) -> Optional[int]:
    """Effective dimension-block width for an index, or None when blocking
    cannot pay: pruning needs >= 2 blocks, and the kernels need the
    dimension to tile exactly."""
    if dim_block is None:
        from dingo_tpu_torch.common.config import FLAGS

        dim_block = int(FLAGS.get("ivf_dim_block"))
    if dim_block <= 0:
        return None
    if dim % dim_block or dim // dim_block < 2:
        return None
    return dim_block


def n_blocks(dim: int, dim_block: int) -> int:
    return -(-dim // dim_block)


def pad_dim(dim: int, dim_block: int) -> int:
    """Storage dimension rounded up to a whole number of blocks."""
    return n_blocks(dim, dim_block) * dim_block


def _pad_last(x: torch.Tensor, dim_block: int) -> torch.Tensor:
    pad = pad_dim(x.shape[-1], dim_block) - x.shape[-1]
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
    return x


def to_blocked(rows: torch.Tensor, dim_block: int) -> torch.Tensor:
    """[n, d] -> contiguous [n_blocks, n, block_d] (zero-padded trailing
    block); from_blocked(to_blocked(x)) == x bit for bit."""
    n, d = rows.shape
    x = _pad_last(rows, dim_block)
    return x.reshape(n, n_blocks(d, dim_block), dim_block).permute(
        1, 0, 2).contiguous()


def from_blocked(blk: torch.Tensor, dim: int) -> torch.Tensor:
    """[n_blocks, n, block_d] -> [n, d] (strips dimension padding)."""
    nblk, n, dblk = blk.shape
    return blk.permute(1, 0, 2).reshape(n, nblk * dblk)[:, :dim]


def block_sqnorms(rows: torch.Tensor, dim_block: int) -> torch.Tensor:
    """Per-dimension-block squared norms [n_blocks, n] f32."""
    blk = to_blocked(rows.to(torch.float32), dim_block)
    return (blk * blk).sum(dim=2)


def bucket_block_sqnorms(data: torch.Tensor, dim_block: int
                         ) -> torch.Tensor:
    """[A, cap, d] bucket data -> per-block norms [A, n_blocks, cap] f32
    (the IVF view's pruning metadata, built when the view materializes)."""
    a, cap, d = data.shape
    x = _pad_last(data.to(torch.float32), dim_block)
    x = x.reshape(a, cap, n_blocks(d, dim_block), dim_block)
    return (x * x).sum(dim=3).permute(0, 2, 1).contiguous()


def query_prefix_sqnorms(q: torch.Tensor, dim_block: int) -> torch.Tensor:
    """Inclusive per-block prefix norms [b, n_blocks] f32:
    out[:, j] = sum_{j' <= j} ||q_block_j'||^2 (out[:, -1] == ||q||^2)."""
    b, d = q.shape
    x = _pad_last(q.to(torch.float32), dim_block)
    per = (x.reshape(b, n_blocks(d, dim_block), dim_block) ** 2).sum(dim=2)
    return torch.cumsum(per, dim=1)
