"""Product quantization: train / encode / ADC (port of dingo_tpu/ops/pq.py).

  train    — m independent k-means fits, one per subspace, each seeded by
             farthest-first from a host-drawn first index and refined by
             Lloyd (ops/kmeans.py); the fits run one after another.
  encode   — per-subspace nearest-codeword argmin, all m subspaces in one
             batched product per chunk of rows; codes are uint8 [n, m].
  ADC scan — dist[b, n] = sum_j LUT[b, j, code[n, j]]: a gather and a sum in
             plain torch. The JAX package contracts a one-hot tile on the
             MXU instead (gathers are slow on a TPU); the IVF_PQ serving
             path scans with kernel B5 (ops/kernel_pq.py), not with this.
"""

from __future__ import annotations

import numpy as np
import torch

from dingo_tpu_torch.ops.kmeans import farthest_first_init, kmeans_fit


def split_subvectors(x: torch.Tensor, m: int) -> torch.Tensor:
    """[n, d] -> [m, n, dsub]."""
    n, d = x.shape
    if d % m:
        raise ValueError(f"dim {d} not divisible by m={m}")
    return x.reshape(n, m, d // m).permute(1, 0, 2)


def pq_train(x: torch.Tensor, m: int, ksub: int = 256, iters: int = 10,
             seed: int = 0) -> torch.Tensor:
    """Train PQ codebooks [m, ksub, dsub] on x[n, d]; subspace j's first
    seed is the j-th draw of default_rng(seed).integers(0, n, size=m), as in
    the JAX package, so each fit equals its JAX fit."""
    subs = split_subvectors(x.to(torch.float32), m)
    first = np.random.default_rng(seed).integers(0, x.shape[0], size=m)
    books = []
    for j in range(m):
        sub = subs[j].contiguous()
        seeds = farthest_first_init(sub, int(first[j]), ksub)
        c, _ = kmeans_fit(sub, seeds, k=ksub, iters=iters)
        books.append(c)
    return torch.stack(books)


def _nearest_codewords(subs: torch.Tensor, codebooks: torch.Tensor
                       ) -> torch.Tensor:
    """subs [m, n, dsub] -> argmin_c ||sub - codebooks[j, c]||^2 as [m, n],
    with the clamp-at-0 squared distance of pairwise_l2sqr."""
    cb_sq = (codebooks * codebooks).sum(-1)                 # [m, ksub]
    s_sq = (subs * subs).sum(-1)                            # [m, n]
    dots = torch.bmm(subs, codebooks.transpose(1, 2))       # [m, n, ksub]
    dist = torch.clamp_min(s_sq[:, :, None] - 2.0 * dots
                           + cb_sq[:, None, :], 0.0)
    return torch.argmin(dist, dim=2)


def pq_encode(x: torch.Tensor, codebooks: torch.Tensor,
              chunk: int = 8192) -> torch.Tensor:
    """Encode x[n, d] -> codes[n, m] uint8 (nearest codeword per
    subspace), `chunk` rows at a time (bounds the [m, chunk, ksub]
    distance block)."""
    m = codebooks.shape[0]
    n = x.shape[0]
    out = torch.empty((n, m), dtype=torch.uint8, device=x.device)
    for lo in range(0, n, chunk):
        subs = split_subvectors(x[lo:lo + chunk].to(torch.float32), m)
        out[lo:lo + chunk] = _nearest_codewords(
            subs, codebooks).T.to(torch.uint8)
    return out


def adc_lut(q: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Distance look-up tables LUT[b, m, ksub] = ||q_sub - codeword||^2
    (clamped at 0, as pairwise_l2sqr)."""
    m = codebooks.shape[0]
    qs = split_subvectors(q.to(torch.float32), m)           # [m, b, dsub]
    cb_sq = (codebooks * codebooks).sum(-1)
    q_sq = (qs * qs).sum(-1)
    lut = torch.clamp_min(q_sq[:, :, None] - 2.0 * torch.bmm(
        qs, codebooks.transpose(1, 2)) + cb_sq[:, None, :], 0.0)
    return lut.permute(1, 0, 2).contiguous()


def codebook_sqnorms(codebooks: torch.Tensor) -> torch.Tensor:
    """||codeword||^2 per (subspace, codeword): [m, ksub] f32."""
    return (codebooks * codebooks).sum(-1)


def residual_lut_tables(resid: torch.Tensor, codebooks: torch.Tensor,
                        cb_sq: torch.Tensor) -> torch.Tensor:
    """Residual targets [n, d] -> ADC tables [n, m, ksub] (a view):
    lut[i, j, c] = ||resid_i_subj - codeword_jc||^2 in the expanded form
    q_sq - 2 dots + cb_sq, the one copy of the table formula both IVF_PQ
    scan arms use (and the one kernel_pq.ivfpq_adc_lut evaluates)."""
    subs = split_subvectors(resid, codebooks.shape[0])     # [m, n, dsub]
    dots = torch.bmm(subs, codebooks.transpose(1, 2))      # [m, n, ksub]
    q_sq = (subs * subs).sum(-1)                           # [m, n]
    lut = q_sq[:, :, None] - 2.0 * dots + cb_sq[:, None, :]
    return lut.permute(1, 0, 2)


def adc_scan(lut: torch.Tensor, codes: torch.Tensor,
             chunk: int = 32768) -> torch.Tensor:
    """ADC distances [b, n] from LUT[b, m, ksub] and codes[n, m], `chunk`
    codes at a time (bounds the [b, chunk, m] gathered block)."""
    b, m, ksub = lut.shape
    n = codes.shape[0]
    flat = lut.reshape(b, m * ksub)
    offs = torch.arange(m, device=codes.device) * ksub
    out = torch.empty((b, n), dtype=torch.float32, device=lut.device)
    for lo in range(0, n, chunk):
        idx = codes[lo:lo + chunk].long() + offs[None, :]   # [c, m]
        out[:, lo:lo + chunk] = flat[:, idx].sum(dim=2)
    return out


def pq_reconstruct(codes: torch.Tensor, codebooks: torch.Tensor
                   ) -> torch.Tensor:
    """Decode codes[n, m] -> approximate vectors [n, d]."""
    m, _, dsub = codebooks.shape
    j = torch.arange(m, device=codes.device)[None, :]
    return codebooks[j, codes.long()].reshape(codes.shape[0], m * dsub)
