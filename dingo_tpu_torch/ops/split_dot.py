"""Host models of the split-precision products of kernels B1 and B2.

The kernels (csrc/fused_topk.cu, csrc/ivf_topk.cu) multiply on the tensor
cores and keep the fp32 tier's f32 accuracy by splitting operands
(csrc/split_mma.cuh):

  3xTF32   f32 rows: x = x_hi + x_lo, q = q_hi + q_lo; hi rounded to TF32
           as ``cvt.rna`` does (to nearest, ties away from zero), lo the
           exact f32 residual of which the tensor cores read the upper 19
           bits (truncated to TF32); dot = q_hi.x_lo + q_lo.x_hi +
           q_hi.x_hi, f32 accumulation (q_lo.x_lo is dropped).
  bf16x3   bf16 rows: the f32 query split into three bf16 parts
           q = q1 + q2 + q3 (each the bf16 rounding, to nearest even, of
           the residual left by the ones before; exact for normal f32
           values); each part times a bf16 row value is exact in f32.

``split_dot`` computes a [b, n] dot matrix that way (the terms' f32
sums run in another order than the tensor cores', which sum each k
step's products from zero and add that partial to an f32 total);
``fused_topk_split`` and ``ivf_item_candidates`` select through it as
the kernels do, B2's per (query, rank) candidates from the work list of
``kernel_ivf_pruned.probe_items_plain`` included. B1 then scores its k
winners again in the plain version's f32 arithmetic, an FMA chain over
the columns in order (``chain_dot``), and returns those scores, re-sorted;
B2 returns its split scores. They are test models:
the index routes and the kernels' wrappers on the CPU run the plain
versions (``fused_topk_plain``, ``ivf_list_topk_plain``), which stay the
functions' definitions.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dingo_tpu_torch.ops.kernel_ivf_pruned import QT, probe_items_plain
from dingo_tpu_torch.ops.topk import topk_scores

NEG_INF = float("-inf")


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32 (10 explicit mantissa bits) to nearest,
    ties away from zero (``cvt.rna.tf32.f32``), as f32. Finite inputs."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    sign = bits & -0x80000000
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & -0x2000
    return (sign | mag).view(torch.float32)


def truncate_tf32(t: torch.Tensor) -> torch.Tensor:
    """The TF32 value the tensor cores read from an f32 register: its low
    13 bits cleared (towards zero)."""
    return (t.to(torch.float32).contiguous().view(torch.int32)
            & -0x2000).view(torch.float32)


def split_tf32_plain(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo), both TF32 values in f32: hi = rna(t), lo = the residual
    t - hi (exact in f32) as the tensor cores read it."""
    t = t.to(torch.float32)
    hi = round_tf32(t)
    return hi, truncate_tf32(t - hi)


def split_bf16x3_plain(q: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three bf16 parts of an f32 query, as f32 (q1 + q2 + q3 == q
    for normal values)."""
    r = q.to(torch.float32)
    parts = []
    for _ in range(3):
        p = r.to(torch.bfloat16).to(torch.float32)
        parts.append(p)
        r = r - p
    return parts[0], parts[1], parts[2]


def split_dot(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """q[b, d] f32 against rows x[n, d] (f32: 3xTF32; bf16: the query's
    three bf16 parts) -> [b, n] f32, the kernels' products. Each query's
    row is computed on its own, so that, as in the kernels, a (query, row)
    dot does not depend on the other queries of the call."""
    q32 = q.to(torch.float32)
    if x.dtype == torch.bfloat16:
        xf = x.to(torch.float32)
        parts = split_bf16x3_plain(q32)
        return torch.stack([(xf @ q3 + xf @ q2) + xf @ q1
                            for q1, q2, q3 in zip(*parts)])
    xh, xl = split_tf32_plain(x)
    qh, ql = split_tf32_plain(q32)
    return torch.stack([(xl @ h + xh @ lo) + xh @ h
                        for h, lo in zip(qh, ql)])


def split_scores(q: torch.Tensor, x: torch.Tensor, x_sqnorm: torch.Tensor,
                 ascending: bool) -> torch.Tensor:
    """'Larger is better' scores through split_dot: L2 -((||q||^2 - 2 dot)
    + ||x||^2) with ||q||^2 of the f32 query, IP the dot."""
    dots = split_dot(q, x)
    if not ascending:
        return dots
    q32 = q.to(torch.float32)
    qsq = (q32 * q32).sum(dim=1)
    return -((qsq[:, None] - 2.0 * dots) + x_sqnorm[None, :])


def chain_dot(q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """q[m, d] . rows[m, d] row by row as one f32 FMA chain over the
    columns in order (B1's rescore): each step's product is exact in f64
    and the sum rounds once to f32 (an f32 FMA, but for the rare double
    rounding through f64)."""
    acc = torch.zeros(q.shape[0], dtype=torch.float32)
    q64 = q.to(torch.float64)
    r64 = rows.to(torch.float32).to(torch.float64)
    for c in range(q.shape[1]):
        acc = (acc.to(torch.float64) + q64[:, c] * r64[:, c]).to(
            torch.float32)
    return acc


def fused_topk_split(q: torch.Tensor, x: torch.Tensor,
                     x_sqnorm: torch.Tensor, valid: torch.Tensor, k: int,
                     ascending: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1 through the split products -> (scores[b, k], slots[b, k]): the
    k best by the split scores, each scored again by ``chain_dot`` and
    the k re-sorted (larger first, equal scores in their first order)."""
    scores = split_scores(q, x, x_sqnorm, ascending)
    vals, ids = topk_scores(scores, k, valid=valid.to(torch.bool)[None, :])
    b = q.shape[0]
    q32 = q.to(torch.float32)
    live = ids >= 0
    flat = ids.clamp_min(0).long()
    dots = chain_dot(q32.repeat_interleave(k, 0),
                     x[flat.reshape(-1)]).reshape(b, k)
    if ascending:
        qsq = (q32 * q32).sum(dim=1)
        dots = -((qsq[:, None] - 2.0 * dots) + x_sqnorm[flat])
    vals = torch.where(live, dots, torch.full_like(dots, NEG_INF))
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices
    return (torch.gather(vals, 1, order),
            torch.gather(ids, 1, order))


#: B2's rows per scan tile, and the most parts it scans an item in
B2_ROWS, B2_PARTS = 128, 2


def ivf_parts(cap: int) -> int:
    """Parts B2 scans an item of a cap-row bucket in: runs of its 128-row
    tiles (``parts_of`` in csrc/ivf_topk.cu)."""
    return min(B2_PARTS, -(-cap // B2_ROWS))


def ivf_item_candidates(vprobes: torch.Tensor, queries: torch.Tensor,
                        buckets: torch.Tensor, bucket_sqnorm: torch.Tensor,
                        bucket_valid: torch.Tensor,
                        bucket_slot: torch.Tensor, k: int,
                        ascending: bool = True, qt: int = QT
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2's candidates -> (cand_v, cand_i) [b, budget, parts, k]: item by
    item of probe_items_plain and part by part of the bucket's rows
    (``ivf_parts``), the item's queries against the part's rows at once,
    each (query, rank) pair's k best of the part at its rank; unprobed
    ranks -inf / -1."""
    b, budget = vprobes.shape
    nb, cap = buckets.shape[:2]
    parts = ivf_parts(cap)
    ntiles = -(-cap // B2_ROWS)
    tpu = -(-ntiles // parts)                   # tiles a part
    cand_v = torch.full((b, budget, parts, k), NEG_INF, dtype=torch.float32)
    cand_i = torch.full((b, budget, parts, k), -1, dtype=torch.int32)
    pairs, items, n_items = probe_items_plain(vprobes, nb, qt)
    for bucket, first, count in items[:n_items].tolist():
        ps = pairs[first:first + count].long()
        qi, ri = ps // budget, ps % budget
        for part in range(parts):
            lo = part * tpu * B2_ROWS
            hi = min(cap, lo + tpu * B2_ROWS)
            scores = split_scores(queries[qi], buckets[bucket, lo:hi],
                                  bucket_sqnorm[bucket, lo:hi], ascending)
            vals, idx = topk_scores(
                scores, k, valid=bucket_valid[bucket, lo:hi].to(torch.bool))
            slots = bucket_slot[bucket, lo:hi][idx.clamp_min(0).long()]
            cand_v[qi, ri, part] = vals
            cand_i[qi, ri, part] = torch.where(
                idx < 0, torch.full_like(slots, -1), slots)
    return cand_v, cand_i


def merge_candidates(cand_v: torch.Tensor, cand_i: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[b, m, k] candidates -> the k best of each row (merge_candidates in
    topk_common.cuh; its ties go to the earliest position)."""
    b = cand_v.shape[0]
    vals, idx = topk_scores(cand_v.reshape(b, -1), k)
    flat = cand_i.reshape(b, -1)
    out = torch.gather(flat, 1, idx.clamp_min(0).long())
    return vals, torch.where(idx < 0, torch.full_like(out, -1), out)
