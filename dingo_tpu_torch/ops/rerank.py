"""Device-resident exact rerank of approximate shortlists (port of
``exact_rerank_device``, ``sq_rerank_device`` and ``cached_rerank_device``
in dingo_tpu/ops/rerank.py).

IVF_PQ's device store keeps every row on the card, so the ADC shortlist is
reranked right after the scan, in the same stream: one gather of the
candidates' rows, one batched product, one top-k. The bf16/sq8 tiers
rerank their quantized shortlist against a bounded row cache the same
way. Nothing waits on the host, and the result joins the reply's single fetch group. Scores follow
the JAX package's formulas (the cosine epsilon included); outputs are in
the wire distance convention, so the rerank drops in after any scan.
"""

from __future__ import annotations

import torch

from dingo_tpu_torch.ops.devfault import DEVFAULT

from dingo_tpu_torch.ops.distance import (
    Metric,
    metric_ascending,
    scores_to_distances,
    squared_norms,
    to_row_dtype,
)
from dingo_tpu_torch.ops.sq import sq_decode_device


def _scores_from_rows(rows: torch.Tensor, c_sq: torch.Tensor,
                      queries: torch.Tensor, metric: Metric) -> torch.Tensor:
    """'Larger is better' scores [b, k'] of candidate rows [b, k', d] with
    their cached norms c_sq [b, k'] (unused for IP): the one metric math of
    the reranks, the beam walk (ops/beam.py, kernel G's plain version) and
    the graph build. Rows arrive in the compute dtype: f32 for exact
    scoring, the bf16 (surrogate) rows of the quantized tiers, with the
    query rounded to bf16 to match; products accumulate in f32 (a bf16 x
    bf16 product is exact in f32). Rows of another storage dtype (f16,
    int8: the beam walk's) pair with the query cast to theirs, as the JAX
    package's einsum does."""
    qd = queries.to(torch.float32)
    qc = qd if rows.dtype == torch.float32 else \
        to_row_dtype(qd, rows.dtype).to(torch.float32)
    dots = torch.einsum("bd,bkd->bk", qc, rows.to(torch.float32))
    if metric is Metric.L2:
        return -(squared_norms(qd)[:, None] - 2.0 * dots + c_sq)
    if metric is Metric.COSINE:
        return dots * torch.rsqrt(torch.clamp_min(c_sq, 1e-30))
    return dots


def _exact_candidate_scores(vecs: torch.Tensor, sqnorm: torch.Tensor,
                            queries: torch.Tensor, rows: torch.Tensor,
                            metric: Metric) -> torch.Tensor:
    """Exact scores [b, k'] for candidate row indices [b, k'] into vecs
    (callers clamp negatives to 0 first)."""
    idx = rows.long()
    # rows widen to f32 first: a bf16 cache still reranks with the f32 query
    return _scores_from_rows(vecs[idx].to(torch.float32), sqnorm[idx],
                             queries, metric)


def _topk_epilogue(scores: torch.Tensor, cand_slots: torch.Tensor, k: int,
                   metric: Metric):
    """Mask padding, top-k over the shortlist, -1 the empty winners, pad
    out to k, convert to wire distances."""
    scores = torch.where(cand_slots >= 0, scores,
                         torch.full_like(scores, -torch.inf))
    kk = min(k, int(cand_slots.shape[1]))
    vals, pos = torch.topk(scores, kk, dim=1)
    slots = torch.gather(cand_slots, 1, pos)
    slots = torch.where(torch.isneginf(vals), torch.full_like(slots, -1),
                        slots)
    if kk < k:
        b = vals.shape[0]
        vals = torch.cat([vals, vals.new_full((b, k - kk), -torch.inf)], 1)
        slots = torch.cat([slots, slots.new_full((b, k - kk), -1)], 1)
    return scores_to_distances(vals, metric), slots


def exact_rerank_device(vecs: torch.Tensor, sqnorm: torch.Tensor,
                        queries: torch.Tensor, cand_slots: torch.Tensor,
                        k: int, metric: Metric):
    """Exact top-k over the candidate slots [b, k'] (-1 pad), rows gathered
    on the device from the store arrays vecs [capacity, d] / sqnorm
    [capacity]. Returns (wire distances [b, k], slots [b, k])."""
    DEVFAULT.maybe_fail("ops.rerank.exact")
    safe = torch.where(cand_slots >= 0, cand_slots,
                       torch.zeros_like(cand_slots))
    scores = _exact_candidate_scores(vecs, sqnorm, queries, safe, metric)
    return _topk_epilogue(scores, cand_slots, k, metric)


def sq_rerank_device(codes: torch.Tensor, vmin: torch.Tensor,
                     scale: torch.Tensor, sqnorm: torch.Tensor,
                     queries: torch.Tensor, cand_slots: torch.Tensor, k: int,
                     metric: Metric):
    """Top-k over candidate slots [b, k'] whose rows are SQ8 codes [cap, d]
    uint8, decoded on the device to the bf16 surrogate and scored with f32
    accumulation; sqnorm [cap] holds the norms of the f32 decode (the
    SqSlotStore convention). Exact for the tier. The HNSW device and host
    paths both end here, so the same candidate set gives the same order.
    Returns (wire distances [b, k], slots [b, k])."""
    DEVFAULT.maybe_fail("ops.rerank.sq")
    safe = torch.where(cand_slots >= 0, cand_slots,
                       torch.zeros_like(cand_slots)).long()
    rows = sq_decode_device(codes[safe], vmin, scale)
    scores = _scores_from_rows(rows, sqnorm[safe], queries, metric)
    return _topk_epilogue(scores, cand_slots, k, metric)


def cached_rerank_device(cache_vecs: torch.Tensor,
                         cache_sqnorm: torch.Tensor,
                         cache_map: torch.Tensor, cand_dists: torch.Tensor,
                         cand_slots: torch.Tensor, queries: torch.Tensor,
                         k: int, metric: Metric):
    """Rerank a quantized shortlist [b, k'] against a bounded row cache:
    cache_map [store_capacity] int32 maps a store slot to its cache row
    (-1 = not cached). Cached candidates get exact scores (rows widened to
    f32); the others keep their quantized score from cand_dists (wire
    distances). Returns (wire distances [b, k], slots [b, k])."""
    DEVFAULT.maybe_fail("ops.rerank.cached")
    safe_slot = torch.where(cand_slots >= 0, cand_slots,
                            torch.zeros_like(cand_slots)).long()
    rows = cache_map[safe_slot]
    cached = (rows >= 0) & (cand_slots >= 0)
    exact = _exact_candidate_scores(
        cache_vecs, cache_sqnorm, queries,
        torch.where(cached, rows, torch.zeros_like(rows)), metric)
    quant = -cand_dists if metric_ascending(metric) else cand_dists
    scores = torch.where(cached, exact, quant)
    return _topk_epilogue(scores, cand_slots, k, metric)
