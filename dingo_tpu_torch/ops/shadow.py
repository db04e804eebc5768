"""Shadow exact scan: the quality plane's ground truth (port of
dingo_tpu/ops/shadow.py).

For a head-sampled fraction of live queries (obs/quality.py) the store
re-answers the same queries exactly: a whole-store score matrix and a
masked top-k over the best fp32 rows the region has, plain torch on the
store's device (the JAX package runs it as an XLA program of its own, no
Pallas kernel). It reports to the launch sentinel under its own name, so
shadow work is never mistaken for serving work, and it counts its calls in
``shadow_exact_topk.calls``.

Shape discipline: callers pad the query batch to a power of two and round
k up the {1,1.5}x-pow2 ladder, so the plane uses a handful of shapes; at
``quality_sample_rate`` 0 nothing runs at all.
"""

from __future__ import annotations

import torch

from dingo_tpu_torch.obs.sentinel import SENTINEL
from dingo_tpu_torch.ops.distance import Metric, score_matrix, scores_to_distances
from dingo_tpu_torch.ops.topk import topk_scores

#: the launch sentinel's name of the scan (the JAX package's program name)
SENTINEL_NAME = "ops.shadow.exact"


def shadow_exact_topk(vecs: torch.Tensor, sqnorm: torch.Tensor,
                      mask: torch.Tensor, queries: torch.Tensor, k: int,
                      metric: Metric):
    """Exact top-k over the whole store: (wire distances [b, k], slot
    indices [b, k], -1 where invalid).

    vecs/sqnorm: [capacity, d] fp32 rows and their cached ||x||^2 (cosine
    rows are stored normalized, so IP over them is cosine); mask:
    [capacity] bool validity (tombstones and filters applied)."""
    SENTINEL.launch(SENTINEL_NAME, (vecs, queries), k)
    shadow_exact_topk.calls += 1
    scores = score_matrix(queries, vecs, metric, x_sqnorm=sqnorm,
                          x_is_normalized=(metric is Metric.COSINE))
    vals, slots = topk_scores(scores, k, valid=mask)
    return scores_to_distances(vals, metric), slots


shadow_exact_topk.calls = 0
