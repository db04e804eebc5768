"""Batched distances on torch tensors (port of dingo_tpu/ops/distance.py;
f32 rows, and bf16 rows paired with a bf16-rounded query).

    L2sqr(q, x)  = ||q||^2 - 2 q.x + ||x||^2
    IP(q, x)     =  q.x
    cosine(q, x) =  q.x / (||q|| ||x||)     (normalize, then IP)

Scores are "larger is better" for every metric (negated L2) so one top-k
serves the whole index family; ``scores_to_distances`` converts back to the
wire convention (L2 ascending, IP/cosine descending).
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch

# The fp32 tier is true fp32: the JAX package pins Precision.HIGHEST on every
# distance contraction, so the port keeps TF32 off for both matrix products
# and cuDNN (TF32 keeps ~3 decimal digits and moves near-tie rankings and
# k-means assignments).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class Metric(enum.Enum):
    """pb::common::MetricType equivalents (HAMMING is not ported yet)."""

    L2 = "l2"
    INNER_PRODUCT = "ip"
    COSINE = "cosine"
    HAMMING = "hamming"


def squared_norms(x: torch.Tensor) -> torch.Tensor:
    """||x_i||^2 per row, f32."""
    x = x.to(torch.float32)
    return (x * x).sum(dim=1)


#: columns of one f32 partial dot of bf16 rows: the dimension block of the
#: bf16 kernel arms and a pass of a 128-deep MXU
DOT_BLOCK = 128


def _dot(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[b, d] @ [n, d]^T accumulated in f32. bf16 rows pair with the query
    rounded to bf16, as the JAX package's bf16 matmul does; a bf16 x bf16
    product is exact in f32, so only the summation order can differ. That
    order is one partial dot per DOT_BLOCK columns, summed block by block:
    on an H100 one f32 product over 768 columns at ||x||^2 ~ 860 erred by
    up to 1.8e-3 against the f64 distance, the blocked sum by 3.8e-4
    (chip_smoke.py's f64 witness). Only bf16 rows take the blocked form
    (f32 rows, and so k-means and the probes, keep one product)."""
    q = q.to(torch.float32)
    if x.dtype != torch.bfloat16:
        return q @ x.to(torch.float32).T
    q = q.to(torch.bfloat16).to(torch.float32)
    out = q[:, :DOT_BLOCK] @ x[:, :DOT_BLOCK].to(torch.float32).T
    for j in range(DOT_BLOCK, x.shape[1], DOT_BLOCK):
        out += q[:, j:j + DOT_BLOCK] @ x[:, j:j + DOT_BLOCK].to(
            torch.float32).T
    return out


def pairwise_l2sqr(q: torch.Tensor, x: torch.Tensor,
                   x_sqnorm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Squared L2 distance matrix [b, n], clamped at 0 against
    cancellation."""
    if x_sqnorm is None:
        x_sqnorm = squared_norms(x)
    d = squared_norms(q)[:, None] - 2.0 * _dot(q, x) + x_sqnorm[None, :]
    return torch.clamp_min(d, 0.0)


def normalize(x: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """Row L2-normalization with the squared-norm floor of np_normalize."""
    x32 = x.to(torch.float32)
    n = torch.sqrt(torch.clamp_min(squared_norms(x32), eps))
    return (x32 / n[:, None]).to(x.dtype)


def np_normalize(x, eps: float = 1e-30) -> np.ndarray:
    """Host-side row normalization, the same convention as the JAX
    package's np_normalize (floor on the SQUARED norm), so rows prepped on
    either side of the H2D boundary normalize to the same values."""
    x = np.ascontiguousarray(x, np.float32)
    n = np.sqrt(np.maximum((x * x).sum(axis=1, dtype=np.float32), eps))
    return np.ascontiguousarray(x / n[:, None])


def metric_ascending(metric: Metric) -> bool:
    """True when smaller distance means better (L2, hamming)."""
    return metric in (Metric.L2, Metric.HAMMING)


def score_matrix(q: torch.Tensor, x: torch.Tensor, metric: Metric,
                 x_sqnorm: Optional[torch.Tensor] = None,
                 x_is_normalized: bool = False) -> torch.Tensor:
    """Unified 'larger is better' score matrix [b, n]."""
    if metric is Metric.L2:
        return -pairwise_l2sqr(q, x, x_sqnorm)
    if metric is Metric.INNER_PRODUCT:
        return _dot(q, x)
    if metric is Metric.COSINE:
        qn = normalize(q)
        if x_is_normalized:
            return _dot(qn, x)
        if x_sqnorm is None:
            x_sqnorm = squared_norms(x)
        inv = torch.rsqrt(torch.clamp_min(x_sqnorm, 1e-30))
        return _dot(qn, x) * inv[None, :]
    raise ValueError(f"metric {metric} is not ported")


def scores_to_distances(scores: torch.Tensor, metric: Metric) -> torch.Tensor:
    """Internal scores -> wire distances."""
    if metric_ascending(metric):
        return -scores
    return scores
