"""Batched distances on torch tensors (port of dingo_tpu/ops/distance.py;
f32 rows, bf16 rows paired with a bf16-rounded query, and the binary
family's int8 +/-1 rows).

    L2sqr(q, x)  = ||q||^2 - 2 q.x + ||x||^2
    IP(q, x)     =  q.x
    cosine(q, x) =  q.x / (||q|| ||x||)     (normalize, then IP)
    hamming(a,b) = (nbits - pm(a).pm(b)) / 2  (pm: bits -> +/-1)

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
    """pb::common::MetricType equivalents, plus HAMMING for the binary
    index family."""

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


def _dot_pm1(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[b, d] @ [n, d]^T for int8 rows and a query of integers in int8
    range (the binary family's +/-1 values, 0 in padded rows), exact: one
    int8 x int8 -> int32 product (torch._int_mm: int8 tensor cores on the
    card), returned as f32. Hamming distances are integers and must come
    out exact; a bf16 product rounds them past 256 and widening the rows
    to f32 copies the whole store per search. The CUDA product wants more
    than 16 query rows and every other extent a multiple of 8: the query
    pads to a multiple of 8 and at least 24 rows, and zero columns or rows
    pad d and n where needed (never on an index's path: binary dimensions
    are multiples of 8 and store capacities powers of two)."""
    (b, d), n = q.shape, x.shape[0]
    m, dp, np_ = max(24, -(-b // 8) * 8), -(-d // 8) * 8, -(-n // 8) * 8
    qi = torch.zeros((m, dp), dtype=torch.int8, device=q.device)
    qi[:b, :d] = q.to(torch.int8)
    if (dp, np_) != (d, n):
        xp = torch.zeros((np_, dp), dtype=torch.int8, device=x.device)
        xp[:n, :d] = x
        x = xp
    return torch._int_mm(qi, x.T)[:b, :n].to(torch.float32)


def _dot(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[b, d] @ [n, d]^T accumulated in f32 (int8 rows: _dot_pm1, exact).
    bf16 rows pair with the query
    rounded to bf16, as the JAX package's bf16 matmul does; a bf16 x bf16
    product is exact in f32, so only the summation order can differ. That
    order is one partial dot per DOT_BLOCK columns, summed block by block:
    on an H100 one f32 product over 768 columns at ||x||^2 ~ 860 erred by
    up to 1.8e-3 against the f64 distance, the blocked sum by 3.8e-4
    (chip_smoke.py's f64 witness). Only bf16 rows take the blocked form
    (f32 rows, and so k-means and the probes, keep one product)."""
    if x.dtype == torch.int8:
        return _dot_pm1(q, x)
    q = q.to(torch.float32)
    if x.dtype != torch.bfloat16:
        return q @ x.to(torch.float32).T
    q = q.to(torch.bfloat16).to(torch.float32)
    out = q[:, :DOT_BLOCK] @ x[:, :DOT_BLOCK].to(torch.float32).T
    for j in range(DOT_BLOCK, x.shape[1], DOT_BLOCK):
        out += q[:, j:j + DOT_BLOCK] @ x[:, j:j + DOT_BLOCK].to(
            torch.float32).T
    return out


def saturate_int8(x: torch.Tensor) -> torch.Tensor:
    """f32 values as int8 the way XLA converts them (the JAX package's
    casts on the device): NaN to 0, a value past the int8 range to its
    nearest end, the rest toward zero. A plain cast (numpy's or torch's)
    wraps out-of-range values instead."""
    return torch.nan_to_num(x, nan=0.0).clamp(-128, 127).to(torch.int8)


def to_row_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """f32 values in a row dtype as XLA converts them: int8 saturates
    (saturate_int8); a float dtype rounds to nearest even, as torch's cast
    does."""
    return saturate_int8(x) if dtype == torch.int8 else x.to(dtype)


def widen_int_rows(x: torch.Tensor) -> torch.Tensor:
    """Rows of a float index's int8 store as f32 (the JAX package's
    einsum promotes them against the f32 query); any other rows as they
    are. The binary family's +/-1 int8 rows skip it: _dot's exact int8
    product casts the query to int8, exact for +/-1 queries only."""
    return x.to(torch.float32) if x.dtype == torch.int8 else x


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


def bits_to_pm1(packed: torch.Tensor, nbits: int) -> torch.Tensor:
    """uint8-packed bits [n, nbytes] -> +/-1 f32 [n, nbits]; bit j of a
    byte is (byte >> j) & 1, little-endian within the byte as in the JAX
    package (and numpy's unpackbits(bitorder="little"))."""
    n, nbytes = packed.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed.to(torch.uint8)[:, :, None] >> shifts) & 1
    bits = bits.reshape(n, nbytes * 8)[:, :nbits]
    return bits.to(torch.float32) * 2.0 - 1.0


def pairwise_hamming(q_packed: torch.Tensor, x_packed: torch.Tensor,
                     nbits: int) -> torch.Tensor:
    """Hamming distance matrix [b, n] (ascending = better) over
    uint8-packed bit vectors: (nbits - <pm(q), pm(x)>) / 2, exact."""
    qp = bits_to_pm1(q_packed, nbits)
    xp = bits_to_pm1(x_packed, nbits).to(torch.int8)
    return (nbits - _dot_pm1(qp, xp)) * 0.5


def metric_ascending(metric: Metric) -> bool:
    """True when smaller distance means better (L2, hamming)."""
    return metric in (Metric.L2, Metric.HAMMING)


def score_matrix(q: torch.Tensor, x: torch.Tensor, metric: Metric,
                 x_sqnorm: Optional[torch.Tensor] = None,
                 x_is_normalized: bool = False,
                 nbits: int = 0) -> torch.Tensor:
    """Unified 'larger is better' score matrix [b, n] (HAMMING: q and x
    are uint8-packed bits, ``nbits`` of them a row)."""
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
    if metric is Metric.HAMMING:
        return -pairwise_hamming(q, x, nbits)
    raise ValueError(f"unknown metric {metric}")


def scores_to_distances(scores: torch.Tensor, metric: Metric) -> torch.Tensor:
    """Internal scores -> wire distances."""
    if metric_ascending(metric):
        return -scores
    return scores


def device_wait_span(name: str, value):
    """Trace hook at a device dispatch site: when the current trace is
    sampled, wait for the tensors in `value` inside an ``ops.<name>``
    span (a CUDA event recorded after them and synchronized), so the span
    measures kernel time instead of dispatch time. Otherwise `value`
    passes through untouched: one sampled check, no event, no sync, no
    allocation. A dispatch outside a request trace is never timed."""
    from dingo_tpu_torch.trace import TRACER, current_span

    cur = current_span()
    if cur is None or not cur.sampled:
        return value
    with TRACER.start_span("ops." + name):
        tensors = value if isinstance(value, (tuple, list)) else (value,)
        if any(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors):
            ev = torch.cuda.Event()
            ev.record()
            ev.synchronize()
    return value
