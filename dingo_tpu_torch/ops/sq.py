"""SQ8 scalar quantizer of the sq8 precision tier (port of
dingo_tpu/ops/sq.py): per-dimension min/max training, uint8 codes, and the
decode-then-bf16 scoring both scan arms of the tier use.

Codec (faiss QT_8bit, per-dimension affine):

    scale[j] = (vmax[j] - vmin[j]) / 255        (floored at EPS_SPAN)
    code     = round((x - vmin) / scale)  clipped to [0, 255]
    decode   = code * scale + vmin              (a multiply, then an add)

Training widens the per-dimension range by MARGIN on each side so values
slightly outside the training sample still encode without clipping. The
host codec is numpy and bit-equal to the JAX package's; scoring decodes in
f32, rounds the decoded rows and the query to bf16 and accumulates the
products in f32 (a bf16 x bf16 product is exact in f32, so only the
summation order can differ from the JAX package's bf16 matmul).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from dingo_tpu_torch.ops.distance import Metric, squared_norms

#: minimum per-dimension span: a constant dimension still gets a scale
EPS_SPAN = 1e-12
#: symmetric range widening at train time (fraction of the span)
TRAIN_MARGIN = 0.05


class SqParams(NamedTuple):
    """Trained per-dimension affine codec: vmin and scale, [d] float32 host
    arrays (they persist as plain npz arrays)."""

    vmin: np.ndarray
    scale: np.ndarray

    @property
    def dim(self) -> int:
        return int(self.vmin.shape[0])


def sq_train(x: np.ndarray, margin: float = TRAIN_MARGIN) -> SqParams:
    """Per-dimension min/max over the sample, widened by `margin` a side."""
    x = np.asarray(x, np.float32)
    if x.ndim != 2 or not len(x):
        raise ValueError(f"sq_train needs [n, d] rows, got {x.shape}")
    vmin = x.min(axis=0)
    vmax = x.max(axis=0)
    span = vmax - vmin
    vmin = vmin - margin * span
    span = span * (1.0 + 2.0 * margin)
    scale = np.maximum(span, EPS_SPAN) / 255.0
    return SqParams(vmin.astype(np.float32), scale.astype(np.float32))


def sq_encode(x: np.ndarray, params: SqParams) -> np.ndarray:
    """f32 rows [n, d] -> uint8 codes [n, d]; out-of-range values clip."""
    # the same operations as rint((x - vmin) / scale) and the clip, in
    # place on one temporary
    q = np.asarray(x, np.float32) - params.vmin[None, :]
    q /= params.scale[None, :]
    np.rint(q, out=q)
    np.clip(q, 0.0, 255.0, out=q)
    return q.astype(np.uint8)


def sq_decode(codes: np.ndarray, params: SqParams) -> np.ndarray:
    """uint8 codes -> the decoded f32 surrogate rows (host): an f32
    multiply, then an f32 add, in place on one copy."""
    out = np.asarray(codes).astype(np.float32)
    out *= params.scale[None, :]
    out += params.vmin[None, :]
    return out


def sq_decode_device(codes: torch.Tensor, vmin: torch.Tensor,
                     scale: torch.Tensor,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Decode [..., d] codes on their device: f32 multiply, f32 add (two
    roundings, as numpy and the JAX package do), then the cast to
    `dtype`."""
    deq = codes.to(torch.float32) * scale + vmin
    return deq.to(dtype)


def _bf16_dots(q: torch.Tensor, xhat: torch.Tensor, eq: str) -> torch.Tensor:
    """bf16 x bf16 products with f32 accumulation: the query rounds to
    bf16, both operands widen exactly to f32, one f32 contraction."""
    qb = q.to(torch.float32).to(torch.bfloat16).to(torch.float32)
    return torch.einsum(eq, qb, xhat.to(torch.float32))


def sq_score_matrix(q: torch.Tensor, codes: torch.Tensor, vmin: torch.Tensor,
                    scale: torch.Tensor, metric: Metric,
                    x_sqnorm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """'Larger is better' scores [b, n] of q [b, d] against SQ8 codes
    [n, d]. x_sqnorm must be ||decode(code)||^2 of the f32 decode (the
    SqSlotStore cache)."""
    xhat = sq_decode_device(codes, vmin, scale)
    qd = q.to(torch.float32)
    dots = _bf16_dots(qd, xhat, "bd,nd->bn")
    if metric is Metric.L2:
        if x_sqnorm is None:
            x_sqnorm = squared_norms(xhat)
        return -(squared_norms(qd)[:, None] - 2.0 * dots + x_sqnorm[None, :])
    if metric is Metric.INNER_PRODUCT:
        return dots
    if metric is Metric.COSINE:
        if x_sqnorm is None:
            x_sqnorm = squared_norms(xhat)
        return dots * torch.rsqrt(torch.clamp_min(x_sqnorm, 1e-30))[None, :]
    raise ValueError(f"SQ8 does not support metric {metric}")


def sq_bucket_scores(queries: torch.Tensor, data: torch.Tensor,
                     sq: torch.Tensor, vmin: torch.Tensor,
                     scale: torch.Tensor, metric: Metric) -> torch.Tensor:
    """Per-query bucket scores [b, cap] for the IVF list scan: data is the
    gathered code bucket [b, cap, d], sq its decoded-norm cache [b, cap]."""
    xhat = sq_decode_device(data, vmin, scale)
    qd = queries.to(torch.float32)
    dots = _bf16_dots(qd, xhat, "bd,bcd->bc")
    if metric is Metric.L2:
        return -(squared_norms(qd)[:, None] - 2.0 * dots + sq)
    if metric is Metric.COSINE:
        return dots * torch.rsqrt(torch.clamp_min(sq, 1e-30))
    return dots
