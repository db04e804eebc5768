"""Kernel G: per-(query, candidate slot) scores of the HNSW beam walk and
the graph build (the port of the XLA program
dingo_tpu/ops/beam.py::_candidate_scores; there is no Pallas kernel).

``candidate_scores`` launches the CUDA kernel in ``csrc/beam_scores.cu``
for CUDA tensors and runs ``candidate_scores_plain`` for CPU tensors; any
other placement raises. The JAX program gathers a [b, C, d] array of
candidate rows; the kernel reads only the rows of live slots (a hole, slot
-1, scores -inf without a read), and the plain version scores the candidate
axis in chunks so that no temporary exceeds PLAIN_CHUNK_BYTES.

Arms by the rows' dtype: f32, bf16 (the query rounded to bf16), and uint8
sq8 codes decoded to the bf16 surrogate (``sq_vmin``/``sq_scale``); each
counts its launches (``candidate_scores.launches``, ``.launches_bf16``,
``.launches_sq8``). With ``candidate_scores.count_live = True`` a launch
also adds its live and total candidate slots to ``.live`` and ``.slots``
(one device reduction and a host read: for measurements, never on by
default).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from dingo_tpu_torch.obs.sentinel import SENTINEL
from dingo_tpu_torch.ops import cuda_build
from dingo_tpu_torch.ops.distance import Metric, squared_norms
from dingo_tpu_torch.ops.rerank import _scores_from_rows
from dingo_tpu_torch.ops.sq import sq_decode_device

#: the plain version's largest gathered-row temporary
PLAIN_CHUNK_BYTES = 256 << 20

#: sentinel name: the JAX program it stands for, plus the scoring step
KERNEL = "ops.beam.search.scores"

_KIND = {torch.float32: (0, "launches"), torch.bfloat16: (1, "launches_bf16"),
         torch.uint8: (2, "launches_sq8")}
_METRIC = {Metric.L2: 0, Metric.INNER_PRODUCT: 1, Metric.COSINE: 2}

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = cuda_build.load("beam_scores")
        fn = lib.dingo_beam_scores
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 2)
        _fn = (lib, fn)
    return _fn


def _gathered_rows(vecs: torch.Tensor, slots: torch.Tensor,
                   sq_vmin: Optional[torch.Tensor],
                   sq_scale: Optional[torch.Tensor]) -> torch.Tensor:
    """Rows at `slots` (>= 0) in the compute dtype: codes decode to the
    bf16 surrogate, float rows as stored."""
    rows = vecs[slots.long()]
    if vecs.dtype == torch.uint8:
        rows = sq_decode_device(rows, sq_vmin, sq_scale)
    return rows


def candidate_scores_plain(queries: torch.Tensor, vecs: torch.Tensor,
                           sqnorm: torch.Tensor, slots: torch.Tensor,
                           metric: Metric,
                           sq_vmin: Optional[torch.Tensor] = None,
                           sq_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """'Larger is better' scores [b, C] f32 of candidate slots [b, C] (-1 =
    hole, -inf) through ops/rerank._scores_from_rows. Like the kernel it
    gathers only the live slots' rows (a host-side compaction: this version
    runs on CPU tensors only), at most PLAIN_CHUNK_BYTES of rows at a
    time."""
    b, c = slots.shape
    d = vecs.shape[1]
    out = torch.full((b, c), -torch.inf, dtype=torch.float32,
                     device=slots.device)
    qi, ci = torch.nonzero(slots >= 0, as_tuple=True)
    step = max(1, PLAIN_CHUNK_BYTES // max(1, d * 4))
    for s in range(0, len(qi), step):
        r, k = qi[s:s + step], ci[s:s + step]
        live = slots[r, k].long()
        rows = _gathered_rows(vecs, live, sq_vmin, sq_scale)
        sc = _scores_from_rows(rows[:, None, :], sqnorm[live][:, None],
                               queries[r], metric)
        out[r, k] = sc[:, 0]
    return out


def candidate_scores(queries: torch.Tensor, vecs: torch.Tensor,
                     sqnorm: torch.Tensor, slots: torch.Tensor,
                     metric: Metric,
                     sq_vmin: Optional[torch.Tensor] = None,
                     sq_scale: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Scores [b, C] f32 of the rows at candidate slots [b, C] int32 (-1 =
    hole, scored -inf) against queries [b, d] f32: vecs [cap, d] f32, bf16
    or uint8 sq8 codes (then sq_vmin/sq_scale [d] f32), sqnorm [cap] f32
    (the store's convention: norms of the stored or decoded rows)."""
    kind, counter = _KIND[vecs.dtype]
    if vecs.dtype == torch.uint8 and (sq_vmin is None or sq_scale is None):
        raise ValueError("candidate_scores: sq8 codes need sq_vmin/sq_scale")
    tensors = (queries, vecs, sqnorm, slots)
    if all(t.device.type == "cpu" for t in tensors):
        SENTINEL.launch(KERNEL, tensors)
        return candidate_scores_plain(queries, vecs, sqnorm, slots, metric,
                                      sq_vmin, sq_scale)
    if not cuda_build.same_cuda_device(*tensors):
        raise ValueError("candidate_scores: tensors must share one CUDA "
                         "device")
    b, d = queries.shape
    if vecs.dim() != 2 or vecs.shape[1] != d or slots.dim() != 2 \
            or slots.shape[0] != b or sqnorm.shape[0] != vecs.shape[0]:
        raise ValueError("candidate_scores: shape mismatch")
    if queries.dtype != torch.float32 or sqnorm.dtype != torch.float32:
        raise TypeError("candidate_scores: queries and sqnorm must be "
                        "float32")
    if slots.dtype != torch.int32:
        raise TypeError("candidate_scores: slots must be int32")
    if metric not in _METRIC:
        raise ValueError(f"candidate_scores: metric {metric} not supported")
    queries = queries.contiguous()
    slots = slots.contiguous()
    if not vecs.is_contiguous():
        raise ValueError("candidate_scores: vecs must be contiguous")
    if kind == 2:
        vmin = sq_vmin.to(torch.float32).contiguous()
        scale = sq_scale.to(torch.float32).contiguous()
        if not cuda_build.same_cuda_device(vmin, scale, vecs):
            raise ValueError("candidate_scores: codec must be on the "
                             "rows' device")
        vptr, sptr = vmin.data_ptr(), scale.data_ptr()
    else:
        vptr = sptr = None
    qsq = squared_norms(queries)
    c = slots.shape[1]
    out = torch.empty((b, c), dtype=torch.float32, device=queries.device)
    lib, fn = _launcher()
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    rc = fn(queries.data_ptr(), qsq.data_ptr(), vecs.data_ptr(),
            sqnorm.data_ptr(), slots.data_ptr(), vptr, sptr, kind, b, c, d,
            _METRIC[metric], out.data_ptr(), stream)
    cuda_build.check_launch(lib, rc, "candidate_scores")
    SENTINEL.launch(KERNEL, tensors)
    setattr(candidate_scores, counter, getattr(candidate_scores, counter) + 1)
    if candidate_scores.count_live:
        candidate_scores.live += int((slots >= 0).sum())
        candidate_scores.slots += slots.numel()
    return out


candidate_scores.launches = 0
candidate_scores.launches_bf16 = 0
candidate_scores.launches_sq8 = 0
candidate_scores.count_live = False
candidate_scores.live = 0
candidate_scores.slots = 0
