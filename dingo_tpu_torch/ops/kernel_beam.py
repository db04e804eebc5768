"""Kernel G: per-(query, candidate slot) scores of the HNSW beam walk and
the graph build (the port of the XLA program
dingo_tpu/ops/beam.py::_candidate_scores; there is no Pallas kernel).

``candidate_scores`` launches a CUDA kernel for CUDA tensors and runs
``candidate_scores_plain`` for CPU tensors; any other placement raises. The
JAX program gathers a [b, C, d] array of candidate rows; the kernels read
only the rows of live slots (a hole, slot -1, scores -inf without a read),
and the plain version scores the candidate axis in chunks so that no
temporary exceeds PLAIN_CHUNK_BYTES.

Two designs, chosen by static shape (no host read):

* the block arm (``csrc/beam_block.cu``), for launches of at least
  BLOCK_MIN_BLOCKS query blocks with at least BLOCK_MIN_SLOTS candidate
  slots a query (the build walk's rounds): each distinct live row of a
  64-query block is read once and scored against the block's queries on
  the tensor cores (a claim pass on the device maps the slots to distinct
  rows, a persistent product over the rows, a scatter of the scores). Its scratch (the counts, a [blocks, cap] map, a row list
  and a dense [blocks, 64, dcap] f32 buffer of dots, dcap = min(cap, 64 C)
  rounded up to BLOCK_ROWS) is kept from launch to launch, one buffer a
  device and stream (``_block_scratch``; the largest layout yet, held for
  the process: 0.5 GiB after a 500,000-row build), so that a launch
  allocates and clears nothing;
* the per-pair arm (``csrc/beam_scores.cu``), for the rest (the seeds, the
  search's one-block rounds, the build's selection and reprune) and for
  inputs the block arm cannot copy in 16-byte pieces: one warp per live
  pair, reading its row. The search's [64, C] rounds stay here: the block
  arm cuts their device time ~3x, but the search waits on its host and
  ran slower end to end with it (PERF.md section 6).

``_scores_block`` and ``_scores_pair`` launch one design whatever the
shape, and count nothing: the wrapper calls them, and measurements and
tests compare them on one input. Arms by the rows' dtype: f32, bf16 (the
query rounded to bf16), and uint8 sq8 codes decoded to the bf16 surrogate
(``sq_vmin``/``sq_scale``); the wrapper counts each launch
(``candidate_scores.launches``, ``.launches_bf16``, ``.launches_sq8``) and
the design taken (``.block`` / ``.pair``). With
``candidate_scores.count_live = True`` a launch also adds its live and
total candidate slots to ``.live`` and ``.slots`` (one device reduction and
a host read: for measurements, never on by default).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, NamedTuple, Optional, Tuple

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

#: the block arm takes launches with at least this many candidate slots a
#: query (the walk rounds: beam x degree) and at least BLOCK_MIN_BLOCKS
#: query blocks (the build's 256-row batches, not a 64-query search);
#: others take the per-pair arm
BLOCK_MIN_SLOTS = 1024
BLOCK_MIN_BLOCKS = 2
#: queries of a block of the block arm (its wgmma M), and the most blocks a
#: launch may have
BLOCK_QUERIES = 64
BLOCK_MAX_BLOCKS = 64
#: the block arm's row tile: its dots buffer is padded to a multiple
BLOCK_ROWS = 128
#: the most scratch a block-arm launch may take (its dots buffer is sized
#: for the worst case, 64 x min(cap, 64 C) floats a block); a larger
#: launch takes the per-pair arm
BLOCK_MAX_SCRATCH_BYTES = 2 << 30
#: elements of a 16-byte piece, by row kind: the block arm's copies
_VEC = {0: 4, 1: 8, 2: 16}

_fn = None
_block_fn = None
#: the block arm's scratch, one a (device, stream): see _block_scratch
_scratch: Dict[Tuple[int, int], "_Scratch"] = {}
_scratch_lock = threading.Lock()
#: words before the block arm's map: the counts, one a query block
_COUNT_WORDS = 64
_EPOCH_MAX = (1 << 32) - 1


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


def _block_launcher():
    global _block_fn
    if _block_fn is None:
        lib = cuda_build.load("beam_block")
        fn = lib.dingo_beam_scores_block
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_uint]
                       + [ctypes.c_void_p] * 2)
        _block_fn = (lib, fn)
    return _block_fn


def _block_dcap(cap: int, c: int) -> int:
    """Row indices a block of the block arm may need: its dots buffer's
    width."""
    return -(-min(cap, BLOCK_QUERIES * c) // BLOCK_ROWS) * BLOCK_ROWS


def _block_words(nblk: int, cap: int, dcap: int) -> Tuple[int, int]:
    """The block arm's scratch, in 4-byte words, as beam_block.cu lays it
    out: (words up to the end of the map, which are cleared at a layout's
    first launch; all words)."""
    head = _COUNT_WORDS + 2 * nblk * cap
    ids = head + nblk * dcap
    return head, -(-ids // 4) * 4 + nblk * BLOCK_QUERIES * dcap


class _Scratch:
    """One stream's block-arm scratch: the buffer, the layout its map was
    cleared for, the last launch's epoch, and a lock held from the layout
    check to the end of the launch's enqueueing (two threads on one stream
    must not interleave their three kernels)."""

    def __init__(self):
        self.buf: Optional[torch.Tensor] = None
        self.layout: Optional[Tuple[int, int, int]] = None
        self.epoch = 0
        self.lock = threading.Lock()


def _block_scratch(dev: torch.device, stream: int) -> _Scratch:
    key = (dev.index, stream)
    with _scratch_lock:
        s = _scratch.get(key)
        if s is None:
            s = _scratch[key] = _Scratch()
        return s


def _next_epoch(s: _Scratch, dev: torch.device, nblk: int, cap: int,
                dcap: int) -> int:
    """Make `s` ready for a launch of this layout (under s.lock): grow the
    buffer if it is too small; at a new layout, or when the epochs run out,
    zero the map and set the counts to -1 (two fills on the stream); then
    the launch's epoch."""
    head, words = _block_words(nblk, cap, dcap)
    if s.buf is None or s.buf.numel() < words:
        s.buf = torch.empty((words,), dtype=torch.int32, device=dev)
        s.layout = None
    if s.layout != (nblk, cap, dcap) or s.epoch >= _EPOCH_MAX:
        s.buf[:head].zero_()
        s.buf[:_COUNT_WORDS].fill_(-1)
        s.layout, s.epoch = (nblk, cap, dcap), 0
    s.epoch += 1
    return s.epoch


def block_arm_fits(queries: torch.Tensor, vecs: torch.Tensor,
                   slots: torch.Tensor) -> bool:
    """Whether the block arm can take these inputs: rows and queries in
    16-byte pieces (d a multiple of the piece, both bases aligned), at
    most BLOCK_MAX_BLOCKS query blocks and a dots buffer within
    BLOCK_MAX_SCRATCH_BYTES. Reads no device value."""
    kind = _KIND[vecs.dtype][0]
    b, d = queries.shape
    nblk = -(-b // BLOCK_QUERIES)
    dots = nblk * BLOCK_QUERIES * _block_dcap(vecs.shape[0], slots.shape[1])
    return (d % _VEC[kind] == 0 and vecs.data_ptr() % 16 == 0
            and queries.data_ptr() % 16 == 0 and nblk <= BLOCK_MAX_BLOCKS
            and 4 * dots <= BLOCK_MAX_SCRATCH_BYTES)


def takes_block_arm(queries: torch.Tensor, vecs: torch.Tensor,
                    slots: torch.Tensor) -> bool:
    """The design a CUDA launch takes: the block arm for at least
    BLOCK_MIN_SLOTS slots a query and BLOCK_MIN_BLOCKS query blocks where
    it fits, else the per-pair arm."""
    return (slots.shape[1] >= BLOCK_MIN_SLOTS
            and -(-slots.shape[0] // BLOCK_QUERIES) >= BLOCK_MIN_BLOCKS
            and block_arm_fits(queries, vecs, slots))


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


#: plain-version scorings on the walk and the build of f16 or int8 rows
#: (scores), on any device
candidate_scores_plain.calls = 0


class _Launch(NamedTuple):
    """A CUDA launch's checked inputs."""
    queries: torch.Tensor
    vecs: torch.Tensor
    sqnorm: torch.Tensor
    slots: torch.Tensor
    qsq: torch.Tensor
    kind: int
    metric: int
    vptr: Optional[int]
    sptr: Optional[int]
    # the codec's tensors, kept alive for the launch
    codec: tuple


def _checked(queries: torch.Tensor, vecs: torch.Tensor,
             sqnorm: torch.Tensor, slots: torch.Tensor, metric: Metric,
             sq_vmin: Optional[torch.Tensor],
             sq_scale: Optional[torch.Tensor]) -> _Launch:
    """The inputs of a CUDA launch, checked; raises on anything a kernel
    cannot take."""
    kind = _KIND[vecs.dtype][0]
    if kind == 2 and (sq_vmin is None or sq_scale is None):
        raise ValueError("candidate_scores: sq8 codes need sq_vmin/sq_scale")
    if not cuda_build.same_cuda_device(queries, vecs, sqnorm, slots):
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
    if not vecs.is_contiguous():
        raise ValueError("candidate_scores: vecs must be contiguous")
    codec: tuple = ()
    vptr = sptr = None
    if kind == 2:
        codec = (sq_vmin.to(torch.float32).contiguous(),
                 sq_scale.to(torch.float32).contiguous())
        if not cuda_build.same_cuda_device(*codec, vecs):
            raise ValueError("candidate_scores: codec must be on the "
                             "rows' device")
        vptr, sptr = codec[0].data_ptr(), codec[1].data_ptr()
    queries = queries.contiguous()
    return _Launch(queries, vecs, sqnorm.contiguous(), slots.contiguous(),
                   squared_norms(queries), kind, _METRIC[metric], vptr, sptr,
                   codec)


def _launch_pair(x: _Launch) -> torch.Tensor:
    b, c = x.slots.shape
    d = x.queries.shape[1]
    dev = x.queries.device
    out = torch.empty((b, c), dtype=torch.float32, device=dev)
    lib, fn = _launcher()
    rc = fn(x.queries.data_ptr(), x.qsq.data_ptr(), x.vecs.data_ptr(),
            x.sqnorm.data_ptr(), x.slots.data_ptr(), x.vptr, x.sptr, x.kind,
            b, c, d, x.metric, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_launch(lib, rc, "candidate_scores")
    return out


def _launch_block(x: _Launch) -> torch.Tensor:
    b, c = x.slots.shape
    d = x.queries.shape[1]
    cap = x.vecs.shape[0]
    nblk, dcap = -(-b // BLOCK_QUERIES), _block_dcap(cap, c)
    dev = x.queries.device
    out = torch.empty((b, c), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib, fn = _block_launcher()
    s = _block_scratch(dev, stream)
    with s.lock:
        epoch = _next_epoch(s, dev, nblk, cap, dcap)
        rc = fn(x.queries.data_ptr(), x.qsq.data_ptr(), x.vecs.data_ptr(),
                x.sqnorm.data_ptr(), x.slots.data_ptr(), x.vptr, x.sptr,
                x.kind, b, c, d, cap, x.metric, s.buf.data_ptr(), dcap,
                epoch, out.data_ptr(), stream)
        if rc != 0:
            s.layout = None     # the counts may be left set
    cuda_build.check_launch(lib, rc, "candidate_scores")
    return out


def _scores_pair(queries, vecs, sqnorm, slots, metric, sq_vmin=None,
                 sq_scale=None) -> torch.Tensor:
    """The per-pair kernel on CUDA tensors, whatever the shape; counts
    nothing."""
    return _launch_pair(_checked(queries, vecs, sqnorm, slots, metric,
                                 sq_vmin, sq_scale))


def _scores_block(queries, vecs, sqnorm, slots, metric, sq_vmin=None,
                  sq_scale=None) -> torch.Tensor:
    """The block arm on CUDA tensors, whatever the shape (ValueError where
    it cannot take the inputs); counts nothing."""
    x = _checked(queries, vecs, sqnorm, slots, metric, sq_vmin, sq_scale)
    if not block_arm_fits(x.queries, x.vecs, x.slots):
        raise ValueError("candidate_scores: the block arm needs d a "
                         "multiple of the 16-byte piece, aligned bases, at "
                         f"most {BLOCK_MAX_BLOCKS} query blocks and its "
                         "scratch within BLOCK_MAX_SCRATCH_BYTES")
    return _launch_block(x)


def scores(queries: torch.Tensor, vecs: torch.Tensor, sqnorm: torch.Tensor,
           slots: torch.Tensor, metric: Metric,
           sq_vmin: Optional[torch.Tensor] = None,
           sq_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The walk's and the build's candidate scores: kernel G
    (candidate_scores) for rows of its arms (f32, bf16, sq8 codes); f16
    and int8 rows (IndexParameter.dtype) take the plain version on any
    device, the JAX package's XLA program for every dtype, counted in
    candidate_scores_plain.calls."""
    if vecs.dtype in _KIND:
        return candidate_scores(queries, vecs, sqnorm, slots, metric,
                                sq_vmin, sq_scale)
    candidate_scores_plain.calls += 1
    return candidate_scores_plain(queries, vecs, sqnorm, slots, metric)


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
    counter = _KIND[vecs.dtype][1]
    if vecs.dtype == torch.uint8 and (sq_vmin is None or sq_scale is None):
        raise ValueError("candidate_scores: sq8 codes need sq_vmin/sq_scale")
    tensors = (queries, vecs, sqnorm, slots)
    if all(t.device.type == "cpu" for t in tensors):
        SENTINEL.launch(KERNEL, tensors)
        return candidate_scores_plain(queries, vecs, sqnorm, slots, metric,
                                      sq_vmin, sq_scale)
    x = _checked(queries, vecs, sqnorm, slots, metric, sq_vmin, sq_scale)
    if takes_block_arm(x.queries, x.vecs, x.slots):
        out, design = _launch_block(x), "block"
    else:
        out, design = _launch_pair(x), "pair"
    SENTINEL.launch(KERNEL, tensors)
    setattr(candidate_scores, counter, getattr(candidate_scores, counter) + 1)
    setattr(candidate_scores, design, getattr(candidate_scores, design) + 1)
    if candidate_scores.count_live:
        candidate_scores.live += int((slots >= 0).sum())
        candidate_scores.slots += slots.numel()
    return out


candidate_scores.launches = 0
candidate_scores.launches_bf16 = 0
candidate_scores.launches_sq8 = 0
candidate_scores.block = 0
candidate_scores.pair = 0
candidate_scores.count_live = False
candidate_scores.live = 0
candidate_scores.slots = 0
