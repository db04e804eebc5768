"""Kernel B1: fused distance + running top-k (port of
dingo_tpu/ops/pallas_topk.py::fused_topk), in its two row arms:

  f32   rows f32, the query f32 (``fused_topk.launches``);
  bf16  rows bf16, the query f32 (pallas_topk.py:67;
        ``fused_topk.launches_bf16``).

``fused_topk`` launches the arm of the rows' dtype in
``csrc/fused_topk.cu`` for CUDA tensors and runs ``fused_topk_plain``
(which takes the same arm) for CPU tensors; any other placement raises.
The kernel holds its running lists in shared memory for k <= K_MAX;
callers route larger k to the XLA-equivalent arm themselves
(index/flat.py), so this wrapper refuses it.

The kernel multiplies on the tensor cores in split precision (3xTF32 for
f32 rows, a three-way bf16 split of the query for bf16 rows;
``ops/split_dot.py`` models both). Bound on an H100 and design: see the
note at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from dingo_tpu_torch.obs.sentinel import SENTINEL
from dingo_tpu_torch.ops import cuda_build
from dingo_tpu_torch.ops.topk import topk_scores

#: largest k the kernel's shared-memory running lists hold
K_MAX = 64
#: rows per scan tile of B4 (a CTA's slot range is a multiple of it)
ROWS_PER_TILE = 128
#: rows per scan tile of B1
B1_ROWS_PER_TILE = 256
#: queries per CTA tile
QUERIES_PER_TILE = 64

#: row dtype -> (C entry point, launch counter attribute)
ARMS = {torch.float32: ("dingo_fused_topk", "launches"),
        torch.bfloat16: ("dingo_fused_topk_bf16", "launches_bf16")}

_fns: dict = {}


def _lists_per_query(lib) -> int:
    """Running lists per query and CTA of the kernel (its candidates'
    middle dimension is this times the CTAs over the slots)."""
    fn = lib.dingo_fused_topk_lists
    fn.restype = ctypes.c_int
    fn.argtypes = []
    return fn()


def _launcher(dtype: torch.dtype = torch.float32):
    if dtype not in _fns:
        lib = cuda_build.load("fused_topk")
        fn = getattr(lib, ARMS[dtype][0])
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p] * 5)
        _fns[dtype] = (lib, fn)
    return _fns[dtype]


def fused_topk_plain(q: torch.Tensor, x: torch.Tensor,
                     x_sqnorm: torch.Tensor, valid: torch.Tensor, k: int,
                     ascending: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of B1, both arms: the same function through
    a [b, n] score matrix (bf16 rows widen exactly; the query stays f32).
    Returns (scores[b, k] f32, slots[b, k] i32)."""
    q32 = q.to(torch.float32)
    dots = q32 @ x.to(torch.float32).T
    if ascending:   # L2: -(||q||^2 - 2 q.x + ||x||^2)
        qsq = (q32 * q32).sum(dim=1)
        scores = -((qsq[:, None] - 2.0 * dots) + x_sqnorm[None, :])
    else:           # IP
        scores = dots
    return topk_scores(scores, k, valid=valid.to(torch.bool)[None, :])


def split_rows(n: int, b: int, num_sms: int, tile: int = ROWS_PER_TILE,
               per_sm: int = 4) -> int:
    """Slot rows per CTA: about `per_sm` CTAs per SM over the whole grid,
    in whole scan tiles of `tile` rows."""
    tiles = -(-n // tile)
    qtiles = -(-b // QUERIES_PER_TILE)
    nsplit = min(tiles, max(1, -(-per_sm * num_sms // qtiles)))
    return -(-tiles // nsplit) * tile


def tma_ready(*tensors: torch.Tensor) -> bool:
    """The kernels' TMA copies take row-major matrices whose row pitch is a
    multiple of 16 bytes from a 16-byte aligned base; others go through
    the same ring by plain loads."""
    return all(t.shape[-1] * t.element_size() % 16 == 0
               and t.data_ptr() % 16 == 0 for t in tensors)


def fused_topk(q: torch.Tensor, x: torch.Tensor, x_sqnorm: torch.Tensor,
               valid: torch.Tensor, k: int, ascending: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q[b, d] vs x[n, d] -> (scores[b, k] f32 'larger is better',
    slots[b, k] i32, -1 where the score is -inf). valid: [n] bool."""
    tensors = (q, x, x_sqnorm, valid)
    if all(t.device.type == "cpu" for t in tensors):
        SENTINEL.launch("fused_topk", tensors, k)
        return fused_topk_plain(q, x, x_sqnorm, valid, k, ascending)
    if not cuda_build.same_cuda_device(*tensors):
        raise ValueError("fused_topk: tensors must share one CUDA device")
    b, d = q.shape
    n = x.shape[0]
    if not 1 <= k <= K_MAX:
        raise ValueError(f"fused_topk: k={k} outside [1, {K_MAX}]")
    if q.dtype != torch.float32 or x.dtype not in ARMS \
            or x_sqnorm.dtype != torch.float32:
        raise TypeError("fused_topk: q and x_sqnorm must be float32, x "
                        "float32 or bfloat16")
    if valid.dtype not in (torch.bool, torch.uint8):
        raise TypeError("fused_topk: valid must be bool or uint8")
    if x.dim() != 2 or x.shape[1] != d or x_sqnorm.shape != (n,) \
            or valid.shape != (n,) or b < 1 or n < 1:
        raise ValueError("fused_topk: shape mismatch")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_topk: tensors must be contiguous")
    dev = q.device
    props = torch.cuda.get_device_properties(dev)
    # one CTA an SM (its ring and lists take most of the shared memory)
    rows = split_rows(n, b, props.multi_processor_count, B1_ROWS_PER_TILE, 1)
    nsplit = -(-n // rows)
    lib, fn = _launcher(x.dtype)
    lists = _lists_per_query(lib) * nsplit
    cand_v = torch.empty((b, lists, k), dtype=torch.float32, device=dev)
    cand_i = torch.empty((b, lists, k), dtype=torch.int32, device=dev)
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(q.data_ptr(), x.data_ptr(), x_sqnorm.data_ptr(),
            valid.view(torch.uint8).data_ptr(), b, n, d, k, int(ascending),
            rows, int(tma_ready(x, q)), cand_v.data_ptr(), cand_i.data_ptr(),
            out_v.data_ptr(), out_i.data_ptr(), stream)
    cuda_build.check_launch(lib, rc, "fused_topk")
    SENTINEL.launch("fused_topk", tensors, k)
    counter = ARMS[x.dtype][1]
    setattr(fused_topk, counter, getattr(fused_topk, counter) + 1)
    return out_v, out_i


fused_topk.launches = 0
fused_topk.launches_bf16 = 0
