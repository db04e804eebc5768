"""Kernel B2: IVF probed-bucket scan + running top-k (port of
dingo_tpu/ops/pallas_ivf.py::ivf_list_topk), in its two row arms:

  f32   buckets f32, the query f32 (``ivf_list_topk.launches``);
  bf16  buckets bf16, the query f32 (pallas_ivf.py:65;
        ``ivf_list_topk.launches_bf16``).

``ivf_list_topk`` launches the arm of the buckets' dtype in
``csrc/ivf_topk.cu`` for CUDA tensors and runs ``ivf_list_topk_plain``
(the same arm) for CPU tensors; any other placement raises. k <= K_MAX
(the JAX package's own gate, ivf_flat.py:885, is k <= 64).

The kernel walks B3's work list (``kernel_ivf_pruned.probe_items_plain``:
items of a bucket and up to 8 of its queries), so a bucket is read once
per item, and multiplies on the tensor cores in split precision (3xTF32
for f32 rows, a three-way bf16 split of the query for bf16 rows;
``ops/split_dot.py`` models both and the per-pair candidate layout).
Bound on an H100 and design: see the note at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from dingo_tpu_torch.obs.sentinel import SENTINEL
from dingo_tpu_torch.ops import cuda_build
from dingo_tpu_torch.ops.kernel_topk import tma_ready
from dingo_tpu_torch.ops.topk import topk_scores

K_MAX = 64
#: the TPU kernel padded per-query arrays to this many rows; kept for the
#: callers that pad batches the same way
ROW_BLOCK = 8

#: bucket dtype -> (C entry point, launch counter attribute)
ARMS = {torch.float32: ("dingo_ivf_list_topk", "launches"),
        torch.bfloat16: ("dingo_ivf_list_topk_bf16", "launches_bf16")}

_fns: dict = {}


def _launcher(dtype: torch.dtype = torch.float32):
    if dtype not in _fns:
        lib = cuda_build.load("ivf_topk")
        fn = getattr(lib, ARMS[dtype][0])
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p] * 6)
        _fns[dtype] = (lib, fn)
    return _fns[dtype]


def _parts(lib, cap: int) -> int:
    """Parts the kernel scans an item of a cap-row bucket in (each pair's
    candidates have this many rows of k)."""
    fn = lib.dingo_ivf_list_parts
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int]
    return fn(cap)


def _pad_rows(queries: torch.Tensor, vprobes: torch.Tensor):
    """Pad the per-query arrays to the ROW_BLOCK multiple; padded queries
    probe nothing (vprobes -1)."""
    pad = (-queries.shape[0]) % ROW_BLOCK
    if pad:
        queries = torch.cat([queries, queries.new_zeros(
            (pad, queries.shape[1]))])
        vprobes = torch.cat([vprobes, vprobes.new_full(
            (pad, vprobes.shape[1]), -1)])
    return queries, vprobes


def ivf_list_topk_plain(vprobes: torch.Tensor, queries: torch.Tensor,
                        buckets: torch.Tensor, bucket_sqnorm: torch.Tensor,
                        bucket_valid: torch.Tensor,
                        bucket_slot: torch.Tensor, k: int,
                        ascending: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of B2, both arms: gathers each probe rank's
    buckets (bf16 rows widen exactly; the query stays f32) and scores
    them, then one top-k over all probed rows."""
    b, budget = vprobes.shape
    cap = buckets.shape[1]
    q32 = queries.to(torch.float32)
    qsq = (q32 * q32).sum(dim=1)
    scores = torch.empty((b, budget, cap), dtype=torch.float32,
                         device=queries.device)
    slots = torch.empty((b, budget, cap), dtype=torch.int32,
                        device=queries.device)
    for r in range(budget):
        lists = vprobes[:, r].long()
        ok = lists >= 0
        lc = torch.where(ok, lists, torch.zeros_like(lists))
        dots = torch.einsum("bd,bcd->bc", q32,
                            buckets[lc].to(torch.float32))
        if ascending:
            s = -((qsq[:, None] - 2.0 * dots) + bucket_sqnorm[lc])
        else:
            s = dots
        live = bucket_valid[lc].to(torch.bool) & ok[:, None]
        scores[:, r] = torch.where(live, s, torch.full_like(s, -torch.inf))
        slots[:, r] = bucket_slot[lc].to(torch.int32)
    vals, idx = topk_scores(scores.reshape(b, budget * cap), k)
    flat = slots.reshape(b, budget * cap)
    out = torch.gather(flat, 1, idx.clamp_min(0).long())
    out = torch.where(idx < 0, torch.full_like(out, -1), out)
    return vals, out


def ivf_list_topk(vprobes: torch.Tensor, queries: torch.Tensor,
                  buckets: torch.Tensor, bucket_sqnorm: torch.Tensor,
                  bucket_valid: torch.Tensor, bucket_slot: torch.Tensor,
                  k: int, ascending: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probed-bucket scan -> (scores[b, k] f32 'larger is better',
    slots[b, k] i32, -1 where fewer than k valid rows were probed).

    vprobes[b, budget] i32 (-1 = padded rank); queries[b, d] f32;
    buckets[B, cap, d] f32 or bf16; bucket_sqnorm[B, cap] f32;
    bucket_valid [B, cap] bool; bucket_slot[B, cap] i32."""
    tensors = (vprobes, queries, buckets, bucket_sqnorm, bucket_valid,
               bucket_slot)
    if all(t.device.type == "cpu" for t in tensors):
        SENTINEL.launch("ivf_list_topk", tensors, k)
        return ivf_list_topk_plain(vprobes, queries, buckets, bucket_sqnorm,
                                   bucket_valid, bucket_slot, k, ascending)
    if not cuda_build.same_cuda_device(*tensors):
        raise ValueError("ivf_list_topk: tensors must share one CUDA device")
    b, budget = vprobes.shape
    nb, cap, d = buckets.shape
    if not 1 <= k <= K_MAX:
        raise ValueError(f"ivf_list_topk: k={k} outside [1, {K_MAX}]")
    if vprobes.dtype != torch.int32 or bucket_slot.dtype != torch.int32:
        raise TypeError("ivf_list_topk: vprobes and bucket_slot must be int32")
    if queries.dtype != torch.float32 or buckets.dtype not in ARMS \
            or bucket_sqnorm.dtype != torch.float32:
        raise TypeError("ivf_list_topk: queries and bucket_sqnorm must be "
                        "float32, buckets float32 or bfloat16")
    if bucket_valid.dtype not in (torch.bool, torch.uint8):
        raise TypeError("ivf_list_topk: bucket_valid must be bool or uint8")
    if queries.shape != (b, d) or bucket_sqnorm.shape != (nb, cap) \
            or bucket_valid.shape != (nb, cap) \
            or bucket_slot.shape != (nb, cap) or b < 1 or budget < 1:
        raise ValueError("ivf_list_topk: shape mismatch")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ivf_list_topk: tensors must be contiguous")
    dev = queries.device
    lib, fn = _launcher(buckets.dtype)
    # the work list (7 b budget + 2) and the queries' norms (b)
    work = torch.empty((7 * b * budget + 2 + b,), dtype=torch.int32,
                       device=dev)
    parts = _parts(lib, cap)
    cand_v = torch.empty((b, budget, parts, k), dtype=torch.float32,
                         device=dev)
    cand_i = torch.empty((b, budget, parts, k), dtype=torch.int32,
                         device=dev)
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(buckets.data_ptr(), vprobes.data_ptr(), queries.data_ptr(),
            bucket_sqnorm.data_ptr(), bucket_valid.view(torch.uint8).data_ptr(),
            bucket_slot.data_ptr(), b, budget, nb, cap, d, k, int(ascending),
            int(tma_ready(buckets, queries)), work.data_ptr(),
            cand_v.data_ptr(), cand_i.data_ptr(),
            out_v.data_ptr(), out_i.data_ptr(), stream)
    cuda_build.check_launch(lib, rc, "ivf_list_topk")
    SENTINEL.launch("ivf_list_topk", tensors, k)
    counter = ARMS[buckets.dtype][1]
    setattr(ivf_list_topk, counter, getattr(ivf_list_topk, counter) + 1)
    return out_v, out_i


ivf_list_topk.launches = 0
ivf_list_topk.launches_bf16 = 0
