"""Kernel B5: IVF_PQ Quick-ADC probed-bucket scan + running top-k (port of
dingo_tpu/ops/pallas_pq.py::ivf_pq_adc_topk).

``ivf_pq_adc_topk`` launches the CUDA kernel in ``csrc/ivf_pq_adc_topk.cu``
for CUDA tensors and runs ``ivf_pq_adc_topk_plain`` for CPU tensors; any
other placement raises. k <= K_MAX (the JAX package's gate, ivf_pq.py:663,
is max(k, topk * ivfpq_rerank_factor) <= 64); a rank's table m * ksub
floats must fit the kernel's shared memory (MAX_TABLE_FLOATS).

Bound on an H100 and design: see the note at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from dingo_tpu_torch.ops import cuda_build
from dingo_tpu_torch.ops.topk import topk_scores

K_MAX = 64
#: largest m * ksub the launch sizes its shared-memory table for (192 KiB:
#: m up to 192 at ksub 256)
MAX_TABLE_FLOATS = 192 * 256

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = cuda_build.load("ivf_pq_adc_topk")
        fn = lib.dingo_ivf_pq_adc_topk
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                       + [ctypes.c_void_p] * 5)
        _fn = (lib, fn)
    return _fn


def ivf_pq_adc_topk_plain(vprobes: torch.Tensor, coarse_pos: torch.Tensor,
                          lut_all: torch.Tensor, code_buckets: torch.Tensor,
                          bucket_valid: torch.Tensor,
                          bucket_slot: torch.Tensor, k: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of B5: per probe rank, gathers the rank's
    table by coarse_pos and the bucket's codes, sums the looked-up entries
    over the subspaces, masks, then one top-k over all probed rows."""
    b, budget = vprobes.shape
    cap = code_buckets.shape[1]
    dev = lut_all.device
    rows = torch.arange(b, device=dev)
    scores = torch.empty((b, budget, cap), dtype=torch.float32, device=dev)
    slots = torch.empty((b, budget, cap), dtype=torch.int32, device=dev)
    for r in range(budget):
        lists = vprobes[:, r].long()
        ok = lists >= 0
        lc = torch.where(ok, lists, torch.zeros_like(lists))
        cp = torch.where(ok, coarse_pos[:, r].long(), torch.zeros_like(lists))
        lut = lut_all[rows, cp]                              # [b, m, ksub]
        codes = code_buckets[lc].long().transpose(1, 2)      # [b, m, cap]
        dist = torch.gather(lut, 2, codes).sum(dim=1)        # [b, cap]
        live = bucket_valid[lc].to(torch.bool) & ok[:, None]
        scores[:, r] = torch.where(live, -dist,
                                   torch.full_like(dist, -torch.inf))
        slots[:, r] = bucket_slot[lc].to(torch.int32)
    vals, idx = topk_scores(scores.reshape(b, budget * cap), k)
    flat = slots.reshape(b, budget * cap)
    out = torch.gather(flat, 1, idx.clamp_min(0).long())
    out = torch.where(idx < 0, torch.full_like(out, -1), out)
    return vals, out


def ivf_pq_adc_topk(vprobes: torch.Tensor, coarse_pos: torch.Tensor,
                    lut_all: torch.Tensor, code_buckets: torch.Tensor,
                    bucket_valid: torch.Tensor, bucket_slot: torch.Tensor,
                    k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused ADC probed-bucket scan -> (scores[b, k] f32 = negated ADC
    distances, larger is better; slots[b, k] i32, -1 where fewer than k
    valid rows were probed).

    vprobes[b, budget] i32 (-1 = padded rank); coarse_pos[b, budget] i32,
    the coarse rank whose table a probe reads (a list's spill buckets share
    one); lut_all[b, nprobe, m, ksub] f32 residual tables; code_buckets
    [B, cap, m] u8; bucket_valid [B, cap] bool; bucket_slot [B, cap] i32."""
    tensors = (vprobes, coarse_pos, lut_all, code_buckets, bucket_valid,
               bucket_slot)
    if all(t.device.type == "cpu" for t in tensors):
        return ivf_pq_adc_topk_plain(*tensors, k)
    if not cuda_build.same_cuda_device(*tensors):
        raise ValueError("ivf_pq_adc_topk: tensors must share one CUDA "
                         "device")
    b, budget = vprobes.shape
    nb, cap, m = code_buckets.shape
    if not 1 <= k <= K_MAX:
        raise ValueError(f"ivf_pq_adc_topk: k={k} outside [1, {K_MAX}]")
    if vprobes.dtype != torch.int32 or coarse_pos.dtype != torch.int32 \
            or bucket_slot.dtype != torch.int32:
        raise TypeError("ivf_pq_adc_topk: vprobes, coarse_pos and "
                        "bucket_slot must be int32")
    if lut_all.dtype != torch.float32 or code_buckets.dtype != torch.uint8:
        raise TypeError("ivf_pq_adc_topk: lut_all must be float32 and "
                        "code_buckets uint8")
    if bucket_valid.dtype not in (torch.bool, torch.uint8):
        raise TypeError("ivf_pq_adc_topk: bucket_valid must be bool or "
                        "uint8")
    if lut_all.dim() != 4 or lut_all.shape[0] != b \
            or lut_all.shape[2] != m or coarse_pos.shape != (b, budget) \
            or bucket_valid.shape != (nb, cap) \
            or bucket_slot.shape != (nb, cap) or b < 1 or budget < 1:
        raise ValueError("ivf_pq_adc_topk: shape mismatch")
    nprobe, ksub = lut_all.shape[1], lut_all.shape[3]
    if not 1 <= ksub <= 256 or m * ksub > MAX_TABLE_FLOATS or nprobe < 1:
        raise ValueError(f"ivf_pq_adc_topk: table m={m} x ksub={ksub} "
                         f"outside the kernel's {MAX_TABLE_FLOATS} floats")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ivf_pq_adc_topk: tensors must be contiguous")
    code_vec = next(v for v in (16, 8, 4, 1)
                    if m % v == 0 and code_buckets.data_ptr() % v == 0)
    lut_vec4 = (m * ksub) % 4 == 0 and lut_all.data_ptr() % 16 == 0
    dev = lut_all.device
    cand_v = torch.empty((b, budget, k), dtype=torch.float32, device=dev)
    cand_i = torch.empty((b, budget, k), dtype=torch.int32, device=dev)
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    lib, fn = _launcher()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(vprobes.data_ptr(), coarse_pos.data_ptr(), lut_all.data_ptr(),
            code_buckets.data_ptr(), bucket_valid.view(torch.uint8).data_ptr(),
            bucket_slot.data_ptr(), b, budget, nprobe, nb, cap, m, ksub, k,
            code_vec, int(lut_vec4), cand_v.data_ptr(), cand_i.data_ptr(),
            out_v.data_ptr(), out_i.data_ptr(), stream)
    cuda_build.check_launch(lib, rc, "ivf_pq_adc_topk")
    ivf_pq_adc_topk.launches += 1
    return out_v, out_i


ivf_pq_adc_topk.launches = 0
