"""Kernel B5: IVF_PQ Quick-ADC probed-bucket scan + running top-k (port of
dingo_tpu/ops/pallas_pq.py::ivf_pq_adc_topk), and the residual tables it
reads (port of the XLA program dingo_tpu/index/ivf_pq.py::_ivfpq_adc_lut).

``ivf_pq_adc_topk`` launches the CUDA kernel in ``csrc/ivf_pq_adc_topk.cu``
and ``ivfpq_adc_lut`` the one in ``csrc/ivfpq_adc_lut.cu`` for CUDA
tensors; for CPU tensors they run ``ivf_pq_adc_topk_plain`` and
``ivfpq_adc_lut_plain``; any other placement raises. k <= K_MAX (the JAX
package's gate, ivf_pq.py:663, is max(k, topk * ivfpq_rerank_factor) <=
64); a rank's table m * ksub floats must fit the kernel's shared memory
(MAX_TABLE_FLOATS).

B5 runs one CTA per (query, coarse rank) and selects block-wide: after
every SEG rows the rows above the running list's k-th best join the list,
which keeps the best K_MAX of the union by an order-preserving uint32
image of the scores (slot order among equal scores); a second kernel
streams each query's [nprobe, k] rank lists through the same pick.
``rank_select_plain``, ``rank_lists_plain`` and ``merge_lists_plain``
model both passes for the tests.

Bound on an H100 and design: see the notes at the top of the CUDA sources.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from dingo_tpu_torch.obs.sentinel import SENTINEL
from dingo_tpu_torch.ops import cuda_build
from dingo_tpu_torch.ops.pq import codebook_sqnorms, residual_lut_tables
from dingo_tpu_torch.ops.topk import topk_scores

K_MAX = 64
#: largest m * ksub the launch sizes its shared-memory table for (192 KiB:
#: m up to 192 at ksub 256)
MAX_TABLE_FLOATS = 192 * 256
#: rows B5 scores between two selections, and at a bucket's end
#: (csrc/ivf_pq_adc_topk.cu SEG)
SEG = 512

_fn = None
_lut_fn = None


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


def _lut_launcher():
    global _lut_fn
    if _lut_fn is None:
        lib = cuda_build.load("ivfpq_adc_lut")
        fn = lib.dingo_ivfpq_adc_lut
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p] * 2)
        _lut_fn = (lib, fn)
    return _lut_fn


# -- the residual tables --------------------------------------------------------
def ivfpq_adc_lut_plain(queries: torch.Tensor, centroids: torch.Tensor,
                        probes_coarse: torch.Tensor, codebooks: torch.Tensor
                        ) -> torch.Tensor:
    """Residual ADC tables [b, nprobe, m, ksub] (contiguous) over the coarse
    probe ranking: the operand kernel B5 keeps in shared memory per
    (query, rank)."""
    b, d = queries.shape
    m, ksub, _ = codebooks.shape
    nprobe = probes_coarse.shape[1]
    resid = (queries[:, None, :] - centroids[probes_coarse.long()]).reshape(
        b * nprobe, d)
    lut = residual_lut_tables(resid, codebooks, codebook_sqnorms(codebooks))
    return lut.reshape(b, nprobe, m, ksub).contiguous()


def ivfpq_adc_lut(queries: torch.Tensor, centroids: torch.Tensor,
                  probes_coarse: torch.Tensor, codebooks: torch.Tensor
                  ) -> torch.Tensor:
    """lut[q, r, j, c] = (q_sq - 2 dot) + cb_sq[j, c] over the residual
    queries[q] - centroids[probes_coarse[q, r]] in subspace j: [b, nprobe,
    m, ksub] f32 contiguous. queries [b, d] and centroids [nlist, d] f32;
    probes_coarse [b, nprobe] i32; codebooks [m, ksub, dsub] f32 with d =
    m * dsub and ksub a multiple of 4; all contiguous."""
    tensors = (queries, centroids, probes_coarse, codebooks)
    if all(t.device.type == "cpu" for t in tensors):
        SENTINEL.launch("ivfpq_adc_lut", tensors)
        return ivfpq_adc_lut_plain(*tensors)
    if not cuda_build.same_cuda_device(*tensors):
        raise ValueError("ivfpq_adc_lut: tensors must share one CUDA device")
    b, d = queries.shape
    m, ksub, dsub = codebooks.shape
    nlist = centroids.shape[0]
    if probes_coarse.dim() != 2 or probes_coarse.shape[0] != b \
            or centroids.shape[1] != d or d != m * dsub:
        raise ValueError("ivfpq_adc_lut: shape mismatch")
    if ksub % 4 or not 4 <= ksub <= 1024:
        raise ValueError(f"ivfpq_adc_lut: ksub={ksub} must be a multiple "
                         "of 4 in [4, 1024]")
    if queries.dtype != torch.float32 or centroids.dtype != torch.float32 \
            or codebooks.dtype != torch.float32:
        raise TypeError("ivfpq_adc_lut: queries, centroids and codebooks "
                        "must be float32")
    if probes_coarse.dtype != torch.int32:
        raise TypeError("ivfpq_adc_lut: probes_coarse must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ivfpq_adc_lut: tensors must be contiguous")
    nprobe = probes_coarse.shape[1]
    lut = torch.empty((b, nprobe, m, ksub), dtype=torch.float32,
                      device=queries.device)
    lib, fn = _lut_launcher()
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    rc = fn(queries.data_ptr(), centroids.data_ptr(),
            probes_coarse.data_ptr(), codebooks.data_ptr(), b, d, nlist,
            nprobe, m, ksub, dsub, lut.data_ptr(), stream)
    cuda_build.check_launch(lib, rc, "ivfpq_adc_lut")
    SENTINEL.launch("ivfpq_adc_lut", tensors)
    ivfpq_adc_lut.launches += 1
    return lut


ivfpq_adc_lut.launches = 0


# -- B5's selection, modelled on the host ---------------------------------------
def score_keys(scores: torch.Tensor) -> torch.Tensor:
    """The kernel's order-preserving image of f32 scores as int64 in [0,
    2^32): a > b iff key(a) > key(b); -inf and NaN map to 0 (an empty
    entry, never selected)."""
    u = scores.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64) & 0xFFFFFFFF
    key = torch.where(u >= 0x80000000, 0xFFFFFFFF - u, u | 0x80000000)
    return torch.where(scores > -torch.inf, key, torch.zeros_like(key))


def rank_select_plain(segments: List[Tuple[torch.Tensor, torch.Tensor]],
                      k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """B5's selection for one stream of offers: `segments` are the
    (scores, slots) of each SEG-row step in scan order. A running list of
    the best K_MAX (key, slot) pairs, ordered by key descending and then
    slot ascending, and its k-th key (0 while it holds fewer than k); each
    step's rows above that key join the list, which keeps the best K_MAX
    of the union. Returns the list's first k (scores [k] descending, -inf
    past the valid entries; slots [k], -1 there)."""
    lk = torch.zeros(0, dtype=torch.int64)
    ls = torch.zeros(0, dtype=torch.int64)
    for scores, slots in segments:
        keys = score_keys(scores.reshape(-1))
        thr = int(lk[k - 1]) if len(lk) >= k else 0
        cand = keys > thr
        if not bool(cand.any()):
            continue
        uk = torch.cat([lk, keys[cand]])
        us = torch.cat([ls, slots.reshape(-1).to(torch.int64)[cand]])
        order = sorted(range(len(uk)),
                       key=lambda i: (-int(uk[i]), int(us[i])))[:K_MAX]
        lk, ls = uk[order], us[order]
    lk, ls = lk[:k], ls[:k]
    vals = torch.full((k,), -torch.inf, dtype=torch.float32)
    out = torch.full((k,), -1, dtype=torch.int64)
    if len(lk):
        u = torch.where(lk >= 0x80000000, lk & 0x7FFFFFFF, 0xFFFFFFFF - lk)
        u = torch.where(u >= 0x80000000, u - (1 << 32), u)
        vals[:len(lk)] = u.to(torch.int32).view(torch.float32)
        out[:len(lk)] = ls
    return vals, out


def rank_lists_plain(vprobes: torch.Tensor, coarse_pos: torch.Tensor,
                     lut_all: torch.Tensor, code_buckets: torch.Tensor,
                     bucket_valid: torch.Tensor, bucket_slot: torch.Tensor,
                     k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """B5's first pass modelled on the host: for each (query, coarse rank)
    the probes whose coarse_pos is that rank, in budget order, scanned in
    the kernel's steps (SEG rows, and the end of each bucket) through
    rank_select_plain. Returns the [b, nprobe, k] lists the second pass
    (merge_lists_plain) folds (scores descending, -inf / -1 past a rank's
    valid rows)."""
    b, budget = vprobes.shape
    nprobe, ksub = lut_all.shape[1], lut_all.shape[3]
    nb, cap, m = code_buckets.shape
    vals = torch.full((b, nprobe, k), -torch.inf, dtype=torch.float32)
    slots = torch.full((b, nprobe, k), -1, dtype=torch.int32)
    offs = torch.arange(m) * ksub
    for q in range(b):
        for r in range(nprobe):
            steps = []
            lut = lut_all[q, r].reshape(-1).cpu()
            for i in range(budget):
                bkt = int(vprobes[q, i])
                if int(coarse_pos[q, i]) != r or not 0 <= bkt < nb:
                    continue
                codes = code_buckets[bkt].long().cpu() + offs[None, :]
                dist = torch.zeros(cap, dtype=torch.float32)
                for j in range(m):     # subspace order, as the kernel adds
                    dist = dist + lut[codes[:, j]]
                sc = torch.where(bucket_valid[bkt].cpu().bool(), -dist,
                                 torch.full_like(dist, -torch.inf))
                for lo in range(0, cap, SEG):
                    steps.append((sc[lo:lo + SEG],
                                  bucket_slot[bkt, lo:lo + SEG].cpu()))
            v, s_ = rank_select_plain(steps, k)
            vals[q, r], slots[q, r] = v, s_.to(torch.int32)
    return vals, slots


def merge_lists_plain(vals: torch.Tensor, slots: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B5's second pass modelled on the host: each query's [nprobe, k]
    rank lists, flattened in rank order, through rank_select_plain in
    steps of SEG. Returns ([b, k] scores, [b, k] int32 slots)."""
    b = vals.shape[0]
    v, s_ = vals.reshape(b, -1), slots.reshape(b, -1)
    out_v = torch.empty((b, k), dtype=torch.float32)
    out_i = torch.empty((b, k), dtype=torch.int32)
    for q in range(b):
        steps = [(v[q, lo:lo + SEG], s_[q, lo:lo + SEG])
                 for lo in range(0, v.shape[1], SEG)]
        out_v[q], mi = rank_select_plain(steps, k)
        out_i[q] = mi.to(torch.int32)
    return out_v, out_i


# -- kernel B5 ---------------------------------------------------------------------


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
        SENTINEL.launch("ivf_pq_adc_topk", tensors, k)
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
    lut_bulk = (m * ksub) % 4 == 0 and lut_all.data_ptr() % 16 == 0
    dev = lut_all.device
    cand_v = torch.empty((b, nprobe, k), dtype=torch.float32, device=dev)
    cand_i = torch.empty((b, nprobe, k), dtype=torch.int32, device=dev)
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    lib, fn = _launcher()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(vprobes.data_ptr(), coarse_pos.data_ptr(), lut_all.data_ptr(),
            code_buckets.data_ptr(), bucket_valid.view(torch.uint8).data_ptr(),
            bucket_slot.data_ptr(), b, budget, nprobe, nb, cap, m, ksub, k,
            code_vec, int(lut_bulk), cand_v.data_ptr(), cand_i.data_ptr(),
            out_v.data_ptr(), out_i.data_ptr(), stream)
    cuda_build.check_launch(lib, rc, "ivf_pq_adc_topk")
    SENTINEL.launch("ivf_pq_adc_topk", tensors, k)
    ivf_pq_adc_topk.launches += 1
    return out_v, out_i


ivf_pq_adc_topk.launches = 0
