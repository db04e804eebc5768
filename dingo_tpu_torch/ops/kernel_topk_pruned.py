"""Kernel B4: dimension-blocked early-pruning scan over the FLAT store's
blocked mirror (port of dingo_tpu/ops/pallas_topk.py::pruned_fused_topk
and pruned_fused_search), in its three row arms (pallas_topk.py:235-251):

  f32   mirror f32, query f32 (``pruned_fused_topk.launches``);
  bf16  mirror bf16, the query rounded to bf16: bf16 x bf16 products,
        f32 accumulation (``pruned_fused_topk.launches_bf16``);
  sq8   uint8 codes with the codec vmin/scale [d]: decoded in f32,
        rounded to bf16; the query rounded to bf16; f32 accumulation
        (``pruned_fused_topk.launches_sq8``).

``pruned_fused_topk`` launches the arm of the mirror's dtype in
``csrc/pruned_fused_topk.cu`` for CUDA tensors and runs
``pruned_fused_topk_plain`` (the same arm) for CPU tensors; any other
placement raises.
k <= K_MAX; callers route larger k to the XLA-equivalent arm themselves
(index/flat.py).

The plain version walks the JAX kernel's order: row blocks of `block`
slots in order, dimension blocks innermost, with the per-unit step of B3
(kernel_ivf_pruned.scan_unit_plain), so its stats lanes are the JAX
package's. The kernel splits the slot range across CTAs, so it prunes in
another order: lanes 1 and 3 equal the plain version's, lanes 0 and 2
only keep 0 <= lane0 <= lane1 and lane2 <= lane3.

Before its scan the kernel seeds each query's threshold with the k-th
best exact score over a strided sample of slots (``seed_slots``: every
SEED_STRIDE-th slot). The plain version takes the same seed through
``init_thr`` (``seed_threshold_plain`` computes it); by default it starts
unseeded, as the JAX kernel does. With ``pruned_fused_topk.count_tiles``
set, ``pruned_fused_topk.tiles`` holds, after a launch, the device counters
of its scan: (tile, block) steps computed, those on the f32 arm's pair by
pair path, and rows computed in all steps (rows computed / (valid rows x
blocks) is the share of the mirror's row bytes it read). Searches leave
the counters off.

Bound on an H100 and design: see the note at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from dingo_tpu_torch.obs.sentinel import SENTINEL
from dingo_tpu_torch.ops import cuda_build
from dingo_tpu_torch.ops.blocked import query_prefix_sqnorms
from dingo_tpu_torch.ops.kernel_ivf_pruned import (
    NEG_INF,
    arm_query,
    arm_rows,
    ord_neg_inf,
    scan_unit_plain,
)
from dingo_tpu_torch.ops.kernel_topk import K_MAX, split_rows

#: the JAX package's row block (pallas_topk.pruned_fused_search default)
BLOCK = 2048
#: the seed samples every SEED_STRIDE-th slot (n / 64 rows: ~1.5% of a
#: full scan's work)
SEED_STRIDE = 64

#: mirror dtype -> (C entry point, launch counter attribute)
ARMS = {torch.float32: ("dingo_pruned_fused_topk", "launches"),
        torch.bfloat16: ("dingo_pruned_fused_topk_bf16", "launches_bf16"),
        torch.uint8: ("dingo_pruned_fused_topk_sq8", "launches_sq8")}

_fns: dict = {}


def _launcher(dtype: torch.dtype = torch.float32):
    if dtype not in _fns:
        lib = cuda_build.load("pruned_fused_topk")
        fn = getattr(lib, ARMS[dtype][0])
        fn.restype = ctypes.c_int
        codec = 2 if dtype == torch.uint8 else 0
        fn.argtypes = ([ctypes.c_void_p] * (1 + codec + 6)
                       + [ctypes.c_int] * 12 + [ctypes.c_void_p] * 10)
        _fns[dtype] = (lib, fn)
    return _fns[dtype]


def pruned_fused_topk_plain(q: torch.Tensor, x_blk: torch.Tensor,
                            bsq_blk: torch.Tensor, x_sqnorm: torch.Tensor,
                            valid: torch.Tensor, k: int,
                            ascending: bool = True, check_every: int = 1,
                            inbucket: bool = True, block: int = BLOCK,
                            sq_vmin=None, sq_scale=None, init_thr=None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain PyTorch version of B4, every arm (the mirror's dtype picks
    it) -> (scores[b, k], slots[b, k], stats[b, 4] f32). n must be a
    multiple of `block`. init_thr [b] f32, if given, is a starting prune
    threshold per query (a score that k real rows reach, as the kernel's
    seed)."""
    nblk, n, dblk = x_blk.shape
    if n % block:
        raise ValueError(f"n={n} not a multiple of block={block}")
    b = q.shape[0]
    dev = q.device
    q32 = q.to(torch.float32)
    qsq = (q32 * q32).sum(dim=1)
    qpsq = query_prefix_sqnorms(q32, dblk)
    qdot = arm_query(q32, x_blk.dtype != torch.float32)
    best_v = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    stats = torch.zeros((b, 4), dtype=torch.float32, device=dev)
    gidx = torch.arange(n, dtype=torch.int32, device=dev)
    vf = valid.to(torch.float32)
    for j0 in range(0, n, block):
        sl = slice(j0, j0 + block)
        alive = vf[sl][None, :].expand(b, block).clone()
        best_v, best_i = scan_unit_plain(
            qdot, qsq, qpsq,
            lambda jb: arm_rows(x_blk[jb, sl][None], jb * dblk, sq_vmin,
                                sq_scale),
            bsq_blk[:, sl][None], x_sqnorm[sl][None], alive, gidx[sl][None],
            best_v, best_i, stats, k, ascending, check_every, inbucket,
            init_thr)
    best_i = torch.where(torch.isneginf(best_v),
                         torch.full_like(best_i, -1), best_i)
    return best_v, best_i, stats


def seed_slots(n: int, device=None) -> torch.Tensor:
    """The slots the kernel's seed launch scores: every SEED_STRIDE-th."""
    return torch.arange(0, n, SEED_STRIDE, dtype=torch.long, device=device)


def seed_threshold_plain(q: torch.Tensor, x_blk: torch.Tensor,
                         bsq_blk: torch.Tensor, x_sqnorm: torch.Tensor,
                         valid: torch.Tensor, k: int, ascending: bool = True,
                         sq_vmin=None, sq_scale=None) -> torch.Tensor:
    """Each query's k-th best exact score over the seed sample (-inf where
    the sample holds fewer than k valid rows), [b] f32: the threshold the
    kernel's seed launch publishes, by the plain arithmetic."""
    idx = seed_slots(x_blk.shape[1], x_blk.device)
    nblk = x_blk.shape[0]
    vals, _, _ = pruned_fused_topk_plain(
        q, x_blk[:, idx].contiguous(), bsq_blk[:, idx].contiguous(),
        x_sqnorm[idx], valid[idx], k, ascending, nblk + 1, False,
        len(idx), sq_vmin, sq_scale)
    return vals[:, k - 1]


def pruned_fused_topk(q: torch.Tensor, x_blk: torch.Tensor,
                      bsq_blk: torch.Tensor, x_sqnorm: torch.Tensor,
                      valid: torch.Tensor, k: int, ascending: bool = True,
                      check_every: int = 1, inbucket: bool = True,
                      sq_vmin=None, sq_scale=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q[b, d] f32 against the blocked mirror x_blk[nblk, n, dblk] (f32,
    bf16, or uint8 codes with sq_vmin / sq_scale [d] f32; bsq_blk[nblk,
    n] and x_sqnorm[n] f32, the norms of what the arm accumulates;
    valid[n] bool) -> (scores[b, k] f32
    'larger is better', slots[b, k] i32 with -1 where the score is -inf,
    stats[b, 4] f32). On the CPU the plain version walks row blocks of
    BLOCK slots, clamped to the mirror's capacity (a power of two >= 4096,
    so the clamp divides it) as pallas_topk.pruned_fused_search does."""
    sq = x_blk.dtype == torch.uint8
    if sq and (sq_vmin is None or sq_scale is None):
        raise ValueError("pruned_fused_topk: uint8 rows need sq_vmin and "
                         "sq_scale")
    tensors = (q, x_blk, bsq_blk, x_sqnorm, valid) + (
        (sq_vmin, sq_scale) if sq else ())
    if all(t.device.type == "cpu" for t in tensors):
        SENTINEL.launch("pruned_fused_topk", tensors, k)
        return pruned_fused_topk_plain(q, x_blk, bsq_blk, x_sqnorm, valid,
                                       k, ascending, check_every, inbucket,
                                       min(BLOCK, x_blk.shape[1]), sq_vmin,
                                       sq_scale)
    if not cuda_build.same_cuda_device(*tensors):
        raise ValueError("pruned_fused_topk: tensors must share one CUDA "
                         "device")
    b, d = q.shape
    nblk, n, dblk = x_blk.shape
    if not 1 <= k <= K_MAX:
        raise ValueError(f"pruned_fused_topk: k={k} outside [1, {K_MAX}]")
    if x_blk.dtype not in ARMS or any(
            t.dtype != torch.float32
            for t in (q, bsq_blk, x_sqnorm) + tensors[5:]):
        raise TypeError("pruned_fused_topk: x_blk must be float32, bfloat16 "
                        "or uint8; q, bsq_blk, x_sqnorm and the codec "
                        "float32")
    if valid.dtype not in (torch.bool, torch.uint8):
        raise TypeError("pruned_fused_topk: valid must be bool or uint8")
    if nblk * dblk != d or bsq_blk.shape != (nblk, n) \
            or x_sqnorm.shape != (n,) or valid.shape != (n,) or b < 1 \
            or n < 1 or check_every < 1 \
            or any(t.shape != (d,) for t in tensors[5:]):
        raise ValueError("pruned_fused_topk: shape mismatch")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("pruned_fused_topk: tensors must be contiguous")
    dev = q.device
    qpsq = query_prefix_sqnorms(q, dblk).contiguous()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = split_rows(n, b, sms)
    nsplit = -(-n // rows)
    nseed = -(-n // SEED_STRIDE)
    seed_rows = split_rows(nseed, b, sms)
    seed_split = -(-nseed // seed_rows)
    thr = torch.full((b,), ord_neg_inf(), dtype=torch.int32, device=dev)
    stats = torch.zeros((b, 4), dtype=torch.int32, device=dev)
    tiles = torch.zeros((3,), dtype=torch.int32, device=dev) \
        if pruned_fused_topk.count_tiles else None
    cand_v = torch.empty((b, nsplit, k), dtype=torch.float32, device=dev)
    cand_i = torch.empty((b, nsplit, k), dtype=torch.int32, device=dev)
    seed_v = torch.empty((b, seed_split, k), dtype=torch.float32, device=dev)
    seed_i = torch.empty((b, seed_split, k), dtype=torch.int32, device=dev)
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    # 16-byte loads: 8 bf16 values or 16 codes
    vec = x_blk.dtype != torch.float32 \
        and dblk % (16 // x_blk.element_size()) == 0 \
        and x_blk.data_ptr() % 16 == 0
    lib, fn = _launcher(x_blk.dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream
    codec = (sq_vmin.data_ptr(), sq_scale.data_ptr()) if sq else ()
    # the bf16 and sq8 arms multiply the query rounded to bf16 (arm_query)
    q16 = None if x_blk.dtype == torch.float32 else q.to(torch.bfloat16)
    rc = fn(x_blk.data_ptr(), *codec, q.data_ptr(),
            None if q16 is None else q16.data_ptr(), qpsq.data_ptr(),
            bsq_blk.data_ptr(), x_sqnorm.data_ptr(),
            valid.view(torch.uint8).data_ptr(), b, n, d, dblk, k,
            int(ascending), int(check_every), int(inbucket), rows, int(vec),
            SEED_STRIDE, seed_rows, thr.data_ptr(), stats.data_ptr(),
            None if tiles is None else tiles.data_ptr(), cand_v.data_ptr(),
            cand_i.data_ptr(), seed_v.data_ptr(), seed_i.data_ptr(),
            out_v.data_ptr(), out_i.data_ptr(), stream)
    cuda_build.check_launch(lib, rc, "pruned_fused_topk")
    SENTINEL.launch("pruned_fused_topk", tensors, k)
    pruned_fused_topk.tiles = tiles
    counter = ARMS[x_blk.dtype][1]
    setattr(pruned_fused_topk, counter,
            getattr(pruned_fused_topk, counter) + 1)
    return out_v, out_i, stats.to(torch.float32)


pruned_fused_topk.launches = 0
pruned_fused_topk.launches_bf16 = 0
pruned_fused_topk.launches_sq8 = 0
#: set to fill pruned_fused_topk.tiles with the scan's counters
pruned_fused_topk.count_tiles = False
pruned_fused_topk.tiles = None


def pruned_fused_search(q: torch.Tensor, x_blk: torch.Tensor,
                        bsq_blk: torch.Tensor, x_sqnorm: torch.Tensor,
                        valid: torch.Tensor, k: int,
                        ascending: bool = True, sq_vmin=None, sq_scale=None):
    """The index's entry to B4 over the blocked store mirror:
    check_every and the in-bucket refresh come from the flags;
    sq_vmin/sq_scale are the codec of a code mirror."""
    from dingo_tpu_torch.common.config import FLAGS

    check = max(1, int(FLAGS.get("ivf_prune_check_interval")))
    return pruned_fused_topk(
        q, x_blk, bsq_blk, x_sqnorm, valid, k, ascending, check,
        bool(FLAGS.get("ivf_prune_inbucket_bound")), sq_vmin, sq_scale)
