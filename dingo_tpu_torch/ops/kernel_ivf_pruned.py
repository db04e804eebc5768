"""Kernel B3: dimension-blocked early-pruning IVF list scan (port of
dingo_tpu/ops/pallas_ivf.py::ivf_pruned_topk and ivf_pruned_search), in
its three row arms (pallas_ivf.py:296-310):

  f32   buckets f32, query f32 (``ivf_pruned_topk.launches``);
  bf16  buckets bf16 widened exactly to f32, query f32
        (``ivf_pruned_topk.launches_bf16``);
  sq8   uint8 codes with the codec vmin/scale [d]: decoded in f32
        (code * scale + vmin), rounded to bf16; the query rounded to
        bf16; f32 accumulation (``ivf_pruned_topk.launches_sq8``).

Norms, bounds and stats are f32 in every arm. ``ivf_pruned_topk`` launches
the arm of the buckets' dtype in ``csrc/ivf_pruned_topk.cu`` for CUDA
tensors and runs ``ivf_pruned_topk_plain`` (the same arm) for CPU tensors;
any other placement raises. k <= K_MAX (the JAX package's own gate,
ivf_flat.py:885).

The plain version walks the JAX kernel's own order step by step (probe
ranks in order for each query, dimension blocks innermost, the prune
check every `check_every` blocks, the in-bucket refresh with its
1e-5 |lb| + 1e-6 shave), so its results and stats lanes are the JAX
package's. ``scan_unit_plain`` is that per-bucket step; B4's plain version
reuses it per row block. Each arm's operands go into it already in the
form the arm multiplies (``arm_query``, ``arm_rows``).

Stats lanes per query: 0 = candidate-block pairs scanned, 1 = pairs
total, 2 = candidates scanned to the last block, 3 = candidates
considered. The kernel may walk candidates in another order, so it may
prune more or less: lanes 1 and 3 always equal the plain version's, and
0 <= lane0 <= lane1, lane2 <= lane3.

The kernel walks the probes bucket-major: one work item is a bucket and
up to ``QT`` of the queries that probe it, so a bucket's rows are staged
once for all of them. ``probe_items_plain`` defines that work list (the
kernel builds the same one on the device; ``probe_items`` returns it).
With ``ivf_pruned_topk.count_staged`` set, ``ivf_pruned_topk.staged``
holds after a launch a device counter of the row slices (a row's
dimension block) the launch staged.

Bound on an H100 and design: see the note at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Callable, Tuple

import torch

from dingo_tpu_torch.obs.sentinel import SENTINEL
from dingo_tpu_torch.ops import cuda_build
from dingo_tpu_torch.ops.blocked import query_prefix_sqnorms
from dingo_tpu_torch.ops.kernel_ivf import K_MAX, _pad_rows
from dingo_tpu_torch.ops.sq import sq_decode_device

NEG_INF = float("-inf")
#: queries per work item (csrc/ivf_pruned_topk.cu QT; checked at load)
QT = 8

#: bucket dtype -> (C entry point, launch counter attribute)
ARMS = {torch.float32: ("dingo_ivf_pruned_topk", "launches"),
        torch.bfloat16: ("dingo_ivf_pruned_topk_bf16", "launches_bf16"),
        torch.uint8: ("dingo_ivf_pruned_topk_sq8", "launches_sq8")}

_fns: dict = {}


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to bf16 (nearest, ties to even), back in f32."""
    return t.to(torch.float32).to(torch.bfloat16).to(torch.float32)


def arm_query(q32: torch.Tensor, round_q: bool) -> torch.Tensor:
    """The query as an arm multiplies it: f32, or rounded to bf16 where
    the arm pairs bf16 operands (sq8 in B3; bf16 and sq8 in B4). Its norms
    stay those of the f32 query."""
    return round_bf16(q32) if round_q else q32


def arm_rows(x: torch.Tensor, col0: int, sq_vmin=None, sq_scale=None
             ) -> torch.Tensor:
    """Rows (or a dimension block of them starting at column col0) as an
    arm multiplies them, in f32: f32 and bf16 rows exactly, sq8 codes
    decoded in f32 and rounded to bf16."""
    if x.dtype == torch.uint8:
        w = x.shape[-1]
        return sq_decode_device(x, sq_vmin[col0:col0 + w],
                                sq_scale[col0:col0 + w]).to(torch.float32)
    return x.to(torch.float32)


def ord_neg_inf() -> int:
    """The kernels' order-preserving int image of -inf (csrc
    topk_common.cuh ord_of): the start value of each query's shared
    k-th best."""
    i = struct.unpack("<i", struct.pack("<f", NEG_INF))[0]
    return i if i >= 0 else i ^ 0x7FFFFFFF


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("ivf_pruned_topk")
    qt = lib.dingo_ivf_pruned_qt
    qt.restype = ctypes.c_int
    if qt() != QT:
        raise RuntimeError(f"ivf_pruned_topk: the library's QT {qt()} is "
                           f"not the wrapper's {QT}")
    return lib


def _launcher(dtype: torch.dtype = torch.float32):
    if dtype not in _fns:
        lib = _library()
        fn = getattr(lib, ARMS[dtype][0])
        fn.restype = ctypes.c_int
        codec = 2 if dtype == torch.uint8 else 0
        fn.argtypes = ([ctypes.c_void_p] * (1 + codec + 7)
                       + [ctypes.c_int] * 12 + [ctypes.c_void_p] * 9)
        _fns[dtype] = (lib, fn)
    return _fns[dtype]


def _stable_topk(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """Top k per row, ties to the earlier column (the JAX kernels'
    max/argmax rounds); rows shorter than k pad with (-inf, -1)."""
    b, c = vals.shape
    if c < k:
        vals = torch.cat([vals, vals.new_full((b, k - c), NEG_INF)], dim=1)
        ids = torch.cat([ids, ids.new_full((b, k - c), -1)], dim=1)
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices
    order = order[:, :k]
    return torch.gather(vals, 1, order), torch.gather(ids, 1, order)


def scan_unit_plain(q: torch.Tensor, qsq: torch.Tensor, qpsq: torch.Tensor,
                    x_block: Callable[[int], torch.Tensor],
                    bsq: torch.Tensor, xsq: torch.Tensor,
                    alive: torch.Tensor, ids: torch.Tensor,
                    best_v: torch.Tensor, best_i: torch.Tensor,
                    stats: torch.Tensor, k: int, ascending: bool,
                    check_every: int, inbucket: bool, init_thr=None):
    """One pruned scan unit (a probed bucket in B3, a row block in B4) for
    every query at once, in the JAX kernels' step order.

    q [b, d] f32 as the arm multiplies it (arm_query), qsq [b] and qpsq
    [b, nblk] of the f32 query; x_block(jb) -> [u, C, dblk] rows of block
    jb as the arm multiplies them (arm_rows; u = b per-query buckets, or 1
    shared rows); bsq [u, nblk,
    C]; xsq [u, C]; alive [b, C] f32 (1 = a candidate of this unit); ids
    [u, C] i32; init_thr [b] f32 or None, a prune threshold the running
    k-th best starts from. Adds to stats [b, 4] in place; returns the new
    running (best_v, best_i) [b, k]."""
    b, c = alive.shape
    nblk = qpsq.shape[1]
    dblk = q.shape[1] // nblk
    nvalid = alive.sum(dim=1)
    stats[:, 1] += nvalid * nblk
    stats[:, 3] += nvalid
    cum = torch.zeros((b, c), dtype=torch.float32, device=q.device)
    xpsq = torch.zeros(xsq.shape, dtype=torch.float32, device=q.device)
    for jb in range(nblk):
        nalive = alive.sum(dim=1)
        stats[:, 0] += nalive
        if jb == nblk - 1:
            stats[:, 2] += nalive
        if not bool((nalive > 0.5).any()):
            break      # nothing alive: no later block computes either
        qj = q[:, jb * dblk:(jb + 1) * dblk]
        x = x_block(jb).to(torch.float32)
        if x.shape[0] == 1:
            dots = qj @ x[0].T
        else:
            dots = torch.einsum("bd,bcd->bc", qj, x)
        cum = cum + dots
        xpsq = xpsq + bsq[:, jb]
        bound = best_v[:, k - 1:k]                  # running k-th best
        if init_thr is not None:
            bound = torch.maximum(bound, init_thr[:, None])
        qpsq_j = qpsq[:, jb:jb + 1]
        qtail = torch.clamp_min(qsq[:, None] - qpsq_j, 0.0)
        xtail = torch.clamp_min(xsq - xpsq, 0.0)
        if ascending:
            partial = qpsq_j - 2.0 * cum + xpsq
            ub = -partial
            final = ub
        else:
            ub = cum + torch.sqrt(qtail * xtail)
            final = cum
        if jb < nblk - 1 and (jb + 1) % check_every == 0:
            bnd = bound
            if inbucket:
                if ascending:
                    tail = torch.sqrt(qtail) + torch.sqrt(xtail)
                    lb = -(partial + tail * tail)
                else:
                    lb = cum - torch.sqrt(qtail * xtail)
                lb = lb - 1e-5 * torch.abs(lb) - 1e-6    # f32 safety shave
                lb = torch.where(alive > 0.5, lb,
                                 torch.full_like(lb, NEG_INF))
                if c >= k:
                    lb_k = torch.topk(lb, k, dim=1).values[:, k - 1:k]
                    bnd = torch.maximum(bnd, lb_k)
            alive = torch.where(ub < bnd, torch.zeros_like(alive), alive)
        if jb == nblk - 1:
            scores = torch.where(alive > 0.5, final,
                                 torch.full_like(final, NEG_INF))
            blk_v, blk_i = _stable_topk(scores, ids.expand(b, c), k)
            best_v, best_i = _stable_topk(torch.cat([best_v, blk_v], 1),
                                          torch.cat([best_i, blk_i], 1), k)
    return best_v, best_i


def ivf_pruned_topk_plain(vprobes: torch.Tensor, queries: torch.Tensor,
                          qpsq: torch.Tensor, buckets: torch.Tensor,
                          bucket_bsq: torch.Tensor,
                          bucket_sqnorm: torch.Tensor,
                          bucket_valid: torch.Tensor,
                          bucket_slot: torch.Tensor, k: int,
                          ascending: bool = True, check_every: int = 1,
                          inbucket: bool = True, sq_vmin=None, sq_scale=None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Plain PyTorch version of B3, every arm (the buckets' dtype picks
    it) -> (scores[b, k], slots[b, k], stats[b, 4] f32)."""
    b, budget = vprobes.shape
    nb, cap, d = buckets.shape
    nblk = qpsq.shape[1]
    dblk = d // nblk
    dev = queries.device
    q32 = queries.to(torch.float32)
    qsq = (q32 * q32).sum(dim=1)
    qdot = arm_query(q32, buckets.dtype == torch.uint8)
    best_v = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    stats = torch.zeros((b, 4), dtype=torch.float32, device=dev)
    for r in range(budget):
        lists = vprobes[:, r].long()
        ok = (lists >= 0) & (lists < nb)
        if not bool(ok.any()):
            continue
        lc = torch.where(ok, lists, torch.zeros_like(lists))
        rows = buckets[lc]                                # [b, cap, d]
        alive = (bucket_valid[lc].to(torch.bool) & ok[:, None]).to(
            torch.float32)
        best_v, best_i = scan_unit_plain(
            qdot, qsq, qpsq,
            lambda jb: arm_rows(rows[:, :, jb * dblk:(jb + 1) * dblk],
                                jb * dblk, sq_vmin, sq_scale),
            bucket_bsq[lc], bucket_sqnorm[lc], alive,
            bucket_slot[lc].to(torch.int32), best_v, best_i, stats, k,
            ascending, check_every, inbucket)
    best_i = torch.where(torch.isneginf(best_v),
                         torch.full_like(best_i, -1), best_i)
    return best_v, best_i, stats


def probe_items_plain(vprobes: torch.Tensor, nbuckets: int, qt: int = QT
                      ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The scan's work list -> (pairs [n] i32, items [n, 3] i32, n_items),
    n = b * budget.

    A pair is a valid probe (0 <= bucket < nbuckets) as q * budget + r;
    ``pairs`` lists them grouped by bucket (ascending), by rank then query
    within a bucket, -1 past the valid ones. Each bucket's pairs are cut
    in that order into chunks of qt: the items. ``items`` holds (bucket,
    index of its first pair in ``pairs``, pair count) in visiting order:
    by the rank of the item's first pair, then bucket, then position in
    the bucket, so every item that holds a rank-0 pair comes first; -1
    past n_items."""
    b, budget = vprobes.shape
    n = b * budget
    dev = vprobes.device
    p = torch.arange(n, dtype=torch.int64, device=dev)
    bkt = vprobes.reshape(-1).to(torch.int64)
    r, q = p % budget, p // budget
    valid = (bkt >= 0) & (bkt < nbuckets)
    big = torch.iinfo(torch.int64).max
    key = torch.where(valid, (bkt * budget + r) * b + q,
                      torch.full_like(bkt, big))
    order = torch.sort(key, stable=True).indices
    nvalid = int(valid.sum())
    sp = order[:nvalid]
    sb = bkt[sp]
    start = torch.searchsorted(sb, sb)
    count = torch.searchsorted(sb, sb, right=True) - start
    pos = torch.arange(nvalid, device=dev) - start
    heads = torch.nonzero(pos % qt == 0).flatten()
    ikey = (r[sp[heads]] * nbuckets + sb[heads]) * n + pos[heads]
    heads = heads[torch.sort(ikey).indices]
    pairs = torch.full((n,), -1, dtype=torch.int32, device=dev)
    pairs[:nvalid] = sp.to(torch.int32)
    items = torch.full((n, 3), -1, dtype=torch.int32, device=dev)
    items[:len(heads), 0] = sb[heads].to(torch.int32)
    items[:len(heads), 1] = heads.to(torch.int32)
    items[:len(heads), 2] = torch.clamp_max(count[heads] - pos[heads],
                                            qt).to(torch.int32)
    return pairs, items, len(heads)


def probe_items(vprobes: torch.Tensor, nbuckets: int
                ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The work list as the kernel builds it on the device, in
    probe_items_plain's form (reads its length back: a test and
    measurement helper, not on the search path)."""
    if vprobes.device.type != "cuda" or vprobes.dtype != torch.int32 \
            or not vprobes.is_contiguous():
        raise ValueError("probe_items: a contiguous int32 CUDA tensor")
    b, budget = vprobes.shape
    n = b * budget
    work = torch.full((7 * n + 2,), -1, dtype=torch.int32,
                      device=vprobes.device)
    lib = _library()
    fn = lib.dingo_ivf_pruned_items
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p] * 2
    rc = fn(vprobes.data_ptr(), b, budget, nbuckets, work.data_ptr(),
            torch.cuda.current_stream(vprobes.device).cuda_stream)
    cuda_build.check_launch(lib, rc, "probe_items")
    # the kernels write the valid pairs and the n_items items; the rest of
    # work keeps its -1
    items = torch.stack([work[4 * n:5 * n], work[5 * n:6 * n],
                         work[6 * n:7 * n]], dim=1)
    return work[:n], items, int(work[7 * n])


def ivf_pruned_topk(vprobes: torch.Tensor, queries: torch.Tensor,
                    qpsq: torch.Tensor, buckets: torch.Tensor,
                    bucket_bsq: torch.Tensor, bucket_sqnorm: torch.Tensor,
                    bucket_valid: torch.Tensor, bucket_slot: torch.Tensor,
                    k: int, ascending: bool = True, check_every: int = 1,
                    inbucket: bool = True, sq_vmin=None, sq_scale=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Early-pruning probed-bucket scan -> (scores[b, k] f32 'larger is
    better', slots[b, k] i32 with -1 where the score is -inf, stats[b, 4]
    f32).

    vprobes[b, budget] i32 (-1 = padded rank); queries[b, d] f32;
    qpsq[b, nblk] f32 inclusive per-block prefix norms (of the f32
    queries); buckets[B, cap, d] f32, bf16, or uint8 codes with sq_vmin /
    sq_scale [d] f32; bucket_bsq[B, nblk, cap] f32 and bucket_sqnorm[B,
    cap] f32, the norms of what the arm accumulates (the f32 decode for
    codes); bucket_valid[B, cap] bool; bucket_slot[B, cap] i32."""
    sq = buckets.dtype == torch.uint8
    if sq and (sq_vmin is None or sq_scale is None):
        raise ValueError("ivf_pruned_topk: uint8 buckets need sq_vmin and "
                         "sq_scale")
    tensors = (vprobes, queries, qpsq, buckets, bucket_bsq, bucket_sqnorm,
               bucket_valid, bucket_slot) + ((sq_vmin, sq_scale) if sq
                                             else ())
    if all(t.device.type == "cpu" for t in tensors):
        SENTINEL.launch("ivf_pruned_topk", tensors, k)
        return ivf_pruned_topk_plain(*tensors[:8], k, ascending, check_every,
                                     inbucket, sq_vmin, sq_scale)
    if not cuda_build.same_cuda_device(*tensors):
        raise ValueError("ivf_pruned_topk: tensors must share one CUDA "
                         "device")
    b, budget = vprobes.shape
    nb, cap, d = buckets.shape
    nblk = qpsq.shape[1] if qpsq.dim() == 2 else 0
    if not 1 <= k <= K_MAX:
        raise ValueError(f"ivf_pruned_topk: k={k} outside [1, {K_MAX}]")
    if vprobes.dtype != torch.int32 or bucket_slot.dtype != torch.int32:
        raise TypeError("ivf_pruned_topk: vprobes and bucket_slot must be "
                        "int32")
    if buckets.dtype not in ARMS or any(
            t.dtype != torch.float32 for t in (queries, qpsq, bucket_bsq,
                                               bucket_sqnorm)
            + tensors[8:]):
        raise TypeError("ivf_pruned_topk: buckets must be float32, "
                        "bfloat16 or uint8; queries, qpsq, bucket_bsq, "
                        "bucket_sqnorm and the codec float32")
    if bucket_valid.dtype not in (torch.bool, torch.uint8):
        raise TypeError("ivf_pruned_topk: bucket_valid must be bool or "
                        "uint8")
    if nblk < 1 or d % nblk or queries.shape != (b, d) \
            or qpsq.shape != (b, nblk) \
            or bucket_bsq.shape != (nb, nblk, cap) \
            or bucket_sqnorm.shape != (nb, cap) \
            or bucket_valid.shape != (nb, cap) \
            or bucket_slot.shape != (nb, cap) or b < 1 or budget < 1 \
            or check_every < 1 \
            or any(t.shape != (d,) for t in tensors[8:]):
        raise ValueError("ivf_pruned_topk: shape mismatch")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ivf_pruned_topk: tensors must be contiguous")
    dblk = d // nblk
    dev = queries.device
    # 16 bytes per lane and load: 4 f32, 8 bf16 or 16 codes
    per16 = 16 // buckets.element_size()
    vec = d % per16 == 0 and dblk % per16 == 0 \
        and buckets.data_ptr() % 16 == 0
    thr = torch.full((b,), ord_neg_inf(), dtype=torch.int32, device=dev)
    stats = torch.zeros((b, 4), dtype=torch.int32, device=dev)
    work = torch.empty((7 * b * budget + 2,), dtype=torch.int32, device=dev)
    staged = torch.zeros((1,), dtype=torch.int32, device=dev) \
        if ivf_pruned_topk.count_staged else None
    cand_v = torch.empty((b, budget, k), dtype=torch.float32, device=dev)
    cand_i = torch.empty((b, budget, k), dtype=torch.int32, device=dev)
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    lib, fn = _launcher(buckets.dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream
    codec = (sq_vmin.data_ptr(), sq_scale.data_ptr()) if sq else ()
    rc = fn(buckets.data_ptr(), *codec, vprobes.data_ptr(),
            queries.data_ptr(), qpsq.data_ptr(), bucket_bsq.data_ptr(),
            bucket_sqnorm.data_ptr(),
            bucket_valid.view(torch.uint8).data_ptr(),
            bucket_slot.data_ptr(), b, budget, nb, cap, d, dblk, k,
            int(ascending), int(check_every), int(inbucket), int(vec),
            int(ivf_pruned_topk.seed), thr.data_ptr(), stats.data_ptr(),
            work.data_ptr(), None if staged is None else staged.data_ptr(),
            cand_v.data_ptr(), cand_i.data_ptr(), out_v.data_ptr(),
            out_i.data_ptr(), stream)
    cuda_build.check_launch(lib, rc, "ivf_pruned_topk")
    SENTINEL.launch("ivf_pruned_topk", tensors, k)
    ivf_pruned_topk.staged = staged
    counter = ARMS[buckets.dtype][1]
    setattr(ivf_pruned_topk, counter, getattr(ivf_pruned_topk, counter) + 1)
    return out_v, out_i, stats.to(torch.float32)


ivf_pruned_topk.launches = 0
ivf_pruned_topk.launches_bf16 = 0
ivf_pruned_topk.launches_sq8 = 0
#: set to fill ivf_pruned_topk.staged with the row slices a launch staged
ivf_pruned_topk.count_staged = False
ivf_pruned_topk.staged = None
#: the rank-0 seed launch before the scan (same results either way)
ivf_pruned_topk.seed = True


def ivf_pruned_search(vprobes: torch.Tensor, queries: torch.Tensor,
                      buckets: torch.Tensor, bucket_bsq: torch.Tensor,
                      bucket_sqnorm: torch.Tensor,
                      bucket_valid: torch.Tensor, bucket_slot: torch.Tensor,
                      k: int, dim_block: int, ascending: bool = True,
                      sq_vmin=None, sq_scale=None):
    """The index's entry to B3: pads the per-query arrays to the
    ROW_BLOCK multiple (padded rows probe nothing), computes the query
    prefix norms, reads check_every and the in-bucket refresh from the
    flags -> (scores[b, k], slots[b, k], stats[b, 4]). sq_vmin/sq_scale
    are the codec of uint8 buckets."""
    from dingo_tpu_torch.common.config import FLAGS

    b = queries.shape[0]
    queries, vprobes = _pad_rows(queries, vprobes)
    qpsq = query_prefix_sqnorms(queries, dim_block)
    check = max(1, int(FLAGS.get("ivf_prune_check_interval")))
    vals, slots, stats = ivf_pruned_topk(
        vprobes.contiguous(), queries.contiguous(), qpsq, buckets,
        bucket_bsq, bucket_sqnorm, bucket_valid, bucket_slot, k, ascending,
        check, bool(FLAGS.get("ivf_prune_inbucket_bound")), sq_vmin,
        sq_scale)
    return vals[:b], slots[:b], stats[:b]
