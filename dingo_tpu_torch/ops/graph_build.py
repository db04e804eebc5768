"""Batched device-side HNSW construction (port of
dingo_tpu/ops/graph_build.py).

The host graph inserts one row at a time through native ``hnsw_add``.
This module builds the level-0 graph that the device tier serves
(``SlotStore.adj``) on the card, one pow2 insert batch at a time:

  candidate discovery   the lockstep beam walk (ops/beam.py) runs the batch
                        rows as queries against the partially built
                        adjacency; an intra-batch all-pairs top-k adds
                        same-batch neighbours the partial graph cannot see
                        yet, and bootstraps the first batch

  neighbour selection   RNG*-style occlusion pruning as ``deg`` rounds of
                        masked argmax over the candidate scores: each round
                        keeps the best surviving candidate and occludes
                        every candidate that scores closer to the kept one
                        than to the inserted point, ``alpha^2 * s(c, kept)
                        > s(c, p)`` in the larger-is-better score space of
                        ops/rerank._scores_from_rows. The candidate-to-kept
                        scores come from one Gram matrix of the gathered
                        candidate rows a batch instead of one product a
                        round

  reverse edges         the selected edges sort by destination; each run
                        head re-prunes its row once against its old
                        neighbours plus up to REVERSE_WINDOW same-batch
                        incomers, degree-clamped by a plain top-deg, in
                        chunks of REVERSE_CHUNK edges. Incomers past the
                        window drop and are counted (``build.reverse_dropped``)

The candidate scores of discovery, selection and reprune all go through
kernel G (ops/kernel_beam.py). Ties follow the JAX package's ``lax.top_k``
and ``jnp.argmax`` (lowest index first): stable sorts, and ``argmax``'s
first maximum.

The JAX package donates the adjacency into each insert program; here the
builder owns the adjacency and updates it in place under
``store.device_lock``. It keeps one extra row past the capacity that
absorbs the writes of padded lanes and dropped edges (the JAX package's
``mode="drop"`` scatter; torch raises on an out-of-range index). Nothing
here reads a result back per batch: the entry slot and the drop counter
stay on the device and ``BulkGraphBuilder.finish()`` reads them once. The
discovery walk reads one flag every CONVERGED_CHECK rounds to stop at
convergence, as the JAX build's while_loop does.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from dingo_tpu_torch.common.metrics import METRICS
from dingo_tpu_torch.ops.beam import beam_search
from dingo_tpu_torch.ops.devfault import DEVFAULT
from dingo_tpu_torch.ops.distance import Metric, squared_norms
from dingo_tpu_torch.ops import kernel_beam
from dingo_tpu_torch.ops.sq import sq_decode_device

#: same-batch incomers one destination row can absorb per flushed batch;
#: overflow drops and counts
REVERSE_WINDOW = 8

#: edge-list chunk of the reverse re-prune
REVERSE_CHUNK = 1024

#: rounds between the discovery walk's host reads of "any query still
#: active" (ops/beam.py converged_check): the JAX build's while_loop exits
#: at convergence, and a fixed max_iters would run ~40 no-op rounds a batch
CONVERGED_CHECK = 4


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _decoded_rows(vecs, slots, sq, vmin, scale):
    """Rows at `slots` in the scoring representation: sq8 codes decode to
    the bf16 surrogate, float tiers as stored."""
    rows = vecs[slots.long()]
    if sq:
        rows = sq_decode_device(rows, vmin, scale)
    return rows


def _pair_scores(rows, sqn, metric):
    """[B, B] larger-is-better scores among the batch rows (f32), one
    product. These only propose candidates; every survivor is re-scored
    through the shared math in the selection stage."""
    dots = rows @ rows.T
    if metric is Metric.L2:
        return -(sqn[:, None] - 2.0 * dots + sqn[None, :])
    if metric is Metric.COSINE:
        return dots * torch.rsqrt(torch.clamp_min(sqn, 1e-30))[None, :]
    return dots


def _topk_stable(scores: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along dim 1, ties to the lower index."""
    v, i = torch.sort(scores, dim=1, descending=True, stable=True)
    return v[:, :k], i[:, :k]


def _dedup_sorted(cand: torch.Tensor, cap: int) -> torch.Tensor:
    """Sort candidate slots ascending (holes last) and hole out repeats."""
    cs = torch.where(cand >= 0, cand, torch.full_like(cand, cap))
    cs, _ = torch.sort(cs, dim=1)
    dup = torch.cat([torch.zeros_like(cs[:, :1], dtype=torch.bool),
                     cs[:, 1:] == cs[:, :-1]], dim=1)
    return torch.where((cs < cap) & ~dup, cs,
                       torch.full_like(cs, -1)).to(torch.int32)


class _Clock:
    """Phase timer of one insert (syncs the card at each phase end); off
    unless the builder was given a timings dict."""

    def __init__(self, timings: Optional[dict], dev: torch.device):
        self.t = timings
        self.dev = dev
        self.t0 = self._now() if timings is not None else 0.0

    def _now(self) -> float:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        return time.perf_counter()

    def lap(self, phase: str) -> None:
        if self.t is None:
            return
        t1 = self._now()
        self.t[phase] = self.t.get(phase, 0.0) + (t1 - self.t0)
        self.t0 = t1


def insert_batch(adj: torch.Tensor, vecs: torch.Tensor, sqnorm: torch.Tensor,
                 valid: torch.Tensor, batch_slots: torch.Tensor,
                 entry: torch.Tensor, vmin: torch.Tensor, scale: torch.Tensor,
                 beam: int, max_iters: int, metric: Metric, sq: bool,
                 alpha_sq: float, timings: Optional[dict] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Insert one pow2 batch of store rows into the partial adjacency.

    adj [cap + 1, deg] int32 (-1 padded; the last row absorbs dropped
    writes) is updated in place. batch_slots [B] int32, -1 padding the
    last partial batch (padded lanes select and install nothing). entry
    [] int32 is the walk's entry (-1 while the graph is empty). `timings`
    (a dict) accumulates seconds of the walk, the selection and the
    reprune, synchronizing the card at each.

    Returns (entry' [] int32, reverse_dropped [] int32: same-batch reverse
    edges past REVERSE_WINDOW), both on the device.
    """
    DEVFAULT.maybe_fail("ops.build.insert")
    clock = _Clock(timings, adj.device)
    cap = adj.shape[0] - 1
    deg = adj.shape[1]
    graph = adj[:cap]
    b = batch_slots.shape[0]
    sv, ss = (vmin, scale) if sq else (None, None)
    bvalid = batch_slots >= 0
    safe_b = torch.clamp_min(batch_slots, 0)
    rows = _decoded_rows(vecs, safe_b, sq, vmin, scale)
    qd = rows.to(torch.float32)
    bsq = sqnorm[safe_b.long()]

    # -- candidate discovery -------------------------------------------------
    res_slots, _, _, _ = beam_search(graph, vecs, sqnorm, valid, valid, qd,
                                     entry, vmin, scale, beam, max_iters,
                                     metric, sq,
                                     converged_check=CONVERGED_CHECK)
    ib = min(b, beam)
    pair = _pair_scores(qd, bsq, metric)
    eye = torch.eye(b, dtype=torch.bool, device=adj.device)
    pair = torch.where(eye | ~bvalid[None, :] | ~bvalid[:, None],
                       torch.full_like(pair, -torch.inf), pair)
    pv, pi = _topk_stable(pair, ib)
    intra = torch.where(torch.isneginf(pv), torch.full_like(pi, -1),
                        safe_b.long()[pi]).to(torch.int32)
    cand = torch.cat([res_slots, intra], dim=1)               # [b, C]
    cand = torch.where(cand == batch_slots[:, None],
                       torch.full_like(cand, -1), cand)
    cand = _dedup_sorted(cand, cap)
    clock.lap("walk")

    # -- occlusion selection -------------------------------------------------
    nc = cand.shape[1]
    live = cand >= 0
    csafe = torch.clamp_min(cand, 0).long()
    s_pc = kernel_beam.candidate_scores(qd, vecs, sqnorm, cand, metric, sv,
                                        ss)
    crows = _decoded_rows(vecs, csafe, sq, vmin, scale).to(torch.float32)
    csq = sqnorm[csafe]
    gram = torch.bmm(crows, crows.transpose(1, 2))            # [b, C, C]
    rown = squared_norms(crows.reshape(-1, crows.shape[-1])).reshape(b, nc)
    col = torch.arange(nc, device=adj.device)
    selected = torch.full((b, deg), -1, dtype=torch.int32, device=adj.device)
    alive = live.clone()
    ninf = torch.full_like(s_pc, -torch.inf)
    for i in range(deg):
        masked = torch.where(alive, s_pc, ninf)
        j = torch.argmax(masked, dim=1, keepdim=True)         # [b, 1]
        ok = masked.gather(1, j)[:, 0] > -torch.inf
        pick = cand.gather(1, j)[:, 0]
        selected[:, i] = torch.where(ok, pick, torch.full_like(pick, -1))
        alive &= col[None, :] != j
        # scores of every candidate against the kept row (its Gram row)
        dots = gram.gather(1, j[:, :, None].expand(b, 1, nc))[:, 0, :]
        if metric is Metric.L2:
            kept_sq = rown.gather(1, j)
            s_ck = -(kept_sq - 2.0 * dots + csq)
        elif metric is Metric.COSINE:
            s_ck = dots * torch.rsqrt(torch.clamp_min(csq, 1e-30))
        else:
            s_ck = dots
        # RNG* occlusion: c is dominated once the kept neighbour explains it
        # better than the inserted point does
        alive &= ~(ok[:, None] & (alpha_sq * s_ck > s_pc))
    del gram, crows
    clock.lap("select")

    # -- forward install (padded lanes write the spare row) -------------------
    tgt = torch.where(bvalid, batch_slots, cap).long()
    adj.index_copy_(0, tgt, selected)

    # -- reverse edges with degree-clamped re-pruning ------------------------
    ne = b * deg
    w = REVERSE_WINDOW
    dst = selected.reshape(-1)
    src = batch_slots.repeat_interleave(deg)
    ok_e = (dst >= 0) & (src >= 0)
    key = torch.where(ok_e, dst, cap).to(torch.int32)
    order = torch.sort(key, stable=True).indices
    dsts = key[order]
    srcs = torch.where(ok_e, src, -1)[order]
    idx = torch.arange(ne, device=adj.device)
    head = (dsts < cap) & torch.cat(
        [torch.ones(1, dtype=torch.bool, device=adj.device),
         dsts[1:] != dsts[:-1]])
    run_start = torch.cummax(torch.where(head, idx, -1), dim=0).values
    dropped = ((dsts < cap) & (idx - run_start >= w)).sum(dtype=torch.int32)

    rc = min(REVERSE_CHUNK, _next_pow2(ne))
    pad = (-ne) % rc
    if pad:
        dsts = torch.cat([dsts, dsts.new_full((pad,), cap)])
        srcs = torch.cat([srcs, srcs.new_full((pad,), -1)])
        head = torch.cat([head, head.new_zeros((pad,))])
    nep = ne + pad
    wins = torch.arange(w, device=adj.device)
    # every chunk re-prunes against the adjacency after the forward
    # install: heads are unique per destination, so a chunk's install
    # never touches a row a later chunk reads for a head
    for s in range(0, nep, rc):
        ii = s + torch.arange(rc, device=adj.device)
        d_e = dsts[s:s + rc]
        h_e = head[s:s + rc]
        dsafe = torch.where(d_e < cap, d_e, 0).long()
        old = adj[dsafe]                                      # [rc, deg]
        win = ii[:, None] + wins[None, :]
        wclip = torch.clamp(win, 0, nep - 1)
        inc = torch.where((dsts[wclip] == d_e[:, None]) & (win < nep),
                          srcs[wclip], -1).to(torch.int32)
        cand2 = torch.cat([old, inc], dim=1)                  # [rc, deg+w]
        cand2 = torch.where(cand2 == d_e[:, None],
                            torch.full_like(cand2, -1), cand2)
        cand2 = _dedup_sorted(cand2, cap)
        drow = _decoded_rows(vecs, dsafe, sq, vmin, scale).to(torch.float32)
        s2 = kernel_beam.candidate_scores(drow, vecs, sqnorm, cand2, metric,
                                          sv, ss)
        v2, i2 = _topk_stable(s2, deg)
        new_row = torch.where(torch.isneginf(v2), torch.full_like(i2, -1),
                              cand2.gather(1, i2).long()).to(torch.int32)
        tgt2 = torch.where(h_e & (d_e < cap), d_e, cap).long()
        adj.index_copy_(0, tgt2, new_row)
    adj[cap] = -1
    clock.lap("reprune")

    # -- entry: the first inserted row anchors all later walks ---------------
    first = batch_slots.gather(
        0, torch.argmax(bvalid.to(torch.int32)).reshape(1))[0]
    entry = torch.where(entry >= 0, entry,
                        torch.where(bvalid.any(), first,
                                    torch.full_like(first, -1)))
    return entry.to(torch.int32), dropped


class BulkGraphBuilder:
    """Accumulates store slots into pow2 insert batches and keeps the
    adjacency under construction on the device. Slot/store level only:
    index-level bookkeeping (row puts, the native back-fill) lives in
    index/hnsw.py's bulk session.

    Not thread-safe; one builder per build. Flushes take store.device_lock.
    Set ``timings`` to a dict to split the build's time by phase (walk,
    select, reprune; this synchronizes the card per phase)."""

    def __init__(self, store, deg: int, metric, *, sq: bool = False,
                 batch_rows: int = 256, beam: int = 64,
                 max_iters: int = 48, alpha: float = 1.0,
                 region_id: int = 0):
        self.store = store
        self.deg = max(1, int(deg))
        self.metric = metric
        self.sq = bool(sq)
        self.batch_rows = _next_pow2(max(8, int(batch_rows)))
        self.beam = max(8, int(beam))
        self.max_iters = max(1, int(max_iters))
        self.alpha_sq = float(alpha) * float(alpha)
        self.region_id = region_id
        self.rows = 0
        self.batches = 0
        self.timings: Optional[dict] = None
        self._pend = np.empty((0,), np.int32)
        self._adj: Optional[torch.Tensor] = None
        dev = store.device
        self._entry_d = torch.full((), -1, dtype=torch.int32, device=dev)
        self._dropped_d = torch.zeros((), dtype=torch.int32, device=dev)
        self._done = False

    def _ensure_adj(self) -> None:
        cap = self.store.capacity
        if self._adj is None:
            self._adj = torch.full((cap + 1, self.deg), -1,
                                   dtype=torch.int32,
                                   device=self.store.device)
        elif self._adj.shape[0] != cap + 1:
            # the store grew under the build: pad to match (callers that
            # reserve() capacity up front never get here)
            grown = self._adj.new_full((cap + 1, self.deg), -1)
            grown[:self._adj.shape[0] - 1] = self._adj[:-1]
            self._adj = grown

    def add_slots(self, slots: np.ndarray) -> None:
        """Queue freshly put store slots; full batches flush at once."""
        assert not self._done, "builder already finished"
        self._pend = np.concatenate(
            [self._pend, np.asarray(slots, np.int32)])
        while len(self._pend) >= self.batch_rows:
            self._flush(self._pend[:self.batch_rows])
            self._pend = self._pend[self.batch_rows:]

    def _flush(self, slots: np.ndarray) -> None:
        bb = self.batch_rows
        if len(slots) < bb:
            slots = np.concatenate(
                [slots, np.full(bb - len(slots), -1, np.int32)])
        store = self.store
        with store.device_lock:
            self._ensure_adj()
            sq_on = self.sq and getattr(store, "sq_params", None) is not None
            if sq_on:
                vmin, scale = store.sq_vmin_d, store.sq_scale_d
            else:
                vmin = torch.zeros((store.dim,), dtype=torch.float32,
                                   device=store.device)
                scale = torch.ones_like(vmin)
            from dingo_tpu_torch.common.device import upload

            self._entry_d, dropped = insert_batch(
                self._adj, store.vecs, store.sqnorm, store.device_mask(),
                upload(slots, store.device), self._entry_d, vmin, scale,
                beam=self.beam, max_iters=self.max_iters,
                metric=self.metric, sq=sq_on, alpha_sq=self.alpha_sq,
                timings=self.timings,
            )
            self._dropped_d = self._dropped_d + dropped
        n = int((slots >= 0).sum())
        self.rows += n
        self.batches += 1
        METRICS.counter("build.rows", region_id=self.region_id).add(n)
        METRICS.counter("build.batches", region_id=self.region_id).add(1)

    def finish(self) -> Tuple[torch.Tensor, int, dict]:
        """Flush the remainder and return (adj [cap, deg] int32 on the
        device, entry slot, stats). Reading the entry and the drop counter
        here is the build's one host sync."""
        assert not self._done, "builder already finished"
        self._done = True
        if len(self._pend):
            self._flush(self._pend)
            self._pend = np.empty((0,), np.int32)
        self._ensure_adj()    # a zero-row build still yields a mirror
        entry = int(self._entry_d.item())
        dropped = int(self._dropped_d.item())
        METRICS.counter("build.reverse_dropped",
                        region_id=self.region_id).add(dropped)
        return self._adj[:-1], entry, {
            "rows": self.rows,
            "batches": self.batches,
            "reverse_dropped": dropped,
        }
