"""Batched lockstep beam search over a device-resident graph (port of
dingo_tpu/ops/beam.py::beam_search).

The host C++ graph walks one query at a time; this walk moves a batch of
queries in lockstep over the level-0 adjacency mirror, a dense
``[capacity, deg]`` int32 array in slot space (SlotStore.adj). Each round:

  frontier gather    one gather of the adjacency: [b, beam] beam slots ->
                     [b, beam * deg] candidate slots
  visited + dedup    a per-query visited map ``[b, capacity + 1]`` int32
                     (INT32_MAX = unvisited; the last column absorbs holes).
                     The new candidates (not visited, store-valid) scatter
                     their position into it with ``amin``: that marks them
                     visited and elects, per slot, the first of in-batch
                     repeats; the others become holes. (The JAX package
                     packs the set as [b, capacity/32] bits and sorts the
                     candidates by slot to drop repeats; the surviving set
                     is the same, and ties below break by slot as its
                     sorted order does.)
  candidate scores   kernel G (ops/kernel_beam.py): a score per live
                     candidate slot, holes -inf, no [b, C, d] gather
  beam update        the best ``beam`` of old beam + candidates, in the JAX
                     package's order: ``lax.top_k`` keeps the lowest index
                     among equal scores, the old beam before the candidates
                     and the candidates by slot. Candidates are preselected
                     by an exact top-k over (score, -slot) int64 keys and
                     merged with the old beam by a stable descending sort.

Termination. The JAX walk is a ``lax.while_loop`` that stops when every
query has converged or after ``max_iters`` rounds. Reading "every query
converged" here would need a host sync in the search dispatch, so the port
runs exactly ``max_iters`` rounds and reads nothing back. This is exact: a
query goes inactive in the round that admits no candidate into its routing
beam. Its beam is then unchanged, and that round marked every neighbour of
the beam visited (the invalid ones never become candidates), so each later
round gathers only holes for it: no score, no merge entry, no visited mark,
no change to any output. ``hops`` counts the rounds in which a query was
active, as the JAX walk's does. G skips the holes of converged rounds;
the torch ops of a round still run. The graph build, which is off the
serving path, passes ``converged_check`` and stops once a host read shows
every query inactive (the JAX build's while_loop exit, read every few
rounds).

Filter pushdown: two lists. The routing beam admits any store-valid node
(a filtered-out node must still conduct the walk), the result beam only
mask-eligible ones, so the caller reranks a filtered candidate set and no
host post-filter exists. Unfiltered searches pass the validity mask twice.

The returned slots are an unordered candidate set: the caller reranks it
exactly (ops/rerank.py), so the final order equals the host graph path's
whenever the candidate sets agree.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dingo_tpu_torch.ops.devfault import DEVFAULT
from dingo_tpu_torch.ops.distance import Metric
from dingo_tpu_torch.ops import kernel_beam

INT32_MAX = 2 ** 31 - 1
INT64_MIN = -(2 ** 63)


def _order_keys(scores: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """int64 keys that sort as (score descending, slot ascending). The f32
    score maps to an order-preserving int32 (the sign-magnitude flip), the
    slot to its complement."""
    bits = scores.contiguous().view(torch.int32)
    ordered = torch.where(bits >= 0, bits, bits ^ INT32_MAX).to(torch.int64)
    return ordered * (2 ** 32) + (INT32_MAX - slots.to(torch.int64))


def _merge(old_scores: torch.Tensor, old_slots: torch.Tensor,
           cscores: torch.Tensor, cand: torch.Tensor, keys: torch.Tensor,
           live: torch.Tensor, beam: int):
    """The JAX package's ``lax.top_k`` merge of [old beam, candidates] (the
    candidates in slot order, dead ones -inf): the best `beam` by score,
    ties to the lower position. `keys` are the candidates' _order_keys.
    Returns (scores, slots with -1 at -inf, whether a live candidate
    entered)."""
    b, c = cand.shape
    kk = min(beam, c)
    ckeys = torch.where(live, keys, INT64_MIN)
    _, pos = torch.topk(ckeys, kk, dim=1, sorted=True)
    tscores = torch.where(live.gather(1, pos), cscores.gather(1, pos),
                          -torch.inf)
    tslots = cand.gather(1, pos)
    allv = torch.cat([old_scores, tscores], dim=1)
    alls = torch.cat([old_slots, tslots], dim=1)
    mv, mi = torch.sort(allv, dim=1, descending=True, stable=True)
    mv, mi = mv[:, :beam], mi[:, :beam]
    fin = ~torch.isneginf(mv)
    ms = torch.where(fin, alls.gather(1, mi), torch.full_like(mi, -1))
    entered = ((mi >= beam) & fin).any(dim=1)
    return mv, ms.to(torch.int32), entered


def beam_search(adj: torch.Tensor, vecs: torch.Tensor, sqnorm: torch.Tensor,
                valid: torch.Tensor, fmask: torch.Tensor,
                queries: torch.Tensor, entry, vmin: Optional[torch.Tensor],
                scale: Optional[torch.Tensor], beam: int, max_iters: int,
                metric: Metric, sq: bool, converged_check: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """Lockstep graph walk; see the module docstring.

    adj     [cap, deg] int32 slot-space adjacency (-1 padded)
    vecs    [cap, d] rows (f32 / bf16 / uint8 sq codes when sq)
    sqnorm  [cap] f32 stored/decoded row norms (SlotStore convention)
    valid   [cap] bool store validity: gates routing and results
    fmask   [cap] bool filter pushdown: gates results only (pass `valid`
            again when unfiltered)
    queries [b, d] f32 (normalized for cosine); entry: the entry slot
            (int or 0-d int tensor on the device; -1 = empty graph)
    vmin/scale [d] f32 sq8 codec (used when sq)

    converged_check > 0: every that many rounds, read on the host whether
    any query is still active and stop when none is (the graph build's
    walks, off the serving path; the outputs are the same, see the module
    docstring). 0, the search's setting: exactly max_iters rounds and no
    host sync.

    Returns (res_slots [b, beam] int32, unordered, -1 padded; hops [b]
    int32 active rounds; vcount [b] int32 visited slots; occ [b] int32 live
    result entries).
    """
    DEVFAULT.maybe_fail("ops.beam.search")
    dev = queries.device
    b = queries.shape[0]
    cap, deg = adj.shape
    qd = queries.to(torch.float32)
    unfiltered = fmask is valid
    res_ok = valid if unfiltered else valid & fmask
    sv, ss = (vmin, scale) if sq else (None, None)

    def score(slots):
        return kernel_beam.scores(qd, vecs, sqnorm, slots, metric, sv, ss)

    if isinstance(entry, torch.Tensor):
        entry_t = entry.to(device=dev, dtype=torch.int32).reshape(())
    else:
        entry_t = torch.full((), int(entry), dtype=torch.int32, device=dev)
    entry_ok = entry_t >= 0
    # [1]-shaped indices: indexing with a 0-d tensor reads it on the host
    e_safe = torch.clamp_min(entry_t, 0).long().reshape(1)
    e_col = torch.where(entry_ok, entry_t, cap).long().reshape(1)

    # visited: INT32_MAX = unvisited; column `cap` absorbs holes
    vis = torch.full((b, cap + 1), INT32_MAX, dtype=torch.int32, device=dev)
    vis.scatter_(1, e_col.view(1, 1).expand(b, 1), 0)
    vis[:, cap] = INT32_MAX
    vcount = entry_ok.to(torch.int32).expand(b).clone()

    # seed: the entry anchors the routing beam even when it is tombstoned or
    # filtered out (its neighbours must be reachable; its -inf score drops
    # it at the first merge), and joins the result beam only if eligible
    ecol = torch.where(entry_ok, entry_t, -1).expand(b, 1).contiguous()
    es = score(ecol)[:, 0]
    neg = torch.full_like(es, -torch.inf)
    e_valid = entry_ok & valid[e_safe][0]
    e_elig = entry_ok & res_ok[e_safe][0]
    bslots = torch.full((b, beam), -1, dtype=torch.int32, device=dev)
    bslots[:, 0] = ecol[:, 0]
    bscores = torch.full((b, beam), -torch.inf, dtype=torch.float32,
                         device=dev)
    bscores[:, 0] = torch.where(e_valid, es, neg)
    rslots = torch.full_like(bslots, -1)
    rslots[:, 0] = torch.where(e_elig, ecol[:, 0], -1)
    rscores = torch.full_like(bscores, -torch.inf)
    rscores[:, 0] = torch.where(e_elig, es, neg)
    active = entry_ok.expand(b).clone()
    hops = torch.zeros((b,), dtype=torch.int32, device=dev)
    pos = torch.arange(beam * deg, dtype=torch.int32,
                       device=dev).expand(b, -1)

    for it in range(max_iters):
        if converged_check and it and it % converged_check == 0 \
                and not bool(active.any()):
            break
        hops += active.to(torch.int32)
        # 1) frontier gather: every beam entry expands one hop
        safe_b = torch.clamp_min(bslots, 0).long()
        neigh = adj[safe_b]                               # [b, beam, deg]
        neigh = torch.where((bslots >= 0)[:, :, None], neigh,
                            torch.full_like(neigh, -1))
        neigh = neigh.reshape(b, beam * deg)
        # 2) holes, already-visited and store-invalid candidates drop
        ok = neigh >= 0
        safe_n = torch.clamp_min(neigh, 0).long()
        new = ok & (vis.gather(1, safe_n) == INT32_MAX) & valid[safe_n]
        # 3) mark + in-batch dedup: the first position of each new slot
        #    wins (repeats share a score, so which copy survives is moot)
        tgt = torch.where(new, safe_n, cap)
        vis.scatter_reduce_(1, tgt, torch.where(new, pos, INT32_MAX),
                            reduce="amin", include_self=True)
        surv = new & (vis.gather(1, safe_n) == pos)
        vis[:, cap] = INT32_MAX
        vcount += surv.sum(dim=1, dtype=torch.int32)
        cand = torch.where(surv, neigh, torch.full_like(neigh, -1))
        # 4) kernel G scores the live candidates
        cscores = score(cand)
        keys = _order_keys(cscores, cand)
        # 5) routing-beam merge: any store-valid candidate competes
        bscores, bslots, entered = _merge(bscores, bslots, cscores, cand,
                                          keys, surv, beam)
        # 6) result merge: masked candidates never enter this beam. An
        #    unfiltered walk (fmask is valid) admits the same candidates to
        #    both lists, whose seeds differ only in a -inf entry: from the
        #    first merge on the two lists are equal, so it is merged once
        if unfiltered:
            rscores, rslots = bscores, bslots
        else:
            relig = surv & res_ok[safe_n]
            rscores, rslots, _ = _merge(rscores, rslots, cscores, cand,
                                        keys, relig, beam)
        # 7) convergence: a query with no admission is done
        active = active & entered
    occ = (rslots >= 0).sum(dim=1, dtype=torch.int32)
    return rslots, hops, vcount, occ
