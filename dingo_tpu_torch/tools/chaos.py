"""Deterministic chaos harness of the port: declarative fault scenarios
with gates (the counterpart of the repo's tools/chaos.py, on the port's
planes).

Each scenario runs an in-process cluster (LocalTransport +
CoordinatorControl + StoreNode, every node on one device) and injects a
real fault through the port's fault planes:

  * TransportFaults    seeded drop/delay/duplicate/partition per
                       store pair (raft/transport.py)
  * DEVFAULT           a synthetic allocation failure at every device
                       dispatch point (ops/devfault.py)
  * process kill       node.stop() + engine close, the in-process
                       SIGKILL; the restart goes through StoreNode.recover
  * flipped byte       one byte of the device rows flipped in place,
                       caught by the integrity scrub and healed by the
                       recovery plane's rebuild from the engine
  * tier kill          a kill inside a memory-tier transition
                       (index/tiering.py's test hook)

Gates (per scenario): no acknowledged write lost (every id whose
vector_add returned reads back with its row after recovery) and a
digest-clean scrub; recovery within RECOVERY_BOUND_S; read goodput at
least GOODPUT_FLOOR during the fault window where replicas keep serving;
no new kernel shape across warmed searches after recovery (the port's
counterpart of "zero steady-state recompiles": SENTINEL.new_shapes()).

Scale. The defaults are the JAX package's (a FLAT region of DIM 16 and
each scenario's own few dozen rows), so the two harnesses compare like
with like. A corpus of ``n`` rows larger than a scenario's own rows is
loaded first in PROPOSAL_ROWS-row proposals (and an IVF region trained
on every replica) before the scenario's own 8-row acknowledged batches
and its fault.

Every randomized actor is seeded (numpy corpus, raft election jitter,
the TransportFaults rng), so a failing run replays from its seed.

    python -m dingo_tpu_torch.tools.chaos [names] [--seed N] [--json]
                                          [--device cuda|cpu]

(no names = every scenario; the device defaults to the card and a
missing card raises DeviceUnavailable).
"""

from __future__ import annotations

import contextlib
import json
import shutil
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from dingo_tpu_torch.common.device import resolve_device
from dingo_tpu_torch.coordinator.control import CoordinatorControl
from dingo_tpu_torch.engine.raw_engine import MemEngine, WalEngine
from dingo_tpu_torch.index import codec as vcodec
from dingo_tpu_torch.index.base import IndexParameter, IndexType
from dingo_tpu_torch.index.recovery import RECOVERY
from dingo_tpu_torch.index.tiering import RUNG_HOST_SQ8, TIERING
from dingo_tpu_torch.obs.integrity import INTEGRITY
from dingo_tpu_torch.obs.sentinel import SENTINEL
from dingo_tpu_torch.ops import cuda_build
from dingo_tpu_torch.ops.devfault import DEVFAULT
from dingo_tpu_torch.raft.core import NotLeader, ProposalFailed
from dingo_tpu_torch.raft.transport import LocalTransport, TransportFaults
from dingo_tpu_torch.store.node import StoreNode
from dingo_tpu_torch.store.region import RegionType

#: bound on every recovery (seconds): the signal is "bounded at all", not
#: a latency benchmark
RECOVERY_BOUND_S = 15.0
#: read goodput floor during the fault window of the scenarios that keep
#: replicas serving (leader failover, partition)
GOODPUT_FLOOR = 0.9

DIM = 16
#: WAL checkpoint threshold of the durable stores at the JAX package's
#: sizes; None = the wal_checkpoint_bytes flag (a large corpus would take
#: a whole-memtable checkpoint every MiB)
CHECKPOINT_BYTES = 1 << 20
#: rows a bulk-load proposal carries (the smoke's region phase's)
PROPOSAL_ROWS = 4096
#: the chaos clusters' first region id: the planes keyed by region id
#: (METRICS, COST, EVENTS) outlive a cluster, and other clusters in the
#: process start their ids at 1000
FIRST_REGION_ID = 9000


def _log(msg: str) -> None:
    print(f"[chaos] {msg}", file=sys.stderr, flush=True)


# --------------------------------------------------------------------------
# cluster scaffolding
# --------------------------------------------------------------------------

class Cluster:
    """In-process store cluster with the fault planes attached, every
    store on `device`, its regions `dim` wide; durable (WalEngine) when
    given a data directory."""

    def __init__(self, n_stores: int, replication: int, seed: int,
                 data_dir: Optional[str] = None, device=None,
                 dim: int = DIM,
                 checkpoint_bytes: Optional[int] = CHECKPOINT_BYTES,
                 raft_kw: Optional[dict] = None):
        self.seed = seed
        self.data_dir = data_dir
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the kernel libraries exist before any fault, so a recovery
            # time measures the restart and not nvcc (a no-op once built)
            cuda_build.build()
        self.dim = dim
        self.checkpoint_bytes = checkpoint_bytes
        self.raft_kw = dict(raft_kw or {})
        self.transport = LocalTransport(seed=seed)
        self.faults = TransportFaults(seed=seed)
        self.transport.faults = self.faults
        self.coord = CoordinatorControl(MemEngine(), replication=replication)
        while self.coord.next_region_id() < FIRST_REGION_ID:
            pass
        self.nodes: Dict[str, StoreNode] = {}
        self._engines: Dict[str, Any] = {}
        for i in range(n_stores):
            sid = f"s{i}"
            self.nodes[sid] = self._store(sid, seed + i)

    def _store(self, sid: str, seed: int) -> StoreNode:
        if self.data_dir is not None:
            raw = WalEngine(f"{self.data_dir}/{sid}",
                            checkpoint_threshold_bytes=self.checkpoint_bytes)
        else:
            raw = MemEngine()
        self._engines[sid] = raw
        return StoreNode(sid, self.transport, self.coord, raw_engine=raw,
                         raft_kw={"seed": seed, **self.raft_kw},
                         device=self.device)

    def create_region(self, index_type=None, precision: str = "",
                      part: int = 0, **param_kw) -> int:
        """One region over partition `part`'s whole id range."""
        param = IndexParameter(
            index_type=index_type or IndexType.FLAT, dimension=self.dim,
            precision=precision, **param_kw)
        d = self.coord.create_region(
            start_key=vcodec.encode_vector_key(part, 0),
            end_key=vcodec.encode_vector_key(part, 1 << 40),
            partition_id=part,
            region_type=RegionType.INDEX,
            index_parameter=param,
        )
        self.drive(rounds=3)
        return d.region_id

    def drive(self, rounds: int = 1, sleep: float = 0.03) -> None:
        for _ in range(rounds):
            for n in self.nodes.values():
                with contextlib.suppress(Exception):
                    n.heartbeat_once()
            time.sleep(sleep)

    def leader(self, region_id: int):
        """(store_id, node) currently claiming leadership, or None."""
        for sid, n in self.nodes.items():
            rn = n.engine.get_node(region_id)
            if rn is not None and rn.is_leader():
                return sid, n
        return None

    def wait_leader(self, region_id: int, timeout: float = 10.0,
                    exclude: Tuple[str, ...] = ()):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.drive(rounds=1, sleep=0.02)
            got = self.leader(region_id)
            if got is not None and got[0] not in exclude:
                return got
        raise AssertionError(f"no leader for region {region_id}")

    def kill(self, store_id: str) -> None:
        """In-process SIGKILL: stop raft (unregisters the transport
        handlers) and close the engine. Nothing is flushed beyond what was
        acknowledged."""
        node = self.nodes.pop(store_id)
        node.stop()
        with contextlib.suppress(Exception):
            self._engines[store_id].close()

    def restart(self, store_id: str, seed_offset: int = 100) -> StoreNode:
        """Bring a killed store back through the real recovery path."""
        if self.data_dir is None:
            raise ValueError("restart needs durable engines")
        node = self._store(store_id, self.seed + seed_offset)
        node.recover()
        self.nodes[store_id] = node
        return node

    def close(self) -> None:
        for n in self.nodes.values():
            with contextlib.suppress(Exception):
                n.stop()
        self.transport.heal()
        # the planes are process-global: clear the scenario's state so the
        # next scenario (or the surrounding process) starts clean
        RECOVERY.clear()
        INTEGRITY.clear()
        TIERING.reset()


@contextlib.contextmanager
def cluster(n_stores: int, replication: int, seed: int,
            durable: bool = False, **kw):
    tmp = tempfile.mkdtemp(prefix="chaos-") if durable else None
    c = Cluster(n_stores, replication, seed, data_dir=tmp, **kw)
    try:
        yield c
    finally:
        c.close()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------
# corpus, load and verification helpers
# --------------------------------------------------------------------------

def _bench_rows(n: int, dim: int, seed: int) -> np.ndarray:
    """bench.py's recipe: max(64, n // 1000) Gaussian centres, each row a
    centre plus 0.35 noise (clusters the IVF lists split evenly)."""
    rng = np.random.default_rng(seed)
    ncl = max(64, n // 1000)
    centers = rng.standard_normal((ncl, dim), dtype=np.float32)
    x = centers[rng.integers(0, ncl, n)]
    x += 0.35 * rng.standard_normal((n, dim), dtype=np.float32)
    return x


def _corpus(seed: int, n: int, dim: int = DIM,
            own: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """ids 0..n-1 and their rows. The last `own` rows (all n by default)
    are the JAX package's draw, a standard normal from the seed; the rows
    before them, a bulk corpus, follow bench.py's recipe."""
    own = n if own is None else min(own, n)
    rng = np.random.default_rng(seed)
    tail = rng.standard_normal((own, dim)).astype(np.float32)
    x = np.concatenate([_bench_rows(n - own, dim, seed + 1), tail])
    return np.arange(n, dtype=np.int64), x


def _wait_count(c: Cluster, rid: int, count: int,
                timeout: float = 60.0) -> None:
    """Until every replica's engine holds `count` rows of region `rid`."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all((r := n.get_region(rid)) is not None
               and n.storage.vector_count(r) >= count
               for n in c.nodes.values()):
            return
        c.drive(rounds=1, sleep=0.05)
    raise AssertionError(f"replicas of region {rid} never held {count} rows")


def _bulk_corpus(c: Cluster, rid: int, node, region, seed: int, n: int,
                 dim: int, own: int):
    """A scenario's corpus of n rows (_corpus) with its bulk, the rows
    before its `own` last ones, acknowledged in PROPOSAL_ROWS-row proposals
    through the leader `node`. An index that trains (IVF) is read once
    untrained (the reader's brute force) and then trained on every replica
    from its engine, as the manager builds it. Returns (ids, rows, the
    index of the first own row, the acknowledged rows)."""
    ids, x = _corpus(seed, n, dim, own=own)
    hi = n - min(n, own)
    acked: Dict[int, np.ndarray] = {}
    if hi <= 0:
        return ids, x, hi, acked
    for lo in range(0, hi, PROPOSAL_ROWS):
        top = min(hi, lo + PROPOSAL_ROWS)
        node.storage.vector_add(region, ids[lo:top], x[lo:top])
        acked.update({int(ids[i]): x[i] for i in range(lo, top)})
    idx = region.vector_index_wrapper.own_index
    if idx is not None and idx.need_train():
        node.storage.vector_batch_search(region, x[:1], 3)
        _wait_count(c, rid, hi)
        for nd in c.nodes.values():
            nd.index_manager.rebuild(nd.get_region(rid))
    return ids, x, hi, acked


def _acked_lost(node, region, acked: Dict[int, np.ndarray]) -> List[int]:
    """Ids that were acknowledged but are NOT readable (with their row)
    after recovery."""
    ids = sorted(acked)
    got = node.storage.vector_batch_query(region, ids)
    found = np.asarray([v is not None and v.vector is not None
                        for v in got], bool)
    lost = [vid for vid, f in zip(ids, found) if not f]
    if found.any():
        have = [i for i, f in enumerate(found) if f]
        rows = np.stack([np.asarray(got[i].vector, np.float32)
                         for i in have])
        want = np.stack([acked[ids[i]] for i in have])
        # np.allclose(row, acked, atol=1e-5) a row
        ok = (np.abs(rows - want) <= 1e-5 + 1e-5 * np.abs(want)).all(axis=1)
        lost += [ids[i] for i, o in zip(have, ok) if not o]
    return sorted(lost)


def _digest_clean(node, attempts: int = 20) -> bool:
    """One scrub sweep over the node: every artifact verifies against the
    incremental ledger. A "raced" verdict (the sweep overlapped a write
    still being applied, a follower's apply of the last entry) decides
    nothing, so the sweep runs again, 50 ms apart, up to `attempts` times;
    a mismatch fails at once."""
    for _ in range(attempts):
        results = INTEGRITY.scrub_node(node)
        statuses = [r.get("status") for per_artifact in results.values()
                    for r in per_artifact.values()]
        if "raced" not in statuses:
            break
        time.sleep(0.05)
    return all(st in ("ok", "skipped", "advisory") for st in statuses)


def _steady_recompiles(node, region, queries: np.ndarray,
                       reps: int = 3) -> int:
    """New kernel shapes across repeated identical searches AFTER one
    warmup (warm serving never meets a new shape)."""
    node.storage.vector_batch_search(region, queries, 3)  # warm
    before = SENTINEL.new_shapes()
    for _ in range(reps):
        node.storage.vector_batch_search(region, queries, 3)
    return SENTINEL.new_shapes() - before


def _result(name: str, seed: int, **kw) -> Dict[str, Any]:
    gates = kw.pop("gates")
    out = {"name": name, "seed": seed, **kw, "gates": gates,
           "passed": all(gates.values())}
    verdict = "PASS" if out["passed"] else "FAIL"
    _log(f"{name}: {verdict} "
         + " ".join(f"{g}={'ok' if v else 'VIOLATED'}"
                    for g, v in gates.items()))
    return out


def _region(c: Cluster, index_type, nlist: int) -> int:
    """A scenario's region: IVF probes half its lists."""
    if index_type in (IndexType.IVF_FLAT, IndexType.IVF_PQ):
        return c.create_region(index_type=index_type, ncentroids=nlist,
                               default_nprobe=max(1, nlist // 2))
    return c.create_region(index_type=index_type)


def _scenario_cluster(n_stores: int, seed: int, durable: bool, dim: int,
                      device, checkpoint_bytes, raft_kw):
    """A scenario's cluster: every region replicated on all its stores."""
    return cluster(n_stores, n_stores, seed, durable=durable, device=device,
                   dim=dim, checkpoint_bytes=checkpoint_bytes,
                   raft_kw=raft_kw)


# --------------------------------------------------------------------------
# scenarios
# --------------------------------------------------------------------------

def scenario_kill_restart(seed: int, *, device=None, n: int = 96,
                          dim: int = DIM, index_type=None, nlist: int = 4,
                          checkpoint_bytes: Optional[int] = CHECKPOINT_BYTES,
                          raft_kw: Optional[dict] = None) -> Dict[str, Any]:
    """Kill a store mid-write-batch (engine closed, nothing flushed beyond
    the acknowledgements), restart through StoreNode.recover(). Gates:
    every acknowledged write survives, digest-clean, bounded recovery,
    writable after it, no new kernel shape."""
    with _scenario_cluster(1, seed, True, dim, device, checkpoint_bytes,
                           raft_kw) as c:
        rid = _region(c, index_type, nlist)
        _sid, node = c.wait_leader(rid)
        region = node.get_region(rid)
        ids, x, lo0, acked = _bulk_corpus(c, rid, node, region, seed,
                                          n, dim, 96)
        # small batches; the kill lands between two acknowledgements,
        # "mid-write-batch" from the client's point of view
        for lo in range(lo0, lo0 + 64, 8):
            node.storage.vector_add(region, ids[lo:lo + 8], x[lo:lo + 8])
            acked.update({int(ids[i]): x[i] for i in range(lo, lo + 8)})
        c.kill("s0")

        t0 = time.perf_counter()
        node2 = c.restart("s0")
        c.wait_leader(rid)
        region2 = node2.get_region(rid)
        # recovered = first read answered
        node2.storage.vector_batch_search(region2, x[:1], 3)
        recovery_ms = (time.perf_counter() - t0) * 1e3

        lost = _acked_lost(node2, region2, acked)
        clean = _digest_clean(node2)
        node2.storage.vector_add(region2, ids[lo0 + 64:lo0 + 72],
                                 x[lo0 + 64:lo0 + 72])
        got = node2.storage.vector_batch_query(region2, [int(ids[lo0 + 64])])
        writable = got[0] is not None
        recompiles = _steady_recompiles(node2, region2, x[:4])
        return _result(
            "kill_restart", seed,
            acked=len(acked), lost=len(lost), lost_ids=lost[:8],
            recovery_ms=round(recovery_ms, 1),
            recovery_bound_ms=RECOVERY_BOUND_S * 1e3,
            steady_recompiles=recompiles,
            gates={
                "zero_acked_loss": not lost,
                "digest_clean": clean,
                "recovery_bounded": recovery_ms <= RECOVERY_BOUND_S * 1e3,
                "writable_after_recovery": writable,
                "zero_steady_recompiles": recompiles == 0,
            })


def _traffic_window(c: Cluster, rid: int, queries: np.ndarray,
                    duration_s: float, exclude: Tuple[str, ...] = ()
                    ) -> Tuple[int, int]:
    """Fire read traffic at every live replica for `duration_s` while
    driving heartbeats; returns (served, attempted)."""
    served = attempted = 0
    deadline = time.monotonic() + duration_s
    while time.monotonic() < deadline:
        c.drive(rounds=1, sleep=0.01)
        for sid, n in list(c.nodes.items()):
            if sid in exclude:
                continue
            region = n.get_region(rid)
            if region is None:
                continue
            attempted += 1
            try:
                res = n.storage.vector_batch_search(region, queries[:1], 3)
                if res and res[0]:
                    served += 1
            except Exception:  # noqa: BLE001 - counted as unserved
                pass
    return served, attempted


def _write_until_ok(c: Cluster, rid: int, ids, vecs, timeout_s: float,
                    exclude: Tuple[str, ...] = ()) -> float:
    """Retry one write batch against whichever node claims leadership
    until it lands; returns the elapsed ms (the write-recovery time)."""
    t0 = time.perf_counter()
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        c.drive(rounds=1, sleep=0.02)
        got = c.leader(rid)
        if got is None or got[0] in exclude:
            continue
        _sid, node = got
        region = node.get_region(rid)
        if region is None:
            continue
        try:
            node.storage.vector_add(region, ids, vecs)
            return (time.perf_counter() - t0) * 1e3
        except (NotLeader, ProposalFailed):
            continue
    raise AssertionError("write never recovered inside the bound")


def scenario_leader_failover(seed: int, *, device=None, n: int = 96,
                             dim: int = DIM, index_type=None,
                             nlist: int = 4,
                             checkpoint_bytes: Optional[int] =
                             CHECKPOINT_BYTES,
                             raft_kw: Optional[dict] = None
                             ) -> Dict[str, Any]:
    """Kill the raft leader under live traffic. Gates: survivors keep
    serving reads (goodput floor), a new leader accepts writes inside the
    bound, no acknowledged write is lost, replicas stay digest-clean."""
    with _scenario_cluster(3, seed, False, dim, device, checkpoint_bytes,
                           raft_kw) as c:
        rid = _region(c, index_type, nlist)
        lsid, lnode = c.wait_leader(rid)
        region = lnode.get_region(rid)
        ids, x, lo0, acked = _bulk_corpus(c, rid, lnode, region, seed,
                                          n, dim, 96)
        for lo in range(lo0, lo0 + 48, 8):
            lnode.storage.vector_add(region, ids[lo:lo + 8], x[lo:lo + 8])
            acked.update({int(ids[i]): x[i] for i in range(lo, lo + 8)})
        c.drive(rounds=3)  # let the followers apply

        c.kill(lsid)
        # fault window: read traffic against the survivors
        served, attempted = _traffic_window(c, rid, x, duration_s=1.0)
        recovery_ms = _write_until_ok(
            c, rid, ids[lo0 + 48:lo0 + 56], x[lo0 + 48:lo0 + 56],
            RECOVERY_BOUND_S)
        acked.update({int(ids[i]): x[i] for i in range(lo0 + 48, lo0 + 56)})

        _sid2, node2 = c.wait_leader(rid)
        region2 = node2.get_region(rid)
        lost = _acked_lost(node2, region2, acked)
        clean = all(_digest_clean(nd) for nd in c.nodes.values())
        goodput = served / attempted if attempted else 0.0
        recompiles = _steady_recompiles(node2, region2, x[:4])
        return _result(
            "leader_failover", seed,
            acked=len(acked), lost=len(lost), lost_ids=lost[:8],
            recovery_ms=round(recovery_ms, 1),
            recovery_bound_ms=RECOVERY_BOUND_S * 1e3,
            goodput=round(goodput, 4), goodput_floor=GOODPUT_FLOOR,
            reads_served=served, reads_attempted=attempted,
            steady_recompiles=recompiles,
            gates={
                "zero_acked_loss": not lost,
                "digest_clean": clean,
                "recovery_bounded": recovery_ms <= RECOVERY_BOUND_S * 1e3,
                "goodput_floor": goodput >= GOODPUT_FLOOR,
                "zero_steady_recompiles": recompiles == 0,
            })


def scenario_partition_heal(seed: int, *, device=None, n: int = 96,
                            dim: int = DIM, index_type=None, nlist: int = 4,
                            checkpoint_bytes: Optional[int] =
                            CHECKPOINT_BYTES,
                            raft_kw: Optional[dict] = None
                            ) -> Dict[str, Any]:
    """Partition the leader away from both followers; the majority side
    elects, keeps serving and accepting writes; heal; the old leader
    rejoins and catches up."""
    with _scenario_cluster(3, seed, False, dim, device, checkpoint_bytes,
                           raft_kw) as c:
        rid = _region(c, index_type, nlist)
        lsid, lnode = c.wait_leader(rid)
        region = lnode.get_region(rid)
        ids, x, lo0, acked = _bulk_corpus(c, rid, lnode, region, seed,
                                          n, dim, 96)
        for lo in range(lo0, lo0 + 32, 8):
            lnode.storage.vector_add(region, ids[lo:lo + 8], x[lo:lo + 8])
            acked.update({int(ids[i]): x[i] for i in range(lo, lo + 8)})
        c.drive(rounds=3)

        others = [sid for sid in c.nodes if sid != lsid]
        for sid in others:
            c.faults.partition(lsid, sid)
        served, attempted = _traffic_window(
            c, rid, x, duration_s=1.0, exclude=(lsid,))
        recovery_ms = _write_until_ok(
            c, rid, ids[lo0 + 32:lo0 + 40], x[lo0 + 32:lo0 + 40],
            RECOVERY_BOUND_S, exclude=(lsid,))
        acked.update({int(ids[i]): x[i] for i in range(lo0 + 32, lo0 + 40)})

        c.faults.heal()
        # the old leader steps down and catches up; poll until it holds
        # every acknowledged write (raft log replay through the real apply)
        deadline = time.monotonic() + RECOVERY_BOUND_S
        caught_up = False
        while time.monotonic() < deadline and not caught_up:
            c.drive(rounds=2, sleep=0.03)
            old = c.nodes[lsid]
            r_old = old.get_region(rid)
            caught_up = r_old is not None and not _acked_lost(
                old, r_old, acked)
        lost_each = {sid: len(_acked_lost(nd, nd.get_region(rid), acked))
                     for sid, nd in c.nodes.items()}
        clean = all(_digest_clean(nd) for nd in c.nodes.values())
        goodput = served / attempted if attempted else 0.0
        return _result(
            "partition_heal", seed,
            acked=len(acked), lost=max(lost_each.values()),
            lost_by_store=lost_each,
            recovery_ms=round(recovery_ms, 1),
            recovery_bound_ms=RECOVERY_BOUND_S * 1e3,
            goodput=round(goodput, 4), goodput_floor=GOODPUT_FLOOR,
            old_leader_caught_up=caught_up,
            gates={
                "zero_acked_loss": max(lost_each.values()) == 0,
                "digest_clean": clean,
                "recovery_bounded": recovery_ms <= RECOVERY_BOUND_S * 1e3,
                "goodput_floor": goodput >= GOODPUT_FLOOR,
                "partitioned_leader_caught_up": caught_up,
            })


def scenario_oom_storm(seed: int, *, device=None, n: int = 96,
                       dim: int = DIM, index_type=None, nlist: int = 4,
                       checkpoint_bytes: Optional[int] = CHECKPOINT_BYTES,
                       raft_kw: Optional[dict] = None) -> Dict[str, Any]:
    """Arm the device-fault shim for EVERY dispatch: writes and reads keep
    being served (ladder -> degraded -> host path) and never raise; after
    the disarm the re-materialization restores device serving with no new
    kernel shape."""
    with _scenario_cluster(1, seed, False, dim, device, checkpoint_bytes,
                           raft_kw) as c:
        rid = _region(c, index_type, nlist)
        _sid, node = c.wait_leader(rid)
        region = node.get_region(rid)
        ids, x, lo0, acked = _bulk_corpus(c, rid, node, region, seed,
                                          n, dim, 96)
        node.storage.vector_add(region, ids[lo0:lo0 + 32], x[lo0:lo0 + 32])
        acked.update({int(ids[i]): x[i] for i in range(lo0, lo0 + 32)})

        DEVFAULT.arm(1 << 30)
        try:
            served = attempted = 0
            unhandled: List[str] = []
            for lo in range(lo0 + 32, lo0 + 64, 8):
                attempted += 1
                try:
                    node.storage.vector_add(region, ids[lo:lo + 8],
                                            x[lo:lo + 8])
                    acked.update({int(ids[i]): x[i]
                                  for i in range(lo, lo + 8)})
                    served += 1
                except Exception as e:  # noqa: BLE001 - the gate itself
                    unhandled.append(f"write: {type(e).__name__}: {e}")
                attempted += 1
                try:
                    res = node.storage.vector_batch_search(
                        region, x[lo:lo + 1], 3)
                    if res and res[0] and res[0][0].id == int(ids[lo]):
                        served += 1
                except Exception as e:  # noqa: BLE001
                    unhandled.append(f"search: {type(e).__name__}: {e}")
            degraded = RECOVERY.is_degraded(rid)
        finally:
            DEVFAULT.disarm()

        t0 = time.perf_counter()
        remats = RECOVERY.run_rematerializations(node)
        recovery_ms = (time.perf_counter() - t0) * 1e3
        lost = _acked_lost(node, region, acked)
        clean = _digest_clean(node)
        recompiles = _steady_recompiles(node, region, x[:4])
        goodput = served / attempted if attempted else 0.0
        return _result(
            "oom_storm", seed,
            acked=len(acked), lost=len(lost), lost_ids=lost[:8],
            degraded_during_storm=degraded, rematerializations=remats,
            recovery_ms=round(recovery_ms, 1),
            recovery_bound_ms=RECOVERY_BOUND_S * 1e3,
            goodput=round(goodput, 4), goodput_floor=1.0,
            unhandled=unhandled[:4],
            steady_recompiles=recompiles,
            gates={
                "every_request_served": not unhandled and goodput == 1.0,
                "region_degraded_then_recovered":
                    degraded and remats >= 1
                    and not RECOVERY.is_degraded(rid),
                "zero_acked_loss": not lost,
                "digest_clean": clean,
                "recovery_bounded": recovery_ms <= RECOVERY_BOUND_S * 1e3,
                "zero_steady_recompiles": recompiles == 0,
            })


def scenario_bitflip(seed: int, *, device=None, n: int = 64,
                     dim: int = DIM, index_type=None, nlist: int = 4,
                     checkpoint_bytes: Optional[int] = CHECKPOINT_BYTES,
                     raft_kw: Optional[dict] = None) -> Dict[str, Any]:
    """One flipped byte in the device rows: the integrity scrub catches it
    and the recovery plane rebuilds from the engine instead of serving
    corruption."""
    with _scenario_cluster(1, seed, False, dim, device, checkpoint_bytes,
                           raft_kw) as c:
        rid = _region(c, index_type, nlist)
        _sid, node = c.wait_leader(rid)
        region = node.get_region(rid)
        ids, x, lo0, acked = _bulk_corpus(c, rid, node, region, seed,
                                          n, dim, 64)
        node.storage.vector_add(region, ids[lo0:], x[lo0:])
        acked.update({int(ids[i]): x[i] for i in range(lo0, n)})
        idx = region.vector_index_wrapper.own_index
        INTEGRITY.scrub_index(idx)
        if INTEGRITY.region_report(idx)[2] is not False:
            raise AssertionError("the scrub flagged the region before the "
                                 "flip")

        # flip one byte of one resident row in place (silent HBM or
        # restore corruption); the JAX package rebuilds the array on the
        # host, the port writes the one byte under the store's lock
        store = idx.store
        slot = int(store.slots_of(ids[:1])[0])
        with store.device_lock:
            raw = store.vecs.view(torch.uint8)
            raw[slot, 0] ^= 1

        t0 = time.perf_counter()
        INTEGRITY.scrub_index(idx)
        detected = INTEGRITY.region_report(idx)[2] is True
        rebuilt = RECOVERY.run_rematerializations(node)
        recovery_ms = (time.perf_counter() - t0) * 1e3

        region2 = node.get_region(rid)
        lost = _acked_lost(node, region2, acked)
        res = node.storage.vector_batch_search(region2, x[:4], 1)
        parity = all(r[0].id == int(ids[i]) for i, r in enumerate(res))
        idx2 = region2.vector_index_wrapper.own_index
        INTEGRITY.scrub_index(idx2)
        clean = INTEGRITY.region_report(idx2)[2] is False
        return _result(
            "bitflip", seed,
            acked=len(acked), lost=len(lost),
            detected=detected, rebuilds=rebuilt,
            recovery_ms=round(recovery_ms, 1),
            recovery_bound_ms=RECOVERY_BOUND_S * 1e3,
            search_parity=parity,
            gates={
                "scrub_detected_flip": detected,
                "rebuilt_from_engine": rebuilt >= 1,
                "zero_acked_loss": not lost,
                "search_parity": parity,
                "digest_clean_after_rebuild": clean,
                "recovery_bounded": recovery_ms <= RECOVERY_BOUND_S * 1e3,
            })


class _TierKill(RuntimeError):
    """Raised by the tier-transition test hook after the in-process
    SIGKILL, so the interrupted transition unwinds as the dying process
    would have."""


def scenario_tier_kill(seed: int, *, device=None, n: int = 96,
                       dim: int = DIM, index_type=None, nlist: int = 4,
                       checkpoint_bytes: Optional[int] = CHECKPOINT_BYTES,
                       raft_kw: Optional[dict] = None) -> Dict[str, Any]:
    """A process kill MID-TIER-TRANSITION: once between the verified
    destination copy and the swap of a demotion, once inside a promotion.
    Every transition is a copy plus a digest-gated swap over state the WAL
    already owns, so the restart rebuilds at the declared tier from the
    engine and every acknowledged write answers. Gates: no acknowledged
    write lost after either restart, digest-clean, bounded recovery,
    writable, no new kernel shape."""
    with _scenario_cluster(1, seed, True, dim, device, checkpoint_bytes,
                           raft_kw) as c:
        rid = _region(c, index_type, nlist)
        _sid, node = c.wait_leader(rid)
        region = node.get_region(rid)
        ids, x, lo0, acked = _bulk_corpus(c, rid, node, region, seed,
                                          n, dim, 96)
        for lo in range(lo0, lo0 + 64, 8):
            node.storage.vector_add(region, ids[lo:lo + 8], x[lo:lo + 8])
            acked.update({int(ids[i]): x[i] for i in range(lo, lo + 8)})

        # reach the device-sq8 rung, then die inside the hbm_sq8 ->
        # host_sq8 transcription: after the digest verify, before the swap
        if not TIERING.demote(node, region)["ok"]:
            raise AssertionError("the demotion to hbm_sq8 was refused")

        def kill_at(stage_name):
            def hook(stage, _ctx=None):
                if stage == stage_name:
                    c.kill("s0")
                    raise _TierKill(stage)
            return hook

        def die_in(move, nd, rg, stage_name):
            TIERING.test_hook = kill_at(stage_name)
            try:
                move(nd, rg)
            except _TierKill:
                return
            finally:
                TIERING.test_hook = None
            raise AssertionError(f"{stage_name} survived the kill hook")

        def restart(seed_offset):
            t0 = time.perf_counter()
            nd = c.restart("s0", seed_offset=seed_offset)
            c.wait_leader(rid)
            rg = nd.get_region(rid)
            nd.storage.vector_batch_search(rg, x[:1], 3)
            ms = (time.perf_counter() - t0) * 1e3
            TIERING.reset()   # a restarted process has no ladder state
            return nd, rg, ms

        die_in(TIERING.demote, node, region, "mid_demote")
        node2, region2, recovery1_ms = restart(100)
        lost1 = _acked_lost(node2, region2, acked)
        clean1 = _digest_clean(node2)

        # walk the survivor down to host RAM, then die mid-PROMOTION
        if not (TIERING.demote(node2, region2)["ok"]
                and TIERING.demote(node2, region2)["ok"]
                and TIERING.state()[rid]["rung"] == "host_sq8"
                and TIERING._regions[rid].rung == RUNG_HOST_SQ8):
            raise AssertionError("the survivor did not reach host_sq8")
        die_in(TIERING.promote, node2, region2, "mid_promote")
        node3, region3, recovery2_ms = restart(200)
        lost2 = _acked_lost(node3, region3, acked)
        clean2 = _digest_clean(node3)
        node3.storage.vector_add(region3, ids[lo0 + 64:lo0 + 72],
                                 x[lo0 + 64:lo0 + 72])
        got = node3.storage.vector_batch_query(region3, [int(ids[lo0 + 64])])
        writable = got[0] is not None
        recompiles = _steady_recompiles(node3, region3, x[:4])
        recovery_ms = max(recovery1_ms, recovery2_ms)
        return _result(
            "tier_kill", seed,
            acked=len(acked), lost=len(lost1) + len(lost2),
            lost_ids=(lost1 + lost2)[:8],
            recovery_ms=round(recovery_ms, 1),
            recovery_bound_ms=RECOVERY_BOUND_S * 1e3,
            steady_recompiles=recompiles,
            gates={
                "zero_acked_loss": not lost1 and not lost2,
                "digest_clean": clean1 and clean2,
                "recovery_bounded": recovery_ms <= RECOVERY_BOUND_S * 1e3,
                "writable_after_recovery": writable,
                "zero_steady_recompiles": recompiles == 0,
            })


SCENARIOS: Dict[str, Callable[..., Dict[str, Any]]] = {
    "kill_restart": scenario_kill_restart,
    "leader_failover": scenario_leader_failover,
    "partition_heal": scenario_partition_heal,
    "oom_storm": scenario_oom_storm,
    "bitflip": scenario_bitflip,
    "tier_kill": scenario_tier_kill,
}


def run_scenarios(names: Optional[List[str]] = None, seed: int = 0,
                  device=None, **kw) -> Dict[str, Any]:
    """Run the named scenarios (default: all) on `device` (None = the
    card) with the scenarios' keyword arguments `kw`, and aggregate the
    verdict. An exception inside a scenario is a FAIL, not a crash of
    the suite."""
    device = resolve_device(device)
    picked = names or list(SCENARIOS)
    results: List[Dict[str, Any]] = []
    for name in picked:
        fn = SCENARIOS[name]
        _log(f"running {name} (seed={seed})")
        try:
            results.append(fn(seed, device=device, **kw))
        except Exception as e:  # noqa: BLE001 - scenario verdict
            _log(f"{name}: ERROR {type(e).__name__}: {e}")
            results.append({"name": name, "seed": seed, "passed": False,
                            "error": f"{type(e).__name__}: {e}",
                            "gates": {"completed": False}})
    return {
        "seed": seed,
        "scenarios": results,
        "passed": all(r["passed"] for r in results),
        "max_recovery_ms": max(
            (r.get("recovery_ms", 0.0) for r in results), default=0.0),
        "min_goodput": min(
            (r["goodput"] for r in results if "goodput" in r), default=1.0),
    }


# --------------------------------------------------------------------------
# the crash-recovery matrix (tests/test_chaos.py's, as a scenario)
# --------------------------------------------------------------------------

#: index family x precision tier
MATRIX = (
    (IndexType.FLAT, "fp32"),
    (IndexType.FLAT, "sq8"),
    (IndexType.IVF_FLAT, "fp32"),
    (IndexType.IVF_FLAT, "sq8"),
    (IndexType.HNSW, "fp32"),
    (IndexType.HNSW, "sq8"),
)


def crash_recovery_case(index_type, precision: str, seed: int = 11, *,
                        device=None, n: int = 48, dim: int = DIM,
                        nlist: int = 4,
                        checkpoint_bytes: Optional[int] = CHECKPOINT_BYTES,
                        raft_kw: Optional[dict] = None) -> Dict[str, Any]:
    """Kill the store between acknowledged write batches and restart it
    through StoreNode.recover(): every acknowledged row is back, the
    scrub is clean, the first four rows find themselves (top-1, an IVF
    region probing every list), and the store takes writes again."""
    param_kw = {}
    if index_type == IndexType.IVF_FLAT:
        param_kw = {"ncentroids": nlist, "default_nprobe": nlist}
    with cluster(1, 1, seed, durable=True, device=device, dim=dim,
                 checkpoint_bytes=checkpoint_bytes, raft_kw=raft_kw) as c:
        rid = c.create_region(index_type=index_type, precision=precision,
                              **param_kw)
        _sid, node = c.wait_leader(rid)
        region = node.get_region(rid)
        ids, x, lo0, acked = _bulk_corpus(c, rid, node, region, seed,
                                          n, dim, 48)
        for lo in range(lo0, n, 8):
            node.storage.vector_add(region, ids[lo:lo + 8], x[lo:lo + 8])
            acked.update({int(ids[i]): x[i] for i in range(lo, lo + 8)})
        c.kill("s0")

        t0 = time.perf_counter()
        node2 = c.restart("s0")
        c.wait_leader(rid)
        region2 = node2.get_region(rid)
        res = node2.storage.vector_batch_search(region2, x[:4], 1)
        recovery_ms = (time.perf_counter() - t0) * 1e3
        top1 = [int(r[0].id) if r else -1 for r in res]
        lost = _acked_lost(node2, region2, acked)
        clean = _digest_clean(node2)
        extra = np.arange(lo0 + 900, lo0 + 904, dtype=np.int64)
        node2.storage.vector_add(region2, extra, x[:4])
        got = node2.storage.vector_batch_query(region2, [int(extra[0])])
        return _result(
            f"{index_type.value}-{precision}", seed,
            acked=len(acked), lost=len(lost), lost_ids=lost[:8],
            top1=top1, recovery_ms=round(recovery_ms, 1),
            recovery_bound_ms=RECOVERY_BOUND_S * 1e3,
            gates={
                "zero_acked_loss": not lost,
                "digest_clean": clean,
                "search_parity": top1 == [int(i) for i in ids[:4]],
                "writable_after_recovery": got[0] is not None,
                "recovery_bounded": recovery_ms <= RECOVERY_BOUND_S * 1e3,
            })


def run_matrix(seed: int = 11, device=None, cases=MATRIX,
               **kw) -> Dict[str, Any]:
    """The matrix `cases` (default: every MATRIX case) on `device` (None =
    the card), each with its wall seconds; a case that raises is a FAIL,
    as in run_scenarios."""
    device = resolve_device(device)
    results: List[Dict[str, Any]] = []
    for index_type, precision in cases:
        name = f"{index_type.value}-{precision}"
        _log(f"running matrix case {name} (seed={seed})")
        t0 = time.perf_counter()
        try:
            case = crash_recovery_case(index_type, precision, seed,
                                       device=device, **kw)
        except Exception as e:  # noqa: BLE001 - case verdict
            _log(f"{name}: ERROR {type(e).__name__}: {e}")
            case = {"name": name, "seed": seed, "passed": False,
                    "error": f"{type(e).__name__}: {e}",
                    "gates": {"completed": False}}
        case["seconds"] = time.perf_counter() - t0
        results.append(case)
    return {"seed": seed, "cases": results,
            "passed": all(r["passed"] for r in results)}


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    seed = 0
    names: List[str] = []
    emit_json = False
    device = "cuda"
    it = iter(argv)
    for a in it:
        if a == "--seed":
            seed = int(next(it))
        elif a == "--json":
            emit_json = True
        elif a == "--device":
            device = next(it)
        elif a in SCENARIOS:
            names.append(a)
        else:
            print(f"unknown scenario {a!r}; known: {', '.join(SCENARIOS)}",
                  file=sys.stderr)
            return 2
    out = run_scenarios(names or None, seed=seed, device=device)
    if emit_json:
        print(json.dumps(out, indent=2, default=str))
    else:
        for r in out["scenarios"]:
            status = "PASS" if r["passed"] else "FAIL"
            extra = f" error={r['error']}" if "error" in r else ""
            print(f"{r['name']:<18} {status}"
                  f"  recovery={r.get('recovery_ms', '-')}ms"
                  f"  goodput={r.get('goodput', '-')}{extra}")
        print("chaos:", "PASS" if out["passed"] else "FAIL")
    return 0 if out["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
