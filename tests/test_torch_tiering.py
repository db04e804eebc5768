"""The memory-tier ladder of the port (index/tiering.py, the host and mmap
sq8 slot stores) against the JAX package's: the cases of test_tiering.py
on a one-store cluster of each package (FLAT/IVF_FLAT at DIM 16, 96
rows), run through both packages, plus the chaos harness's tier_kill
scenario of each package, the staged code pour, the
stores themselves, the collector's serving_tier and the carry of a
host-rung snapshot the JAX package saved.

Tolerances. Within a package the round trip is byte-identical (one
canonical rebuild first, as test_tiering.py makes its baseline). Across
packages: ids equal modulo ties; distances of the fp32 rungs within rtol
1e-5 (atol 1e-5 near 0), of the bf16 and sq8 device rungs within rtol
2e-2 / atol 0.2 (test_tiering.py's host-versus-device bound: the JAX
package's jitted sq8 decode fuses into an FMA and its bf16 arms round
otherwise); the host rungs scan the same codes with the same decode in
both packages, the port's product in torch and the JAX package's in numpy
(f32 sums in another order), and agree within the fp32 tolerance.

The port runs on the CPU (``device="cpu"``); raft waits have deadlines.
"""

import contextlib
import importlib
import os
import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

PKGS = ("dingo_tpu", "dingo_tpu_torch")
DIM = 16
FIRST_REGION_ID = 7000


class Pkg:
    MODS = {"tiering": "index.tiering", "base": "index.base",
            "control": "coordinator.control", "raw": "engine.raw_engine",
            "raft": "raft", "node": "store.node", "vcodec": "index.codec",
            "regm": "store.region", "metrics": "common.metrics",
            "config": "common.config", "hbm": "obs.hbm",
            "integrity": "obs.integrity", "recovery": "index.recovery",
            "events": "obs.events", "distance": "ops.distance",
            "slot": "index.slot_store", "sq": "ops.sq"}

    def __init__(self, name):
        self.name = name
        self.kw = {"device": "cpu"} if name == "dingo_tpu_torch" else {}
        for attr, m in self.MODS.items():
            setattr(self, attr, importlib.import_module(f"{name}.{m}"))

    @property
    def torch(self) -> bool:
        return self.name == "dingo_tpu_torch"

    @property
    def TIERING(self):
        return self.tiering.TIERING

    @property
    def FLAGS(self):
        return self.config.FLAGS


class Cluster:
    """An in-process store cluster of one package (tools/chaos.py's
    Cluster without the transport faults) on memory engines."""

    def __init__(self, p: Pkg, n_stores: int, replication: int, seed: int):
        self.p = p
        self.transport = p.raft.LocalTransport(seed=seed)
        self.coord = p.control.CoordinatorControl(
            p.raw.MemEngine(), replication=replication)
        # region ids of their own: the process-global planes (METRICS,
        # COST, EVENTS, TIERING) are keyed by region id, and the other
        # files' clusters start at 1000
        while self.coord.next_region_id() < FIRST_REGION_ID:
            pass
        self.nodes = {
            f"s{i}": p.node.StoreNode(f"s{i}", self.transport, self.coord,
                                      raw_engine=p.raw.MemEngine(),
                                      raft_kw={"seed": seed + i}, **p.kw)
            for i in range(n_stores)}

    def create_region(self, index_type=None, precision="", **param_kw):
        b = self.p.base
        param = b.IndexParameter(
            index_type=index_type or b.IndexType.FLAT, dimension=DIM,
            precision=precision, **param_kw)
        d = self.coord.create_region(
            start_key=self.p.vcodec.encode_vector_key(0, 0),
            end_key=self.p.vcodec.encode_vector_key(0, 1 << 40),
            partition_id=0, region_type=self.p.regm.RegionType.INDEX,
            index_parameter=param)
        self.drive(rounds=3)
        return d.region_id

    def drive(self, rounds=1, sleep=0.03):
        for _ in range(rounds):
            for n in self.nodes.values():
                with contextlib.suppress(Exception):
                    n.heartbeat_once()
            time.sleep(sleep)

    def wait_leader(self, region_id, timeout=10.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            self.drive(rounds=1, sleep=0.02)
            for sid, n in self.nodes.items():
                rn = n.engine.get_node(region_id)
                if rn is not None and rn.is_leader():
                    return sid, n
        raise AssertionError(f"no leader for region {region_id}")

    def close(self):
        for n in self.nodes.values():
            with contextlib.suppress(Exception):
                n.stop()
        self.p.recovery.RECOVERY.clear()
        self.p.integrity.INTEGRITY.clear()
        self.p.TIERING.reset()


@contextlib.contextmanager
def cluster(p, n_stores=1, replication=1, seed=7):
    c = Cluster(p, n_stores, replication, seed)
    try:
        yield c
    finally:
        c.close()


@pytest.fixture(autouse=True)
def _fresh_ladder():
    for name in PKGS:
        importlib.import_module(f"{name}.index.tiering").TIERING.reset()
    yield
    for name in PKGS:
        importlib.import_module(f"{name}.index.tiering").TIERING.reset()


@pytest.fixture(params=PKGS)
def pkg(request):
    return Pkg(request.param)


def _fill(node, region, n=96, seed=5):
    rng = np.random.default_rng(seed)
    ids = np.arange(1, n + 1, dtype=np.int64)
    x = rng.standard_normal((n, DIM)).astype(np.float32)
    for lo in range(0, n, 16):
        node.storage.vector_add(region, ids[lo:lo + 16], x[lo:lo + 16])
    return ids, x


def _topk(node, region, queries, k=10):
    res = node.storage.vector_batch_search(region, queries, k)
    return ([[r.id for r in row] for row in res],
            [[r.distance for r in row] for row in res])


def _same_modulo_ties(a, b, rtol, atol):
    """Two packages' (ids, distances): distances within the tolerance, an
    id that differs sits at a distance equal to a neighbour's."""
    (ia, da), (ib, db) = a, b
    assert len(ia) == len(ib)
    for ra, rb, xa, xb in zip(ia, ib, da, db):
        ra, rb = np.asarray(ra), np.asarray(rb)
        xa, xb = np.asarray(xa), np.asarray(xb)
        assert len(ra) == len(rb)
        np.testing.assert_allclose(xb, xa, rtol=rtol, atol=atol)
        for c in np.flatnonzero(ra != rb):
            near = [xb[j] for j in (c - 1, c + 1) if 0 <= j < len(xb)]
            assert any(np.isclose(xb[c], v, rtol=rtol, atol=atol)
                       for v in near), (ra, rb, xa, xb)


MATRIX = [
    ("flat", "fp32"), ("flat", "bf16"), ("flat", "sq8"),
    ("ivf_flat", "fp32"), ("ivf_flat", "bf16"), ("ivf_flat", "sq8"),
]


def _round_trip(p, index_type, precision):
    """test_tiering.py's walk: one canonical rebuild, the ladder down with
    a self-hit at every rung, back up to the base rung. Returns the
    package's observations."""
    T = p.TIERING
    b = p.base
    param_kw = {}
    if index_type == "ivf_flat":
        param_kw = {"ncentroids": 4, "default_nprobe": 4}
    out = {"rungs": {}}
    with cluster(p, seed=7) as c:
        rid = c.create_region(index_type=b.IndexType(index_type),
                              precision=precision, **param_kw)
        _sid, node = c.wait_leader(rid)
        region = node.get_region(rid)
        ids, x = _fill(node, region)
        q = x[:8]
        assert node.index_manager.rebuild_at_precision(
            region, raft_log=T._raft_log(node, rid), precision=None)
        out["base"] = _topk(node, region, q)
        assert [row[0] for row in out["base"][0]] == \
            [int(i) for i in ids[:8]]
        st = T._state(region)
        base_rung = st.base
        while st.rung < len(p.tiering.RUNGS) - 1:
            rep = T.demote(node, region)
            assert rep["ok"], rep
            got = _topk(node, region, q)
            # every acknowledged row searchable at every rung
            assert [row[0] for row in got[0]] == [int(i) for i in ids[:8]]
            out["rungs"][p.tiering.RUNGS[st.rung]] = got
        assert p.tiering.RUNGS[st.rung] == "mmap_sq8"
        w = region.vector_index_wrapper
        assert isinstance(w.own_index, p.tiering.HostSqFlat)
        # the retire hook: no device residency, the ledger forgot it
        assert w.get_device_memory_size() == 0
        assert rid not in p.hbm.HBM.state()["regions"]
        mmap_path = st.mmap_path
        assert mmap_path is not None and os.path.exists(mmap_path)
        while st.rung > base_rung:
            rep = T.promote(node, region)
            assert rep["ok"], rep
        assert not os.path.exists(mmap_path)
        out["rt"] = _topk(node, region, q)
    return out


@pytest.mark.parametrize("index_type,precision", MATRIX,
                         ids=[f"{t}-{p}" for t, p in MATRIX])
def test_round_trip_parity(index_type, precision):
    """The whole ladder down and back in each package: byte-identical to
    its own canonical baseline after the round trip; across packages the
    same ids (modulo ties) at every rung."""
    got = {name: _round_trip(Pkg(name), index_type, precision)
           for name in PKGS}
    for name, o in got.items():
        assert o["rt"][0] == o["base"][0], name
        for a, b in zip(o["rt"][1], o["base"][1]):
            assert np.array_equal(np.asarray(a), np.asarray(b)), name
    ref, port = got["dingo_tpu"], got["dingo_tpu_torch"]
    tol = (dict(rtol=1e-5, atol=1e-5) if precision == "fp32"
           else dict(rtol=2e-2, atol=0.2))
    _same_modulo_ties(ref["base"], port["base"], **tol)
    _same_modulo_ties(ref["rt"], port["rt"], **tol)
    assert list(ref["rungs"]) == list(port["rungs"]) == \
        (["hbm_sq8", "host_sq8", "mmap_sq8"] if precision != "sq8"
         else ["host_sq8", "mmap_sq8"])
    for rung in ref["rungs"]:
        t = (dict(rtol=1e-5, atol=1e-5) if rung.startswith(("host", "mmap"))
             else dict(rtol=2e-2, atol=0.2))
        _same_modulo_ties(ref["rungs"][rung], port["rungs"][rung], **t)


def test_digest_gate_refuses_corrupted_copy(pkg):
    """One destination byte flipped between copy and verify: the swap is
    refused, the old rung serves byte-identically, tier.digest_refusals
    counts."""
    T = pkg.TIERING
    with cluster(pkg, seed=9) as c:
        rid = c.create_region(precision="sq8")
        _sid, node = c.wait_leader(rid)
        region = node.get_region(rid)
        _fill(node, region, n=64)
        q = np.random.default_rng(1).standard_normal((4, DIM)).astype(
            np.float32)
        before = _topk(node, region, q)
        st = T._state(region)
        assert st.rung == pkg.tiering.RUNG_HBM_SQ8

        def corrupt(stage, ctx=None):
            if stage == "copied" and ctx is not None:
                ctx.store.vecs[0, 0] ^= 1   # one flipped destination byte

        T.test_hook = corrupt
        try:
            rep = T.demote(node, region)
        finally:
            T.test_hook = None
        assert rep["ok"] is False and "digest" in rep["reason"]
        assert st.rung == pkg.tiering.RUNG_HBM_SQ8
        assert not isinstance(region.vector_index_wrapper.own_index,
                              pkg.tiering.HostSqFlat)
        after = _topk(node, region, q)
        assert after[0] == before[0]
        for a, b in zip(after[1], before[1]):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        assert pkg.metrics.METRICS.counter(
            "tier.digest_refusals", region_id=rid).get() >= 1


def test_clean_copy_passes_digest_gate_and_swaps(pkg):
    T = pkg.TIERING
    with cluster(pkg, seed=9) as c:
        rid = c.create_region(precision="sq8")
        _sid, node = c.wait_leader(rid)
        region = node.get_region(rid)
        _fill(node, region, n=64)
        fired = []
        T.test_hook = lambda stage, ctx=None: fired.append(stage)
        try:
            rep = T.demote(node, region)
        finally:
            T.test_hook = None
        assert rep["ok"], rep
        assert fired == ["copied", "mid_demote"]
        assert isinstance(region.vector_index_wrapper.own_index,
                          pkg.tiering.HostSqFlat)


def test_hamming_region_refuses_ladder(pkg):
    """No sq8 codec for a binary region: the policy never nominates it,
    the transcription arm refuses (the old rung serves on), and the host
    index rejects the metric."""
    T = pkg.TIERING
    b = pkg.base
    Metric = pkg.distance.Metric
    with cluster(pkg, seed=13) as c:
        rid = c.create_region(index_type=b.IndexType.BINARY_FLAT,
                              metric=Metric.HAMMING)
        _sid, node = c.wait_leader(rid)
        region = node.get_region(rid)
        ids = np.arange(1, 17, dtype=np.int64)
        packed = np.random.default_rng(13).integers(
            0, 256, size=(16, DIM // 8), dtype=np.uint8)
        node.storage.vector_add(region, ids, packed)
        assert T._pick_demote({rid: region}, {rid: 0.0}, 5.0) is None
        st = T._state(region)
        st.rung = pkg.tiering.RUNG_HBM_SQ8   # force the transcription arm
        rep = T.demote(node, region)
        assert rep["ok"] is False
        res = node.storage.vector_batch_search(region, packed[:2], 3)
        assert [r[0].id for r in res] == [1, 2]
    with pytest.raises(b.InvalidParameter):
        pkg.tiering.HostSqFlat(1, b.IndexParameter(
            index_type=b.IndexType.FLAT, dimension=DIM,
            metric=Metric.HAMMING), store=None)


def test_tier_demote_command_flags_region_and_tick_demotes(pkg):
    """The coordinator handshake on the node: a TIER_DEMOTE region command
    with tiering on flags the region; with a synthetic one-byte budget
    one policy tick demotes exactly that region one rung, and the
    collector's next snapshot reports the rung."""
    T = pkg.TIERING
    FLAGS = pkg.FLAGS
    with cluster(pkg, seed=21) as c:
        rid = c.create_region()
        _sid, node = c.wait_leader(rid)
        region = node.get_region(rid)
        _fill(node, region, n=64)
        cmd = pkg.control.RegionCmd(
            cmd_id=99, region_id=rid,
            cmd_type=pkg.control.RegionCmdType.TIER_DEMOTE)
        node.execute_region_cmd(cmd)          # tiering off: acked, no flag
        assert rid not in T.state()
        FLAGS.set("tier_enabled", True)
        try:
            node.execute_region_cmd(cmd)
            assert T.state()[rid]["advisory"]
            T.budget_override = 1   # 1-byte budget: no headroom
            rep = T.tick(node)
        finally:
            FLAGS.set("tier_enabled", False)
            T.budget_override = None
        assert rep.get("ok"), rep
        assert rep["action"] == "demote" and rep["region"] == rid
        assert not T.state()[rid]["advisory"]   # consumed
        assert pkg.metrics.METRICS.counter(
            "tier.advisories", region_id=rid).get() >= 1
        node.metrics._latest_mono = 0.0
        snap = node.metrics.collect()
        assert snap.region(rid).serving_tier == "hbm_sq8"


def test_tick_noop_when_disabled(pkg):
    with cluster(pkg, seed=23) as c:
        rid = c.create_region()
        _sid, node = c.wait_leader(rid)
        assert pkg.TIERING.tick(node) == {}
        assert pkg.TIERING.region_tier(rid) == "hbm"


def test_region_tier_reporting_defaults(pkg):
    T = pkg.TIERING
    assert T.region_tier(999) == "hbm"
    assert T.region_tier(999, precision="sq8") == "hbm_sq8"


def _host_vs_device(p):
    T = p.TIERING
    with cluster(p, seed=31) as c:
        rid = c.create_region(precision="sq8")
        _sid, node = c.wait_leader(rid)
        region = node.get_region(rid)
        _ids, x = _fill(node, region, n=80)
        q = x[:6]
        dev = _topk(node, region, q, k=7)
        assert T.demote(node, region)["ok"]
        return dev, _topk(node, region, q, k=7)


def test_host_sq_flat_matches_device_sq8_ranking():
    """Demoting FLAT-sq8 a rung serves the same codes: the host scan's
    distances agree with the device arm's within bf16 tolerance and the
    rankings agree but across sub-bf16 near-ties, in both packages; the
    two packages' host rungs agree with each other."""
    got = {}
    for name in PKGS:
        p = Pkg(name)
        old = p.FLAGS.get("rerank_cache_rows")
        p.FLAGS.set("rerank_cache_rows", 0)
        try:
            got[name] = _host_vs_device(p)
        finally:
            p.FLAGS.set("rerank_cache_rows", old)
    for name, (dev, host) in got.items():
        for hi, di, hd, dd in zip(host[0], dev[0], host[1], dev[1]):
            np.testing.assert_allclose(np.asarray(hd), np.asarray(dd),
                                       rtol=2e-2, atol=0.2)
            assert hi[0] == di[0], name
            assert len(set(hi) & set(di)) >= 6, (name, hi, di)
    _same_modulo_ties(got["dingo_tpu"][1], got["dingo_tpu_torch"][1],
                      rtol=1e-5, atol=1e-5)


def test_snapshot_source_refuses_non_sq_store(pkg):
    class _Wrapper:
        class _Idx:
            store = object()

        own_index = _Idx()
        apply_log_id = 0
        _lock = threading.RLock()

    with pytest.raises(pkg.tiering.TierRefused):
        pkg.TIERING._snapshot_source(_Wrapper())


# -- the chaos harness's tier_kill, through each package's scenario -------

def test_tier_kill_mid_transition_loses_nothing(monkeypatch):
    """scenario_tier_kill of tools/chaos.py and of the port's
    dingo_tpu_torch/tools/chaos.py (seed 3): a kill between the verified
    copy and the swap of a demotion and one inside a promotion, each
    restart through StoreNode.recover(); 0 acknowledged rows lost after
    either restart, a clean scrub, still writable; the two packages'
    survivors answer alike (their top-3 of the first four rows, read when
    each scenario starts its warmed searches)."""
    import tools.chaos as jax_chaos
    from dingo_tpu_torch.tools import chaos as port_chaos

    rows = {}

    def spy(mod, name):
        real = mod._steady_recompiles

        def wrapped(node, region, queries, reps=3):
            rows[name] = _topk(node, region, queries, k=3)
            return real(node, region, queries, reps)

        monkeypatch.setattr(mod, "_steady_recompiles", wrapped)

    spy(jax_chaos, "dingo_tpu")
    spy(port_chaos, "dingo_tpu_torch")
    got = {"dingo_tpu": jax_chaos.scenario_tier_kill(3),
           "dingo_tpu_torch": port_chaos.scenario_tier_kill(3, device="cpu")}
    for name, g in got.items():
        assert g["lost"] == 0, name
        assert g["gates"]["digest_clean"], name
        assert g["gates"]["writable_after_recovery"], name
    _same_modulo_ties(rows["dingo_tpu"], rows["dingo_tpu_torch"],
                      rtol=1e-5, atol=1e-5)


# -- the stores, the staged pour, the carry --------------------------------

def _codec(p, x):
    return p.sq.sq_train(x)


def test_host_sq_store_equals_reference():
    """HostSqSlotStore holds the codes and decoded-row norms the JAX
    package's holds; canonical_rows are the codes; device bytes 0."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((300, DIM)).astype(np.float32)
    ids = np.arange(300, dtype=np.int64) * 7
    got = {}
    for name in PKGS:
        p = Pkg(name)
        st = (p.slot.HostSqSlotStore(DIM, torch.device("cpu"))
              if p.torch else p.slot.HostSqSlotStore(DIM))
        st.set_params(_codec(p, x))
        st.put(ids, x)
        st.remove_slots(ids[:10])
        snap = st.codes_to_host()
        got[name] = (np.asarray(st.vecs).copy(), st.sqnorm.copy(),
                     snap["ids"], snap["codes"], st.canonical_rows(x[:5]),
                     st.gather(ids[10:13])[1], st.memory_size())
    for a, b in zip(got["dingo_tpu"], got["dingo_tpu_torch"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    from dingo_tpu_torch.index.base import tensor_bytes

    st = Pkg("dingo_tpu_torch").slot.HostSqSlotStore(DIM,
                                                     torch.device("cpu"))
    assert tensor_bytes(st) == 0


def test_mmap_store_grows_and_unlinks(tmp_path):
    """The mmap rung's file holds the host rung's bytes, grows with the
    store's capacity, and close(unlink=True) removes it."""
    p = Pkg("dingo_tpu_torch")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5000, DIM)).astype(np.float32)
    ids = np.arange(5000, dtype=np.int64)
    path = str(tmp_path / "r" / "region_1.codes")
    mm = p.slot.MmapSqSlotStore(DIM, path, torch.device("cpu"))
    host = p.slot.HostSqSlotStore(DIM, torch.device("cpu"))
    params = _codec(p, x)
    for st in (mm, host):
        st.set_params(params)
        st.put(ids, x)                 # past MIN_CAPACITY: one growth
    assert mm.capacity == host.capacity == 16384
    assert os.path.getsize(path) == mm.disk_bytes() == 16384 * DIM
    np.testing.assert_array_equal(np.asarray(mm.vecs), host.vecs)
    np.testing.assert_array_equal(mm.sqnorm, host.sqnorm)
    assert mm.memory_size() == mm.sqnorm.nbytes
    mm.close(unlink=True)
    assert not os.path.exists(path) and len(mm.vecs) == 0


def test_staged_put_codes_equals_plain_put_codes():
    """The promotion's staged pour (a staging ring in the store's _upload
    hook) writes the same codes, norms and slots as a plain put_codes,
    and restores the hook."""
    p = Pkg("dingo_tpu_torch")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((9000, DIM)).astype(np.float32)
    ids = rng.permutation(20000)[:9000].astype(np.int64)
    params = _codec(p, x)
    codes = p.sq.sq_encode(x, params)
    a = p.slot.SqSlotStore(DIM, torch.device("cpu"), blocked=False)
    b = p.slot.SqSlotStore(DIM, torch.device("cpu"), blocked=False)
    for st in (a, b):
        st.set_params(params)
        st.reserve(16384)
    a.put_codes(ids, codes)
    p.tiering.TierManager._staged_put_codes(b, ids, codes)
    assert "_upload" not in vars(b)      # the store's own copy again
    assert torch.equal(a.vecs, b.vecs) and torch.equal(a.sqnorm, b.sqnorm)
    np.testing.assert_array_equal(a.ids_by_slot, b.ids_by_slot)


@pytest.mark.parametrize("index_type", ["flat", "ivf_flat"])
def test_carry_host_rung_snapshot_from_reference(tmp_path, index_type):
    """A host-rung index the JAX package saved (HostSqFlat.save) loads
    into the port's HostSqFlat through carry.host_rung_from_reference and
    answers with the same ids, and distances within the fp32 tolerance
    (the same codes, decode and norms; the product sums in another order).
    The loaded store holds the snapshot's codes byte for byte."""
    ref = Pkg("dingo_tpu")
    b = ref.base
    kw = ({"ncentroids": 4, "default_nprobe": 4}
          if index_type == "ivf_flat" else {})
    with cluster(ref, seed=41) as c:
        rid = c.create_region(index_type=b.IndexType(index_type), **kw)
        _sid, node = c.wait_leader(rid)
        region = node.get_region(rid)
        _ids, x = _fill(node, region)
        q = x[::9] + np.float32(0.05)
        assert ref.TIERING.demote(node, region)["ok"]
        assert ref.TIERING.demote(node, region)["ok"]
        own = region.vector_index_wrapper.own_index
        assert isinstance(own, ref.tiering.HostSqFlat)
        own.save(str(tmp_path / "snap"))
        want = own.search(q, 10)
    from dingo_tpu_torch.index.carry import host_rung_from_reference
    from dingo_tpu_torch.index.tiering import HostSqFlat

    port = host_rung_from_reference(str(tmp_path / "snap"), device="cpu",
                                    index_id=rid)
    assert isinstance(port, HostSqFlat)
    assert port.get_device_memory_size() == 0
    got = port.search(q, 10)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_allclose(g.distances, w.distances, rtol=1e-5,
                                   atol=1e-5)
    snap = np.load(str(tmp_path / "snap" / "flat.npz"))
    mine = port.store.codes_to_host()
    np.testing.assert_array_equal(mine["ids"], snap["ids"])
    np.testing.assert_array_equal(mine["codes"], snap["codes"])


def test_host_rung_ignores_search_parameters():
    """An IVF_FLAT region on host_sq8 answers a search that passes nprobe
    (IndexService always passes the request's): the exact scan has no use
    for it, and the reply equals the one without it; a parameter no
    ladder family takes raises TypeError. The JAX package's host rung
    raises TypeError on nprobe too (ROADMAP section C); both packages'
    replies without it agree."""
    got = {}
    for name in PKGS:
        p = Pkg(name)
        with cluster(p, seed=3) as c:
            rid = c.create_region(index_type=p.base.IndexType.IVF_FLAT,
                                  ncentroids=4, default_nprobe=4)
            _sid, node = c.wait_leader(rid)
            region = node.get_region(rid)
            _ids, x = _fill(node, region)
            assert p.TIERING.demote(node, region)["ok"]
            assert p.TIERING.demote(node, region)["ok"]
            plain = _topk(node, region, x[:4])
            if p.torch:
                res = node.storage.vector_batch_search(region, x[:4], 10,
                                                       nprobe=4)
                assert ([[r.id for r in row] for row in res],
                        [[r.distance for r in row] for row in res]) == plain
                with pytest.raises(TypeError):
                    node.storage.vector_batch_search(region, x[:4], 10,
                                                     nprob=4)
            else:
                with pytest.raises(TypeError):
                    node.storage.vector_batch_search(region, x[:4], 10,
                                                     nprobe=4)
            got[name] = plain
    _same_modulo_ties(got["dingo_tpu"], got["dingo_tpu_torch"], rtol=1e-5,
                      atol=1e-5)


@pytest.mark.parametrize("index_type", ["flat", "ivf_flat"])
def test_retire_frees_the_replaced_index(index_type):
    """The port's retire frees the device tensors of every index a
    transition swaps out, even where something still refers to the object
    (here the test itself; the JAX package leaves its arrays to their last
    reference): the fp32 index after hbm -> hbm_sq8, the device sq8 index
    after hbm_sq8 -> host_sq8, and on the way up the device sq8 index
    after hbm_sq8 -> hbm. The serving index answers as before each step
    (ids equal, distances within rtol/atol 1e-5 across the rebuilds)."""
    p = Pkg("dingo_tpu_torch")
    kw = ({"ncentroids": 4, "default_nprobe": 4}
          if index_type == "ivf_flat" else {})
    with cluster(p, seed=3) as c:
        rid = c.create_region(index_type=p.base.IndexType(index_type), **kw)
        _sid, node = c.wait_leader(rid)
        region = node.get_region(rid)
        _ids, x = _fill(node, region)
        w = region.vector_index_wrapper
        before = _topk(node, region, x[:8])
        fp32 = w.own_index
        assert p.base.tensor_bytes(fp32) > 0
        assert p.TIERING.demote(node, region)["ok"]
        sq8 = w.own_index
        assert p.base.tensor_bytes(fp32) == 0
        assert p.base.tensor_bytes(sq8) > 0
        at_sq8 = _topk(node, region, x[:8])
        assert p.TIERING.demote(node, region)["ok"]
        assert p.base.tensor_bytes(sq8) == 0
        assert _topk(node, region, x[:8])[0] == at_sq8[0]
        assert p.TIERING.promote(node, region)["ok"]
        up_sq8 = w.own_index
        assert p.TIERING.promote(node, region)["ok"]
        assert p.base.tensor_bytes(up_sq8) == 0
        assert p.base.tensor_bytes(w.own_index) > 0
        after = _topk(node, region, x[:8])
        # the IVF arm retrains at each rebuild: distances to within f32
        # sums in another order
        assert after[0] == before[0]
        np.testing.assert_allclose(after[1], before[1], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("wait_s", [30.0, 0.05])
def test_retire_waits_for_a_dispatched_search(monkeypatch, wait_s):
    """A search dispatched on the fp32 index before the swap holds it
    (the wrapper's pin) until its resolve: the retire frees the index
    only then, and the search resolves to the answer it would have given.
    A pin that outlasts RETIRE_WAIT_S leaves the index to its last
    reference (a warning, no free)."""
    p = Pkg("dingo_tpu_torch")
    monkeypatch.setattr(p.tiering, "RETIRE_WAIT_S", wait_s)
    with cluster(p, seed=3) as c:
        rid = c.create_region(index_type=p.base.IndexType.FLAT)
        _sid, node = c.wait_leader(rid)
        region = node.get_region(rid)
        _ids, x = _fill(node, region)
        w = region.vector_index_wrapper
        fp32 = w.own_index
        want = fp32.search(x[:4], 10)
        thunk = w.search_async(x[:4], 10)
        reps = []
        t = threading.Thread(
            target=lambda: reps.append(p.TIERING.demote(node, region)))
        t.start()
        deadline = time.monotonic() + 60
        while w.own_index is fp32 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert w.own_index is not fp32
        if wait_s < 1.0:
            t.join(timeout=60)
        assert p.base.tensor_bytes(fp32) > 0
        got = thunk()
        t.join(timeout=60)
        assert reps and reps[0]["ok"], reps
        for g, e in zip(got, want):
            np.testing.assert_array_equal(g.ids, e.ids)
            np.testing.assert_array_equal(g.distances, e.distances)
        assert (p.base.tensor_bytes(fp32) == 0) == (wait_s > 1.0)
