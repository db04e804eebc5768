"""The device recovery ladder of the port (index/recovery.py,
ops/devfault.py, obs/hbm.py) against the JAX package's: the cases of
test_device_recovery.py on a single-replica StoreNode of each package
(no coordinator; the region from ``create_region``, FLAT at DIM 8), run
through both packages under the same device-fault schedule, plus parity
of the replies and the OOM classification of torch's own error.

The port runs on the CPU (``device="cpu"``). Raft waits have deadlines.
"""

import dataclasses
import importlib
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

PKGS = ("dingo_tpu", "dingo_tpu_torch")
DIM = 8


class Pkg:
    MODS = {"regm": "store.region", "vcodec": "index.codec",
            "base": "index.base", "node": "store.node", "raft": "raft",
            "rec": "index.recovery", "devfault": "ops.devfault",
            "hbm": "obs.hbm", "config": "common.config"}

    def __init__(self, name):
        self.name = name
        self.kw = {"device": "cpu"} if name == "dingo_tpu_torch" else {}
        for attr, m in self.MODS.items():
            setattr(self, attr, importlib.import_module(f"{name}.{m}"))

    @property
    def RECOVERY(self):
        return self.rec.RECOVERY

    @property
    def DEVFAULT(self):
        return self.devfault.DEVFAULT

    def param(self, **kw):
        b = self.base
        return b.IndexParameter(index_type=b.IndexType.FLAT, dimension=DIM,
                                **kw)

    def node_with_region(self, rid=5):
        n = self.node.StoreNode("s0", self.raft.LocalTransport(), None,
                                raft_kw={"seed": 0}, **self.kw)
        r = self.regm
        d = r.RegionDefinition(
            region_id=rid,
            start_key=self.vcodec.encode_vector_key(0, 0),
            end_key=self.vcodec.encode_vector_key(0, 1 << 40),
            partition_id=0, peers=["s0"], region_type=r.RegionType.INDEX,
            index_parameter=self.param())
        region = n.create_region(d)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            rn = n.engine.get_node(rid)
            if rn is not None and rn.is_leader():
                break
            time.sleep(0.02)
        assert n.engine.get_node(rid).is_leader()
        return n, region


def _reset(p):
    p.DEVFAULT.disarm()
    p.RECOVERY.clear()
    # the ladder count is process-wide and clear() keeps it: a test file
    # run earlier in the same worker (test_torch_cluster.py's heartbeat
    # case walks the ladder in both packages) must not leak into this one
    p.RECOVERY.ladder_runs = 0


@pytest.fixture(params=PKGS)
def p(request):
    pkg = Pkg(request.param)
    _reset(pkg)
    yield pkg
    _reset(pkg)


@pytest.fixture()
def node(p):
    n, region = p.node_with_region()
    yield n, region
    n.stop()


def _rows(n=16, seed=0):
    rng = np.random.default_rng(seed)
    return (np.arange(n, dtype=np.int64),
            rng.standard_normal((n, DIM)).astype(np.float32))


def test_single_fault_recovered_by_ladder_retry(p, node):
    n, region = node
    ids, x = _rows()
    n.storage.vector_add(region, ids, x)
    p.DEVFAULT.arm(1)
    res = n.storage.vector_batch_search(region, x[:1], 3)
    assert res[0][0].id == 0
    assert not p.RECOVERY.is_degraded(region.id)
    assert p.DEVFAULT.armed() == 0   # the fault actually fired
    assert p.RECOVERY.ladder_runs == 1


def test_persistent_oom_degrades_and_serves_host_path(p, node):
    n, region = node
    ids, x = _rows()
    n.storage.vector_add(region, ids[:8], x[:8])
    p.DEVFAULT.arm(1 << 30)
    # a write under the storm is absorbed (the engine keeps it) and the
    # region degrades
    n.storage.vector_add(region, ids[8:], x[8:])
    assert p.RECOVERY.is_degraded(region.id)
    # searches take the host exact path and see both the pre-degrade rows
    # and the degraded-window write the engine holds
    res = n.storage.vector_batch_search(region, x[8:9], 3)
    assert res[0][0].id == 8
    res = n.storage.vector_batch_search(region, x[:1], 3)
    assert res[0][0].id == 0


def test_degraded_write_does_not_advance_apply_log_id(p, node):
    n, region = node
    ids, x = _rows()
    n.storage.vector_add(region, ids[:8], x[:8])
    wrapper = region.vector_index_wrapper
    before = wrapper.apply_log_id
    p.DEVFAULT.arm(1 << 30)
    n.storage.vector_add(region, ids[8:], x[8:])
    assert p.RECOVERY.is_degraded(region.id)
    assert wrapper.apply_log_id == before


def test_rematerialization_exits_degraded_at_lower_precision(p, node):
    n, region = node
    ids, x = _rows()
    n.storage.vector_add(region, ids[:8], x[:8])
    p.DEVFAULT.arm(1 << 30)
    n.storage.vector_add(region, ids[8:], x[8:])
    assert p.RECOVERY.is_degraded(region.id)
    p.DEVFAULT.disarm()

    assert p.RECOVERY.run_rematerializations(n) == 1
    assert not p.RECOVERY.is_degraded(region.id)
    idx = region.vector_index_wrapper.own_index
    # the advisory-lower resident precision; the definition is unchanged
    assert idx.parameter.precision == "sq8"
    assert region.definition.index_parameter.precision == ""
    # the degraded-window write materialized during the rebuild
    res = n.storage.vector_batch_search(region, x[8:9], 3)
    assert res[0][0].id == 8


def test_remat_parameter_narrows_only_when_different(p):
    q = p.param(precision="fp32")
    out = p.rec.DeviceRecoveryPlane.remat_parameter(q)
    assert out.precision == "sq8"
    assert q.precision == "fp32"            # original untouched (frozen)
    already = dataclasses.replace(q, precision="sq8")
    assert p.rec.DeviceRecoveryPlane.remat_parameter(already) is already


def test_non_oom_exception_propagates_untouched(p):
    plane = p.rec.DeviceRecoveryPlane()

    def op():
        raise KeyError("not an oom")

    with pytest.raises(KeyError):
        plane.attempt(None, 1, op)
    assert not plane.is_degraded(1)
    assert plane.ladder_runs == 0


def test_recovery_off_lets_the_oom_propagate(p, node):
    """device_recovery_enabled off: the injected OOM reaches the caller
    and nothing degrades (both packages)."""
    n, region = node
    ids, x = _rows()
    n.storage.vector_add(region, ids, x)
    FLAGS = p.config.FLAGS
    FLAGS.set("device_recovery_enabled", False)
    try:
        p.DEVFAULT.arm(1)
        with pytest.raises(p.devfault.InjectedDeviceFault):
            n.storage.vector_batch_search(region, x[:1], 3)
    finally:
        FLAGS.set("device_recovery_enabled", True)
    assert not p.RECOVERY.is_degraded(region.id)


def test_looks_like_oom_classifies_torch_oom():
    from dingo_tpu_torch.obs.hbm import looks_like_oom
    from dingo_tpu_torch.ops.devfault import InjectedDeviceFault

    assert looks_like_oom(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert looks_like_oom(torch.OutOfMemoryError("x"))
    assert looks_like_oom(InjectedDeviceFault("x"))
    # the type decides, not the text
    assert not looks_like_oom(RuntimeError("CUDA out of memory"))
    assert not looks_like_oom(KeyError("RESOURCE_EXHAUSTED"))


def test_fault_names_carry_the_reference_program_names():
    """An arm written for the JAX package's program names targets the
    same dispatch in the port: the sentinel's launches fire under the
    reference name, and a substring that matches nothing never fires."""
    from dingo_tpu_torch.obs.sentinel import FAULT_NAMES, SENTINEL
    from dingo_tpu_torch.ops.devfault import DEVFAULT, InjectedDeviceFault

    assert FAULT_NAMES["pruned_fused_topk"] == "ops.pallas.pruned_fused_topk"
    t = torch.zeros(2)
    try:
        DEVFAULT.arm(1, kernel_substr="ops.pallas.ivf_pruned_topk")
        SENTINEL.launch("fused_topk", (t,))          # no match: no fault
        assert DEVFAULT.armed() == 1
        with pytest.raises(InjectedDeviceFault):
            SENTINEL.launch("ivf_pruned_topk", (t,))
        assert DEVFAULT.armed() == 0
    finally:
        DEVFAULT.disarm()


def _schedule(p):
    """One fault schedule through a package: writes, a recovered search
    fault, a degrading write storm with searches, re-materialization, and
    searches after it. Returns every reply's ids and the degraded flags."""
    n, region = p.node_with_region(rid=11)
    try:
        ids, x = _rows(48, seed=3)
        q = x[::5] + 0.01
        out = []
        n.storage.vector_add(region, ids[:24], x[:24])
        p.DEVFAULT.arm(1)
        out.append(n.storage.vector_batch_search(region, q, 4))
        p.DEVFAULT.arm(1 << 30)
        n.storage.vector_add(region, ids[24:40], x[24:40])
        n.storage.vector_delete(region, ids[:4])
        out.append(n.storage.vector_batch_search(region, q, 4))
        flags = [p.RECOVERY.is_degraded(region.id)]
        p.DEVFAULT.disarm()
        flags.append(p.RECOVERY.run_rematerializations(n))
        n.storage.vector_add(region, ids[40:], x[40:])
        out.append(n.storage.vector_batch_search(region, q, 4))
        flags.append(p.RECOVERY.is_degraded(region.id))
        return [[[v.id for v in row] for row in rep] for rep in out], flags
    finally:
        n.stop()
        _reset(p)


def test_same_replies_under_the_same_fault_schedule():
    want = _schedule(Pkg("dingo_tpu"))
    got = _schedule(Pkg("dingo_tpu_torch"))
    assert got == want
    assert want[1] == [True, 1, False]


def test_rematerialization_on_a_mono_store_node():
    """A MonoStoreNode's region (no raft member, no log to replay) walks
    the same ladder and re-materializes."""
    from dingo_tpu_torch.index import codec as vcodec
    from dingo_tpu_torch.index.base import IndexParameter, IndexType
    from dingo_tpu_torch.index.recovery import RECOVERY
    from dingo_tpu_torch.ops.devfault import DEVFAULT
    from dingo_tpu_torch.store.node import MonoStoreNode
    from dingo_tpu_torch.store.region import RegionDefinition, RegionType

    node = MonoStoreNode(device="cpu")
    region = node.create_region(RegionDefinition(
        region_id=4, start_key=vcodec.encode_vector_key(0, 0),
        end_key=vcodec.encode_vector_key(1), region_type=RegionType.INDEX,
        index_parameter=IndexParameter(index_type=IndexType.FLAT,
                                       dimension=DIM)))
    ids, x = _rows()
    try:
        node.storage.vector_add(region, ids[:8], x[:8])
        DEVFAULT.arm(1 << 30)
        node.storage.vector_add(region, ids[8:], x[8:])
        assert RECOVERY.is_degraded(4)
        DEVFAULT.disarm()
        assert RECOVERY.run_rematerializations(node) == 1
        assert not RECOVERY.is_degraded(4)
        res = node.storage.vector_batch_search(region, x[8:9], 3)
        assert res[0][0].id == 8
    finally:
        DEVFAULT.disarm()
        RECOVERY.clear()
        node.stop()
