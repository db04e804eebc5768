"""The port's chaos harness (dingo_tpu_torch/tools/chaos.py) against the JAX
package's (tools/chaos.py): each of the six scenarios and each case of
tests/test_chaos.py's crash-recovery matrix run through both packages at
the JAX package's sizes (DIM 16, each scenario's own rows, the matrix's 48),
the port on the CPU.

Held equal: the result's keys and gate names, the acknowledged and lost
row counts, and the matrix's post-restart top-1 ids. Every gate that
reads no clock is asserted in both packages. The two clock gates,
``recovery_bounded`` and ``goodput_floor``, are recorded and not asserted
here: they read the host's clock, and six test workers on the host's cores
move it (the JAX package's leader_failover gate failed so under load);
chip_smoke.py's chaos phase asserts them on the card. The digest gate of
both packages sweeps again after a raced sweep (see _jax_digest_clean)."""

import json
import time

import numpy as np
import pytest
import torch

import tools.chaos as jax_chaos
from dingo_tpu.index.base import IndexType as JaxIndexType
from dingo_tpu_torch.common.device import DeviceUnavailable
from dingo_tpu_torch.index.base import IndexType
from dingo_tpu_torch.tools import chaos

torch.set_num_threads(1)

#: gates that read the host's clock
CLOCK_GATES = {"recovery_bounded", "goodput_floor"}


def _assert_gates(result, who):
    for gate, ok in result["gates"].items():
        if gate not in CLOCK_GATES:
            assert ok, (who, result["name"], gate, result)


def _jax_digest_clean(node):
    """tools/chaos.py's digest gate under the port harness's rule for a
    raced sweep: a sweep that overlapped a follower's apply of the last
    entry (status "raced") decides nothing and runs again. The JAX
    harness counts it unclean, so its three-replica scenarios can fail
    the gate by thread timing."""
    from dingo_tpu.obs.integrity import INTEGRITY

    for _ in range(20):
        results = INTEGRITY.scrub_node(node)
        statuses = [r.get("status") for per in results.values()
                    for r in per.values()]
        if "raced" not in statuses:
            break
        time.sleep(0.05)
    return all(st in ("ok", "skipped", "advisory") for st in statuses)


@pytest.mark.parametrize("name", sorted(jax_chaos.SCENARIOS))
def test_scenario_matches_the_jax_package(name, monkeypatch):
    monkeypatch.setattr(jax_chaos, "_digest_clean", _jax_digest_clean)
    ref = jax_chaos.SCENARIOS[name](seed=0)
    got = chaos.SCENARIOS[name](0, device="cpu")
    assert set(got) == set(ref)
    assert list(got["gates"]) == list(ref["gates"])
    assert (got["acked"], got["lost"]) == (ref["acked"], ref["lost"])
    assert got["lost"] == 0
    _assert_gates(ref, "dingo_tpu")
    _assert_gates(got, "dingo_tpu_torch")
    assert got["recovery_ms"] >= 0.0
    if "goodput" in ref:
        assert 0.0 <= got["goodput"] <= 1.0


def _jax_matrix_case(index_type, precision):
    """tests/test_chaos.py::test_crash_recovery_matrix's steps on the JAX
    package: (lost ids, digest clean, top-1 ids after the restart,
    writable)."""
    param_kw = {}
    if index_type == JaxIndexType.IVF_FLAT:
        param_kw = {"ncentroids": 4, "default_nprobe": 4}
    with jax_chaos.cluster(1, replication=1, seed=11, durable=True) as c:
        rid = c.create_region(index_type=index_type, precision=precision,
                              **param_kw)
        _sid, node = c.wait_leader(rid)
        region = node.get_region(rid)
        ids, x = jax_chaos._corpus(11, 48)
        acked = {}
        for lo in range(0, 48, 8):
            node.storage.vector_add(region, ids[lo:lo + 8], x[lo:lo + 8])
            acked.update({int(ids[i]): x[i] for i in range(lo, lo + 8)})
        c.kill("s0")
        node2 = c.restart("s0")
        c.wait_leader(rid)
        region2 = node2.get_region(rid)
        res = node2.storage.vector_batch_search(region2, x[:4], 1)
        lost = jax_chaos._acked_lost(node2, region2, acked)
        clean = jax_chaos._digest_clean(node2)
        node2.storage.vector_add(region2, np.arange(900, 904), x[:4])
        writable = node2.storage.vector_batch_query(region2, [900])[0] \
            is not None
    return lost, clean, [int(r[0].id) for r in res], writable


@pytest.mark.parametrize(
    "index_type,precision", chaos.MATRIX,
    ids=[f"{t.value}-{p}" for t, p in chaos.MATRIX])
def test_crash_recovery_matrix_matches_the_jax_package(index_type,
                                                       precision):
    lost, clean, top1, writable = _jax_matrix_case(
        JaxIndexType(index_type.value), precision)
    assert lost == [] and clean and writable
    assert top1 == [0, 1, 2, 3]
    got = chaos.crash_recovery_case(index_type, precision, device="cpu")
    assert got["name"] == f"{index_type.value}-{precision}"
    _assert_gates(got, "dingo_tpu_torch")
    assert (got["acked"], got["lost"]) == (48, 0)
    assert got["top1"] == top1


def test_run_scenarios_aggregates_and_survives_errors(monkeypatch):
    def boom(seed, **kw):
        raise RuntimeError("synthetic scenario crash")

    monkeypatch.setitem(chaos.SCENARIOS, "bitflip", boom)
    out = chaos.run_scenarios(["bitflip"], seed=3, device="cpu")
    assert out["passed"] is False
    assert "synthetic scenario crash" in out["scenarios"][0]["error"]
    assert out["scenarios"][0]["gates"] == {"completed": False}


def test_run_matrix_records_a_crash_as_a_failure(monkeypatch):
    def boom(index_type, precision, seed, **kw):
        raise RuntimeError("synthetic case crash")

    monkeypatch.setattr(chaos, "crash_recovery_case", boom)
    out = chaos.run_matrix(device="cpu")
    assert out["passed"] is False
    assert [c["name"] for c in out["cases"]] == [
        f"{t.value}-{p}" for t, p in chaos.MATRIX]
    assert all("synthetic case crash" in c["error"] for c in out["cases"])


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        chaos.run_scenarios(["bitflip"])
    with pytest.raises(DeviceUnavailable):
        chaos.main(["bitflip"])
    with pytest.raises(DeviceUnavailable):
        chaos.crash_recovery_case(IndexType.FLAT, "fp32")


def test_main_unknown_scenario_and_json_verdict(capsys):
    assert chaos.main(["no_such_scenario"]) == 2
    assert "unknown scenario" in capsys.readouterr().err
    assert chaos.main(["bitflip", "--device", "cpu", "--seed", "1",
                       "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["passed"] is True and out["seed"] == 1
    assert [r["name"] for r in out["scenarios"]] == ["bitflip"]
