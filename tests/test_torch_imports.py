"""The port stands alone: it imports without JAX or the JAX package, every
module but the gRPC front end imports without grpc and protobuf too, and
its entry points run on the CUDA device unless told otherwise."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the gRPC front end: the only port modules that import grpc or protobuf
#: (the card's machine has neither, and no phase of the smoke imports them)
FRONT_END = ("dingo_tpu_torch.server.dingo_pb2",
             "dingo_tpu_torch.server.convert",
             "dingo_tpu_torch.server.grpc_services",
             "dingo_tpu_torch.server.rpc",
             "dingo_tpu_torch.raft.grpc_transport")

_BLOCKED_IMPORT = textwrap.dedent("""
    import importlib, pkgutil, sys

    FRONT_END = @FRONT_END@

    class Block:
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "dingo_tpu", "grpc") or \
                    name.startswith("google.protobuf"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    import dingo_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        dingo_tpu_torch.__path__, prefix="dingo_tpu_torch.")]
    assert set(FRONT_END) <= set(names), names
    for name in names:
        if name not in FRONT_END:
            importlib.import_module(name)
    # the precision tiers' modules, B1/B2's split-product models and the
    # coalesced serving path are among them
    assert {"dingo_tpu_torch.ops.sq", "dingo_tpu_torch.ops.split_dot",
            "dingo_tpu_torch.index.rerank_cache",
            "dingo_tpu_torch.common.log", "dingo_tpu_torch.common.pipeline",
            "dingo_tpu_torch.common.coalescer",
            "dingo_tpu_torch.trace.span", "dingo_tpu_torch.trace.export",
            "dingo_tpu_torch.obs.pressure", "dingo_tpu_torch.obs.sentinel",
            "dingo_tpu_torch.server.services",
            "dingo_tpu_torch.common.stream"} <= set(names), names
    # the replicated region path: raft, the MVCC engine, apply, Storage
    # and VectorReader, the index manager and the store node, none of
    # which may need grpc or protobuf (the card's machine has neither)
    assert {"dingo_tpu_torch.raft.wire", "dingo_tpu_torch.raft.log",
            "dingo_tpu_torch.raft.transport", "dingo_tpu_torch.raft.core",
            "dingo_tpu_torch.common.failpoint",
            "dingo_tpu_torch.common.persist",
            "dingo_tpu_torch.mvcc.codec", "dingo_tpu_torch.mvcc.reader",
            "dingo_tpu_torch.mvcc.ts_provider",
            "dingo_tpu_torch.engine.raw_engine",
            "dingo_tpu_torch.engine.write_data",
            "dingo_tpu_torch.engine.apply",
            "dingo_tpu_torch.engine.apply_results",
            "dingo_tpu_torch.engine.raft_engine",
            "dingo_tpu_torch.engine.mono_engine",
            "dingo_tpu_torch.engine.storage",
            "dingo_tpu_torch.coprocessor.scalar_filter",
            "dingo_tpu_torch.index.codec",
            "dingo_tpu_torch.index.vector_reader",
            "dingo_tpu_torch.index.manager",
            "dingo_tpu_torch.store.region",
            "dingo_tpu_torch.store.node"} <= set(names), names
    # the device recovery ladder and HNSW: the walk, kernel G's wrapper,
    # the bulk build, the index and the host graph's own binding
    assert {"dingo_tpu_torch.ops.devfault", "dingo_tpu_torch.obs.hbm",
            "dingo_tpu_torch.index.recovery", "dingo_tpu_torch.ops.beam",
            "dingo_tpu_torch.ops.kernel_beam",
            "dingo_tpu_torch.ops.graph_build",
            "dingo_tpu_torch.index.hnsw",
            "dingo_tpu_torch.native"} <= set(names), names
    # the in-process control plane: the coordinator, the metrics plane,
    # the store's checkers and the roles' crontab schedules
    assert {"dingo_tpu_torch.common.runnable",
            "dingo_tpu_torch.common.crontab",
            "dingo_tpu_torch.coordinator.tso",
            "dingo_tpu_torch.coordinator.auto_increment",
            "dingo_tpu_torch.coordinator.kv_control",
            "dingo_tpu_torch.coordinator.control",
            "dingo_tpu_torch.coordinator.capacity",
            "dingo_tpu_torch.coordinator.balance",
            "dingo_tpu_torch.coordinator.meta",
            "dingo_tpu_torch.coordinator.raft_meta",
            "dingo_tpu_torch.coordinator.carry",
            "dingo_tpu_torch.metrics.snapshot",
            "dingo_tpu_torch.metrics.collector",
            "dingo_tpu_torch.store.checker",
            "dingo_tpu_torch.server.main"} <= set(names), names
    # the diskann role's core and its item manager (its service is gRPC
    # and comes with the front end)
    assert {"dingo_tpu_torch.diskann", "dingo_tpu_torch.diskann.core",
            "dingo_tpu_torch.diskann.item"} <= set(names), names
    # the observability planes: digests and the integrity scrub, the
    # shadow scan and quality plane, the SLO tuner, events, heat, cost,
    # the HBM ledger, the flight recorder and the Prometheus sidecar
    assert {"dingo_tpu_torch.ops.digest", "dingo_tpu_torch.ops.shadow",
            "dingo_tpu_torch.obs.integrity", "dingo_tpu_torch.obs.quality",
            "dingo_tpu_torch.obs.tuner", "dingo_tpu_torch.obs.events",
            "dingo_tpu_torch.obs.heat", "dingo_tpu_torch.obs.cost",
            "dingo_tpu_torch.obs.flight", "dingo_tpu_torch.metrics.device",
            "dingo_tpu_torch.metrics.http"} <= set(names), names
    # the memory-tier ladder and the serving-edge cache
    assert {"dingo_tpu_torch.index.tiering", "dingo_tpu_torch.cache",
            "dingo_tpu_torch.cache.keys", "dingo_tpu_torch.cache.store",
            "dingo_tpu_torch.cache.policy", "dingo_tpu_torch.cache.dedupe",
            "dingo_tpu_torch.cache.edge",
            "dingo_tpu_torch.index.carry"} <= set(names), names
    # the coprocessor and its typed rows, transactions, GC, the native LSM
    # engine, documents and the per-request tracker
    assert {"dingo_tpu_torch.coprocessor.expr",
            "dingo_tpu_torch.coprocessor.aggregation",
            "dingo_tpu_torch.coprocessor.coprocessor_v2",
            "dingo_tpu_torch.common.serial",
            "dingo_tpu_torch.common.tracker",
            "dingo_tpu_torch.engine.concurrency",
            "dingo_tpu_torch.engine.txn", "dingo_tpu_torch.engine.gc",
            "dingo_tpu_torch.engine.lsm_engine",
            "dingo_tpu_torch.document", "dingo_tpu_torch.document.index",
            "dingo_tpu_torch.document.query"} <= set(names), names
    # the chaos harness and its crash-recovery matrix
    assert {"dingo_tpu_torch.tools",
            "dingo_tpu_torch.tools.chaos"} <= set(names), names
    import chip_smoke  # the on-card smoke script imports nothing of JAX either
    import precision_check  # nor does the f32-against-f64 check
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "dingo_tpu", "grpc")
           or m.startswith("google.protobuf")]
    assert not bad, bad
    print(len(names))
""").replace("@FRONT_END@", repr(FRONT_END))

# the front end imports grpc and protobuf, and still nothing of JAX
_FRONT_END_IMPORT = textwrap.dedent("""
    import importlib, sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "dingo_tpu"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    for name in @FRONT_END@:
        importlib.import_module(name)
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "dingo_tpu")]
    assert not bad, bad
    assert "grpc" in sys.modules and "google.protobuf" in sys.modules
    print("ok")
""").replace("@FRONT_END@", repr(FRONT_END))


def test_port_imports_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 60
    out = subprocess.run(
        [sys.executable, "-c", _FRONT_END_IMPORT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_new_index_without_device_raises_when_no_cuda(monkeypatch):
    from dingo_tpu_torch.common.device import DeviceUnavailable
    from dingo_tpu_torch.index.base import IndexParameter, IndexType
    from dingo_tpu_torch.index.factory import new_index
    from dingo_tpu_torch.index.wrapper import VectorIndexWrapper

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for t in (IndexType.FLAT, IndexType.IVF_FLAT, IndexType.BRUTEFORCE,
              IndexType.HNSW, IndexType.BINARY_FLAT,
              IndexType.BINARY_IVF_FLAT):
        param = IndexParameter(index_type=t, dimension=8, ncentroids=4)
        with pytest.raises(DeviceUnavailable):
            new_index(1, param)
        with pytest.raises(DeviceUnavailable):
            new_index(1, param, device="cuda")
        with pytest.raises(DeviceUnavailable):
            VectorIndexWrapper(1, param).build_own()
        assert new_index(1, param, device="cpu") is not None


def test_kernel_wrappers_refuse_mixed_devices():
    """A wrapper runs its plain version only for CPU tensors; anything
    else must go to the kernel or raise, never silently to the CPU."""
    from dingo_tpu_torch.ops.kernel_topk import fused_topk

    q = torch.zeros((2, 4))
    x = torch.zeros((8, 4), device="meta")
    with pytest.raises(ValueError):
        fused_topk(q, x, torch.zeros(8), torch.ones(8, dtype=torch.bool), 2)


def test_candidate_scores_refuses_mixed_devices():
    """Kernel G's wrapper, likewise: CPU tensors take the plain version,
    a placement that is neither all-CPU nor one CUDA device raises."""
    from dingo_tpu_torch.ops.distance import Metric
    from dingo_tpu_torch.ops.kernel_beam import candidate_scores

    q = torch.zeros((2, 4))
    slots = torch.tensor([[0, -1], [1, 0]], dtype=torch.int32)
    x = torch.zeros((8, 4), device="meta")
    with pytest.raises(ValueError):
        candidate_scores(q, x, torch.zeros(8), slots, Metric.L2)
    got = candidate_scores(q, torch.ones((8, 4)), torch.full((8,), 4.0),
                           slots, Metric.L2)
    assert torch.equal(torch.isneginf(got), slots < 0)
