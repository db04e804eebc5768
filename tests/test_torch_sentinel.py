"""The launch-and-shape sentinel (dingo_tpu_torch/obs/sentinel.py): launch
and new-shape counting with the JAX sentinel's meaning under ``kernel.*``
names, library builds reported by ops/cuda_build.py, every kernel wrapper
of ops/kernel_*.py reporting its calls (on the CPU under route "plain"),
and the invariant the JAX package checks with its recompile counter: a
warmed batch ladder of 1 to 64 sees no new shape under a coalesced run,
serial or pipelined, while a batch off the warmed shapes is counted.

Indexes are small (d 32, nlist 16, ivf_dim_block 8) and on the CPU, with
the kernel crossovers forced on so that searches reach the wrappers."""

import os
import stat

import numpy as np
import pytest
import torch

from dingo_tpu_torch.common.config import FLAGS
from dingo_tpu_torch.common.metrics import METRICS
from dingo_tpu_torch.index.base import IndexParameter, IndexType
from dingo_tpu_torch.index.factory import new_index
from dingo_tpu_torch.index.wrapper import VectorIndexWrapper
from dingo_tpu_torch.obs.sentinel import SENTINEL, LaunchSentinel
from dingo_tpu_torch.server.services import IndexService
from dingo_tpu_torch.trace import TRACE_BUFFER
from torch_region_util import node_over_wrapper

# small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

D, NLIST, K = 32, 16, 10
ROUTE_FLAGS = ("use_pallas_fused_search", "use_pallas_ivf_search",
               "vector_blocked_layout", "ivf_prune_scan", "ivf_dim_block",
               "ivfpq_rerank_factor", "pipeline_enabled")


@pytest.fixture
def flags():
    saved = {f: FLAGS.get(f) for f in ROUTE_FLAGS}
    FLAGS.set("ivf_dim_block", 8)
    FLAGS.set("use_pallas_fused_search", True)
    FLAGS.set("use_pallas_ivf_search", True)
    try:
        yield FLAGS
    finally:
        for f, v in saved.items():
            FLAGS.set(f, v)


def _data(n=3000, seed=3):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((16, D), dtype=np.float32)
    x = centers[rng.integers(0, 16, n)] + 0.3 * rng.standard_normal(
        (n, D), dtype=np.float32)
    return x.astype(np.float32)


def test_launch_counts_new_shapes_and_hits():
    s = LaunchSentinel()
    a = torch.zeros((4, 8))
    b = torch.zeros((16, 8), dtype=torch.bfloat16)
    new0 = METRICS.counter("kernel.new_shapes").get()
    hits = METRICS.counter("kernel.shape_hits", labels={"kernel": "kx"})
    hits0 = hits.get()
    assert s.launch("kx", (a, b), 10)
    assert not s.launch("kx", (a, b), 10)
    assert not s.launch("kx", (torch.ones((4, 8)), b), 10)   # same shapes
    assert s.launch("kx", (a, b), 12)                # another k
    assert s.launch("kx", (torch.zeros((8, 8)), b), 10)     # another batch
    assert s.launch("ky", (a,))
    st = s.state()
    assert st["kx"]["calls"] == 5
    assert st["kx"]["new_shapes"] == 3
    assert st["kx"]["shape_hits"] == 2
    assert st["kx"]["signatures"]["plain:float32[4x8]_bfloat16[16x8]_10"] \
        == 3
    assert st["kx"]["last_new_shape_age_s"] is not None
    assert s.new_shapes() == 4
    assert METRICS.counter("kernel.new_shapes").get() == new0 + 4
    assert hits.get() == hits0 + 2
    assert METRICS.counter("kernel.new_shapes_by_kernel",
                           labels={"kernel": "ky"}).get() >= 1


def test_on_build_records_library_and_span():
    s = LaunchSentinel()
    builds0 = METRICS.counter("kernel.builds").get()
    TRACE_BUFFER.clear()
    s.on_build("libz", 1234.5)
    s.on_build("libz", 10.0)
    assert s.builds()["libz"] == {"builds": 2, "build_ms_total": 1244.5,
                                  "last_build_ms": 10.0}
    assert METRICS.counter("kernel.builds").get() == builds0 + 2
    assert METRICS.gauge("kernel.build_ms",
                         labels={"library": "libz"}).get() == 10.0
    spans = [r for r in TRACE_BUFFER.snapshot() if r["name"] ==
             "kernel.build"]
    TRACE_BUFFER.clear()
    # a build is recorded whatever the sampling rate (it is evidence)
    assert len(spans) == 2 and spans[0]["attrs"]["library"] == "libz"
    assert spans[0]["dur_us"] >= 1_000_000


def test_cuda_build_reports_each_library_built(tmp_path, monkeypatch):
    """ops/cuda_build.build() reports every library it compiled (here with
    a stand-in compiler that writes its -o target) and none it found
    built."""
    from dingo_tpu_torch.ops import cuda_build

    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    before = dict(SENTINEL.builds())
    paths = cuda_build.build(["fused_topk", "ivfpq_adc_lut"])
    assert all(os.path.exists(p) for p in paths.values())
    after = SENTINEL.builds()
    for lib in ("fused_topk", "ivfpq_adc_lut"):
        assert after[lib]["builds"] == before.get(lib, {}).get("builds",
                                                               0) + 1
    cuda_build.build(["fused_topk"])            # already built: no build
    assert SENTINEL.builds()["fused_topk"] == after["fused_topk"]


def _index(kind, x, precision="fp32"):
    kw = {"dimension": D}
    if kind == "flat":
        t = IndexType.FLAT
    elif kind == "ivf_flat":
        t = IndexType.IVF_FLAT
        kw.update(ncentroids=NLIST, default_nprobe=8)
    else:
        t = IndexType.IVF_PQ
        kw.update(ncentroids=NLIST, default_nprobe=8, nsubvector=8)
    idx = new_index(1, IndexParameter(index_type=t, precision=precision,
                                      **kw), device="cpu")
    idx.upsert(np.arange(len(x), dtype=np.int64), x)
    if kind != "flat":
        idx.train()
    return idx


def test_every_kernel_wrapper_reports(flags):
    """Each of the six wrappers reports its calls, on the CPU under route
    "plain": B4 and B1 (FLAT with and without the blocked mirror), B3 and
    B2 (IVF_FLAT pruned and not), B5 and the residual tables (IVF_PQ at
    rerank factor 6)."""
    x = _data()
    q = x[:4] + 0.01
    before = {k: v["calls"] for k, v in SENTINEL.state().items()}
    flags.set("ivfpq_rerank_factor", 6)
    for blocked in (True, False):
        flags.set("vector_blocked_layout", blocked)
        _index("flat", x).search(q, K)
    for prune in (True, False):
        flags.set("ivf_prune_scan", prune)
        _index("ivf_flat", x).search(q, K, nprobe=8)
    _index("ivf_pq", x).search(q, K, nprobe=8)
    st = SENTINEL.state()
    for kernel in ("pruned_fused_topk", "fused_topk", "ivf_pruned_topk",
                   "ivf_list_topk", "ivf_pq_adc_topk", "ivfpq_adc_lut"):
        assert st[kernel]["calls"] > before.get(kernel, 0), kernel
        assert all(sig.startswith("plain:")
                   for sig in st[kernel]["signatures"]), kernel


CASES = [("flat", "fp32", "pruned_fused_topk"),
         ("ivf_flat", "fp32", "ivf_pruned_topk"),
         ("ivf_flat", "bf16", "ivf_pruned_topk"),
         ("ivf_pq", "fp32", "ivf_pq_adc_topk")]


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("kind,precision,kernel", CASES)
def test_warmed_ladder_sees_no_new_shape_under_coalesced_run(
        flags, kind, precision, kernel, pipelined):
    """Warm the pow2 batch ladder 1..64 with direct searches, then serve
    4-row requests over four keys through IndexService (max_batch 64):
    the kernel is called and no new shape appears. A batch of 100 rows
    after it (padded to 128, off the ladder) is counted."""
    flags.set("ivfpq_rerank_factor", 6)
    flags.set("pipeline_enabled", pipelined)
    flags.set("vector_blocked_layout", True)     # FLAT's B4 mirror
    x = _data()
    idx = _index(kind, x, precision)
    w = VectorIndexWrapper(1, idx.parameter, device="cpu")
    w.set_own(idx)
    kw = {} if kind == "flat" else {"nprobe": 8}
    SENTINEL.reset()               # shapes of earlier tests do not count
    b = 1
    while b <= 64:
        w.search(x[:b] + 0.01, K, **kw)
        b *= 2
    new0 = SENTINEL.new_shapes()
    calls0 = SENTINEL.state()[kernel]["calls"]
    node = node_over_wrapper(w, np.arange(len(x)), x, keys=(1, 2, 3, 4))
    svc = IndexService(node, window_ms=2.0, max_batch=64)
    try:
        for rnd in range(3):
            futs = [svc.submit(1 + i % 4, x[4 * i:4 * i + 4] + 0.01, K,
                               **kw) for i in range(16 * rnd, 16 * rnd + 16)]
            for i, f in zip(range(16 * rnd, 16 * rnd + 16), futs):
                rows = f.result(timeout=60)
                assert [r[0].id for r in rows] == \
                    list(range(4 * i, 4 * i + 4))
    finally:
        svc.close()
    assert SENTINEL.state()[kernel]["calls"] > calls0
    assert SENTINEL.new_shapes() == new0
    w.search(x[:100], K, **kw)          # pads to 128: off the warm ladder
    assert SENTINEL.new_shapes() > new0
