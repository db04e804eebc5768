"""The state-integrity plane of the port (ops/digest.py, obs/integrity.py
and their hooks) against the JAX package's, case by case from
tests/test_integrity.py (the br, CLI, ReplicaGroup and pb cases stay
there): each case runs through both packages on the same seeded numpy
inputs.

Tolerance: none. Fingerprints, ``SetDigest.hex()`` and the digest vectors
of the same writes are equal bit for bit in every payload dtype (f32,
bf16 as its 16-bit patterns, sq8 codes, int8 +/-1, adjacency by external
id, IVF list assignments); a snapshot saved by either package verifies
when the other loads it, and a tampered one is refused by both."""

import json
import os

import numpy as np
import pytest
import torch

from torch_cluster_util import PKGS, Pkg

# small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

D = 32
N = 400
P = {name: Pkg(name) for name in PKGS}
J, T = P["dingo_tpu"], P["dingo_tpu_torch"]


@pytest.fixture(autouse=True)
def _integrity_on():
    """Plane on, a clean flight recorder and ledger, in both packages."""
    saved = []
    for p in P.values():
        saved.append((p, p.config.FLAGS.get("integrity_enabled")))
        p.config.FLAGS.set("integrity_enabled", True)
        p.flight.FLIGHT.clear()
        p.integrity.INTEGRITY.clear()
    yield
    for p, was in saved:
        p.config.FLAGS.set("integrity_enabled", was)
        p.integrity.INTEGRITY.clear()


@pytest.fixture(params=PKGS)
def pkg(request):
    return P[request.param]


def _flags(p, **kw):
    saved = {k: p.config.FLAGS.get(k) for k in kw}
    for k, v in kw.items():
        p.config.FLAGS.set(k, v)
    return saved


def _corpus(seed=0, n=N, d=D):
    rng = np.random.default_rng(seed)
    return (np.arange(n, dtype=np.int64),
            rng.standard_normal((n, d)).astype(np.float32))


def _param(p, kind, d=D, **kw):
    base = p.base
    kind = base.IndexType(kind)
    defaults = dict(index_type=kind, dimension=d)
    if kind in (base.IndexType.IVF_FLAT, base.IndexType.IVF_PQ,
                base.IndexType.BINARY_IVF_FLAT):
        defaults.update(ncentroids=8, default_nprobe=8)
    if kind is base.IndexType.IVF_PQ:
        defaults.update(nsubvector=8)
    defaults.update(kw)
    return base.IndexParameter(**defaults)


def _artifacts(p, idx) -> dict:
    return p.integrity.INTEGRITY.ledger(idx).report()["artifacts"]


# ---------------- the digest primitive ----------------

@pytest.mark.parametrize("dtype", ["f32", "bf16", "sq8", "pm1", "adj",
                                   "buckets", "i64"])
def test_fingerprints_and_hex_equal_the_reference(dtype):
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 1 << 40, 300)
    x = rng.standard_normal((300, 48)).astype(np.float32)
    payload = {
        "f32": x,
        # bf16 rows as their bit patterns: the port's canonical form
        "bf16": torch.from_numpy(x).to(torch.bfloat16).view(
            torch.int16).numpy().view(np.uint16),
        "sq8": rng.integers(0, 256, (300, 48), dtype=np.uint8),
        "pm1": (rng.integers(0, 2, (300, 64)) * 2 - 1).astype(np.int8),
        "adj": rng.integers(-1, 1 << 30, (300, 32)).astype(np.int64),
        "buckets": rng.integers(0, 1024, 300).astype(np.int32),
        "i64": rng.integers(-(1 << 62), 1 << 62, (300, 3)),
    }[dtype]
    for tag in ("rows", "blocked", "ivf_buckets"):
        a = J.digest.row_fingerprints(tag, ids, payload)
        b = T.digest.row_fingerprints(tag, ids, payload)
        assert a.dtype == b.dtype == np.uint64
        assert np.array_equal(a, b)
        assert J.digest.SetDigest.of(a).hex() == \
            T.digest.SetDigest.of(b).hex()


def test_bf16_canonical_bytes_equal_ml_dtypes():
    """The port's bf16 bytes (torch's round-to-nearest-even, viewed as
    int16) are the JAX package's (ml_dtypes' bfloat16 bytes)."""
    import ml_dtypes

    x = np.random.default_rng(2).standard_normal((64, 40)).astype(
        np.float32) * 1e3
    ref = x.astype(ml_dtypes.bfloat16).view(np.uint8)
    store = T.factory.new_index(
        1, _param(T, "flat", d=40, precision="bf16"), device="cpu").store
    got = store.canonical_rows(x).view(np.uint8)
    assert np.array_equal(ref, got)


def test_digest_order_invariant_and_homomorphic(pkg):
    dg = pkg.digest
    ids, x = _corpus()
    fps = dg.row_fingerprints("rows", ids, x)
    perm = np.random.default_rng(1).permutation(len(ids))
    assert dg.SetDigest.of(fps) == dg.SetDigest.of(
        dg.row_fingerprints("rows", ids[perm], x[perm]))
    d = dg.SetDigest.of(fps)
    d.remove(fps[:50])
    d.add(fps[:50])
    assert d == dg.SetDigest.of(fps)
    assert d.count == len(ids)


def test_digest_detects_flip_swap_and_separates_tags(pkg):
    dg = pkg.digest
    ids, x = _corpus()
    base = dg.SetDigest.of(dg.row_fingerprints("rows", ids, x))
    flipped = x.copy()
    flipped.view(np.uint8)[7, 13] ^= 1
    assert dg.SetDigest.of(dg.row_fingerprints("rows", ids, flipped)) != base
    swapped = x.copy()
    swapped[[3, 4]] = swapped[[4, 3]]
    assert dg.SetDigest.of(dg.row_fingerprints("rows", ids, swapped)) != base
    assert dg.SetDigest.of(dg.row_fingerprints("blocked", ids, x)) != base
    assert dg.SetDigest.from_hex(base.hex()) == base


def test_diverged_artifacts_helper(pkg):
    da = pkg.integrity.diverged_artifacts
    a = json.dumps({"rows": "1-a-b", "blocked": "1-c-d"})
    b = json.dumps({"rows": "1-a-b", "blocked": "1-x-y", "extra": "1-e-f"})
    assert da(a, b) == ["blocked"]
    assert da(a, a) == []
    assert da("", a) == []


# ---------------- incremental ledger: equal across packages -------------

def _write_sequence(p, kind, precision, blocked=False):
    saved = _flags(p, vector_blocked_layout=str(blocked))
    try:
        # the mirror needs two dimension blocks of ivf_dim_block (128)
        d = 256 if blocked else D
        ids, x = _corpus(seed=3, d=d)
        idx = p.new_index(11, _param(p, kind, d=d, precision=precision))
        idx.upsert(ids, x)
        idx.delete(ids[10:40])
        idx.upsert(ids[20:30], x[20:30] + 1.0)
        idx.upsert(ids[:5], x[:5] * 2.0)
        return idx
    finally:
        _flags(p, **saved)


@pytest.mark.parametrize("kind,precision,blocked", [
    ("flat", "fp32", False),
    ("flat", "fp32", True),
    ("flat", "bf16", False),
    ("flat", "sq8", False),
    ("ivf_flat", "fp32", False),
    ("hnsw", "fp32", False),
    ("ivf_pq", "fp32", False),
])
def test_ledger_digests_equal_the_reference(kind, precision, blocked):
    """The same writes fold into the same digest vector in both packages
    (before training: row, blocked and code payloads)."""
    got = {}
    for name, p in P.items():
        idx = _write_sequence(p, kind, precision, blocked)
        got[name] = _artifacts(p, idx)
    assert got["dingo_tpu"] == got["dingo_tpu_torch"]
    assert "rows" in got["dingo_tpu_torch"]
    assert ("blocked" in got["dingo_tpu_torch"]) == blocked


def test_binary_flat_ledger_equals_reference_and_scrub():
    rng = np.random.default_rng(5)
    packed = rng.integers(0, 256, size=(N, D // 8), dtype=np.uint8)
    ids = np.arange(N, dtype=np.int64)
    got = {}
    for name, p in P.items():
        idx = p.new_index(12, _param(p, "binary_flat"))
        idx.upsert(ids, packed)
        idx.delete(ids[:17])
        res = p.integrity.INTEGRITY.scrub_index(idx)
        assert res["rows"]["status"] == "ok"
        got[name] = _artifacts(p, idx)
    assert got["dingo_tpu"] == got["dingo_tpu_torch"]


@pytest.mark.parametrize("kind,precision", [
    ("flat", "fp32"), ("flat", "bf16"), ("flat", "sq8"),
    ("ivf_flat", "fp32"), ("ivf_flat", "sq8"), ("hnsw", "fp32"),
    ("ivf_pq", "fp32"),
])
def test_incremental_ledger_matches_scrub(pkg, kind, precision):
    """Writes, deletes and overwrites maintained incrementally agree with
    a from-scratch device-state recompute, trained indexes included."""
    ids, x = _corpus(seed=3)
    idx = pkg.new_index(11, _param(pkg, kind, precision=precision))
    idx.upsert(ids, x)
    if idx.need_train():
        idx.train()
        idx.search(x[:4], 5)
    idx.delete(ids[10:40])
    idx.upsert(ids[20:30], x[20:30] + 1.0)
    idx.upsert(ids[:5], x[:5] * 2.0)
    if kind == "ivf_flat":
        idx.search(x[:4], 5)
    res = pkg.integrity.INTEGRITY.scrub_index(idx)
    assert res
    for artifact, r in res.items():
        assert r["status"] == "ok", (artifact, r)
    if kind in ("ivf_flat", "ivf_pq"):
        assert "ivf_buckets" in res
    if kind == "ivf_pq":
        assert "pq_codes" in res
    if pkg.torch:
        # the port's cost keys: seconds, bytes read back, lock hold
        assert res["rows"]["d2h_bytes"] > 0
        assert res["rows"]["max_lock_ms"] >= 0.0


def test_disabled_plane_is_inert(pkg):
    pkg.config.FLAGS.set("integrity_enabled", False)
    ids, x = _corpus()
    idx = pkg.new_index(13, _param(pkg, "flat"))
    idx.upsert(ids, x)
    assert pkg.integrity.INTEGRITY.peek(idx) is None
    _applied, digests, mismatch = \
        pkg.integrity.INTEGRITY.region_report(idx)
    assert digests == "" and not mismatch


# ---------------- one flipped byte per artifact ----------------

def _corrupt(p, holder, attr, mutate, store):
    """Silent device corruption: read the array back, flip it on the
    host, put it back whole."""
    arr = p.host(getattr(holder, attr))
    mutate(arr)
    with store.device_lock:
        setattr(holder, attr, p.device_like(arr, getattr(holder, attr)))


def _assert_detected(p, idx, artifact, results):
    assert results[artifact]["status"] == "mismatch", results
    mm = p.metrics.METRICS.counter(
        "consistency.scrub_mismatches", region_id=idx.id,
        labels={"artifact": artifact})
    assert mm.get() >= 1
    metas = p.flight.FLIGHT.bundles_meta()
    assert any(m["reason"] == "corruption" for m in metas), metas


def test_scrub_detects_flipped_row_byte(pkg):
    ids, x = _corpus()
    idx = pkg.new_index(21, _param(pkg, "flat"))
    idx.upsert(ids, x)
    slot = int(idx.store.slots_of(ids[:1])[0])
    _corrupt(pkg, idx.store, "vecs", lambda a: a.view(np.uint8).__setitem__(
        (slot, 3), a.view(np.uint8)[slot, 3] ^ 1), idx.store)
    res = pkg.integrity.INTEGRITY.scrub_index(idx)
    _assert_detected(pkg, idx, "rows", res)
    bundle = pkg.flight.FLIGHT.get_json()
    assert bundle["reason"] == "corruption"
    arts = bundle["trigger"]["artifacts"]["rows"]
    assert arts["expected"] != arts["actual"]


def test_scrub_detects_flipped_sq8_code(pkg):
    ids, x = _corpus(seed=7)
    idx = pkg.new_index(22, _param(pkg, "flat", precision="sq8"))
    idx.upsert(ids, x)
    slot = int(idx.store.slots_of(ids[5:6])[0])
    _corrupt(pkg, idx.store, "vecs",
             lambda a: a.__setitem__((slot, 2), a[slot, 2] ^ 1), idx.store)
    res = pkg.integrity.INTEGRITY.scrub_index(idx)
    assert res["rows"]["status"] == "mismatch"


def test_scrub_detects_flipped_blocked_mirror_entry(pkg):
    saved = _flags(pkg, vector_blocked_layout="True")
    try:
        ids, x = _corpus(seed=8, d=256)
        idx = pkg.new_index(23, _param(pkg, "flat", d=256))
        assert idx.store.vecs_blk is not None
        idx.upsert(ids, x)
        res = pkg.integrity.INTEGRITY.scrub_index(idx)
        assert res["blocked"]["status"] == "ok"
        slot = int(idx.store.slots_of(ids[3:4])[0])
        _corrupt(pkg, idx.store, "vecs_blk",
                 lambda a: a.view(np.uint8).__setitem__(
                     (1, slot, 5), a.view(np.uint8)[1, slot, 5] ^ 1),
                 idx.store)
        res = pkg.integrity.INTEGRITY.scrub_index(idx)
        assert res["rows"]["status"] == "ok"
        _assert_detected(pkg, idx, "blocked", res)
    finally:
        _flags(pkg, **saved)


def test_scrub_detects_flipped_adjacency_entry(pkg):
    saved = _flags(pkg, hnsw_device_search="True")
    try:
        ids, x = _corpus(seed=9)
        idx = pkg.new_index(24, _param(pkg, "hnsw"))
        idx.upsert(ids, x)
        idx.search(x[:2], 5)
        assert idx.adjacency_in_sync()
        res = pkg.integrity.INTEGRITY.scrub_index(idx)
        assert res["adjacency"]["status"] == "ok"
        slots = idx.store.slots_of(ids[:2])
        _corrupt(pkg, idx.store, "adj",
                 lambda a: a.__setitem__((int(slots[0]), 0), int(slots[1])),
                 idx.store)
        res = pkg.integrity.INTEGRITY.scrub_index(idx)
        _assert_detected(pkg, idx, "adjacency", res)
    finally:
        _flags(pkg, **saved)


def test_scrub_detects_flipped_ivf_bucket_entry(pkg):
    ids, x = _corpus(seed=10)
    idx = pkg.new_index(25, _param(pkg, "ivf_flat"))
    idx.upsert(ids, x)
    idx.train()
    idx.search(x[:2], 5)
    res = pkg.integrity.INTEGRITY.scrub_index(idx)
    assert res["ivf_buckets"]["status"] == "ok"
    view = idx._view
    bs = pkg.host(view.bucket_slot)
    valid = np.argwhere(bs >= 0)
    b, r = valid[0]
    bs[b, r] = bs[tuple(valid[-1])]
    with idx.store.device_lock:
        view.bucket_slot = pkg.device_like(bs, view.bucket_slot)
    res = pkg.integrity.INTEGRITY.scrub_index(idx)
    _assert_detected(pkg, idx, "ivf_buckets", res)


def test_scrub_detects_flipped_pq_code(pkg):
    ids, x = _corpus(seed=11)
    idx = pkg.new_index(26, _param(pkg, "ivf_pq"))
    idx.upsert(ids, x)
    idx.train()
    res = pkg.integrity.INTEGRITY.scrub_index(idx)
    assert res["pq_codes"]["status"] == "ok"
    slot = int(idx.store.slots_of(ids[:1])[0])
    _corrupt(pkg, idx, "_codes",
             lambda a: a.__setitem__((slot, 0), a[slot, 0] ^ 1), idx.store)
    res = pkg.integrity.INTEGRITY.scrub_index(idx)
    _assert_detected(pkg, idx, "pq_codes", res)


def test_scrub_detection_within_one_interval_and_recovery(pkg):
    integ = pkg.integrity.INTEGRITY
    ids, x = _corpus(seed=12)
    idx = pkg.new_index(27, _param(pkg, "flat"))
    idx.upsert(ids, x)
    integ.scrub_index(idx)
    assert not integ.region_report(idx)[2]
    slot = int(idx.store.slots_of(ids[:1])[0])
    _corrupt(pkg, idx.store, "vecs", lambda a: a.view(np.uint8).__setitem__(
        (slot, 0), a.view(np.uint8)[slot, 0] ^ 1), idx.store)
    integ.scrub_index(idx)
    assert integ.region_report(idx)[2] is True
    idx.upsert(ids[:1], x[:1])
    integ.scrub_index(idx)
    assert integ.region_report(idx)[2] is False


# ---------------- snapshots, across packages ----------------

_SNAP_CASES = [("flat", "fp32"), ("flat", "bf16"), ("flat", "sq8"),
               ("ivf_flat", "fp32"), ("ivf_flat", "sq8"), ("hnsw", "fp32")]


@pytest.mark.parametrize("kind,precision", _SNAP_CASES)
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_snapshot_verifies_across_packages(tmp_path, kind, precision,
                                           direction):
    """A snapshot carries its digest vector; the other package recomputes
    the same digests from the state it restored."""
    src, dst = (J, T) if direction == "jax_to_torch" else (T, J)
    ids, x = _corpus(seed=13)
    idx = src.new_index(31, _param(src, kind, precision=precision))
    idx.upsert(ids, x)
    if idx.need_train():
        idx.train()
    path = str(tmp_path / "snap")
    idx.save(path)
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert meta.get("integrity", {}).get("rows"), meta
    fresh = dst.new_index(31, _param(dst, kind, precision=precision))
    fresh.load(path)                      # verification passes
    assert fresh.get_count() == len(ids)
    got = _artifacts(dst, fresh)
    for art, hexd in meta["integrity"].items():
        assert got[art] == hexd, art


@pytest.mark.parametrize("kind,precision,npz,field", [
    ("flat", "fp32", "flat.npz", "vectors"),
    ("flat", "sq8", "flat.npz", "codes"),
    ("ivf_flat", "fp32", "ivf_flat.npz", "vectors"),
    ("hnsw", "fp32", "hnsw_vectors.npz", "vectors"),
])
def test_tampered_snapshot_refused_by_both(tmp_path, kind, precision, npz,
                                           field):
    ids, x = _corpus(seed=14)
    idx = T.new_index(32, _param(T, kind, precision=precision))
    idx.upsert(ids, x)
    if idx.need_train():
        idx.train()
    path = str(tmp_path / "snap")
    idx.save(path)
    data = dict(np.load(os.path.join(path, npz)))
    data[field].view(np.uint8)[1, 0] ^= 1
    np.savez(os.path.join(path, npz), **data)
    for p in P.values():
        fresh = p.new_index(32, _param(p, kind, precision=precision))
        with pytest.raises(p.base.SnapshotCorruption):
            fresh.load(path)
        assert p.metrics.METRICS.counter(
            "consistency.restore_mismatches", region_id=32).get() >= 1


def test_manager_rebuilds_on_corrupt_snapshot(tmp_path, pkg):
    """load_index returns False on SnapshotCorruption, which is the
    rebuild-from-engine path; the rebuilt index serves the engine's rows."""
    wrapper_m = pkg.wrapper
    param = _param(pkg, "flat")
    ids, x = _corpus(seed=16)
    idx = pkg.new_index(34, param)
    idx.upsert(ids, x)
    mgr = pkg.manager.VectorIndexManager(pkg.raw.MemEngine(),
                                         snapshot_root=str(tmp_path),
                                         **pkg.kw)
    path = mgr.snapshot_path(34)
    idx.save(path)
    data = dict(np.load(os.path.join(path, "flat.npz")))
    data["vectors"].view(np.uint8)[0, 0] ^= 1
    np.savez(os.path.join(path, "flat.npz"), **data)
    definition = pkg.regm.RegionDefinition(
        region_id=34, start_key=b"", end_key=b"",
        region_type=pkg.regm.RegionType.INDEX, index_parameter=param)
    region = pkg.regm.Region(definition, **pkg.kw)
    region.vector_index_wrapper = wrapper_m.VectorIndexWrapper(
        34, param, **pkg.kw)
    assert mgr.load_index(region) is False


# ---------------- the wrapper, the scrub runner, races ----------------

def test_wrapper_tags_applied_index(pkg):
    param = _param(pkg, "flat")
    w = pkg.wrapper.VectorIndexWrapper(41, param, **pkg.kw)
    w.build_own()
    w.ready = True
    ids, x = _corpus(seed=17, n=20)
    w.add(ids, x, log_id=7)
    applied, digests, _ = pkg.integrity.INTEGRITY.region_report(
        w.own_index)
    assert applied == 7 and "rows" in json.loads(digests)
    w.delete(ids[:3], log_id=9)
    assert pkg.integrity.INTEGRITY.region_report(w.own_index)[0] == 9


def test_wrapper_digest_vectors_equal_the_reference():
    got = {}
    for name, p in P.items():
        w = p.wrapper.VectorIndexWrapper(42, _param(p, "flat"), **p.kw)
        w.build_own()
        w.ready = True
        ids, x = _corpus(seed=18, n=64)
        w.add(ids, x, log_id=3)
        w.delete(ids[:5], log_id=4)
        got[name] = p.integrity.INTEGRITY.region_report(w.own_index)[:2]
    assert got["dingo_tpu"] == got["dingo_tpu_torch"]


def test_scrub_marks_inflight_write_as_raced(pkg):
    integ = pkg.integrity.INTEGRITY
    ids, x = _corpus(seed=19)
    idx = pkg.new_index(43, _param(pkg, "flat"))
    idx.upsert(ids, x)
    integ.note_mutation_begin(idx)      # a write touching device state
    try:
        res = integ.scrub_index(idx)
        assert res["rows"]["status"] == "raced"
        # the heartbeat withholds the digest vector mid-write
        assert integ.region_report(idx)[1] == ""
    finally:
        integ.note_mutation_end(idx)
    res = integ.scrub_index(idx)
    assert res["rows"]["status"] == "ok"


def test_ledger_survives_enabled_toggle(pkg):
    integ = pkg.integrity.INTEGRITY
    ids, x = _corpus(seed=20)
    idx = pkg.new_index(44, _param(pkg, "flat"))
    idx.upsert(ids[:200], x[:200])
    pkg.config.FLAGS.set("integrity_enabled", False)
    idx.upsert(ids[200:], x[200:])      # an existing ledger keeps folding
    pkg.config.FLAGS.set("integrity_enabled", True)
    assert integ.scrub_index(idx)["rows"]["status"] == "ok"


def test_adjacency_excluded_from_heartbeat_vector(pkg):
    saved = _flags(pkg, hnsw_device_search="True")
    try:
        ids, x = _corpus(seed=21)
        idx = pkg.new_index(45, _param(pkg, "hnsw"))
        idx.upsert(ids, x)
        idx.search(x[:2], 5)
        assert "adjacency" in _artifacts(pkg, idx)
        _a, digests, _m = pkg.integrity.INTEGRITY.region_report(idx)
        assert "adjacency" not in json.loads(digests)
    finally:
        _flags(pkg, **saved)


# ---------------- the scrub on a node, the corruption rebuild ----------

def _node_with_region(p, rid=5, dim=D):
    """A single-replica StoreNode (no coordinator) hosting one FLAT
    region, as test_torch_recovery.py builds it."""
    import time

    n = p.node.StoreNode("s0", p.raft.LocalTransport(), None,
                         raft_kw={"seed": 0}, **p.kw)
    r = p.regm
    region = n.create_region(r.RegionDefinition(
        region_id=rid, start_key=p.vcodec.encode_vector_key(0, 0),
        end_key=p.vcodec.encode_vector_key(0, 1 << 40), partition_id=0,
        peers=["s0"], region_type=r.RegionType.INDEX,
        index_parameter=_param(p, "flat", d=dim)))
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        rn = n.engine.get_node(rid)
        if rn is not None and rn.is_leader():
            break
        time.sleep(0.02)
    assert n.engine.get_node(rid).is_leader()
    return n, region


def test_scrub_node_and_rebuild_corrupted_region():
    """The scrub flags a flipped row byte, the recovery plane's
    _rebuild_corrupted rebuilds the region from the engine, and a clean
    pass over the rebuilt index clears the flag; the replies are the
    exact answer again, in both packages."""
    ids, x = _corpus(seed=22, n=64)
    replies = {}
    for name, p in P.items():
        integ = p.integrity.INTEGRITY
        p.recovery.RECOVERY.clear()
        n, region = _node_with_region(p)
        try:
            n.storage.vector_add(region, ids, x)
            assert integ.scrub_node(n)[region.id]["rows"]["status"] == "ok"
            idx = region.vector_index_wrapper.own_index
            slot = int(idx.store.slots_of(ids[7:8])[0])
            _corrupt(p, idx.store, "vecs", lambda a: a.__setitem__(
                (slot, 0), a[slot, 0] + 100.0), idx.store)
            res = integ.scrub_node(n)
            assert res[region.id]["rows"]["status"] == "mismatch"
            assert integ.region_report(None, region.id)[2] is True
            assert p.recovery.RECOVERY._rebuild_corrupted(n) == 1
            assert integ.region_report(None, region.id)[2] is False
            res = integ.scrub_node(n)
            assert res[region.id]["rows"]["status"] == "ok"
            got = n.storage.vector_batch_search(region, x[:8], 3)
            replies[name] = [[v.id for v in row] for row in got]
        finally:
            n.stop()
    assert replies["dingo_tpu"] == replies["dingo_tpu_torch"]
    assert [r[0] for r in replies["dingo_tpu_torch"]] == list(range(8))


def test_coordinator_divergence_detect_flag_and_clear(pkg):
    """diverged_regions: replicas whose digest vectors differ at equal
    applied indices are flagged (with a flight bundle naming the
    artifact), a lagging replica is not, and re-convergence clears it."""
    S, R = pkg.snapshot.StoreMetricsSnapshot, pkg.snapshot.RegionMetricsSnapshot
    coord = pkg.coordinator(replication=2)
    coord.register_store("s0")
    coord.register_store("s1")
    good = json.dumps({"rows": "64-aaaa-bbbb", "blocked": "64-cc-dd"})
    bad = json.dumps({"rows": "64-aaaa-bbbb", "blocked": "64-ee-ff"})

    def beat(sid, applied, digests):
        coord.store_heartbeat(sid, metrics=S(sid, regions=[R(
            9, integrity_applied_index=applied,
            integrity_digests=digests)]))

    beat("s0", 5, good)
    assert coord.diverged_regions() == []
    beat("s1", 5, bad)
    assert coord.diverged_regions() == [9]
    assert pkg.metrics.METRICS.gauge(
        "consistency.diverged_regions").get() == 1.0
    bundle = pkg.flight.FLIGHT.get_json()
    assert bundle["reason"] == "divergence"
    assert bundle["trigger"]["peers"][0]["artifacts"] == ["blocked"]
    beat("s1", 6, bad)                 # lagging: not evidence
    beat("s1", 5, good)
    beat("s0", 5, good)
    assert coord.diverged_regions() == []
