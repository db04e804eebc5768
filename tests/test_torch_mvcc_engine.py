"""The port's MVCC layer and raw engines against the JAX package's: the
codec's keys and values are byte-equal, Reader/Writer visibility at a ts
and the MemEngine/WalEngine checkpoint and recovery cases of
test_mvcc_engine.py and test_wal_rotation.py run through both packages,
and a WAL or checkpoint written by the JAX package's WalEngine recovers in
the port's."""

import importlib
import os
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

PKGS = ("dingo_tpu", "dingo_tpu_torch")


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def codec(pkg):
    m = mod(pkg, "mvcc.codec")
    return m.Codec, m.ValueFlag


def engines(pkg):
    return mod(pkg, "engine.raw_engine")


def mvcc(pkg):
    return mod(pkg, "mvcc.reader")


# ---------------- codec: byte-equal across packages ------------------------

KEYS = [b"", b"a", b"12345678", b"123456789", b"\x00\xff" * 9,
        b"abcdefgh\x00", bytes(range(40))]


@pytest.mark.parametrize("key", KEYS, ids=range(len(KEYS)))
def test_codec_keys_byte_equal(key):
    (jc, _), (tc, _) = codec("dingo_tpu"), codec("dingo_tpu_torch")
    enc = tc.encode_bytes(key)
    assert enc == jc.encode_bytes(key)
    assert tc.decode_bytes(enc) == (key, len(enc))
    for ts in (0, 1, 10, 2**40, 2**63 - 1):
        k = tc.encode_key(key, ts)
        assert k == jc.encode_key(key, ts)
        assert tc.decode_key(k) == (key, ts)


def test_codec_values_byte_equal():
    (jc, jf), (tc, tf) = codec("dingo_tpu"), codec("dingo_tpu_torch")
    for value, flag, ttl in ((b"hello", "PUT", 0), (b"x", "PUT_TTL", 12345),
                             (b"", "DELETE", 0)):
        tv = tc.package_value(value, getattr(tf, flag), ttl)
        assert tv == jc.package_value(value, getattr(jf, flag), ttl)
        got = tc.unpackage_value(tv)
        assert got[0] is getattr(tf, flag) and got[1] == value
    assert tf.PUT.value == jf.PUT.value


@pytest.mark.parametrize("pkg", PKGS)
def test_encode_bytes_order_preserving(pkg):
    c, _ = codec(pkg)
    keys = [b"", b"a", b"aa", b"ab", b"b", b"abcdefgh", b"abcdefgh\x00",
            b"abcdefghi"]
    encs = [c.encode_bytes(k) for k in keys]
    assert sorted(encs) == [c.encode_bytes(k) for k in sorted(keys)]
    assert c.encode_key(b"k", 20) < c.encode_key(b"k", 10)


@pytest.mark.parametrize("pkg", PKGS)
def test_ts_provider(pkg):
    ts = mod(pkg, "mvcc.ts_provider")
    tp = ts.TsProvider(batch_size=4)
    seen = [tp.get_ts() for _ in range(100)]
    assert all(b > a for a, b in zip(seen, seen[1:]))
    first, count = ts.LocalTsOracle().generate(10)
    phys, _ = ts.decompose_ts(first)
    assert abs(phys - time.time() * 1000) < 5000 and count == 10


# ---------------- sorted kv / engines ----------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_sorted_kv_and_batch(pkg):
    e = engines(pkg)
    kv = e.SortedKv()
    for i in (3, 1, 2, 9, 5):
        kv.put(f"k{i}".encode(), f"v{i}".encode())
    assert [k for k, _ in kv.scan(b"k2", b"k5")] == [b"k2", b"k3"]
    assert [k for k, _ in kv.scan_reverse(b"k2", b"k9")] == \
        [b"k5", b"k3", b"k2"]
    assert kv.delete_range(b"k1", b"k3") == 2
    assert len(kv) == 3
    eng = e.MemEngine()
    eng.write(e.WriteBatch().put(e.CF_DEFAULT, b"a", b"1")
              .put("lock", b"a", b"L").delete(e.CF_DEFAULT, b"missing"))
    assert eng.get(e.CF_DEFAULT, b"a") == b"1"
    assert eng.get("lock", b"a") == b"L"


@pytest.mark.parametrize("pkg", PKGS)
def test_wal_engine_recovery_and_checkpoint(pkg, tmp_path):
    e = engines(pkg)
    path = str(tmp_path / "eng")
    eng = e.WalEngine(path)
    eng.put(e.CF_DEFAULT, b"k1", b"v1")
    eng.put(e.CF_DEFAULT, b"k2", b"v2")
    eng.delete(e.CF_DEFAULT, b"k1")
    for i in range(100):
        eng.put(e.CF_DEFAULT, f"c{i}".encode(), b"v")
    eng.checkpoint()
    assert os.path.getsize(os.path.join(path, "wal.log")) == 0
    eng.put(e.CF_DEFAULT, b"post", b"1")
    eng.close()
    eng2 = e.WalEngine(path)
    assert eng2.get(e.CF_DEFAULT, b"k1") is None
    assert eng2.get(e.CF_DEFAULT, b"k2") == b"v2"
    assert eng2.get(e.CF_DEFAULT, b"c50") == b"v"
    assert eng2.get(e.CF_DEFAULT, b"post") == b"1"
    eng2.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_wal_rotates_and_torn_tail_recovers(pkg, tmp_path):
    e = engines(pkg)
    eng = e.WalEngine(str(tmp_path / "a"), checkpoint_threshold_bytes=4096)
    for i in range(64):
        eng.write(e.WriteBatch().put(e.CF_DEFAULT, f"k{i:04d}".encode(),
                                     b"x" * 512))
    assert os.path.getsize(tmp_path / "a" / "wal.log") < 8 * 1024
    eng.close()
    eng2 = e.WalEngine(str(tmp_path / "a"), checkpoint_threshold_bytes=4096)
    assert all(eng2.get(e.CF_DEFAULT, f"k{i:04d}".encode()) == b"x" * 512
               for i in range(64))
    eng2.close()
    eng = e.WalEngine(str(tmp_path / "b"), checkpoint_threshold_bytes=1 << 30)
    for i in range(10):
        eng.put(e.CF_DEFAULT, f"k{i}".encode(), b"v")
    eng.close()
    wal = tmp_path / "b" / "wal.log"
    wal.write_bytes(wal.read_bytes()[:-7])
    eng2 = e.WalEngine(str(tmp_path / "b"))
    assert eng2.get(e.CF_DEFAULT, b"k8") == b"v"
    assert eng2.get(e.CF_DEFAULT, b"k9") is None
    eng2.put(e.CF_DEFAULT, b"new", b"acked")
    eng2.close()
    eng3 = e.WalEngine(str(tmp_path / "b"))
    assert eng3.get(e.CF_DEFAULT, b"new") == b"acked"
    eng3.close()


def _fill(pkg, eng):
    e = engines(pkg)
    w = mvcc(pkg).Writer(eng, e.CF_DEFAULT)
    rng = np.random.default_rng(4)
    for i in range(200):
        w.kv_put(f"k{i:03d}".encode(), rng.bytes(24), ts=10 + i)
    for i in range(0, 200, 7):
        w.kv_delete(f"k{i:03d}".encode(), ts=500 + i)
    eng.write(e.WriteBatch().put(e.CF_META, b"meta", b"m")
              .delete_range(e.CF_DEFAULT, b"z", None))


def test_wal_written_by_jax_package_recovers_in_port(tmp_path):
    """The same writes give byte-equal WAL and checkpoint files in both
    packages, and the port's WalEngine recovers the JAX package's."""
    paths = {}
    for pkg in PKGS:
        e = engines(pkg)
        p = str(tmp_path / pkg)
        eng = e.WalEngine(p, checkpoint_threshold_bytes=1 << 30)
        _fill(pkg, eng)
        eng.close()
        paths[pkg] = p
    wal = {pkg: open(os.path.join(p, "wal.log"), "rb").read()
           for pkg, p in paths.items()}
    assert wal["dingo_tpu"] == wal["dingo_tpu_torch"]
    te = engines("dingo_tpu_torch")
    eng = te.WalEngine(paths["dingo_tpu"])
    ref = engines("dingo_tpu").WalEngine(paths["dingo_tpu"] + "_ref")
    _fill("dingo_tpu", ref)
    for cf in ("default", "meta"):
        assert eng.scan(cf, b"", None) == ref.scan(cf, b"", None)
    # a checkpoint written by the JAX package recovers in the port too
    ref.checkpoint()
    ref.close()
    eng.close()
    eng2 = te.WalEngine(paths["dingo_tpu"] + "_ref")
    assert eng2.get("meta", b"meta") == b"m"
    r = mvcc("dingo_tpu_torch").Reader(eng2, te.CF_DEFAULT)
    assert r.kv_count(b"k", b"l", 10**6) == 200 - len(range(0, 200, 7))
    eng2.close()


def test_mem_engine_snapshot_state_equal():
    states = {}
    for pkg in PKGS:
        eng = engines(pkg).MemEngine()
        _fill(pkg, eng)
        states[pkg] = eng.snapshot_state()
    assert states["dingo_tpu"] == states["dingo_tpu_torch"]
    eng = engines("dingo_tpu_torch").MemEngine()
    eng.load_state(states["dingo_tpu"])
    assert eng.snapshot_state() == states["dingo_tpu"]


# ---------------- mvcc reader/writer -----------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_mvcc_visibility_and_ttl(pkg):
    e, m = engines(pkg), mvcc(pkg)
    eng = e.MemEngine()
    w, r = m.Writer(eng, e.CF_DEFAULT), m.Reader(eng, e.CF_DEFAULT)
    w.kv_put(b"k", b"v1", ts=10)
    w.kv_put(b"k", b"v2", ts=20)
    assert r.kv_get(b"k", 15) == b"v1"
    assert r.kv_get(b"k", 25) == b"v2"
    assert r.kv_get(b"k", 5) is None
    w.kv_delete(b"k", ts=30)
    assert r.kv_get(b"k", 35) is None
    assert r.kv_get(b"k", 25) == b"v2"
    past = int(time.time() * 1000) - 1000
    future = int(time.time() * 1000) + 60_000
    w.kv_put(b"dead", b"x", ts=1, ttl_ms=past)
    w.kv_put(b"alive", b"y", ts=1, ttl_ms=future)
    assert r.kv_get(b"dead", 10) is None
    assert r.kv_get(b"alive", 10) == b"y"


@pytest.mark.parametrize("pkg", PKGS)
def test_mvcc_scan_versions_deletes_limit(pkg):
    e, m = engines(pkg), mvcc(pkg)
    eng = e.MemEngine()
    w, r = m.Writer(eng, e.CF_DEFAULT), m.Reader(eng, e.CF_DEFAULT)
    for i in range(5):
        key = f"k{i}".encode()
        w.kv_put(key, b"old", ts=10)
        w.kv_put(key, f"new{i}".encode(), ts=20)
    w.kv_delete(b"k2", ts=25)
    got = r.kv_scan(b"k0", b"k9", ts=30)
    assert [k for k, _ in got] == [b"k0", b"k1", b"k3", b"k4"]
    assert dict(got)[b"k3"] == b"new3"
    got15 = r.kv_scan(b"k0", b"k9", ts=15)
    assert all(v == b"old" for _, v in got15) and len(got15) == 5
    assert len(r.kv_scan(b"k0", b"k9", ts=30, limit=3)) == 3
    assert r.kv_count(b"k0", b"k99", ts=30) == 4


def test_reader_visibility_equal_across_packages():
    """The same versioned writes read the same at every ts in both."""
    out = {}
    for pkg in PKGS:
        eng = engines(pkg).MemEngine()
        _fill(pkg, eng)
        r = mvcc(pkg).Reader(eng, engines(pkg).CF_DEFAULT)
        out[pkg] = [r.kv_scan(b"k", b"l", ts) for ts in (5, 50, 300, 600)]
        out[pkg].append(r.kv_batch_get([b"k007", b"k008", b"nope"], 10**6))
    assert out["dingo_tpu"] == out["dingo_tpu_torch"]
