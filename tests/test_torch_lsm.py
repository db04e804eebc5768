"""The port's native LSM engine (csrc/host/lsm.cc, a copy of the JAX
package's native/lsm/lsm.cc, behind engine/lsm_engine.py's LsmRawEngine)
against the JAX package's.

test_lsm_engine.py's cases run through the port (its imports from the JAX
package taken from the port), all but the 1M-key measurement, which stays
out of tier-1. Then a seeded script of batches, deletes, range deletes,
flushes, compactions and a checkpoint goes into both packages' engines in
two directories: the scans of every CF are equal, and since the source and
the g++ flags are the same, so is every SST, index and WAL file, byte for
byte. Last, the store node's restart on the native engine through the
port (test_store_node_on_lsm) and the server's engine choice.
"""

import importlib
import os
import random
import types

import numpy as np
import pytest
import torch

from test_torch_coprocessor import port_cases, port_on_cpu

torch.set_num_threads(1)

PKGS = ("dingo_tpu", "dingo_tpu_torch")
LSM = port_cases("test_lsm_engine.py")
#: test_scale_1m_keys is a manual 1M-key measurement (skipped in its own
#: file unless DINGO_LSM_SCALE is set): not a tier-1 case
CASES = sorted(n for n in dir(LSM) if n.startswith("test_")
               and n != "test_scale_1m_keys")


def test_case_list():
    assert LSM.LsmRawEngine.__module__ == "dingo_tpu_torch.engine.lsm_engine"
    assert len(CASES) == 16, CASES


@pytest.mark.parametrize("case", CASES)
def test_lsm_cases_through_the_port(case, tmp_path, monkeypatch):
    port_on_cpu(monkeypatch)
    fn = getattr(LSM, case)
    args = fn.__code__.co_varnames[:fn.__code__.co_argcount]
    if args == ("eng",):          # the module's `eng` fixture
        e = LSM.LsmRawEngine(str(tmp_path / "db"), memtable_bytes=1 << 20)
        try:
            fn(e)
        finally:
            e.close()
        return
    kw = {a: {"tmp_path": tmp_path, "monkeypatch": monkeypatch}[a]
          for a in args}
    fn(**kw)


def drive(eng, WriteBatch, seed=13):
    """A seeded script of writes over three CFs; returns nothing, leaves
    state in `eng` (flushed, compacted, one memtable of writes open)."""
    rng = random.Random(seed)
    cfs = ("default", "vector_scalar", "lock")
    for step in range(60):
        b = WriteBatch()
        for _ in range(rng.randrange(1, 40)):
            cf = rng.choice(cfs)
            k = b"key%05d" % rng.randrange(2000)
            if rng.random() < 0.15:
                b.delete(cf, k)
            else:
                b.put(cf, k, bytes(rng.randrange(256)
                                    for _ in range(rng.randrange(0, 300))))
        eng.write(b)
        if step % 7 == 3:
            lo = rng.randrange(2000)
            eng.delete_range(rng.choice(cfs), b"key%05d" % lo,
                             b"key%05d" % (lo + rng.randrange(1, 50)))
        if step % 11 == 5:
            eng.flush()
        if step == 40:
            eng.compact()
    b = WriteBatch()
    b.delete_range("default", b"key00100", b"key00200")
    b.put("default", b"key00150", b"back")
    eng.write(b)                  # a range delete mixed into a batch
    eng.put("default", b"open", b"memtable")


def files(path):
    out = {}
    for root, _, names in os.walk(path):
        for n in names:
            rel = os.path.relpath(os.path.join(root, n), path)
            with open(os.path.join(root, n), "rb") as f:
                out[rel] = f.read()
    return out


def test_same_operations_give_equal_scans_and_files(tmp_path):
    got = {}
    for name in PKGS:
        m = importlib.import_module(f"{name}.engine.lsm_engine")
        raw = importlib.import_module(f"{name}.engine.raw_engine")
        path = str(tmp_path / name)
        e = m.LsmRawEngine(path, memtable_bytes=1 << 14, sync_writes=False)
        drive(e, raw.WriteBatch)
        scans = {cf: e.scan(cf) for cf in raw.ALL_CFS}
        rev = e.scan_reverse("default", b"key00300", b"key00900")
        counts = (e.sst_counts(), e.index_bytes(),
                  e.count("default", b"key00500", b"key01500"))
        e.checkpoint(str(tmp_path / f"{name}_ckpt"))
        e.close()
        reopened = m.LsmRawEngine(path, memtable_bytes=1 << 14)
        again = {cf: reopened.scan(cf) for cf in raw.ALL_CFS}
        reopened.close()
        got[name] = types.SimpleNamespace(
            scans=scans, rev=rev, counts=counts, again=again,
            files=files(path), ckpt=files(str(tmp_path / f"{name}_ckpt")))
    ref, port = got["dingo_tpu"], got["dingo_tpu_torch"]
    assert port.scans == ref.scans and port.rev == ref.rev
    assert port.counts == ref.counts
    assert port.again == port.scans == ref.again
    assert sum(len(v) for v in port.scans.values()) > 500
    assert port.scans["default"][0][0] <= port.scans["default"][-1][0]
    # one source, one set of flags: the same files, byte for byte
    assert sorted(port.files) == sorted(ref.files)
    diff = [n for n in port.files if port.files[n] != ref.files[n]]
    assert not diff, f"files differ between the packages: {diff}"
    assert port.ckpt == ref.ckpt and port.ckpt


def test_make_engine_choices(tmp_path):
    from dingo_tpu.server.main import _make_engine as ref_make
    from dingo_tpu_torch.server.main import _make_engine

    for engine in ("mem", "wal", "lsm"):
        for data_dir in ("", str(tmp_path / engine)):
            args = types.SimpleNamespace(engine=engine, data_dir=data_dir)
            e = _make_engine(args)
            want = type(ref_make(types.SimpleNamespace(
                engine=engine, data_dir=data_dir and data_dir + "_ref")))
            assert type(e).__name__ == want.__name__
            assert type(e).__module__.startswith("dingo_tpu_torch.")
            if hasattr(e, "close"):
                e.close()
    assert type(_make_engine(types.SimpleNamespace(
        data_dir=str(tmp_path / "default")))).__name__ == "WalEngine"


def test_lsm_region_index_survives_reopen(tmp_path):
    """An IVF_FLAT region on a one-replica node over the native engine:
    trained search, close, reopen from the same directory, rebuild from
    the engine scan: the same ids."""
    from dingo_tpu_torch.engine.lsm_engine import LsmRawEngine
    from dingo_tpu_torch.index import codec as vcodec
    from dingo_tpu_torch.index.base import IndexParameter, IndexType
    from dingo_tpu_torch.store.node import MonoStoreNode
    from dingo_tpu_torch.store.region import RegionDefinition, RegionType

    rng = np.random.default_rng(2)
    x = rng.standard_normal((600, 16)).astype(np.float32)
    d = RegionDefinition(
        region_id=4, start_key=vcodec.encode_vector_key(1, 0),
        end_key=vcodec.encode_vector_key(1, 1 << 30), partition_id=1,
        region_type=RegionType.INDEX, index_parameter=IndexParameter(
            index_type=IndexType.IVF_FLAT, dimension=16, ncentroids=8,
            default_nprobe=4))
    path = str(tmp_path / "store")
    raw = LsmRawEngine(path, memtable_bytes=1 << 16)
    node = MonoStoreNode(raw, device="cpu")
    region = node.create_region(d)
    for lo in range(0, 600, 128):
        node.storage.vector_add(region, np.arange(lo, min(600, lo + 128),
                                                  dtype=np.int64),
                                x[lo:lo + 128])
    node.storage.vector_delete(region, [5, 6])
    assert node.index_manager.rebuild(region)
    before = node.storage.vector_batch_search(region, x[:8], 5, nprobe=8)
    raw.close()
    raw2 = LsmRawEngine(path, memtable_bytes=1 << 16)
    node2 = MonoStoreNode(raw2, device="cpu")
    assert node2.meta.recover() == 1
    region2 = node2.get_region(4)
    assert node2.index_manager.rebuild(region2)
    after = node2.storage.vector_batch_search(region2, x[:8], 5, nprobe=8)
    assert [[v.id for v in r] for r in after] == \
        [[v.id for v in r] for r in before]
    assert all(v.id not in (5, 6) for r in after for v in r)
    assert node2.storage.vector_count(region2) == 598
    raw2.close()
