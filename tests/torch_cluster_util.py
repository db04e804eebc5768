"""Helpers of the control-plane parity tests: one package's control-plane
modules by name (the port's constructors get ``device="cpu"``), the
heartbeat and leader waits of test_cluster.py, and the observables two
runs of a scenario are held equal on."""

import importlib
import time

import numpy as np

PKGS = ("dingo_tpu", "dingo_tpu_torch")


class Pkg:
    MODS = {"control": "coordinator.control", "balance": "coordinator.balance",
            "kvm": "coordinator.kv_control", "tso": "coordinator.tso",
            "ai": "coordinator.auto_increment", "meta": "coordinator.meta",
            "raft_meta": "coordinator.raft_meta",
            "raw": "engine.raw_engine", "vcodec": "index.codec",
            "base": "index.base", "raft": "raft", "rcore": "raft.core",
            "rlog": "raft.log", "node": "store.node",
            "regm": "store.region", "checker": "store.checker",
            "snapshot": "metrics.snapshot", "crontab": "common.crontab",
            "metrics": "common.metrics", "persist": "common.persist",
            "recovery": "index.recovery", "devfault": "ops.devfault",
            "wd": "engine.write_data", "manager": "index.manager",
            "apply": "engine.apply", "config": "common.config",
            "factory": "index.factory", "wrapper": "index.wrapper",
            "digest": "ops.digest", "integrity": "obs.integrity",
            "quality": "obs.quality", "tuner": "obs.tuner",
            "events": "obs.events", "heat": "obs.heat", "cost": "obs.cost",
            "flight": "obs.flight", "hbm": "obs.hbm",
            "pressure": "obs.pressure", "coalescer": "common.coalescer",
            "sentinel": "obs.sentinel", "collector": "metrics.collector",
            "http": "metrics.http", "trace": "trace"}

    def __init__(self, name):
        self.name = name
        self.kw = {"device": "cpu"} if name == "dingo_tpu_torch" else {}
        for attr, m in self.MODS.items():
            setattr(self, attr, importlib.import_module(f"{name}.{m}"))

    def coordinator(self, replication=3, engine=None):
        eng = engine if engine is not None else self.raw.MemEngine()
        return self.control.CoordinatorControl(eng, replication=replication)

    def store(self, sid, transport, coord, seed, **raft_kw):
        return self.node.StoreNode(sid, transport, coord,
                                   raft_kw={"seed": seed, **raft_kw},
                                   **self.kw)

    def cluster(self, n=3, replication=3, **raft_kw):
        transport = self.raft.LocalTransport()
        coord = self.coordinator(replication)
        nodes = {f"s{i}": self.store(f"s{i}", transport, coord, i, **raft_kw)
                 for i in range(n)}
        return transport, coord, nodes

    @property
    def torch(self) -> bool:
        return self.name == "dingo_tpu_torch"

    def new_index(self, index_id, param):
        return self.factory.new_index(index_id, param, **self.kw)

    def host(self, arr) -> np.ndarray:
        """A device array's values on the host (a copy)."""
        if self.torch:
            return arr.cpu().numpy().copy()
        return np.asarray(arr).copy()

    def device_like(self, host, like):
        """`host` as a device array where `like` lives."""
        if self.torch:
            import torch

            return torch.from_numpy(np.ascontiguousarray(host)).to(
                like.device)
        import jax.numpy as jnp

        return jnp.asarray(host)

    def index_param(self, index_type="flat", dim=8, **kw):
        b = self.base
        return b.IndexParameter(index_type=b.IndexType(index_type),
                                dimension=dim, **kw)

    def index_region(self, coord, partition=0, lo=0, hi=1 << 40, **kw):
        return coord.create_region(
            start_key=self.vcodec.encode_vector_key(partition, lo),
            end_key=self.vcodec.encode_vector_key(partition, hi),
            partition_id=partition,
            region_type=self.regm.RegionType.INDEX,
            index_parameter=self.index_param(**kw))


def stop_nodes(nodes):
    for n in nodes.values():
        n.stop()


def drive_heartbeats(nodes, rounds=3):
    for _ in range(rounds):
        for n in nodes.values():
            n.heartbeat_once()
        time.sleep(0.05)


def wait_region_leader(nodes, region_id, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        leaders = [
            n for n in nodes.values()
            if (rn := n.engine.get_node(region_id)) is not None
            and rn.is_leader()
        ]
        if len(leaders) == 1:
            return leaders[0]
        time.sleep(0.02)
    raise AssertionError(f"no leader for region {region_id}")


def wait_for(cond, timeout=5.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def region_view(coord):
    """The coordinator's region map: id -> (keys, epoch, peers)."""
    return {rid: (d.start_key, d.end_key, d.epoch.conf_version,
                  d.epoch.version, list(d.peers))
            for rid, d in sorted(coord.regions.items())}


def cmd_view(coord):
    """The commands the coordinator issued, in order: (type, region, split
    key, child id). The store a command went to follows raft leadership,
    which is timing, and is left out."""
    return [(c.cmd_id, c.cmd_type.value, c.region_id, c.split_key,
             c.child_region_id) for c in coord.jobs]


def rows(res):
    """A reader's reply rows as (ids, distances) arrays per query."""
    return [(np.asarray([v.id for v in r], np.int64),
             np.asarray([v.distance for v in r], np.float32)) for r in res]


def assert_same_modulo_ties(a, b, rtol=1e-5, atol=1e-5):
    """Two packages' reply rows: distances within rtol (and atol for a
    distance near 0, where XLA's f32 |q|^2 - 2 q.x + |x|^2 rounds to
    ~2e-6 and the port's to 0), an id that differs sits at a distance
    equal to a neighbour's (an exact tie)."""
    assert len(a) == len(b)
    for (ia, da), (ib, db) in zip(rows(a), rows(b)):
        assert len(ia) == len(ib)
        np.testing.assert_allclose(db, da, rtol=rtol, atol=atol)
        for c in np.flatnonzero(ia != ib):
            near = [db[j] for j in (c - 1, c + 1) if 0 <= j < len(db)]
            assert any(np.isclose(db[c], v, rtol=rtol, atol=atol)
                       for v in near), (ia, ib, da, db)


def exact_ids(x, ids, q, k):
    """numpy's exact L2 top-k of `q` over rows `x` with ids `ids`."""
    d = ((x - q[None, :]) ** 2).sum(1)
    order = np.argsort(d, kind="stable")[:k]
    return ids[order], d[order]
