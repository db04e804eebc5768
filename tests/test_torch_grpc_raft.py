"""Raft over gRPC in the port against the JAX package: the three cases of
tests/test_grpc_raft_transport.py, each on a cluster of each package
whose three StoreNodes replicate through their own GrpcRaftTransport and
the servers' RaftService (real sockets, no shared in-process bus), and
the RaftService's refusals of a foreign sender (95001, a wrong cluster
token) and of a malformed payload (95002).

Replication is compared on every replica (counts and search hits equal
to the JAX package's), failover by the surviving writes, PushService by
the command ids it acknowledges and the regions it creates.
"""

import importlib

import grpc
import numpy as np
import pytest
import torch

from test_torch_grpc_server import PB, PKGS, GrpcCluster, wait_for

torch.set_num_threads(1)


@pytest.fixture()
def clusters():
    cs = {}
    try:
        for name in PKGS:
            cs[name] = GrpcCluster(name, grpc_raft=True)
        yield cs
    finally:
        for c in cs.values():
            c.close()


def test_replication_over_sockets(clusters):
    """30 rows written on the leader reach every replica's engine and
    index; each replica's search answers the JAX package's hits."""
    x = np.random.default_rng(0).standard_normal((30, 8)).astype(np.float32)
    hits = {}
    for name, c in clusters.items():
        rid = c.create(index_type="flat", dimension=8, start=0, end=1 << 30)
        leader = c.nodes[c.leader(rid)]
        leader.storage.vector_add(leader.get_region(rid),
                                  np.arange(30, dtype=np.int64), x)
        counts = []

        def converged():
            counts[:] = [n.storage.vector_count(n.get_region(rid))
                         for n in c.nodes.values()]
            return counts == [30, 30, 30]

        wait_for(converged, what=f"replication in {name}")
        hits[name] = []
        for n in c.nodes.values():
            r = n.get_region(rid)
            assert r.vector_index_wrapper.get_count() == 30, name
            rows = n.storage.vector_batch_search(r, x[:4], 3)
            hits[name].append([[v.id for v in row] for row in rows])
    assert hits["dingo_tpu_torch"] == hits["dingo_tpu"]
    # each query is a stored row: its own id comes first on every replica
    assert all([row[0] for row in replica] == [0, 1, 2, 3]
               for replica in hits["dingo_tpu_torch"])


def test_failover_over_sockets(clusters):
    """Cutting the leader's links elects a new leader among the
    survivors, which keeps the old write and takes a new one."""
    for name, c in clusters.items():
        rid = c.create(kind="kv", start=b"a", end=b"z")
        dead = c.leader(rid)
        leader = c.nodes[dead]
        leader.storage.kv_put(leader.get_region(rid), [(b"k", b"v")])
        c.settle(rid)
        for sid, t in c.transports.items():
            if sid != dead:
                t.set_peer(dead, "127.0.0.1:1")
        for sid in c.sids:
            if sid != dead:
                c.transports[dead].set_peer(sid, "127.0.0.1:1")
        survivors = [s for s in c.sids if s != dead]
        found = []

        def new_leader():
            found[:] = [s for s in survivors if c.raft(s, rid).is_leader()]
            return len(found) == 1

        wait_for(new_leader, what=f"a new leader in {name}")
        n2 = c.nodes[found[0]]
        r2 = n2.get_region(rid)
        n2.storage.kv_put(r2, [(b"k2", b"v2")])
        assert n2.storage.kv_get(r2, b"k") == b"v", name
        assert n2.storage.kv_get(r2, b"k2") == b"v2", name


def test_push_service():
    """CREATE commands delivered by PushService (no heartbeats): every
    pending command is acknowledged and each peer holds the region."""
    done = {}
    for name in PKGS:
        c = GrpcCluster(name, heartbeat=False)
        try:
            conv = c.p.convert
            d = c.control.create_region(start_key=b"p", end_key=b"q",
                                        replication=2)
            done[name] = []
            for sid in d.peers:
                pending = [cmd for cmd in c.control.store_ops[sid]
                           if cmd.status == "pending"]
                assert pending, (name, sid)
                req = PB.PushStoreOperationRequest()
                for cmd in pending:
                    out = req.commands.add()
                    out.cmd_id = cmd.cmd_id
                    out.region_id = cmd.region_id
                    out.cmd_type = cmd.cmd_type.value
                    if cmd.definition is not None:
                        out.definition.CopyFrom(
                            conv.region_def_to_pb(cmd.definition))
                resp = c.stub(sid, "PushService").PushStoreOperation(req)
                assert list(resp.done_cmd_ids) == \
                    [cmd.cmd_id for cmd in pending], name
                done[name].append(len(resp.done_cmd_ids))
                for cmd in pending:
                    cmd.status = "done"
            for sid in d.peers:
                assert c.nodes[sid].get_region(d.region_id) is not None
            c.leader(d.region_id)
        finally:
            c.close()
    assert done["dingo_tpu_torch"] == done["dingo_tpu"]


@pytest.mark.parametrize("name", PKGS)
def test_raft_service_rejects_foreign_senders(name):
    """RaftService answers a wrong cluster token with 95001 and a
    payload that does not decode with 95002; neither is delivered. The
    JAX package's stub calls the port's server and the other way
    round."""
    other = PKGS[1 - PKGS.index(name)]
    gt = importlib.import_module(f"{name}.raft.grpc_transport")
    rpc = importlib.import_module(f"{name}.server.rpc")
    wire = importlib.import_module(f"{other}.raft.wire")
    stub_t = importlib.import_module(f"{other}.server.rpc").ServiceStub
    transport = gt.GrpcRaftTransport("s0", cluster_token="secret")
    transport.register("s0/r1", lambda method, msg: {"echo": method})
    server = rpc.DingoServer()
    rpc._register(server._server, "RaftService", gt.RaftService(transport))
    port = server.start()
    chan = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        stub = stub_t(chan, "RaftService")
        ok = stub.RaftMessage(PB.RaftMessageRequest(
            target="s0/r1", method="m", payload=wire.encode({"x": 1}),
            cluster_token="secret"))
        assert ok.delivered and wire.decode(ok.payload) == {"echo": "m"}
        bad = stub.RaftMessage(PB.RaftMessageRequest(
            target="s0/r1", method="m", payload=wire.encode({}),
            cluster_token="wrong"))
        assert not bad.delivered and bad.error.errcode == 95001
        junk = stub.RaftMessage(PB.RaftMessageRequest(
            target="s0/r1", method="m", payload=b"\xff\x00junk",
            cluster_token="secret"))
        assert not junk.delivered and junk.error.errcode == 95002
        nobody = stub.RaftMessage(PB.RaftMessageRequest(
            target="s0/r9", method="m", payload=wire.encode({}),
            cluster_token="secret"))
        assert not nobody.delivered and nobody.error.errcode == 0
    finally:
        chan.close()
        server.stop()
        transport.close()
