"""grpc raft transport: multi-process replication (port of
dingo_tpu/raft/grpc_transport.py).

The reference replicates over brpc/braft TCP; this transport carries the
same RaftNode RPCs (request_vote / append_entries / install_snapshot /
timeout_now) between store PROCESSES over grpc. Raft node addresses stay
"<store_id>/r<region_id>"; the transport maps the store prefix to a grpc
endpoint and the receiving server dispatches to the locally-registered
handler. Local targets short-circuit in process.
"""

from __future__ import annotations

import hmac
import threading
import time
from typing import Callable, Dict, Optional

import grpc

from dingo_tpu_torch.raft import wire
from dingo_tpu_torch.raft.transport import Transport, TransportFaults
from dingo_tpu_torch.server import dingo_pb2 as pb
from dingo_tpu_torch.server.rpc import ServiceStub


class GrpcRaftTransport(Transport):
    def __init__(self, store_id: str,
                 peer_addrs: Optional[Dict[str, str]] = None,
                 cluster_token: str = ""):
        self.store_id = store_id
        #: shared cluster secret rejecting out-of-cluster senders; payloads
        #: themselves are a typed TLV codec (raft/wire.py) that can only
        #: produce plain data, so a forged message cannot execute code
        self.cluster_token = cluster_token
        self._peer_addrs = dict(peer_addrs or {})
        self._handlers: Dict[str, Callable[[str, dict], dict]] = {}
        self._channels: Dict[str, grpc.Channel] = {}
        self._stubs: Dict[str, ServiceStub] = {}
        self._lock = threading.Lock()
        #: injectable per-peer-pair faults (drop/delay/duplicate/partition,
        #: raft/transport.py TransportFaults) — None = no fault layer, the
        #: send path pays one attribute check
        self.faults: Optional[TransportFaults] = None

    # -- wiring --------------------------------------------------------------
    def set_peer(self, store_id: str, addr: str) -> None:
        with self._lock:
            self._peer_addrs[store_id] = addr
            self._channels.pop(store_id, None)
            self._stubs.pop(store_id, None)

    def register(self, node_id: str, handler) -> None:
        with self._lock:
            self._handlers[node_id] = handler

    def unregister(self, node_id: str) -> None:
        with self._lock:
            self._handlers.pop(node_id, None)

    # -- server side (RaftService dispatch) ----------------------------------
    def dispatch(self, target: str, method: str, msg: dict) -> Optional[dict]:
        with self._lock:
            handler = self._handlers.get(target)
        if handler is None:
            return None
        try:
            return handler(method, msg)
        except Exception:
            return None

    # -- client side ----------------------------------------------------------
    def _stub(self, store_id: str) -> Optional[ServiceStub]:
        with self._lock:
            stub = self._stubs.get(store_id)
            if stub is not None:
                return stub
            addr = self._peer_addrs.get(store_id)
            if addr is None:
                return None
            chan = grpc.insecure_channel(addr)
            self._channels[store_id] = chan
            stub = ServiceStub(chan, "RaftService")
            self._stubs[store_id] = stub
            return stub

    def send(self, target: str, method: str, msg: dict) -> Optional[dict]:
        store_id = target.split("/")[0]
        if store_id == self.store_id:
            return self.dispatch(target, method, msg)
        copies = 1
        if self.faults is not None:
            deliver, delay_s, copies = self.faults.decide(
                self.store_id, store_id)
            if not deliver:
                return None
            if delay_s:
                time.sleep(delay_s)
        stub = self._stub(store_id)
        if stub is None:
            return None
        req = pb.RaftMessageRequest(
            target=target, method=method,
            payload=wire.encode(msg),
            cluster_token=self.cluster_token,
        )
        resp = None
        for _ in range(copies):
            # duplicate fault: the peer processes the message twice; the
            # FIRST response is the one the raft node acts on (raft must
            # dedupe re-delivery by term/index — the invariant exercised)
            try:
                r = stub.RaftMessage(req, timeout=2.0)
            except grpc.RpcError:
                r = None
            if resp is None:
                resp = r
        if resp is None or not resp.delivered:
            return None
        try:
            return wire.decode(resp.payload)
        except wire.WireError:
            return None

    def close(self) -> None:
        with self._lock:
            for chan in self._channels.values():
                chan.close()
            self._channels.clear()


class RaftService:
    """Server-side receiver (registered on the store's DingoServer)."""

    def __init__(self, transport: GrpcRaftTransport):
        self.transport = transport

    def RaftMessage(self, req: pb.RaftMessageRequest) -> pb.RaftMessageResponse:
        resp = pb.RaftMessageResponse()
        if not hmac.compare_digest(
            req.cluster_token.encode(), self.transport.cluster_token.encode()
        ):
            resp.delivered = False
            resp.error.errcode = 95001
            resp.error.errmsg = "cluster token mismatch"
            return resp
        try:
            msg = wire.decode(req.payload)
        except wire.WireError:
            resp.delivered = False
            resp.error.errcode = 95002
            resp.error.errmsg = "malformed raft payload"
            return resp
        out = self.transport.dispatch(req.target, req.method, msg)
        if out is None:
            resp.delivered = False
        else:
            resp.delivered = True
            resp.payload = wire.encode(out)
        return resp
