"""Raft message transport (port of dingo_tpu/raft/transport.py).

The reference replicates over brpc (braft's TCP stack). Here the transport is
pluggable: LocalTransport delivers RPCs in-process with optional fault
injection (drop/partition/delay) — the single-process multi-peer topology the
reference's raft tests use (test_raft_node.cc: 3 braft peers on one
127.0.0.1 server distinguished by peer index). A grpc transport slots in for
multi-process deployments (server/ layer).

Fault injection is generalized by ``TransportFaults``: a seeded per-peer-pair
rule set (drop probability, delay, duplicate probability, partitions) that
both LocalTransport and GrpcRaftTransport consult on every send. Rules key
on STORE ids (the prefix of "<store_id>/r<region_id>" node addresses) so one
rule covers every region-pair between two stores; the chaos harness
(tools/chaos.py) drives it deterministically via the seed.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, Dict, Optional, Set, Tuple


def _store_of(node_id: str) -> str:
    """Store prefix of a raft node address ("s0/r7" -> "s0")."""
    return node_id.split("/")[0]


class LinkRule:
    """Fault parameters for one directed (src_store, dst_store) link."""

    __slots__ = ("drop", "delay_ms", "duplicate")

    def __init__(self, drop: float = 0.0, delay_ms: float = 0.0,
                 duplicate: float = 0.0):
        self.drop = drop
        self.delay_ms = delay_ms
        self.duplicate = duplicate


class TransportFaults:
    """Seeded, deterministic per-peer-pair fault rules.

    Verdicts are rolled on the SENDER's thread under one lock so a chaos
    run with a fixed seed and a fixed send order replays exactly. The
    ``decide`` contract: returns (deliver, delay_s, copies) — copies > 1
    means the transport should send the message that many times (duplicate
    delivery; raft must dedupe by term/index, which is the invariant the
    fault exists to exercise).
    """

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self._rng = random.Random(seed)
        self._partitions: Set[Tuple[str, str]] = set()
        self._links: Dict[Tuple[str, str], LinkRule] = {}
        self._default = LinkRule()
        self.injected = 0   # faults that actually fired (drop/delay/dup)

    def set_seed(self, seed: int) -> None:
        with self._lock:
            self._rng = random.Random(seed)

    # -- rules ---------------------------------------------------------------
    def partition(self, a: str, b: str) -> None:
        """Cut the store-pair a<->b (both directions)."""
        with self._lock:
            self._partitions.add((a, b))
            self._partitions.add((b, a))

    def heal(self, a: Optional[str] = None, b: Optional[str] = None) -> None:
        """Heal one store-pair (both directions) or, with no args, every
        partition AND every link rule."""
        with self._lock:
            if a is None:
                self._partitions.clear()
                self._links.clear()
                self._default = LinkRule()
            else:
                self._partitions.discard((a, b))
                self._partitions.discard((b, a))

    def set_link(self, src: str, dst: str, drop: float = 0.0,
                 delay_ms: float = 0.0, duplicate: float = 0.0) -> None:
        """Directed per-pair rule ("*" wildcard = the default rule)."""
        rule = LinkRule(drop, delay_ms, duplicate)
        with self._lock:
            if src == "*" and dst == "*":
                self._default = rule
            else:
                self._links[(src, dst)] = rule

    def is_partitioned(self, src: str, dst: str) -> bool:
        with self._lock:
            return (src, dst) in self._partitions

    # -- verdict -------------------------------------------------------------
    def decide(self, src: str, dst: str) -> Tuple[bool, float, int]:
        """(deliver, delay_s, copies) for one message src_store->dst_store.

        Counter emission happens AFTER the lock is released: the metrics
        registry has its own lock, and nesting registry acquisition under
        this one while other code observes transport state under the
        registry lock is a lock-order cycle (dingolint: lock-order)."""
        fired: list = []
        with self._lock:
            if (src, dst) in self._partitions:
                self.injected += 1
                verdict = (False, 0.0, 0)
                fired.append("partition")
            else:
                rule = self._links.get((src, dst), self._default)
                if rule.drop and self._rng.random() < rule.drop:
                    self.injected += 1
                    verdict = (False, 0.0, 0)
                    fired.append("drop")
                else:
                    copies = 1
                    if rule.duplicate \
                            and self._rng.random() < rule.duplicate:
                        self.injected += 1
                        fired.append("duplicate")
                        copies = 2
                    delay_s = (rule.delay_ms / 1000.0
                               if rule.delay_ms else 0.0)
                    if delay_s:
                        self.injected += 1
                        fired.append("delay")
                    verdict = (True, delay_s, copies)
        for kind in fired:
            self._count(kind)
        return verdict

    @staticmethod
    def _count(kind: str) -> None:
        from dingo_tpu_torch.common.metrics import METRICS

        METRICS.counter("fault.transport_faults",
                        labels={"kind": kind}).add(1)


class Transport:
    def send(self, target: str, method: str, msg: dict) -> Optional[dict]:
        """Synchronous RPC; returns response dict or None on network error."""
        raise NotImplementedError

    def register(self, node_id: str, handler: Callable[[str, dict], dict]) -> None:
        raise NotImplementedError


class LocalTransport(Transport):
    """In-process delivery with fault injection for tests."""

    def __init__(self, seed: int = 0):
        self._handlers: Dict[str, Callable[[str, dict], dict]] = {}
        self._lock = threading.Lock()
        self._rng = random.Random(seed)
        self.drop_rate = 0.0
        self._partitions: Set[Tuple[str, str]] = set()
        self.delay_s = 0.0
        #: optional generalized per-peer-pair rules (store-id keyed);
        #: consulted IN ADDITION to the legacy node-id fields above
        self.faults: Optional[TransportFaults] = None

    def register(self, node_id: str, handler) -> None:
        with self._lock:
            self._handlers[node_id] = handler

    def unregister(self, node_id: str) -> None:
        with self._lock:
            self._handlers.pop(node_id, None)

    def partition(self, a: str, b: str) -> None:
        """Cut the link a<->b (both directions; node-id granularity)."""
        self._partitions.add((a, b))
        self._partitions.add((b, a))

    def heal(self) -> None:
        self._partitions.clear()
        if self.faults is not None:
            self.faults.heal()

    def _deliver(self, target: str, method: str, msg: dict) -> Optional[dict]:
        with self._lock:
            handler = self._handlers.get(target)
        if handler is None:
            return None
        try:
            return handler(method, msg)
        except Exception:
            return None

    def send(self, target: str, method: str, msg: dict) -> Optional[dict]:
        src = msg.get("from", "?")
        if (src, target) in self._partitions:
            return None
        if self.drop_rate and self._rng.random() < self.drop_rate:
            return None
        if self.delay_s:
            time.sleep(self.delay_s)
        if self.faults is not None:
            deliver, delay_s, copies = self.faults.decide(
                _store_of(src), _store_of(target))
            if not deliver:
                return None
            if delay_s:
                time.sleep(delay_s)
            if copies > 1:
                # duplicate delivery: the receiver sees the message twice;
                # the FIRST response is what the sender acts on
                first = self._deliver(target, method, msg)
                self._deliver(target, method, msg)
                return first
        return self._deliver(target, method, msg)
