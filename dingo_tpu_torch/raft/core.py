"""Raft consensus core: election, replication, commit, snapshot install
(port of dingo_tpu/raft/core.py).

Reference mapping:
  RaftNode (src/raft/raft_node.h; Commit at raft_node.cc:124)  -> RaftNode
  StoreStateMachine::on_apply (store_state_machine.cc:110)     -> apply_fn
  on_leader_start / on_start_following (raft_vote_handler.cc)  -> callbacks
  braft replication + snapshot install                         -> ticker
      thread + InstallSnapshot RPC (engine checkpoint blob)

Original implementation of the Raft algorithm (Ongaro & Ousterhout) — the
reference uses braft; we need no external consensus library.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, List, Optional

from dingo_tpu_torch.common.log import get_logger
from dingo_tpu_torch.raft.log import RaftLog
from dingo_tpu_torch.raft.transport import Transport

_log = get_logger("raft.core")

FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"

#: payload of the entry a new leader appends when its log holds entries
#: beyond its commit index; apply_fn never sees it
NOOP = b""


class NotLeader(Exception):
    def __init__(self, leader_hint: Optional[str] = None):
        super().__init__(f"not leader (hint: {leader_hint})")
        self.leader_hint = leader_hint


class ProposalFailed(Exception):
    pass


class RaftNode:
    def __init__(
        self,
        node_id: str,
        peers: List[str],
        transport: Transport,
        log: Optional[RaftLog] = None,
        apply_fn: Optional[Callable[[int, bytes], None]] = None,
        snapshot_save_fn: Optional[Callable[[], bytes]] = None,
        snapshot_install_fn: Optional[Callable[[bytes], None]] = None,
        on_leader_start: Optional[Callable[[int], None]] = None,
        on_start_following: Optional[Callable[[str, int], None]] = None,
        election_timeout: tuple = (0.15, 0.3),
        heartbeat_interval: float = 0.05,
        snapshot_threshold: int = 10_000,
        seed: Optional[int] = None,
    ):
        self.id = node_id
        self.peers = [p for p in peers if p != node_id]
        self.transport = transport
        self.log = log or RaftLog()
        self.apply_fn = apply_fn or (lambda i, p: None)
        self.snapshot_save_fn = snapshot_save_fn
        self.snapshot_install_fn = snapshot_install_fn
        self.on_leader_start = on_leader_start
        self.on_start_following = on_start_following
        self.election_timeout = election_timeout
        self.heartbeat_interval = heartbeat_interval
        self.snapshot_threshold = snapshot_threshold

        self._lock = threading.RLock()
        self._applied_cv = threading.Condition(self._lock)
        #: serializes state-machine application: apply_fn must run in log
        #: order and last_applied only advances AFTER apply_fn returns.
        self._apply_mutex = threading.Lock()
        self.role = FOLLOWER
        self.current_term, self.voted_for = self.log.hard_state()
        self.leader_id: Optional[str] = None
        self.commit_index = self.log.snapshot_index
        self.last_applied = self.log.snapshot_index
        self.next_index: Dict[str, int] = {}
        self.match_index: Dict[str, int] = {}
        self._rng = random.Random(seed if seed is not None else hash(node_id))
        self._deadline = time.monotonic() + self._rand_timeout()
        #: last time we heard from a live leader — drives pre-vote
        #: stickiness; must NOT be conflated with _deadline, which the
        #: node's own candidacy resets (that conflation livelocked
        #: failover: survivors mutually refused pre-votes)
        self._last_leader_contact = 0.0
        #: leader-side: last time each peer answered an RPC (check-quorum)
        self._peer_last_ack: Dict[str, float] = {}
        self._stop = threading.Event()
        self._appliers_busy = False

        transport.register(node_id, self._handle_rpc)
        self._ticker = threading.Thread(
            target=self._tick_loop, name=f"raft-{node_id}", daemon=True
        )

    # ------------- lifecycle -------------
    def start(self) -> None:
        self._ticker.start()

    def stop(self) -> None:
        self._stop.set()
        self.transport.unregister(self.id)
        if self._ticker.is_alive():
            self._ticker.join(timeout=2)
        self.log.close()

    def is_leader(self) -> bool:
        with self._lock:
            return self.role == LEADER

    # ------------- public: membership -------------
    def update_peers(self, peer_ids) -> None:
        """Single-step membership change (braft ChangePeers analog; the
        coordinator changes one server at a time, which keeps single-step
        reconfiguration safe). New peers start from next_index=1 and catch
        up via normal replication / snapshot install."""
        with self._lock:
            new_peers = [p for p in peer_ids if p != self.id]
            now = time.monotonic()
            for p in new_peers:
                if p not in self.next_index:
                    self.next_index[p] = self.log.last_index() + 1
                    self.match_index[p] = 0
                    # full check-quorum grace window, like a fresh leader:
                    # an epoch ack would count the new peer as
                    # unreachable-forever and could depose a healthy
                    # leader on the very tick the membership change applies
                    self._peer_last_ack[p] = now
            for p in list(self.next_index):
                if p not in new_peers and p != self.id:
                    self.next_index.pop(p, None)
                    self.match_index.pop(p, None)
                    self._peer_last_ack.pop(p, None)
            self.peers = new_peers

    # ------------- public: leadership transfer -------------
    def transfer_leadership(self, target: str) -> bool:
        """Ask `target` to campaign now; we step down on its higher term
        (RaftNode transfer-leader, raft_node.h)."""
        with self._lock:
            if self.role != LEADER or target not in self.peers:
                return False
        resp = self.transport.send(target, "timeout_now", {"from": self.id})
        return resp is not None and resp.get("ok", False)

    # ------------- public: propose (RaftNode::Commit) -------------
    def propose(self, payload: bytes, timeout: float = 5.0) -> int:
        """Append to the replicated log; blocks until applied locally.
        Returns the log index. Raises NotLeader / ProposalFailed."""
        from dingo_tpu_torch.common.failpoint import failpoint

        failpoint("before_raft_propose")
        with self._lock:
            if self.role != LEADER:
                raise NotLeader(self.leader_id)
            term = self.current_term
            index = self.log.append(term, payload)
            self.match_index[self.id] = index
        self._broadcast_append()
        deadline = time.monotonic() + timeout
        with self._applied_cv:
            while self.last_applied < index:
                if self.log.term_at(index) != term:
                    raise ProposalFailed(f"entry {index} overwritten")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ProposalFailed(f"timeout waiting for apply {index}")
                self._applied_cv.wait(remaining)
            if self.log.term_at(index) not in (term, None):
                raise ProposalFailed(f"entry {index} overwritten")
        return index

    # ------------- ticker -------------
    def _persist_hard_state(self) -> None:
        """Raft safety: term/vote must survive restart or a node can vote
        twice in one term (election safety violation). Must hold _lock."""
        self.log.set_hard_state(self.current_term, self.voted_for)

    def _rand_timeout(self) -> float:
        lo, hi = self.election_timeout
        return lo + (hi - lo) * self._rng.random()

    def _tick_loop(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                role = self.role
            if role == LEADER:
                self._broadcast_append()
                self._check_quorum()
                self._stop.wait(self.heartbeat_interval)
            else:
                now = time.monotonic()
                with self._lock:
                    expired = now >= self._deadline
                if expired:
                    self._start_election()
                else:
                    self._stop.wait(0.01)

    # ------------- election -------------
    def _pre_vote(self) -> bool:
        """Pre-vote phase (braft parity): probe a majority's willingness to
        vote for term+1 WITHOUT bumping our term. A partitioned node that
        keeps timing out cannot inflate its term and depose a healthy
        leader on rejoin; peers with a live leader refuse."""
        with self._lock:
            proposed = self.current_term + 1
            last_idx = self.log.last_index()
            last_term = self.log.last_term()
            # reset the deadline so we do not spin pre-votes back to back
            self._deadline = time.monotonic() + self._rand_timeout()
        granted = 1
        for peer in self.peers:
            resp = self.transport.send(peer, "pre_vote", {
                "from": self.id, "term": proposed,
                "last_log_index": last_idx, "last_log_term": last_term,
            })
            if resp is None:
                continue
            if resp["term"] > proposed - 1:
                # a peer is ahead: adopt its term so we can participate in
                # the real election instead of probing a stale term forever
                self._step_down(resp["term"])
                return False
            if resp.get("granted"):
                granted += 1
        quorum = (len(self.peers) + 1) // 2 + 1
        ok = granted >= quorum
        if not ok:
            # retry sooner than a full election timeout: pre-vote probes
            # disturb nobody, and a refused round usually means peers'
            # deadlines have not expired yet
            with self._lock:
                self._deadline = time.monotonic() + 0.5 * self._rand_timeout()
        return ok

    def _on_pre_vote(self, msg: dict) -> dict:
        with self._lock:
            # refuse while we believe a leader is alive: if WE are the
            # leader that is trivially true (a leader's own deadline is not
            # refreshed, so the time check below would wrongly lapse), and
            # for followers the deadline tracks recent leader contact —
            # leader stickiness is the whole point of pre-vote
            leader_alive = self.role == LEADER or (
                self.leader_id is not None
                and time.monotonic() - self._last_leader_contact
                < self.election_timeout[1]
            )
            up_to_date = (
                msg["last_log_term"], msg["last_log_index"]
            ) >= (self.log.last_term(), self.log.last_index())
            granted = (
                not leader_alive
                and msg["term"] > self.current_term
                and up_to_date
            )
            return {"term": self.current_term, "granted": granted}

    def _start_election(self, skip_pre_vote: bool = False) -> None:
        if not skip_pre_vote and self.peers and not self._pre_vote():
            return
        with self._lock:
            self.role = CANDIDATE
            self.current_term += 1
            term = self.current_term
            self.voted_for = self.id
            self._persist_hard_state()
            self.leader_id = None
            self._deadline = time.monotonic() + self._rand_timeout()
            last_idx = self.log.last_index()
            last_term = self.log.last_term()
        votes = 1
        for peer in self.peers:
            resp = self.transport.send(peer, "request_vote", {
                "from": self.id, "term": term, "last_log_index": last_idx,
                "last_log_term": last_term,
            })
            if resp is None:
                continue
            if resp["term"] > term:
                self._step_down(resp["term"])
                return
            if resp.get("granted"):
                votes += 1
        quorum = (len(self.peers) + 1) // 2 + 1
        with self._lock:
            if self.role != CANDIDATE or self.current_term != term:
                return
            if votes >= quorum:
                self.role = LEADER
                self.leader_id = self.id
                last = self.log.last_index()
                self.next_index = {p: last + 1 for p in self.peers}
                self.match_index = {p: 0 for p in self.peers}
                self.match_index[self.id] = last
                if last > self.commit_index:
                    # a leader commits only entries of its own term, so
                    # earlier-term entries beyond the known commit index
                    # (one the old leader acknowledged included) would
                    # wait for the next proposal to be applied here and
                    # on the followers: a no-op of this term commits them
                    # now (Raft section 8; braft's configuration entry).
                    # The JAX package's core appends none.
                    self.match_index[self.id] = self.log.append(term, NOOP)
                # fresh check-quorum clock: the new leader gets a full
                # window before reachability is judged
                now = time.monotonic()
                self._peer_last_ack = {p: now for p in self.peers}
                cb = self.on_leader_start
            else:
                return
        _log.info("%s became leader (term %d, last_index %d)",
                  self.id, term, last)
        if cb:
            cb(term)
        self._broadcast_append()

    def _step_down(self, term: int, leader: Optional[str] = None) -> None:
        cb = None
        with self._lock:
            if term > self.current_term:
                self.current_term = term
                self.voted_for = None
                self._persist_hard_state()
            was = self.role
            self.role = FOLLOWER
            if leader is not None and leader != self.leader_id:
                self.leader_id = leader
                cb = self.on_start_following
            self._deadline = time.monotonic() + self._rand_timeout()
        if cb and leader is not None:
            cb(leader, term)

    # ------------- replication (leader side) -------------
    def _check_quorum(self) -> None:
        """Check-quorum (braft parity): a leader that cannot reach a
        majority within ~2 election timeouts steps down. Without this, a
        partitioned-away leader keeps role=LEADER until it SEES a higher
        term — which the partition prevents — and the leader-gated read
        paths would serve reads missing the new leader's commits
        indefinitely. With it, the stale-read window is bounded by the
        check window."""
        window = 2.0 * self.election_timeout[1]
        with self._lock:
            if self.role != LEADER or not self.peers:
                return
            now = time.monotonic()
            reachable = 1 + sum(
                1 for p in self.peers
                if now - self._peer_last_ack.get(p, 0.0) <= window
            )
            quorum = (len(self.peers) + 1) // 2 + 1
            if reachable >= quorum:
                return
            self.role = FOLLOWER
            self.leader_id = None
            self._deadline = now + self._rand_timeout()
        _log.warning(
            "%s stepping down (check-quorum): %d/%d peers reachable in "
            "%.2fs window", self.id, reachable - 1, len(self.peers), window,
        )

    def _broadcast_append(self) -> None:
        for peer in self.peers:
            self._replicate_to(peer)
        self._advance_commit()

    def _replicate_to(self, peer: str) -> None:
        # Decide snapshot-vs-append under _lock, but CALL _send_snapshot
        # outside it: _send_snapshot takes _apply_mutex, and
        # _apply_committed takes _apply_mutex then _lock — calling it
        # while holding _lock inverts the lock order (deadlock).
        need_snapshot = False
        with self._lock:
            if self.role != LEADER:
                return
            term = self.current_term
            nxt = self.next_index.get(peer, self.log.last_index() + 1)
            # Follower too far behind the compacted log -> snapshot install
            if nxt <= self.log.snapshot_index:
                need_snapshot = True
            else:
                prev_index = nxt - 1
                prev_term = self.log.term_at(prev_index)
                if prev_term is None:
                    need_snapshot = True
                else:
                    entries = self.log.entries_from(nxt)
                    commit = self.commit_index
        if need_snapshot:
            self._send_snapshot(peer, term)
            return
        resp = self.transport.send(peer, "append_entries", {
            "from": self.id, "term": term, "prev_index": prev_index,
            "prev_term": prev_term, "entries": entries, "commit": commit,
        })
        if resp is None:
            return
        with self._lock:
            # any response proves reachability (check-quorum input)
            self._peer_last_ack[peer] = time.monotonic()
        if resp["term"] > term:
            self._step_down(resp["term"])
            return
        with self._lock:
            if self.role != LEADER or self.current_term != term:
                return
            if resp.get("ok"):
                if entries:
                    self.match_index[peer] = entries[-1][0]
                    self.next_index[peer] = entries[-1][0] + 1
                else:
                    self.match_index[peer] = max(
                        self.match_index.get(peer, 0), prev_index
                    )
            else:
                hint = resp.get("conflict_index")
                self.next_index[peer] = max(
                    1, hint if hint else self.next_index.get(peer, 2) - 1
                )

    def _send_snapshot(self, peer: str, term: int) -> None:
        if self.snapshot_save_fn is None:
            return
        # Hold the apply mutex so the blob reflects EXACTLY last_applied —
        # labeling it with a commit_index ahead of apply would make the
        # follower skip the gap entries forever (replica divergence).
        with self._apply_mutex:
            with self._lock:
                snap_index = self.last_applied
                snap_term = self.log.term_at(snap_index) or self.current_term
            blob = self.snapshot_save_fn()
        resp = self.transport.send(peer, "install_snapshot", {
            "from": self.id, "term": term, "snap_index": snap_index,
            "snap_term": snap_term, "blob": blob,
        })
        if resp is None:
            return
        with self._lock:
            self._peer_last_ack[peer] = time.monotonic()
        if resp["term"] > term:
            self._step_down(resp["term"])
            return
        with self._lock:
            if self.role == LEADER and resp.get("ok"):
                self.match_index[peer] = snap_index
                self.next_index[peer] = snap_index + 1

    def _advance_commit(self) -> None:
        with self._lock:
            if self.role != LEADER:
                return
            matches = sorted(self.match_index.values(), reverse=True)
            quorum = (len(self.peers) + 1) // 2 + 1
            candidate = matches[quorum - 1] if len(matches) >= quorum else 0
            # Raft safety: only commit entries from the current term directly
            if (
                candidate > self.commit_index
                and self.log.term_at(candidate) == self.current_term
            ):
                self.commit_index = candidate
        self._apply_committed()

    # ------------- RPC handlers (follower side) -------------
    def _handle_rpc(self, method: str, msg: dict) -> dict:
        if method == "request_vote":
            return self._on_request_vote(msg)
        if method == "pre_vote":
            return self._on_pre_vote(msg)
        if method == "timeout_now":
            # leadership transfer: start an election immediately, skipping
            # pre-vote (the current leader explicitly asked us to take
            # over; braft TransferLeadership analog)
            threading.Thread(
                target=self._start_election, kwargs={"skip_pre_vote": True},
                daemon=True,
            ).start()
            return {"term": self.current_term, "ok": True}
        if method == "append_entries":
            return self._on_append_entries(msg)
        if method == "install_snapshot":
            return self._on_install_snapshot(msg)
        return {"term": 0, "ok": False}

    def _on_request_vote(self, msg: dict) -> dict:
        with self._lock:
            term = msg["term"]
            if term < self.current_term:
                return {"term": self.current_term, "granted": False}
            if term > self.current_term:
                self.current_term = term
                self.voted_for = None
                self.role = FOLLOWER
                self._persist_hard_state()
            up_to_date = (
                msg["last_log_term"], msg["last_log_index"]
            ) >= (self.log.last_term(), self.log.last_index())
            if up_to_date and self.voted_for in (None, msg["from"]):
                self.voted_for = msg["from"]
                self._persist_hard_state()
                self._deadline = time.monotonic() + self._rand_timeout()
                return {"term": self.current_term, "granted": True}
            return {"term": self.current_term, "granted": False}

    def _on_append_entries(self, msg: dict) -> dict:
        to_apply = []
        cb = None
        with self._lock:
            term = msg["term"]
            if term < self.current_term:
                return {"term": self.current_term, "ok": False}
            if term > self.current_term:
                self.current_term = term
                self.voted_for = None
                self._persist_hard_state()
            self.role = FOLLOWER
            if msg["from"] != self.leader_id:
                self.leader_id = msg["from"]
                cb = self.on_start_following
            self._deadline = time.monotonic() + self._rand_timeout()
            self._last_leader_contact = time.monotonic()
            prev_index, prev_term = msg["prev_index"], msg["prev_term"]
            my_prev_term = self.log.term_at(prev_index)
            if my_prev_term is None or my_prev_term != prev_term:
                conflict = min(prev_index, self.log.last_index() + 1)
                # skip back over the conflicting term cheaply
                while (
                    conflict > self.log.first_index
                    and self.log.term_at(conflict - 1) == my_prev_term
                    and my_prev_term is not None
                ):
                    conflict -= 1
                return {
                    "term": self.current_term, "ok": False,
                    "conflict_index": max(conflict, 1),
                }
            for index, eterm, payload in msg["entries"]:
                existing = self.log.term_at(index)
                if existing != eterm:
                    self.log.put_at(index, eterm, payload)
            if msg["commit"] > self.commit_index:
                self.commit_index = min(msg["commit"], self.log.last_index())
            out = {"term": self.current_term, "ok": True}
        if cb:
            cb(msg["from"], msg["term"])
        self._apply_committed()
        return out

    def _on_install_snapshot(self, msg: dict) -> dict:
        with self._lock:
            term = msg["term"]
            if term < self.current_term:
                return {"term": self.current_term, "ok": False}
            if term > self.current_term:
                self.current_term = term
                self.voted_for = None
                self._persist_hard_state()
            self.role = FOLLOWER
            self.leader_id = msg["from"]
            self._deadline = time.monotonic() + self._rand_timeout()
            self._last_leader_contact = time.monotonic()
            if msg["snap_index"] <= self.log.snapshot_index:
                return {"term": self.current_term, "ok": True}
        _log.info("%s installing snapshot @%d (term %d) from %s",
                  self.id, msg["snap_index"], msg["snap_term"], msg["from"])
        with self._apply_mutex:  # no concurrent apply during state install
            if self.snapshot_install_fn:
                self.snapshot_install_fn(msg["blob"])
            with self._lock:
                self.log.install_snapshot_mark(
                    msg["snap_index"], msg["snap_term"]
                )
                self.commit_index = max(self.commit_index, msg["snap_index"])
                self.last_applied = max(self.last_applied, msg["snap_index"])
                self._applied_cv.notify_all()
        return {"term": self.current_term, "ok": True}

    # ------------- apply -------------
    def _apply_committed(self) -> None:
        """Apply committed entries IN ORDER; last_applied only advances
        after apply_fn returns, and a mutex serializes appliers across
        threads (ticker + RPC handlers) so the state machine never sees
        out-of-order or premature-visible applies."""
        applied_any = False
        with self._apply_mutex:
            while True:
                with self._lock:
                    nxt = self.last_applied + 1
                    if nxt > self.commit_index:
                        break
                    entry = self.log.entry_at(nxt)
                    if entry is None:
                        break
                    payload = entry[1]
                if payload != NOOP:
                    self.apply_fn(nxt, payload)
                applied_any = True
                with self._applied_cv:
                    self.last_applied = nxt
                    self._applied_cv.notify_all()
        if applied_any:
            self._maybe_snapshot()

    def _maybe_snapshot(self) -> None:
        """Log compaction once the retained tail exceeds the threshold
        (braft snapshot trigger analog)."""
        if self.snapshot_save_fn is None:
            return
        with self._apply_mutex:
            with self._lock:
                retained = self.last_applied - self.log.snapshot_index
                if retained < self.snapshot_threshold:
                    return
                upto = self.last_applied
            # blob reflects exactly last_applied (apply mutex held)
            self.snapshot_save_fn()
            with self._lock:
                self.log.compact(upto)
