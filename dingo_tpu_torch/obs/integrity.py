"""State-integrity plane: incremental device-state digests + corruption
scrub (port of dingo_tpu/obs/integrity.py).

The stack observes latency (trace), resources (metrics/hbm), quality
(obs/quality.py) and pressure (obs/pressure.py) — this module observes
*state*: whether the bytes an index actually serves from still match what
was written. One region's data lives simultaneously as SlotStore rows,
sq8 codes, a dimension-blocked scan mirror, an HNSW adjacency mirror and
an IVF bucket arrangement; silent drift between any of them (a scatter
bug, a bad restore, flipped HBM) is the failure mode nothing else
catches.

Mechanics (ops/digest.py): every artifact keeps an order-invariant
multiset digest over (id, canonical payload bytes) — write paths fold
batches in with O(batch) host work (put adds a term, tombstone subtracts
it; no device work, no recompiles), so the digest is always current and
O(1) to read. Digests are tagged with the raft applied index and ride
heartbeats (RegionMetricsSnapshot.integrity_*); CoordinatorControl
compares replicas at EQUAL applied indices and raises the
``consistency.*`` family + a DIVERGED flag + a rate-limited flight
bundle carrying both replicas' digest vectors.

The ``consistency_scrub`` crontab recomputes full digests FROM DEVICE
STATE off the hot path (chunked reads under ``store.device_lock`` so
p99 stays bounded) and checks them against the incremental ledger —
catching both bookkeeping bugs (ledger wrong) and silent HBM/restore
corruption (device wrong). Snapshot save persists the digest vector in
meta.json; load recomputes from the restored state and refuses to serve
a mismatch (index/base.py SnapshotCorruption -> the manager falls back
to a rebuild from the engine, which is the source of truth).

Ledgers are keyed by INDEX OBJECT (weakly), not by region id: a rebuild
builds a fresh index while the old one still serves writes, and the two
must not share a ledger. Reporting resolves through the region's live
wrapper, so heartbeats always describe the serving index.
"""

from __future__ import annotations

import json
import threading
import time
import weakref
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from dingo_tpu_torch.common.config import FLAGS
from dingo_tpu_torch.common.log import get_logger
from dingo_tpu_torch.common.metrics import METRICS
from dingo_tpu_torch.ops.digest import (
    SetDigest,
    row_fingerprints,
    row_fingerprints_tags,
)

_log = get_logger("obs.integrity")

#: slots read back per device_lock hold during a scrub / restore rebuild
#: (bounds how long a scrub chunk can stall a concurrent search dispatch)
SCRUB_CHUNK = 65536

#: artifacts that survive a snapshot save/load round-trip and are
#: therefore persisted in meta.json ("blocked" is a runtime arrangement
#: rebuilt from conf at load; its digest is checked by the scrub instead)
SNAPSHOT_ARTIFACTS = ("rows", "adjacency", "ivf_buckets", "pq_codes")

#: artifacts EXCLUDED from the heartbeat digest vector the coordinator
#: compares across replicas: the adjacency ledger is rewritten by the
#: LAZY device-mirror re-export (search-timing-driven, not raft-ordered),
#: so two healthy replicas at the same applied index can legitimately
#: hold different adjacency digests — comparing them would read pure
#: staleness as divergence. The scrub (adjacency_in_sync-gated) and the
#: snapshot meta still cover the artifact.
HEARTBEAT_EXCLUDED = frozenset({"adjacency"})


class ArtifactLedger:
    """Incrementally-maintained digest of one artifact's (id -> payload)
    map. Callers hold the owning RegionIntegrity's lock."""

    __slots__ = ("tag", "digest", "version", "_fp")

    def __init__(self, tag: str):
        self.tag = tag
        self.digest = SetDigest()
        #: bumped on every mutation — the scrub uses it to detect a write
        #: racing the chunked recompute (raced pass = retry, not mismatch)
        self.version = 0
        self._fp: Dict[int, int] = {}

    def update(self, ids: np.ndarray, payload: np.ndarray) -> None:
        self.update_fps(ids, row_fingerprints(self.tag, ids, payload))

    def update_fps(self, ids: np.ndarray, fps: np.ndarray) -> None:
        olds: List[int] = []
        for i, fp in zip(np.asarray(ids, np.int64).tolist(), fps.tolist()):
            prev = self._fp.get(i)
            if prev is not None:
                olds.append(prev)
            self._fp[i] = fp
        if olds:
            self.digest.remove(np.asarray(olds, np.uint64))
        self.digest.add(fps)
        self.version += 1

    def remove(self, ids: np.ndarray) -> None:
        olds = []
        for i in np.asarray(ids, np.int64).tolist():
            prev = self._fp.pop(i, None)
            if prev is not None:
                olds.append(prev)
        if olds:
            self.digest.remove(np.asarray(olds, np.uint64))
            self.version += 1

    def reset(self) -> None:
        self._fp.clear()
        self.digest = SetDigest()
        self.version += 1

    def count(self) -> int:
        return self.digest.count


class RegionIntegrity:
    """Per-index ledger set: one ArtifactLedger per artifact plus the
    raft applied index the digests correspond to."""

    def __init__(self, region_id: int):
        self.region_id = region_id
        self.lock = threading.Lock()
        self.artifacts: Dict[str, ArtifactLedger] = {}
        self.applied_index = 0
        #: bumped BEFORE each write path touches device state (the ledger
        #: folds after the device mutation, so per-artifact versions alone
        #: cannot see a write whose fold hasn't landed yet — the scrub
        #: checks this counter too and marks such passes raced)
        self.mutations = 0
        #: write paths IN FLIGHT right now (begin/end bracketed): while
        #: nonzero, device state may be ahead of the ledger and the
        #: applied-index tag may be pending — the scrub classifies
        #: overlapping passes as raced, and the heartbeat withholds the
        #: digest vector for the beat (no evidence beats torn evidence)
        self.pending = 0

    def begin_mutation(self) -> None:
        with self.lock:
            self.mutations += 1
            self.pending += 1

    def end_mutation(self) -> None:
        with self.lock:
            self.pending = max(0, self.pending - 1)

    def heartbeat_view(self) -> Tuple[int, str]:
        """(applied_index, digests_json) read ATOMICALLY: while any write
        is in flight the digest vector is withheld — between a ledger
        fold and its applied-index tag the pair would be torn, and the
        coordinator would read a healthy replica as DIVERGED."""
        with self.lock:
            applied = self.applied_index
            if self.pending:
                return applied, ""
            arts = {
                name: led.digest.hex()
                for name, led in sorted(self.artifacts.items())
                if name not in HEARTBEAT_EXCLUDED
            }
        if not arts:
            return applied, ""
        return applied, json.dumps(arts, sort_keys=True,
                                   separators=(",", ":"))

    def ledger(self, artifact: str) -> ArtifactLedger:
        led = self.artifacts.get(artifact)
        if led is None:
            led = self.artifacts[artifact] = ArtifactLedger(artifact)
        return led

    def update(self, artifact: str, ids: np.ndarray,
               payload: np.ndarray) -> None:
        with self.lock:
            self.ledger(artifact).update(ids, payload)

    def remove(self, artifact: str, ids: np.ndarray) -> None:
        with self.lock:
            led = self.artifacts.get(artifact)
            if led is not None:
                led.remove(ids)

    def drop(self, artifact: str) -> None:
        with self.lock:
            self.artifacts.pop(artifact, None)

    def report(self) -> Dict[str, Any]:
        with self.lock:
            return {
                "applied_index": self.applied_index,
                "artifacts": {
                    name: led.digest.hex()
                    for name, led in sorted(self.artifacts.items())
                },
            }



def diverged_artifacts(a_json: str, b_json: str) -> List[str]:
    """Artifact names present in BOTH digest vectors with different
    digests (the coordinator's replica-compare primitive; artifacts only
    one side reports — e.g. a mirror not built yet — are not divergence)."""
    try:
        a, b = json.loads(a_json or "{}"), json.loads(b_json or "{}")
    except ValueError:
        return []
    return sorted(k for k in set(a) & set(b) if a[k] != b[k])


# ---------------------------------------------------------------------------
# device-state readers: (ids, payload) chunks per artifact, read back from
# the arrays the kernels actually serve from. Shared by the scrub (compare)
# and the restore/primer paths (rebuild the ledger from state).
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    """A device read-back in canonical host bytes (bf16 as its 16-bit
    patterns); a host store's numpy rows pass through."""
    if isinstance(x, np.ndarray):
        return x
    from dingo_tpu_torch.index.slot_store import host_bits

    return host_bits(x)


class ReadStats:
    """Device read-back accounting of the current thread's scrub or
    restore pass: bytes copied to the host and the longest hold of a
    store's device lock (the stall a concurrent search dispatch can see)."""

    def __init__(self):
        self.d2h_bytes = 0
        self.max_hold_ms = 0.0


_tls = threading.local()


def read_stats() -> ReadStats:
    """This thread's read-back accounting; reset by ``reset_read_stats``."""
    st = getattr(_tls, "stats", None)
    if st is None:
        st = _tls.stats = ReadStats()
    return st


def reset_read_stats() -> ReadStats:
    _tls.stats = ReadStats()
    return _tls.stats


def _pinned(nbytes: int):
    """This thread's reusable pinned host buffer of at least `nbytes`."""
    import torch

    buf = getattr(_tls, "pinned", None)
    if buf is None or buf.numel() < nbytes:
        buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        _tls.pinned = buf
    return buf


def _read(store, fetch) -> np.ndarray:
    """One chunk's read-back under the store's device lock, accounted. A
    CUDA chunk copies into a pinned buffer under the lock (a pageable
    copy runs at a fraction of the bus rate and would hold the lock that
    much longer) and out of it after the lock is released."""
    probe = fetch()
    on_card = not isinstance(probe, np.ndarray) and probe.is_cuda
    if on_card:
        # size the pinned buffer before the lock (its first allocation is
        # a page-locking host allocation, far slower than the copy)
        _pinned(probe.numel() * probe.element_size())
    probe = None
    with store.device_lock:
        t0 = time.perf_counter()
        src = fetch()
        staged = None
        if not on_card:
            out = _host(src)
        else:
            src = src.contiguous()
            nbytes = src.numel() * src.element_size()
            staged = _pinned(nbytes)[:nbytes].view(src.dtype).view(
                src.shape)
            staged.copy_(src)
        held_ms = (time.perf_counter() - t0) * 1e3
    if staged is not None:
        out = _host(staged).copy()
    st = read_stats()
    st.max_hold_ms = max(st.max_hold_ms, held_ms)
    st.d2h_bytes += int(out.nbytes)
    return out


def _iter_rows(index, chunk: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    store = index.store
    for lo in range(0, store.capacity, chunk):
        hi = min(store.capacity, lo + chunk)
        ids = store.ids_by_slot[lo:hi]
        live = ids >= 0
        if not live.any():
            continue
        vals = _read(store, lambda: store.vecs[lo:hi])
        yield ids[live], vals[live]


def _iter_blocked(index, chunk: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    store = index.store
    for lo in range(0, store.capacity, chunk):
        hi = min(store.capacity, lo + chunk)
        ids = store.ids_by_slot[lo:hi]
        live = ids >= 0
        if not live.any():
            continue
        blk = _read(store, lambda: store.vecs_blk[:, lo:hi, :])
        # [nblk, n, dblk] -> per-slot canonical row bytes (the blocked
        # transform is a per-row reshape, so values re-concatenate to the
        # original row exactly)
        rows = np.transpose(blk, (1, 0, 2)).reshape(hi - lo, -1)
        yield ids[live], rows[live]


def _iter_adjacency(index, chunk: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    store = index.store
    for lo in range(0, store.capacity, chunk):
        hi = min(store.capacity, lo + chunk)
        ids = store.ids_by_slot[lo:hi]
        live = ids >= 0
        if not live.any():
            continue
        adj = _read(store, lambda: store.adj[lo:hi])
        # slot-space neighbors translate to EXTERNAL ids so the digest is
        # invariant under slot renumbering (snapshot load reassigns slots)
        yield ids[live], store.ids_of_slots(adj[live])


def _iter_ivf_buckets(index, chunk: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Per-row coarse-list assignment as arranged on DEVICE: reads the
    view's bucket_slot array back (in bucket-axis chunks so each
    device_lock hold stays bounded like the other readers) and pairs
    each placed slot with its bucket's coarse list."""
    view = index._view
    store = index.store
    nbuckets = int(view.bucket_slot.shape[0])
    cap = max(1, int(view.cap_list))
    step = max(1, chunk // cap)
    for lo in range(0, nbuckets, step):
        hi = min(nbuckets, lo + step)
        bucket_slot = _read(store, lambda: view.bucket_slot[lo:hi])
        valid = bucket_slot >= 0
        if not valid.any():
            continue
        coarse = np.broadcast_to(
            view.bucket_coarse_h[lo:hi, None], bucket_slot.shape
        )
        ids = store.ids_of_slots(bucket_slot[valid])
        yield ids, np.ascontiguousarray(coarse[valid], np.int32)


def _iter_assign(index, chunk: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Host assignment truth (_assign_h) — the ledger/restore source for
    ivf_buckets; the scrub compares it against _iter_ivf_buckets."""
    store = index.store
    ids_all = store.ids_by_slot
    live = np.flatnonzero(ids_all >= 0)
    if len(live):
        assign = index._assign_h[live].astype(np.int32)
        placed = assign >= 0
        yield ids_all[live][placed], assign[placed]


def _iter_pq_codes(index, chunk: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    store = index.store
    for lo in range(0, store.capacity, chunk):
        hi = min(store.capacity, lo + chunk)
        ids = store.ids_by_slot[lo:hi]
        live = ids >= 0
        if not live.any():
            continue
        codes = _read(store, lambda: index._codes[lo:hi])
        yield ids[live], codes[live]


def _digest_chunks(tag: str, chunks) -> Tuple[SetDigest, Dict[int, int], int]:
    """(digest, id->fp map, slots) over a chunk stream."""
    dig = SetDigest()
    fp_map: Dict[int, int] = {}
    n = 0
    for ids, payload in chunks:
        fps = row_fingerprints(tag, ids, payload)
        dig.add(fps)
        fp_map.update(zip(np.asarray(ids, np.int64).tolist(), fps.tolist()))
        n += len(ids)
    return dig, fp_map, n


class IntegrityPlane:
    def __init__(self, registry=METRICS):
        self.registry = registry
        self._lock = threading.Lock()
        #: index object -> RegionIntegrity (weak: a swapped-out index takes
        #: its ledger with it; the fresh index starts clean)
        self._ledgers: "weakref.WeakKeyDictionary" = (
            weakref.WeakKeyDictionary()
        )
        #: region id -> scrub status (verdicts survive index swaps so the
        #: heartbeat keeps reporting a mismatch until a clean pass clears it)
        self._status: Dict[int, Dict[str, Any]] = {}

    # ---- gating ------------------------------------------------------------
    @staticmethod
    def enabled() -> bool:
        try:
            return bool(FLAGS.get("integrity_enabled"))
        except KeyError:  # registry not populated (unit contexts)
            return False

    # ---- ledger access -----------------------------------------------------
    def ledger(self, index) -> RegionIntegrity:
        with self._lock:
            led = self._ledgers.get(index)
            if led is None:
                led = self._ledgers[index] = RegionIntegrity(index.id)
            return led

    def peek(self, index) -> Optional[RegionIntegrity]:
        if index is None:
            return None
        with self._lock:
            return self._ledgers.get(index)

    def tracking(self, index) -> bool:
        """True while writes must keep folding into this index's ledger.
        Only ledger CREATION is gated on integrity.enabled — an existing
        ledger keeps tracking through a momentary flag toggle, because a
        ledger frozen across untracked writes would read as corruption
        forever after (the quality mirror's toggle discipline)."""
        return self.enabled() or self.peek(index) is not None

    def tag_applied(self, index, log_id: int) -> None:
        """Stamp the ledger with the raft applied index its digests now
        correspond to (wrapper.add/delete call this right after advancing
        apply_log_id, still under the wrapper lock — so a heartbeat never
        reads a digest tagged with an index it doesn't describe)."""
        led = self.peek(index)
        if led is not None:
            led.applied_index = int(log_id)

    # ---- write-path hooks (called from the index classes) ------------------
    def note_mutation_begin(self, index) -> None:
        """Called at the TOP of every index write path, BEFORE any device
        state mutates: the ledger fold lands after the device write, so a
        scrub overlapping that window would otherwise read fresh bytes
        against a stale ledger and report phantom corruption — this
        counter lets it classify the pass as raced instead."""
        if not self.tracking(index):
            return
        self.ledger(index).begin_mutation()

    def note_mutation_end(self, index) -> None:
        led = self.peek(index)
        if led is not None:
            led.end_mutation()

    def note_write(self, index, artifact: str, ids: np.ndarray,
                   payload: np.ndarray) -> None:
        self.note_write_tags(index, (artifact,), ids, payload)

    def note_write_tags(self, index, artifacts, ids: np.ndarray,
                        payload: np.ndarray) -> None:
        """note_write of one payload under several artifacts (the rows and
        the blocked mirror of a write hold the same bytes), hashing the
        payload once."""
        if len(ids) == 0 or not self.tracking(index):
            return
        fps = row_fingerprints_tags(artifacts, ids, payload)
        led = self.ledger(index)
        for artifact in artifacts:
            with led.lock:
                led.ledger(artifact).update_fps(ids, fps[artifact])
            self.registry.counter(
                "consistency.digest_updates", region_id=index.id).add(1)

    def note_delete(self, index, ids: np.ndarray) -> None:
        if len(ids) == 0:
            return
        led = self.peek(index)
        if led is None:
            return
        with led.lock:
            for art in list(led.artifacts):
                led.artifacts[art].remove(ids)

    def reset_artifact(self, index, artifact: str) -> None:
        """Clear one artifact's ledger IN PLACE (full-swap paths like the
        adjacency install): ArtifactLedger.reset() bumps the version
        counter, so a scrub pass that captured the pre-swap digest
        classifies as raced — dropping the ledger object instead would
        recreate it at version 1 and make the swap invisible."""
        led = self.peek(index)
        if led is not None:
            with led.lock:
                art = led.artifacts.get(artifact)
                if art is not None:
                    art.reset()

    # ---- reporting ---------------------------------------------------------
    def region_report(self, index,
                      region_id: Optional[int] = None
                      ) -> Tuple[int, str, bool]:
        """(applied_index, digests_json, scrub_mismatch) for the heartbeat
        snapshot; empty digests when the plane is off or unprimed."""
        led = self.peek(index)
        applied, digests = 0, ""
        if led is not None:
            applied, digests = led.heartbeat_view()
        if region_id is None:
            region_id = getattr(index, "id", 0) if index is not None else 0
        st = self._status.get(region_id)
        return applied, digests, bool(st and st.get("mismatch"))

    def last_verified_ms(self, region_id: int) -> int:
        st = self._status.get(region_id)
        return int(st.get("last_verified_ms", 0)) if st else 0

    def forget_region(self, region_id: int) -> None:
        with self._lock:
            self._status.pop(region_id, None)

    # ---- artifact discovery ------------------------------------------------
    def _state_arms(self, index) -> Dict[str, Any]:
        """Artifact -> chunk-iterator factory for everything the index's
        CURRENT device/host state materializes. Adjacency and bucket arms
        only appear while their mirror/view is in sync with the store —
        a pending lazy re-export is staleness, not corruption."""
        arms: Dict[str, Any] = {}
        store = getattr(index, "store", None)
        if store is None or getattr(store, "ids_by_slot", None) is None:
            return arms
        arms["rows"] = _iter_rows
        if getattr(store, "vecs_blk", None) is not None:
            arms["blocked"] = _iter_blocked
        if getattr(store, "adj", None) is not None:
            fresh = getattr(index, "adjacency_in_sync", None)
            if fresh is None or fresh():
                arms["adjacency"] = _iter_adjacency
        if getattr(index, "_view", None) is not None \
                and not getattr(index, "_view_dirty", True):
            arms["ivf_buckets"] = _iter_ivf_buckets
        if getattr(index, "_codes", None) is not None:
            arms["pq_codes"] = _iter_pq_codes
        return arms

    # ---- restore / primer --------------------------------------------------
    def rebuild_from_index(self, index) -> Dict[str, str]:
        """Recompute every artifact ledger from the index's live state
        (snapshot load, scrub priming, pre-save reconciliation). Returns
        {artifact: digest hex}."""
        led = self.ledger(index)
        out: Dict[str, str] = {}
        arms = self._state_arms(index)
        # ivf bucket ledger rebuilds from the assignment TRUTH (_assign_h)
        # so a restore can verify before any view exists
        if getattr(index, "_assign_h", None) is not None \
                and getattr(index, "is_trained", lambda: False)():
            arms["ivf_buckets"] = _iter_assign
        for artifact, it in arms.items():
            dig, fp_map, _ = _digest_chunks(
                artifact, it(index, SCRUB_CHUNK)
            )
            with led.lock:
                art = led.ledger(artifact)
                art.reset()
                art._fp = fp_map
                art.digest = dig
            out[artifact] = dig.hex()
        # drop ledger entries whose backing state vanished (e.g. a load
        # into an untrained index: no codes, no buckets)
        with led.lock:
            for name in list(led.artifacts):
                if name not in arms:
                    del led.artifacts[name]
        return out

    def snapshot_artifacts(self, index) -> Dict[str, str]:
        """Digest vector persisted in snapshot meta.json. Reconciles the
        ledger against live state first when it is missing or stale (e.g.
        the index was populated while the plane was disabled), so the
        persisted vector always describes the bytes being saved."""
        if not self.enabled():
            return {}
        led = self.peek(index)
        store = getattr(index, "store", None)
        live = len(store) if store is not None else 0
        rows = None
        if led is not None:
            with led.lock:
                art = led.artifacts.get("rows")
                rows = art.count() if art is not None else None
        if rows is None or rows != live:
            self.rebuild_from_index(index)
            led = self.ledger(index)
        rep = led.report()["artifacts"]
        # only artifacts whose backing state is CURRENT may persist: a
        # stale adjacency ledger (mirror pending re-export) must not gate
        # the restore against bytes the snapshot never carried
        valid = set(self._state_arms(index))
        if getattr(index, "_assign_h", None) is not None \
                and getattr(index, "is_trained", lambda: False)():
            valid.add("ivf_buckets")
        return {k: v for k, v in rep.items()
                if k in SNAPSHOT_ARTIFACTS and k in valid}

    def verify_restore(self, index, meta_integrity) -> None:
        """Recompute digests from the just-restored state and compare with
        the snapshot's persisted vector; raises SnapshotCorruption on any
        mismatch (the manager then falls back to an engine rebuild)."""
        if not self.enabled():
            return
        actual = self.rebuild_from_index(index)
        if not meta_integrity:
            return
        bad = {}
        for artifact, expected in meta_integrity.items():
            got = actual.get(artifact)
            if got is not None and got != expected:
                bad[artifact] = {"expected": expected, "actual": got}
        if bad:
            self.registry.counter(
                "consistency.restore_mismatches", region_id=index.id
            ).add(len(bad))
            from dingo_tpu_torch.index.base import SnapshotCorruption

            raise SnapshotCorruption(
                f"restored index {index.id} digests diverge from "
                f"snapshot meta: {bad}"
            )

    # ---- scrub -------------------------------------------------------------
    def scrub_index(self, index, chunk: int = SCRUB_CHUNK
                    ) -> Dict[str, Dict[str, Any]]:
        """Full-state digest recompute vs the incremental ledger for one
        index. Chunked device reads under store.device_lock (never one
        long hold); a ledger mutation racing the pass marks the artifact
        'raced' instead of mismatched. Returns per-artifact verdicts and
        feeds the consistency.* metrics family + flight recorder."""
        rid = index.id
        results: Dict[str, Dict[str, Any]] = {}
        led = self.ledger(index)
        t0 = time.perf_counter()
        arms = self._state_arms(index)
        checked_slots = 0
        costs: Dict[str, Dict[str, float]] = {}
        for artifact, it in arms.items():
            with led.lock:
                art = led.artifacts.get(artifact)
                before = (art.version, art.digest.copy()) if art else None
                muts_before = led.mutations
                pending_before = led.pending
            ta = time.perf_counter()
            rs = reset_read_stats()
            actual, fp_map, n = _digest_chunks(artifact, it(index, chunk))
            checked_slots += n
            # the pass's cost: wall seconds, bytes read back, and the
            # longest device-lock hold (the port's addition; the verdict
            # keys are the JAX package's)
            costs[artifact] = {
                "seconds": time.perf_counter() - ta,
                "d2h_bytes": rs.d2h_bytes,
                "max_lock_ms": rs.max_hold_ms,
            }
            with led.lock:
                art2 = led.artifacts.get(artifact)
                # raced on ANY signal: a folded ledger mutation (artifact
                # version), a write that touched device state but hasn't
                # folded yet (region mutation counter, bumped before any
                # device write begins), or a write IN FLIGHT at either
                # endpoint of the pass (pending bracket — covers a write
                # that began before the capture and folds after the check)
                raced = (
                    pending_before > 0
                    or led.pending > 0
                    or led.mutations != muts_before
                    or (before is not None and (
                        art2 is None or art2.version != before[0]))
                )
                expected = (art2.digest.copy() if art2
                            else (before[1] if before else None))
                if before is None and not raced:
                    # state exists but was never ledgered (plane enabled
                    # mid-life): prime the ledger from this clean pass
                    art = led.ledger(artifact)
                    art._fp = fp_map
                    art.digest = actual
            if before is None and not raced:
                results[artifact] = {"status": "primed", "slots": n,
                                     "digest": actual.hex()}
                continue
            if raced:
                results[artifact] = {"status": "raced", "slots": n}
                continue
            if actual == expected:
                results[artifact] = {"status": "ok", "slots": n,
                                     "digest": actual.hex()}
            else:
                results[artifact] = {
                    "status": "mismatch", "slots": n,
                    "expected": expected.hex(), "actual": actual.hex(),
                }
        for artifact, c in costs.items():
            results[artifact].update(c)
        self._finish_scrub(rid, results, time.perf_counter() - t0)
        return results

    def _finish_scrub(self, rid: int, results, dur_s: float) -> None:
        reg = self.registry
        reg.counter("consistency.scrub_runs", region_id=rid).add(1)
        reg.counter("consistency.scrub_slots", region_id=rid).add(
            sum(r.get("slots", 0) for r in results.values())
        )
        reg.latency("consistency.scrub_ms", region_id=rid).observe_us(
            dur_s * 1e6
        )
        bad = {a: r for a, r in results.items()
               if r["status"] == "mismatch"}
        clean = bool(results) and all(
            r["status"] in ("ok", "primed") for r in results.values()
        )
        now_ms = int(time.time() * 1000)
        with self._lock:
            st = self._status.setdefault(rid, {})
            if bad:
                st["mismatch"] = True
                st["artifacts"] = sorted(bad)
            elif clean:
                st["mismatch"] = False
                st["artifacts"] = []
                st["last_verified_ms"] = now_ms
        if bad or clean:
            # only DECISIVE passes move the gauge: a raced/empty pass
            # after a confirmed mismatch must not flip a dashboard back
            # to healthy while the heartbeat still says CORRUPT
            reg.gauge("consistency.scrub_ok", region_id=rid).set(
                0.0 if bad else 1.0
            )
        if bad:
            for artifact, r in bad.items():
                reg.counter(
                    "consistency.scrub_mismatches", region_id=rid,
                    labels={"artifact": artifact},
                ).add(1)
                _log.error(
                    "integrity scrub MISMATCH region=%d artifact=%s "
                    "expected=%s actual=%s", rid, artifact,
                    r["expected"], r["actual"],
                )
            if bool(FLAGS.get("integrity_flight_on_divergence")):
                from dingo_tpu_torch.obs.flight import FLIGHT

                FLIGHT.trigger(
                    "corruption",
                    name=f"scrub:{','.join(sorted(bad))}",
                    region_id=rid,
                    extra={"artifacts": bad},
                )

    def scrub_node(self, node) -> Dict[int, Dict[str, Dict[str, Any]]]:
        """One scrub sweep over every region's serving index (the
        consistency_scrub crontab body; best-effort per region)."""
        out: Dict[int, Dict[str, Dict[str, Any]]] = {}
        for region in node.meta.get_all_regions():
            wrapper = region.vector_index_wrapper
            idx = wrapper.own_index if wrapper is not None else None
            if idx is None:
                continue
            try:
                out[region.id] = self.scrub_index(idx)
            except Exception:  # noqa: BLE001 — index mid-swap/build
                _log.exception("scrub failed for region %d", region.id)
        now_ms = int(time.time() * 1000)
        for rid in out:
            last = self.last_verified_ms(rid)
            self.registry.gauge(
                "consistency.digest_age_s", region_id=rid
            ).set((now_ms - last) / 1000.0 if last else -1.0)
        return out

    # ---- flight capture ----------------------------------------------------
    def state(self) -> Dict[str, Any]:
        """Per-region digest vectors + scrub verdicts for flight bundles
        (resolved through live ledgers; weakly-held indexes may be gone)."""
        regions: Dict[int, Any] = {}
        with self._lock:
            items = list(self._ledgers.items())
            status = {r: dict(s) for r, s in self._status.items()}
        for index, led in items:
            rep = led.report()
            if rep["artifacts"]:
                regions[led.region_id] = rep
        return {"regions": regions, "scrub_status": status,
                "sampled_at": time.time()}

    def clear(self) -> None:
        with self._lock:
            self._ledgers = weakref.WeakKeyDictionary()
            self._status.clear()


INTEGRITY = IntegrityPlane()


class IntegrityScrubRunner:
    """consistency_scrub crontab body: hot-gated on integrity.enabled,
    re-applies a hot-changed integrity.scrub_interval_s per tick (the
    QualityTunerRunner pattern), and runs the sweep on its own worker so
    a long chunked scrub never stalls the shared crontab thread."""

    def __init__(self, node, crontab=None):
        self.node = node
        self._crontab = crontab
        self._worker: Optional[threading.Thread] = None
        self.sweeps = 0

    def tick(self) -> None:
        if self._crontab is not None:
            self._crontab.set_interval(
                "consistency_scrub",
                float(FLAGS.get("integrity_scrub_interval_s")),
            )
        if not INTEGRITY.enabled():
            return
        t = self._worker
        if t is not None and t.is_alive():
            return

        def work():
            INTEGRITY.scrub_node(self.node)
            self.sweeps += 1
            # recovery actions ride the same maintenance lane: rebuild
            # scrub-confirmed corrupt indexes from the engine, and
            # re-materialize device-degraded regions at lower precision
            # (index/recovery.py — fault-domain hardening)
            from dingo_tpu_torch.index.recovery import RECOVERY

            try:
                RECOVERY.run_rematerializations(self.node)
            except Exception:  # noqa: BLE001 — next tick retries
                _log.exception("device recovery sweep failed")

        t = threading.Thread(target=work, name="consistency_scrub",
                             daemon=True)
        self._worker = t
        t.start()
