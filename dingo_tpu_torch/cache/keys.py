"""Cache key derivation (port of dingo_tpu/cache/keys.py): fingerprints
binding a query row to exactly the device state and resolved parameters
that would answer it.

A result-cache entry is correct to serve iff a fresh dispatch would
return byte-identical rows. Three things determine that reply on the
plain search path:

- the raw query bytes (the kernel input),
- the resolved search parameters (topn, nprobe/ef, metric-relevant
  kwargs — the same canonicalized scalar items the coalescer keys on),
- the device state, summarized losslessly for this purpose by
  ``SlotStore.mutation_version`` (index/slot_store.py): every put /
  remove / growth bumps it, and every [capacity]-shaped cached artifact
  in the repo already keys on it (HNSW filter masks, the adjacency
  mirror). FilterSpec-bearing searches additionally fold the filter
  fingerprint — the plain path serves filter-free, so the empty
  fingerprint is the common case.

Fingerprints ride ``ops/digest.py``'s row-fingerprint primitive
(odd-coefficient byte projection xor splitmix64), the machinery the
state-integrity plane trusts for corruption detection: collisions are the
2^-64 class of risk already accepted there, and the values equal the JAX
package's bit for bit.

The semantic tier quantizes the query with the sq8 codec (ops/sq.py) first
(per-region params trained lazily on observed queries), so near-identical
queries that round to the same uint8 codes share a fingerprint. Exact and
semantic namespaces are disjoint by tag.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np

from dingo_tpu_torch.ops.digest import row_fingerprints, splitmix64, tag_seed
from dingo_tpu_torch.ops.sq import SqParams, sq_encode, sq_train

#: rows of observed queries the lazy per-region semantic codec trains on
SEMANTIC_TRAIN_ROWS = 256


def params_seed(topn: int, kw_items: Tuple,
                filter_fp: bytes = b"") -> np.uint64:
    """One uint64 summarizing the resolved search parameters + filter.

    `kw_items` is the coalescer key's canonical scalar-kwarg tuple
    (sorted (name, value) pairs) — parameter-identical searches, and only
    those, share a seed. The filter fingerprint (FilterSpec.fingerprint,
    blake2b-16) folds in as hex; the plain path passes b""."""
    return tag_seed(
        f"cache.params|{int(topn)}|{kw_items!r}|{filter_fp.hex()}"
    )


def query_fingerprints(queries: np.ndarray, seed: np.uint64) -> np.ndarray:
    """[n] uint64 fingerprints over raw query-row bytes under `seed`.

    Rows digest over their canonical C-order float32 bytes — the exact
    bytes the kernel would scan — so the same VALUES always fingerprint
    identically regardless of upstream array layout."""
    q = np.ascontiguousarray(np.asarray(queries, np.float32))
    if q.ndim != 2:
        raise ValueError(f"query_fingerprints needs [n, d], got {q.shape}")
    fps = row_fingerprints(
        "cache.query", np.zeros(len(q), np.int64), q
    )
    return splitmix64(fps ^ np.uint64(seed))


def semantic_fingerprints(codes: np.ndarray, seed: np.uint64) -> np.ndarray:
    """[n] uint64 fingerprints over sq8 code rows — a distinct namespace
    from the exact tier (different tag), same seed binding."""
    c = np.ascontiguousarray(np.asarray(codes, np.uint8))
    fps = row_fingerprints(
        "cache.semantic", np.zeros(len(c), np.int64), c
    )
    return splitmix64(fps ^ np.uint64(seed))


class SemanticCodec:
    """Per-region sq8 quantizer for query rows, trained lazily.

    The first SEMANTIC_TRAIN_ROWS observed query rows accumulate on the
    host; once enough arrive, sq_train fits the per-dim affine codec and
    encode() starts answering. Until trained (or after reset) encode()
    returns None and the semantic tier simply doesn't serve — no
    approximate hit is ever minted from an unfitted codec."""

    def __init__(self):
        self._lock = threading.Lock()
        self._params: Dict[int, SqParams] = {}
        self._pending: Dict[int, list] = {}

    def observe(self, region_id: int, queries: np.ndarray) -> None:
        """Accumulate training rows until the codec fits."""
        with self._lock:
            if region_id in self._params:
                return
            buf = self._pending.setdefault(region_id, [])
            buf.append(np.array(queries, np.float32, copy=True))
            rows = sum(len(b) for b in buf)
            if rows < SEMANTIC_TRAIN_ROWS:
                return
            sample = np.concatenate(buf, axis=0)[:SEMANTIC_TRAIN_ROWS]
            self._params[region_id] = sq_train(sample)
            del self._pending[region_id]

    def encode(self, region_id: int,
               queries: np.ndarray) -> Optional[np.ndarray]:
        """uint8 codes [n, d], or None while the codec is untrained or
        the query dimension moved (region recreated at a new dim)."""
        with self._lock:
            params = self._params.get(region_id)
        if params is None:
            return None
        q = np.asarray(queries, np.float32)
        if q.ndim != 2 or q.shape[1] != params.dim:
            return None
        return sq_encode(q, params)

    def trained(self, region_id: int) -> bool:
        with self._lock:
            return region_id in self._params

    def forget_region(self, region_id: int) -> None:
        with self._lock:
            self._params.pop(region_id, None)
            self._pending.pop(region_id, None)

    def reset(self) -> None:
        with self._lock:
            self._params.clear()
            self._pending.clear()
