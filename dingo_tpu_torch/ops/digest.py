"""Order-invariant incremental set digests for device-state integrity
(port of dingo_tpu/ops/digest.py: the same fingerprints and the same
``hex()`` for the same ids and payload bytes).

The state-integrity plane (obs/integrity.py) needs to answer "do two
replicas of a region — or a snapshot and its restore, or the incremental
ledger and the actual device arrays — hold the same data" without ever
hashing the whole index on the hot path. The construction here makes the
digest *maintainable*: a write batch folds in O(batch) host work, and the
digest of the full set is always available in O(1).

Per-row fingerprint (uint64):

    proj  = sum_i bytes[i] * coeff[i]    (mod 2^64; coeff = fixed seeded
                                          odd uint64 stream)
    fp    = splitmix64(proj ^ splitmix64(id) ^ tag_seed)

- coeff[i] is ODD, so a single flipped byte (delta in [-255, 255], != 0)
  always changes proj — no power of two <= 2^8 divides 2^64/coeff[i].
- the id mixes NONLINEARLY (through splitmix64), so swapping two rows'
  payloads changes both fingerprints: a linear id term would cancel in
  the aggregate sum.
- tag_seed separates artifacts: the same bytes digested as "rows" and as
  "blocked" produce unrelated fingerprints.

Aggregate (SetDigest): component-wise modular sums of (fp,
splitmix64(fp ^ LANE2)) plus the element count. Sums are add/remove-
homomorphic — put adds a term, tombstone subtracts it — and order-
invariant, so replicas that applied the same writes in different slot
orders agree, and an incrementally-maintained ledger can be checked
against a from-scratch recompute (the corruption scrub).

Collision notes: this is an integrity check against silent corruption
and bookkeeping bugs, not an adversarial MAC. A single-element change is
ALWAYS detected (the per-fp guarantees above); multi-element collisions
require two independent 64-bit lanes to cancel simultaneously.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Optional

import numpy as np

_U64 = np.uint64
_GOLDEN = _U64(0x9E3779B97F4A7C15)
_MIX1 = _U64(0xBF58476D1CE4E5B9)
_MIX2 = _U64(0x94D049BB133111EB)
_LANE2 = _U64(0xD6E8FEB86659FD93)

#: projection coefficients are generated lazily per payload width and
#: cached (a fixed seed, so every process derives the same stream)
_COEFF_SEED = 0xD1E657
_coeff_cache: Dict[int, np.ndarray] = {}


def _coeffs(nbytes: int) -> np.ndarray:
    """[nbytes] uint64 odd projection coefficients (fixed seeded stream)."""
    have = _coeff_cache.get(0)
    if have is None or len(have) < nbytes:
        n = max(4096, 1 << int(nbytes - 1).bit_length() if nbytes else 4096)
        rng = np.random.default_rng(_COEFF_SEED)
        have = rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
        have = (have << _U64(1)) | _U64(1)   # force odd
        _coeff_cache[0] = have
    return have[:nbytes]


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer over uint64 (wraps mod 2^64)."""
    z = x.astype(np.uint64, copy=True)
    z += _GOLDEN
    z = (z ^ (z >> _U64(30))) * _MIX1
    z = (z ^ (z >> _U64(27))) * _MIX2
    return z ^ (z >> _U64(31))


def tag_seed(tag: str) -> np.uint64:
    """Stable per-artifact domain-separation seed."""
    h = hashlib.blake2b(tag.encode("utf-8"), digest_size=8).digest()
    return _U64(int.from_bytes(h, "little"))


def _payload_bytes(payload: np.ndarray) -> np.ndarray:
    """[n, ...] fixed-width payload -> [n, L] uint8 canonical bytes."""
    arr = np.ascontiguousarray(payload)
    if arr.ndim == 1:
        arr = arr[:, None]
    elif arr.ndim > 2:
        arr = arr.reshape(arr.shape[0], -1)
    return arr.view(np.uint8).reshape(arr.shape[0], -1)


def row_fingerprints(tag: str, ids: np.ndarray,
                     payload: np.ndarray) -> np.ndarray:
    """[n] uint64 fingerprints binding (id, payload row) under `tag`.

    `payload` is any fixed-width array [n, ...]; rows are digested over
    their canonical C-order bytes, so the same VALUES in the same dtype
    always fingerprint identically regardless of the device layout they
    were read back from."""
    return row_fingerprints_tags((tag,), ids, payload)[tag]


def row_fingerprints_tags(tags, ids: np.ndarray,
                          payload: np.ndarray) -> Dict[str, np.ndarray]:
    """``row_fingerprints`` of the same (ids, payload) under several tags
    at the cost of one: the projection does not depend on the tag (the
    rows and blocked artifacts of a write digest the same bytes)."""
    ids = np.asarray(ids)
    if len(ids) == 0:
        return {t: np.empty(0, np.uint64) for t in tags}
    raw = _payload_bytes(payload)
    if len(raw) != len(ids):
        raise ValueError(f"ids/payload length mismatch "
                         f"({len(ids)} vs {len(raw)})")
    base = _project(raw) ^ splitmix64(ids.astype(np.int64).view(np.uint64))
    return {t: splitmix64(base ^ tag_seed(t)) for t in tags}


#: the projection's coefficients split into 4-bit limbs: float32 [L, 16]
#: by width (limb j of coefficient i at [i, j])
_limb_cache: Dict[int, np.ndarray] = {}
_LIMB_BITS = 4
_NLIMBS = 64 // _LIMB_BITS
#: bytes a row per float32 product: every partial sum of a column block
#: stays below _COLS * 255 * 15 < 2^24, an integer float32 holds exactly
_COLS = 4096


def _limbs(nbytes: int) -> np.ndarray:
    have = _limb_cache.get(nbytes)
    if have is None:
        c = _coeffs(nbytes)
        mask = _U64((1 << _LIMB_BITS) - 1)
        have = np.stack(
            [((c >> _U64(_LIMB_BITS * j)) & mask).astype(np.float32)
             for j in range(_NLIMBS)], axis=1)
        _limb_cache[nbytes] = have
    return have


def _project(raw: np.ndarray) -> np.ndarray:
    """[n, L] uint8 -> [n] uint64 coefficient projection mod 2^64, the
    JAX package's values computed another way: each coefficient splits
    into sixteen 4-bit limbs, and S_j = raw @ limb_j is a float32 product
    over blocks of at most 4096 columns, whose every partial sum is an
    integer below 4096 * 255 * 15 < 2^24, so it is exact in any summation
    order. proj = sum over blocks and j of S_j << 4j wraps mod 2^64 as
    the reference's uint64 sum does. A BLAS product instead of a widened
    uint64 temporary: several times the rows/s of the JAX package's block
    loop. Rows go in chunks that bound the float32 temporary to ~16 MB."""
    n, L = raw.shape
    limbs = _limbs(L)
    shifts = (_U64(_LIMB_BITS) * np.arange(_NLIMBS, dtype=np.uint64))
    proj = np.zeros(n, np.uint64)
    step = max(1, (1 << 22) // max(1, min(L, _COLS)))
    for lo in range(0, n, step):
        for c0 in range(0, L, _COLS):
            blk = raw[lo:lo + step, c0:c0 + _COLS].astype(np.float32)
            s = (blk @ limbs[c0:c0 + _COLS]).astype(np.uint64)
            proj[lo:lo + step] += (s << shifts).sum(axis=1, dtype=np.uint64)
    return proj


class SetDigest:
    """Order-invariant multiset digest: element count + two modular-sum
    lanes over row fingerprints. add/remove are exact inverses."""

    __slots__ = ("count", "s0", "s1")

    def __init__(self, count: int = 0,
                 s0: np.uint64 = _U64(0), s1: np.uint64 = _U64(0)):
        self.count = int(count)
        self.s0 = _U64(s0)
        self.s1 = _U64(s1)

    def add(self, fps: np.ndarray) -> None:
        self._fold(fps, +1)

    def remove(self, fps: np.ndarray) -> None:
        self._fold(fps, -1)

    def _fold(self, fps: np.ndarray, sign: int) -> None:
        """Modular sums in Python ints — numpy warns on SCALAR uint64
        wraparound even though wraparound is exactly the semantics here."""
        if len(fps):
            mask = (1 << 64) - 1
            self.count += sign * len(fps)
            self.s0 = _U64(
                (int(self.s0) + sign * int(fps.sum(dtype=np.uint64)))
                & mask
            )
            lane2 = int(splitmix64(fps ^ _LANE2).sum(dtype=np.uint64))
            self.s1 = _U64((int(self.s1) + sign * lane2) & mask)

    @classmethod
    def of(cls, fps: np.ndarray) -> "SetDigest":
        d = cls()
        d.add(np.asarray(fps, np.uint64))
        return d

    def copy(self) -> "SetDigest":
        return SetDigest(self.count, self.s0, self.s1)

    def hex(self) -> str:
        """Stable wire form `count-s0-s1` (rides heartbeats / meta.json)."""
        return f"{self.count:x}-{int(self.s0):016x}-{int(self.s1):016x}"

    @classmethod
    def from_hex(cls, text: str) -> Optional["SetDigest"]:
        try:
            c, s0, s1 = text.split("-")
            return cls(int(c, 16), _U64(int(s0, 16)), _U64(int(s1, 16)))
        except (ValueError, AttributeError):
            return None

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, SetDigest)
            and self.count == other.count
            and self.s0 == other.s0
            and self.s1 == other.s1
        )

    def __hash__(self):  # noqa: D105 — dict/set member in tests
        return hash((self.count, int(self.s0), int(self.s1)))

    def __repr__(self):  # noqa: D105
        return f"SetDigest({self.hex()})"
