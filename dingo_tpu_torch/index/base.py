"""VectorIndex abstract API + filter model (port of dingo_tpu/index/base.py).

Every filter mode compiles to a per-slot validity bitmap on the host
(FilterSpec.slot_mask): 64-bit external ids stay on the host, kernels work
in slot space, and the host translates slots back to ids after top-k.
"""

from __future__ import annotations

import abc
import dataclasses
import enum
import hashlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from dingo_tpu_torch.ops.distance import Metric


class IndexType(enum.Enum):
    """pb::common::VectorIndexType equivalents."""

    FLAT = "flat"
    IVF_FLAT = "ivf_flat"
    IVF_PQ = "ivf_pq"
    HNSW = "hnsw"
    DISKANN = "diskann"
    BRUTEFORCE = "bruteforce"
    BINARY_FLAT = "binary_flat"
    BINARY_IVF_FLAT = "binary_ivf_flat"


class VectorIndexError(Exception):
    """Base error; carries an errno-style code matching pb::error::Errno."""


class NotSupported(VectorIndexError):
    """EVECTOR_NOT_SUPPORT: the reader falls back to a brute-force scan for
    untrained IVF / BRUTEFORCE."""


class NotPorted(VectorIndexError):
    """A feature of the JAX package that the port does not carry yet. It
    is not EVECTOR_NOT_SUPPORT: nothing catches it on the serving path, so
    an unported feature fails loudly instead of turning into a
    brute-force scan."""


class NotTrained(VectorIndexError):
    """EVECTOR_INDEX_NOT_TRAIN."""


class InvalidParameter(VectorIndexError):
    """EILLEGAL_PARAMTETERS [sic — the reference spells it this way]."""


class SnapshotCorruption(VectorIndexError):
    """A restored snapshot's recomputed state digests diverge from the
    digest vector in its meta.json (obs/integrity.py): the files rotted at
    rest or the restore mangled them. load() raises it before the index
    can serve; the manager's load-or-build path then rebuilds from the
    engine."""


@dataclasses.dataclass(frozen=True)
class IndexParameter:
    """Union of pb::common::VectorIndexParameter fields (the same fields as
    the JAX package, so snapshots and parameters carry across)."""

    index_type: IndexType = IndexType.FLAT
    dimension: int = 0
    metric: Metric = Metric.L2
    ncentroids: int = 2048
    nsubvector: int = 64
    nbits_per_idx: int = 8
    default_nprobe: int = 80
    max_elements: int = 0
    efconstruction: int = 200
    nlinks: int = 32
    dtype: str = "float32"
    precision: str = ""
    host_vectors: bool = False
    scalar_speedup_keys: Tuple[str, ...] = ()


PRECISION_TIERS = ("fp32", "bf16", "sq8")

_PRECISION_ALIASES = {
    "": "fp32", "fp32": "fp32", "f32": "fp32", "float32": "fp32",
    "bf16": "bf16", "bfloat16": "bf16",
    "sq8": "sq8", "int8": "sq8", "uint8": "sq8",
}


def precision_tier(parameter: IndexParameter) -> str:
    """Effective precision tier: the parameter wins, else the
    vector_precision flag; a legacy bf16 dtype means bf16 (the JAX
    package's resolve_precision)."""
    p = (parameter.precision or "").strip().lower()
    if not p:
        from dingo_tpu_torch.common.config import FLAGS

        p = str(FLAGS.get("vector_precision")).strip().lower()
    tier = _PRECISION_ALIASES.get(p)
    if tier is None:
        raise InvalidParameter(f"unknown precision tier {p!r} "
                               f"(want one of {PRECISION_TIERS})")
    if tier == "fp32" and parameter.dtype in ("bfloat16", "bf16"):
        tier = "bf16"
    return tier


def resolve_precision(parameter: IndexParameter) -> str:
    """Effective precision tier of a float index (fp32, bf16 or sq8)."""
    tier = precision_tier(parameter)
    if parameter.dtype not in ("float32", "f32", "bfloat16", "bf16"):
        raise NotPorted(f"storage dtype {parameter.dtype} is not ported")
    return tier


_ATOMS = (int, float, str, bytes, np.generic, type(None))


def _members(values) -> list:
    """The non-scalar members of a dict's values or a list, copied first:
    the raft apply threads change an index's maps while a reader walks
    them. list() copies a dict view or a list in C, without a thread
    switch between items; a resize that lands in it all the same is
    retried."""
    while True:
        try:
            items = list(values)
            break
        except RuntimeError:  # changed size during the copy
            continue
    return [v for v in items if not isinstance(v, _ATOMS)]


def tensor_bytes(root, seen: Optional[Tuple[set, set]] = None) -> int:
    """Bytes of the distinct torch tensors reachable from an index: its
    own attributes and those of the port's objects it holds (store, view,
    rerank cache), through dicts, lists and tuples. The port's counterpart
    of the JAX package's live_device_bytes. `seen` (visited objects,
    visited storages) is shared across calls to charge each storage once
    (the HBM ledger's per-owner attribution)."""
    import torch

    seen_obj, seen_mem = seen if seen is not None else (set(), set())
    total = 0
    stack = [root]
    while stack:
        obj = stack.pop()
        if isinstance(obj, torch.Tensor):
            st = obj.untyped_storage()
            key = (obj.device, st.data_ptr())
            if key not in seen_mem:
                seen_mem.add(key)
                total += st.nbytes()
            continue
        if id(obj) in seen_obj:
            continue
        seen_obj.add(id(obj))
        if isinstance(obj, dict):
            # scalars hold no tensor: an id -> slot map of a million rows
            # must not cost a million stack visits (the metrics collector
            # calls this on every heartbeat's collection)
            stack.extend(_members(obj.values()))
        elif isinstance(obj, (list, tuple)):
            stack.extend(_members(obj))
        elif type(obj).__module__.startswith("dingo_tpu_torch"):
            if hasattr(obj, "__dict__"):
                stack.extend(_members(vars(obj).values()))
    return total


def _holds_tensor_on(value, dev_type: str) -> bool:
    import torch

    if isinstance(value, torch.Tensor):
        return value.device.type == dev_type
    if isinstance(value, dict):
        value = value.values()
    elif not isinstance(value, (list, tuple)):
        return False
    return any(_holds_tensor_on(v, dev_type) for v in _members(value))


def drop_device_tensors(root) -> None:
    """Let go of the tensors on a retired index's device, over tensor_bytes'
    walk: each attribute of the port's objects that holds one (itself, or in
    a list, tuple or dict) becomes None. No other index and no wrapper is
    entered. The caller guarantees that nothing searches or writes the
    index any more; whatever still refers to the object then holds no card
    memory through it."""
    import torch

    from dingo_tpu_torch.index.wrapper import VectorIndexWrapper

    dev_type = torch.device(getattr(root, "device", None) or "cpu").type
    seen: set = set()
    stack = [root]
    while stack:
        obj = stack.pop()
        if id(obj) in seen:
            continue
        seen.add(id(obj))
        if isinstance(obj, dict):
            stack.extend(_members(obj.values()))
            continue
        if isinstance(obj, (list, tuple)):
            stack.extend(_members(obj))
            continue
        if (not type(obj).__module__.startswith("dingo_tpu_torch")
                or not hasattr(obj, "__dict__")
                or isinstance(obj, VectorIndexWrapper)
                or (isinstance(obj, VectorIndex) and obj is not root)):
            continue
        for name, value in list(vars(obj).items()):
            if _holds_tensor_on(value, dev_type):
                setattr(obj, name, None)
            elif not isinstance(value, _ATOMS):
                stack.append(value)


@dataclasses.dataclass
class FilterSpec:
    """Compiled filter: ranges ([lo, hi) id intervals, OR'd), include_ids
    (whitelist) and exclude_ids (blacklist)."""

    ranges: Optional[Sequence[Tuple[int, int]]] = None
    include_ids: Optional[np.ndarray] = None
    exclude_ids: Optional[np.ndarray] = None

    def is_empty(self) -> bool:
        return (
            not self.ranges
            and self.include_ids is None
            and self.exclude_ids is None
        )

    def fingerprint(self) -> bytes:
        """Stable content digest: the key of the IVF filter-mask cache."""
        h = hashlib.blake2b(digest_size=16)
        for lo, hi in self.ranges or ():
            h.update(int(lo).to_bytes(8, "little", signed=True))
            h.update(int(hi).to_bytes(8, "little", signed=True))
        for tag, ids in ((b"i", self.include_ids), (b"x", self.exclude_ids)):
            if ids is not None:
                h.update(tag)
                h.update(np.ascontiguousarray(
                    np.asarray(ids, np.int64)
                ).tobytes())
        return h.digest()

    def slot_mask(self, ids_by_slot: np.ndarray) -> np.ndarray:
        """Compile against the host id-by-slot array [capacity] int64
        (-1 = empty slot) -> bool mask [capacity]."""
        mask = ids_by_slot >= 0
        if self.ranges:
            rmask = np.zeros_like(mask)
            for lo, hi in self.ranges:
                rmask |= (ids_by_slot >= lo) & (ids_by_slot < hi)
            mask &= rmask
        if self.include_ids is not None:
            mask &= np.isin(ids_by_slot, np.asarray(self.include_ids, np.int64))
        if self.exclude_ids is not None and len(self.exclude_ids):
            mask &= ~np.isin(ids_by_slot, np.asarray(self.exclude_ids, np.int64))
        return mask


@dataclasses.dataclass
class SearchResult:
    """Per-query result; distances follow the wire convention (L2
    ascending, IP/cosine descending)."""

    ids: np.ndarray        # [k'] int64, no -1 entries
    distances: np.ndarray  # [k'] float32


def strip_invalid(ids: np.ndarray, distances: np.ndarray) -> SearchResult:
    """Drop -1 (masked/padding) entries."""
    keep = ids >= 0
    return SearchResult(ids=ids[keep], distances=distances[keep])


class VectorIndex(abc.ABC):
    """Abstract ANN index owned per region (region_id == index id)."""

    def __init__(self, index_id: int, parameter: IndexParameter):
        self.id = index_id
        self.parameter = parameter
        self.apply_log_id: int = 0
        self.snapshot_log_id: int = 0
        self.write_count_since_save: int = 0
        #: per-region serving-default overrides: {"nprobe": int}; a
        #: request-pinned value always wins
        self.tuning: dict = {}

    def tuned(self, knob: str, fallback: int) -> int:
        v = self.tuning.get(knob)
        return int(v) if v else int(fallback)

    @property
    def dimension(self) -> int:
        return self.parameter.dimension

    @property
    def metric(self) -> Metric:
        return self.parameter.metric

    @property
    def index_type(self) -> IndexType:
        return self.parameter.index_type

    @abc.abstractmethod
    def add(self, ids: np.ndarray, vectors: np.ndarray) -> None:
        """Insert; error on duplicate id."""

    @abc.abstractmethod
    def upsert(self, ids: np.ndarray, vectors: np.ndarray) -> None:
        """Insert-or-replace."""

    @abc.abstractmethod
    def delete(self, ids: np.ndarray) -> None:
        """Remove ids (missing ids are ignored)."""

    @abc.abstractmethod
    def search(self, queries: np.ndarray, topk: int,
               filter_spec: Optional[FilterSpec] = None
               ) -> List[SearchResult]:
        ...

    def range_search(self, queries: np.ndarray, radius: float,
                     filter_spec: Optional[FilterSpec] = None,
                     limit: int = 1024) -> List[SearchResult]:
        """Results within `radius`, at most `limit` a query
        (FLAGS_vector_max_range_search_result_count = 1024): the top-limit
        search, then the radius cut on the host (<= for L2 and HAMMING,
        >= for the similarities)."""
        results = self.search(queries, limit, filter_spec)
        ascending = self.metric in (Metric.L2, Metric.HAMMING)
        out = []
        for r in results:
            keep = (r.distances <= radius) if ascending \
                else (r.distances >= radius)
            out.append(SearchResult(r.ids[keep], r.distances[keep]))
        return out

    def need_train(self) -> bool:
        return False

    def is_trained(self) -> bool:
        return True

    def train(self, vectors: Optional[np.ndarray] = None) -> None:  # noqa: B027
        """No-op for non-trainable index types."""

    @abc.abstractmethod
    def save(self, path: str) -> None:
        ...

    @abc.abstractmethod
    def load(self, path: str) -> None:
        ...

    @abc.abstractmethod
    def get_count(self) -> int:
        ...

    def get_deleted_count(self) -> int:
        return 0

    def get_device_memory_size(self) -> int:
        """Bytes of the tensors this index holds (the device bytes of an
        index on the card)."""
        return tensor_bytes(self)

    @abc.abstractmethod
    def get_memory_size(self) -> int:
        ...

    def need_to_rebuild(self) -> bool:
        return False

    def need_to_save(self, last_save_log_behind: int) -> bool:
        return False
