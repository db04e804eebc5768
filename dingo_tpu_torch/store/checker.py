"""Pre-split / pre-merge checkers (port of dingo_tpu/store/checker.py).

Reference: src/split/ (PreSplitChecker — policies by approximate size/keys,
config_helper.h:27-35) and src/merge/ (PreMergeChecker); both crontab-driven
(server.cc:583-616): leaders inspect their regions, pick split keys at the
size/keys midpoint, and ask the coordinator to split/merge.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from dingo_tpu_torch.common.config import FLAGS
from dingo_tpu_torch.index import codec as vcodec
from dingo_tpu_torch.store.region import Region, RegionState


@dataclasses.dataclass
class SplitProposal:
    region_id: int
    split_key: bytes
    reason: str


@dataclasses.dataclass
class MergeProposal:
    source_region_id: int
    target_region_id: int
    reason: str


class PreSplitChecker:
    """Propose splits for oversized regions (split policy by approximate
    keys — the reference also supports size-based policies)."""

    def __init__(self, node, max_keys: Optional[int] = None):
        self.node = node
        self.max_keys = max_keys or FLAGS.get("split_check_approximate_keys")

    def check_region(self, region: Region) -> Optional[SplitProposal]:
        raft = self.node.engine.get_node(region.id)
        if raft is None or not raft.is_leader():
            return None
        if region.state is not RegionState.NORMAL:
            return None
        if region.definition.index_parameter is None:
            return None  # KV split policy needs key sampling; index regions
            # use the id midpoint below
        reader = self.node.engine.new_vector_reader(region)
        count = reader.vector_count()
        if count < self.max_keys:
            return None
        # split at the median id (HALF_SPLIT policy analog); scan only up to
        # the median — no need to materialize the full region
        rows = reader.vector_scan_query(
            0, limit=count // 2 + 1, with_vector_data=False
        )
        mid_id = rows[-1].id
        lo, hi = region.id_window()
        if not (lo < mid_id < hi):
            return None
        return SplitProposal(
            region.id,
            vcodec.encode_vector_key(region.definition.partition_id, mid_id),
            f"keys {count} >= {self.max_keys}",
        )

    def run(self) -> List[SplitProposal]:
        """Crontab entry: propose splits to the coordinator."""
        out = []
        for region in self.node.meta.get_all_regions():
            p = self.check_region(region)
            if p is None:
                continue
            out.append(p)
            if self.node.coordinator is not None:
                try:
                    self.node.coordinator.split_region(p.region_id, p.split_key)
                except (KeyError, ValueError):
                    pass
        return out


class PreMergeChecker:
    """Propose merging undersized sibling regions (PreMergeChecker)."""

    def __init__(self, node, min_keys: int = 1024):
        self.node = node
        self.min_keys = min_keys

    def run(self) -> List[MergeProposal]:
        out = []
        regions = sorted(
            (r for r in self.node.meta.get_all_regions()
             if r.state is RegionState.NORMAL
             and r.definition.index_parameter is not None),
            key=lambda r: r.definition.start_key,
        )
        for a, b in zip(regions, regions[1:]):
            if a.definition.end_key != b.definition.start_key:
                continue  # not adjacent
            raft = self.node.engine.get_node(a.id)
            if raft is None or not raft.is_leader():
                continue
            ca = self.node.engine.new_vector_reader(a).vector_count()
            cb = self.node.engine.new_vector_reader(b).vector_count()
            if ca + cb < self.min_keys:
                p = MergeProposal(b.id, a.id, f"{ca}+{cb} < {self.min_keys}")
                out.append(p)
                if self.node.coordinator is not None:
                    try:
                        self.node.coordinator.merge_region(
                            p.target_region_id, p.source_region_id
                        )
                    except (KeyError, ValueError):
                        pass
        return out
