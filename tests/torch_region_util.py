"""Helpers of the port's region tests that import nothing of JAX (the
`gpu` cases of test_torch_gpu.py import them on the card)."""

import numpy as np

from dingo_tpu_torch.engine.storage import VECTOR_MAX_BATCH_COUNT
from dingo_tpu_torch.index import codec as vcodec
from dingo_tpu_torch.store.node import MonoStoreNode
from dingo_tpu_torch.store.region import RegionDefinition, RegionType


def node_over_wrapper(wrapper, ids, rows, keys=(1,)):
    """A MonoStoreNode whose regions `keys` are served by `wrapper`, an
    index that already holds exactly `ids` -> `rows`. Every region covers
    partition 0, so all of them read the same engine rows; the rows go
    into the engine through the first region's Storage.vector_add. The
    wrapper stands for an index snapshot taken at the region's last
    ingest log id: the apply-log contract skips those writes in the index
    (already materialized) and applies every later one."""
    ids = np.asarray(ids, np.int64)
    node = MonoStoreNode(device=wrapper.device)
    regions = []
    for key in keys:
        region = node.create_region(RegionDefinition(
            region_id=key, start_key=vcodec.encode_vector_key(0, 0),
            end_key=vcodec.encode_vector_key(1),
            region_type=RegionType.INDEX,
            index_parameter=wrapper.parameter))
        region.vector_index_wrapper = wrapper
        regions.append(region)
    index = wrapper.own_index
    index.apply_log_id = -(-len(ids) // VECTOR_MAX_BATCH_COUNT)
    wrapper.set_own(index)
    for lo in range(0, len(ids), VECTOR_MAX_BATCH_COUNT):
        hi = lo + VECTOR_MAX_BATCH_COUNT
        node.storage.vector_add(regions[0], ids[lo:hi], rows[lo:hi])
    return node
