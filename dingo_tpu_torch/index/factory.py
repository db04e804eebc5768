"""Index factory (port of dingo_tpu/index/factory.py): FLAT, BRUTEFORCE,
BINARY_FLAT, IVF_FLAT, BINARY_IVF_FLAT, IVF_PQ and HNSW. DISKANN raises
NotPorted: its index is a gRPC proxy to the diskann role (the role's core,
``dingo_tpu_torch.diskann``, is ported)."""

from __future__ import annotations

from dingo_tpu_torch.index.base import (
    IndexParameter,
    IndexType,
    InvalidParameter,
    NotPorted,
    NotSupported,
    VectorIndex,
)


def new_index(index_id: int, parameter: IndexParameter,
              device=None) -> VectorIndex:
    """Build an index on `device` (None = the CUDA device; raises when
    there is none)."""
    t = parameter.index_type
    if t is IndexType.FLAT:
        from dingo_tpu_torch.index.flat import TpuFlat

        return TpuFlat(index_id, parameter, device=device)
    if t is IndexType.BRUTEFORCE:
        from dingo_tpu_torch.index.flat import TpuBruteforce

        return TpuBruteforce(index_id, parameter, device=device)
    if t is IndexType.BINARY_FLAT:
        from dingo_tpu_torch.index.flat import TpuBinaryFlat

        return TpuBinaryFlat(index_id, parameter, device=device)
    if t is IndexType.IVF_FLAT:
        from dingo_tpu_torch.index.ivf_flat import TpuIvfFlat

        return TpuIvfFlat(index_id, parameter, device=device)
    if t is IndexType.BINARY_IVF_FLAT:
        from dingo_tpu_torch.index.ivf_flat import TpuBinaryIvfFlat

        return TpuBinaryIvfFlat(index_id, parameter, device=device)
    if t is IndexType.IVF_PQ:
        from dingo_tpu_torch.index.ivf_pq import TpuIvfPq

        return TpuIvfPq(index_id, parameter, device=device)
    if t is IndexType.DISKANN:
        raise NotPorted("DISKANN indexes are gRPC proxies to the diskann "
                        "role; they come with the gRPC front end")
    if t is IndexType.HNSW:
        if parameter.host_vectors:
            # the device walk and its rerank read the store's device rows;
            # host_vectors fits only indexes that serve from codes
            raise InvalidParameter("HNSW does not support host_vectors")
        from dingo_tpu_torch.index.hnsw import TpuHnsw

        return TpuHnsw(index_id, parameter, device=device)
    raise NotSupported(f"index type {t} not implemented")
