"""Index factory (port of dingo_tpu/index/factory.py): FLAT, BRUTEFORCE,
IVF_FLAT, IVF_PQ and HNSW. Every other type raises NotPorted until it is
ported."""

from __future__ import annotations

from dingo_tpu_torch.index.base import (
    IndexParameter,
    IndexType,
    NotPorted,
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
    if t is IndexType.IVF_FLAT:
        from dingo_tpu_torch.index.ivf_flat import TpuIvfFlat

        return TpuIvfFlat(index_id, parameter, device=device)
    if t is IndexType.IVF_PQ:
        from dingo_tpu_torch.index.ivf_pq import TpuIvfPq

        return TpuIvfPq(index_id, parameter, device=device)
    if t is IndexType.HNSW:
        from dingo_tpu_torch.index.hnsw import TpuHnsw

        return TpuHnsw(index_id, parameter, device=device)
    raise NotPorted(f"index type {t} is not ported yet")
