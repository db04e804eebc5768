"""Carry index state across from the JAX package.

The JAX package's snapshot (``meta.json`` + ``flat.npz``, ``ivf_flat.npz``,
``ivf_pq.npz``, ``binary_flat.npz`` or ``binary_ivf_flat.npz`` holding
``ids``, ``vectors`` (an sq8 index: ``codes`` with its codec
``sq_vmin``/``sq_scale`` instead; a binary index: its packed uint8 rows)
and, once trained, ``centroids`` plus ``assign`` (IVF_FLAT and
BINARY_IVF_FLAT) or ``codebooks`` (IVF_PQ)) is the
interchange format, and the snapshot's precision tier carries over: the
port's ``load`` reads it, and ``index_from_reference`` builds a port index from a snapshot directory or
from the same arrays given as numpy. Rows go into slots in snapshot order,
so both packages hold the same slots, centroids and bucket assignments and
compute the same thing. An IVF_PQ snapshot re-encodes its rows at load, as
the JAX package's load does; a mapping may carry the reference's exact
``codes`` and ``assign`` instead.

``hnsw_from_reference`` carries an HNSW index: the JAX package's
``TpuHnsw.save`` directory (meta, rows or sq8 codes, the native graph blob
and the level-0 adjacency) goes through the port's ``TpuHnsw.load``; the
graph's nlinks and efConstruction come from the blob's header, so the
host graph, the device mirror and the search defaults all carry over.

``host_rung_from_reference`` carries the serving index of a region on a
host rung of the memory-tier ladder: the JAX package's ``HostSqFlat.save``
writes TpuFlat's sq8 form (``flat.npz`` with ids, codes and codec, meta
precision "sq8", the region's own index type), which loads into the
port's ``HostSqFlat`` over a ``HostSqSlotStore`` and answers with the
same ids and distances.

``region_from_reference`` carries a whole region: the JAX package's
engine state and region blob go into a port node, which rebuilds the
region's index from its own engine.
"""

from __future__ import annotations

import json
import os
from typing import Mapping, Optional, Union

import numpy as np

from dingo_tpu_torch.index.base import (
    IndexParameter,
    IndexType,
    InvalidParameter,
)
from dingo_tpu_torch.index.factory import new_index
from dingo_tpu_torch.ops.distance import Metric
from dingo_tpu_torch.ops.sq import SqParams


_BINARY_TYPES = (IndexType.BINARY_FLAT, IndexType.BINARY_IVF_FLAT)


def index_from_reference(source: Union[str, os.PathLike, Mapping],
                         device=None,
                         parameter: Optional[IndexParameter] = None,
                         index_id: int = 0):
    """Port index from a JAX snapshot directory, or from a mapping of numpy
    arrays (``ids``, ``vectors`` and optionally ``centroids`` with
    ``assign`` for IVF_FLAT, or ``centroids``, ``codebooks`` and optionally
    ``codes``/``assign`` for IVF_PQ; an sq8 FLAT/IVF_FLAT gives ``codes``,
    ``sq_vmin`` and ``sq_scale`` in place of ``vectors``; a binary index
    gives packed uint8 ``vectors``; ``parameter`` describes the index,
    inferred when absent: IVF_PQ when codebooks are given, IVF_FLAT when
    only centroids are, else FLAT, L2, in the snapshot's tier: its
    ``precision`` entry, sq8 for codes, else fp32; uint8 ``vectors`` mean
    the binary family, HAMMING over 8 bits a byte). Rows are taken as
    stored (cosine rows already normalized)."""
    if isinstance(source, (str, os.PathLike)):
        with open(os.path.join(source, "meta.json")) as f:
            meta = json.load(f)
        if parameter is None:
            t = IndexType(meta["index_type"])
            kw = {"ncentroids": int(meta["nlist"])} if "nlist" in meta else {}
            if "m" in meta:
                kw["nsubvector"] = int(meta["m"])
            parameter = IndexParameter(
                index_type=t, dimension=int(meta["dimension"]),
                metric=Metric(meta["metric"]),
                precision=meta.get("precision") or "fp32", **kw,
            )
        index = new_index(index_id, parameter, device=device)
        index.load(os.fspath(source))
        return index

    arrays = source
    centroids = arrays.get("centroids")
    binary = (parameter.index_type in _BINARY_TYPES if parameter is not None
              else np.asarray(arrays.get("vectors", ())).dtype == np.uint8)
    if binary:
        packed = np.asarray(arrays["vectors"], np.uint8)
        if parameter is None:
            parameter = IndexParameter(
                index_type=(IndexType.BINARY_FLAT if centroids is None
                            else IndexType.BINARY_IVF_FLAT),
                dimension=packed.shape[1] * 8, metric=Metric.HAMMING,
                ncentroids=len(centroids) if centroids is not None else 1)
        index = new_index(index_id, parameter, device=device)
        if parameter.index_type is IndexType.BINARY_IVF_FLAT:
            if centroids is not None and "assign" not in arrays:
                raise InvalidParameter("centroids given without assign")
            index.restore_arrays(arrays["ids"], packed, centroids,
                                 arrays.get("assign"))
        else:
            index.restore_arrays(arrays["ids"], packed)
        index.apply_log_id = int(arrays.get("apply_log_id", 0))
        return index
    codebooks = arrays.get("codebooks")
    sq_codes = codebooks is None and "codes" in arrays
    if sq_codes:
        rows = {"codes": np.asarray(arrays["codes"], np.uint8),
                "sq_params": SqParams(
                    np.asarray(arrays["sq_vmin"], np.float32),
                    np.asarray(arrays["sq_scale"], np.float32))}
        dim = rows["codes"].shape[1]
    else:
        rows = {"vectors": np.asarray(arrays["vectors"], np.float32)}
        dim = rows["vectors"].shape[1]
    if parameter is None:
        tier = "sq8" if sq_codes else "fp32"
        if codebooks is not None:
            parameter = IndexParameter(
                index_type=IndexType.IVF_PQ, dimension=dim,
                ncentroids=len(centroids), nsubvector=len(codebooks),
            )
        elif centroids is not None:
            parameter = IndexParameter(
                index_type=IndexType.IVF_FLAT, dimension=dim,
                ncentroids=len(centroids), precision=tier,
            )
        else:
            parameter = IndexParameter(index_type=IndexType.FLAT,
                                       dimension=dim, precision=tier)
    index = new_index(index_id, parameter, device=device)
    if parameter.index_type is IndexType.IVF_FLAT:
        if centroids is not None and "assign" not in arrays:
            raise InvalidParameter("centroids given without assign")
        index.restore_arrays(arrays["ids"], centroids=centroids,
                             assign=arrays.get("assign"), **rows)
    elif parameter.index_type is IndexType.IVF_PQ:
        index.restore_arrays(arrays["ids"], rows["vectors"], centroids,
                             codebooks, arrays.get("codes"),
                             arrays.get("assign"))
    else:
        index.restore_arrays(arrays["ids"], **rows)
    index.apply_log_id = int(arrays.get("apply_log_id", 0))
    return index


def hnsw_from_reference(snapshot_dir: Union[str, os.PathLike], device=None,
                        parameter: Optional[IndexParameter] = None,
                        index_id: int = 0):
    """Port TpuHnsw from a directory written by the JAX package's
    ``TpuHnsw.save``. ``parameter`` is inferred when absent: dimension,
    metric and tier from meta.json, nlinks and efconstruction from the
    native graph blob's header (int64 words: version, dim, metric, M,
    ef_construction)."""
    path = os.fspath(snapshot_dir)
    if parameter is None:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        head = np.fromfile(os.path.join(path, "hnsw_graph.bin"), np.int64,
                           count=5)
        if len(head) < 5 or int(head[0]) != 1:
            raise InvalidParameter("bad hnsw graph blob header")
        parameter = IndexParameter(
            index_type=IndexType.HNSW, dimension=int(meta["dimension"]),
            metric=Metric(meta["metric"]),
            precision=meta.get("precision") or "fp32",
            nlinks=int(head[3]), efconstruction=int(head[4]))
    index = new_index(index_id, parameter, device=device)
    index.load(path)
    return index


def host_rung_from_reference(snapshot_dir: Union[str, os.PathLike],
                             device=None,
                             parameter: Optional[IndexParameter] = None,
                             index_id: int = 0):
    """Port HostSqFlat (the host_sq8 rung's serving index) from a directory
    written by the JAX package's ``HostSqFlat.save``. ``parameter`` is
    inferred when absent: index type, dimension and metric from meta.json
    (the tier is sq8). `device` is where the store's rows_device uploads."""
    from dingo_tpu_torch.common.device import resolve_device
    from dingo_tpu_torch.index.slot_store import HostSqSlotStore
    from dingo_tpu_torch.index.tiering import HostSqFlat

    path = os.fspath(snapshot_dir)
    if parameter is None:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if (meta.get("precision") or "sq8") != "sq8":
            raise InvalidParameter(
                f"a host-rung snapshot holds sq8 codes, not "
                f"{meta.get('precision')}")
        parameter = IndexParameter(
            index_type=IndexType(meta["index_type"]),
            dimension=int(meta["dimension"]), metric=Metric(meta["metric"]),
            precision="sq8")
    store = HostSqSlotStore(parameter.dimension, resolve_device(device))
    index = HostSqFlat(index_id, parameter, store)
    index.load(path)
    return index


def region_from_reference(node, engine_state: Mapping, region_blob: bytes):
    """Carry a JAX package region into a port node as plain data: a
    ``MemEngine.snapshot_state()`` dict (column family -> list of (key,
    value) bytes) and a ``Region.serialize()`` blob. The node creates the
    region from the blob's definition, installs the state's pairs inside
    the region's range (the meta column family stays behind) as one
    region-install write, and rebuilds the region's index from its engine.
    On a replicated node that write is a raft proposal: call it on the
    leader, and every replica rebuilds when it applies the install.
    Returns the port Region."""
    from dingo_tpu_torch.engine import write_data as wd
    from dingo_tpu_torch.engine.raft_engine import (
        RaftStoreEngine,
        region_bounds,
    )
    from dingo_tpu_torch.engine.raw_engine import CF_META
    from dingo_tpu_torch.store.region import Region

    definition = Region.deserialize(region_blob,
                                    device=node.device).definition
    region = node.create_region(definition)
    start, end = region_bounds(region)
    cfs = []
    for cf, pairs in engine_state.items():
        if cf == CF_META:
            continue
        inside = [(bytes(k), bytes(v)) for k, v in pairs
                  if k >= start and (end is None or k < end)]
        if inside:
            cfs.append((cf, inside))
    node.engine.write(region, wd.RegionInstallData(cfs=cfs))
    if not isinstance(node.engine, RaftStoreEngine):
        # a mono apply runs without the node's install hook
        node.index_manager.rebuild(region)
    return region
