"""ctypes bindings of the port's host libraries (port of ``load_hnsw`` and
``load_lsm`` in dingo_tpu/native/__init__.py): the HNSW graph and the LSM
raw-KV engine.

The sources are the port's own copies, ``csrc/host/hnsw.cc`` and
``csrc/host/lsm.cc``. Each is compiled with g++ at first use into
``build/dingo_tpu_torch/lib<name>-<hash>.so`` at the repository root
(git-ignored), the hash covering the source, the flags and the CPU that
``-march=native`` resolves to, so an edited source rebuilds and a stale or
foreign library is never loaded.
The build goes to a private temporary file first and is renamed into place,
so concurrent processes never load a half-written library. The flags are
the JAX package's (``-march=native`` included: it lets g++ contract the
distance loops into FMAs, and both packages must compute the same graph).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc" / "host"
#: library name -> its source under SRC_DIR
SOURCES = {"dingohnsw": "hnsw.cc", "dingolsm": "lsm.cc"}
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dingo_tpu_torch"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-march=native"]

_lock = threading.Lock()
_libs: dict = {}


def _native_arch() -> str:
    """What -march=native resolves to on this machine, as g++ reports it:
    a library built for another CPU (a copied checkout) is never loaded."""
    out = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                         capture_output=True, text=True, check=True).stdout
    for line in out.splitlines():
        if line.strip().startswith("-march="):
            return line.split()[-1]
    return out


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((SRC_DIR / SOURCES[name]).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_native_arch().encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile host library `name` (a key of SOURCES) unless it is built
    already."""
    path = _lib_path(name)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", *CXX_FLAGS, str(SRC_DIR / SOURCES[name]), "-o",
                    str(tmp)], check=True, capture_output=True)
    os.replace(tmp, path)
    return path


def load_hnsw() -> ctypes.CDLL:
    """The loaded host graph library with its argument types."""
    with _lock:
        if "dingohnsw" in _libs:
            return _libs["dingohnsw"]
        lib = ctypes.CDLL(str(build("dingohnsw")))
        c = ctypes
        lib.hnsw_new.restype = c.c_void_p
        lib.hnsw_new.argtypes = [c.c_int, c.c_int, c.c_int, c.c_int,
                                 c.c_uint64]
        lib.hnsw_free.argtypes = [c.c_void_p]
        lib.hnsw_add.argtypes = [
            c.c_void_p, c.c_int, c.POINTER(c.c_int64), c.POINTER(c.c_float),
        ]
        lib.hnsw_delete.restype = c.c_int
        lib.hnsw_delete.argtypes = [c.c_void_p, c.c_int,
                                    c.POINTER(c.c_int64)]
        lib.hnsw_search.argtypes = [
            c.c_void_p, c.c_int, c.POINTER(c.c_float), c.c_int, c.c_int,
            c.POINTER(c.c_int64), c.POINTER(c.c_float),
        ]
        for name in ("hnsw_count", "hnsw_deleted_count", "hnsw_memory",
                     "hnsw_total_count", "hnsw_graph_version",
                     "hnsw_entry_label", "hnsw_save_size"):
            fn = getattr(lib, name)
            fn.restype = c.c_int64
            fn.argtypes = [c.c_void_p]
        lib.hnsw_export_level0.argtypes = [
            c.c_void_p, c.c_int64, c.c_int,
            c.POINTER(c.c_int64), c.POINTER(c.c_int32),
        ]
        lib.hnsw_save.restype = c.c_int64
        lib.hnsw_save.argtypes = [c.c_void_p, c.POINTER(c.c_uint8)]
        lib.hnsw_load.restype = c.c_void_p
        lib.hnsw_load.argtypes = [c.POINTER(c.c_uint8), c.c_int64]
        _libs["dingohnsw"] = lib
        return lib


def load_lsm() -> ctypes.CDLL:
    """The loaded LSM engine library with its argument types."""
    with _lock:
        if "dingolsm" in _libs:
            return _libs["dingolsm"]
        lib = ctypes.CDLL(str(build("dingolsm")))
        c = ctypes
        lib.lsm_open.restype = c.c_void_p
        lib.lsm_open.argtypes = [c.c_char_p, c.c_uint64, c.c_int]
        lib.lsm_close.argtypes = [c.c_void_p]
        lib.lsm_write.restype = c.c_int
        lib.lsm_write.argtypes = [c.c_void_p, c.c_char_p, c.c_uint64]
        lib.lsm_get.restype = c.c_int
        lib.lsm_get.argtypes = [
            c.c_void_p, c.c_char_p, c.c_uint64,
            c.POINTER(c.POINTER(c.c_char)), c.POINTER(c.c_uint64),
        ]
        lib.lsm_free_buf.argtypes = [c.POINTER(c.c_char)]
        lib.lsm_scan.restype = c.c_void_p
        lib.lsm_scan.argtypes = [
            c.c_void_p, c.c_char_p, c.c_uint64, c.c_char_p, c.c_uint64,
            c.c_int, c.c_int,
        ]
        lib.lsm_iter_next.restype = c.c_int
        lib.lsm_iter_next.argtypes = [
            c.c_void_p, c.POINTER(c.POINTER(c.c_char)),
            c.POINTER(c.c_uint64), c.POINTER(c.POINTER(c.c_char)),
            c.POINTER(c.c_uint64),
        ]
        lib.lsm_iter_close.argtypes = [c.c_void_p]
        lib.lsm_count.restype = c.c_uint64
        lib.lsm_count.argtypes = [
            c.c_void_p, c.c_char_p, c.c_uint64, c.c_char_p, c.c_uint64,
            c.c_int,
        ]
        lib.lsm_flush.restype = c.c_int
        lib.lsm_flush.argtypes = [c.c_void_p]
        lib.lsm_compact.restype = c.c_int
        lib.lsm_compact.argtypes = [c.c_void_p]
        lib.lsm_sst_count.restype = c.c_uint64
        lib.lsm_sst_count.argtypes = [c.c_void_p]
        lib.lsm_delete_range.restype = c.c_int64
        lib.lsm_delete_range.argtypes = [
            c.c_void_p, c.c_char_p, c.c_uint64, c.c_char_p, c.c_uint64,
            c.c_int,
        ]
        lib.lsm_index_bytes.restype = c.c_uint64
        lib.lsm_index_bytes.argtypes = [c.c_void_p]
        _libs["dingolsm"] = lib
        return lib
