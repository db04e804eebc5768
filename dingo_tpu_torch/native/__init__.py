"""ctypes binding of the port's host HNSW graph (port of ``load_hnsw`` in
dingo_tpu/native/__init__.py).

The source is the port's own copy, ``csrc/host/hnsw.cc``. It is compiled
with g++ at first use into ``build/dingo_tpu_torch/libdingohnsw-<hash>.so``
at the repository root (git-ignored), the hash covering the source, the
flags and the CPU that ``-march=native`` resolves to, so an edited source
rebuilds and a stale or foreign library is never loaded.
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

SRC = Path(__file__).resolve().parent.parent / "csrc" / "host" / "hnsw.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dingo_tpu_torch"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-march=native"]

_lock = threading.Lock()
_lib = None


def _native_arch() -> str:
    """What -march=native resolves to on this machine, as g++ reports it:
    a library built for another CPU (a copied checkout) is never loaded."""
    out = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                         capture_output=True, text=True, check=True).stdout
    for line in out.splitlines():
        if line.strip().startswith("-march="):
            return line.split()[-1]
    return out


def _lib_path() -> Path:
    h = hashlib.sha256()
    h.update(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_native_arch().encode())
    return BUILD_DIR / f"libdingohnsw-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the host graph library unless it is built already."""
    path = _lib_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                   check=True, capture_output=True)
    os.replace(tmp, path)
    return path


def load_hnsw() -> ctypes.CDLL:
    """The loaded host graph library with its argument types."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
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
        _lib = lib
        return lib
