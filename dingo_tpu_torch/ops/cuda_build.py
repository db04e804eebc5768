"""Build and load the port's CUDA kernels (plain C interface over ctypes).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``build/dingo_tpu_torch/lib<name>-<hash>.so`` at the repository root, at
first use; the hash covers the source and the shared headers, so an edited
kernel rebuilds and a stale library is never loaded. Each build is
reported to the launch sentinel (``obs/sentinel.py``). The build reads only
the sources under ``csrc/``. Nothing here runs at import time: this
module imports on machines with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

from dingo_tpu_torch.obs.sentinel import SENTINEL

CSRC = Path(__file__).resolve().parent.parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO_ROOT / "build" / "dingo_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

#: kernel library name -> its source file under csrc/
SOURCES = {"fused_topk": "fused_topk.cu", "ivf_topk": "ivf_topk.cu",
           "ivf_pruned_topk": "ivf_pruned_topk.cu",
           "pruned_fused_topk": "pruned_fused_topk.cu",
           "ivf_pq_adc_topk": "ivf_pq_adc_topk.cu",
           "ivfpq_adc_lut": "ivfpq_adc_lut.cu",
           "beam_scores": "beam_scores.cu", "beam_block": "beam_block.cu"}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: ptxas resource report (-Xptxas -v) of each library built in this process
build_logs: Dict[str, str] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise KernelBuildError("nvcc not found (set CUDA_HOME)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in [CSRC / SOURCES[name]] + sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Compile every named library that is not built yet, one nvcc process
    per source, all started together. Returns name -> library path."""
    names = list(names)
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC),
               "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_logs[n] = out
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exit {proc.returncode}\n{out}")
            continue
        os.replace(tmp, paths[n])
        # wall ms from the start of the parallel build to this nvcc's exit
        # being collected (the launch sentinel's build record)
        SENTINEL.on_build(n, (time.perf_counter() - t0) * 1e3)
    if failed:
        raise KernelBuildError("\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `name`, building it first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _libs[name] = lib
        return lib


def check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C launcher returned a nonzero cudaError_t."""
    if rc != 0:
        fn = lib.dingo_cuda_error_string
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(
            f"{what}: CUDA error {rc} ({fn(rc).decode(errors='replace')})"
        )


def same_cuda_device(*tensors) -> bool:
    dev = tensors[0].device
    return dev.type == "cuda" and all(t.device == dev for t in tensors)
