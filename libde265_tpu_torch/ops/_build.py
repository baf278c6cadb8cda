"""Build and load the port's CUDA kernels (``libde265_tpu_torch/csrc``).

The kernels are CUDA C++ with a plain C interface.  At first use, ``nvcc``
compiles every ``csrc/*.cu`` for ``sm_90a`` into one shared library under
``build/libde265_tpu_torch/`` (named by a hash of the sources and flags, so
an edited source rebuilds), and ``ctypes`` loads it with the argument types
of every entry point declared.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes as ct
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "libde265_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _L = ct.c_void_p, ct.c_int, ct.c_longlong
# entry point -> argument types (pointers and the stream as void*)
SIGNATURES = {
    "tde_densify": [_P, _L, _P, _P, _I, _I, _P],
    "tde_luma_pass": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _I,
                      _I, _P],
    "tde_chroma_pass": [_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _I, _I,
                        _L, _I, _P],
    "tde_sao_plane": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the last nvcc run in this process


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or NVCC)")


def _sources():
    return sorted(_CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(_CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libtde265_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library of the current sources exists."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ct.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            L = ct.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(L, name)
                fn.argtypes = argtypes
                fn.restype = ct.c_int
            _lib = L
        return _lib


def check_launch(name: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")
