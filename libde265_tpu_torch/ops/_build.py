"""Build and load the port's CUDA kernels (``libde265_tpu_torch/csrc``).

The kernels are CUDA C++ with a plain C interface.  At first use, one
``nvcc`` per ``csrc/*.cu``, all started together, compiles each source for
``sm_90a``; the objects are linked into one shared library under
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P, _I, _L = ct.c_void_p, ct.c_int, ct.c_longlong
# entry point -> argument types (pointers and the stream as void*)
SIGNATURES = {
    "tde_densify_bins": [_P, _P],      # (const Args*, stream)
    "tde_residual_bins": [_P, _P],     # (const ResArgs*, stream)
    "tde_deblock_luma": [_P, _P],      # (const Args*, stream)
    "tde_deblock_chroma": [_P, _P],
    "tde_deblock_params": [_P, _P],
    "tde_sao_plane": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "tde_border_gather": [_P, _I, _I, _P, _P, _I, _I, _I, _P, _P, _P],
    "tde_window_scatter": [_P, _I, _I, _P, _P, _P, _P, _I, _I, _P],
    "tde_intra_scan": [_P, _P],
    "tde_intra_bins": [_P, _P],        # (const BinArgs*, stream)
    "tde_scan_threads": [],
    "tde_chain_probe": [_P, _I, _I, _I, _P, _P],
    "tde_mc_stripes": [_P, _L, _I, _P, _P, _I, _I, _P, _I, _P, _I, _I, _I,
                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "tde_paint_pu_idx": [_P, _P, _I, _P, _I, _P, _I, _I, _I, _P],
    "tde_residual_stripes": [_P, _I, _I, _P, _P, _I, _P, _I, _I, _I, _P],
    "tde_expand_blocks": [_P, _P],      # (const Args*, stream)
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the last build in this process
build_log = ""        # ptxas resource usage of the last build


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in sorted(_CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libtde265_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library of the current sources exists."""
    global build_seconds, build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = out.with_name(f"{out.stem}.{src.stem}.{tag}.o")
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs, failed = [], []
    for src, _, proc in jobs:
        _, err = proc.communicate()
        logs.append(f"{src.name}:\n{err}")
        if proc.returncode != 0:
            failed.append(f"nvcc {src.name} failed ({proc.returncode}):\n"
                          f"{err}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = out.with_name(f"{out.name}.{tag}")
        r = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp),
                            *map(str, objs)], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{r.stderr}")
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    return out


def lib() -> ct.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is not None:      # loaded: no lock on the launch path
        return _lib
    with _lock:
        if _lib is None:
            L = ct.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(L, name)
                fn.argtypes = argtypes
                fn.restype = ct.c_int
            _lib = L
        return _lib


def variant(src: Path, defines) -> ct.CDLL:
    """One source built alone with extra preprocessor definitions (e.g.
    ``["TDE_SCAN_THREADS=256"]``) into a library of its own, cached by the
    source, flags and definitions, and loaded with the argument types of
    the entry points it has.  For measurement and tests, never the decode's
    path."""
    src = Path(src)
    flags = [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]
    h = hashlib.sha256(" ".join(flags).encode() + src.read_bytes())
    out = BUILD_DIR / f"{src.stem}_variant_{h.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        r = subprocess.run([_nvcc(), *flags, "-shared", "-o", str(tmp),
                            str(src)], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc {src.name} {defines} failed "
                               f"({r.returncode}):\n{r.stderr}")
        os.replace(tmp, out)
    L = ct.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        if hasattr(L, name):
            fn = getattr(L, name)
            fn.argtypes = argtypes
            fn.restype = ct.c_int
    return L


def check_launch(name: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")
