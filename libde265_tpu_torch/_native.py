"""ctypes bindings to the native tde265 core (libtde265.so).

A copy of ``libde265_tpu/_native.py``, kept here so that the port never
imports the JAX package; both load the same ``build/libtde265.so``.

The native library provides the de265.h-compatible C API plus the tde265_*
FrameProgram tensor-export extensions (native/src/capi.cc).

The build is safe for concurrent processes: ``build_tree`` takes an
exclusive lock on ``build/.native.lock`` and, holding it, configures the
tree (once) and builds every target.  Several processes that start on an
incomplete tree at once (test workers, say) queue on the lock: one builds,
the others find the tree complete.  Without the lock, one process relinks
``libtde265.so`` while another links a tool against it.
"""
from __future__ import annotations

import ctypes as ct
import fcntl
import subprocess
from pathlib import Path

_REPO = Path(__file__).resolve().parent.parent
_BUILD = _REPO / "build"
_LIB_PATH = _BUILD / "libtde265.so"
LOCK_NAME = ".native.lock"

_built = set()   # build directories this process has brought up to date


def _run(cmd, cwd: Path):
    r = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"native build: {' '.join(cmd)} failed "
                           f"({r.returncode}):\n{r.stdout}\n{r.stderr}")


def build_tree(build: Path = _BUILD, source: Path = _REPO / "native") -> Path:
    """Configure `build` from the CMake tree `source` (if it has no
    build.ninja) and build all its targets, under an exclusive lock on
    `build`/.native.lock; once per process and build directory (a no-op
    ninja is cheap, and a lone library file says nothing of the tools).
    Raises with the build's output on failure."""
    build = Path(build)
    if build in _built:
        return build
    build.mkdir(parents=True, exist_ok=True)
    with open(build / LOCK_NAME, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not (build / "build.ninja").exists():
                _run(["cmake", "-G", "Ninja", str(source)], build)
            _run(["ninja"], build)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    _built.add(build)
    return build


def _ensure_built() -> Path:
    build_tree()
    return _LIB_PATH


class ProgramView(ct.Structure):
    _fields_ = [
        ("poc", ct.c_int32),
        ("width", ct.c_int32),
        ("height", ct.c_int32),
        ("chroma_width", ct.c_int32),
        ("chroma_height", ct.c_int32),
        ("bytes_pp", ct.c_int32),
        ("bit_depth", ct.c_int32 * 3),
        ("plane", ct.c_void_p * 3),
        ("stride", ct.c_int32 * 3),
        ("n_ops", ct.c_int32),
        ("op_kind", ct.c_void_p),
        ("op_raw", ct.c_void_p),
        ("op_stride", ct.c_int32),
        ("n_tus", ct.c_int32),
        ("tu_raw", ct.c_void_p),
        ("tu_stride", ct.c_int32),
        ("n_pus", ct.c_int32),
        ("pu_raw", ct.c_void_p),
        ("pu_stride", ct.c_int32),
        ("n_intras", ct.c_int32),
        ("intra_raw", ct.c_void_p),
        ("intra_stride", ct.c_int32),
        ("n_coeffs", ct.c_int32),
        ("coeff_val", ct.c_void_p),
        ("coeff_pos", ct.c_void_p),
        ("n_refs", ct.c_int32),
        ("ref_plane", (ct.c_void_p * 3) * 16),
        ("ref_poc", ct.c_int32 * 16),
        ("pb_w", ct.c_int32),
        ("pb_h", ct.c_int32),
        ("qp_y", ct.c_void_p),
        ("nonzero_coeff", ct.c_void_p),
        ("deblock_flags", ct.c_void_p),
        ("cu_info", ct.c_void_p),
        ("sao_raw", ct.c_void_p),
        ("sao_stride", ct.c_int32),
        ("ctb_w", ct.c_int32),
        ("ctb_h", ct.c_int32),
        ("slice_idx", ct.c_void_p),
        ("n_slices", ct.c_int32),
        ("slice_records", ct.c_void_p),
        ("scaling_enabled", ct.c_int32),
        ("scaling_factors", ct.c_void_p),
        ("slice_addr", ct.c_void_p),
        ("tile_id", ct.c_void_p),
        ("across_tiles", ct.c_int32),
        ("ctb_size", ct.c_int32),
        ("n_pcms", ct.c_int32),
        ("pcm_raw", ct.c_void_p),
        ("pcm_stride", ct.c_int32),
        ("pcm_data", ct.c_void_p),
        ("n_pcm_data", ct.c_int32),
        ("pcm_bit_depth", ct.c_int32 * 2),
        ("pcm_loop_filter_disable", ct.c_int32),
        ("pu_idx", ct.c_void_p),
        ("ip_step", ct.c_void_p),
        ("ip_slot", ct.c_void_p),
        ("ip_rrow", ct.c_void_p),
        ("ip_flags", ct.c_void_p),
        ("ip_edge", ct.c_void_p),
        ("ip_border_pos", ct.c_void_p),
        ("ip_border_sub", ct.c_void_p),
        ("ip_border_off", ct.c_void_p),
        ("ip_n_border", ct.c_int32),
    ]


_lib = None


def lib() -> ct.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    path = _ensure_built()
    L = ct.CDLL(str(path))

    L.de265_new_decoder.restype = ct.c_void_p
    L.de265_free_decoder.argtypes = [ct.c_void_p]
    L.de265_push_data.argtypes = [ct.c_void_p, ct.c_void_p, ct.c_int,
                                  ct.c_int64, ct.c_void_p]
    L.de265_push_NAL.argtypes = [ct.c_void_p, ct.c_void_p, ct.c_int,
                                 ct.c_int64, ct.c_void_p]
    L.de265_flush_data.argtypes = [ct.c_void_p]
    L.de265_decode.argtypes = [ct.c_void_p, ct.POINTER(ct.c_int)]
    L.de265_reset.argtypes = [ct.c_void_p]
    L.de265_peek_next_picture.argtypes = [ct.c_void_p]
    L.de265_peek_next_picture.restype = ct.c_void_p
    L.de265_get_next_picture.argtypes = [ct.c_void_p]
    L.de265_get_next_picture.restype = ct.c_void_p
    L.de265_release_next_picture.argtypes = [ct.c_void_p]
    L.de265_get_warning.argtypes = [ct.c_void_p]
    L.de265_get_image_width.argtypes = [ct.c_void_p, ct.c_int]
    L.de265_get_image_height.argtypes = [ct.c_void_p, ct.c_int]
    L.de265_get_chroma_format.argtypes = [ct.c_void_p]
    L.de265_get_bits_per_pixel.argtypes = [ct.c_void_p, ct.c_int]
    L.de265_get_image_plane.argtypes = [ct.c_void_p, ct.c_int,
                                        ct.POINTER(ct.c_int)]
    L.de265_get_image_plane.restype = ct.c_void_p
    L.de265_get_image_PTS.argtypes = [ct.c_void_p]
    L.de265_get_image_PTS.restype = ct.c_int64
    L.de265_set_parameter_bool.argtypes = [ct.c_void_p, ct.c_int, ct.c_int]
    L.de265_set_parameter_int.argtypes = [ct.c_void_p, ct.c_int, ct.c_int]
    L.de265_get_parameter_bool.argtypes = [ct.c_void_p, ct.c_int]
    L.de265_set_limit_TID.argtypes = [ct.c_void_p, ct.c_int]
    L.de265_start_worker_threads.argtypes = [ct.c_void_p, ct.c_int]
    L.de265_get_highest_TID.argtypes = [ct.c_void_p]
    L.de265_get_version.restype = ct.c_char_p

    L.tde265_set_keep_programs.argtypes = [ct.c_void_p, ct.c_int]
    L.tde265_set_parse_only.argtypes = [ct.c_void_p, ct.c_int]
    L.tde265_num_programs.argtypes = [ct.c_void_p]
    L.tde265_get_program.argtypes = [ct.c_void_p, ct.c_int,
                                     ct.POINTER(ProgramView)]
    L.tde265_clear_programs.argtypes = [ct.c_void_p]
    L.tde265_execute_program_scalar.argtypes = [ct.c_void_p, ct.c_int,
                                                ct.c_int, ct.c_int]
    L.tde265_pack_caps.argtypes = [ct.c_void_p, ct.c_int, ct.c_void_p]
    L.tde265_pack_feed.argtypes = [ct.c_void_p, ct.c_int, ct.c_void_p,
                                   ct.c_int, ct.c_void_p, ct.c_void_p,
                                   ct.c_int64]
    L.tde265_compact_blocks.argtypes = [ct.c_void_p, ct.c_int64, ct.c_int32,
                                        ct.c_int32, ct.c_void_p, ct.c_void_p,
                                        ct.c_int64]
    L.tde265_compact_blocks.restype = ct.c_int64
    _lib = L
    return L
