#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (libde265_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failure raises and the script exits non-zero):
  1. card check: a CUDA device must be present; prints the card's name and
     power limit as nvidia-smi reports them;
  2. build: the native parser library (cmake + ninja, the library target
     only) and the port's CUDA kernels (one nvcc per source, in parallel,
     sm_90a); prints the intra kernels' ptxas resource lines;
  3. main path at 1080p, each run with the launch counts set to 0 before
     it and read after it, every frame held bit-exact against the scalar
     oracle's planes:
       a. a 1920x1088 P-GOP (8 frames, intra period 4) made by the in-repo
          encoder, decoded with PipelinedDecoder() (the default device);
       b. a 1920x1088 all-intra GOP (4 frames, intra period 1), decoded
          with PipelinedDecoder(): the intra scan, one persistent kernel
          launch and one launch of its records' kernel (intra_bins) per
          picture with intra blocks and none for the others;
     each run with every picture packed by the native feed packer
     (FeedPacker.pack_native; the packer's counters), then the parse of
     each stream alone (host ms per picture), the native
     against the numpy packer's host ms on every picture of both streams
     (their buffers equal word for word), synced per-picture milliseconds
     and launches (I and P; B1, B4, the residual bins, the deblocking
     edge parameters, B8 and B9 once each in every picture),
     the synced feed pack (whichever packer ran), intra scan and
     deblocking of single pictures, the deblocking, the residual
     and the feed upload sections of the first I and P picture alone
     (synced ms, device ms and device operations; the upload also as the
     whole feed), and one all-intra picture under torch.profiler
     (device busy and idle share, the intra kernels by name);
  4. kernels vs plain: each kernel against its plain PyTorch version on
     the card, on seeded random inputs at the 1080p shapes and on the
     inputs captured from the first I and P picture (the intra kernels on
     the first I picture's whole scan, the scan's records timed on the I
     picture's call); exact equality; CUDA-event times of
     both, each kernel's device time (torch.profiler, profiled again while
     it sees no device time, up to five times, else the run fails) and
     bound; B5 and the residual bins timed
     on the I picture's calls as well (B5: bins with no segment), and
     B1's, B4's, the residual bins', B5's, B2's, B8's, B9's and the edge
     parameters' calls checked to run no device work
     besides their kernel (intra_bins: its kernel and one memset); B4
     (every size bin of a picture in one call) and the residual bins
     also on random bins of the P picture's sizes; B1's library
     yardstick, the one indexing call of its plain version, timed.  B8
     and B9 (both edge orientations of a plane in one launch) are also
     held through the per-orientation wrappers.  The persistent scan
     also on synthetic pictures whose steps share all four luma sizes.
     The separate B6 and B7 kernels (the JAX package's two Pallas
     kernels' counterparts) are held here only: the decode runs B6's
     gather and B7's store inside the persistent scan;
  5. small streams, bit-exact on the card: 104x72 with CTB 64 (two intra
     sizes per plane, a chroma plane that is not a multiple of 8 wide or
     high), a 416x240 B/weighted/2-ref stream under both formulations, two
     4:4:4 streams with cross-component prediction (lossless and lossy,
     intra and inter pictures; packed by numpy, against the oracle), and
     two pictures with RDPCM flags injected into their TU records (a
     lossless picture, and the first 104x72 picture with transform skip
     on its 4x4 TUs), each equal to the port's decode on the CPU;
  6. pictures with more than 8 references: a 1920x1088 stream of 12
     frames of periodic stripes (up to 15 references; pictures 9-11 read
     9-11 and go to pipeline.reconstruct) decoded with PipelinedDecoder()
     as in phase 3 (counts set to 0 before, read after, every frame
     bit-exact, 3 pictures through the pipeline), then picture by picture
     (synced ms of the routed and the fused pictures; the edge parameters,
     B8, B9 once and B10 three times in a routed picture, no other
     kernel), the first routed picture's edge-parameter, B8, B9 and B10
     calls against their plain versions, the
     last routed picture's stages (residuals, MC, intra, deblocking, SAO;
     synced ms, device_intra False and True in turns), that picture on the
     card against the CPU, and a 10-bit reconstruct_stream chain (64x48,
     3 pictures) against the oracle, its planes uint16;
  7. the multi-device paths of libde265_tpu_torch.parallel, every device
     entry cuda:0, each main-path run with the counts set to 0 before it
     and read after it, every frame bit-exact:
       a. GopParallelDecoder(["cuda:0"] * 4) on a 1920x1088 P-GOP of 12
          frames, intra period 4 (3 segments, so the fourth entry idles),
          every kernel of the production formulation launched (B2, B3
          and B5 at least once per P picture); then k = 1, 2, 4 and
          PipelinedDecoder() in turns over 3 passes (fps), and the
          parse of 1, 2 and 4 segments at once (ms per picture per
          thread);
       b. ShardedTileDecoder over 8 entries on two 1920x1088 streams with
          CTB 32 and 4x2 tiles of 480x544 (4 frames, intra period 8), one
          gated and one filtering across tiles (the halo exchange): synced
          ms and launches per picture (the edge parameters, B8 and B9 8,
          B10 24: 3 per tile, in the tile program or in the halo filter);
          then picture 0 of each stream again with its kernel calls
          recorded, each call of B4, the residual bins, the scan, the edge
          parameters, B8, B9 and B10 (the tile shapes, and the halo-padded
          ones with their masks) against its plain version, exact;
       c. sharded_filter_pipeline at 1088x1928 with 4 row shards, equal
          to the single-device composition of luma_pass and to that of
          its plain version, B8 8 times;
  8. the per-op DeviceDecoder (libde265_tpu_torch.tpu_decode: its DPB
     over pipeline.reconstruct with the intra wavefront) and programs
     without the native intra plan, each main-path run with the counts set
     to 0 before it and read after it, every frame bit-exact:
       a. the first GOP of the phase-3 1080p P-GOP (an I picture and 3
          P pictures: an I picture takes seconds of host time here, so
          one, not the stream's two) through DeviceDecoder() (the default
          device) from parse-only programs: synced ms per I and P
          picture, the edge parameters, B8 and B9 once and B10 three
          times in every picture (no other kernel: the rest is PyTorch),
          the intra wavefront's intra_wave_kernel calls and host plan ms
          per picture, picture 0's edge-parameter, B8, B9 and B10 calls
          against their plain versions, then one
          P and one I picture decoded again under torch.profiler (device
          busy ms, idle share, device operations);
       b. the phase-6 stripe stream through DeviceDecoder(), pictures 9-11
          (more than 8 references, which the JAX module cannot decode)
          counted;
       c. the phase-3 all-intra pictures with ip=None and src=None through
          FusedDecoder(): packed by numpy with the records of
          feed._plan_intra (its host ms per picture beside the native
          records'), one scan launch per picture, picture 0's records
          equal to the native plan's word for word.

The kernels line's launches are the sums over the main-path runs of
phases 3, 6, 7 and 8; intra_bins is checked at one launch a picture with
intra records (a tile with them, in 7b) and none for the others in each
of them, and every captured call of it against its plain version (phase
4, each scan held in phases 4 and 5, phase 7b).  The last three lines of
stdout are the kernels JSON object (all fourteen rows: B1-B10, the
deblocking edge parameters, the persistent scan and its records, the
residual bins),
the card's nvidia-smi line and the result line {"ok": true, "device":
{...}}.
Nothing here imports JAX or the JAX package libde265_tpu.
"""
from __future__ import annotations

import importlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
BUILD = REPO / "build"
sys.path.insert(0, str(REPO))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
INT_OPS_PER_S = 67e12       # H100 SXM peak outside the tensor cores

B1, B2, B3 = "B1 expand_blocks", "B2 paint_pu_idx", "B3 mc_stripes"
B4, B5 = "B4 densify_bins", "B5 residual_stripes"
B6, B7 = "B6 border_gather", "B7 window_scatter"
B8, B9 = "B8 deblock_luma (V+H)", "B9 deblock_chroma (V+H)"
B10 = "B10 sao_plane_fused"
PARAMS = "B8+B9 deblock_params (edge parameters)"
SCAN = "B6+B7 intra_scan (persistent)"
BINS = "intra_bins (scan records)"
RES = "residual_bins (dequant + inverse transform)"

# family -> (source, TPU kernel it replaces, ops module, launch counter,
#            integer operations per output element, counted from the source)
KERNELS = {
    B1: ("libde265_tpu_torch/csrc/expand.cu",
         "libde265_tpu/fused_decode.py:1371", "expand", "launches", 1),
    B2: ("libde265_tpu_torch/csrc/mc.cu",
         "libde265_tpu/ops/mc_pallas.py:454", "mc_seg", "paint_launches",
         100),
    B3: ("libde265_tpu_torch/csrc/mc.cu",
         "libde265_tpu/ops/mc_pallas.py:380", "mc_seg", "mc_launches", 60),
    B4: ("libde265_tpu_torch/csrc/coef.cu",
         "libde265_tpu/ops/coef_pallas.py:165", "coef_cuda", "launches", 2),
    B5: ("libde265_tpu_torch/csrc/mc.cu",
         "libde265_tpu/ops/mc_pallas.py:619", "mc_seg", "residual_launches",
         2),
    B8: ("libde265_tpu_torch/csrc/deblock.cu",
         "libde265_tpu/ops/deblock_pallas.py:212,223", "deblock_cuda",
         "luma_launches", 30),
    B9: ("libde265_tpu_torch/csrc/deblock.cu",
         "libde265_tpu/ops/deblock_pallas.py:263,282", "deblock_cuda",
         "chroma_launches", 20),
    B10: ("libde265_tpu_torch/csrc/sao.cu",
          "libde265_tpu/ops/sao_pallas.py:120", "sao_cuda", "launches", 25),
    # no TPU kernel: the JAX program derives the parameters with XLA ops
    PARAMS: ("libde265_tpu_torch/csrc/deblock.cu",
             "libde265_tpu/tpu_decode.py:370 (_edge_params_jnp, XLA)",
             "deblock_cuda", "param_launches", 15),
    SCAN: ("libde265_tpu_torch/csrc/intra.cu",
           "libde265_tpu/ops/intra_window_pallas.py:133,252",
           "intra_cuda", "scan_launches", 60),
    # no TPU kernel: the JAX program unpacks and scatters the records with
    # XLA ops
    BINS: ("libde265_tpu_torch/csrc/intra_bins.cu",
           "libde265_tpu/fused_decode.py:268,480 (_unpack_irec, "
           "_scatter_intra_bins, XLA)", "intra_cuda", "bin_launches", 1),
    # no TPU kernel: the JAX program dequantises and transforms with XLA
    # ops; a sample's least work is its dequantisation and one product of
    # each stage with their roundings
    RES: ("libde265_tpu_torch/csrc/coef.cu",
          "libde265_tpu/ops/transform.py:113 (residual_batch, XLA)",
          "coef_cuda", "transform_launches", 10),
}
# The separate B6 and B7 kernels, the counterparts of the JAX package's two
# Pallas kernels: the decode runs B6's gather and B7's store inside the
# persistent scan, one launch per picture, so these two are held against
# their plain versions in phase 4 only, on the first I picture's step
# sequence (no main-path launch check; their rows show 0 launches).
HELD = {
    B6: ("libde265_tpu_torch/csrc/intra.cu",
         "libde265_tpu/ops/intra_window_pallas.py:133",
         "intra_window", "gather_launches", 8),
    B7: ("libde265_tpu_torch/csrc/intra.cu",
         "libde265_tpu/ops/intra_window_pallas.py:252",
         "intra_window", "scatter_launches", 6),
}
ALL = {**KERNELS, **HELD}
NAMES = list(ALL)
ROWS = [B1, B2, B3, B4, B5, B6, B7, B8, B9, PARAMS, B10, SCAN,
        BINS, RES]  # kernels line
INTRA = (SCAN, B6, B7)

# wrapper (module, function) -> family
WRAPPERS = {("expand", "expand_blocks"): B1,
            ("mc_seg", "paint_pu_idx"): B2,
            ("mc_seg", "mc_stripes"): B3,
            ("coef_cuda", "densify_bins"): B4,
            ("coef_cuda", "densify_bin"): B4,
            ("coef_cuda", "residual_bins"): RES,
            ("mc_seg", "residual_stripes"): B5,
            ("deblock_cuda", "deblock_luma"): B8,
            ("deblock_cuda", "deblock_chroma"): B9,
            ("deblock_cuda", "luma_pass"): B8,
            ("deblock_cuda", "luma_pass_h"): B8,
            ("deblock_cuda", "chroma_pass_stacked"): B9,
            ("deblock_cuda", "chroma_pass_stacked_h"): B9,
            ("deblock_cuda", "deblock_params"): PARAMS,
            ("sao_cuda", "sao_plane_fused"): B10,
            ("intra_cuda", "intra_scan"): SCAN,
            ("intra_cuda", "intra_bins"): BINS,
            ("intra_window", "border_gather"): B6,
            ("intra_window", "window_scatter"): B7}
FAMILY = {fn: fam for (_, fn), fam in WRAPPERS.items()}
MODULE = {fn: m for (m, fn) in WRAPPERS}
INPLACE = ("window_scatter", "residual_bins")   # update their first argument
# the kernel whose device time a call's row counts, where a call's device
# work holds more (the copy of an in-place kernel's input)
DEVICE_MARK = {"residual_bins": "residual_bins_kernel"}
# Device ms of the earlier designs (PERF.md, NVIDIA H100 80GB HBM3, 700.00
# W), printed beside this run's: B3, B5 and B2 per 1080p P picture in their
# first designs (B3 and B5: one CTA per segment slot of a watermark x bands
# grid, B5 over a zero-filled output; B2: one thread per band and column,
# each walking every segment of its band), B8 and B9 per 1080p P picture in
# their first design (one launch per edge orientation, one thread per
# segment and edge, each on a clone of a zero-padded copy of the plane),
# and B4 per 1080p P picture in its first design (one launch per size bin,
# a warp per TU, over a zero-filled output)
B3_FIRST_DESIGN_MS = 0.2100
B5_FIRST_DESIGN_MS = 0.0737
B2_FIRST_DESIGN_MS = 0.0191
B8_FIRST_DESIGN_MS = 0.0280
B9_FIRST_DESIGN_MS = 0.0156
# The persistent scan per 1080p I picture in its first design (one
# 1024-thread CTA per plane walking the (step, size bin) pairs, four block
# barriers and two dependent global round trips each)
SCAN_FIRST_DESIGN_MS = 1.8679
B4_FIRST_DESIGN_MS = 0.0132
# B1 per 1080p P picture in its first design (one 256-thread CTA per output
# block, 4-byte loads and stores, inv re-read by every thread)
B1_FIRST_DESIGN_MS = 0.0025


def log(*a):
    print(*a, flush=True)


def ops_module(name):
    return importlib.import_module(f"libde265_tpu_torch.ops.{name}")


# ---------------------------------------------------------------------------
# phase 1 + 2
# ---------------------------------------------------------------------------

def card_check():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script measures the port on a CUDA card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}  (torch {torch.__version__}, CUDA {torch.version.cuda})")
    return smi


def build_native():
    """The native tree (native/CMakeLists.txt) under the port's build lock
    (libde265_tpu_torch._native.build_tree); returns the seconds it took."""
    from libde265_tpu_torch import _native
    t0 = time.perf_counter()
    _native.build_tree()
    return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

def synth_frame(t, base, xx, yy):
    """Moving gradient + fixed texture (the 1080p benchmark content)."""
    y = ((xx + 4 * t) % 255 // 2 + (yy + 2 * t) % 128 + base) % 235
    cb = (xx[::2, ::2] // 2 + 3 * t) % 200 + 20
    cr = (yy[::2, ::2] // 2 + 2 * t) % 200 + 20
    return y.astype(np.uint8), cb.astype(np.uint8), cr.astype(np.uint8)


def make_stream(path: Path, w, h, frames, qp, params, ctb=64):
    """Encode (or reuse) a stream under build/; returns (bytes, seconds)."""
    if path.exists():
        return path.read_bytes(), 0.0
    from libde265_tpu_torch import Encoder
    rng = np.random.default_rng(42)
    base = rng.integers(0, 40, (h, w), np.int16)
    yy, xx = np.mgrid[0:h, 0:w]
    t0 = time.perf_counter()
    with Encoder(qp=qp, ctb_size=ctb) as enc:
        for k, v in params.items():
            enc.set_parameter(k, v)
        data = b"".join(enc.encode(*synth_frame(t, base, xx, yy))
                        for t in range(frames)) + enc.finish()
    dt = time.perf_counter() - t0
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(data)
    return data, dt


def corpus_content(W, H, t):
    """The frame content of scripts/make_corpus.py (8-bit 4:2:0)."""
    yy, xx = np.mgrid[0:H, 0:W]
    y = ((xx * 3 + yy * 2 + 11 * t) % 220 + 16).astype(np.uint8)
    y[(yy // 8 + xx // 8 + t) % 5 == 0] += 20
    cb = ((xx[::2, ::2] + 5 * t) % 220 + 16).astype(np.uint8)
    cr = ((yy[::2, ::2] * 2 - 3 * t) % 220 + 16).astype(np.uint8)
    return y, cb, cr


def make_conf_window_stream(path: Path):
    """The corpus stream conf_window_104x72 (scripts/make_corpus.py): 6
    frames of 104x72, CTB 64, intra period 4, QP 30, SEI hashes.  Its
    chroma planes (52x36) are not a multiple of 8 wide or high, and its
    intra pictures hold two block sizes per plane (luma 8 and 16, chroma 4
    and 8), which no 1080p stream here does."""
    if path.exists():
        return path.read_bytes()
    from libde265_tpu_torch import Encoder
    with Encoder(qp=30, ctb_size=32) as enc:
        enc.set_parameter("sei-hash", True)
        enc.set_parameter("ctb-size", 64)
        enc.set_parameter("intra-period", 4)
        data = b"".join(enc.encode(*corpus_content(104, 72, t), pts=t)
                        for t in range(6)) + enc.finish()
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(data)
    return data


def staircase(h, w, t, chroma="444"):
    """An 8x8-block brightness staircase moved 2t samples to the right
    (the content of the repository's CCP and RDPCM tests at t = 0): luma
    residuals stay non-negative, where CCP engages.  4:4:4: chroma follows
    luma; 4:2:0: flat chroma."""
    y = np.zeros((h, w), int)
    lvl = 20
    for by in range(0, h, 8):
        for bx in range(0, w, 8):
            lvl += 2 if chroma == "444" else 3
            y[by:by + 8, bx:bx + 8] = lvl
    if chroma == "444":
        planes = (y, 16 + y * 7 // 8, 16 + y * 3 // 4)
    else:
        planes = (y, np.full((h // 2, w // 2), 128),
                  np.full((h // 2, w // 2), 90))
    return tuple(np.roll(a.clip(0, 255), 2 * t, axis=1).astype(np.uint8)
                 for a in planes)


def make_ccp_stream(path: Path, lossless):
    """Four 64x64 4:4:4 pictures (staircase), intra period 4, QP 27,
    cross-component prediction on, lossless or lossy; encoded (or reused)
    as make_stream does."""
    if path.exists():
        return path.read_bytes()
    from libde265_tpu_torch import Encoder
    with Encoder(qp=27, chroma_format="444") as enc:
        if lossless:
            enc.set_parameter("lossless", True)
        enc.set_parameter("ccp", True)
        enc.set_parameter("intra-period", 4)
        data = b"".join(enc.encode(*staircase(64, 64, t))
                        for t in range(4)) + enc.finish()
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(data)
    return data


def rdpcm_programs(conf_prog):
    """Two pictures with TU_RDPCM injected into their TU records, without
    their native source (src = None, so the numpy packer packs the edited
    records): a lossless 64x64 4:2:0 staircase, every other coded TU
    flagged (its TUs bypass transform and quantisation), and conf_prog
    (the first 104x72 picture) with transform skip and RDPCM on its coded
    4x4 TUs; horizontal and vertical in turn."""
    import dataclasses
    from libde265_tpu_torch import Encoder
    from libde265_tpu_torch.decoder import (TU_RDPCM, TU_RDPCM_VERTICAL,
                                            TU_TRANSFORM_SKIP)
    with Encoder(qp=27) as enc:
        enc.set_parameter("lossless", True)
        data = enc.encode(*staircase(64, 64, 0, "420")) + enc.finish()
    _, (prog,) = oracle_programs(data)
    out = []
    for name, p, lg, extra in (("lossless 64x64", prog, None, 0),
                               ("104x72 picture 0, 4x4 transform skip",
                                conf_prog, 2, TU_TRANSFORM_SKIP)):
        tus = p.tus.copy()
        coded = tus["ncoeff"] > 0
        sel = np.nonzero(coded & (tus["log2_size"] == lg))[0] \
            if lg else np.nonzero(coded)[0][::2]
        if len(sel) < 8:
            raise AssertionError(f"RDPCM {name}: {len(sel)} TUs to flag")
        tus["flags"][sel] |= TU_RDPCM | extra
        tus["flags"][sel[1::2]] |= TU_RDPCM_VERTICAL
        out.append((name, dataclasses.replace(p, tus=tus, src=None)))
    return out


def make_stripe_stream(path: Path, w=1920, h=1088, frames=12, block=8):
    """Pictures that read many references, encoded (or reused) as
    make_stream does: 16 vertical stripes of w // 16 samples, stripe j
    showing one of j + 1 textures of seeded random levels on block x block
    luma squares (and on block/2 squares in chroma, a texture of its own)
    in turn, so that it repeats every j + 1 pictures and picture t finds an
    exact match for stripe j only in picture t - j - 1.  Random levels
    cost less to code than uniform noise, and no shift of one texture
    matches another.  QP 32, CTB 32, up to 15 references, intra period 32,
    SAO on: picture t reads t references."""
    if path.exists():
        return path.read_bytes(), 0.0
    from libde265_tpu_torch import Encoder
    sw = w // 16
    rng = np.random.default_rng(7)
    tex = [[[rng.integers(16, 236, (h // block + 1, sw // block + 1))
             for _ in range(j + 1)] for j in range(16)] for _ in range(2)]
    one = np.ones((block, block))
    t0 = time.perf_counter()
    with Encoder(qp=32, ctb_size=32) as enc:
        enc.set_parameter("num-refs", 15)
        enc.set_parameter("intra-period", 32)
        enc.set_parameter("sao", True)
        data = b""
        for t in range(frames):
            y = np.zeros((h, w), np.uint8)
            cb = np.zeros((h // 2, w // 2), np.uint8)
            for j in range(16):
                k = t % (j + 1)
                y[:, j * sw:(j + 1) * sw] = np.kron(tex[0][j][k], one)[
                    :h, :sw]
                cb[:, j * sw // 2:(j + 1) * sw // 2] = np.kron(
                    tex[1][j][k], one[::2, ::2])[:h // 2, :sw // 2]
            data += enc.encode(y, cb, 255 - cb)
        data += enc.finish()
    dt = time.perf_counter() - t0
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(data)
    return data, dt


def make_10bit_gop(path: Path):
    """Three 64x48 10-bit 4:2:0 pictures, intra period 4, QP 30, CTB 32
    (the content of tests/_torch_common.gop): samples above 255, for the
    pipeline's reconstruct_stream chain."""
    if path.exists():
        return path.read_bytes()
    from libde265_tpu_torch import Encoder
    w, h = 64, 48
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    with Encoder(qp=30, ctb_size=32, bit_depth=10) as enc:
        enc.set_parameter("intra-period", 4)
        data = b""
        for f in range(3):
            y = (128 + 60 * np.sin((xx + 3 * f) * 0.11)
                 * np.cos((yy + 2 * f) * 0.07)).clip(0, 255)
            cb = (100 + 40 * np.sin((xx[::2, ::2] + f) * 0.07)).clip(0, 255)
            cr = (150 - 40 * np.cos((yy[::2, ::2] + f) * 0.06)).clip(0, 255)
            data += enc.encode(*((a * 4).astype(np.uint16)
                                 for a in (y, cb, cr)))
        data += enc.finish()
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(data)
    return data


def synthetic_intra(seed, H=128, W=128, bit_depth=8):
    """A seeded synthetic intra scan with all four sizes in shared steps.

    Per plane (luma H x W, two 4:2:0 chroma planes) a random z-order
    quadtree of blocks (luma 4 to 32, chroma 4 to 16), about half of
    them inter (reconstructed before the scan, as in a P picture) and the
    rest intra, scheduled by the native rule (native/src/intraplan.cc
    build_intra_plan): a block's step is the largest 1 + writer step over
    the 4x4 cells of its available border samples (0 for an inter cell),
    moved on past steps whose bin is full (WAVE_CAP).  A border sample is
    available when it lies in the plane in a block decoded before
    (z-order), less about a tenth dropped at random; filter and edge flags
    follow the native rule for luma.  Returns (planes [3] numpy int32, irec
    [n, IREC_COLS] int32 as the feed's intra records, nsteps [3], {lg:
    residual rows [n, s, s]})."""
    from libde265_tpu_torch.feed import AVAIL_WORDS, IREC_COLS, WAVE_CAP
    rng = np.random.default_rng(seed)
    sc = 1 << (bit_depth - 8)
    recs, planes = [], []
    nsteps = np.zeros(3, np.int32)
    n_res = {lg: 0 for lg in (2, 3, 4, 5)}
    for c, (h, w, smax) in enumerate(((H, W, 32), (H // 2, W // 2, 16),
                                      (H // 2, W // 2, 16))):
        yy, xx = np.mgrid[0:h, 0:w]
        planes.append((((60 + yy // 2 + xx // 3 + 40 * c) * sc +
                        rng.integers(0, 3 * sc, (h, w))) % (1 << bit_depth)
                       ).astype(np.int32))
        order = []

        def split(y, x, s):
            if y >= h or x >= w:
                return
            if s > 4 and (rng.random() < 0.55 or y + s > h or x + s > w):
                for dy, dx in ((0, 0), (0, s // 2), (s // 2, 0),
                               (s // 2, s // 2)):
                    split(y + dy, x + dx, s // 2)
            else:
                order.append((y, x, s))

        for y in range(0, h, smax):
            for x in range(0, w, smax):
                split(y, x, smax)
        wmap = np.zeros((h // 4, w // 4), np.int32)
        done = np.zeros((h, w), bool)
        counts = {lg: [] for lg in (2, 3, 4, 5)}
        for y, x, s in order:
            if rng.random() < 0.5:       # an inter block
                done[y:y + s, x:x + s] = True
                continue
            lg = s.bit_length() - 1
            nb, n2 = 4 * s + 1, 2 * s
            j = np.arange(nb)
            by = np.where(j < n2, y + n2 - 1 - j, y - 1)
            bx = np.where(j <= n2, x - 1, x + j - n2 - 1)
            byc, bxc = by.clip(0, h - 1), bx.clip(0, w - 1)
            av = ((by >= 0) & (by < h) & (bx >= 0) & (bx < w) &
                  done[byc, bxc] & (rng.random(nb) >= 0.1))
            flags = 8 if av.any() else 9
            step = int(wmap[byc[av] // 4, bxc[av] // 4].max(initial=0))
            cnt = counts[lg]
            while True:
                cnt.extend([0] * (step + 1 - len(cnt)))
                if cnt[step] < WAVE_CAP[lg]:
                    break
                step += 1
            slot = cnt[step]
            cnt[step] += 1
            wmap[y // 4:(y + s) // 4, x // 4:(x + s) // 4] = step + 1
            done[y:y + s, x:x + s] = True
            mode = int(rng.choice([0, 1, 10, 26])) if rng.random() < 0.4 \
                else int(rng.integers(0, 35))
            edge = 0
            if c == 0 and s < 32:
                edge = {1: 1, 26: 2, 10: 3}.get(mode, 0)
            if c == 0 and mode != 1 and s != 4:
                mind = min(abs(mode - 26), abs(mode - 10))
                thr = {8: 7, 16: 1, 32: 0}[s]
                if mode == 0 or mind > thr:
                    flags |= 2
                    if s == 32 and rng.random() < 0.7:
                        flags |= 4
            rrow = -1
            if rng.random() < 0.7:
                rrow, n_res[lg] = n_res[lg], n_res[lg] + 1
            aw = np.packbits(np.pad(av, (0, 32 * AVAIL_WORDS - nb)),
                             bitorder="little").view(np.int32)
            recs.append([mode, edge, y, x, flags, rrow, step, slot, c, lg,
                         *aw])
            nsteps[c] = max(nsteps[c], step + 1)
    irec = np.array(recs, np.int32)
    assert irec.shape[1] == IREC_COLS
    res = {lg: rng.integers(-40 * sc, 41 * sc,
                            (max(n, 1), 1 << lg, 1 << lg)).astype(np.int32)
           for lg, n in n_res.items()}
    return planes, irec, nsteps, res


def full_bin_intra(seed, bit_depth=8, H=128, W=128):
    """A seeded synthetic intra scan whose 4x4 bins are full: per plane
    (luma H x W, two 4:2:0 chroma planes) a 4x4 block at every (8a, 8b) in
    step 0 (256 luma blocks at 128x128: K = WAVE_CAP[2], all valid), no
    valid block in step 1, and a 4x4 block at every (8a + 4, 8b + 4) in
    step 2, whose borders read step 0's blocks and samples of no block.  A
    border sample is available when it lies in the plane and in no block
    of the same or a later step (the scheduler's rule), less about a tenth
    dropped at random; modes at random, the edge flags of the native rule
    for luma.  Returns synthetic_intra's (planes, irec, nsteps, {lg:
    residual rows})."""
    from libde265_tpu_torch.feed import AVAIL_WORDS, IREC_COLS
    rng = np.random.default_rng(seed)
    sc = 1 << (bit_depth - 8)
    recs, planes, n_res = [], [], 0
    s, nb, n2 = 4, 17, 8
    j = np.arange(nb)
    for c, (h, w) in enumerate(((H, W), (H // 2, W // 2), (H // 2, W // 2))):
        planes.append(rng.integers(0, 1 << bit_depth, (h, w)).astype(
            np.int32))
        step2 = np.zeros((h, w), bool)     # samples of step-2 blocks
        for y in range(4, h, 8):
            for x in range(4, w, 8):
                step2[y:y + 4, x:x + 4] = True
        for step, off in ((0, 0), (2, 4)):
            slot = 0
            for y in range(off, h, 8):
                for x in range(off, w, 8):
                    by = np.where(j < n2, y + n2 - 1 - j, y - 1)
                    bx = np.where(j <= n2, x - 1, x + j - n2 - 1)
                    inside = (by >= 0) & (by < h) & (bx >= 0) & (bx < w)
                    av = (inside & (rng.random(nb) >= 0.1) &
                          ~(step2[by.clip(0, h - 1), bx.clip(0, w - 1)] &
                            (step == 0)))
                    mode = int(rng.integers(0, 35))
                    edge = {1: 1, 26: 2, 10: 3}.get(mode, 0) if c == 0 else 0
                    rrow = -1
                    if rng.random() < 0.7:
                        rrow, n_res = n_res, n_res + 1
                    aw = np.packbits(np.pad(av, (0, 32 * AVAIL_WORDS - nb)),
                                     bitorder="little").view(np.int32)
                    recs.append([mode, edge, y, x, 8 if av.any() else 9,
                                 rrow, step, slot, c, 2, *aw])
                    slot += 1
    irec = np.array(recs, np.int32)
    assert irec.shape[1] == IREC_COLS
    res = {lg: rng.integers(-40 * sc, 41 * sc, (max(n_res if lg == 2 else 0,
                                                     1), 1 << lg, 1 << lg)
                            ).astype(np.int32) for lg in (2, 3, 4, 5)}
    return planes, irec, np.full(3, 3, np.int32), res


def scan_inputs(intra, dev, bit_depth=8):
    """A synthetic scan (synthetic_intra's or full_bin_intra's result) as
    intra_scan's arguments on `dev`: (padded planes, bins_by_plane,
    bin_res, tables, nsteps, bit depths)."""
    import torch
    from libde265_tpu_torch.feed import bin_depths
    from libde265_tpu_torch.ops import intra_cuda
    from libde265_tpu_torch.ops import intra_window as iw
    planes, irec, nsteps, res = intra
    bins = tuple(sorted({(("y", "cb", "cr")[int(c)], int(lg))
                         for c, lg in irec[:, 8:10]}))
    scap = int(irec[:, 6].max()) + 1
    by_plane = intra_cuda.scatter_records(
        torch.from_numpy(irec).to(dev), bins, scap,
        bin_depths(irec[:, 8], irec[:, 9], irec[:, 6]))
    padded = [iw.pad_plane_for_scan(torch.from_numpy(p).to(dev),
                                    *iw.scan_pad_sizes(*p.shape))
              for p in planes]
    bin_res = {lg: torch.from_numpy(r).to(dev) for lg, r in res.items()}
    tables = {lg: intra_cuda.mode_tables(1 << lg, torch.device(dev))
              for lg in (2, 3, 4, 5)}
    return padded, by_plane, bin_res, tables, nsteps, [bit_depth] * 3


def synthetic_scan_inputs(seed, dev, H=128, W=128, bit_depth=8):
    """synthetic_intra's scan as intra_scan's arguments on `dev`."""
    return scan_inputs(synthetic_intra(seed, H, W, bit_depth), dev,
                       bit_depth)


def oracle_programs(data):
    """Programs with the scalar decoder's planes (the bit-exact oracle)."""
    from libde265_tpu_torch import Decoder
    dec = Decoder(keep_programs=True)
    list(dec.decode_all(data))
    return dec, [dec.get_program(i) for i in range(dec.num_programs())]


def parse_only_programs(data):
    """The programs of a parse-only decode (no planes of their own, no
    reference planes), as PipelinedDecoder's parse thread makes them."""
    from libde265_tpu_torch import Decoder
    dec = Decoder(parse_only=True, keep_programs=True)
    list(dec.decode_all(data))
    return [dec.get_program(i) for i in range(dec.num_programs())]


def assert_bit_exact(outs, progs, what):
    if len(outs) != len(progs):
        raise AssertionError(f"{what}: {len(outs)} frames decoded, oracle "
                             f"has {len(progs)}")
    for i, (planes, prog) in enumerate(zip(outs, progs)):
        for c, pl in enumerate(planes):
            got = pl.cpu().numpy()
            want = prog.planes[c].astype(np.int32)
            if not np.array_equal(got, want):
                bad = np.argwhere(got != want)
                raise AssertionError(
                    f"{what}: frame {i} plane {c}: {len(bad)} samples "
                    f"differ, first at {bad[0].tolist()}")


# ---------------------------------------------------------------------------
# launch counters and input capture
# ---------------------------------------------------------------------------

def reset_counts():
    for v in ALL.values():
        setattr(ops_module(v[2]), v[3], 0)


def read_counts():
    return {n: getattr(ops_module(v[2]), v[3]) for n, v in ALL.items()}


def main_path_run(what, data, progs, routed=0):
    """One main-path run: counts set to 0, PipelinedDecoder() over the
    stream, synchronised, counts read; every frame held bit-exact, every
    picture packed natively but the `routed` ones (more than MAX_REFS
    references), which go to pipeline.reconstruct."""
    import torch
    import libde265_tpu_torch as lt
    pd = lt.PipelinedDecoder()
    reset_counts()
    t0 = time.perf_counter()
    outs = pd.decode_stream(data)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    assert_bit_exact(outs, progs, what)
    pk = pd.fd.packer
    if (pk.native_packs, pk.numpy_packs) != (len(progs) - routed, 0):
        raise AssertionError(f"{what}: {pk.native_packs} pictures packed "
                             f"natively and {pk.numpy_packs} by numpy, of "
                             f"{len(progs)}")
    if pd.fd.pipeline_pictures != routed:
        raise AssertionError(f"{what}: {pd.fd.pipeline_pictures} pictures "
                             f"through the pipeline, expected {routed}")
    log(f"{what}: {len(progs)} frames bit-exact, all packed natively"
        f"{f' but {routed} through pipeline.reconstruct' if routed else ''}; "
        f"e2e "
        f"{len(progs) / dt:.4f} fps ({1000 * dt / len(progs):.1f} "
        f"ms/frame); launches {json.dumps(counts)}")
    return counts, dt


def parse_ms(data):
    """Host ms per picture of the native parse alone, as
    PipelinedDecoder's parse thread runs it (a parse-only Decoder that
    keeps the programs), over the whole stream."""
    from libde265_tpu_torch import Decoder
    dec = Decoder(parse_only=True, keep_programs=True)
    t0 = time.perf_counter()
    list(dec.decode_all(data))
    return 1000 * (time.perf_counter() - t0) / dec.num_programs()


def pack_compare(progs):
    """Host ms of the native packer (pack_native) against the numpy packer
    (pack, production feed) on each picture: two packers planned up front
    (the numpy one from the programs without their native source), each
    picture packed by numpy then natively, as the decoder would (the
    native packer's state is planned anew for each picture), the two
    feeds asserted equal word for word.  Returns (native ms, numpy ms,
    words) per picture."""
    import dataclasses
    from libde265_tpu_torch.feed import MAX_REFS, FeedPacker
    native, numpy_ = FeedPacker(), FeedPacker()
    native.plan_stream(progs, pallas_mc=True)
    numpy_.plan_stream([dataclasses.replace(p, src=None) for p in progs],
                       pallas_mc=True)
    rows = []
    for i, p in enumerate(progs):
        slot_map = {k: k for k in range(min(len(p.ref_pocs), MAX_REFS))}
        slot_row = np.zeros(3, np.int32)
        t0 = time.perf_counter()
        want = numpy_.pack(p, slot_map, slot_row, pallas_mc=True)
        t1 = time.perf_counter()
        got = native.pack_native(p, slot_map, slot_row)
        t2 = time.perf_counter()
        if got[0] != want[0] or not np.array_equal(got[1], want[1]) or \
                got[2:] != want[2:]:
            raise AssertionError(f"picture {i}: the native feed differs "
                                 f"from the numpy feed")
        rows.append((1000 * (t2 - t1), 1000 * (t1 - t0), got[1].size))
    return rows


def per_picture(progs):
    """Synced ms, launch counts, intra flag, upload bytes and whether it has
    intra records, of each picture (FusedDecoder()), and the bytes of the
    DPB ring."""
    import torch
    import libde265_tpu_torch as lt
    fd = lt.FusedDecoder()
    if not fd.use_pallas_mc:
        raise AssertionError("FusedDecoder() on the card is not the "
                             "production formulation")
    fd.plan_stream(progs)
    rows = []
    for p in progs:
        reset_counts()
        t0 = time.perf_counter()
        fd.decode(p)
        torch.cuda.synchronize()
        rows.append((1000 * (time.perf_counter() - t0), read_counts(),
                     len(p.pus) == 0, fd.last_wire_bytes,
                     len(p.intras) > 0))
    ring = sum(t.numel() * t.element_size() for t in fd._stack)
    return rows, ring


def section_alone(progs, idx, name, run=None, reps=20, owner=None):
    """The picture program's section fused_decode.<name> of one picture
    alone (the pictures before it decoded first): its arguments captured
    while the picture decodes, then run(*args) again on them (run defaults
    to the section itself): synced ms (median of reps), and device ms and
    device operations by name per run (torch.profiler over five runs,
    after a first profile that only warms the profiler up: kernels, fills
    and copies; the ms is None where the profiler sees no device time).
    owner: where the section lives, the module fused_decode by default;
    for a method, its class (the captured arguments then begin with the
    decoder, and run gets it too)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    import libde265_tpu_torch as lt
    owner = owner or lt.fused_decode
    fd = lt.FusedDecoder()
    fd.plan_stream(progs)
    for p in progs[:idx]:
        fd.decode(p)
    section, seen = getattr(owner, name), []

    def record(*a, **k):
        seen.append((a, k))
        return section(*a, **k)

    setattr(owner, name, record)
    try:
        fd.decode(progs[idx])
    finally:
        setattr(owner, name, section)
    a, k = seen[0]
    run = run or section
    ts = []
    for i in range(reps + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(*a, **k)
        torch.cuda.synchronize()
        if i >= 3:
            ts.append(1000 * (time.perf_counter() - t0))
    for n in (1, 5):    # the first profile of a process is a warm-up
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                run(*a, **k)
            torch.cuda.synchronize()
    ka = [e for e in prof.key_averages() if _device_us(e) > 0]
    us = sum(_device_us(e) for e in ka) / 5
    return (statistics.median(ts), (us / 1000 if us > 0 else None),
            {e.key: e.count / 5 for e in ka})


def upload_section(progs, idx):
    """The feed upload of one picture alone (section_alone of the method
    FusedDecoder._sparse_upload), as the decoder runs it (host block
    compaction and inverse map into a pinned slot, the copies, B1), and the
    whole feed of the same picture uploaded instead
    (torch.from_numpy(buf).to(device)): one section_alone result each."""
    import torch
    import libde265_tpu_torch as lt
    cls = lt.fused_decode.FusedDecoder
    whole = lambda fd, buf: torch.from_numpy(buf).to(fd.device)  # noqa: E731
    return (section_alone(progs, idx, "_sparse_upload", owner=cls),
            section_alone(progs, idx, "_sparse_upload", run=whole,
                          owner=cls))


def deblock_section(progs, idx):
    """The deblocking section of one picture alone (section_alone)."""
    return section_alone(progs, idx, "_deblock_section")


def residual_section(progs, idx):
    """The residual section of one picture alone (section_alone): B4 over
    every size bin, the escape corrections, dequant + inverse transform."""
    return section_alone(progs, idx, "_residual_section")


def profile_picture(progs, idx):
    """torch.profiler over one picture (the ones before it decoded first,
    untraced): wall ms, device busy ms (the sum of kernel self times, one
    stream), and the device ms and launches of the intra scan, of the
    deblocking kernels (the edge parameters, B8, B9) and of B4 in the
    picture."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    import libde265_tpu_torch as lt
    fd = lt.FusedDecoder()
    fd.plan_stream(progs)
    for p in progs[:idx]:
        fd.decode(p)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fd.decode(progs[idx])
        torch.cuda.synchronize()
        wall = 1000 * (time.perf_counter() - t0)

    ka = prof.key_averages()
    busy = sum(_device_us(e) for e in ka) / 1000
    named = {e.key: (_device_us(e) / 1000, e.count) for e in ka
             if any(k in e.key for k in ("intra", "deblock_kernel",
                                         "deblock_params", "densify",
                                         "residual_bins")) and
             _device_us(e) > 0}
    return wall, busy, named


def _device_us(event):
    """Device self time (us) of a torch.profiler key_averages() entry."""
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0))


def device_kernels(fn):
    """Names of the device activities (kernels, fills, copies) that
    torch.profiler sees during fn(), with their device us."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: _device_us(e) for e in prof.key_averages()
            if _device_us(e) > 0}


def device_ms(fn, kernel=None):
    """Device ms of the kernels whose name contains `kernel` during fn(),
    of all its device work (kernels and copies) when kernel is None
    (torch.profiler, device activity only); None where the profiler sees
    no device time."""
    us = sum(v for k, v in device_kernels(fn).items()
             if kernel is None or kernel in k)
    return us / 1000 if us > 0 else None


def measured_device_ms(fn, what, kernel=None, tries=20):
    """device_ms(fn, kernel), profiled again while the profiler sees no
    device time, up to `tries` profiles; raises if it never does."""
    for _ in range(tries):
        ms = device_ms(fn, kernel)
        if ms is not None:
            return ms
    raise AssertionError(f"{what}: torch.profiler saw no device time in "
                         f"{tries} profiles")


def _add(a, b):
    return None if a is None or b is None else a + b


class IntraTrace:
    """A picture's intra scan (the arguments of intra_cuda.intra_scan): the
    padded planes before it (`initial`) and after it (`final`), keyed by
    plane; the scan's other arguments (`scan`); and the scan's (step,
    plane, size bin) steps in scan order, as intra_step_plain's arguments
    (`calls`: (plane, args, kwargs))."""

    def __init__(self, padded, bins, bin_res, tables, nsteps, bit_depths):
        from libde265_tpu_torch.ops import intra_cuda
        self.initial = {c: p.clone() for c, p in enumerate(padded)}
        self.final = dict(enumerate(padded))    # the scan updates in place
        self.scan = (bins, bin_res, tables, nsteps, bit_depths)
        self.calls = []
        for i, c, lg in intra_cuda.scan_order(bins, len(padded), nsteps):
            v = bins[c][lg]
            self.calls.append((c, (v["meta"], v["rrow"], v["aw"], i,
                                   bin_res[lg], *tables[lg]),
                               {"s": 1 << lg, "bit_depth": bit_depths[c]}))


def scan_shape(trace):
    """What a picture's intra scan holds: per plane its steps, its block
    sizes with each size bin's depth, and the most valid blocks of one
    (step, size) pair; and the number of (step, plane, size) pairs."""
    bins, _, _, nsteps, _ = trace.scan
    most = {}
    for c, s, _, hm, _ in _step_views(trace):
        most[c] = max(most.get(c, 0), int(((hm[:, 4] & 8) != 0).sum()))
    return {"steps": [int(n) for n in nsteps],
            "sizes (size: depth)": {c: {1 << lg: int(v["depth"])
                                        for lg, v in sorted(b.items())}
                                    for c, b in sorted(bins.items())},
            "most blocks in a step": most, "pairs": len(trace.calls)}


def _clone(x):
    """x with every tensor in it (in lists, tuples and dicts too) cloned."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(a) for a in x)
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x


def capture_inputs(fd, progs, trace_scan=True, keep=None):
    """Decode progs with every kernel wrapper recording its arguments;
    returns per picture {wrapper name: [(args, kwargs), ...]}, the intra
    scan as an IntraTrace under "intra_scan" (one scan a picture) unless
    trace_scan is False, when each of its calls is recorded as the others
    are.  Arguments are cloned, but not the padded planes of a traced
    intra scan (the trace keeps them).  keep: a list that gets each
    picture's decoded planes."""
    import torch
    saved = {}
    per_frame = []

    def wrap(name, fn):
        def rec(*args, **kwargs):
            if name == "intra_scan" and trace_scan:
                per_frame[-1][name] = IntraTrace(*args, **kwargs)
            else:
                per_frame[-1].setdefault(name, []).append(
                    (_clone(list(args)), _clone(kwargs)))
            return fn(*args, **kwargs)
        return rec

    for m, name in WRAPPERS:
        mod = ops_module(m)
        if not hasattr(mod, name):    # an older checkout's port
            continue
        saved[(m, name)] = getattr(mod, name)
        setattr(mod, name, wrap(name, saved[(m, name)]))
    try:
        for prog in progs:
            per_frame.append({})
            out = fd.decode(prog)
            if keep is not None:
                keep.append(out)
        torch.cuda.synchronize()
    finally:
        for (m, name), fn in saved.items():
            setattr(ops_module(m), name, fn)
    return per_frame


# ---------------------------------------------------------------------------
# phase 4: kernels vs plain
# ---------------------------------------------------------------------------

def _csr_bin(rng, N, S):
    """Random valid CSR bin: unique positions per TU, 4-bit values."""
    bs, offs = [], [0]
    for _ in range(N):
        n = 0 if rng.random() < 0.3 else int(rng.integers(1, S * S + 1))
        pos = np.sort(rng.permutation(S * S)[:n])
        val = rng.integers(1, 8, n) * rng.choice([-1, 1], n)
        out, p = [], -1
        for q, v in zip(pos, val):
            g = int(q) - p - 1
            out.extend([0] * (g // 15))
            out.append((g % 15) | ((int(v) & 0xF) << 4))
            p = int(q)
        while len(out) % 4:
            out.append(0)
        bs.extend(out)
        offs.append(offs[-1] + len(out))
    b = np.asarray(bs + [0] * (-len(bs) % 4), np.int64)
    cv = (b[0::4] | (b[1::4] << 8) | (b[2::4] << 16) | (b[3::4] << 24))
    return cv.astype(np.uint32).view(np.int32), np.asarray(offs, np.int32)


def _intra_records(rng, s, K, H, W, bd):
    """One step of K disjoint blocks of size s on an H x W plane, about a
    quarter of the slots invalid and scattered (valid ones do not lead):
    meta [K, 5], resid [K, s, s] (numpy)."""
    gw, gh = W // s, H // s
    cells = rng.permutation(gw * gh)[:K]
    ys, xs = (cells // gw) * s, (cells % gw) * s
    invalid = rng.random(K) < 0.25
    meta = np.zeros((K, 5), np.int64)
    meta[:, 0] = rng.integers(0, 35, K)
    meta[:, 1] = rng.integers(0, 4, K) if s < 32 else 0
    meta[:, 2], meta[:, 3] = ys, xs
    meta[:, 4] = ((rng.random(K) < 0.1) * 1 | (rng.random(K) < 0.6) * 2 |
                  (rng.random(K) < 0.5) * 4 | 8)
    meta[invalid] = 0
    sc = 1 << (bd - 8)
    resid = rng.integers(-40 * sc, 41 * sc, (K, s, s))
    return meta, resid


def _random_pus(rng, H, W, L, max_mv, n_slots):
    """A random partition of the picture into PUs (a quadtree of 64x64
    blocks, halves as 2-PU splits, about a fifth left as intra holes):
    disjoint, as in a real picture.  L=2: pred_flags 1..3."""
    from libde265_tpu_torch.decoder import PU_DTYPE
    recs = []

    def leaf(x, y, w, h):
        if rng.random() < 0.2:
            return
        r = np.zeros(1, PU_DTYPE)[0]
        r["x"], r["y"], r["w"], r["h"] = x, y, w, h
        r["pred_flags"] = int(rng.integers(1, 4)) if L == 2 else 1
        for l in (0, 1):
            r[f"mv{l}x"] = int(rng.integers(-max_mv * 4, max_mv * 4))
            r[f"mv{l}y"] = int(rng.integers(-max_mv * 4, max_mv * 4))
            r[f"ref_dpb{l}"] = int(rng.integers(0, n_slots))
        recs.append(r)

    def split(x, y, s):
        if x >= W or y >= H:
            return
        if s > 8 and (rng.random() < 0.5 or x + s > W or y + s > H):
            for dy in (0, s // 2):
                for dx in (0, s // 2):
                    split(x + dx, y + dy, s // 2)
            return
        u = rng.random()
        if u < 0.3:
            leaf(x, y, s, s // 2)
            leaf(x, y + s // 2, s, s // 2)
        elif u < 0.6:
            leaf(x, y, s // 2, s)
            leaf(x + s // 2, y, s // 2, s)
        else:
            leaf(x, y, s, s)

    for y in range(0, H, 64):
        for x in range(0, W, 64):
            split(x, y, 64)
    return np.array(recs, PU_DTYPE)


def _segment_cases(rng, t, dev, H, W):
    """B3 and B2 inputs at H x W: a random PU partition, rings of 17 slots
    of random samples (luma and chroma, 8 and 10 bit), lists 0 and 1;
    each band's index table carries two more words than its widest band
    (padding segments, as the feed's watermark leaves them)."""
    import torch
    from libde265_tpu_torch.fused_decode import RING_SLOTS
    from libde265_tpu_torch.ops import mc_seg
    pus = _random_pus(rng, H, W, 2, 64, RING_SLOTS)
    puw = t(mc_seg.pus_to_wire(pus))
    n_bands = (H + 3) // 4
    raw = [mc_seg.plan_segment_indices(pus, l, H) for l in (0, 1)]
    kp = max(r[1].shape[1] for r in raw) + 2
    plans = [(c, np.pad(sx, ((0, 0), (0, kp - sx.shape[1]))))
             for c, sx, _ in raw]
    g = torch.Generator(device=dev).manual_seed(7)
    mc, paint = [], []
    for chroma in (False, True):
        Hd, Wd = (H // 2, W // 2) if chroma else (H, W)
        hp, wp = mc_seg.pad_sizes(Hd, Wd)
        for bd in (8, 10):
            ring = torch.randint(0, 1 << bd, (RING_SLOTS * hp, wp),
                                 generator=g, device=dev, dtype=torch.int32)
            for l, (counts, sidx) in enumerate(plans):
                mc.append(((ring, t(counts), t(sidx), puw), dict(
                    list_idx=l, OR=2 if chroma else 4, T=4 if chroma else 8,
                    Hpad=hp, Wout=max(256, (Wd + 127) & ~127),
                    n_bands=n_bands, KMAX=2 * sidx.shape[1], bd=bd,
                    chroma=chroma, Hdim=Hd, Wdim=Wd, sub_x=2, sub_y=2)))
    for L in (1, 2):
        sidx2 = np.stack([plans[l][1] for l in range(L)], axis=1)
        paint.append(((t(np.stack([plans[l][0] for l in range(L)])),
                       t(sidx2), puw), dict(n_bands=n_bands, W4=W // 4, L=L)))
    return mc, paint


def _residual_cases(rng, t, H, W):
    """B5 inputs for every size bin and band height: about a third of the
    s-grid of a 1080p luma (OR 4) or 4:2:0 chroma (OR 2) plane covered by
    TUs; two padding words per band beyond the widest band."""
    from libde265_tpu_torch.ops import mc_seg
    out = []
    for OR, (Hc, Wc) in ((4, (H, W)), (2, (H // 2, W // 2))):
        for lg in (2, 3, 4, 5):
            s = 1 << lg
            gy, gx = Hc // s, Wc // s
            cells = np.flatnonzero(rng.random(gy * gx) < 0.35)
            rng.shuffle(cells)
            n = len(cells)
            sc = np.stack([np.arange(n), (cells % gx) * s, (cells // gx) * s],
                          axis=1).astype(np.int32)
            band, srow, x0 = mc_seg.plan_residual_segments(sc, s, OR)
            cnt, sw, _ = mc_seg.pack_band_segments(band, srow, x0,
                                                   (H + 3) // 4)
            sw = np.pad(sw, ((0, 0), (0, 2)), constant_values=5 << 20)
            res = rng.integers(-512, 512, (n + 7, s, s))
            out.append(((t(res, np.int32), t(cnt), t(sw)), dict(
                OR=OR, S=s, Wout=max(256, (Wc + 127) & ~127),
                n_bands=(H + 3) // 4)))
    return out


def _residual_bin_cases(rng, t, sizes):
    """residual_bins inputs at a 1080p picture's bin sizes [(N, S), ...]:
    random levels (most zero) with an escape a TU and four padding rows a
    bin, every TU flag mixed; 8-bit flat, and 10-bit luma with 8-bit
    chroma (cidx shipped) and scaling lists."""
    import torch
    from libde265_tpu_torch.decoder import (TU_RDPCM, TU_RDPCM_VERTICAL,
                                            TU_TQ_BYPASS, TU_TRANSFORM_SKIP,
                                            TU_USE_DST)
    out = []
    for bd, bdc, scaling in ((8, 8, False), (10, 8, True)):
        levels, bins = [], []
        for N, S in sizes:
            lg = S.bit_length() - 1
            lev = rng.integers(-7, 8, N * S * S)
            lev[rng.random(lev.shape) < 0.85] = 0
            pos = np.sort(rng.choice(lev.size, N, replace=False))
            want = rng.integers(8, 32768, N) * rng.choice([-1, 1], N)
            lev[pos] = np.clip(want, -7, 7)
            f = ((rng.random(N) < 0.1) * TU_TRANSFORM_SKIP |
                 (rng.random(N) < 0.05) * TU_TQ_BYPASS |
                 (rng.random(N) < 0.5) * TU_USE_DST |
                 (rng.random(N) < 0.2) * TU_RDPCM |
                 (rng.random(N) < 0.5) * TU_RDPCM_VERTICAL)
            b = {"qp": t(rng.integers(0, 52 + 6 * (bd - 8), N), np.int32),
                 "flags": t(f, np.int32),
                 "mid": t(rng.integers(0, 6 if lg < 5 else 2, N), np.int32),
                 "cfx": t(np.concatenate([pos, [-1] * 4]), np.int32),
                 "cfv": t(np.concatenate([want - lev[pos], [5] * 4]),
                          np.int32)}
            if bd != bdc:
                b["cidx"] = t(rng.integers(0, 3, N), np.int32)
            levels.append(lev)
            bins.append((lg, b))
        buf = t(np.concatenate(levels + [[0]]), np.int32)
        sft = tuple(t(rng.integers(1, 256, (6, 1 << lg, 1 << lg)), np.int32)
                    for lg in (2, 3, 4, 5)) if scaling else None
        if buf.data_ptr() % 16:
            buf = buf.clone()
        out.append(((buf, bins, bd, bdc, sft), {}))
    return out


def _expand_cases(rng, t):
    """B1 inputs of a 1080p-sized feed: about 40% of its 1024-word blocks
    nonzero, the compact rows rounded up to 256 with zero rows."""
    out = []
    for total in (1 << 21, 1_500_001):
        B = 1024
        nb = (total + B - 1) // B
        keep = np.flatnonzero(rng.random(nb) < 0.4)
        M = -(-len(keep) // 256) * 256
        blocks = np.zeros((M, B), np.int32)
        blocks[:len(keep)] = rng.integers(-(1 << 31), 1 << 31,
                                          (len(keep), B))
        inv = np.full(nb, -1, np.int32)
        inv[keep] = np.arange(len(keep))
        out.append(((t(blocks), t(inv)), dict(total=total, B=B)))
    return out


def random_cases(dev, b4_sizes, H=1088, W=1920):
    """Seeded random inputs at the 1080p main-path shapes:
    {wrapper name: [(args, kwargs), ...]}.  b4_sizes: [(N, S), ...], the
    size bins of a real 1080p P picture (its capacities)."""
    import torch
    from libde265_tpu_torch.feed import WAVE_CAP
    from libde265_tpu_torch.ops import intra_window as iw
    rng = np.random.default_rng(2024)

    def t(a, dtype=None):
        a = np.ascontiguousarray(a)
        if dtype is not None:
            a = a.astype(dtype)
        return torch.from_numpy(a).to(dev)

    bd = 8
    cases = {name: [] for name in FAMILY}
    cases["mc_stripes"], cases["paint_pu_idx"] = _segment_cases(rng, t, dev,
                                                                H, W)
    cases["residual_stripes"] = _residual_cases(rng, t, H, W)
    cases["expand_blocks"] = _expand_cases(rng, t)
    for sizes in ([(4096, 4), (2048, 8), (512, 16), (128, 32)], b4_sizes):
        bins = [(*map(t, _csr_bin(rng, N, S)), N, S) for N, S in sizes]
        cases["densify_bins"].append(((bins,), {}))
    cv, coff = _csr_bin(rng, 2048, 8)
    cases["densify_bin"].append(((t(cv), t(coff)), {"N": 2048, "S": 8}))
    cases["residual_bins"] = _residual_bin_cases(rng, t, b4_sizes)

    def luma_params(a, b):
        return (t(rng.integers(0, 3, (a, b)).astype(np.int32)),
                t((rng.integers(0, 65, (a, b)) << (bd - 8)).astype(np.int32)),
                t((rng.integers(0, 25, (a, b)) << (bd - 8)).astype(np.int32)),
                t((rng.random((a, b)) < 0.1).astype(np.int32)),
                t((rng.random((a, b)) < 0.1).astype(np.int32)))

    img = rng.integers(0, 1 << bd, (H, W + 8)).astype(np.int32)
    cases["luma_pass"].append(((t(img), *luma_params(H // 4, W // 8)),
                               {"bit_depth": bd}))
    img = rng.integers(0, 1 << bd, (H + 8, W)).astype(np.int32)
    cases["luma_pass_h"].append(((t(img), *luma_params(H // 8, W // 4)),
                                 {"bit_depth": bd}))

    def chroma_params(a, b):
        tcs = rng.integers(0, 25, (2, a, b)).astype(np.int32)
        tcs[rng.random((2, a, b)) < 0.5] = 0
        return (t(tcs), t((rng.random((a, b)) < 0.1).astype(np.int32)),
                t((rng.random((a, b)) < 0.1).astype(np.int32)))

    Hc, Wc = H // 2, W // 2
    imgs = rng.integers(0, 1 << bd, (2, Hc, Wc + 8)).astype(np.int32)
    cases["chroma_pass_stacked"].append(
        ((t(imgs), *chroma_params(H // 4, Wc // 8)),
         {"bit_depth": bd, "rows_per_seg": 2}))
    imgs = rng.integers(0, 1 << bd, (2, Hc + 8, Wc)).astype(np.int32)
    cases["chroma_pass_stacked_h"].append(
        ((t(imgs), *chroma_params(Hc // 8, W // 4)),
         {"bit_depth": bd, "cols_per_seg": 2}))
    # both orientations in one call, in the picture program's layouts
    # (edge 0 has no parameter), on blocky smooth content (a gradient and
    # an offset per 4x4 block), where most edges pass the decisions
    yy, xx = np.mgrid[0:H, 0:W]

    def blocky(h, w):
        off = rng.integers(-6, 7, ((h + 3) // 4, (w + 3) // 4))
        v = (xx[:h, :w] + 2 * yy[:h, :w]) // 3 % 160 + 40 + \
            off.repeat(4, 0).repeat(4, 1)[:h, :w]
        return v.astype(np.int32)

    cases["deblock_luma"].append(
        ((t(blocky(H, W)), list(luma_params(H // 4, W // 8 - 1)),
          list(luma_params(H // 8 - 1, W // 4))), {"bit_depth": bd}))
    cases["deblock_chroma"].append(
        ((t(blocky(Hc, Wc)), t(blocky(Hc, Wc)),
          list(chroma_params(H // 4, (Wc + 7) // 8 - 1)),
          list(chroma_params((Hc + 7) // 8 - 1, W // 4))),
         {"bit_depth": bd, "sub_x": 2, "sub_y": 2}))

    for edge_ok in (True, False):
        args = (t(rng.integers(0, 256, (H, W)).astype(np.int32)),
                t(rng.integers(0, 3, (H, W)).astype(np.int32)),
                t(rng.integers(0, 4, (H, W)).astype(np.int32)),
                t(rng.integers(0, 32, (H, W)).astype(np.int32)),
                t(rng.integers(-7, 8, (H, W, 4)).astype(np.int32)),
                t(rng.random((H, W)) < 0.05))
        kw = {"bit_depth": 8,
              "edge_ok": t(rng.random((H, W)) > 0.1) if edge_ok else None}
        cases["sao_plane_fused"].append((args, kw))

    # the intra kernels: the padded 1080p luma plane, K = WAVE_CAP[lg]
    hp, wp = iw.scan_pad_sizes(H, W)
    yy, xx = np.mgrid[0:H, 0:W]
    for s in (4, 8, 16, 32):
        K = WAVE_CAP[s.bit_length() - 1]
        for ibd in (8, 10):
            sc = 1 << (ibd - 8)
            plane = ((60 + yy // 2 + xx // 3) * sc +
                     rng.integers(0, 3 * sc, (H, W))) % (1 << ibd)
            padded = iw.pad_plane_for_scan(t(plane, np.int32), hp, wp)
            meta, resid = _intra_records(rng, s, K, H, W, ibd)
            y0p = t(meta[:, 2] + iw.PAD_T, np.int32)
            x0p = t(meta[:, 3] + iw.PAD_L, np.int32)
            valid = t((meta[:, 4] & 8) != 0)
            nvalid = int(rng.integers(K // 2, K + 1))
            cases["border_gather"].append(((padded, y0p, x0p, nvalid),
                                           {"s": s}))
            cases["window_scatter"].append(
                ((padded, t(resid + 500, np.int32), y0p, x0p, valid),
                 {"s": s}))
    # the persistent scan: synthetic pictures whose steps share all four
    # luma sizes (no 1080p stream has more than one size per plane)
    for seed, ibd in ((0, 8), (1, 10), (2, 12)):
        cases["intra_scan"].append((synthetic_scan_inputs(seed, dev,
                                                          bit_depth=ibd), {}))
    # and one whose 4x4 bins are full (256 blocks in a luma step), with a
    # step of no valid block
    cases["intra_scan"].append((scan_inputs(full_bin_intra(0, 10), dev, 10),
                                {}))
    return cases


def plain_of(name):
    """The plain PyTorch version of a wrapper (run on the same device)."""
    import torch
    from libde265_tpu_torch.ops import (coef_cuda, deblock_cuda, expand,
                                        intra_cuda, mc_seg)
    from libde265_tpu_torch.ops import intra_window as iw
    from libde265_tpu_torch.ops.deblock import _chroma_pass, _luma_pass
    from libde265_tpu_torch.ops.sao import sao_plane

    if name == "expand_blocks":
        return expand.expand_blocks_plain
    if name in ("mc_stripes", "paint_pu_idx", "residual_stripes"):
        return getattr(mc_seg, f"{name}_plain")
    if name == "densify_bin":
        return lambda cv, coff, N, S: coef_cuda.densify_bin_plain(cv, coff,
                                                                  N, S)
    if name == "densify_bins":
        return coef_cuda.densify_bins_plain
    if name == "residual_bins":
        return coef_cuda.residual_bins_plain
    if name in ("deblock_luma", "deblock_chroma"):
        return getattr(deblock_cuda, f"{name}_plain")
    if name == "deblock_params":
        return deblock_cuda.deblock_params_plain
    if name == "luma_pass":
        return _luma_pass
    if name == "luma_pass_h":
        return lambda img, *p, bit_depth: _luma_pass(
            img.T, *(a.T for a in p), bit_depth=bit_depth).T
    if name == "chroma_pass_stacked":
        return lambda imgs, tcs, no_p, no_q, bit_depth, rows_per_seg: \
            torch.stack([_chroma_pass(imgs[c], tcs[c], no_p, no_q, bit_depth,
                                      rows_per_seg) for c in range(2)])
    if name == "chroma_pass_stacked_h":
        return lambda imgs, tcs, no_p, no_q, bit_depth, cols_per_seg: \
            torch.stack([_chroma_pass(imgs[c].T, tcs[c].T, no_p.T, no_q.T,
                                      bit_depth, cols_per_seg).T
                         for c in range(2)])
    if name == "border_gather":
        return iw.border_gather_plain
    if name == "window_scatter":
        return iw.window_scatter_plain
    if name == "intra_scan":
        return intra_cuda.intra_scan_plain
    if name == "intra_bins":
        return intra_cuda.intra_bins_plain
    return sao_plane


def kernel_of(name):
    return getattr(ops_module(MODULE[name]), name)


def median_ms(fn, reps=25, warm=3):
    import torch
    for _ in range(warm):
        fn()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def _tensors(x):
    import torch
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for a in x for t in _tensors(a)]
    if isinstance(x, dict):
        return _tensors(list(x.values()))
    return []


def _nbytes(x):
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _work(name, args, kw, out):
    """(bytes the function must move, output elements its operations are
    counted on) for one call: each input read once and each output written
    once.  B3 reads its segments' windows, not the whole ring, and its
    operations run on the samples the segments cover; B5 reads the
    residual rows its segments place; B4 reads the words its TUs' runs
    cover (not the capacity of cv) and writes its buffer (the views
    alias it)."""
    nbytes = _nbytes(args) + _nbytes(kw) + _nbytes(out)
    nout = sum(t.numel() for t in _tensors(out))
    if name == "mc_stripes":
        from libde265_tpu_torch.ops import mc_seg
        refs, nseg, sidx, pu = args
        band, idx = mc_seg._segments(nseg, sidx, kw["KMAX"])
        geo = {k: kw[k] for k in ("OR", "T", "Hpad", "chroma", "Hdim",
                                  "Wdim", "sub_x", "sub_y")}
        ws = mc_seg.seg_params(pu, idx, band.int(), kw["list_idx"],
                               **geo)[5].long()
        OR, T = kw["OR"], kw["T"]
        nbytes += 4 * int(((OR + T - 1) * (ws + T - 1)).sum()) - \
            _nbytes(refs)
        nout = int((OR * ws).sum())
    elif name == "densify_bins":
        (bins,), (buf, _) = args, out
        nbytes = buf.numel() * 4 + sum(
            4 * (N + 1) + 4 * min(cv.shape[0], (int(coff[N]) + 3) // 4)
            for cv, coff, N, _ in bins)
        nout = buf.numel()
    elif name == "residual_bins":
        # each sample's level read and its residual written; a TU's four
        # fields and each escape read once
        buf, bins = args[0], args[1]
        nout = buf.numel() - 1
        nbytes = 8 * nout + sum(
            4 * sum(bf[k].numel() for k in ("qp", "flags", "mid", "cidx",
                                             "cfx", "cfv") if k in bf)
            for _, bf in bins)
    elif name == "deblock_params":
        # every input grid read once and the arena written once (the
        # chroma no_p / no_q are views of the luma ones)
        arena = sum(t.numel() for t in out["v"] + out["h"]) + sum(
            out[k][0].numel() for k in ("cv", "ch") if k in out)
        nbytes = _nbytes(args) + _nbytes(kw) + 4 * arena
        nout = arena
    elif name == "intra_bins":
        # the records read (8 words each) and the arena written once
        arena = sum(t.numel() for t in _tensors(out))
        nbytes = 32 * args[4] + 4 * arena
        nout = arena
    elif name == "residual_stripes":
        res, nseg, sw = args
        live = int(nseg.clamp(max=sw.shape[1]).sum())
        nbytes += 4 * live * kw["OR"] * kw["S"] - _nbytes(res)
        nout = live * kw["OR"] * kw["S"]
    return nbytes, nout


def _call(fn, name, args, kw):
    """fn(*args, **kw) on a copy of the plane that an in-place kernel
    updates, so every call sees the same inputs."""
    if name in INPLACE:
        args = (args[0].clone(), *args[1:])
    elif name == "intra_scan":    # updates its padded planes
        args = ([p.clone() for p in args[0]], *args[1:])
    return fn(*args, **kw)


def _max_err(got, want, what):
    got, want = _tensors(got), _tensors(want)
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} outputs vs {len(want)}")
    e = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"{what}: shape {tuple(g.shape)} vs "
                                 f"{tuple(w.shape)}")
        if g.numel():
            e = max(e, int((g.long() - w.long()).abs().max().item()))
    return e


def compare_kernels(case_sets):
    """Exact kernel-vs-plain comparison on every case: (max error, number
    of cases) per family."""
    import torch
    err = {n: 0 for n in NAMES}
    ncases = {n: 0 for n in NAMES}
    for label, cases in case_sets:
        for name, calls in cases.items():
            if isinstance(calls, IntraTrace):
                continue    # a picture's scan: compare_intra_trace
            fam = FAMILY[name]
            for args, kw in calls:
                got = _call(kernel_of(name), name, args, kw)
                want = _call(plain_of(name), name, args, kw)
                torch.cuda.synchronize()
                e = _max_err(got, want, f"{name} ({label})")
                err[fam] = max(err[fam], e)
                ncases[fam] += 1
                if e != 0:
                    raise AssertionError(f"{name} ({label}): kernel differs "
                                         f"from the plain version by {e}")
    return err, ncases


def _bound(fam, nbytes, nout):
    """(bound ms, what bounds it): bytes over the memory rate against
    integer operations over the peak rate outside the tensor cores."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = nout * ALL[fam][4] / INT_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def time_calls(timed):
    """Kernel and plain ms summed per family over one picture's calls
    (CUDA events: plain, kernel, kernel, plain per call; the lower of each
    pair), the calls' device ms (torch.profiler: all device work of a
    call) and the bound of the same work (each input read once, each
    output written once)."""
    ms = {}
    for name, calls in timed.items():
        if isinstance(calls, IntraTrace):
            continue
        fam = FAMILY[name]
        for args, kw in calls:
            k, p = kernel_of(name), plain_of(name)
            t_p1 = median_ms(lambda: _call(p, name, args, kw))
            t_k1 = median_ms(lambda: _call(k, name, args, kw))
            t_k2 = median_ms(lambda: _call(k, name, args, kw))
            t_p2 = median_ms(lambda: _call(p, name, args, kw))
            t_dev = measured_device_ms(lambda: _call(k, name, args, kw),
                                       name, DEVICE_MARK.get(name))
            out = _call(k, name, args, kw)
            row = ms.setdefault(fam, [0.0, 0.0, 0, 0, 0, 0.0])
            row[5] = _add(row[5], t_dev)
            nbytes, nout = _work(name, args, kw, out)
            row[0] += min(t_k1, t_k2)
            row[1] += min(t_p1, t_p2)
            row[2] += nbytes
            row[3] += nout
            row[4] += 1
    return ms


def expand_library_call(blocks, inv, total, B):
    """B1's library yardstick, ready to run: the one indexing call that
    expand_blocks_plain makes (rows[sel]), on these inputs."""
    import torch
    nb, M = (total + B - 1) // B, blocks.shape[0]
    rows = torch.cat([blocks.reshape(M, B), blocks.new_zeros((1, B))])
    sel = torch.where(inv[:nb] >= 0, inv[:nb].long(), M).clamp(max=M)
    return lambda: rows[sel]


def expand_library_ms(calls):
    """expand_library_call and B1 in turns (library, kernel, kernel,
    library; the lower of each pair) on each call's inputs, summed over
    the calls: (library CUDA-event ms, library device ms by torch.profiler,
    B1 CUDA-event ms of the same turns).  At about 2 us of device work
    both event figures are mostly the host's launch time, so they are
    taken in turns, not at two moments of the run."""
    from libde265_tpu_torch.ops import expand
    ev, dev, kern = 0.0, 0.0, 0.0
    for (blocks, inv), kw in calls:
        lib = expand_library_call(blocks, inv, **kw)
        k = lambda: expand.expand_blocks(blocks, inv, **kw)  # noqa: E731
        t_l1, t_k1, t_k2, t_l2 = (median_ms(lib), median_ms(k),
                                  median_ms(k), median_ms(lib))
        ev += min(t_l1, t_l2)
        kern += min(t_k1, t_k2)
        dev = _add(dev, measured_device_ms(lib, "rows[sel]"))
    return ev, dev, kern


def _step_views(trace):
    """Per call of an intra trace: (plane key, s, meta [K, 5] on the
    device, the same on the host, rrow row on the host)."""
    cache = {}
    out = []
    for key, args, kw in trace.calls:
        meta_all, rrow_all, step = args[0], args[1], args[3]
        if id(meta_all) not in cache:
            cache[id(meta_all)] = (meta_all.cpu().numpy(),
                                   rrow_all.cpu().numpy())
        hm, hr = cache[id(meta_all)]
        out.append((key, kw["s"], meta_all[step], hm[step], hr[step]))
    return out


def compare_intra_trace(trace, err, ncases, ms):
    """The first I picture's intra work, three ways, each against its
    plain version and against the decode's own planes:
      * the persistent scan: the picture's scan, one launch, from the
        planes before it;
      * B6: every step's borders gathered from the planes after the
        picture;
      * B7: every step's valid blocks, read back from the planes after the
        picture, scattered onto the planes before the first step (which
        must then equal the planes after it).
    Times are one pass over the picture (one call of the scan, every step
    of the others), CUDA events for the kernel
    and the plain version alike (plain, kernel, kernel, plain; the lower of
    each pair), and the kernel's device time (torch.profiler).  At a few
    microseconds a kernel the event-timed pass measures the host's launch
    loop, the device time the kernels alone."""
    import torch
    from libde265_tpu_torch.ops import intra_window as iw

    def replay(fn):
        planes = {k: p.clone() for k, p in trace.initial.items()}
        for key, args, kw in trace.calls:
            fn(planes[key], *args, **kw)
        return planes

    views = _step_views(trace)
    b6, b7 = [], []
    for key, s, meta, hm, _ in views:
        fin = trace.final[key]
        y0p = (meta[:, 2] + iw.PAD_T).contiguous()
        x0p = (meta[:, 3] + iw.PAD_L).contiguous()
        ar = torch.arange(s, device=meta.device)
        rows = (y0p[:, None, None] + ar[None, :, None]).clamp(
            0, fin.shape[0] - 1).long()
        cols = (x0p[:, None, None] + ar[None, None, :]).clamp(
            0, fin.shape[1] - 1).long()
        b6.append((key, (y0p, x0p, meta.shape[0]), {"s": s}))
        b7.append((key, (fin[rows, cols].contiguous(), y0p, x0p,
                         (meta[:, 4] & 8) != 0), {"s": s}))

    def gather_all(fn):
        return [fn(trace.final[key], *a, **kw) for key, a, kw in b6]

    def scatter_all(fn):
        planes = {k: p.clone() for k, p in trace.initial.items()}
        for key, a, kw in b7:
            fn(planes[key], *a, **kw)
        return planes

    def scan_all(fn):
        planes = [p.clone() for p in trace.initial.values()]
        return dict(enumerate(fn(planes, *trace.scan)))

    runs = {    # the device time counts the named kernel, not the copies
        SCAN: (lambda: scan_all(kernel_of("intra_scan")),
               lambda: scan_all(plain_of("intra_scan")), "intra_scan_kernel"),
        B6: (lambda: gather_all(kernel_of("border_gather")),
             lambda: gather_all(plain_of("border_gather")),
             "border_gather_kernel"),
        B7: (lambda: scatter_all(kernel_of("window_scatter")),
             lambda: scatter_all(plain_of("window_scatter")),
             "window_scatter_kernel"),
    }
    for fam, (kern, plain, kname) in runs.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        e = _max_err(got if isinstance(got, list) else list(got.values()),
                     want if isinstance(want, list) else list(want.values()),
                     f"{fam} (first I picture)")
        if fam != B6:    # the planes after the picture, as decoded
            e = max(e, _max_err(list(got.values()),
                                list(trace.final.values()),
                                f"{fam} vs the decode"))
        err[fam] = max(err[fam], e)
        ncalls = 1 if fam == SCAN else len(trace.calls)
        ncases[fam] += ncalls
        if e != 0:
            raise AssertionError(f"{fam} (first I picture): differs by {e}")
        t_p1 = median_ms(plain, reps=1, warm=0)
        t_k1 = median_ms(kern, reps=5, warm=1)
        t_k2 = median_ms(kern, reps=5, warm=0)
        t_p2 = median_ms(plain, reps=1, warm=0)
        ms[fam] = [min(t_k1, t_k2), min(t_p1, t_p2), 0, 0, ncalls,
                   measured_device_ms(kern, fam, kname)]

    # bytes each function must move on this picture's data.  A (step, bin)
    # of the scan reads every slot's meta, the valid
    # slots' residual row index and availability words, their residual
    # blocks and border samples, and stores their blocks.
    aw_words = trace.calls[0][1][2].shape[2]
    for (key, s, meta, hm, hr) in views:
        K, nb, ss = meta.shape[0], 4 * s + 1, s * s
        valid = (hm[:, 4] & 8) != 0
        nv = int(valid.sum())
        nres = int((valid & (hr >= 0)).sum())
        ms[B6][2] += 4 * (2 * K + 2 * K * nb)
        ms[B6][3] += K * nb
        ms[B7][2] += 4 * (2 * K + 2 * nv * ss) + K
        ms[B7][3] += nv * ss
        ms[SCAN][2] += 4 * (5 * K + nv * (1 + aw_words + nb + ss) +
                            nres * ss)
        ms[SCAN][3] += nv * ss


def hold_scans(what, progs, err, ncases):
    """Every intra scan of a stream on the card (a FusedDecoder over
    progs, each scan recorded): the kernel, one launch, against its plain
    version and against the planes the decode left, exact; one scan held
    for each picture with intra blocks, else it fails; and each picture's
    intra_bins call (one for each picture with intra blocks) against its
    plain version.  Returns the number of scans held."""
    import torch
    import libde265_tpu_torch as lt
    from libde265_tpu_torch.ops import intra_cuda
    fd = lt.FusedDecoder(device=torch.device("cuda"))
    fd.plan_stream(progs)
    n = 0
    caps = capture_inputs(fd, progs)
    for i, (cap, p) in enumerate(zip(caps, progs)):
        if len(cap.get("intra_bins", ())) != (len(p.intras) > 0):
            raise AssertionError(f"{BINS} ({what} picture {i}): "
                                 f"{len(cap.get('intra_bins', ()))} calls")
    e, nb = compare_kernels([(f"{what} picture {i}",
                              {"intra_bins": cap["intra_bins"]})
                             for i, cap in enumerate(caps)
                             if "intra_bins" in cap])
    err[BINS] = max(err[BINS], e[BINS])
    ncases[BINS] += nb[BINS]
    for i, cap in enumerate(caps):
        trace = cap.get("intra_scan")
        if trace is None or not intra_cuda.fill_scan_args(
                list(trace.initial.values()), *trace.scan)[1]:
            continue
        before = intra_cuda.scan_launches
        got = intra_cuda.intra_scan(
            [p.clone() for p in trace.initial.values()], *trace.scan)
        want = intra_cuda.intra_scan_plain(
            [p.clone() for p in trace.initial.values()], *trace.scan)
        torch.cuda.synchronize()
        if intra_cuda.scan_launches != before + 1:
            raise AssertionError(f"{SCAN} ({what} picture {i}): "
                                 f"{intra_cuda.scan_launches - before} "
                                 f"launches")
        e = max(_max_err(got, want, f"{SCAN} ({what} picture {i})"),
                _max_err(got, list(trace.final.values()),
                         f"{SCAN} ({what} picture {i}) vs the decode"))
        err[SCAN] = max(err[SCAN], e)
        if e != 0:
            raise AssertionError(f"{SCAN} ({what} picture {i}): differs "
                                 f"by {e}")
        n += 1
    want = sum(len(p.intras) > 0 for p in progs)
    if n == 0 or n != want:
        raise AssertionError(f"{SCAN} ({what}): {n} scans held, {want} "
                             f"pictures with intra blocks")
    ncases[SCAN] += n
    log(f"{SCAN}: {n} scans of the {what} stream equal to the plain "
        f"version and to the decode (tolerance 0); {BINS}: {nb[BINS]} calls "
        f"equal to the plain version")
    return n


def chain_probe(rounds, threads):
    """The least time of one dependent step of the scan on this card
    (csrc/intra.cu chain_probe_kernel on one CTA of `threads` threads:
    rounds of store, block barrier, load of the sample another warp
    stored, store): per way (shared memory, global memory with the scan's
    loads, global memory with loads from L2), (us per round, clock64
    cycles per round).  The us are CUDA-event medians of 2 * rounds rounds
    less those of `rounds`, over `rounds`, so the launch cancels."""
    import torch
    from libde265_tpu_torch.ops import _build
    buf = torch.zeros(2 * threads, dtype=torch.int32, device="cuda")
    cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for mode, way in enumerate(("shared", "global (ld.global)",
                                "global (ld.global.cg, L2)")):
        def run(r):
            rc = _build.lib().tde_chain_probe(buf.data_ptr(), threads, r,
                                              mode, cyc.data_ptr(), stream)
            _build.check_launch("tde_chain_probe", rc)
        t1 = median_ms(lambda: run(rounds))
        t2 = median_ms(lambda: run(2 * rounds))
        run(rounds)
        out[way] = (1e3 * (t2 - t1) / rounds, int(cyc.item()) / rounds)
    return out


# ---------------------------------------------------------------------------
# phase 6: pictures with more than MAX_REFS references
# ---------------------------------------------------------------------------

def pipeline_stage_ms(prog, refs, reps=3):
    """Synced ms of each stage of pipeline.reconstruct on one picture on
    the card (the stages as reconstruct runs them, a synchronise after
    each), with device_intra False and True in turns, reps runs each:
    {device_intra: (median ms per stage, planes of the last run)}."""
    import torch
    from libde265_tpu_torch import pipeline as pl
    dev = refs[0][0].device
    runs = {False: [], True: []}
    out = {}
    for _ in range(reps):
        for device_intra in (False, True):
            spent = {}
            torch.cuda.synchronize()
            t = [time.perf_counter()]

            def mark(name):
                torch.cuda.synchronize()
                now = time.perf_counter()
                spent[name] = 1000 * (now - t[0])
                t[0] = now

            planes = pl._zero_planes(prog, dev)
            res = pl._compute_residuals(prog, dev)
            pl._apply_ccp(prog, res)
            mark("residuals")
            pl._motion_compensate(prog, planes, refs)
            pl._apply_pcm(prog, planes)
            pl._add_inter_residuals(prog, planes, res)
            mark("MC")
            (pl._intra_wavefront if device_intra else pl._intra_host)(
                prog, planes, res)
            mark("intra")
            pl._deblock(prog, planes)
            mark("deblocking")
            pl._apply_sao(prog, planes)
            mark("SAO")
            runs[device_intra].append(spent)
            out[device_intra] = planes
    return {di: ({k: statistics.median(r[k] for r in rs) for k in rs[0]},
                 out[di]) for di, rs in runs.items()}


def many_refs_phase(smi):
    """Phase 6: the 1080p stripe stream, whose pictures 9-11 read 9-11
    references, through PipelinedDecoder() (the main path; counts set to
    0 before it and read after it), then per picture, the routed
    pictures' kernel calls against the plain versions, the stages of a
    routed picture, the card against the CPU, and a 10-bit
    reconstruct_stream chain.  Returns the main-path run's (counts,
    seconds), the kernel comparison's (max error, cases), and the
    stream's parse-only and oracle programs."""
    import torch
    import libde265_tpu_torch as lt
    from libde265_tpu_torch import pipeline as pl
    from libde265_tpu_torch.feed import MAX_REFS
    data, t_enc = make_stripe_stream(BUILD / "chip_smoke" /
                                     "stripes_1080p_12f.h265")
    log(f"stream: 1920x1088 periodic stripes, 12 frames, up to 15 "
        f"references, {len(data)} bytes, encoded in {t_enc:.1f} s")
    pprogs = parse_only_programs(data)
    nrefs = [len(p.ref_pocs) for p in pprogs]
    routed = [i for i, n in enumerate(nrefs) if n > MAX_REFS]
    if nrefs[9:12] != [9, 10, 11] or routed != [9, 10, 11]:
        raise AssertionError(f"stripe stream: references per picture "
                             f"{nrefs}")
    _, progs = oracle_programs(data)
    run = main_path_run("1080p many references", data, progs,
                        routed=len(routed))

    # per picture: synced ms and launches; a routed picture launches B8
    # and B9 once and B10 once per plane, and no other kernel
    fd = lt.FusedDecoder()
    fd.plan_stream(pprogs)
    ms_r, ms_f = [], []
    for i, p in enumerate(pprogs):
        reset_counts()
        t0 = time.perf_counter()
        out = fd.decode(p)
        torch.cuda.synchronize()
        ms = 1000 * (time.perf_counter() - t0)
        c = read_counts()
        if i in routed:
            ms_r.append(ms)
            if (c[PARAMS], c[B8], c[B9], c[B10]) != (1, 1, 1, 3) or \
                    sum(c.values()) != 6:
                raise AssertionError(f"routed picture {i}: launches "
                                     f"{json.dumps(c)}")
        else:
            ms_f.append(ms)
            if c[BINS] != (len(p.intras) > 0) or c[RES] != c[B4]:
                raise AssertionError(f"fused picture {i}: {c[BINS]} {BINS} "
                                     f"launches, {len(p.intras)} intra "
                                     f"records; {c[RES]} {RES} and "
                                     f"{c[B4]} B4 launches")
    if fd.pipeline_pictures != len(routed):
        raise AssertionError(f"{fd.pipeline_pictures} routed pictures")
    assert_bit_exact([out], progs[-1:], "many references, last picture")
    log(f"many references: routed pictures {routed} ms (synced) "
        f"{[round(m, 2) for m in ms_r]}, fused pictures ms "
        f"{[round(m, 2) for m in ms_f]} (median "
        f"{statistics.median(ms_f):.2f}); edge parameters / B8 / B9 / B10 "
        f"launches per routed picture 1 / 1 / 1 / 3 on {smi}")

    # the routed picture's kernel calls against their plain versions
    fd9 = lt.FusedDecoder()
    for p in pprogs[:routed[0]]:
        fd9.decode(p)
    (cap,) = capture_inputs(fd9, pprogs[routed[0]:routed[0] + 1])
    if set(cap) != {"deblock_params", "deblock_luma", "deblock_chroma",
                    "sao_plane_fused"}:
        raise AssertionError(f"routed picture: kernels {sorted(cap)}")
    err, ncases = compare_kernels([(f"routed picture {routed[0]}", cap)])
    log(f"routed picture {routed[0]}: the edge parameters, B8, B9 and B10 "
        f"equal to their plain "
        f"versions on its calls (tolerance 0): "
        f"{json.dumps({n: ncases[n] for n in (PARAMS, B8, B9, B10)})}")

    # the stages of the last routed picture, from the decoder's DPB
    prog = pprogs[routed[-1]]
    refs = fd._dpb_refs(prog)
    for device_intra, (spent, planes) in pipeline_stage_ms(prog,
                                                           refs).items():
        assert_bit_exact([planes], progs[routed[-1]:routed[-1] + 1],
                         f"stages, device_intra={device_intra}")
        log(f"routed picture {routed[-1]} by stage, device_intra="
            f"{device_intra} (synced ms, median of 3, the two settings in "
            f"turns): "
            f"{json.dumps({k: round(v, 2) for k, v in spent.items()})}, "
            f"total {sum(spent.values()):.2f} on {smi}")

    # the card against the CPU on the same picture and references
    t0 = time.perf_counter()
    cpu = pl.reconstruct(prog, device="cpu",
                         ref_planes=[[q.cpu() for q in r] for r in refs])
    t_cpu = time.perf_counter() - t0
    card = pl.reconstruct(prog, ref_planes=refs)
    for c in range(3):
        if not torch.equal(card[c].cpu(), cpu[c]):
            raise AssertionError(f"routed picture: plane {c} differs "
                                 f"between the card and the CPU")
    log(f"routed picture {routed[-1]}: the card equals the CPU "
        f"(reconstruct on the CPU {t_cpu:.2f} s, host)")

    # a 10-bit chain: the pipeline's own pictures as references, all bits
    gdata = make_10bit_gop(BUILD / "chip_smoke" / "gop_64x48_10bit.h265")
    _, gprogs = oracle_programs(gdata)
    n = 0
    for gp, (poc, planes) in zip(gprogs, pl.reconstruct_stream(gprogs)):
        if poc != gp.poc or any(not q.is_cuda or q.dtype != torch.uint16
                                for q in planes):
            raise AssertionError(f"10-bit chain: POC {poc}")
        assert_bit_exact([[q.int() for q in planes]], [gp],
                         f"10-bit chain POC {poc}")
        n += 1
    peak = max(int(gp.planes[0].max()) for gp in gprogs)
    if n != len(gprogs) or peak <= 255:
        raise AssertionError(f"10-bit chain: {n} pictures, peak {peak}")
    log(f"10-bit reconstruct_stream chain (64x48, {n} pictures, samples up "
        f"to {peak}): bit-exact on the card, uint16 planes")
    return run, err, ncases, pprogs, progs


# ---------------------------------------------------------------------------
# phase 7: the multi-device paths (parallel/), k entries of one card
# ---------------------------------------------------------------------------

def concurrent_parse(segs):
    """Each segment parsed on its own thread at once (a parse-only Decoder
    that keeps the programs, as GopParallelDecoder runs it); returns the
    wall seconds and each thread's ms per picture."""
    import threading
    from libde265_tpu_torch import Decoder
    per = [None] * len(segs)

    def parse(i):
        t0 = time.perf_counter()
        dec = Decoder(parse_only=True, keep_programs=True)
        list(dec.decode_all(segs[i]))
        per[i] = 1000 * (time.perf_counter() - t0) / dec.num_programs()

    threads = [threading.Thread(target=parse, args=(i,))
               for i in range(len(segs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return time.perf_counter() - t0, per


def gop_parallel_phase(smi):
    """(a) GopParallelDecoder(["cuda:0"] * k) on a 1080p P-GOP of 12
    frames, intra period 4 (3 segments: 16 frames took about a minute to
    encode on the card machine's host, 12 keep the phase near two
    minutes; so k = 4 leaves its fourth entry idle and decodes as k = 3
    would): the k = 4 run is the main path (counts set to 0 before it,
    read after; every kernel of the production formulation launched, B2,
    B3 and B5 at least once per P picture); fps of k = 1, 2, 4 and of
    PipelinedDecoder() over 3 passes in turns, every frame bit-exact; the
    parse ms per picture with 1, 2 and 4 segments parsed at once (the
    fourth thread parses the first segment again, on its own decoder).
    Returns the main-path run's (counts, seconds)."""
    import torch
    import libde265_tpu_torch as lt
    from libde265_tpu_torch.parallel import (GopParallelDecoder,
                                             split_segments)
    frames = 12
    data, t_enc = make_stream(BUILD / "chip_smoke" / f"1080p_{frames}f.h265",
                              1920, 1088, frames, 32,
                              {"intra-period": 4, "sao": True})
    log(f"stream: 1920x1088 P-GOP, {frames} frames, intra period 4, "
        f"{len(data)} bytes, encoded in {t_enc:.1f} s")
    segs = split_segments(data)
    if len(segs) != frames // 4:
        raise AssertionError(f"{len(segs)} segments, expected {frames // 4}")
    _, progs = oracle_programs(data)

    def run(k):
        dec = lt.PipelinedDecoder() if k == 0 else \
            GopParallelDecoder(["cuda:0"] * k)
        t0 = time.perf_counter()
        outs = dec.decode_stream(data)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        what = "PipelinedDecoder" if k == 0 else f"GopParallelDecoder k={k}"
        assert_bit_exact(outs, progs, f"1080p {frames} frames, {what}")
        if k and dec.last_assignment != [i % k for i in range(len(segs))]:
            raise AssertionError(f"{what}: segments on entries "
                                 f"{dec.last_assignment}")
        return dt, (dec.last_parse_s if k else None)

    reset_counts()
    dt, _ = run(4)
    counts = read_counts()
    for n in KERNELS:    # the production formulation: B1-B5, scan, B8-B10
        if counts[n] == 0:
            raise AssertionError(f"GOP-parallel: no {n} launch")
    n_p = sum(len(p.pus) > 0 for p in progs)
    for n in (B2, B3, B5):
        if counts[n] < n_p:
            raise AssertionError(f"GOP-parallel: {counts[n]} {n} launches "
                                 f"over {n_p} P pictures")
    n_rec = sum(len(p.intras) > 0 for p in progs)
    if counts[BINS] != n_rec:
        raise AssertionError(f"GOP-parallel: {counts[BINS]} {BINS} launches "
                             f"over {n_rec} pictures with intra records")
    if counts[RES] != counts[B4]:
        raise AssertionError(f"GOP-parallel: {counts[RES]} {RES} launches, "
                             f"{counts[B4]} of B4")
    log(f"GOP-parallel k=4 (main path): {frames} frames bit-exact, "
        f"{len(segs)} segments on entries {list(range(len(segs)))}"
        f"{f' (entry {len(segs)} idle)' if len(segs) < 4 else ''}, "
        f"{frames / dt:.4f} fps; launches {json.dumps(counts)}")
    fps = {k: [] for k in (0, 1, 2, 4)}
    parse_s = {k: [] for k in (1, 2, 4)}
    for _ in range(3):
        for k in (0, 1, 2, 4):
            t, ps = run(k)
            fps[k].append(frames / t)
            if k:
                parse_s[k].append(ps)
    for k, v in fps.items():
        what = "PipelinedDecoder()" if k == 0 else \
            f"GopParallelDecoder(['cuda:0'] * {k})"
        extra = "" if k == 0 else (
            f"; its concurrent parse {[round(1e3 * x, 1) for x in parse_s[k]]}"
            f" ms of the stream")
        log(f"1080p {frames}-frame P-GOP, {what}: fps over 3 passes in turns "
            f"{[round(x, 4) for x in v]}, median "
            f"{statistics.median(v):.4f}{extra} on {smi}")
    for n in (1, 2, 4):
        walls, per = [], []
        for _ in range(3):
            wall, p = concurrent_parse([segs[i % len(segs)]
                                        for i in range(n)])
            walls.append(wall)
            per.extend(p)
        log(f"parse of {n} segment(s) at once (4 pictures each, 3 reps): "
            f"ms per picture per thread median "
            f"{statistics.median(per):.2f} (min {min(per):.2f}, max "
            f"{max(per):.2f}); wall median {1e3 * statistics.median(walls):.1f}"
            f" ms, {4 * n / statistics.median(walls):.2f} pictures/s in all; "
            f"{os.cpu_count()} host cores on {smi}")
    return counts, dt


def sharded_tile_phase(smi):
    """(b) ShardedTileDecoder over 8 entries of the card on two 1920x1088
    streams with CTB 32 and 4x2 tiles of 480x544 (4 frames, intra period
    8), one gated and one filtering across tiles: a warm pass, then the
    main path (counts set to 0 before, read after; per-picture launches
    and synced ms), every frame bit-exact; then the host partition of
    each picture alone and the last picture under torch.profiler (device
    busy ms, idle share).  Returns one (counts, seconds) per stream."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from libde265_tpu_torch.parallel import (ShardedTileDecoder, make_mesh,
                                             tile_grid)
    runs = []
    for across in (False, True):
        what = "across tiles" if across else "gated"
        data, t_enc = make_stream(
            BUILD / "chip_smoke" /
            f"1080p_tiles4x2_{'across' if across else 'gated'}.h265",
            1920, 1088, 4, 32,
            {"intra-period": 8, "sao": True, "tile-cols": 4, "tile-rows": 2,
             "across-tiles": across}, ctb=32)
        _, progs = oracle_programs(data)
        rows, cols = tile_grid(progs[0])
        if rows != [(0, 544), (544, 1088)] or \
                cols != [(x, x + 480) for x in range(0, 1920, 480)] or \
                progs[0].across_tiles != across:
            raise AssertionError(f"tiles ({what}): rows {rows}, cols {cols}")
        log(f"stream: 1920x1088, CTB 32, 4x2 tiles of 480x544, {what}, 4 "
            f"frames, {len(data)} bytes, encoded in {t_enc:.1f} s")
        sd = ShardedTileDecoder(make_mesh(devices=["cuda:0"] * 8))
        for p in progs:                                 # warm
            sd.decode(p)
        torch.cuda.synchronize()
        sd = ShardedTileDecoder(make_mesh(devices=["cuda:0"] * 8))
        outs, ms, per = [], [], []
        reset_counts()
        prev = read_counts()
        t_run = time.perf_counter()
        for p in progs:
            t0 = time.perf_counter()
            outs.append(sd.decode(p))
            torch.cuda.synchronize()
            ms.append(1000 * (time.perf_counter() - t0))
            c = read_counts()
            per.append({n: c[n] - prev[n] for n in NAMES if c[n] - prev[n]})
            prev = c
        dt = time.perf_counter() - t_run
        counts = read_counts()
        assert_bit_exact(outs, progs, f"tile-sharded ({what})")
        for i, c in enumerate(per):
            if (c.get(PARAMS), c.get(B8), c.get(B9), c.get(B10),
                    c.get(BINS)) != (8, 8, 8, 24,
                                     8 if len(progs[i].intras) else None):
                raise AssertionError(f"tile-sharded ({what}) picture {i}: "
                                     f"launches {json.dumps(c)}")
        for n in (B4, SCAN, PARAMS, B8, B9, B10):
            if counts[n] == 0:
                raise AssertionError(f"tile-sharded ({what}): no {n} launch")
        log(f"tile-sharded ({what}): 4 frames bit-exact on 8 entries of the "
            f"card; synced ms per picture {[round(x, 2) for x in ms]}; "
            f"launches per picture {json.dumps(per)} on {smi}")
        runs.append((counts, dt))
        sharded_kernel_check(progs[0], per[0], what, smi)
        part = []
        for p in progs:
            t0 = time.perf_counter()
            sd._partition(p)
            part.append(1000 * (time.perf_counter() - t0))
        sd = ShardedTileDecoder(make_mesh(devices=["cuda:0"] * 8))
        for p in progs[:-1]:
            sd.decode(p)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sd.decode(progs[-1])
            torch.cuda.synchronize()
            wall = 1000 * (time.perf_counter() - t0)
        busy = sum(_device_us(e) for e in prof.key_averages()) / 1000
        log(f"tile-sharded ({what}): host partition alone (tile grid, "
            f"per-tile TU bins, intra records) ms per picture "
            f"{[round(x, 2) for x in part]}; picture 3 profiled: wall "
            f"{wall:.2f} ms, device busy {busy:.2f} ms"
            + (f", idle share {1 - busy / wall:.3f}" if busy > 0 else
               " (the profiler saw no device time; idle share not "
               "measured)") + f" on {smi}")
    return runs


def sharded_kernel_check(prog, launches, what, smi):
    """Picture 0 of a tile-sharded stream decoded again (a fresh decoder,
    the wrappers recording their arguments): each call of B4, the scan,
    B8, B9 and B10 at the tile shapes (and, across tiles, the halo-padded
    shapes of the halo filter with its allow and edge_ok masks) against
    its plain version on the card, tolerance 0; the calls per family
    equal the main path's launches of that picture."""
    import torch
    from libde265_tpu_torch.parallel import ShardedTileDecoder, make_mesh
    t0 = time.perf_counter()
    sd = ShardedTileDecoder(make_mesh(devices=["cuda:0"] * 8))
    (cap,) = capture_inputs(sd, [prog], trace_scan=False)
    calls = {}
    for name, c in cap.items():
        calls[FAMILY[name]] = calls.get(FAMILY[name], 0) + len(c)
    if calls != launches or \
            set(calls) != {B4, RES, SCAN, BINS, PARAMS, B8, B9, B10}:
        raise AssertionError(f"tile-sharded ({what}) picture 0: calls "
                             f"{json.dumps(calls)}, main-path launches "
                             f"{json.dumps(launches)}")
    shapes = {name: sorted({tuple(a[0].shape) for a, _ in c})
              for name, c in cap.items()
              if name not in ("densify_bins", "residual_bins", "intra_scan",
                              "intra_bins", "deblock_params")}
    shapes["intra_scan"] = sorted({tuple(p.shape) for a, _ in
                                   cap.get("intra_scan", []) for p in a[0]})
    err, ncases = compare_kernels([(f"tile-sharded ({what}) picture 0",
                                    cap)])
    del cap
    torch.cuda.synchronize()
    held = (B4, RES, SCAN, BINS, PARAMS, B8, B9, B10)
    log(f"tile-sharded ({what}) picture 0: B4, the residual bins, the scan, "
        f"its records, the edge parameters, B8, B9 and B10 equal to their "
        f"plain versions on "
        f"its "
        f"calls (tolerance 0): {json.dumps({n: ncases[n] for n in held})}; "
        f"plane shapes {json.dumps(shapes)}; checked in "
        f"{time.perf_counter() - t0:.1f} s on {smi}")


def filter_pipeline_phase(smi):
    """(c) sharded_filter_pipeline at 1088x1928 with 4 row shards on the
    card: the main path (counts set to 0 before, read after: B8 once per
    shard and pass) equal to the single-device composition of luma_pass
    and to that of its plain version; synced ms of the first two.  Returns
    (counts, seconds)."""
    import torch
    from libde265_tpu_torch.ops.deblock import _luma_pass
    from libde265_tpu_torch.ops.deblock_cuda import luma_pass
    from libde265_tpu_torch.parallel import (make_mesh,
                                             sharded_filter_pipeline)
    H, W = 1088, 1920
    rng = np.random.default_rng(11)
    dev = torch.device("cuda")

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    def prm(shape):
        return [t(rng.integers(0, 3, shape)), t(np.full(shape, 48)),
                t(np.full(shape, 6)), t(rng.integers(0, 2, shape)),
                t(rng.integers(0, 2, shape))]

    args = [t(rng.integers(0, 255, (H, W + 8)))] + prm((H // 4, W // 8)) + \
        prm(((W + 8) // 4, H // 8))
    fn = sharded_filter_pipeline(make_mesh(devices=["cuda:0"] * 4))
    fn(*args)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    got = fn(*args)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()

    def single(fn=luma_pass):
        v = fn(*args[:6], bit_depth=8)
        return fn(v.T.contiguous(), *args[6:], bit_depth=8).T

    if not torch.equal(got, single()):
        raise AssertionError("sharded_filter_pipeline differs from the "
                             "single-device composition")
    # the same composition of B8's plain version: a wrong B8 at the
    # shards' shapes would pass the comparison above
    if not torch.equal(got, single(_luma_pass)):
        raise AssertionError("sharded_filter_pipeline differs from the "
                             "composition of the plain luma pass")
    if counts[B8] != 8 or sum(counts.values()) != 8:
        raise AssertionError(f"filter pipeline: launches "
                             f"{json.dumps(counts)}")
    log(f"sharded_filter_pipeline 1088x1928, 4 row shards on the card: "
        f"equal to the single-device composition of B8 and of its plain "
        f"version (tolerance 0); B8 launches 8; synced "
        f"{median_ms(lambda: fn(*args), reps=10):.4f} ms against "
        f"{median_ms(single, reps=10):.4f} ms single (CUDA events, median "
        f"of 10) on {smi}")
    return counts, dt


def multi_device_phase(smi):
    """Phase 7: the GOP-parallel, tile-sharded and filter-pipeline paths;
    returns their main-path runs' (counts, seconds)."""
    t0 = time.perf_counter()
    runs = [gop_parallel_phase(smi)] + sharded_tile_phase(smi) + \
        [filter_pipeline_phase(smi)]
    log(f"phase 7 (multi-device paths) took {time.perf_counter() - t0:.1f} "
        f"s, stream encodes included")
    return runs


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 8: the per-op DeviceDecoder, and programs without the intra plan
# ---------------------------------------------------------------------------

def device_decoder_run(what, pprogs, progs, routed=0, waves=None,
                       capture=None):
    """One main-path run of DeviceDecoder() over parse-only programs:
    counts set to 0, every picture decoded and synchronised (synced ms and
    its launches, read as differences), counts read; every picture held
    bit-exact against the oracle's, the edge parameters, B8 and B9 once
    and B10 three times in each (nothing else: the rest is PyTorch),
    `routed` pictures that the JAX module sends to its pipeline or cannot
    decode.  waves: a list that gets each picture's number of
    intra_wave_kernel calls and host ms in intra_wave.plan_blocks.
    capture: a dict that gets picture 0's kernel calls (capture_inputs's
    form).  Returns ((counts, seconds), per-picture [(ms, intra
    picture)], the decoder)."""
    import torch
    from libde265_tpu_torch import tpu_decode
    from libde265_tpu_torch.ops import intra_wave
    dd = tpu_decode.DeviceDecoder()
    if dd.device.type != "cuda":
        raise AssertionError(f"DeviceDecoder() on {dd.device}")
    kernel, plan = intra_wave.intra_wave_kernel, intra_wave.plan_blocks
    n_calls, plan_ms = [0], [0.0]

    def counted(*a, **k):
        n_calls[0] += 1
        return kernel(*a, **k)

    def timed_plan(*a, **k):
        t0 = time.perf_counter()
        out = plan(*a, **k)
        plan_ms[0] += 1000 * (time.perf_counter() - t0)
        return out

    intra_wave.intra_wave_kernel, intra_wave.plan_blocks = counted, timed_plan
    outs, rows = [], []
    try:
        reset_counts()
        t_all = time.perf_counter()
        for i, p in enumerate(pprogs):
            before = read_counts()
            n_calls[0], plan_ms[0] = 0, 0.0
            t0 = time.perf_counter()
            if i == 0 and capture is not None:
                (got,) = capture_inputs(dd, [p], keep=outs)
                capture.update(got)
            else:
                outs.append(dd.decode(p))
            torch.cuda.synchronize()
            ms = 1000 * (time.perf_counter() - t0)
            c = {n: v - before[n] for n, v in read_counts().items()}
            if (c[PARAMS], c[B8], c[B9], c[B10]) != (1, 1, 1, 3) or \
                    sum(c.values()) != 6:
                raise AssertionError(f"{what} picture {i}: launches "
                                     f"{json.dumps(c)}")
            rows.append((ms, len(p.pus) == 0))
            if waves is not None:
                waves.append((n_calls[0], plan_ms[0]))
        dt = time.perf_counter() - t_all
        counts = read_counts()
    finally:
        intra_wave.intra_wave_kernel, intra_wave.plan_blocks = kernel, plan
    assert_bit_exact(outs, progs, what)
    if dd.pipeline_pictures != routed:
        raise AssertionError(f"{what}: {dd.pipeline_pictures} pictures "
                             f"with more than MAX_REFS references, CCP or "
                             f"RDPCM, expected {routed}")
    return (counts, dt), rows, dd


def profile_decode(dd, prog):
    """torch.profiler (device activity) over dd.decode(prog): wall ms,
    device busy ms (the durations of the kernels, copies and fills, one
    stream) and device operations, summed from the profiler's raw events
    (key_averages takes minutes over the 400,000 operations of an I
    picture).  dd holds prog's references (a picture it decoded before is
    decoded again, to the same planes)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dd.decode(prog)
        torch.cuda.synchronize()
        wall = 1000 * (time.perf_counter() - t0)
    cuda = torch.autograd.DeviceType.CUDA
    ns = [e.duration_ns() for e in prof.profiler.kineto_results.events()
          if e.device_type() == cuda]
    return wall, sum(ns) / 1e6, len(ns)


def device_decoder_phase(smi, pprogs, progs, iprogs, stripe_pprogs,
                         stripe_progs):
    """Phase 8: a. the first GOP of the 1080p P-GOP (an I picture and 3 P
    pictures) through DeviceDecoder() from parse-only programs
    (per-picture ms, launches, the intra wavefront's calls and host plan,
    picture 0's B8, B9, B10 calls against their plain versions, then one
    P and one I picture again under torch.profiler); b. the 1080p stripe
    stream through DeviceDecoder(), pictures 9-11 (more than MAX_REFS
    references) counted;
    c. the 1080p all-intra pictures without their native intra plan or
    source through FusedDecoder() (numpy pack, records from
    feed._plan_intra; its host ms beside the native records', picture 0's
    records against the native ones).  An I picture takes seconds of host
    time here (the wavefront's plan and its calls), so 8a decodes one I
    picture, not the P-GOP's two.  Each main-path run with the counts set
    to 0 before it and read after it.  Returns the runs [(counts,
    seconds)] and the kernel comparison's (max error, cases)."""
    import dataclasses
    import torch
    import libde265_tpu_torch as lt
    from libde265_tpu_torch import feed
    t_phase = t_part = time.perf_counter()

    def part(name):
        nonlocal t_part
        now = time.perf_counter()
        log(f"phase {name} took {now - t_part:.1f} s")
        t_part = now

    # a. the first GOP of the P-GOP
    gop = next(i for i, p in enumerate(pprogs) if i and not len(p.pus))
    waves, cap = [], {}
    run_a, rows, dd = device_decoder_run(
        "DeviceDecoder 1080p P-GOP", pprogs[:gop], progs[:gop], waves=waves,
        capture=cap)
    for kind, intra in (("I", True), ("P", False)):
        ms = [round(r[0], 2) for r in rows if r[1] == intra]
        w = [n for n, r in zip(waves, rows) if r[1] == intra]
        log(f"DeviceDecoder 1080p P-GOP: {kind} pictures ms (synced) {ms}, "
            f"median {statistics.median(ms):.2f}; per picture "
            f"intra_wave_kernel calls {[n for n, _ in w]}, host ms in "
            f"intra_wave.plan_blocks {[round(m, 1) for _, m in w]}; edge "
            f"parameters / B8 / B9 / B10 launches per picture 1 / 1 / 1 / 3 "
            f"on {smi}")
    log(f"DeviceDecoder 1080p P-GOP: frames 0-{gop - 1} bit-exact from "
        f"parse-only programs, {gop / run_a[1]:.4f} fps; launches "
        f"{json.dumps(run_a[0])}")
    if set(cap) != {"deblock_params", "deblock_luma", "deblock_chroma",
                    "sao_plane_fused"}:
        raise AssertionError(f"DeviceDecoder picture 0: kernels "
                             f"{sorted(cap)}")
    err, ncases = compare_kernels([("DeviceDecoder picture 0", cap)])
    log(f"DeviceDecoder picture 0: the edge parameters, B8, B9 and B10 "
        f"equal to their plain "
        f"versions on its calls (tolerance 0): "
        f"{json.dumps({n: ncases[n] for n in (PARAMS, B8, B9, B10)})}")
    for kind, idx in (("P", 1), ("I", 0)):
        wall, busy, n_ops = profile_decode(dd, pprogs[idx])
        log(f"profiled DeviceDecoder {kind} picture {idx}: wall "
            f"{wall:.2f} ms, device busy {busy:.2f} ms, idle share "
            + (f"{1 - busy / wall:.3f}" if busy > 0 else "not measured")
            + f", {n_ops} device operations on {smi}")
    del dd, cap
    part("8a")

    # b. more than MAX_REFS references
    routed = [i for i, p in enumerate(stripe_pprogs)
              if len(p.ref_pocs) > feed.MAX_REFS]
    run_b, rows, _ = device_decoder_run(
        "DeviceDecoder 1080p many references", stripe_pprogs, stripe_progs,
        routed=3)
    log(f"DeviceDecoder 1080p many references: {len(stripe_pprogs)} frames "
        f"bit-exact, {len(routed)} with more than MAX_REFS references "
        f"(pictures {routed}); ms (synced) {[round(r[0], 2) for r in rows]} on {smi}")
    part("8b")

    # c. the all-intra pictures without the native intra plan or source
    bare = [dataclasses.replace(p, ip=None, src=None) for p in iprogs]
    plan, spent = feed._plan_intra, []

    def timed_plan(*a):
        t0 = time.perf_counter()
        out = plan(*a)
        spent.append((1000 * (time.perf_counter() - t0), out))
        return out

    fd = lt.FusedDecoder()
    feed._plan_intra = timed_plan
    try:
        reset_counts()
        t0 = time.perf_counter()
        outs = [fd.decode(p) for p in bare]
        torch.cuda.synchronize()
        run_c = (read_counts(), time.perf_counter() - t0)
    finally:
        feed._plan_intra = plan
    assert_bit_exact(outs, iprogs, "all-intra without the intra plan")
    pk = fd.packer
    if run_c[0][SCAN] != len(bare) or run_c[0][BINS] != len(bare) or \
            len(spent) != len(bare) or \
            (pk.numpy_packs, pk.native_packs) != (len(bare), 0):
        raise AssertionError(f"all-intra without the intra plan: "
                             f"{run_c[0][SCAN]} scans, {run_c[0][BINS]} "
                             f"{BINS}, {len(spent)} plans, "
                             f"{pk.numpy_packs} numpy and "
                             f"{pk.native_packs} native packs")
    native_ms = []
    for p in iprogs:
        t0 = time.perf_counter()
        feed._intra_records_native(p)
        native_ms.append(1000 * (time.perf_counter() - t0))
    got, want = spent[0][1], feed._intra_records_native(iprogs[0])
    if not (np.array_equal(got[0], want[0]) and got[1] == want[1] and
            np.array_equal(got[2], want[2])):
        raise AssertionError("picture 0: _plan_intra's records differ from "
                             "the native plan's")
    log(f"1080p all-intra without the native intra plan (ip=None, "
        f"src=None), FusedDecoder(): {len(bare)} frames bit-exact, "
        f"{run_c[0][SCAN]} scan launches, {pk.numpy_packs} numpy packs; "
        f"picture 0's records equal the native plan's word for word "
        f"({want[0].shape[0]} blocks, {want[1]} steps); _plan_intra host ms "
        f"per picture {[round(m, 1) for m, _ in spent]} against the native "
        f"records' {[round(m, 2) for m in native_ms]}; "
        f"{len(bare) / run_c[1]:.4f} fps on {smi}")
    part("8c")
    log(f"phase 8 (DeviceDecoder, no intra plan) took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return [run_a, run_b, run_c], err, ncases


def main():
    t_start = time.perf_counter()
    smi = card_check()
    import torch

    # ---- phase 2: build ----
    t_native = build_native()
    from libde265_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.lib()
    t_kern = time.perf_counter() - t0
    log(f"build: native library {t_native:.1f} s, CUDA kernels "
        f"{t_kern:.1f} s (parallel nvcc + link {_build.build_seconds} s)")
    for line in _build.build_log.splitlines():
        if any(k in line for k in ("intra", "mc", "paint", "residual",
                                   "expand", "registers", "spill")):
            log(f"  ptxas: {line.strip()}")

    import libde265_tpu_torch as lt
    dev = torch.device("cuda")

    # ---- phase 3: main path at 1080p ----
    frames = 8
    data, t_enc = make_stream(BUILD / "chip_smoke" / f"1080p_{frames}f.h265",
                              1920, 1088, frames, 32,
                              {"intra-period": 4, "sao": True})
    log(f"stream: 1920x1088 P-GOP, {frames} frames, {len(data)} bytes, "
        f"encoded in {t_enc:.1f} s")
    idata, t_enc = make_stream(BUILD / "chip_smoke" / "1080p_intra_4f.h265",
                               1920, 1088, 4, 32,
                               {"intra-period": 1, "sao": True})
    log(f"stream: 1920x1088 all-intra, 4 frames, {len(idata)} bytes, "
        f"encoded in {t_enc:.1f} s")
    _, progs = oracle_programs(data)
    _, iprogs = oracle_programs(idata)
    is_intra = [len(p.pus) == 0 for p in progs]
    first_i, first_p = is_intra.index(True), is_intra.index(False)
    if not all(len(p.pus) == 0 for p in iprogs):
        raise AssertionError("the all-intra stream has inter pictures")

    warm = lt.PipelinedDecoder()               # CUDA / cuBLAS set-up
    if warm.fd.device.type != "cuda":
        raise AssertionError(f"default device {warm.fd.device}")
    warm.decode_stream(data)
    torch.cuda.synchronize()

    runs = [main_path_run("1080p P-GOP", data, progs),
            main_path_run("1080p all-intra", idata, iprogs)]
    counts = {n: sum(r[0][n] for r in runs) for n in NAMES}
    for n in KERNELS:
        if counts[n] == 0:
            raise AssertionError(f"{n}: no launch on the main path")
    log(f"launches in the main-path runs: {json.dumps(counts)}")
    n_pics = len(progs) + len(iprogs)
    n_i = sum(is_intra) + len(iprogs)
    if not n_i <= counts[SCAN] <= n_pics:
        raise AssertionError(f"intra launches: {counts[SCAN]} scans over "
                             f"{n_pics} pictures ({n_i} I)")
    log(f"intra scan launches {counts[SCAN]} over {n_pics} pictures ({n_i} "
        f"I, the rest P with or without intra blocks)")
    n_rec = sum(len(p.intras) > 0 for p in progs + iprogs)
    if counts[BINS] != n_rec or counts[SCAN] != n_rec:
        raise AssertionError(f"{counts[BINS]} {BINS} and {counts[SCAN]} scan "
                             f"launches over {n_rec} pictures with intra "
                             f"records")

    # the parse alone, against the pipelined decode's ms per picture
    for (counts_, dt), what, d, pp in zip(runs, ("P-GOP", "all-intra"),
                                          (data, idata), (progs, iprogs)):
        log(f"parse alone of the 1080p {what}: {parse_ms(d):.2f} ms per "
            f"picture (host, one parse-only pass), against "
            f"{1000 * dt / len(pp):.2f} ms per picture end to end "
            f"(PipelinedDecoder); {os.cpu_count()} host cores on {smi}")

    # the native against the numpy packer, picture by picture
    for what, pp in (("P-GOP", progs), ("all-intra", iprogs)):
        for i, (nat_ms, np_ms, words) in enumerate(pack_compare(pp)):
            kind = "P" if len(pp[i].pus) else "I"
            log(f"pack of 1080p {what} picture {i} ({kind}): native "
                f"{nat_ms:.2f} ms, numpy {np_ms:.2f} ms (host; {words} "
                f"words, equal) on {smi}")

    # per-picture synced times, launches and upload bytes (I/P split)
    for what, pp in (("P-GOP", progs), ("all-intra", iprogs)):
        rows, ring = per_picture(pp)
        for ms_, c, intra, _, rec in rows:
            if c[SCAN] != rec or (intra and not rec):
                raise AssertionError(f"{what}: {c[SCAN]} scan launches in a "
                                     f"picture")
            if c[BINS] != rec:
                raise AssertionError(f"{what}: {c[BINS]} {BINS} launches in "
                                     f"a picture with{'' if rec else 'out'} "
                                     f"intra records")
            if c[PARAMS] != 1 or c[B8] != 1 or c[B9] != 1:
                raise AssertionError(f"{what}: {c[PARAMS]} edge-parameter, "
                                     f"{c[B8]} B8 and {c[B9]} B9 launches "
                                     f"in a picture, not 1 / 1 / 1")
            if c[B4] != 1 or c[B1] != 1 or c[RES] != 1:
                raise AssertionError(f"{what}: {c[B4]} B4, {c[B1]} B1 and "
                                     f"{c[RES]} {RES} launches in a "
                                     f"picture, not 1 / 1 / 1")
        for kind, want in (("I", True), ("P", False)):
            sel = [r for r in rows if r[2] == want]
            if not sel:
                continue
            med = statistics.median(r[0] for r in sel)
            log(f"{what}: {kind} pictures ms (synced) "
                f"{[round(r[0], 2) for r in sel]}, median {med:.2f}; "
                f"launches per picture {json.dumps(sel[0][1])}; feed upload "
                f"bytes (last_wire_bytes) {[r[3] for r in sel]} on {smi}")
        log(f"{what}: DPB ring {ring} bytes (3 planes x 17 padded slots)")

    for what, pp, idx in (("P-GOP I", progs, first_i),
                          ("P-GOP P", progs, first_p)):
        for sec, fn in (("deblocking", deblock_section),
                        ("residual", residual_section)):
            sms, dms, ops = fn(pp, idx)
            log(f"{sec} section of {what} picture {idx} alone: synced "
                f"{sms:.4f} ms (median of 20), device "
                f"{'not measured' if dms is None else f'{dms:.4f} ms'}, "
                f"{sum(ops.values()):g} device operations"
                + (f" {json.dumps(ops)}" if sec == "residual" else "")
                + f" on {smi}")
        for how, (sms, dms, ops) in zip(("sparse (B1)", "whole feed"),
                                        upload_section(pp, idx)):
            log(f"upload section of {what} picture {idx} alone, {how}: "
                f"synced {sms:.4f} ms (median of 20), device "
                f"{'not measured' if dms is None else f'{dms:.4f} ms'}, "
                f"{sum(ops.values()):g} device operations {json.dumps(ops)} "
                f"on {smi}")
    for what, pp, idx in (("all-intra", iprogs, 1),
                          ("P-GOP P", progs, first_p)):
        wall, busy, named = profile_picture(pp, idx)
        if busy > 0:
            log(f"profiled {what} picture {idx}: wall {wall:.2f} ms, device "
                f"busy {busy:.2f} ms, idle share {1 - busy / wall:.3f}; "
                f"intra, deblocking, B4 and residual bins kernels (device "
                f"ms, launches) "
                f"{json.dumps(named)} on {smi}")
        else:
            log(f"profiled {what} picture {idx}: the profiler saw no device "
                "time; idle share not measured")

    # ---- phase 4: kernels vs plain on the card ----
    fd = lt.FusedDecoder(device=dev)
    fd.plan_stream(progs)
    caps = capture_inputs(fd, progs[:first_p + 1])
    del fd
    (b4_bins,), _ = caps[first_p]["densify_bins"][0]
    b4_sizes = [(N, S) for _, _, N, S in b4_bins]
    log(f"{B4}: the 1080p P picture's bins (N, S) {b4_sizes}")
    rand = random_cases(dev, b4_sizes)
    err, ncases = compare_kernels(
        [("random", rand),
         (f"frame {first_i} (I)", caps[first_i]),
         (f"frame {first_p} (P)", caps[first_p])])
    # times on the P picture's calls; a family that the P picture did not
    # call is timed on the I picture's calls, else on its random cases
    captured = {**caps[first_i], **caps[first_p]}
    # the scan's records timed on the I picture's, the most of the two
    captured["intra_bins"] = caps[first_i]["intra_bins"]
    on_path = {FAMILY[k] for k in captured}
    timed = {**{k: v for k, v in rand.items()
                if FAMILY[k] not in INTRA and FAMILY[k] not in on_path},
             **captured}
    pic_of = {FAMILY[k]: ("I" if k == "intra_bins" else
                          "P" if k in caps[first_p] else
                          "I" if k in caps[first_i] else "random")
              for k in timed}
    ms = time_calls(timed)
    # B5 on the I picture's calls too: bins the feed ships with no segment
    b5_i = time_calls({"residual_stripes":
                       caps[first_i]["residual_stripes"]})[B5]
    live_i = sum(int(a[1].clamp(max=a[2].shape[1]).sum())
                 for a, _ in caps[first_i]["residual_stripes"])
    log(f"{B5} on 1080p I picture {first_i} ({b5_i[4]} calls, {live_i} "
        f"segments): {b5_i[0]:.4f} ms (CUDA events; device time "
        f"{b5_i[5]} ms) vs plain {b5_i[1]:.4f} ms, bound "
        f"{_bound(B5, b5_i[2], b5_i[3])[0]:.4f} ms ({b5_i[2]} bytes) on "
        f"{smi}")
    # the residual bins on the I picture's call too (the P picture's is
    # the kernels line's row)
    res_i = time_calls({"residual_bins":
                        caps[first_i]["residual_bins"]})[RES]
    log(f"{RES} on 1080p I picture {first_i} ({res_i[4]} call, "
        f"{res_i[3]} samples): {res_i[0]:.4f} ms (CUDA events, with the "
        f"copy of its input; device time {res_i[5]} ms) vs plain "
        f"{res_i[1]:.4f} ms, bound {_bound(RES, res_i[2], res_i[3])[0]:.4f} "
        f"ms ({res_i[2]} bytes) on {smi}")
    # B5, B2, B8, B9, B4 and B1 allocate their outputs unfilled and copy
    # nothing, the edge parameters write a kept arena, the residual bins
    # write over their input: the kernel must be the only device work of
    # a call; the scan's records clear their kept arena first (one memset)
    for name, marks in (("expand_blocks", ("expand_kernel",)),
                        ("densify_bins", ("densify_bins_kernel",)),
                        ("residual_bins", ("residual_bins_kernel",)),
                        ("residual_stripes", ("residual_kernel",)),
                        ("paint_pu_idx", ("paint_kernel",)),
                        ("deblock_luma", ("deblock_kernel",)),
                        ("deblock_chroma", ("deblock_kernel",)),
                        ("deblock_params", ("deblock_params_kernel",)),
                        ("intra_bins", ("intra_bins_kernel", "Memset"))):
        args, kw = (caps[first_i] if name == "intra_bins" else
                    caps[first_p])[name][0]
        if name in INPLACE:     # the input's copy is not the call's work
            args = (args[0].clone(), *args[1:])
        seen = device_kernels(lambda: kernel_of(name)(*args, **kw))
        if not seen:
            log(f"{name}: the profiler saw no device time; its device "
                f"work not checked")
        elif any(not any(m in k for m in marks) for k in seen) or \
                not any(marks[0] in k for k in seen):
            raise AssertionError(f"{name}: device work besides its kernel: "
                                 f"{json.dumps(seen)}")
        else:
            log(f"{name}: device work of one call {json.dumps(seen)}")
    library = {n: None for n in ROWS}
    library[B1], lib_dev, b1_ev = expand_library_ms(
        caps[first_p]["expand_blocks"])
    log(f"{B1}: the one indexing call of its plain version (rows[sel]) on "
        f"the P picture's inputs {library[B1]:.4f} ms (CUDA events; device "
        f"time {lib_dev} ms), B1 in turns with it {b1_ev:.4f} ms (CUDA "
        f"events) on {smi}")
    compare_intra_trace(caps[first_i]["intra_scan"], err, ncases, ms)
    shape = scan_shape(caps[first_i]["intra_scan"])
    log(f"intra scan of 1080p I picture {first_i}: {json.dumps(shape)}")
    del caps, timed, rand
    hold_scans("1080p all-intra", iprogs, err, ncases)

    # ---- phase 4b: the scan's chain bound ----
    from libde265_tpu_torch.ops import _build
    steps = max(shape["steps"])
    scan_threads = _build.lib().tde_scan_threads()
    chain = chain_probe(steps, scan_threads)
    for way, (us, cycles) in chain.items():
        log(f"chain probe, {way}: {us:.4f} us ({cycles:.1f} cycles) a "
            f"dependent step (store, block barrier, load, store; one CTA of "
            f"{scan_threads} threads, the scan's, {steps} rounds) on {smi}")
    chain_ms = steps * chain["global (ld.global)"][0] / 1e3
    byte_ms = _bound(SCAN, ms[SCAN][2], ms[SCAN][3])[0]
    d_scan = ms[SCAN][5]
    log(f"scan of 1080p I picture {first_i}: {steps} steps, device "
        + ("not measured" if d_scan is None else
           f"{d_scan:.4f} ms = {1e3 * d_scan / steps:.4f} us a step; "
           f"byte bound {byte_ms:.4f} ms (share {byte_ms / d_scan:.4f}), "
           f"chain bound {chain_ms:.4f} ms (steps x the global round trip; "
           f"share {chain_ms / d_scan:.4f}), through shared memory "
           f"{steps * chain['shared'][0] / 1e3:.4f} ms")
        + f" on {smi}")
    for n in ROWS:
        k_ms, p_ms, nbytes, nout, ncalls, d_ms = ms[n]
        bound_ms, _ = _bound(n, nbytes, nout)
        pic = "I" if n in INTRA else pic_of[n]
        dev_txt = "not measured" if d_ms is None else f"{d_ms:.4f} ms"
        log(f"{n}: {ncases[n]} cases equal to the plain version (tolerance "
            f"0, integer); {pic} ({ncalls} calls) {k_ms:.4f} ms "
            f"(CUDA events; device time {dev_txt}) vs plain {p_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({nbytes} bytes) on {smi}")
    log(f"device ms per 1080p I picture: the persistent scan {ms[SCAN][5]} "
        f"(1 launch; {SCAN_FIRST_DESIGN_MS} in its first design); B3 device ms per 1080p P picture {ms[B3][5]} "
        f"({ms[B3][4]} launches) vs {B3_FIRST_DESIGN_MS} in its first "
        f"design; B5 {ms[B5][5]} ({ms[B5][4]} launches) vs "
        f"{B5_FIRST_DESIGN_MS}; B2 {ms[B2][5]} ({ms[B2][4]} launch) vs "
        f"{B2_FIRST_DESIGN_MS}; B8 {ms[B8][5]} ({ms[B8][4]} launch) vs "
        f"B8_FIRST_DESIGN_MS = {B8_FIRST_DESIGN_MS}; B9 {ms[B9][5]} "
        f"({ms[B9][4]} launch) vs B9_FIRST_DESIGN_MS = "
        f"{B9_FIRST_DESIGN_MS}; B4 {ms[B4][5]} ({ms[B4][4]} launch) vs "
        f"B4_FIRST_DESIGN_MS = {B4_FIRST_DESIGN_MS} (2 launches); B1 "
        f"{ms[B1][5]} ({ms[B1][4]} launch) vs B1_FIRST_DESIGN_MS = "
        f"{B1_FIRST_DESIGN_MS}; on {smi}")

    # ---- phase 5: small streams ----
    # 104x72, CTB 64 (the corpus stream conf_window_104x72): two intra
    # block sizes per plane (the multi-bin scan) and a 52x36 chroma plane
    # whose last deblocking edges lie 4 samples from its end
    cdata = make_conf_window_stream(BUILD / "chip_smoke" / "104x72.h265")
    _, cprogs = oracle_programs(cdata)
    pd = lt.PipelinedDecoder()
    reset_counts()
    couts = pd.decode_stream(cdata)
    torch.cuda.synchronize()
    c = read_counts()
    assert_bit_exact(couts, cprogs, "104x72")
    if c[SCAN] == 0:
        raise AssertionError(f"104x72: {c[SCAN]} scan launches")
    log(f"104x72 (CTB 64, intra period 4): {len(cprogs)} frames bit-exact; "
        f"launches {json.dumps(c)}")
    hold_scans("104x72", cprogs, err, ncases)

    bdata, _ = make_stream(BUILD / "chip_smoke" / "416x240_bw.h265", 416, 240,
                           8, 30, {"intra-period": 8, "b-slices": True,
                                   "weighted-pred": True, "num-refs": 2})
    _, bprogs = oracle_programs(bdata)
    n_bi = sum(int((p.pus["pred_flags"] == 3).sum()) for p in bprogs
               if len(p.pus))
    for production in (True, False):
        pd = lt.PipelinedDecoder()
        pd.fd.use_pallas_mc = production
        reset_counts()
        bouts = pd.decode_stream(bdata)
        torch.cuda.synchronize()
        c = read_counts()
        what = "production" if production else "use_pallas_mc=False"
        assert_bit_exact(bouts, bprogs, f"416x240 B/weighted ({what})")
        if (c[B3] > 0) != production:
            raise AssertionError(f"416x240 ({what}): {c[B3]} B3 launches")
        log(f"416x240 B/weighted/2-ref, {what}: {len(bprogs)} frames "
            f"bit-exact ({n_bi} bi-predicted PUs); launches {json.dumps(c)}")

    # cross-component prediction: 4:4:4, intra and inter pictures, packed
    # by numpy (the only packer with the CCP fields)
    for lossless in (True, False):
        what = "lossless" if lossless else "lossy"
        ccp = make_ccp_stream(BUILD / "chip_smoke" / f"ccp444_{what}.h265",
                              lossless)
        _, pprogs = oracle_programs(ccp)
        scaled = [int((p.tus["cross_comp_scale"] != 0).sum())
                  for p in pprogs]
        if not all(scaled[:2]) or not any(len(p.pus) for p in pprogs):
            raise AssertionError(f"CCP {what}: CCP TUs per picture "
                                 f"{scaled}")
        pd = lt.PipelinedDecoder()
        pouts = pd.decode_stream(ccp)
        torch.cuda.synchronize()
        assert_bit_exact(pouts, pprogs, f"CCP 4:4:4 {what}")
        pk = pd.fd.packer
        if not pk.has_ccp or pk.numpy_packs != len(pprogs):
            raise AssertionError(f"CCP {what}: {pk.numpy_packs} numpy packs "
                                 f"of {len(pprogs)}")
        log(f"64x64 4:4:4 CCP ({what}, QP 27): {len(pprogs)} frames "
            f"bit-exact, packed by numpy; CCP TUs per picture {scaled}")
        hold_scans(f"4:4:4 CCP {what}", pprogs, err, ncases)

    # RDPCM, injected: the card against the port's CPU decode
    for what, prog in rdpcm_programs(cprogs[0]):
        got = {}
        for device in ("cuda", "cpu"):
            fd = lt.FusedDecoder(device=device)
            fd.use_pallas_mc = True
            got[device] = [q.cpu().numpy() for q in fd.decode(prog)]
            if not fd.packer.has_rdpcm or fd.packer.numpy_packs != 1:
                raise AssertionError(f"RDPCM {what}: not latched")
        for c, (a, b) in enumerate(zip(got["cuda"], got["cpu"])):
            if not np.array_equal(a, b):
                raise AssertionError(f"RDPCM {what}: plane {c} differs "
                                     f"between the card and the CPU")
        if all(np.array_equal(a, q) for a, q in zip(got["cuda"],
                                                    prog.planes)):
            raise AssertionError(f"RDPCM {what}: the flags changed nothing")
        log(f"RDPCM injected, {what}: the card equals the CPU decode")

    # ---- phase 6: pictures with more than 8 references ----
    run6, err6, ncases6, stripe_pprogs, stripe_progs = many_refs_phase(smi)
    runs.append(run6)
    counts = {n: sum(r[0][n] for r in runs) for n in NAMES}
    for n in NAMES:
        err[n] = max(err[n], err6[n])
        ncases[n] += ncases6[n]
    log(f"launches in the main-path runs (phases 3 and 6): "
        f"{json.dumps(counts)}")

    # ---- phase 7: the multi-device paths ----
    runs += multi_device_phase(smi)
    counts = {n: sum(r[0][n] for r in runs) for n in NAMES}
    log(f"launches in the main-path runs (phases 3, 6 and 7): "
        f"{json.dumps(counts)}")

    # ---- phase 8: DeviceDecoder, programs without the intra plan ----
    runs8, err8, ncases8 = device_decoder_phase(
        smi, parse_only_programs(data), progs, iprogs, stripe_pprogs,
        stripe_progs)
    runs += runs8
    counts = {n: sum(r[0][n] for r in runs) for n in NAMES}
    for n in NAMES:
        err[n] = max(err[n], err8[n])
        ncases[n] += ncases8[n]
    log(f"launches in the main-path runs (phases 3, 6, 7 and 8): "
        f"{json.dumps(counts)}")

    bad = sorted(m for m in sys.modules
                 if m in ("jax", "libde265_tpu") or
                 m.startswith(("jax.", "jaxlib", "libde265_tpu.")))
    if bad:
        raise AssertionError(f"the port imported JAX or libde265_tpu: "
                             f"{bad[:5]}")

    kernels = []
    for n in ROWS:
        src, rep = ALL[n][:2]
        bound_ms, bound_by = _bound(n, ms[n][2], ms[n][3])
        kernels.append({"name": n, "route": "cuda", "source": src,
                        "replaces": rep, "launches": counts[n],
                        "max_abs_err": err[n], "ms": ms[n][0],
                        "ms_device": ms[n][5], "plain_ms": ms[n][1],
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": library[n]})
        if n == SCAN:
            kernels[-1]["chain_bound_ms"] = chain_ms
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
