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
          launch per picture with intra blocks, no fused-step launch;
     then synced per-picture milliseconds and launches (I and P), the
     synced feed pack and intra scan of single pictures, and one
     all-intra picture under torch.profiler (device busy and idle share,
     the intra kernels by name);
  4. kernels vs plain: each kernel against its plain PyTorch version on
     the card, on seeded random inputs at the 1080p shapes and on the
     inputs captured from the first I and P picture (the intra kernels on
     the first I picture's whole scan); exact equality; CUDA-event times of
     both, each kernel's device time (torch.profiler) and bound; B5 timed
     on the I picture's calls as well (bins with no segment), and B5's and
     B2's calls checked to run no device work besides their kernel.  The
     persistent scan also on synthetic pictures whose steps share all four
     luma sizes.  The separate B6 and B7 kernels and the fused step (the
     scan's body, one launch per step and size bin) are held here only:
     the decode runs B6's gather and B7's store inside the persistent
     scan;
  5. small streams, bit-exact on the card: 104x72 with CTB 64 (two intra
     sizes per plane, a chroma plane that is not a multiple of 8 wide or
     high) and a 416x240 B/weighted/2-ref stream under both formulations.

The last three lines of stdout are the kernels JSON object (all twelve
rows: B1-B10, the fused step and the persistent scan), the card's
nvidia-smi line and the result line {"ok": true, "device": {...}}.
Nothing here imports JAX or the JAX package libde265_tpu.
"""
from __future__ import annotations

import importlib
import json
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
B4, B5 = "B4 densify_bin", "B5 residual_stripes"
B6, B7 = "B6 border_gather", "B7 window_scatter"
B8, B9 = "B8 luma_pass (V+H)", "B9 chroma_pass_stacked (V+H)"
B10 = "B10 sao_plane_fused"
STEP = "B6+B7 intra_step (fused)"
SCAN = "B6+B7 intra_scan (persistent)"

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
         "libde265_tpu/ops/deblock_pallas.py:212", "deblock_cuda",
         "luma_launches", 30),
    B9: ("libde265_tpu_torch/csrc/deblock.cu",
         "libde265_tpu/ops/deblock_pallas.py:263", "deblock_cuda",
         "chroma_launches", 20),
    B10: ("libde265_tpu_torch/csrc/sao.cu",
          "libde265_tpu/ops/sao_pallas.py:120", "sao_cuda", "launches", 25),
    SCAN: ("libde265_tpu_torch/csrc/intra.cu",
           "libde265_tpu/ops/intra_window_pallas.py:133,252",
           "intra_cuda", "scan_launches", 60),
}
# The separate B6 and B7 kernels and the fused step (the scan's body, one
# launch per step and size bin): the decode runs B6's gather and B7's store
# inside the persistent scan, one launch per picture, so these three are
# held against their plain versions in phase 4 only, on the first I
# picture's step sequence (no main-path launch check; their rows show 0
# launches).
HELD = {
    B6: ("libde265_tpu_torch/csrc/intra.cu",
         "libde265_tpu/ops/intra_window_pallas.py:133",
         "intra_window", "gather_launches", 8),
    B7: ("libde265_tpu_torch/csrc/intra.cu",
         "libde265_tpu/ops/intra_window_pallas.py:252",
         "intra_window", "scatter_launches", 6),
    STEP: ("libde265_tpu_torch/csrc/intra.cu",
           "libde265_tpu/ops/intra_window_pallas.py:133,252",
           "intra_cuda", "launches", 60),
}
ALL = {**KERNELS, **HELD}
NAMES = list(ALL)
ROWS = [B1, B2, B3, B4, B5, B6, B7, B8, B9, B10, STEP, SCAN]  # kernels line
INTRA = (SCAN, STEP, B6, B7)

# wrapper (module, function) -> family
WRAPPERS = {("expand", "expand_blocks"): B1,
            ("mc_seg", "paint_pu_idx"): B2,
            ("mc_seg", "mc_stripes"): B3,
            ("coef_cuda", "densify_bin"): B4,
            ("mc_seg", "residual_stripes"): B5,
            ("deblock_cuda", "luma_pass"): B8,
            ("deblock_cuda", "luma_pass_h"): B8,
            ("deblock_cuda", "chroma_pass_stacked"): B9,
            ("deblock_cuda", "chroma_pass_stacked_h"): B9,
            ("sao_cuda", "sao_plane_fused"): B10,
            ("intra_cuda", "intra_scan"): SCAN,
            ("intra_cuda", "intra_step"): STEP,
            ("intra_window", "border_gather"): B6,
            ("intra_window", "window_scatter"): B7}
FAMILY = {fn: fam for (_, fn), fam in WRAPPERS.items()}
MODULE = {fn: m for (m, fn) in WRAPPERS}
INPLACE = ("window_scatter", "intra_step")   # update their first argument
# Device ms of the earlier designs (PERF.md, NVIDIA H100 80GB HBM3, 700.00
# W), printed beside this run's: B3, B5 and B2 per 1080p P picture in their
# first designs (B3 and B5: one CTA per segment slot of a watermark x bands
# grid, B5 over a zero-filled output; B2: one thread per band and column,
# each walking every segment of its band), and the fused intra step per
# 1080p I picture when it ran the main path (1584 launches)
B3_FIRST_DESIGN_MS = 0.2100
B5_FIRST_DESIGN_MS = 0.0737
B2_FIRST_DESIGN_MS = 0.0191
FUSED_STEP_MAIN_PATH_MS = 7.9225


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


def make_stream(path: Path, w, h, frames, qp, params):
    """Encode (or reuse) a stream under build/; returns (bytes, seconds)."""
    if path.exists():
        return path.read_bytes(), 0.0
    from libde265_tpu_torch import Encoder
    rng = np.random.default_rng(42)
    base = rng.integers(0, 40, (h, w), np.int16)
    yy, xx = np.mgrid[0:h, 0:w]
    t0 = time.perf_counter()
    with Encoder(qp=qp) as enc:
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


def synthetic_scan_inputs(seed, dev, H=128, W=128, bit_depth=8):
    """synthetic_intra's scan as intra_scan's arguments on `dev`: (padded
    planes, bins_by_plane, bin_res, tables, nsteps, bit depths)."""
    import torch
    from libde265_tpu_torch import fused_decode as fdm
    from libde265_tpu_torch.ops import intra_cuda
    from libde265_tpu_torch.ops import intra_window as iw
    planes, irec, nsteps, res = synthetic_intra(seed, H, W, bit_depth)
    bins = tuple(sorted({(("y", "cb", "cr")[int(c)], int(lg))
                         for c, lg in irec[:, 8:10]}))
    scap = int(irec[:, 6].max()) + 1
    by_plane = fdm._scatter_intra_bins(torch.from_numpy(irec).to(dev), irec,
                                       bins, scap)
    padded = [iw.pad_plane_for_scan(torch.from_numpy(p).to(dev),
                                    *iw.scan_pad_sizes(*p.shape))
              for p in planes]
    bin_res = {lg: torch.from_numpy(r).to(dev) for lg, r in res.items()}
    tables = {lg: intra_cuda.mode_tables(1 << lg, torch.device(dev))
              for lg in (2, 3, 4, 5)}
    return padded, by_plane, bin_res, tables, nsteps, [bit_depth] * 3


def oracle_programs(data):
    """Programs with the scalar decoder's planes (the bit-exact oracle)."""
    from libde265_tpu_torch import Decoder
    dec = Decoder(keep_programs=True)
    list(dec.decode_all(data))
    return dec, [dec.get_program(i) for i in range(dec.num_programs())]


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


def main_path_run(what, data, progs):
    """One main-path run: counts set to 0, PipelinedDecoder() over the
    stream, synchronised, counts read; every frame held bit-exact."""
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
    log(f"{what}: {len(progs)} frames bit-exact; e2e {len(progs) / dt:.4f} "
        f"fps ({1000 * dt / len(progs):.1f} ms/frame); launches "
        f"{json.dumps(counts)}")
    return counts, dt


def per_picture(progs):
    """Synced ms, launch counts, intra flag and upload bytes of each picture
    (FusedDecoder()), and the bytes of the DPB ring."""
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
                     len(p.pus) == 0, fd.last_wire_bytes))
    ring = sum(t.numel() * t.element_size() for t in fd._stack)
    return rows, ring


def section_ms(progs, idx):
    """Synced ms of one picture's host feed pack, feed upload (with B1),
    motion compensation, intra scan and whole decode (the pictures before
    it decoded first, untimed)."""
    import torch
    import libde265_tpu_torch as lt
    fdm, feed = lt.fused_decode, lt.feed
    spent = {"pack": 0.0, "intra scan": 0.0}

    def timed(key, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[key] += 1000 * (time.perf_counter() - t0)
            return out
        return run

    fd = lt.FusedDecoder()
    fd.plan_stream(progs)
    for p in progs[:idx]:
        fd.decode(p)
    spent["upload"] = spent["mc"] = 0.0
    scan, pack = fdm._intra_scan_all, feed.FeedPacker.pack
    upload, mc = fdm.FusedDecoder._sparse_upload, fdm._mc_section
    fdm._intra_scan_all = timed("intra scan", scan)
    feed.FeedPacker.pack = timed("pack", pack)
    fdm.FusedDecoder._sparse_upload = timed("upload", upload)
    fdm._mc_section = timed("mc", mc)
    try:
        t0 = time.perf_counter()
        fd.decode(progs[idx])
        torch.cuda.synchronize()
        spent["picture"] = 1000 * (time.perf_counter() - t0)
    finally:
        fdm._intra_scan_all, feed.FeedPacker.pack = scan, pack
        fdm.FusedDecoder._sparse_upload, fdm._mc_section = upload, mc
    return spent


def profile_picture(progs, idx):
    """torch.profiler over one picture (the ones before it decoded first,
    untraced): wall ms, device busy ms (the sum of kernel self times, one
    stream), and the device ms per kernel name containing "intra"."""
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
    intra = {e.key: (_device_us(e) / 1000, e.count) for e in ka
             if "intra" in e.key and _device_us(e) > 0}
    return wall, busy, intra


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


def _add(a, b):
    return None if a is None or b is None else a + b


class IntraTrace:
    """A picture's intra scan (the arguments of intra_cuda.intra_scan): the
    padded planes before it (`initial`) and after it (`final`), keyed by
    plane; the scan's other arguments (`scan`); and the same scan as the
    fused step's calls in scan order (`calls`: (plane, args, kwargs))."""

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


def capture_inputs(fd, progs):
    """Decode progs with every kernel wrapper recording its arguments;
    returns per picture {wrapper name: [(args, kwargs), ...]}, the intra
    scan as an IntraTrace under "intra_scan".  Arguments are cloned, but
    not the padded planes of the intra scan (the trace keeps them)."""
    import torch
    saved = {}
    per_frame = []

    def wrap(name, fn):
        def rec(*args, **kwargs):
            if name == "intra_scan":
                per_frame[-1][name] = IntraTrace(*args, **kwargs)
            else:
                cl = [a.clone() if isinstance(a, torch.Tensor) else a
                      for a in args]
                kw = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                      for k, v in kwargs.items()}
                per_frame[-1].setdefault(name, []).append((cl, kw))
            return fn(*args, **kwargs)
        return rec

    for m, name in WRAPPERS:
        mod = ops_module(m)
        saved[(m, name)] = getattr(mod, name)
        setattr(mod, name, wrap(name, saved[(m, name)]))
    try:
        for prog in progs:
            per_frame.append({})
            fd.decode(prog)
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
    meta [K, 5], aw [K, 5], resid [K, s, s] (numpy).  As in a real step, no
    available border sample lies in a block of the same step, nor outside
    the picture."""
    nb, n2 = 4 * s + 1, 2 * s
    gw, gh = W // s, H // s
    cells = rng.permutation(gw * gh)[:K]
    ys, xs = (cells // gw) * s, (cells % gw) * s
    invalid = rng.random(K) < 0.25
    occ = np.zeros((gh, gw), bool)
    occ[ys[~invalid] // s, xs[~invalid] // s] = True
    meta = np.zeros((K, 5), np.int64)
    meta[:, 0] = rng.integers(0, 35, K)
    meta[:, 1] = rng.integers(0, 4, K) if s < 32 else 0
    meta[:, 2], meta[:, 3] = ys, xs
    meta[:, 4] = ((rng.random(K) < 0.1) * 1 | (rng.random(K) < 0.6) * 2 |
                  (rng.random(K) < 0.5) * 4 | 8)
    j = np.arange(nb)
    by = np.where(j < n2, ys[:, None] + n2 - 1 - j, ys[:, None] - 1)
    bx = np.where(j <= n2, xs[:, None] - 1, xs[:, None] + j - n2 - 1)
    inside = (by >= 0) & (by < H) & (bx >= 0) & (bx < W)
    busy = occ[np.clip(by, 0, H - 1) // s, np.clip(bx, 0, W - 1) // s]
    av = ((rng.random((K, nb)) < 0.8) | (rng.random((K, 1)) < 0.4)) & \
        inside & ~busy
    aw = np.packbits(np.pad(av, ((0, 0), (0, 160 - nb))), axis=1,
                     bitorder="little").view(np.int32).astype(np.int64)
    meta[invalid] = 0
    aw[invalid] = 0
    sc = 1 << (bd - 8)
    resid = rng.integers(-40 * sc, 41 * sc, (K, s, s))
    return meta, aw, resid


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


def random_cases(dev, H=1088, W=1920):
    """Seeded random inputs at the 1080p main-path shapes:
    {wrapper name: [(args, kwargs), ...]}."""
    import torch
    from libde265_tpu_torch.feed import WAVE_CAP
    from libde265_tpu_torch.ops import intra_window as iw
    from libde265_tpu_torch.ops.intra_wave import build_mode_tables
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
    for S, N in ((4, 4096), (8, 2048), (16, 512), (32, 128)):
        cv, coff = _csr_bin(rng, N, S)
        cases["densify_bin"].append(((t(cv), t(coff)), {"N": N, "S": S}))

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
        tabs = tuple(t(a) for a in build_mode_tables(s))
        for ibd in (8, 10):
            sc = 1 << (ibd - 8)
            plane = ((60 + yy // 2 + xx // 3) * sc +
                     rng.integers(0, 3 * sc, (H, W))) % (1 << ibd)
            padded = iw.pad_plane_for_scan(t(plane, np.int32), hp, wp)
            meta, aw, resid = _intra_records(rng, s, K, H, W, ibd)
            y0p = t(meta[:, 2] + iw.PAD_T, np.int32)
            x0p = t(meta[:, 3] + iw.PAD_L, np.int32)
            valid = t((meta[:, 4] & 8) != 0)
            rrow = np.arange(K)[::-1].copy()
            rrow[rng.random(K) < 0.2] = -1
            step_args = (t(np.stack([np.zeros_like(meta), meta]), np.int32),
                         t(np.stack([np.full(K, -1), rrow]), np.int32),
                         t(np.stack([np.zeros_like(aw), aw]), np.int32), 1,
                         t(resid, np.int32), *tabs)
            cases["intra_step"].append(((padded, *step_args),
                                        {"s": s, "bit_depth": ibd}))
            nvalid = int(rng.integers(K // 2, K + 1))
            cases["border_gather"].append(((padded, y0p, x0p, nvalid),
                                           {"s": s}))
            cases["window_scatter"].append(
                ((padded, t(resid + 500, np.int32), y0p, x0p, valid),
                 {"s": s}))
    # the persistent scan: synthetic pictures whose steps share all four
    # luma sizes (no 1080p stream has more than one size per plane)
    for seed, ibd in ((0, 8), (1, 10)):
        cases["intra_scan"].append((synthetic_scan_inputs(seed, dev,
                                                          bit_depth=ibd), {}))
    return cases


def plain_of(name):
    """The plain PyTorch version of a wrapper (run on the same device)."""
    import torch
    from libde265_tpu_torch.ops import coef_cuda, expand, intra_cuda, mc_seg
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
    if name == "intra_step":
        return intra_cuda.intra_step_plain
    if name == "intra_scan":
        return intra_cuda.intra_scan_plain
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
    residual rows its segments place."""
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
    pair), the call's device ms (torch.profiler: the kernel and the copy of
    the plane that a deblock wrapper returns) and the bound of the same
    work (each input read once, each output written once)."""
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
            t_dev = device_ms(lambda: _call(k, name, args, kw))
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
    """The first I picture's intra work, four ways, each against its
    plain version and against the decode's own planes:
      * the persistent scan: the picture's scan, one launch, from the
        planes before it;
      * the fused step: the same scan as its step sequence (step, plane,
        size bin), one launch each, from the planes before it;
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
        STEP: (lambda: replay(kernel_of("intra_step")),
               lambda: replay(plain_of("intra_step")), "intra_step_kernel"),
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
                   device_ms(kern, kname)]

    # bytes each function must move on this picture's data.  A (step, bin)
    # of the scan or the fused step reads every slot's meta, the valid
    # slots' residual row index and availability words, their residual
    # blocks and border samples, and stores their blocks; the fused step
    # reads the packed angular rows of its modes in every call, the scan
    # each (size, mode) row of the picture once.
    aw_words = trace.calls[0][1][2].shape[2]
    rows = set()
    for (key, s, meta, hm, hr) in views:
        K, nb, ss = meta.shape[0], 4 * s + 1, s * s
        valid = (hm[:, 4] & 8) != 0
        nv = int(valid.sum())
        nres = int((valid & (hr >= 0)).sum())
        modes = set(hm[valid & (hm[:, 0] >= 2), 0].tolist())
        rows |= {(s, m) for m in modes}
        ms[B6][2] += 4 * (2 * K + 2 * K * nb)
        ms[B6][3] += K * nb
        ms[B7][2] += 4 * (2 * K + 2 * nv * ss) + K
        ms[B7][3] += nv * ss
        step = 4 * (5 * K + nv * (1 + aw_words + nb + ss) + nres * ss)
        ms[STEP][2] += step + 4 * len(modes) * ss
        ms[SCAN][2] += step
        ms[STEP][3] += nv * ss
        ms[SCAN][3] += nv * ss
    ms[SCAN][2] += sum(4 * s * s for s, _ in rows)


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main():
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
                                   "expand", "registers")):
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
    if counts[STEP] or not n_i <= counts[SCAN] <= n_pics:
        raise AssertionError(f"intra launches: {counts[SCAN]} scans, "
                             f"{counts[STEP]} fused steps over {n_pics} "
                             f"pictures ({n_i} I)")
    log(f"intra scan launches {counts[SCAN]} over {n_pics} pictures ({n_i} "
        f"I, the rest P with or without intra blocks); fused step launches "
        f"{counts[STEP]}")

    # per-picture synced times, launches and upload bytes (I/P split)
    for what, pp in (("P-GOP", progs), ("all-intra", iprogs)):
        rows, ring = per_picture(pp)
        for ms_, c, intra, _ in rows:
            if c[SCAN] > 1 or (intra and c[SCAN] != 1) or c[STEP]:
                raise AssertionError(f"{what}: {c[SCAN]} scan and {c[STEP]} "
                                     f"fused step launches in a picture")
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
                          ("P-GOP P", progs, first_p),
                          ("all-intra", iprogs, 1)):
        spent = {k: round(v, 2) for k, v in section_ms(pp, idx).items()}
        log(f"sections of {what} picture {idx} (synced ms): "
            f"{json.dumps(spent)} on {smi}")
    for what, pp, idx in (("all-intra", iprogs, 1),
                          ("P-GOP P", progs, first_p)):
        wall, busy, intra = profile_picture(pp, idx)
        if busy > 0:
            log(f"profiled {what} picture {idx}: wall {wall:.2f} ms, device "
                f"busy {busy:.2f} ms, idle share {1 - busy / wall:.3f}; "
                f"intra kernels (device ms, launches) {json.dumps(intra)} "
                f"on {smi}")
        else:
            log(f"profiled {what} picture {idx}: the profiler saw no device "
                "time; idle share not measured")

    # ---- phase 4: kernels vs plain on the card ----
    fd = lt.FusedDecoder(device=dev)
    fd.plan_stream(progs)
    caps = capture_inputs(fd, progs[:first_p + 1])
    del fd
    rand = random_cases(dev)
    err, ncases = compare_kernels(
        [("random", rand),
         (f"frame {first_i} (I)", caps[first_i]),
         (f"frame {first_p} (P)", caps[first_p])])
    # times on the P picture's calls; a wrapper that the P picture did not
    # call is timed on the I picture's calls, else on its random cases
    timed = {**{k: v for k, v in rand.items() if FAMILY[k] not in INTRA},
             **caps[first_i], **caps[first_p]}
    pic_of = {FAMILY[k]: ("P" if k in caps[first_p] else
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
    # B5 and B2 allocate their outputs unfilled: the kernel must be the
    # only device work of a call
    for name, mark in (("residual_stripes", "residual_kernel"),
                       ("paint_pu_idx", "paint_kernel")):
        args, kw = caps[first_p][name][0]
        seen = device_kernels(lambda: _call(kernel_of(name), name, args, kw))
        if not seen:
            log(f"{name}: the profiler saw no device time; its device "
                f"work not checked")
        elif any(mark not in k for k in seen):
            raise AssertionError(f"{name}: device work besides its kernel: "
                                 f"{json.dumps(seen)}")
        else:
            log(f"{name}: device work of one call {json.dumps(seen)}")
    compare_intra_trace(caps[first_i]["intra_scan"], err, ncases, ms)
    log(f"intra scan of 1080p I picture {first_i}: "
        f"{json.dumps(scan_shape(caps[first_i]['intra_scan']))}")
    del caps, timed, rand
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
        f"(1 launch) vs the fused step {ms[STEP][5]} in this run "
        f"({ms[STEP][4]} launches; {FUSED_STEP_MAIN_PATH_MS} when it ran the "
        f"main path); B3 device ms per 1080p P picture {ms[B3][5]} "
        f"({ms[B3][4]} launches) vs {B3_FIRST_DESIGN_MS} in its first "
        f"design; B5 {ms[B5][5]} ({ms[B5][4]} launches) vs "
        f"{B5_FIRST_DESIGN_MS}; B2 {ms[B2][5]} ({ms[B2][4]} launch) vs "
        f"{B2_FIRST_DESIGN_MS}; on {smi}")

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
    if c[SCAN] == 0 or c[STEP]:
        raise AssertionError(f"104x72: {c[SCAN]} scan, {c[STEP]} fused step "
                             f"launches")
    log(f"104x72 (CTB 64, intra period 4): {len(cprogs)} frames bit-exact; "
        f"launches {json.dumps(c)}")

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
                        "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
