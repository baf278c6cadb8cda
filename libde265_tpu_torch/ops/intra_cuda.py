"""The intra scan's kernel (``csrc/intra.cu``) and its plain PyTorch
version: the persistent scan ``tde_intra_scan`` (``intra_scan``, one
launch per picture) and ``intra_scan_plain``, the scan as its sequence of
(step, plane, size bin) steps of ``intra_step_plain``.

The persistent scan replaces the TPU program's loop over the steps on
its padded planes (a ``fori_loop`` of B6, the ``_wave_body`` math and B7
in ``libde265_tpu/fused_decode.py``).  A picture's steps
are a chain of dependent steps (528 per plane at 1080p), each of at most
464 small blocks, so a launch per step is bound by launch latency and one
launch per picture by the chain: a step's gather reads what the step
before stored.  One CTA of 1024 threads per plane walks its
plane's steps with one block barrier a step (a block of step i reads only
samples written at steps < i, the scheduler's rule, checked by
``test_schedule_reads_only_earlier_steps``).  The CTA's last warp prepares
the next step off that chain (records copied two steps ahead, compacted
one step ahead); the other warps run every size bin of a step at once,
each block from its residual and border loads to its store within one warp
(four 4x4 blocks, two 8x8, one 16x16 or 32x32 a warp), an angular mode
through the spec's reference array, built once a block from the mode's
angle (no table is read).  The records stay where
``intra_bins`` put them; their pointers, depths and residual rows
go to the kernel in one argument struct by value.  ``intra_step_plain``
is one step of one bin: B6's plain gather, ``ops.intra_wave.
wave_predict``, B7's plain store.

The angular tables passed to the wrappers (``build_mode_tables``) serve the
plain versions.  The records and residual rows must be 16-byte aligned
with K a multiple of 4 and at most ``MAX_SLOTS[lg]``, as ``intra_bins``
makes them (K = WAVE_CAP): the kernel copies the records 16 bytes at a
time and reads the residual a quad at a time.

The scan's records: ``intra_bins`` writes every (plane, size) bin's scan
arrays of a picture from the uploaded wire records (``feed._pack_irec``)
with one memset and one launch of ``tde_intra_bins``
(``csrc/intra_bins.cu``) into one int32 arena a call; its plain version,
``intra_bins_plain``, unpacks the records into 15 columns and scatters
them with three ``index_put_`` a bin (``scatter_records``).
"""
from __future__ import annotations

import ctypes as ct
import functools

import numpy as np
import torch

from . import _build
from . import intra_window as iw
from ._tensors import check, on_cuda, stream_of
from .intra_wave import build_mode_tables, wave_predict

scan_launches = 0  # persistent scan launches since the last reset
bin_launches = 0   # tde_intra_bins launches since the last reset

# csrc/intra.cu max_slots: the most slots of a size bin by lg (WAVE_CAP)
MAX_SLOTS = {2: 256, 3: 128, 4: 64, 5: 16}
PLANE_OF = {"y": 0, "cb": 1, "cr": 2}   # plane class -> plane
AW_WORDS = 5       # availability words of a record (feed.AVAIL_WORDS)


class _ScanBin(ct.Structure):
    _fields_ = [("meta", ct.c_void_p), ("rrow", ct.c_void_p),
                ("aw", ct.c_void_p), ("res", ct.c_void_p), ("K", ct.c_int),
                ("depth", ct.c_int), ("n_res", ct.c_int),
                ("unused", ct.c_int)]


class _ScanPlane(ct.Structure):
    _fields_ = [("plane", ct.c_void_p), ("Hp", ct.c_int), ("Wp", ct.c_int),
                ("bit_depth", ct.c_int), ("nsteps", ct.c_int),
                ("bins", _ScanBin * 4)]


class ScanArgs(ct.Structure):
    """csrc/intra.cu ScanArgs, passed to tde_intra_scan by address and to
    the kernel by value."""
    _fields_ = [("planes", _ScanPlane * 3), ("stamps", ct.c_void_p),
                ("n_planes", ct.c_int), ("pad_t", ct.c_int),
                ("pad_l", ct.c_int), ("aw_words", ct.c_int)]


@functools.lru_cache(maxsize=None)
def mode_tables(s: int, device: torch.device):
    """build_mode_tables(s) as int32 tensors on `device`, made once."""
    return tuple(torch.as_tensor(t, dtype=torch.int32, device=device)
                 for t in build_mode_tables(s))


def _fill_bin(a, c, lg, meta, rrow, aw, res, tabs, depth, dev):
    """Check one (plane, size) bin's records, residual rows and tables and
    put them into a.planes[c].bins[lg - 2] with the given depth."""
    check("intra_scan", dev, torch.int32, meta, rrow, aw, res, *tabs)
    s = 1 << lg
    rows, K = rrow.shape
    if (lg not in (2, 3, 4, 5) or meta.shape != (rows, K, 5) or
            aw.dim() != 3 or aw.shape[:2] != (rows, K) or
            res.dim() != 3 or res.shape[1:] != (s, s) or
            res.shape[0] == 0 or not 0 < K <= MAX_SLOTS.get(lg, 0) or
            K % 4 or aw.shape[2] * 32 < 4 * s + 1 or
            a.aw_words not in (0, aw.shape[2]) or
            any(t.shape != (35, s * s) for t in tabs)):
        raise ValueError(f"intra_scan: bad records, residual or tables of "
                         f"plane {c}, lg {lg}")
    if any(t.data_ptr() % 16 for t in (meta, rrow, aw, res)):
        raise ValueError(f"intra_scan: records and residual must be 16-byte "
                         f"aligned (plane {c}, lg {lg})")
    if depth > rows:
        raise IndexError(f"intra_scan: depth {depth} of {rows} steps (plane "
                         f"{c}, lg {lg})")
    a.aw_words = aw.shape[2]
    B = a.planes[c].bins[lg - 2]
    B.meta, B.rrow, B.aw = meta.data_ptr(), rrow.data_ptr(), aw.data_ptr()
    B.res, B.n_res, B.K, B.depth = res.data_ptr(), res.shape[0], K, depth


def scan_order(bins_by_plane, n_planes: int, nsteps):
    """(step, plane, lg) of the scan in order: step, then plane, then size
    bin ascending; a step at or beyond a bin's depth (a host int) is
    skipped, and no step reaches max(nsteps)."""
    total = int(np.max(nsteps)) if len(nsteps) else 0
    for i in range(total):
        for c in sorted(bins_by_plane):
            if c >= n_planes:
                continue
            for lg in sorted(bins_by_plane[c]):
                if i < bins_by_plane[c][lg]["depth"]:
                    yield i, c, lg


def intra_scan_plain(padded_planes, bins_by_plane, bin_res, tables, nsteps,
                     bit_depths):
    """The whole intra scan of a picture on its padded planes, in place:
    every (step, plane, size bin) of scan_order through intra_step_plain.

    padded_planes: [Hp, Wp] int32 per plane; bins_by_plane: {plane: {lg:
    {"meta" [rows, K, 5], "rrow" [rows, K], "aw" [rows, K, AVAIL_WORDS],
    "depth" host int}}}; bin_res: {lg: [n, s, s]}; tables: {lg: (P0, P1,
    WT)}; nsteps: the per-plane step counts (host); bit_depths: per plane.
    Returns padded_planes."""
    for i, c, lg in scan_order(bins_by_plane, len(padded_planes), nsteps):
        v = bins_by_plane[c][lg]
        intra_step_plain(padded_planes[c], v["meta"], v["rrow"], v["aw"], i,
                         bin_res[lg], *tables[lg], s=1 << lg,
                         bit_depth=bit_depths[c])
    return padded_planes


def fill_scan_args(padded_planes, bins_by_plane, bin_res, tables, nsteps,
                   bit_depths):
    """The kernel's arguments for intra_scan's inputs on the card, checked:
    (ScanArgs, whether any bin has a step to run)."""
    dev = padded_planes[0].device
    n_planes = len(padded_planes)
    if n_planes > 3 or len(bit_depths) < n_planes:
        raise ValueError("intra_scan: 1 to 3 planes, a bit depth each")
    total = int(np.max(nsteps)) if len(nsteps) else 0
    a = ScanArgs(n_planes=n_planes, pad_t=iw.PAD_T, pad_l=iw.PAD_L)
    work = False
    for c, plane in enumerate(padded_planes):
        check("intra_scan", dev, torch.int32, plane)
        if plane.dim() != 2:
            raise ValueError("intra_scan: padded planes must be 2-D")
        P = a.planes[c]
        P.plane = plane.data_ptr()
        P.Hp, P.Wp = plane.shape
        P.bit_depth = int(bit_depths[c])
        for lg, v in bins_by_plane.get(c, {}).items():
            depth = min(int(v["depth"]), total)
            if depth <= 0:
                continue
            _fill_bin(a, c, lg, v["meta"], v["rrow"], v["aw"], bin_res[lg],
                      tables[lg], depth, dev)
            P.nsteps = max(P.nsteps, depth)
            work = True
    return a, work


def intra_scan(padded_planes, bins_by_plane, bin_res, tables, nsteps,
               bit_depths):
    """intra_scan_plain's update: the persistent scan kernel (one launch)
    on CUDA tensors, the plain version on CPU tensors; returns
    padded_planes.  No launch when no bin has a step to run."""
    global scan_launches
    if not padded_planes:
        return padded_planes
    if not on_cuda("intra_scan", padded_planes[0]):
        return intra_scan_plain(padded_planes, bins_by_plane, bin_res, tables,
                                nsteps, bit_depths)
    a, work = fill_scan_args(padded_planes, bins_by_plane, bin_res, tables,
                             nsteps, bit_depths)
    if not work:
        return padded_planes
    rc = _build.lib().tde_intra_scan(ct.addressof(a),
                                     stream_of(padded_planes[0]))
    _build.check_launch("tde_intra_scan", rc)
    scan_launches += 1
    return padded_planes


def intra_step_plain(padded, meta_all, rrow_all, aw_all, step: int, res,
                     P0, P1, WT, *, s: int, bit_depth: int):
    """One bin of one super-wave step on the padded plane, in place: B6's
    function, the wave math, B7's function.

    padded: [Hp, Wp] int32; meta_all [steps, K, 5], rrow_all [steps, K],
    aw_all [steps, K, AVAIL_WORDS]: the bin's scan records, of which row
    `step` is used; res: [n, s, s] residual rows of the size bin (rrow -1:
    none); P0/P1/WT: build_mode_tables(s) as tensors.  Returns padded."""
    meta, rrow, aw = meta_all[step], rrow_all[step], aw_all[step]
    resid = torch.where((rrow >= 0)[:, None, None],
                        res[rrow.long().clamp(0, res.shape[0] - 1)], 0)
    y0p = meta[:, 2] + iw.PAD_T
    x0p = meta[:, 3] + iw.PAD_L
    tops, lefts = iw.border_gather_plain(padded, y0p, x0p, meta.shape[0], s=s)
    out = wave_predict(torch.cat([lefts.flip(1), tops], 1), meta, aw, resid,
                       P0, P1, WT, s, bit_depth)
    return iw.window_scatter_plain(padded, out, y0p, x0p,
                                   (meta[:, 4] & 8) != 0, s=s)


# ---------------------------------------------------------------------------
# the scan's records of a picture (tde_intra_bins)
# ---------------------------------------------------------------------------

def unpack_records(p):
    """Inverse of feed._pack_irec: [8, cap] -> [cap, 15] int32 (numpy array
    or tensor in, same kind out)."""
    w0, w1, w2 = p[0], p[1], p[2]
    cols = [w0 & 63, (w0 >> 6) & 15, w1 & 0xFFFF, (w1 >> 16) & 0xFFFF,
            (w0 >> 10) & 15, (w2 & 0x3FFFFF) - 1, (w0 >> 19) & 0x1FFF,
            (w2 >> 22) & 0x3FF, (w0 >> 14) & 3, (w0 >> 16) & 7,
            p[3], p[4], p[5], p[6], p[7]]
    if isinstance(p, np.ndarray):
        return np.stack(cols, axis=1)
    return torch.stack(cols, dim=1)


def scatter_records(irec, bins, scap: int, depths):
    """The flat intra records [n, 15] (feed.IREC_COLS) scattered into the
    scan arrays of each (plane class, lg) bin of `bins`: {plane: {lg:
    {"meta" [scap, K, 5], "rrow" [scap, K], "aw" [scap, K, AW_WORDS],
    "depth" depths[plane, lg]}}}, K = MAX_SLOTS[lg].  A record goes to
    (step, slot) of its bin; records of other bins, with step >= scap or
    with a slot outside [0, K) are dropped; unused slots hold 0 (meta, aw)
    and -1 (rrow)."""
    out = {}
    dev = irec.device
    step, slot = irec[:, 6].long(), irec[:, 7].long()
    for (pc, lg) in bins:
        c = PLANE_OF[pc]
        K = MAX_SLOTS[lg]
        ok = (irec[:, 8] == c) & (irec[:, 9] == lg) & (step < scap) & \
            (slot >= 0) & (slot < K)
        # rows of other bins go to a scratch step row scap
        idx = (torch.where(ok, step, scap), slot.clamp(0, K - 1))
        meta = torch.zeros((scap + 1, K, 5), dtype=torch.int32, device=dev)
        meta.index_put_(idx, irec[:, 0:5])
        rrow = torch.full((scap + 1, K), -1, dtype=torch.int32, device=dev)
        rrow.index_put_(idx, irec[:, 5])
        aw = torch.zeros((scap + 1, K, AW_WORDS), dtype=torch.int32,
                         device=dev)
        aw.index_put_(idx, irec[:, 10:10 + AW_WORDS])
        out.setdefault(c, {})[lg] = {"meta": meta[:scap], "rrow": rrow[:scap],
                                     "aw": aw[:scap],
                                     "depth": int(depths[c, lg])}
    return out


def intra_bins_plain(irecp, bins, scap: int, depths, n=None):
    """Plain version of intra_bins: the first n wire records (all of them
    when n is None) unpacked, then scatter_records."""
    n = irecp.shape[1] if n is None else n
    return scatter_records(unpack_records(irecp[:, :n]), bins, scap, depths)


class _BinArgs(ct.Structure):
    """csrc/intra_bins.cu BinArgs, passed by address to tde_intra_bins and
    by value to the kernel."""
    _fields_ = [("rec", ct.c_void_p), ("pitch", ct.c_longlong),
                ("n", ct.c_int), ("scap", ct.c_int), ("arena", ct.c_void_p),
                ("arena_words", ct.c_longlong), ("rrow_at", ct.c_longlong),
                ("rrow_words", ct.c_longlong), ("meta", ct.c_longlong * 12),
                ("rrow", ct.c_longlong * 12), ("aw", ct.c_longlong * 12),
                ("K", ct.c_int * 12), ("aw_words", ct.c_int)]


@functools.lru_cache(maxsize=None)
def _bin_layout(bins, scap: int):
    """The arena of (bins, scap): per bin its meta and aw arrays, then
    every bin's rrow array in one run (each a multiple of 16 bytes, K % 4
    == 0).  Returns the kernel's arguments with the offsets set (bytes),
    the arena's words, the parts' sizes in order, and per bin (plane, lg,
    the shapes of its meta, rrow and aw, their indices among the parts)."""
    if scap < 1 or len(set(bins)) != len(bins) or any(
            pc not in PLANE_OF or lg not in MAX_SLOTS for pc, lg in bins):
        raise ValueError(f"intra_bins: bad bins {bins} or steps {scap}")
    a = _BinArgs(scap=scap, aw_words=AW_WORDS)
    at, sizes, layout = 0, [], []
    for j, (pc, lg) in enumerate(bins):
        b, K = 4 * PLANE_OF[pc] + lg - 2, MAX_SLOTS[lg]
        a.K[b], a.meta[b], a.aw[b] = K, at, at + scap * K * 5
        at += scap * K * (5 + AW_WORDS)
        sizes += [scap * K * 5, scap * K * AW_WORDS]
        layout.append((PLANE_OF[pc], lg,
                       ((scap, K, 5), (scap, K), (scap, K, AW_WORDS)),
                       (2 * j, 2 * len(bins) + j, 2 * j + 1)))
    a.rrow_at = at
    for pc, lg in bins:
        a.rrow[4 * PLANE_OF[pc] + lg - 2] = at
        at += scap * MAX_SLOTS[lg]
        sizes.append(scap * MAX_SLOTS[lg])
    a.rrow_words, a.arena_words = at - a.rrow_at, at
    return bytes(a), at, sizes, layout


def intra_bins(irecp, bins, scap: int, depths, n=None):
    """The scan arrays of every (plane class, lg) bin of `bins` from the
    first n (default: all) wire records irecp [8, >= n] int32 (feed.
    _pack_irec), as scatter_records gives them from the unpacked records:
    {plane: {lg: {"meta" [scap, K, 5], "rrow" [scap, K], "aw" [scap, K,
    AW_WORDS], "depth" depths[plane, lg]}}}.  depths: host ints by [plane,
    lg] (feed.record_depths).

    On the card: the arrays are views of one int32 arena, allocated by the
    call (so it lives as long as the caller holds them, as the plain
    version's arrays do), set by one memset and one tde_intra_bins launch.
    A CPU tensor runs the plain version."""
    global bin_launches
    n = irecp.shape[1] if n is None else int(n)
    if not on_cuda("intra_bins", irecp):
        return intra_bins_plain(irecp, bins, scap, depths, n)
    dev = irecp.device
    check("intra_bins", dev, torch.int32, irecp)
    if irecp.dim() != 2 or irecp.shape[0] != 8 or \
            not 0 <= n <= irecp.shape[1]:
        raise ValueError(f"intra_bins: records must be [8, >= n] int32, got "
                         f"{tuple(irecp.shape)} with n = {n}")
    args, words, sizes, layout = _bin_layout(tuple(bins), int(scap))
    arena = torch.empty(max(words, 1), dtype=torch.int32, device=dev)
    a = _BinArgs.from_buffer_copy(args)
    a.arena, a.rec, a.pitch, a.n = (arena.data_ptr(), irecp.data_ptr(),
                                    irecp.shape[1], n)
    rc = _build.lib().tde_intra_bins(ct.addressof(a), stream_of(irecp))
    _build.check_launch("tde_intra_bins", rc)
    bin_launches += 1
    parts = arena[:words].split(sizes) if sizes else ()
    out = {}
    for c, lg, (ms, rs, ws), (i, j, k) in layout:
        out.setdefault(c, {})[lg] = {
            "meta": parts[i].view(ms), "rrow": parts[j].view(rs),
            "aw": parts[k].view(ws), "depth": int(depths[c, lg])}
    return out
