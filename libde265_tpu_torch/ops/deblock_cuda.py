"""Kernels B8 (luma) and B9 (chroma) deblocking (``csrc/deblock.cu``) and
their plain PyTorch versions.

Replace the TPU kernels ``libde265_tpu/ops/deblock_pallas.py:luma_pass``,
``luma_pass_h``, ``chroma_pass_stacked`` and ``chroma_pass_stacked_h``.
``deblock_luma`` and ``deblock_chroma`` filter every vertical and then every
horizontal edge of a picture's plane (both chroma channels) in one launch,
tile by tile in shared memory, from the plane as it is (a row view will
do) into a fresh output: no padded copy and no clone.  Their plain versions
are the composition that the picture program ran before: the vertical
plane pass of ``ops.deblock`` (pad, pass, unpad), then the horizontal one
(the same on the transpose).  The
per-orientation wrappers keep the TPU kernels' padded layouts and reach
the same two kernels with the other orientation switched off.  Bound by
device memory: one read and one write of each sample, plus the parameters.

``deblock_params`` derives those parameters for a whole picture in one
launch of ``tde_deblock_params`` from the packed per-4x4 grids, the PU
gather's cell grids, the per-CTB slice and tile grids and the slice
records, into one int32 arena that ``deblock_luma`` and ``deblock_chroma``
read as strided views.  Its plain version, ``deblock_params_plain``, is
the PyTorch composition the picture program ran before (the port of the
JAX program's ``_edge_params_jnp``, its slice and tile gate and its chroma
tc).
"""
from __future__ import annotations

import ctypes as ct
import threading

import torch

from . import _build
from ._tensors import check, on_cuda, stream_of
from .deblock import (TC_TABLE, _chroma_pass, _luma_pass, chroma_horizontal,
                      chroma_qp_map, chroma_vertical, edge_params,
                      luma_horizontal, luma_vertical, pad_edge0)

luma_launches = 0    # B8 launches since the last reset (read by chip_smoke)
chroma_launches = 0  # B9 launches since the last reset
param_launches = 0   # tde_deblock_params launches since the last reset
# (rows of a tile: 16 or 32, threads of a CTA: 64, 128 or 256) per kernel,
# from the sweep of scripts/torch_section.py --sweep deblock (PERF.md)
TILE = {"tde_deblock_luma": (32, 128), "tde_deblock_chroma": (16, 256)}


class _Prm(ct.Structure):      # element (segment s, edge j) at p[s*ss + j*se]
    _fields_ = [("p", ct.c_void_p), ("ss", ct.c_longlong),
                ("se", ct.c_longlong)]


class _Edges(ct.Structure):    # edge j < n at column (row) 8j + x0
    _fields_ = [("prm", _Prm * 5), ("n", ct.c_int), ("nseg", ct.c_int),
                ("x0", ct.c_int), ("per_seg", ct.c_int)]


class _Args(ct.Structure):     # csrc/deblock.cu Args
    _fields_ = [("inp", ct.c_void_p * 2), ("in_pitch", ct.c_longlong * 2),
                ("out", ct.c_void_p), ("R", ct.c_int), ("C", ct.c_int),
                ("nch", ct.c_int), ("v", _Edges), ("h", _Edges),
                ("bit_depth", ct.c_int), ("tile_h", ct.c_int),
                ("threads", ct.c_int)]


def _edges(prms, n, x0, per_seg, vertical):
    """One orientation's edges: prms are 2-D views, [segments, edges] for
    vertical edges and [edges, segments] for horizontal ones, any strides;
    n = 0 switches the orientation off."""
    e = _Edges(n=n, x0=x0, per_seg=per_seg)
    if n > 0:
        sa, ea = (0, 1) if vertical else (1, 0)
        e.nseg = prms[0].shape[sa]
        for i, t in enumerate(prms):
            e.prm[i] = _Prm(t.data_ptr(), t.stride(sa), t.stride(ea))
    return e


def _chroma_edges(prm, most, per_seg, vertical):
    """_edges of B9: (tc [2, ., .], no_p, no_q), the two channels' tc read
    in place (no channel views); at most `most` edges."""
    tc, no_p, no_q = prm
    sa, ea = (0, 1) if vertical else (1, 0)
    e = _edges((no_p, no_p, no_p, no_q),
               max(0, min(no_p.shape[ea], most)), 8, per_seg, vertical)
    if e.n > 0:
        for c in range(2):
            e.prm[c] = _Prm(tc.data_ptr() + 4 * c * tc.stride(0),
                            tc.stride(sa + 1), tc.stride(ea + 1))
    return e


def _launch(name, planes, out, v, h, bit_depth):
    a = _Args(v=v, h=h, bit_depth=bit_depth, tile_h=TILE[name][0],
              threads=TILE[name][1])
    for i, p in enumerate(planes):
        a.inp[i] = p.data_ptr()
        a.in_pitch[i] = p.stride(0)
    a.out = out.data_ptr()
    a.R, a.C = planes[0].shape
    a.nch = len(planes)
    rc = getattr(_build.lib(), name)(ct.addressof(a), stream_of(out))
    _build.check_launch(name, rc)


def _check_planes(name, planes, prms):
    """Planes: int32 [R, C] on one card, rows 16-byte aligned, unit column
    stride, C a multiple of 4; parameters int32 2-D on the same card, of
    one shape per group."""
    dev = planes[0].device
    for p in planes:
        if p.device != dev or p.dtype != torch.int32 or p.dim() != 2 or \
                p.shape != planes[0].shape:
            raise ValueError(f"{name}: planes must be int32 [R, C] of one "
                             f"shape on {dev}")
        if p.stride(1) != 1 or p.stride(0) % 4 or p.data_ptr() % 16 or \
                p.shape[1] % 4:
            raise ValueError(f"{name}: a plane needs unit column stride, a "
                             f"16-byte aligned row pitch and C % 4 == 0")
    for group in prms:
        for t in group:
            if t.device != dev or t.dtype != torch.int32 or t.dim() != 2 or \
                    t.shape != group[0].shape:
                raise ValueError(f"{name}: parameters must be int32 2-D "
                                 f"tensors of one shape on {dev}")


# ---------------------------------------------------------------------------
# both orientations of a picture's plane (the picture program's path)
# ---------------------------------------------------------------------------

def deblock_luma_plain(y, prm_v, prm_h, bit_depth: int = 8):
    """Plain version of deblock_luma: luma_vertical, then luma_horizontal
    (the plane padded by 4 samples each side for each pass)."""
    H, W = y.shape
    y = luma_vertical(y, [pad_edge0(p, W // 8) for p in prm_v], bit_depth)
    return luma_horizontal(y, [pad_edge0(p.T, H // 8) for p in prm_h],
                           bit_depth).contiguous()


def deblock_luma(y, prm_v, prm_h, bit_depth: int = 8):
    """Every vertical and then every horizontal edge of a luma plane y
    [H, W]; returns a new contiguous [H, W] plane.

    prm_v: (bs, beta, tc, no_p, no_q), each [H/4, E] (a segment of 4 rows
    per row): column j is the vertical edge at x = 8(j+1).  prm_h: the same
    five, each [E', W/4]: row j is the horizontal edge at y = 8(j+1).
    Edge 0, the picture's border, has no parameter and is not filtered;
    edges past x = 8(W//8 - 1) (y = 8(H//8 - 1)) are not filtered either.
    Any strides (the edge-parameter derivation gives views)."""
    global luma_launches
    if not on_cuda("deblock_luma", y):
        return deblock_luma_plain(y, prm_v, prm_h, bit_depth)
    _check_planes("deblock_luma", [y], [prm_v, prm_h])
    H, W = y.shape
    out = torch.empty((H, W), dtype=torch.int32, device=y.device)
    if out.numel() == 0:
        return out
    v = _edges(prm_v, max(0, min(prm_v[0].shape[1], W // 8 - 1)), 8, 4,
               True)
    h = _edges(prm_h, max(0, min(prm_h[0].shape[0], H // 8 - 1)), 8, 4,
               False)
    _launch("tde_deblock_luma", [y], out, v, h, bit_depth)
    luma_launches += 1
    return out


def deblock_chroma_plain(cb, cr, prm_v, prm_h, bit_depth: int = 8,
                         sub_x: int = 2, sub_y: int = 2):
    """Plain version of deblock_chroma: per channel, chroma_vertical, then
    chroma_horizontal (padded by 2 samples each side for each pass)."""
    Hc, Wc = cb.shape
    ev, eh = (Wc + 7) // 8, (Hc + 7) // 8
    tc, no_p, no_q = prm_v
    no_p, no_q = pad_edge0(no_p, ev), pad_edge0(no_q, ev)
    out = [chroma_vertical(pl, pad_edge0(tc[c], ev), no_p, no_q, bit_depth,
                           4 // sub_y) for c, pl in enumerate((cb, cr))]
    tc, no_p, no_q = prm_h
    no_p, no_q = pad_edge0(no_p.T, eh), pad_edge0(no_q.T, eh)
    return torch.stack([chroma_horizontal(pl, pad_edge0(tc[c].T, eh), no_p,
                                          no_q, bit_depth, 4 // sub_x)
                        for c, pl in enumerate(out)])


def deblock_chroma(cb, cr, prm_v, prm_h, bit_depth: int = 8, sub_x: int = 2,
                   sub_y: int = 2):
    """Every vertical and then every horizontal edge of both chroma planes
    cb, cr [Hc, Wc] (one launch); returns a new contiguous [2, Hc, Wc].

    prm_v: (tc [2, S, E] (0 = off), no_p [S, E], no_q [S, E]), a segment
    of 4 // sub_y chroma rows per row, column j the vertical edge at
    x = 8(j+1); prm_h: (tc [2, E', S'], no_p, no_q [E', S']), a segment of
    4 // sub_x chroma columns per column, row j the horizontal edge at
    y = 8(j+1).  The last edge counted is the one at x = 8((Wc + 7)//8 - 1)
    (y likewise), 4 samples from the end on a plane that is 4 more than a
    multiple of 8.  Any strides."""
    global chroma_launches
    if not on_cuda("deblock_chroma", cb):
        return deblock_chroma_plain(cb, cr, prm_v, prm_h, bit_depth, sub_x,
                                    sub_y)
    tc_v, tc_h = prm_v[0], prm_h[0]
    if tc_v.dim() != 3 or tc_v.shape[0] != 2 or tc_h.dim() != 3 or \
            tc_h.shape[0] != 2 or sub_x not in (1, 2) or sub_y not in (1, 2):
        raise ValueError("deblock_chroma: tc must be [2, ., .] and sub_x, "
                         "sub_y 1 or 2")
    _check_planes("deblock_chroma", [cb, cr], [prm_v[1:], prm_h[1:]])
    if tc_v.shape[1:] != prm_v[1].shape or \
            tc_h.shape[1:] != prm_h[1].shape or \
            tc_v.dtype != torch.int32 or tc_h.dtype != torch.int32 or \
            tc_v.device != cb.device or tc_h.device != cb.device:
        raise ValueError("deblock_chroma: tc must be int32 [2, ...] of the "
                         f"shape of no_p and no_q on {cb.device}")
    Hc, Wc = cb.shape
    out = torch.empty((2, Hc, Wc), dtype=torch.int32, device=cb.device)
    if out.numel() == 0:
        return out
    v = _chroma_edges(prm_v, (Wc + 7) // 8 - 1, 4 // sub_y, True)
    h = _chroma_edges(prm_h, (Hc + 7) // 8 - 1, 4 // sub_x, False)
    _launch("tde_deblock_chroma", [cb, cr], out, v, h, bit_depth)
    chroma_launches += 1
    return out


# ---------------------------------------------------------------------------
# the edge parameters of a picture (tde_deblock_params)
# ---------------------------------------------------------------------------

GRID_KEYS = ("cu4", "nzc4", "dbf4", "qp4")
CELL_KEYS = ("pf", "mv0x", "mv0y", "mv1x", "mv1y", "poc0", "poc1")


class _ParamArgs(ct.Structure):    # csrc/deblock.cu ParamArgs
    _fields_ = [("cu4", ct.c_void_p), ("nzc4", ct.c_void_p),
                ("dbf4", ct.c_void_p), ("qp4", ct.c_void_p),
                ("unfilt", ct.c_void_p), ("pf", ct.c_void_p),
                ("mv", ct.c_void_p * 4), ("poc", ct.c_void_p * 2),
                ("allow_v", ct.c_void_p), ("allow_h", ct.c_void_p),
                ("slice_idx", ct.c_void_p), ("slice_addr", ct.c_void_p),
                ("tile_id", ct.c_void_p), ("recs", ct.c_void_p),
                ("rec_pitch", ct.c_longlong), ("ctb_w", ct.c_int),
                ("cs4", ct.c_int), ("n_slices", ct.c_int),
                ("across_tiles", ct.c_int), ("h4", ct.c_int),
                ("w4", ct.c_int), ("bd", ct.c_int), ("bdc", ct.c_int),
                ("sub_x", ct.c_int), ("sub_y", ct.c_int),
                ("is420", ct.c_int), ("lv", ct.c_void_p),
                ("lh", ct.c_void_p), ("cv", ct.c_void_p),
                ("ch", ct.c_void_p), ("ev", ct.c_int), ("eh", ct.c_int),
                ("ecv", ct.c_int), ("ech", ct.c_int)]


def _param_shapes(h4, w4, st):
    """Edges of the parameter arrays: luma vertical / horizontal (edge 0
    dropped), chroma vertical / horizontal (0 for a mono picture)."""
    ev, eh = max(0, (w4 - 1) // 2), max(0, (h4 - 1) // 2)
    if st["mono"]:
        return ev, eh, 0, 0
    return ev, eh, ev // st["sub_x"], eh // st["sub_y"]


def _arena_views(arena, h4, w4, st):
    """The parameter dict of deblock_params over an int32 arena: luma
    [5, h4, ev] and [5, eh, w4], chroma tc [2, h4, ecv] and [2, ech, w4];
    the chroma no_p / no_q are views of the luma ones (chroma edge k on
    luma edge k * sub + sub - 1)."""
    ev, eh, ecv, ech = _param_shapes(h4, w4, st)
    sizes = (5 * h4 * ev, 5 * eh * w4, 2 * h4 * ecv, 2 * ech * w4)
    lv, lh, cv, ch = arena[:sum(sizes)].split(sizes)
    lv, lh = lv.view(5, h4, ev), lh.view(5, eh, w4)
    prm = {"v": list(lv.unbind(0)), "h": list(lh.unbind(0))}
    if not st["mono"]:
        sx, sy = st["sub_x"], st["sub_y"]
        prm["cv"] = (cv.view(2, h4, ecv), lv[3][:, sx - 1::sx],
                     lv[4][:, sx - 1::sx])
        prm["ch"] = (ch.view(2, ech, w4), lh[3][sy - 1::sy],
                     lh[4][sy - 1::sy])
    return prm


def deblock_params_plain(grids, recs, slice_idx, slice_addr, tile_id, st,
                         allow=None):
    """Plain version of deblock_params: the composition the picture
    program ran before it, on the unpacked grids (the per-4x4 slice
    fields by indexing the per-CTB grids, the slice and tile gate by
    rolled neighbours, ops.deblock's derivation once per orientation, then
    the chroma tc)."""
    sub_x, sub_y = st["sub_x"], st["sub_y"]
    h4, w4 = grids["qp4"].shape
    dev = grids["qp4"].device
    cs4 = st["ctb_size"] // 4
    cy = (torch.arange(h4, device=dev) // cs4)[:, None]
    cx = (torch.arange(w4, device=dev) // cs4)[None, :]
    sidx4 = slice_idx[cy, cx].clamp(0, st["n_slices"] - 1).long()
    disabled4 = recs[sidx4, 1] != 0
    sa4 = slice_addr[cy, cx]
    ti4 = tile_id[cy, cx]
    across4 = recs[sidx4, 9] != 0

    def gate(axis):
        slice_ok = (torch.roll(sa4, 1, dims=axis) == sa4) | across4
        tile_ok = st["across_tiles"] | (torch.roll(ti4, 1, dims=axis) == ti4)
        return (slice_ok & tile_ok & ~disabled4).to(torch.int32)

    allow_v, allow_h = gate(1), gate(0)
    if allow is not None:
        allow_v, allow_h = allow_v * allow[0], allow_h * allow[1]
    dbf = grids["dbf4"]

    def cells(k):
        return grids[k].reshape(h4, w4)

    meta = {"intra": grids["cu4"] & 1, "nzc": grids["nzc4"] & 1,
            "tu_edge_v": ((dbf & 1) != 0).to(torch.int32),
            "tu_edge_h": ((dbf & 2) != 0).to(torch.int32),
            "pu_edge_v": ((dbf & 4) != 0).to(torch.int32),
            "pu_edge_h": ((dbf & 8) != 0).to(torch.int32),
            "qp": grids["qp4"], "pf": cells("pf"),
            "mv": [[cells(f"mv{l}x"), cells(f"mv{l}y")] for l in (0, 1)],
            "rp": [cells(f"poc{l}") for l in (0, 1)],
            "unfilt": grids["unfilt"].to(torch.int32),
            "bit_depth": st["bd"], "beta_off": recs[sidx4, 2],
            "tc_off": recs[sidx4, 3], "cqo0": recs[sidx4, 10],
            "cqo1": recs[sidx4, 11], "allow_v": allow_v, "allow_h": allow_h}
    keys = ("bs", "beta", "tc", "no_p", "no_q")
    pv = edge_params(meta, vertical=True)    # [h4, ev]
    ph = edge_params(meta, vertical=False)   # [eh, w4]
    prm = {"v": [pv[k] for k in keys], "h": [ph[k] for k in keys]}
    if st["mono"]:
        return prm
    is420 = sub_x == 2 and sub_y == 2
    tc_table = torch.as_tensor(TC_TABLE, device=dev)

    def chroma(p, s):
        """(tc [2, ...], no_p, no_q) of the chroma edges, each on luma
        edge column (row) s of p."""
        qpc = chroma_qp_map(p["qp_l"][s][None] +
                            torch.stack([c[s] for c in p["cqo"]]), is420)
        tc = tc_table[(qpc + 2 + p["tco"][s][None]).clamp(0, 53).long()] \
            << (st["bdc"] - 8)
        return (torch.where(p["bs"][s][None] == 2, tc, 0), p["no_p"][s],
                p["no_q"][s])

    # chroma edge k lies on luma edge k * sub (parameter column
    # k * sub - 1 with edge 0 dropped)
    prm["cv"] = chroma(pv, (slice(None), slice(sub_x - 1, None, sub_x)))
    prm["ch"] = chroma(ph, (slice(sub_y - 1, None, sub_y), slice(None)))
    return prm


# (thread, device, stream) -> (shape key, arena, parameter dict): one arena
# per launching thread and stream, so that only stream order separates a
# picture's B8 and B9 reads from the next picture's write
_arenas = {}


def _check_param_inputs(grids, recs, ctb, allow, st, h4, w4):
    """Shapes, dtypes, devices and contiguity of deblock_params' inputs
    (the kernel reads each grid with its row pitch, so all are dense)."""
    dev = grids["qp4"].device
    cells = [grids[k] for k in GRID_KEYS + CELL_KEYS] + list(allow or ())
    check("deblock_params", dev, torch.int32, *cells, *ctb, recs)
    check("deblock_params", dev, torch.bool, grids["unfilt"])
    if grids["qp4"].dim() != 2 or any(
            t.numel() != h4 * w4 for t in cells + [grids["unfilt"]]):
        raise ValueError("deblock_params: every per-4x4 grid must hold "
                         f"{h4} x {w4} cells")
    cs4 = st["ctb_size"] // 4
    if cs4 < 1 or ctb[0].dim() != 2 or \
            any(t.shape != ctb[0].shape for t in ctb) or \
            ctb[0].shape[0] < -(-h4 // cs4) or ctb[0].shape[1] < -(-w4 // cs4):
        raise ValueError("deblock_params: the per-CTB grids must be of one "
                         "shape and cover the per-4x4 grids")
    if recs.dim() != 2 or recs.shape[1] < 12 or \
            not 1 <= st["n_slices"] <= recs.shape[0]:
        raise ValueError("deblock_params: slice records must be "
                         "[>= n_slices, >= 12] with n_slices >= 1")
    if not st["mono"] and (st["sub_x"] not in (1, 2) or
                           st["sub_y"] not in (1, 2)):
        raise ValueError("deblock_params: sub_x, sub_y must be 1 or 2")


def deblock_params(grids, recs, slice_idx, slice_addr, tile_id, st,
                   allow=None):
    """Every deblocking parameter of a picture in one launch.

    grids: per-4x4 int32 grids [h4, w4] cu4 (bit 0 intra), nzc4 (bit 0),
    dbf4 (bits 0-3: TU edge V, H, PU edge V, H), qp4 and the bool unfilt
    (samples the loop filters leave), and the PU gather's int32 cell
    grids pf, mv0x, mv0y, mv1x, mv1y, poc0, poc1 (h4 * w4 cells, any
    shape); recs: int32 slice records [>= n_slices, >= 12]; slice_idx,
    slice_addr, tile_id: int32 per-CTB grids; st: sub_x, sub_y, bd, bdc,
    mono, ctb_size, n_slices, across_tiles; allow: optional int32
    (vertical, horizontal) per-4x4 masks.  Every tensor dense.

    Returns {"v": [bs, beta, tc, no_p, no_q] each [h4, ev], "h": the same
    five each [eh, w4]} (edge j at x or y = 8(j + 1)), and unless mono
    "cv": (tc [2, h4, ecv], no_p, no_q) and "ch": (tc [2, ech, w4], no_p,
    no_q), chroma edge k at 8(k + 1) chroma samples: the layouts
    deblock_luma and deblock_chroma take.  On the card they are views of
    one int32 arena kept for the next call of the same shape on the same
    thread and stream, which overwrites it: stream order puts that call's
    launch after this picture's B8 and B9, and no other thread or stream
    writes it.  A CPU tensor runs the plain version."""
    global param_launches
    if not on_cuda("deblock_params", grids["qp4"]):
        return deblock_params_plain(grids, recs, slice_idx, slice_addr,
                                    tile_id, st, allow)
    h4, w4 = grids["qp4"].shape
    ctb = (slice_idx, slice_addr, tile_id)
    _check_param_inputs(grids, recs, ctb, allow, st, h4, w4)
    dev = grids["qp4"].device
    stream = stream_of(grids["qp4"])
    ev, eh, ecv, ech = _param_shapes(h4, w4, st)
    n = 5 * (h4 * ev + eh * w4) + 2 * (h4 * ecv + ech * w4)
    shape = (h4, w4, ecv, ech, st["sub_x"], st["sub_y"], st["mono"])
    key = (threading.get_ident(), dev, stream)
    kept = _arenas.get(key)
    if kept is None or kept[0] != shape:
        arena = torch.empty(max(n, 1), dtype=torch.int32, device=dev)
        kept = _arenas[key] = (shape, arena, _arena_views(arena, h4, w4, st))
    _, arena, prm = kept
    if h4 * ev + eh * w4 == 0:
        return prm
    a = _ParamArgs(
        cu4=grids["cu4"].data_ptr(), nzc4=grids["nzc4"].data_ptr(),
        dbf4=grids["dbf4"].data_ptr(), qp4=grids["qp4"].data_ptr(),
        unfilt=grids["unfilt"].data_ptr(), pf=grids["pf"].data_ptr(),
        slice_idx=slice_idx.data_ptr(), slice_addr=slice_addr.data_ptr(),
        tile_id=tile_id.data_ptr(), recs=recs.data_ptr(),
        rec_pitch=recs.shape[1], ctb_w=slice_idx.shape[1],
        cs4=st["ctb_size"] // 4, n_slices=st["n_slices"],
        across_tiles=int(bool(st["across_tiles"])), h4=h4, w4=w4,
        bd=st["bd"], bdc=st["bdc"], sub_x=st["sub_x"], sub_y=st["sub_y"],
        is420=int(st["sub_x"] == 2 and st["sub_y"] == 2), ev=ev, eh=eh,
        ecv=ecv, ech=ech)
    for i, k in enumerate(CELL_KEYS[1:5]):
        a.mv[i] = grids[k].data_ptr()
    a.poc[0], a.poc[1] = grids["poc0"].data_ptr(), grids["poc1"].data_ptr()
    if allow is not None:
        a.allow_v, a.allow_h = allow[0].data_ptr(), allow[1].data_ptr()
    base = arena.data_ptr()
    a.lv = base
    a.lh = base + 4 * 5 * h4 * ev
    if not st["mono"]:
        a.cv = a.lh + 4 * 5 * eh * w4
        a.ch = a.cv + 4 * 2 * h4 * ecv
    rc = _build.lib().tde_deblock_params(ct.addressof(a), stream)
    _build.check_launch("tde_deblock_params", rc)
    param_launches += 1
    return prm


# ---------------------------------------------------------------------------
# one orientation in the TPU kernels' padded layouts
# ---------------------------------------------------------------------------

def _luma_cuda(img, bs, beta, tc, no_p, no_q, bit_depth, horizontal):
    global luma_launches
    check("luma_pass", img.device, torch.int32, img, bs, beta, tc, no_p, no_q)
    for t in (beta, tc, no_p, no_q):
        if t.shape != bs.shape:
            raise ValueError("luma_pass: parameter shapes differ")
    if img.dim() != 2 or bs.dim() != 2:
        raise ValueError("luma_pass: img and params must be 2-D")
    _check_planes("luma_pass", [img], [])
    E = bs.shape[0] if horizontal else bs.shape[1]
    groups = img.shape[0] if horizontal else img.shape[1]
    if 8 * E > groups:
        raise ValueError(f"luma_pass: {E} edges need {8 * E} samples, "
                         f"plane has {groups}")
    out = torch.empty_like(img)
    if out.numel() == 0:
        return out
    on = _edges((bs, beta, tc, no_p, no_q), E, 4, 4, not horizontal)
    off = _Edges(x0=4, per_seg=4)
    v, h = (off, on) if horizontal else (on, off)
    _launch("tde_deblock_luma", [img], out, v, h, bit_depth)
    luma_launches += 1
    return out


def luma_pass(img, bs, beta, tc, no_p, no_q, bit_depth: int = 8):
    """Vertical-edge luma pass: img [H, Wp] with the picture at columns
    [4, 4+W); params [H/4, E], edge e at padded column 8e+4."""
    if not on_cuda("luma_pass", img):
        return _luma_pass(img, bs, beta, tc, no_p, no_q, bit_depth)
    return _luma_cuda(img, bs, beta, tc, no_p, no_q, bit_depth, False)


def luma_pass_h(img, bs, beta, tc, no_p, no_q, bit_depth: int = 8):
    """Horizontal-edge luma pass in natural layout: img [Hp, W] with the
    picture at rows [4, 4+H); params [E, W/4], edge e at padded row 8e+4.
    The plain version transposes around the vertical pass."""
    if not on_cuda("luma_pass_h", img):
        return _luma_pass(img.T, bs.T, beta.T, tc.T, no_p.T, no_q.T,
                          bit_depth).T.contiguous()
    return _luma_cuda(img, bs, beta, tc, no_p, no_q, bit_depth, True)


def _chroma_cuda(imgs, tcs, no_p, no_q, bit_depth, per_seg, horizontal):
    global chroma_launches
    check("chroma_pass", imgs.device, torch.int32, imgs, tcs, no_p, no_q)
    if imgs.dim() != 3 or imgs.shape[0] != 2 or tcs.dim() != 3 or \
            tcs.shape[0] != 2 or tcs.shape[1:] != no_p.shape or \
            no_q.shape != no_p.shape:
        raise ValueError("chroma_pass: expected imgs [2, ., .], tcs "
                         "[2, a, b] and no_p/no_q [a, b]")
    if per_seg not in (2, 4):
        raise ValueError(f"chroma_pass: {per_seg} samples per segment, "
                         f"expected 2 or 4")
    planes = [imgs[0], imgs[1]]
    _check_planes("chroma_pass", planes, [])
    E = no_p.shape[0] if horizontal else no_p.shape[1]
    groups = imgs.shape[1] if horizontal else imgs.shape[2]
    if 8 * E > groups:
        raise ValueError(f"chroma_pass: {E} edges need {8 * E} samples, "
                         f"plane has {groups}")
    out = torch.empty_like(imgs)
    if out.numel() == 0:
        return out
    on = _edges((tcs[0], tcs[1], no_p, no_q), E, 2, per_seg, not horizontal)
    off = _Edges(x0=2, per_seg=per_seg)
    v, h = (off, on) if horizontal else (on, off)
    _launch("tde_deblock_chroma", planes, out, v, h, bit_depth)
    chroma_launches += 1
    return out


def chroma_pass_stacked(imgs, tcs, no_p, no_q, bit_depth: int = 8,
                        rows_per_seg: int = 2):
    """Both chroma channels, vertical edges: imgs [2, Hc, Wp] with the
    picture at columns [2, 2+Wc); tcs [2, S, E] (0 = off); no_p/no_q
    [S, E]; one luma segment covers rows_per_seg chroma rows."""
    if not on_cuda("chroma_pass_stacked", imgs):
        return torch.stack([
            _chroma_pass(imgs[c], tcs[c], no_p, no_q, bit_depth, rows_per_seg)
            for c in range(2)])
    return _chroma_cuda(imgs, tcs, no_p, no_q, bit_depth, rows_per_seg, False)


def chroma_pass_stacked_h(imgs, tcs, no_p, no_q, bit_depth: int = 8,
                          cols_per_seg: int = 2):
    """Both chroma channels, horizontal edges, natural layout: imgs
    [2, Hp, Wc] with the picture at rows [2, 2+Hc); tcs [2, E, S];
    no_p/no_q [E, S]; one luma segment covers cols_per_seg chroma columns.
    The plain version transposes around the vertical pass."""
    if not on_cuda("chroma_pass_stacked_h", imgs):
        return torch.stack([
            _chroma_pass(imgs[c].T, tcs[c].T, no_p.T, no_q.T, bit_depth,
                         cols_per_seg).T for c in range(2)])
    return _chroma_cuda(imgs, tcs, no_p, no_q, bit_depth, cols_per_seg, True)
