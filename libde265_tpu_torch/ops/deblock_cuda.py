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
"""
from __future__ import annotations

import ctypes as ct

import torch

from . import _build
from ._tensors import check, on_cuda, stream_of
from .deblock import (_chroma_pass, _luma_pass, chroma_horizontal,
                      chroma_vertical, luma_horizontal, luma_vertical,
                      pad_edge0)

luma_launches = 0    # B8 launches since the last reset (read by chip_smoke)
chroma_launches = 0  # B9 launches since the last reset
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
    pv = (tc_v[0], tc_v[1], *prm_v[1:])
    ph = (tc_h[0], tc_h[1], *prm_h[1:])
    _check_planes("deblock_chroma", [cb, cr], [pv, ph])
    Hc, Wc = cb.shape
    out = torch.empty((2, Hc, Wc), dtype=torch.int32, device=cb.device)
    if out.numel() == 0:
        return out
    v = _edges(pv, max(0, min(pv[0].shape[1], (Wc + 7) // 8 - 1)), 8,
               4 // sub_y, True)
    h = _edges(ph, max(0, min(ph[0].shape[0], (Hc + 7) // 8 - 1)), 8,
               4 // sub_x, False)
    _launch("tde_deblock_chroma", [cb, cr], out, v, h, bit_depth)
    chroma_launches += 1
    return out


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
