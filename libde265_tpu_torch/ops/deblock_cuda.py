"""Kernels B8 (luma) and B9 (chroma) deblocking passes (``csrc/deblock.cu``)
and their plain PyTorch versions.

Replace the TPU kernels ``libde265_tpu/ops/deblock_pallas.py:luma_pass``,
``luma_pass_h``, ``chroma_pass_stacked`` and ``chroma_pass_stacked_h``, with
the same argument layouts.  One thread per (segment, edge) filters its
group in place on a copy of the plane, in the natural layout for both edge
orientations.  Bound by device memory (one read of each group sample).
"""
from __future__ import annotations

import torch

from . import _build
from ._tensors import check, on_cuda, stream_of
from .deblock import _chroma_pass, _luma_pass

luma_launches = 0    # B8 launches since the last reset (read by chip_smoke)
chroma_launches = 0  # B9 launches since the last reset


def _luma_cuda(img, bs, beta, tc, no_p, no_q, bit_depth, horizontal):
    global luma_launches
    check("luma_pass", img.device, torch.int32, img, bs, beta, tc, no_p, no_q)
    for t in (beta, tc, no_p, no_q):
        if t.shape != bs.shape:
            raise ValueError("luma_pass: parameter shapes differ")
    if img.dim() != 2 or bs.dim() != 2:
        raise ValueError("luma_pass: img and params must be 2-D")
    if horizontal:   # img [Hp, W], params [E, W/4]
        E, nseg = bs.shape
        R, groups = img.shape[1], img.shape[0]
        geom = (1, img.shape[1], 1, nseg)  # stride_r, stride_g, ps, pe
    else:            # img [H, Wp], params [H/4, E]
        nseg, E = bs.shape
        R, groups = img.shape[0], img.shape[1]
        geom = (img.shape[1], 1, E, 1)
    if 8 * E > groups:
        raise ValueError(f"luma_pass: {E} edges need {8 * E} samples, "
                         f"plane has {groups}")
    out = img.clone()
    rc = _build.lib().tde_luma_pass(
        out.data_ptr(), bs.data_ptr(), beta.data_ptr(), tc.data_ptr(),
        no_p.data_ptr(), no_q.data_ptr(), nseg, E, R, *geom, bit_depth,
        stream_of(img))
    _build.check_launch("tde_luma_pass", rc)
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
    _, h, w = imgs.shape
    if horizontal:   # imgs [2, Hp, Wc], params [E, S]
        E, nseg = no_p.shape
        R, groups = w, h
        strides = (1, w)
        pstrides = (1, nseg)
    else:            # imgs [2, Hc, Wp], params [S, E]
        nseg, E = no_p.shape
        R, groups = h, w
        strides = (w, 1)
        pstrides = (E, 1)
    if 8 * E > groups:
        raise ValueError(f"chroma_pass: {E} edges need {8 * E} samples, "
                         f"plane has {groups}")
    out = imgs.clone()
    rc = _build.lib().tde_chroma_pass(
        out.data_ptr(), tcs.data_ptr(), no_p.data_ptr(), no_q.data_ptr(),
        nseg, E, R, per_seg, *strides, h * w, *pstrides, nseg * E,
        bit_depth, stream_of(imgs))
    _build.check_launch("tde_chroma_pass", rc)
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
