"""Motion compensation (spec 8.5.3.3): 8-tap qpel luma / 4-tap epel chroma
interpolation and the weighted/default sample prediction merge.

Port of ``libde265_tpu/ops/mc.py``.  PUs are binned by (w, h); the
reference windows of a bin (edge-clamped, +7/+3 taps) are gathered on the
device in one clamped index gather from a stack of reference planes, and
the separable filters run as shifted multiply-adds over the batch.
``frame_helpers._mc_plane`` (the picture program's per-cell MC) is
``gather_windows`` + ``_sep_filter``, and its ``_merge`` is
``pred_merge_batch``.
"""
from __future__ import annotations

import numpy as np
import torch

QPEL_FILTERS = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1]], dtype=np.int32)

EPEL_FILTERS = np.array([
    [0, 64, 0, 0], [-2, 58, 10, -2], [-4, 54, 16, -2], [-6, 46, 28, -4],
    [-4, 36, 36, -4], [-4, 28, 46, -6], [-2, 16, 54, -4], [-2, 10, 58, -2]],
    dtype=np.int32)


def gather_windows(plane, xs, ys, w: int, h: int, taps: int, center: int,
                   slot=None):
    """[N, h+taps-1, w+taps-1] windows with edge clamping, in one gather.

    plane: [H, W] tensor, or a stack [R, H, W] with `slot` [N] picking each
    window's plane (clamped to [0, R)); xs/ys [N]: the integer-pel top-left
    positions of the blocks (tensors or arrays).  Every coordinate is
    clamped to the plane, as the JAX package's per-window loop does."""
    stack = plane if plane.dim() == 3 else plane[None]
    R, ph, pw = stack.shape
    dev = stack.device
    xs = torch.as_tensor(xs, device=dev).long()
    ys = torch.as_tensor(ys, device=dev).long()
    if slot is None:
        slot = torch.zeros_like(xs)
    slot = torch.as_tensor(slot, device=dev).long().clamp(0, R - 1)
    yy = (ys[:, None] - center +
          torch.arange(h + taps - 1, device=dev)).clamp(0, ph - 1)
    xx = (xs[:, None] - center +
          torch.arange(w + taps - 1, device=dev)).clamp(0, pw - 1)
    idx = (slot[:, None, None] * (ph * pw) + yy[:, :, None] * pw +
           xx[:, None, :])
    return stack.reshape(-1)[idx]


def _wrap16(v):
    """Wrap an int32 tensor to int16 range (two's complement), as the
    spec's 16-bit intermediates of 8.5.3.3.3 do."""
    return v.to(torch.int16).to(torch.int32)


def _sep_filter(win, fx, fy, taps: int, w: int, h: int, shift1: int,
                shift3: int, filters):
    """Separable fractional-sample interpolation on a window batch.

    win: [N, h+taps-1, w+taps-1] int32; fx/fy: [N] fractional positions;
    filters: [n_frac, taps] (array or tensor).  Returns the int16-scaled
    intermediate values [N, h, w] (int32 dtype).
    """
    dev = win.device
    filters = torch.as_tensor(filters, device=dev)
    fx = torch.as_tensor(fx, device=dev).long()
    fy = torch.as_tensor(fy, device=dev).long()
    f_h = filters[fx]  # [N, taps]
    f_v = filters[fy]
    center = taps // 2 - 1

    def taps_along(x, dim, f):
        # sum_k f[:, k] * x shifted by k along dim, as one product over the
        # taps-wide windows of x (integer sums: any order is exact)
        win_k = x.unfold(dim, taps, 1)             # [..., taps]
        return (win_k * f[:, None, None, :]).sum(-1, dtype=torch.int32)

    # horizontal filter over all rows (needed rows depend on fy)
    th = taps_along(win, 2, f_h)
    th_s1 = _wrap16(th >> shift1)               # one-pass H + HV stage 1
    # vertical filter over the full-pel columns
    tv = taps_along(win[:, :, center:center + w], 1, f_v)
    tv_s1 = _wrap16(tv >> shift1)
    # HV: vertical pass over the horizontal intermediate
    hv = _wrap16(taps_along(th_s1, 1, f_v) >> 6)

    full = _wrap16(win[:, center:center + h, center:center + w] << shift3)
    h_only = th_s1[:, center:center + h, :]
    fx_b = (fx != 0)[:, None, None]
    fy_b = (fy != 0)[:, None, None]
    sel = torch.where
    return sel(fx_b & fy_b, hv, sel(fx_b, h_only, sel(fy_b, tv_s1, full)))


def mc_luma_batch(win, fx, fy, w: int, h: int, bit_depth: int = 8):
    """Luma qpel interpolation: win [N, h+7, w+7] -> int16-scaled [N, h, w]."""
    return _sep_filter(win, fx, fy, 8, w, h, bit_depth - 8, 14 - bit_depth,
                       QPEL_FILTERS)


def mc_chroma_batch(win, fx, fy, w: int, h: int, bit_depth: int = 8):
    """Chroma epel interpolation: win [N, h+3, w+3] -> int16-scaled
    [N, h, w]."""
    return _sep_filter(win, fx, fy, 4, w, h, bit_depth - 8, 14 - bit_depth,
                       EPEL_FILTERS)


def pred_merge_batch(p0, p1, bi, weighted, w0, o0, w1, o1, log2_denom,
                     bit_depth: int = 8):
    """Weighted/default sample prediction merge (spec 8.5.4.2.3).

    p0/p1: int32 [N, h, w] int16-scaled predictions (p1 ignored when not
    bi); bi, weighted (bool or int, nonzero = on) and the per-PU weights,
    offsets and log2 denominators are [N] tensors.  Returns clipped
    pixels [N, h, w] int32; every product stays in int32, as in the JAX
    package (at most 2**15 * 2**8 plus a 2**24 offset term)."""
    maxv = (1 << bit_depth) - 1
    shift1 = 14 - bit_depth
    shift2 = 15 - bit_depth
    uni_def = ((p0 + (1 << (shift1 - 1))) >> shift1).clamp(0, maxv)
    bi_def = ((p0 + p1 + (1 << (shift2 - 1))) >> shift2).clamp(0, maxv)
    lwd = (log2_denom + shift1)[:, None, None]
    w0b, w1b = w0[:, None, None], w1[:, None, None]
    o0b, o1b = o0[:, None, None], o1[:, None, None]
    uni_w = (((p0 * w0b + (1 << (lwd - 1))) >> lwd) + o0b).clamp(0, maxv)
    bi_w = ((p0 * w0b + p1 * w1b + ((o0b + o1b + 1) << lwd)) >>
            (lwd + 1)).clamp(0, maxv)
    bi_b = (bi != 0)[:, None, None]
    wt_b = (weighted != 0)[:, None, None]
    sel = torch.where
    return sel(wt_b, sel(bi_b, bi_w, uni_w), sel(bi_b, bi_def, uni_def))
