"""Per-picture helpers of the fused decode: MC interpolation and merge,
cell-grid reshapes, and the deblocking edge-parameter derivation.

Port of the helpers that ``libde265_tpu/fused_decode.py`` imports from
``libde265_tpu/tpu_decode.py`` (``_wrap16``, ``_mc_plane``, ``_merge``,
``_cells_to_plane``, ``_edge_params_jnp``, ``_chroma_qp_map``; its
``_pad_edge0_cols`` is ``ops.deblock.pad_edge0``).  The names are kept so
that each function can be held against its counterpart.
"""
from __future__ import annotations

import torch

from .feed import NOREF
from .ops import deblock as dbk


def _wrap16(v):
    """Wrap an int32 tensor to int16 range (two's complement), as the
    spec's 16-bit intermediates of 8.5.3.3.3 do."""
    return v.to(torch.int16).to(torch.int32)


def _mc_plane(ref_stack, slot, xint, yint, frac_x, frac_y, filters, taps,
              bs: int, bd: int):
    """Interpolate a [N, bs, bs] block batch from the stacked refs.

    ref_stack: [R, Hp, Wp] int32; per-cell integer positions, fractions and
    reference slots ([N] int32); filters: [n_frac, taps] int32 tensor.
    Returns predictions at the 14-bit intermediate scale (int32 dtype).
    """
    R, Hp, Wp = ref_stack.shape
    dev = ref_stack.device
    wn = bs + taps - 1
    center = taps // 2 - 1
    ar = torch.arange(wn, device=dev)
    iy = (yint.long()[:, None] - center + ar).clamp(0, Hp - 1)
    ix = (xint.long()[:, None] - center + ar).clamp(0, Wp - 1)
    slot = slot.long().clamp(0, R - 1)
    idx = (slot[:, None, None] * (Hp * Wp) + iy[:, :, None] * Wp +
           ix[:, None, :])
    win = ref_stack.reshape(-1)[idx]  # [N, wn, wn]

    f_h = filters[frac_x.long()]  # [N, taps]
    f_v = filters[frac_y.long()]
    shift1 = bd - 8
    shift3 = 14 - bd
    th = sum(f_h[:, k, None, None] * win[:, :, k:k + bs] for k in range(taps))
    th_s1 = _wrap16(th >> shift1)
    tv = sum(f_v[:, k, None, None] * win[:, k:k + bs, center:center + bs]
             for k in range(taps))
    tv_s1 = _wrap16(tv >> shift1)
    hv = sum(f_v[:, k, None, None] * th_s1[:, k:k + bs, :]
             for k in range(taps))
    hv = _wrap16(hv >> 6)
    full = _wrap16(win[:, center:center + bs, center:center + bs] << shift3)
    h_only = th_s1[:, center:center + bs, :]
    fx_b = (frac_x != 0)[:, None, None]
    fy_b = (frac_y != 0)[:, None, None]
    w = torch.where
    return w(fx_b & fy_b, hv, w(fx_b, h_only, w(fy_b, tv_s1, full)))


def _merge(p0, p1, bi, weighted, w0, o0, w1, o1, denom, bd: int):
    """Weighted/default prediction merge on per-cell block batches."""
    maxv = (1 << bd) - 1
    shift1 = 14 - bd
    shift2 = 15 - bd
    uni_def = ((p0 + (1 << (shift1 - 1))) >> shift1).clamp(0, maxv)
    bi_def = ((p0 + p1 + (1 << (shift2 - 1))) >> shift2).clamp(0, maxv)
    lwd = (denom + shift1)[:, None, None]
    w0b, w1b = w0[:, None, None], w1[:, None, None]
    o0b, o1b = o0[:, None, None], o1[:, None, None]
    uni_w = (((p0 * w0b + (1 << (lwd - 1))) >> lwd) + o0b).clamp(0, maxv)
    bi_w = ((p0 * w0b + p1 * w1b + ((o0b + o1b + 1) << lwd)) >>
            (lwd + 1)).clamp(0, maxv)
    bi_b = bi[:, None, None]
    wt_b = (weighted != 0)[:, None, None]
    w = torch.where
    return w(wt_b, w(bi_b, bi_w, uni_w), w(bi_b, bi_def, uni_def))


def _cells_to_plane(blocks, H4, W4, bs):
    return blocks.reshape(H4, W4, bs, bs).permute(0, 2, 1, 3).reshape(
        H4 * bs, W4 * bs)


def _edge_params_jnp(meta, vertical: bool):
    """Per-4-sample-segment deblocking parameters of one edge orientation
    (bS, beta, tc, qp_l, no_p, no_q, chroma QP and tc offsets) from the
    per-4x4 metadata grids; port of tpu_decode._edge_params_jnp."""
    # edges at 4x4 cell index 2, 4, ... (q side) with p one cell before
    if vertical:
        q = (slice(None), slice(2, None, 2))
        p = (slice(None), slice(1, -1, 2))
        tu_edge = meta["tu_edge_v"][q]
        pu_edge = meta["pu_edge_v"][q]
    else:
        q = (slice(2, None, 2), slice(None))
        p = (slice(1, -1, 2), slice(None))
        tu_edge = meta["tu_edge_h"][q]
        pu_edge = meta["pu_edge_h"][q]

    intra_p = meta["intra"][p] != 0
    intra_q = meta["intra"][q] != 0
    nz_p = meta["nzc"][p] != 0
    nz_q = meta["nzc"][q] != 0
    pf_p = meta["pf"][p]
    pf_q = meta["pf"][q]
    w = torch.where
    rp, rq = [None, None], [None, None]
    mvp = [[None, None], [None, None]]
    mvq = [[None, None], [None, None]]
    for l in range(2):
        has_p = ((pf_p >> l) & 1) != 0
        has_q = ((pf_q >> l) & 1) != 0
        rp[l] = w(has_p, meta["rp"][l][p], NOREF)
        rq[l] = w(has_q, meta["rp"][l][q], NOREF)
        for c in range(2):
            mvp[l][c] = w(has_p, meta["mv"][l][c][p], 0)
            mvq[l][c] = w(has_q, meta["mv"][l][c][q], 0)

    def far(mpx, mpy, mqx, mqy):
        return ((mpx - mqx).abs() >= 4) | ((mpy - mqy).abs() >= 4)

    same_pics = (((rp[0] == rq[0]) & (rp[1] == rq[1])) |
                 ((rp[0] == rq[1]) & (rp[1] == rq[0])))
    straight = far(mvp[0][0], mvp[0][1], mvq[0][0], mvq[0][1]) | \
        far(mvp[1][0], mvp[1][1], mvq[1][0], mvq[1][1])
    crossed = far(mvp[0][0], mvp[0][1], mvq[1][0], mvq[1][1]) | \
        far(mvp[1][0], mvp[1][1], mvq[0][0], mvq[0][1])
    mv_differs = w(rp[0] != rp[1], w(rp[0] == rq[0], straight, crossed),
                   straight & crossed)
    mv_bs = w(same_pics, mv_differs, True).to(torch.int32)
    bs = w(intra_p | intra_q, 2,
           w((tu_edge != 0) & (nz_p | nz_q), 1, mv_bs))
    edge = (tu_edge | pu_edge) != 0
    allow = meta["allow_v"][q] if vertical else meta["allow_h"][q]
    bs = w(edge & (allow != 0), bs, 0).to(torch.int32)

    qp_l = (meta["qp"][p] + meta["qp"][q] + 1) >> 1
    bd = meta["bit_depth"]
    boff = meta["beta_off"][q]
    toff = meta["tc_off"][q]
    dev = bs.device
    beta_t = torch.as_tensor(dbk.BETA_TABLE, device=dev)
    tc_t = torch.as_tensor(dbk.TC_TABLE, device=dev)
    beta = beta_t[(qp_l + boff).clamp(0, 51).long()] << (bd - 8)
    tc = tc_t[(qp_l + 2 * (bs - 1) + toff).clamp(0, 53).long()] << (bd - 8)
    return {"bs": bs, "beta": beta, "tc": tc, "qp_l": qp_l.to(torch.int32),
            "no_p": meta["unfilt"][p].to(torch.int32),
            "no_q": meta["unfilt"][q].to(torch.int32),
            "cqo": [meta["cqo0"][q], meta["cqo1"][q]],
            "tco": toff}


def _chroma_qp_map(qpi, is420):
    if is420:
        tab = torch.as_tensor(dbk.CHROMA_QP_TAB, device=qpi.device)
        return torch.where(
            qpi < 30, qpi,
            torch.where(qpi > 43, qpi - 6, tab[(qpi - 30).clamp(0, 13).long()]))
    return qpi.clamp(0, 51)
