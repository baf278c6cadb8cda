"""Deblocking filter (spec 8.7.2): tables and the plain PyTorch passes.

Port of ``libde265_tpu/ops/deblock.py``.  ``derive_edge_params`` derives
the per-segment parameters of one edge orientation from the per-4x4
metadata grids.  A pass filters every edge of one orientation at once: the
edges sit 8 samples apart and each touches at most 3 samples per side, so
the 8-sample groups around them are independent.  ``_luma_pass`` and
``_chroma_pass`` and the plane wrappers around them (``luma_vertical``,
``luma_horizontal``, ``chroma_vertical``, ``chroma_horizontal``) are the
plain versions of the Hopper kernels wrapped in ``deblock_cuda`` and the
CPU path of the port.
"""
from __future__ import annotations

import numpy as np
import torch

BETA_TABLE = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6, 7,
    8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32,
    34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64],
    dtype=np.int32)
TC_TABLE = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4,
    4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24],
    dtype=np.int32)

CHROMA_QP_TAB = np.array([29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37,
                          37], dtype=np.int32)


NOREF = -(10 ** 6)    # the reference POC of a list a 4x4 cell does not use


def derive_edge_params(meta, vertical: bool):
    """Per-4-sample-segment edge parameters of one orientation.

    meta: per-4x4 tensors intra, nzc, tu_edge_v/h, pu_edge_v/h, qp, pf,
    mv[2][2], rp[2] (reference POCs, int64), unfilt, allow_v/h, beta_off
    and tc_off (per-4x4 grids, the Q-side cell's slice governs, or
    scalars), and the int bit_depth.  Returns bs, beta, tc, qp_l, no_p,
    no_q as int32 [n_seg_rows, n_edges] for vertical edges (x = 8, 16,
    ...) and [n_edges, n_seg_cols] for horizontal ones.
    """
    return _derive_edge_params(meta, vertical)[0]


def edge_params(meta, vertical: bool):
    """derive_edge_params with the Q side's tc offset ("tco") and chroma QP
    offsets ("cqo": meta's cqo0 and cqo1 grids), the inputs of the chroma
    tc; port of tpu_decode._edge_params_jnp."""
    q = (slice(None), slice(2, None, 2)) if vertical else \
        (slice(2, None, 2), slice(None))
    out, tco = _derive_edge_params(meta, vertical)
    out["tco"] = tco
    out["cqo"] = [meta["cqo0"][q], meta["cqo1"][q]]
    return out


def _derive_edge_params(meta, vertical: bool):
    """derive_edge_params and the Q side's tc offset it used."""
    if vertical:
        # edges at x4 = 2, 4, ... (x = 8k, k >= 1); segments: every y4
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
    # different reference pictures -> bS=1 regardless of the MVs
    mv_bs = w(same_pics, mv_differs, True).to(torch.int32)
    bs = w(intra_p | intra_q, 2,
           w((tu_edge != 0) & (nz_p | nz_q), 1, mv_bs))
    # picture-boundary/slice/tile/slice-disable gating is folded into the
    # allow grids (per 4x4 position of the Q side)
    edge = (tu_edge | pu_edge) != 0
    allow = meta["allow_v"][q] if vertical else meta["allow_h"][q]
    bs = w(edge & (allow != 0), bs, 0).to(torch.int32)

    qp_l = (meta["qp"][p] + meta["qp"][q] + 1) >> 1
    bd = meta["bit_depth"]
    boff, toff = meta["beta_off"], meta["tc_off"]
    if torch.is_tensor(boff) and boff.dim() == 2:
        boff = boff[q]
    if torch.is_tensor(toff) and toff.dim() == 2:
        toff = toff[q]
    dev = bs.device
    beta_t = torch.as_tensor(BETA_TABLE, device=dev)
    tc_t = torch.as_tensor(TC_TABLE, device=dev)
    beta = beta_t[(qp_l + boff).clamp(0, 51).long()] << (bd - 8)
    tc = tc_t[(qp_l + 2 * (bs - 1) + toff).clamp(0, 53).long()] << (bd - 8)
    return {"bs": bs, "beta": beta.to(torch.int32), "tc": tc.to(torch.int32),
            "qp_l": qp_l.to(torch.int32),
            "no_p": meta["unfilt"][p].to(torch.int32),
            "no_q": meta["unfilt"][q].to(torch.int32)}, toff


def chroma_qp_map(qpi, is420):
    """QpC of the chroma deblocking from qPi (spec Table 8-10 for 4:2:0,
    else Min(qPi, 51), here clamped to [0, 51])."""
    if is420:
        tab = torch.as_tensor(CHROMA_QP_TAB, device=qpi.device)
        return torch.where(qpi < 30, qpi, torch.where(
            qpi > 43, qpi - 6, tab[(qpi - 30).clamp(0, 13).long()]))
    return qpi.clamp(0, 51)


def pad_edge0(a, E):
    """Per-segment parameters [S, E'] of edges 1.. as [S, E] of edges 0..E-1:
    a zero column (edge 0, the picture's border: off) in front, cut to E."""
    return torch.cat([a.new_zeros((a.shape[0], 1)), a], dim=1)[:, :E]


def _luma_pass(img, bs, beta, tc, no_p, no_q, bit_depth: int = 8):
    """One vertical deblocking pass over a [H, Wp] padded int32 plane.

    img: padded plane with the picture at columns [4, 4+W); edges at picture
    columns 8k map to padded columns 8k+4.  bs/beta/tc/no_p/no_q are
    [H/4, E] per-segment params (E = W//8 edges, edge 0 = picture x=0,
    gated off by bs=0).
    """
    H = img.shape[0]
    E = bs.shape[1]
    maxv = (1 << bit_depth) - 1

    # c[k][:, e] = img[:, 8e + k]
    g = img[:, :8 * E].reshape(H, E, 8).permute(2, 0, 1)
    p3, p2, p1, p0, q0, q1, q2, q3 = [g[k] for k in range(8)]

    def rep(a):
        return a.repeat_interleave(4, dim=0)[:H]

    tc_r = rep(tc)
    no_p_r = rep(no_p) != 0
    no_q_r = rep(no_q) != 0

    dp = (p2 - 2 * p1 + p0).abs()
    dq = (q2 - 2 * q1 + q0).abs()
    # per-segment decision uses rows 0 and 3
    dp0, dp3 = dp[0::4], dp[3::4]
    dq0, dq3 = dq[0::4], dq[3::4]
    dpq0 = dp0 + dq0
    dpq3 = dp3 + dq3
    filt_seg = (dpq0 + dpq3 < beta) & (bs > 0)

    def strong_cond(k_p3, k_p0, k_q0, k_q3, dpq):
        return ((2 * dpq < (beta >> 2)) &
                (((k_p3 - k_p0).abs() + (k_q0 - k_q3).abs()) < (beta >> 3)) &
                ((k_p0 - k_q0).abs() < ((5 * tc + 1) >> 1)))

    s0 = strong_cond(p3[0::4], p0[0::4], q0[0::4], q3[0::4], dpq0)
    s3 = strong_cond(p3[3::4], p0[3::4], q0[3::4], q3[3::4], dpq3)
    strong_seg = filt_seg & s0 & s3
    side = (beta + (beta >> 1)) >> 3
    dep_seg = filt_seg & ((dp0 + dp3) < side)
    deq_seg = filt_seg & ((dq0 + dq3) < side)

    filt = rep(filt_seg)
    strong = rep(strong_seg)
    dep = rep(dep_seg)
    deq = rep(deq_seg)

    # --- strong filter ---
    def c2(x):
        return torch.minimum(torch.maximum(x, -2 * tc_r), 2 * tc_r)

    sp0 = p0 + c2(((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3) - p0)
    sp1 = p1 + c2(((p2 + p1 + p0 + q0 + 2) >> 2) - p1)
    sp2 = p2 + c2(((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3) - p2)
    sq0 = q0 + c2(((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3) - q0)
    sq1 = q1 + c2(((q2 + q1 + q0 + p0 + 2) >> 2) - q1)
    sq2 = q2 + c2(((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3) - q2)

    # --- weak filter ---
    def clip_t(x, t):
        return torch.minimum(torch.maximum(x, -t), t)

    delta0 = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    weak_on = delta0.abs() < (tc_r * 10)
    delta = clip_t(delta0, tc_r)
    wp0 = (p0 + delta).clamp(0, maxv)
    wq0 = (q0 - delta).clamp(0, maxv)
    tc2 = tc_r >> 1
    wp1 = (p1 + clip_t((((p2 + p0 + 1) >> 1) - p1 + delta) >> 1, tc2)).clamp(
        0, maxv)
    wq1 = (q1 + clip_t((((q2 + q0 + 1) >> 1) - q1 - delta) >> 1, tc2)).clamp(
        0, maxv)

    weak = filt & ~strong & weak_on
    strong_m = filt & strong
    do_p = ~no_p_r
    do_q = ~no_q_r
    w = torch.where
    np0 = w(strong_m & do_p, sp0, w(weak & do_p, wp0, p0))
    np1 = w(strong_m & do_p, sp1, w(weak & dep & do_p, wp1, p1))
    np2 = w(strong_m & do_p, sp2, p2)
    nq0 = w(strong_m & do_q, sq0, w(weak & do_q, wq0, q0))
    nq1 = w(strong_m & do_q, sq1, w(weak & deq & do_q, wq1, q1))
    nq2 = w(strong_m & do_q, sq2, q2)

    new_g = torch.stack([p3, np2, np1, np0, nq0, nq1, nq2, q3])
    out_cols = new_g.permute(1, 2, 0).reshape(H, 8 * E)
    return torch.cat([out_cols, img[:, 8 * E:]], dim=1)


def _chroma_pass(img, tc, no_p, no_q, bit_depth: int = 8,
                 rows_per_seg: int = 2):
    """Chroma vertical pass on a [Hc, pad] plane; edges every 8 chroma cols.

    tc/no_p/no_q: [S, E] per-segment params (tc=0 where bs!=2); one luma
    4-row segment covers `rows_per_seg` chroma rows (2 for 4:2:0 vertical,
    4 for full-resolution axes in 4:2:2/4:4:4).
    """
    H = img.shape[0]
    E = tc.shape[1]
    maxv = (1 << bit_depth) - 1
    g = img[:, :8 * E].reshape(H, E, 8).permute(2, 0, 1)
    p1, p0, q0, q1 = [g[k] for k in range(4)]

    def rep(a):
        return a.repeat_interleave(rows_per_seg, dim=0)[:H]

    tc_r = rep(tc)
    no_p_r = rep(no_p) != 0
    no_q_r = rep(no_q) != 0

    delta = torch.minimum(torch.maximum(
        ((((q0 - p0) << 2) + p1 - q1 + 4) >> 3), -tc_r), tc_r)
    on = tc_r > 0
    np0 = torch.where(on & ~no_p_r, (p0 + delta).clamp(0, maxv), p0)
    nq0 = torch.where(on & ~no_q_r, (q0 - delta).clamp(0, maxv), q0)
    new_g = torch.cat([g[0:1], np0[None], nq0[None], g[3:]])
    out_cols = new_g.permute(1, 2, 0).reshape(H, 8 * E)
    return torch.cat([out_cols, img[:, 8 * E:]], dim=1)


def luma_vertical(img, params, bit_depth: int = 8):
    """The vertical luma pass on a [H, W] int32 plane: params (bs, beta,
    tc, no_p, no_q), each [H/4, W//8] with edge 0 (the picture's border,
    bs 0) first.  Returns a new [H, W] plane."""
    H, W = img.shape
    pad = img.new_zeros((H, W + 8))
    pad[:, 4:4 + W] = img
    return _luma_pass(pad, *params, bit_depth)[:, 4:4 + W]


def luma_horizontal(img, params, bit_depth: int = 8):
    """The horizontal luma pass: params [W/4, H//8] (transposed layout)."""
    return luma_vertical(img.T, params, bit_depth).T


def chroma_vertical(img, tc, no_p, no_q, bit_depth: int = 8,
                    rows_per_seg: int = 2):
    """The vertical chroma pass on a [Hc, Wc] int32 plane: tc/no_p/no_q
    [S, E] with edge 0 first (tc 0 where bS != 2)."""
    H, W = img.shape
    pad = img.new_zeros((H, W + 8))
    pad[:, 2:2 + W] = img
    return _chroma_pass(pad, tc, no_p, no_q, bit_depth,
                        rows_per_seg)[:, 2:2 + W]


def chroma_horizontal(img, tc, no_p, no_q, bit_depth: int = 8,
                      rows_per_seg: int = 2):
    """The horizontal chroma pass (parameters in transposed layout)."""
    return chroma_vertical(img.T, tc, no_p, no_q, bit_depth,
                           rows_per_seg).T
