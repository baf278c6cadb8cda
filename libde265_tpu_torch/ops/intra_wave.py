"""Intra super-wave math (spec 8.4.4.2): the angular tables and the
prediction of one step's blocks from their raw borders.

``build_mode_tables`` is the port of ``libde265_tpu/ops/intra_wave.py``'s
(pure numpy); ``ANGLE`` and ``INV_ANGLE`` are copies of the tables of
``libde265_tpu/ops/intra.py``.  ``wave_predict`` is the math of the JAX
program's ``fused_decode._wave_body`` between the border gather and the
store, shared by the port's unpadded wave step and its padded-plane
(``pallas_intra``) step, and the plain version of the fused CUDA step.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

ANGLE = np.array([0, 0, 32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17,
                  -21, -26, -32, -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9,
                  13, 17, 21, 26, 32])
INV_ANGLE = np.array([0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -4096, -1638, -910,
                      -630, -482, -390, -315, -256, -315, -390, -482, -630,
                      -910, -1638, -4096, 0, 0, 0, 0, 0, 0, 0, 0, 0])


@functools.lru_cache(maxsize=None)
def build_mode_tables(s: int):
    """Per-(mode, size) angular gather tables.

    Returns (P0, P1, W): int32 [35, s*s], the border indices of the two
    reference samples and the interpolation weight for every output pixel.
    Modes 0/1 rows are unused (planar/DC are computed directly).
    """
    n2 = 2 * s
    P0 = np.zeros((35, s * s), dtype=np.int32)
    P1 = np.zeros((35, s * s), dtype=np.int32)
    W = np.zeros((35, s * s), dtype=np.int32)
    for mode in range(2, 35):
        angle = int(ANGLE[mode])
        inv = int(INV_ANGLE[mode])
        vertical = mode >= 18

        def ref_map(i):
            # spec ref[] index -> border[] index
            if i >= 0:
                return (n2 + i) if vertical else (n2 - i)
            off = (i * inv + 128) >> 8
            if vertical:
                return max(n2 - off, 0)
            return min(n2 + off, 4 * s)

        k = np.arange(s)
        idx = ((k + 1) * angle) >> 5
        fact = ((k + 1) * angle) & 31
        p0 = np.zeros((s, s), dtype=np.int32)
        p1 = np.zeros((s, s), dtype=np.int32)
        w = np.zeros((s, s), dtype=np.int32)
        for a in range(s):          # a = y (vertical modes) or x (horizontal)
            for b in range(s):      # b runs along the reference
                i0 = idx[a] + 1 + b
                if vertical:
                    p0[a, b] = ref_map(i0)
                    p1[a, b] = ref_map(i0 + 1)
                    w[a, b] = fact[a]
                else:
                    p0[b, a] = ref_map(i0)
                    p1[b, a] = ref_map(i0 + 1)
                    w[b, a] = fact[a]
        P0[mode] = p0.ravel()
        P1[mode] = p1.ravel()
        W[mode] = w.ravel()
    return P0, P1, W


def wave_predict(b_raw, meta, aw, resid, P0, P1, WT, s: int, bit_depth: int):
    """Reconstructed [N, s, s] blocks of one super-wave step from their raw
    borders (spec 8.4.4.2): substitution, filtering, prediction, residual
    add and clip.

    b_raw: [N, 4s+1] border samples, k < 2s the left column (bottom to
    top), k = 2s the corner, k > 2s the top row (left to right); only the
    samples whose availability bit is set are read.  meta: [N, 5] records
    (mode, edge, y0, x0, flags 1 unavailable | 2 filter | 4 strong |
    8 valid); aw: [N, AVAIL_WORDS] availability bits; resid: [N, s, s];
    P0/P1/WT: the build_mode_tables(s) rows as tensors."""
    dev = b_raw.device
    w = torch.where
    mode, edge = meta[:, 0], meta[:, 1]
    unavail = (meta[:, 4] & 1) != 0
    filt = (meta[:, 4] & 2) != 0
    strong = (meta[:, 4] & 4) != 0
    N = mode.shape[0]
    n2 = 2 * s
    nb = 4 * s + 1
    maxv = (1 << bit_depth) - 1
    lg = s.bit_length() - 1

    # substitution: each sample takes the last available sample at or
    # before it, else the first available one (jump-propagation ladders)
    k = torch.arange(nb, device=dev)
    fil = ((aw[:, k >> 5] >> (k & 31)) & 1) != 0
    b = w(fil, b_raw, 0)
    sh = 1
    while sh < nb:                       # fill-forward: nearest at-or-before
        b = w(fil, b, torch.cat([b.new_zeros((N, sh)), b[:, :nb - sh]], 1))
        fil = fil | torch.cat([fil.new_zeros((N, sh)), fil[:, :nb - sh]], 1)
        sh *= 2
    sh = 1
    while sh < nb:                       # fill-backward: before the first
        b = w(fil, b, torch.cat([b[:, sh:], b.new_zeros((N, sh))], 1))
        fil = fil | torch.cat([fil[:, sh:], fil.new_zeros((N, sh))], 1)
        sh *= 2
    b = w(unavail[:, None], 1 << (bit_depth - 1), b)

    corner = b[:, n2]
    tap3 = b.clone()
    tap3[:, 1:-1] = (b[:, :-2] + 2 * b[:, 1:-1] + b[:, 2:] + 2) >> 2
    if s == 32:
        thr = 1 << (bit_depth - 5)
        bi_ok = (((corner + b[:, 4 * s] - 2 * b[:, n2 + s]).abs() < thr) &
                 ((corner + b[:, 0] - 2 * b[:, s]).abs() < thr))
        i = torch.arange(1, n2, device=dev, dtype=torch.int32)
        bl = b[:, 0:1]
        tr = b[:, 4 * s:4 * s + 1]
        bilin = b.clone()
        bilin[:, n2 - i] = ((n2 - i)[None, :] * corner[:, None] +
                            i[None, :] * bl + 32) >> 6
        bilin[:, n2 + i] = ((n2 - i)[None, :] * corner[:, None] +
                            i[None, :] * tr + 32) >> 6
        filtered = w((strong & bi_ok)[:, None], bilin,
                     w(filt[:, None], tap3, b))
    else:
        filtered = w(filt[:, None], tap3, b)

    left = filtered[:, :n2].flip(1)
    top = filtered[:, n2 + 1:]
    corner = filtered[:, n2]

    xg = torch.arange(s, device=dev, dtype=torch.int32)[None, None, :]
    yg = torch.arange(s, device=dev, dtype=torch.int32)[None, :, None]
    planar = (((s - 1 - xg) * left[:, :s, None] +
               (xg + 1) * top[:, s, None, None] +
               (s - 1 - yg) * top[:, None, :s] +
               (yg + 1) * left[:, s, None, None] + s) >> (lg + 1))

    dc = ((left[:, :s].sum(1) + top[:, :s].sum(1) + s) >> (lg + 1)).to(
        torch.int32)
    dcp = dc[:, None, None].expand(N, s, s)
    if s < 32:
        dce = dcp.clone()
        dce[:, 0, 1:] = (top[:, 1:s] + 3 * dc[:, None] + 2) >> 2
        dce[:, 1:, 0] = (left[:, 1:s] + 3 * dc[:, None] + 2) >> 2
        dce[:, 0, 0] = (left[:, 0] + 2 * dc + top[:, 0] + 2) >> 2
        dcp = w((edge == 1)[:, None, None], dce, dcp)

    # angular reference fetch: rows of the per-mode tables, then a gather
    # along the filtered border.  Table entries outside the border (only
    # ever paired with weight 0) read as 0, as the JAX one-hot product does.
    mi = mode.long().clamp(0, 34)

    def fetch(tab):
        p = tab[mi].long()
        inside = (p >= 0) & (p < nb)
        return w(inside, torch.gather(filtered, 1, p.clamp(0, nb - 1)), 0)

    g0 = fetch(P0)
    g1 = fetch(P1)
    wt = WT[mi]
    ang = (((32 - wt) * g0 + wt * g1 + 16) >> 5).reshape(N, s, s)
    if s < 32:
        v26 = (top[:, 0, None] + ((left[:, :s] - corner[:, None]) >> 1)).clamp(
            0, maxv)
        v10 = (left[:, 0, None] + ((top[:, :s] - corner[:, None]) >> 1)).clamp(
            0, maxv)
        a26 = ang.clone()
        a26[:, :, 0] = v26
        ang = w((edge == 2)[:, None, None], a26, ang)
        a10 = ang.clone()
        a10[:, 0, :] = v10
        ang = w((edge == 3)[:, None, None], a10, ang)

    pred = w((mode == 0)[:, None, None], planar,
             w((mode == 1)[:, None, None], dcp, ang))
    return (pred + resid).clamp(0, maxv)
