"""Batched dequant + inverse transform (spec 8.6.2-8.6.4) in PyTorch.

Port of ``libde265_tpu/ops/transform.py``.  TUs are binned by size into
dense ``[N, s, s]`` int32 batches.  The two 1-D transform stages are
matrix products taken in float64: the integer sums reach about
32 * 90 * 32768 (9.4e7), beyond float32's exact range (2**24) but far
inside float64's (2**53), so every product and sum is exact on both the
CPU and the GPU.  PyTorch has no general int32 matmul on CUDA.  A bin
mixes the TUs of every channel, so ``residual_batch_by_channel`` takes
each TU at its own channel's bit depth where luma and chroma depths
differ.
"""
from __future__ import annotations

import numpy as np
import torch

# spec 8.6.4.2 transMatrix (32x32); identical constants to
# native/src/transform.cc kDctMatrix.
DCT32 = np.array([
    [64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64,
     64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64],
    [90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4,
     -4, -13, -22, -31, -38, -46, -54, -61, -67, -73, -78, -82, -85, -88, -90, -90],
    [90, 87, 80, 70, 57, 43, 25, 9, -9, -25, -43, -57, -70, -80, -87, -90,
     -90, -87, -80, -70, -57, -43, -25, -9, 9, 25, 43, 57, 70, 80, 87, 90],
    [90, 82, 67, 46, 22, -4, -31, -54, -73, -85, -90, -88, -78, -61, -38, -13,
     13, 38, 61, 78, 88, 90, 85, 73, 54, 31, 4, -22, -46, -67, -82, -90],
    [89, 75, 50, 18, -18, -50, -75, -89, -89, -75, -50, -18, 18, 50, 75, 89,
     89, 75, 50, 18, -18, -50, -75, -89, -89, -75, -50, -18, 18, 50, 75, 89],
    [88, 67, 31, -13, -54, -82, -90, -78, -46, -4, 38, 73, 90, 85, 61, 22,
     -22, -61, -85, -90, -73, -38, 4, 46, 78, 90, 82, 54, 13, -31, -67, -88],
    [87, 57, 9, -43, -80, -90, -70, -25, 25, 70, 90, 80, 43, -9, -57, -87,
     -87, -57, -9, 43, 80, 90, 70, 25, -25, -70, -90, -80, -43, 9, 57, 87],
    [85, 46, -13, -67, -90, -73, -22, 38, 82, 88, 54, -4, -61, -90, -78, -31,
     31, 78, 90, 61, 4, -54, -88, -82, -38, 22, 73, 90, 67, 13, -46, -85],
    [83, 36, -36, -83, -83, -36, 36, 83, 83, 36, -36, -83, -83, -36, 36, 83,
     83, 36, -36, -83, -83, -36, 36, 83, 83, 36, -36, -83, -83, -36, 36, 83],
    [82, 22, -54, -90, -61, 13, 78, 85, 31, -46, -90, -67, 4, 73, 88, 38,
     -38, -88, -73, -4, 67, 90, 46, -31, -85, -78, -13, 61, 90, 54, -22, -82],
    [80, 9, -70, -87, -25, 57, 90, 43, -43, -90, -57, 25, 87, 70, -9, -80,
     -80, -9, 70, 87, 25, -57, -90, -43, 43, 90, 57, -25, -87, -70, 9, 80],
    [78, -4, -82, -73, 13, 85, 67, -22, -88, -61, 31, 90, 54, -38, -90, -46,
     46, 90, 38, -54, -90, -31, 61, 88, 22, -67, -85, -13, 73, 82, 4, -78],
    [75, -18, -89, -50, 50, 89, 18, -75, -75, 18, 89, 50, -50, -89, -18, 75,
     75, -18, -89, -50, 50, 89, 18, -75, -75, 18, 89, 50, -50, -89, -18, 75],
    [73, -31, -90, -22, 78, 67, -38, -90, -13, 82, 61, -46, -88, -4, 85, 54,
     -54, -85, 4, 88, 46, -61, -82, 13, 90, 38, -67, -78, 22, 90, 31, -73],
    [70, -43, -87, 9, 90, 25, -80, -57, 57, 80, -25, -90, -9, 87, 43, -70,
     -70, 43, 87, -9, -90, -25, 80, 57, -57, -80, 25, 90, 9, -87, -43, 70],
    [67, -54, -78, 38, 85, -22, -90, 4, 90, 13, -88, -31, 82, 46, -73, -61,
     61, 73, -46, -82, 31, 88, -13, -90, -4, 90, 22, -85, -38, 78, 54, -67],
    [64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64,
     64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64],
    [61, -73, -46, 82, 31, -88, -13, 90, -4, -90, 22, 85, -38, -78, 54, 67,
     -67, -54, 78, 38, -85, -22, 90, 4, -90, 13, 88, -31, -82, 46, 73, -61],
    [57, -80, -25, 90, -9, -87, 43, 70, -70, -43, 87, 9, -90, 25, 80, -57,
     -57, 80, 25, -90, 9, 87, -43, -70, 70, 43, -87, -9, 90, -25, -80, 57],
    [54, -85, -4, 88, -46, -61, 82, 13, -90, 38, 67, -78, -22, 90, -31, -73,
     73, 31, -90, 22, 78, -67, -38, 90, -13, -82, 61, 46, -88, 4, 85, -54],
    [50, -89, 18, 75, -75, -18, 89, -50, -50, 89, -18, -75, 75, 18, -89, 50,
     50, -89, 18, 75, -75, -18, 89, -50, -50, 89, -18, -75, 75, 18, -89, 50],
    [46, -90, 38, 54, -90, 31, 61, -88, 22, 67, -85, 13, 73, -82, 4, 78,
     -78, -4, 82, -73, -13, 85, -67, -22, 88, -61, -31, 90, -54, -38, 90, -46],
    [43, -90, 57, 25, -87, 70, 9, -80, 80, -9, -70, 87, -25, -57, 90, -43,
     -43, 90, -57, -25, 87, -70, -9, 80, -80, 9, 70, -87, 25, 57, -90, 43],
    [38, -88, 73, -4, -67, 90, -46, -31, 85, -78, 13, 61, -90, 54, 22, -82,
     82, -22, -54, 90, -61, -13, 78, -85, 31, 46, -90, 67, 4, -73, 88, -38],
    [36, -83, 83, -36, -36, 83, -83, 36, 36, -83, 83, -36, -36, 83, -83, 36,
     36, -83, 83, -36, -36, 83, -83, 36, 36, -83, 83, -36, -36, 83, -83, 36],
    [31, -78, 90, -61, 4, 54, -88, 82, -38, -22, 73, -90, 67, -13, -46, 85,
     -85, 46, 13, -67, 90, -73, 22, 38, -82, 88, -54, -4, 61, -90, 78, -31],
    [25, -70, 90, -80, 43, 9, -57, 87, -87, 57, -9, -43, 80, -90, 70, -25,
     -25, 70, -90, 80, -43, -9, 57, -87, 87, -57, 9, 43, -80, 90, -70, 25],
    [22, -61, 85, -90, 73, -38, -4, 46, -78, 90, -82, 54, -13, -31, 67, -88,
     88, -67, 31, 13, -54, 82, -90, 78, -46, 4, 38, -73, 90, -85, 61, -22],
    [18, -50, 75, -89, 89, -75, 50, -18, -18, 50, -75, 89, -89, 75, -50, 18,
     18, -50, 75, -89, 89, -75, 50, -18, -18, 50, -75, 89, -89, 75, -50, 18],
    [13, -38, 61, -78, 88, -90, 85, -73, 54, -31, 4, 22, -46, 67, -82, 90,
     -90, 82, -67, 46, -22, -4, 31, -54, 73, -85, 90, -88, 78, -61, 38, -13],
    [9, -25, 43, -57, 70, -80, 87, -90, 90, -87, 80, -70, 57, -43, 25, -9,
     -9, 25, -43, 57, -70, 80, -87, 90, -90, 87, -80, 70, -57, 43, -25, 9],
    [4, -13, 22, -31, 38, -46, 54, -61, 67, -73, 78, -82, 85, -88, 90, -90,
     90, -90, 88, -85, 82, -78, 73, -67, 61, -54, 46, -38, 31, -22, 13, -4]],
    dtype=np.int32)

DST4 = np.array([[29, 55, 74, 84],
                 [74, 74, 0, -74],
                 [84, -29, -74, 55],
                 [55, -84, 74, -29]], dtype=np.int32)

LEVEL_SCALE = np.array([40, 45, 51, 57, 64, 72], dtype=np.int32)

def dct_matrix(size: int) -> np.ndarray:
    """N-point inverse-DCT matrix: rows of DCT32 sampled at stride 32/N."""
    step = 32 // size
    return DCT32[::step, :size].copy()


def _itx_2d(coeff, mat, bd_shift):
    """Two-stage integer inverse transform of a [N, s, s] batch.

    Stage 1 (vertical):  g[n,i,c] = clip16((sum_j M[j,i]*coeff[n,j,c] + 64) >> 7)
    Stage 2 (horizontal): r[n,y,i] = (sum_j M[j,i]*g[n,y,j] + rnd) >> bd_shift
    """
    m = torch.as_tensor(mat, dtype=torch.float64, device=coeff.device)
    g = torch.matmul(m.T, coeff.to(torch.float64)).to(torch.int64)
    g = ((g + 64) >> 7).clamp(-32768, 32767)
    r = torch.matmul(g.to(torch.float64), m).to(torch.int64)
    return ((r + (1 << (bd_shift - 1))) >> bd_shift).to(torch.int32)


def residual_batch(levels, fact, tskip, use_dst, log2_size: int,
                   bit_depth: int = 8, sf=None, qp=None):
    """Dequant + inverse transform for one size bin.

    levels:  int32 [N, s, s] coded coefficient levels (dense)
    fact:    int32 [N] levelScale[qp%6] << (qp/6) (flat scaling list)
    tskip:   bool  [N] transform_skip_flag
    use_dst: bool  [N] 4x4 intra luma DST (only meaningful for s=4)
    sf:      optional int32 [N, s, s] scaling factors (spec 8.6.3 m[x][y]);
             requires `qp` int32 [N] (the per-TU QP') when given
    returns: int32 [N, s, s] residual
    """
    s = 1 << log2_size
    if sf is None:
        bd_shift = bit_depth + log2_size - 5 - 4
        offset = 1 << (bd_shift - 1)
        coeff = ((levels * fact[:, None, None] + offset) >> bd_shift).clamp(
            -32768, 32767)
    else:
        # scaling-list dequant in int32, the qp/6 left shift folded into the
        # right shift exactly (see libde265_tpu/ops/transform.py)
        b = bit_depth + log2_size - 5
        ls = torch.as_tensor(LEVEL_SCALE, device=levels.device)
        t = levels * (sf * ls[(qp % 6).long()][:, None, None])
        d = (b - qp // 6)[:, None, None]
        rnd = torch.where(d > 0, 1 << (d - 1).clamp(min=0), 0)
        coeff = torch.where(d > 0, (t + rnd) >> d.clamp(min=0),
                            t << (-d).clamp(min=0))
        coeff = coeff.clamp(-32768, 32767)

    bd_shift2 = 20 - bit_depth
    r_tx = _itx_2d(coeff, dct_matrix(s), bd_shift2)
    if s == 4:
        r_tx = torch.where(use_dst[:, None, None],
                           _itx_2d(coeff, DST4, bd_shift2), r_tx)

    ts_shift = 5 + log2_size
    rnd = 1 << (bd_shift2 - 1)
    r_skip = ((coeff << ts_shift) + rnd) >> bd_shift2
    return torch.where(tskip[:, None, None], r_skip, r_tx)


def residual_batch_by_channel(levels, fact, tskip, use_dst, log2_size: int,
                              bd: int, bdc: int, chroma, sf=None, qp=None):
    """residual_batch with every TU at its own channel's bit depth: luma
    rows at bd, the rows where chroma (bool [N] tensor; None when the two
    depths agree) is set at bdc.  One pass when the two depths agree, else
    one per depth."""
    res = residual_batch(levels, fact, tskip, use_dst, log2_size, bd, sf=sf,
                         qp=qp)
    if bdc == bd:
        return res
    res_c = residual_batch(levels, fact, tskip, use_dst, log2_size, bdc,
                           sf=sf, qp=qp)
    return torch.where(chroma[:, None, None], res_c, res)


def qp_to_fact(qp):
    """levelScale[qp % 6] << (qp / 6) for an int32 tensor of QPs."""
    ls = torch.as_tensor(LEVEL_SCALE, device=qp.device)
    return ls[(qp % 6).long()] << (qp // 6)


def scatter_coeffs(tus, coeff_val, coeff_pos, log2_size: int, idx, device):
    """Dense [len(idx), s, s] int32 levels of the TUs idx of one size bin
    from the program's sparse coefficient lists, scattered on `device`
    (one index_put for the whole bin)."""
    s = 1 << log2_size
    idx = np.asarray(idx, np.int64)
    n = tus["ncoeff"][idx].astype(np.int64)
    start = tus["coeff_start"][idx].astype(np.int64)
    k = np.repeat(np.arange(len(idx)), n)
    ent = np.repeat(start - np.cumsum(n) + n, n) + np.arange(int(n.sum()))
    pos = coeff_pos[ent].astype(np.int64)
    out = torch.zeros((len(idx), s, s), dtype=torch.int32, device=device)
    if len(ent):
        d = torch.as_tensor(np.stack([k, pos >> 6, pos & 63]), device=device)
        out[d[0], d[1], d[2]] = torch.as_tensor(
            coeff_val[ent].astype(np.int32), device=device)
    return out


def ccp_add(res, rows, scale, bd: int, bdc: int):
    """Cross-component prediction of one bin: res [N, S, S] int32 with
    res[i] += (scale[i] * ((res[rows[i]] << bdc) >> bd)) >> 3 wherever
    rows[i] >= 0 (the partner luma TU's row in the bin).  As the reference
    decoder computes it: the shifts are logical on uint32 and the product
    wraps at 32 bits, then the arithmetic >> 3 of its int32 value.  Done
    in int64 with the low 32 bits masked, as torch.uint32 has no shifts or
    products on every build."""
    r_y = res[rows.long().clamp(min=0)].long()
    term = (((r_y & 0xFFFFFFFF) << bdc) & 0xFFFFFFFF) >> bd
    # scale is in [-8, 8]: its signed product has the uint32 product's low
    # 32 bits and does not overflow int64
    prod = (scale.long()[:, None, None] * term) & 0xFFFFFFFF
    prod = torch.where(prod >= 1 << 31, prod - (1 << 32), prod)
    out = (res.long() + (prod >> 3)).to(torch.int32)
    return torch.where((rows >= 0)[:, None, None], out, res)
