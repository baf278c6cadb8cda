"""Segment motion compensation (kernel B3), the per-cell PU index paint (B2)
and the residual band stripes (B5): ``csrc/mc.cu`` and the plain PyTorch
versions, with the host planning that feeds them.

The counterpart of ``libde265_tpu/ops/mc_pallas.py``, with its names.  A
*segment* is the intersection of one inter PU with one band of four luma
rows: one motion vector, one reference slot and one filter phase, so its
reference window is one rectangle of the padded DPB ring.  The feed ships
only the PU index of each segment; its window origin, phases and placement
are re-derived from the PU record, as ``mc_pallas.seg_params`` does.

References live in a ring of ``2*MAX_REFS+1`` replicate-padded slots per
plane, stacked as ``[slots*Hpad, Wpad]`` (``pad_sizes``); a window origin
is clamped so that it stays inside the padding.

The kernels read the 5-word wire PU SoA ``[Pcap, 5]`` (``pus_to_wire``)
directly.  The TPU kernels need ``pack_pu_mc`` and ``pack_pu_geo`` only
because Mosaic pads scalar memory to (8, 128) tiles; a CUDA thread reads a
PU's words at their addresses, so the port has no use for the folds.

Segments of one band are disjoint (PUs, and TUs, partition the picture),
so B3 writes a stripe from many CTAs without atomics;
``tests/test_torch_fused_decode.py`` checks that on the test streams'
feeds.  Beyond ``nseg[band]`` a band's index words are padding (PU 0) and
are never read.  B5 and B2 give each band (and B5 each 1024-lane tile of
its stripe) one CTA that writes every lane of its output once, so their
outputs are allocated without a fill.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build
from ._tensors import check, on_cuda, stream_of
from .mc import EPEL_FILTERS, QPEL_FILTERS

# replicate padding of each reference plane inside the ring: a window
# origin is clamped to >= -(w + taps - 2) >= -70 columns and
# >= -(OR + taps - 2) >= -10 rows
PADL = 128
PADR = 256
PADT = 16
FW = 256            # the TPU kernel's fetched lanes per segment window

# kernel launches since the last reset (read by chip_smoke)
mc_launches = 0
paint_launches = 0
residual_launches = 0


def pad_sizes(h: int, w: int):
    """Padded plane size of one ring slot."""
    hp = h + PADT + 48
    hp = (hp + 7) & ~7
    wp = (w + PADL + PADR + 127) & ~127
    return hp, wp


# ---------------------------------------------------------------------------
# host planning (numpy; word for word the JAX package's)
# ---------------------------------------------------------------------------

def plan_segment_indices(pus: np.ndarray, list_idx: int, H: int):
    """Explode the PUs of one reference list into per-band segments.

    Returns per-band counts [n_bands], sidx [n_bands, ceil(K/2)] with two
    16-bit PU indices per int32 word (band-major, PU emission order), and
    K, the most segments of a band."""
    n_bands = (H + 3) // 4
    sel = np.nonzero((pus["pred_flags"] & (1 << list_idx)) != 0)[0] \
        if len(pus) else np.zeros(0, np.int64)
    if not len(sel):
        return (np.zeros(n_bands, np.int32),
                np.zeros((n_bands, 1), np.int32), 1)

    p = pus[sel]
    y = p["y"].astype(np.int32)
    rows = p["h"].astype(np.int32) >> 2
    tot = int(rows.sum())
    pidx = np.repeat(sel.astype(np.int32), rows)
    within = np.arange(tot) - np.repeat(np.cumsum(rows) - rows, rows)
    band = np.repeat(y >> 2, rows) + within

    order = np.argsort(band, kind="stable")
    bs = band[order]
    first = np.searchsorted(bs, bs)
    k_of = np.arange(tot) - first
    K = int(k_of.max()) + 1 if tot else 1
    counts = np.zeros(n_bands, np.int32)
    np.add.at(counts, band, 1)

    sw = np.zeros((n_bands, (K + 1) // 2), np.int32)
    np.bitwise_or.at(sw, (bs, k_of >> 1),
                     pidx[order] << (16 * (k_of & 1)))
    return counts, sw, K


def pus_to_wire(pus: np.ndarray, slot_map=None):
    """The 5-word wire PU SoA: mv0 (x|y<<16), mv1, meta (pf | slot0<<2 |
    slot1<<8 | ridx0<<14 | ridx1<<18), slice, geo (x/4 | y/4<<11 |
    (w/4-1)<<22 | (h/4-1)<<27)."""
    n = len(pus)
    pu = np.zeros((max(n, 1), 5), np.int32)
    if not n:
        return pu
    p = pus
    pu[:n, 0] = (p["mv0x"].astype(np.int32) & 0xFFFF) | \
        (p["mv0y"].astype(np.int32) << 16)
    pu[:n, 1] = (p["mv1x"].astype(np.int32) & 0xFFFF) | \
        (p["mv1y"].astype(np.int32) << 16)
    meta = p["pred_flags"].astype(np.int32) & 3
    for l in (0, 1):
        raw = p[f"ref_dpb{l}"].astype(np.int32)
        if slot_map is not None:
            slot = np.array([slot_map.get(int(v), 0) for v in raw], np.int32)
        else:
            slot = np.maximum(raw, 0)
        meta |= (slot & 63) << (2 + 6 * l)
        meta |= (np.maximum(p[f"ref_idx{l}"].astype(np.int32), 0)
                 & 15) << (14 + 4 * l)
    pu[:n, 2] = meta
    pu[:n, 3] = p["slice"]
    pu[:n, 4] = (p["x"].astype(np.int32) >> 2) | \
        ((p["y"].astype(np.int32) >> 2) << 11) | \
        (((p["w"].astype(np.int32) >> 2) - 1) << 22) | \
        (((p["h"].astype(np.int32) >> 2) - 1) << 27)
    return pu


def plan_residual_segments(sc: np.ndarray, s: int, OR: int):
    """Explode one bin's scatter list [n, 3] (row, x, y) into per-band
    segments: (band, srow, x0) arrays [n_seg]."""
    if len(sc) == 0:
        return (np.zeros(0, np.int32),) * 3
    rows, xs, ys = sc[:, 0], sc[:, 1], sc[:, 2]
    keep = rows >= 0
    rows, xs, ys = rows[keep], xs[keep], ys[keep]
    per = s // OR                     # bands spanned by one TU
    band = (ys[:, None] // OR + np.arange(per)[None, :]).ravel()
    srow = (rows[:, None] * per + np.arange(per)[None, :]).ravel()
    x0 = np.repeat(xs, per)
    return band.astype(np.int32), srow.astype(np.int32), x0.astype(np.int32)


def pack_band_segments(band, srow, x0, n_bands: int):
    """Group segments by band: counts [n_bands], words [n_bands, K]
    (srow (20 bits) | x0/2 (12 bits) << 20) and K."""
    order = np.argsort(band, kind="stable")
    bs = band[order]
    first = np.searchsorted(bs, bs)
    k_of = np.arange(len(bs)) - first
    K = int(k_of.max()) + 1 if len(bs) else 1
    counts = np.zeros(n_bands, np.int32)
    if len(bs):
        np.add.at(counts, bs, 1)
    out_w = np.zeros((n_bands, K), np.int32)
    out_w[bs, k_of] = (srow[order] & 0xFFFFF) | \
        (((x0[order] >> 1) & 0xFFF) << 20)
    return counts, out_w, K


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _wrap16(v):
    return v.to(torch.int16).to(torch.int32)


def _segments(nseg, sidx, kmax: int):
    """(band, PU index) of every segment k < min(nseg[band], kmax), band
    by band in order."""
    k = torch.arange(min(kmax, 2 * sidx.shape[1]), device=nseg.device)
    live = k[None, :] < nseg[:, None]
    band, kk = torch.nonzero(live, as_tuple=True)
    word = sidx[band, kk >> 1]
    idx = (word >> ((kk & 1) * 16)) & 0xFFFF
    return band, idx


def seg_params(pu, idx, band, list_idx: int, *, OR: int, T: int, Hpad: int,
               chroma: bool, Hdim: int, Wdim: int, sub_x: int, sub_y: int):
    """Per segment (ring row, padded column of the window origin, fy, fx,
    output column, width): mc_pallas.seg_params on tensors."""
    p = pu[idx.long()]
    mvw, meta, geo = p[:, list_idx], p[:, 2], p[:, 4]
    mvx = (mvw << 16) >> 16
    mvy = mvw >> 16
    slot = (meta >> (2 + 6 * list_idx)) & 63
    x = (geo & 0x7FF) * 4
    w = (((geo >> 22) & 0x1F) + 1) * 4
    if not chroma:
        oy = (4 * band + (mvy >> 2) - 3).clamp(-(4 + T - 2), Hdim - 1) + PADT
        ox = torch.maximum(x + (mvx >> 2) - 3,
                           -(w + T - 2)).clamp(max=Wdim - 1) + PADL
        return slot * Hpad + oy, ox, mvy & 3, mvx & 3, x, w
    shx = 3 if sub_x == 2 else 2
    shy = 3 if sub_y == 2 else 2
    fx = (mvx & 7) if sub_x == 2 else ((mvx & 3) << 1)
    fy = (mvy & 7) if sub_y == 2 else ((mvy & 3) << 1)
    cw = w // sub_x
    oy = ((4 // sub_y) * band + (mvy >> shy) - 1).clamp(
        -((4 // sub_y) + T - 2), Hdim - 1) + PADT
    ox = torch.maximum(x // sub_x + (mvx >> shx) - 1,
                       -(cw + T - 2)).clamp(max=Wdim - 1) + PADL
    return slot * Hpad + oy, ox, fy, fx, x // sub_x, cw


def mc_stripes_plain(refs2d, nseg, sidx, pu, *, list_idx: int, OR: int,
                     T: int, Hpad: int, Wout: int, n_bands: int, KMAX: int,
                     bd: int, chroma: bool = False, Hdim: int = 0,
                     Wdim: int = 0, sub_x: int = 2, sub_y: int = 2):
    """[n_bands, OR, Wout] int32 stripes of one list and plane class at the
    14-bit intermediate scale: the 8-tap (T=8, luma) or 4-tap (T=4, chroma)
    separable filter of every segment's window, the horizontal pass wrapped
    to int16 after >> (bd-8), the vertical after >> 6.  Lanes no segment
    covers stay 0."""
    dev = refs2d.device
    band, idx = _segments(nseg, sidx, KMAX)
    out = torch.zeros(n_bands * OR * Wout + 1, dtype=torch.int32, device=dev)
    if band.numel() == 0:
        return out[:-1].view(n_bands, OR, Wout)
    row, col, fy, fx, xs, ws = seg_params(
        pu, idx, band.to(torch.int32), list_idx, OR=OR, T=T, Hpad=Hpad,
        chroma=chroma, Hdim=Hdim, Wdim=Wdim, sub_x=sub_x, sub_y=sub_y)
    wmax = 64 // (sub_x if chroma else 1)
    nr, nc = OR + T - 1, wmax + T - 1
    rr = (row[:, None] + torch.arange(nr, device=dev)).clamp(
        0, refs2d.shape[0] - 1).long()
    cc = (col[:, None] + torch.arange(nc, device=dev)).clamp(
        0, refs2d.shape[1] - 1).long()
    win = refs2d[rr[:, :, None], cc[:, None, :]]          # [n, nr, nc]
    filt = torch.as_tensor(QPEL_FILTERS if T == 8 else EPEL_FILTERS,
                           device=dev)
    fh, fv = filt[fx.long()], filt[fy.long()]              # [n, T]
    th = sum(fh[:, k, None, None] * win[:, :, k:k + wmax] for k in range(T))
    th = _wrap16(th >> (bd - 8))
    tv = sum(fv[:, k, None, None] * th[:, k:k + OR, :] for k in range(T))
    pred = _wrap16(tv >> 6)                                # [n, OR, wmax]
    j = torch.arange(wmax, device=dev)
    r = torch.arange(OR, device=dev)
    ok = (j[None, None, :] < ws[:, None, None]).expand(-1, OR, -1)
    dst = (band[:, None, None].long() * OR + r[None, :, None]) * Wout + \
        (xs[:, None, None] + j[None, None, :]).long()
    dst = torch.where(ok, dst, n_bands * OR * Wout)
    out[dst.reshape(-1)] = pred.reshape(-1)
    return out[:-1].view(n_bands, OR, Wout)


def paint_pu_idx_plain(nseg2, sidx2, pu, *, n_bands: int, W4: int, L: int):
    """[n_bands, W4] per-cell PU index (-1 where no segment covers): list 0
    then list 1, segments in order, the last covering one wins.

    nseg2: [L, n_bands]; sidx2: [n_bands, L, KP]; pu: the wire SoA."""
    dev = pu.device
    out = torch.full((n_bands, W4), -1, dtype=torch.int32, device=dev)
    lane = torch.arange(W4, device=dev, dtype=torch.int32)
    for l in range(L):
        n = nseg2[l]
        for k in range(int(n.max().item()) if n.numel() else 0):
            word = sidx2[:, l, k >> 1]
            idx = (word >> ((k & 1) * 16)) & 0xFFFF
            geo = pu[idx.long().clamp(max=pu.shape[0] - 1), 4]
            x4 = geo & 0x7FF
            w4 = ((geo >> 22) & 0x1F) + 1
            m = (k < n)[:, None] & (lane[None, :] >= x4[:, None]) & \
                (lane[None, :] < (x4 + w4)[:, None])
            out = torch.where(m, idx[:, None], out)
    return out


def residual_stripes_plain(bin_res, nseg, sw, *, OR: int, S: int, Wout: int,
                           n_bands: int):
    """[n_bands, OR, Wout] stripes of one size bin's residual blocks: for
    segment word w of a band, srow = w & 0xFFFFF, xs = ((w >> 20) & 0xFFF)
    * 2, rows (srow % per) * OR .. + OR of block srow // per (per = S // OR)
    go to lanes xs .. xs + S."""
    dev = bin_res.device
    N = bin_res.shape[0]
    per = S // OR
    out = torch.zeros(n_bands * OR * Wout + 1, dtype=torch.int32, device=dev)
    k = torch.arange(sw.shape[1], device=dev)
    band, kk = torch.nonzero(k[None, :] < nseg[:, None], as_tuple=True)
    if band.numel():
        w = sw[band, kk]
        srow = (w & 0xFFFFF).long()
        xs = ((w >> 20) & 0xFFF).long() * 2
        rows = torch.cat([bin_res.reshape(N * per, OR, S),
                          bin_res.new_zeros((1, OR, S))])
        blk = rows[srow.clamp(max=N * per)]                 # [n, OR, S]
        r = torch.arange(OR, device=dev)
        c = torch.arange(S, device=dev)
        dst = (band[:, None, None] * OR + r[None, :, None]) * Wout + \
            xs[:, None, None] + c[None, None, :]
        out[dst.reshape(-1)] = blk.reshape(-1)
    return out[:-1].view(n_bands, OR, Wout)


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------

def mc_stripes(refs2d, nseg, sidx, pu, *, list_idx: int, OR: int, T: int,
               Hpad: int, Wout: int, n_bands: int, KMAX: int, bd: int,
               chroma: bool = False, Hdim: int = 0, Wdim: int = 0,
               sub_x: int = 2, sub_y: int = 2):
    """Kernel B3 on a CUDA tensor, mc_stripes_plain on a CPU tensor.

    refs2d: the ring [slots*Hpad, Wpad]; nseg [n_bands]; sidx [n_bands,
    KP] (two PU indices a word); pu: the wire SoA [Pcap, 5]."""
    global mc_launches
    kw = dict(list_idx=list_idx, OR=OR, T=T, Hpad=Hpad, Wout=Wout,
              n_bands=n_bands, KMAX=KMAX, bd=bd, chroma=chroma, Hdim=Hdim,
              Wdim=Wdim, sub_x=sub_x, sub_y=sub_y)
    if not on_cuda("mc_stripes", refs2d):
        return mc_stripes_plain(refs2d, nseg, sidx, pu, **kw)
    check("mc_stripes", refs2d.device, torch.int32, refs2d, nseg, sidx, pu)
    if (refs2d.dim() != 2 or nseg.shape != (n_bands,) or sidx.dim() != 2 or
            sidx.shape[0] != n_bands or pu.dim() != 2 or pu.shape[1] != 5 or
            T not in (4, 8) or (T == 8) == chroma or list_idx not in (0, 1)):
        raise ValueError("mc_stripes: bad shapes or arguments")
    out = torch.zeros((n_bands, OR, Wout), dtype=torch.int32,
                      device=refs2d.device)
    kmax = min(KMAX, 2 * sidx.shape[1])
    if n_bands == 0 or kmax == 0:
        return out
    rc = _build.lib().tde_mc_stripes(
        refs2d.data_ptr(), refs2d.shape[0], refs2d.shape[1], nseg.data_ptr(),
        sidx.data_ptr(), sidx.shape[1], kmax, pu.data_ptr(), pu.shape[0],
        out.data_ptr(), n_bands, Wout, list_idx, OR, T, Hpad, bd,
        int(chroma), Hdim, Wdim, sub_x, sub_y, stream_of(refs2d))
    _build.check_launch("tde_mc_stripes", rc)
    mc_launches += 1
    return out


def paint_pu_idx(nseg2, sidx2, pu, *, n_bands: int, W4: int, L: int):
    """Kernel B2 on a CUDA tensor, paint_pu_idx_plain on a CPU tensor."""
    global paint_launches
    if not on_cuda("paint_pu_idx", pu):
        return paint_pu_idx_plain(nseg2, sidx2, pu, n_bands=n_bands, W4=W4,
                                  L=L)
    check("paint_pu_idx", pu.device, torch.int32, nseg2, sidx2, pu)
    if (nseg2.shape != (L, n_bands) or sidx2.dim() != 3 or
            sidx2.shape[:2] != (n_bands, L) or pu.dim() != 2 or
            pu.shape[1] != 5 or pu.shape[0] == 0 or
            L * 2 * sidx2.shape[2] > 32768 or W4 > 12288):
        raise ValueError("paint_pu_idx: bad shapes")
    out = torch.empty((n_bands, W4), dtype=torch.int32, device=pu.device)
    if out.numel() == 0:
        return out
    rc = _build.lib().tde_paint_pu_idx(
        nseg2.data_ptr(), sidx2.data_ptr(), sidx2.shape[2], pu.data_ptr(),
        pu.shape[0], out.data_ptr(), n_bands, W4, L, stream_of(pu))
    _build.check_launch("tde_paint_pu_idx", rc)
    paint_launches += 1
    return out


def residual_stripes(bin_res, nseg, sw, *, OR: int, S: int, Wout: int,
                     n_bands: int):
    """Kernel B5 on a CUDA tensor, residual_stripes_plain on a CPU
    tensor."""
    global residual_launches
    if not on_cuda("residual_stripes", bin_res):
        return residual_stripes_plain(bin_res, nseg, sw, OR=OR, S=S,
                                      Wout=Wout, n_bands=n_bands)
    check("residual_stripes", bin_res.device, torch.int32, bin_res, nseg, sw)
    if (bin_res.dim() != 3 or bin_res.shape[1:] != (S, S) or
            nseg.shape != (n_bands,) or sw.dim() != 2 or
            sw.shape[0] != n_bands or S not in (4, 8, 16, 32) or
            OR not in (1, 2, 4) or Wout % 4 or bin_res.numel() >= 1 << 31):
        raise ValueError("residual_stripes: bad shapes or arguments")
    # every lane is written by the kernel (zeros where no segment lies,
    # K = 0 included): no fill
    out = torch.empty((n_bands, OR, Wout), dtype=torch.int32,
                      device=bin_res.device)
    if out.numel() == 0:
        return out
    rc = _build.lib().tde_residual_stripes(
        bin_res.data_ptr(), bin_res.shape[0], S, nseg.data_ptr(),
        sw.data_ptr(), sw.shape[1], out.data_ptr(), n_bands, OR, Wout,
        stream_of(bin_res))
    _build.check_launch("tde_residual_stripes", rc)
    residual_launches += 1
    return out
