"""Kernel B4: CSR coefficient densify (``csrc/coef.cu``), and the residual
bins kernel after it: dequantisation and inverse transform of the densified
levels; each with its plain PyTorch version.

B4 replaces the TPU kernel ``libde265_tpu/ops/coef_pallas.py:densify_bin``.
``densify_bins`` densifies all TU size bins of a picture in one launch into
one buffer: each CTA decodes a tile of consecutive TUs of one bin into
shared memory and stores the whole tile, so every level is written once
and the buffer comes from ``torch.empty``.  The buffer ends in one scratch
element (set to 0) for the plain version's escape corrections.  Bound by
device memory: the store of the dense levels is nearly all of the bytes.

``residual_bins`` turns that buffer's levels into residuals in place, every
bin in one launch (the JAX program does this with XLA ops, in
``libde265_tpu/ops/transform.py``): the escape corrections, dequantisation
at each TU's channel depth (flat or scaling list), the int32 inverse DCT
(DST for flagged 4x4 TUs), transform skip, bypass and RDPCM.  Its plain
version is the per-bin composition of ``ops/transform.py``.  Bound by
device memory: each sample's level read and its residual written once.
"""
from __future__ import annotations

import ctypes as ct

import torch

from . import _build
from . import transform as tx
from ..decoder import (TU_RDPCM, TU_RDPCM_VERTICAL, TU_TQ_BYPASS,
                       TU_TRANSFORM_SKIP, TU_USE_DST)
from ._tensors import check, on_cuda, stream_of

launches = 0  # B4 launches since the last reset (read by chip_smoke)
transform_launches = 0  # residual_bins launches since the last reset
MAX_BINS = 4  # bins of one launch: the four TU sizes of a picture
# S -> (TUs of a CTA's shared-memory tile, lanes that decode one TU), and
# the threads of a CTA: from the sweep of scripts/torch_section.py on the
# 1080p P picture's bins, S = 8 and 16 (PERF.md); S = 4 and 32, which no
# 1080p picture of the in-repo encoder has, follow the same rule (one TU
# per lane group, 4 lanes up to S = 8, 32 above).
TILE = {4: (32, 4), 8: (32, 4), 16: (4, 32), 32: (4, 32)}
THREADS = 128


class _Bin(ct.Structure):      # csrc/coef.cu Bin
    _fields_ = [("cv", ct.c_void_p), ("coff", ct.c_void_p),
                ("n_entries", ct.c_longlong), ("out_off", ct.c_longlong),
                ("N", ct.c_int), ("S", ct.c_int), ("tus", ct.c_int),
                ("lanes", ct.c_int), ("first_cta", ct.c_int)]


class _Args(ct.Structure):     # csrc/coef.cu Args
    _fields_ = [("bin", _Bin * MAX_BINS), ("nbins", ct.c_int),
                ("out", ct.c_void_p), ("total", ct.c_longlong),
                ("threads", ct.c_int)]


class _ResBin(ct.Structure):   # csrc/coef.cu ResBin
    _fields_ = [("res", ct.c_void_p), ("qp", ct.c_void_p),
                ("flags", ct.c_void_p), ("mid", ct.c_void_p),
                ("cidx", ct.c_void_p), ("cfx", ct.c_void_p),
                ("cfv", ct.c_void_p), ("sf", ct.c_void_p),
                ("n_cf", ct.c_int), ("n_sf", ct.c_int), ("N", ct.c_int),
                ("lg", ct.c_int), ("first_cta", ct.c_int)]


class _ResArgs(ct.Structure):  # csrc/coef.cu ResArgs
    _fields_ = [("bin", _ResBin * MAX_BINS), ("nbins", ct.c_int),
                ("bd", ct.c_int), ("bdc", ct.c_int)]


def densify_bin_plain(cv, coff, N: int, S: int):
    """The JAX package's XLA formulation (fused_decode._expand_feed's
    cumsum/searchsorted position recovery + the dense scatter), in PyTorch,
    with positions >= S*S dropped, as the TPU kernel and the oracle
    (coef_pallas.densify_ref) drop them (the XLA form clamps them to
    S*S - 1; no feed the packer makes has one).

    cv:   [Wd] int32, four 8-bit delta entries per word, CSR-ordered.
    coff: [>= N+1] int32 per-TU ENTRY offsets (padded rows repeat the total).
    Returns int32 [N, S, S] levels.
    """
    dev = cv.device
    ent = torch.stack([(cv >> (8 * h)) & 0xFF for h in range(4)],
                      dim=1).reshape(-1)
    cval = ((ent >> 4) ^ 8) - 8
    step = torch.where(cval == 0, 15, (ent & 0xF) + 1)
    i = torch.arange(ent.shape[0], device=dev, dtype=torch.int32)
    crow = torch.searchsorted(coff, i, right=True).to(torch.int64) - 1
    c = torch.cumsum(step, 0)
    c_excl = torch.cat([c.new_zeros(1), c])
    start = coff[crow.clamp(min=0)].long().clamp(0, c.shape[0])
    pos = c - c_excl[start] - 1
    ok = (i < coff[-1]) & (cval != 0) & (crow >= 0) & (crow < N) & \
        (pos < S * S)
    p10 = pos.clamp(0, S * S - 1)
    # dropped entries land in a trailing scratch element
    flat = torch.where(ok, crow * (S * S) + p10, N * S * S)
    levels = torch.zeros(N * S * S + 1, dtype=torch.int32, device=dev)
    levels.index_put_((flat,), cval.to(torch.int32))
    return levels[:-1].view(N, S, S)


def _views(buf, bins):
    out, off = [], 0
    for _, _, N, S in bins:
        out.append(buf[off:off + N * S * S].view(N, S, S))
        off += N * S * S
    return out


def densify_bins_plain(bins):
    """Plain version of densify_bins: densify_bin_plain per bin, the
    levels laid one bin after another, then a zero scratch element."""
    parts = [densify_bin_plain(cv, coff, N, S).reshape(-1)
             for cv, coff, N, S in bins]
    buf = torch.cat(parts + [torch.zeros(1, dtype=torch.int32,
                                         device=bins[0][0].device)])
    return buf, _views(buf, bins)


def _check_bins(bins):
    if not 1 <= len(bins) <= MAX_BINS:
        raise ValueError(f"densify_bins: {len(bins)} bins, expected 1 to "
                         f"{MAX_BINS}")
    for cv, coff, N, S in bins:
        if S not in TILE:
            raise ValueError(f"densify_bins: S={S}")
        if cv.dim() != 1 or coff.dim() != 1 or N < 0 or \
                coff.shape[0] < N + 1:
            raise ValueError(f"densify_bins: bad shapes cv "
                             f"{tuple(cv.shape)}, coff {tuple(coff.shape)} "
                             f"for N={N}")


def densify_bins(bins):
    """Dense levels of a picture's TU size bins (kernel B4, one launch, on
    CUDA tensors; the plain version on CPU tensors).

    bins: [(cv, coff, N, S), ...], at most four, as densify_bin takes them.
    Returns (buf, views): buf is int32 [sum N*S*S + 1], the bins' levels
    one after another and a scratch element 0; views[i] is bin i's
    [N, S, S] levels, a view of buf."""
    global launches
    bins = [(cv, coff, int(N), int(S)) for cv, coff, N, S in bins]
    _check_bins(bins)
    if not on_cuda("densify_bins", bins[0][0]):
        return densify_bins_plain(bins)
    dev = bins[0][0].device
    for cv, coff, _, _ in bins:
        check("densify_bins", dev, torch.int32, cv, coff)
    total = sum(N * S * S for _, _, N, S in bins)
    buf = torch.empty(total + 1, dtype=torch.int32, device=dev)
    a = _Args(nbins=len(bins), out=buf.data_ptr(), total=total,
              threads=THREADS)
    off = 0
    for i, (cv, coff, N, S) in enumerate(bins):
        tus, lanes = TILE[S]
        a.bin[i] = _Bin(cv.data_ptr(), coff.data_ptr(), 4 * cv.shape[0], off,
                        N, S, tus, lanes, 0)
        off += N * S * S
    rc = _build.lib().tde_densify_bins(ct.addressof(a), stream_of(buf))
    _build.check_launch("tde_densify_bins", rc)
    launches += 1
    return buf, _views(buf, bins)


def densify_bin(cv, coff, N: int, S: int):
    """Dense [N, S, S] int32 levels of one size bin's CSR coefficient feed:
    densify_bins on that one bin."""
    return densify_bins([(cv, coff, N, S)])[1][0]


def _add_escapes(buf, off: int, n: int, cfx, cfv):
    """Escape corrections of one bin, in place: buf[off + cfx] += cfv where
    0 <= cfx < n (the bin's levels start at buf[off]); the rest, padding
    rows (cfx = -1) among them, go to buf's last element, the scratch.  The
    4-bit wire value clamps a level to +-7; cfv is the full-precision
    delta.  Positions are distinct within a bin and integer adds commute,
    so this equals the JAX program's `levels.at[...].add(cfv,
    mode="drop")`."""
    ok = (cfx >= 0) & (cfx < n)
    buf.index_add_(0, torch.where(ok, cfx + off, buf.shape[0] - 1), cfv)


def _rdpcm(base, flags, tskip, bypass):
    """RDPCM of one bin: the residual of a TU flagged TU_RDPCM with
    transform skip or bypass becomes its prefix sums down the columns
    (TU_RDPCM_VERTICAL) or along the rows."""
    rd = ((flags & TU_RDPCM) != 0) & (tskip | bypass)
    vert = (flags & TU_RDPCM_VERTICAL) != 0
    cs = torch.where(vert[:, None, None],
                     torch.cumsum(base, 1, dtype=torch.int32),
                     torch.cumsum(base, 2, dtype=torch.int32))
    return torch.where(rd[:, None, None], cs, base)


def _level_views(buf, bins):
    return _views(buf, [(None, None, bf["qp"].shape[0], 1 << lg)
                        for lg, bf in bins])


def residual_bins_plain(buf, bins, bd: int, bdc: int, sf_tables=None):
    """Plain version of residual_bins, per bin: the escape corrections into
    buf (in place), tx.residual_batch_by_channel, the levels where a TU
    bypasses transform and quantisation, RDPCM.  Returns the residuals
    (new tensors)."""
    out, off = [], 0
    for (lg, bf), levels in zip(bins, _level_views(buf, bins)):
        if "cfx" in bf:
            _add_escapes(buf, off, levels.numel(), bf["cfx"], bf["cfv"])
        off += levels.numel()
        flags = bf["flags"]
        tskip = (flags & TU_TRANSFORM_SKIP) != 0
        use_dst = (flags & TU_USE_DST) != 0
        bypass = (flags & TU_TQ_BYPASS) != 0
        kw = {}
        if sf_tables is not None:
            kw = dict(sf=sf_tables[lg - 2][bf["mid"].long()], qp=bf["qp"])
        # the feed ships the channels (cidx) only where the depths differ
        res = tx.residual_batch_by_channel(
            levels, tx.qp_to_fact(bf["qp"]), tskip, use_dst, lg, bd,
            bdc if "cidx" in bf else bd,
            bf["cidx"] != 0 if "cidx" in bf else None, **kw)
        base = torch.where(bypass[:, None, None], levels, res)
        out.append(_rdpcm(base, flags, tskip, bypass))
    return out


def _check_residual(buf, bins, bd, bdc, sf_tables):
    def bad(what):
        raise ValueError(f"residual_bins: {what}")

    def vec(name, t, n):
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape[0] != n or \
                t.device != buf.device or not t.is_contiguous():
            bad(f"{name} is {t.dtype} {tuple(t.shape)} on {t.device}, "
                f"expected contiguous int32 ({n},) on {buf.device}")

    if buf.dtype != torch.int32 or buf.dim() != 1 or \
            not buf.is_contiguous():
        bad(f"buf is {buf.dtype} {tuple(buf.shape)}, expected contiguous "
            f"int32 1-D")
    if buf.data_ptr() % 16:
        bad("buf is not 16-byte aligned")
    if not 1 <= len(bins) <= MAX_BINS:
        bad(f"{len(bins)} bins, expected 1 to {MAX_BINS}")
    if not (8 <= bd <= 16 and 8 <= bdc <= 16):
        bad(f"bit depths {bd}, {bdc}")
    total = 0
    for lg, bf in bins:
        if lg not in (2, 3, 4, 5):
            bad(f"log2 size {lg}")
        if not {"qp", "flags", "mid"} <= bf.keys():
            bad(f"bin {lg} lacks one of qp, flags and mid")
        n = bf["qp"].shape[0]
        for k in ("qp", "flags", "mid", "cidx"):
            if k in bf:
                vec(f"bin {lg} {k}", bf[k], n)
        if ("cfx" in bf) != ("cfv" in bf):
            bad(f"bin {lg} has one of cfx and cfv")
        if "cfx" in bf:
            for k in ("cfx", "cfv"):
                vec(f"bin {lg} {k}", bf[k], bf["cfx"].shape[0])
        if sf_tables is not None:
            sf, S = sf_tables[lg - 2], 1 << lg
            if sf.dtype != torch.int32 or sf.dim() != 3 or \
                    sf.shape[0] < 1 or tuple(sf.shape[1:]) != (S, S) or \
                    sf.device != buf.device or not sf.is_contiguous():
                bad(f"sf_tables[{lg - 2}] is {sf.dtype} {tuple(sf.shape)}")
        total += n << (2 * lg)
    if buf.shape[0] != total + 1:
        bad(f"buf has {buf.shape[0]} elements, the bins {total} + 1")


def residual_bins(buf, bins, bd: int, bdc: int, sf_tables=None):
    """Residuals of a picture's TU size bins from densify_bins' buffer (one
    launch on CUDA tensors; the plain version on CPU tensors).

    buf: int32 [sum N*S*S + 1], densify_bins' buffer (16-byte aligned).
    bins: [(lg, bin), ...] in buf's order, at most four; bin holds the
    feed's int32 [N] fields "qp" (QP'), "flags" (decoder.TU_*), "mid" (the
    TU's row of sf_tables[lg - 2]) and, where luma and chroma depths
    differ, "cidx" (a TU with cidx != 0 at bdc, the others at bd); and
    optionally the escape corrections "cfx" (positions in the bin, sorted
    ascending, padding rows -1 last) and "cfv".  sf_tables: None (flat
    dequantisation) or four int32 [M, S, S] tables, lg 2 to 5.
    Returns each bin's [N, S, S] residuals: on CUDA written over the
    levels in buf (views of it), on the CPU new tensors."""
    global transform_launches
    _check_residual(buf, bins, bd, bdc, sf_tables)
    if not on_cuda("residual_bins", buf):
        return residual_bins_plain(buf, bins, bd, bdc, sf_tables)
    a = _ResArgs(nbins=len(bins), bd=bd, bdc=bdc)
    ptr, off = buf.data_ptr(), 0
    for i, (lg, bf) in enumerate(bins):
        n = bf["qp"].shape[0]
        cf, sf = bf.get("cfx"), None
        if sf_tables is not None:
            sf = sf_tables[lg - 2]
        a.bin[i] = _ResBin(
            ptr + 4 * off, bf["qp"].data_ptr(), bf["flags"].data_ptr(),
            bf["mid"].data_ptr(),
            bf["cidx"].data_ptr() if "cidx" in bf else None,
            None if cf is None else cf.data_ptr(),
            None if cf is None else bf["cfv"].data_ptr(),
            None if sf is None else sf.data_ptr(),
            0 if cf is None else cf.shape[0],
            0 if sf is None else sf.shape[0], n, lg, 0)
        off += n << (2 * lg)
    rc = _build.lib().tde_residual_bins(ct.addressof(a), stream_of(buf))
    _build.check_launch("tde_residual_bins", rc)
    transform_launches += 1
    return _level_views(buf, bins)
