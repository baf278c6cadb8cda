"""Kernel B4: CSR coefficient densify (``csrc/coef.cu``) and its plain
PyTorch version.

Replaces the TPU kernel ``libde265_tpu/ops/coef_pallas.py:densify_bin``.
``densify_bins`` densifies all TU size bins of a picture in one launch into
one buffer: each CTA decodes a tile of consecutive TUs of one bin into
shared memory and stores the whole tile, so every level is written once
and the buffer comes from ``torch.empty``.  The buffer ends in one scratch
element (set to 0) for the caller's escape corrections.  Bound by device
memory: the store of the dense levels is nearly all of the bytes.
"""
from __future__ import annotations

import ctypes as ct

import torch

from . import _build
from ._tensors import check, on_cuda, stream_of

launches = 0  # kernel launches since the last reset (read by chip_smoke)
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
