"""Kernel B4: CSR coefficient densify (``csrc/coef.cu``) and its plain
PyTorch version.

Replaces the TPU kernel ``libde265_tpu/ops/coef_pallas.py:densify_bin``.
On the card it is bound by device memory: the zero fill of the dense
[N, S, S] output outweighs the ~1 byte per coefficient it reads.  One warp
per TU turns the delta-coded positions into absolute ones with a warp scan.
"""
from __future__ import annotations

import torch

from . import _build
from ._tensors import check, on_cuda, stream_of

launches = 0  # kernel launches since the last reset (read by chip_smoke)


def densify_bin_plain(cv, coff, N: int, S: int):
    """The JAX package's XLA formulation (fused_decode._expand_feed's
    cumsum/searchsorted position recovery + the dense scatter), in PyTorch.

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
    ok = (i < coff[-1]) & (cval != 0) & (crow >= 0) & (crow < N)
    p10 = pos.clamp(0, S * S - 1)
    # dropped entries land in a trailing scratch element
    flat = torch.where(ok, crow * (S * S) + p10, N * S * S)
    levels = torch.zeros(N * S * S + 1, dtype=torch.int32, device=dev)
    levels.index_put_((flat,), cval.to(torch.int32))
    return levels[:-1].view(N, S, S)


def densify_bin(cv, coff, N: int, S: int):
    """Dense [N, S, S] int32 levels of one size bin's CSR coefficient feed
    (kernel B4 on a CUDA tensor, the plain version on a CPU tensor)."""
    global launches
    if not on_cuda("densify_bin", cv):
        return densify_bin_plain(cv, coff, N, S)
    check("densify_bin", cv.device, torch.int32, cv, coff)
    if coff.dim() != 1 or coff.shape[0] < N + 1 or cv.dim() != 1:
        raise ValueError(f"densify_bin: bad shapes cv {tuple(cv.shape)}, "
                         f"coff {tuple(coff.shape)} for N={N}")
    if S not in (4, 8, 16, 32):
        raise ValueError(f"densify_bin: S={S}")
    out = torch.zeros((N, S, S), dtype=torch.int32, device=cv.device)
    if N == 0:
        return out
    rc = _build.lib().tde_densify(cv.data_ptr(), cv.shape[0], coff.data_ptr(),
                                  out.data_ptr(), N, S, stream_of(cv))
    _build.check_launch("tde_densify", rc)
    launches += 1
    return out
