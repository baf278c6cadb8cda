"""Kernels B6 (border gather) and B7 (window scatter) of the intra scan on
the padded plane (``csrc/intra.cu``), with their plain PyTorch versions.

Counterpart of ``libde265_tpu/ops/intra_window_pallas.py``, with its names:
the scan runs on a zero-padded copy of each plane (``PAD_T`` rows above,
``PAD_L`` columns to the left, slack below and to the right), so every
border sample of a block, out-of-picture ones included, lies inside the
padded plane.  Out-of-picture samples read the zero padding; their
availability bits are clear, so the substitution replaces them.

Replaces the TPU kernels ``border_gather`` (B6) and ``window_scatter``
(B7).  On the TPU both move whole (8, 128) tiles by DMA and place samples
with roll ladders; on the card a thread reads or writes one sample at its
address, so neither needs windows, grouping or compaction.  Both are bound
by device memory (and, at the scan's sizes, by launch latency): B6 moves
K*(4s+1) samples, B7 the valid blocks' pixels.  The decode runs their
device functions (``border_sample``, ``store_sample``) inside the
persistent scan kernel (``ops/intra_cuda.py``), one launch per picture;
the two kernels here are the TPU kernels' one-to-one counterparts, held
against their plain versions by ``chip_smoke.py`` and the `gpu` tests.
"""
from __future__ import annotations

import torch

from . import _build
from ._tensors import check, on_cuda, stream_of

PAD_T = 8     # rows of zero padding above the plane
PAD_L = 128   # columns of zero padding left of the plane

gather_launches = 0   # kernel launches since the last reset (chip_smoke)
scatter_launches = 0


def scan_pad_sizes(h: int, w: int):
    """Padded scan-plane shape (the JAX package's, so both pad alike):
    bottom-left border samples reach y0p + 2s - 1 and top-right ones
    x0p + 2s - 1, both inside it for every block of an h x w plane."""
    hp = (h + PAD_T + 2 * 32 + 8 + 7) & ~7
    wp = ((w + PAD_L + 127) // 128 + 2) * 128
    return hp, wp


def pad_plane_for_scan(plane, hp: int, wp: int):
    """Zero-padded copy of a plane in its scan layout."""
    h, w = plane.shape
    out = plane.new_zeros((hp, wp))
    out[PAD_T:PAD_T + h, PAD_L:PAD_L + w] = plane
    return out


def unpad_plane(padded, h: int, w: int):
    return padded[PAD_T:PAD_T + h, PAD_L:PAD_L + w]


def _check_s(name, s):
    if s not in (4, 8, 16, 32):
        raise ValueError(f"{name}: block size {s}")


def border_gather_plain(padded, y0p, x0p, nvalid, *, s: int):
    """Raw borders of K blocks of size s from the padded plane.

    y0p/x0p: [K] block origins in padded coordinates.  Returns (tops
    [K, 2s+1]: the corner, then the top row left to right; lefts [K, 2s]:
    the left column top to bottom).  Rows k >= nvalid are zero (the TPU
    kernel leaves clamped duplicates there); nothing reads them."""
    Hp, Wp = padded.shape
    dev = padded.device
    n2 = 2 * s
    flat = padded.reshape(-1)

    def at(y, x):
        return flat[y.clamp(0, Hp - 1).long() * Wp + x.clamp(0, Wp - 1).long()]

    j = torch.arange(n2 + 1, device=dev, dtype=torch.int32)
    tops = at((y0p - 1)[:, None].expand(-1, n2 + 1), x0p[:, None] - 1 + j)
    lefts = at(y0p[:, None] + j[None, :n2], (x0p - 1)[:, None].expand(-1, n2))
    keep = (torch.arange(y0p.shape[0], device=dev) < nvalid)[:, None]
    return torch.where(keep, tops, 0), torch.where(keep, lefts, 0)


def window_scatter_plain(padded, blocks, y0p, x0p, valid, *, s: int):
    """Write the valid ones of K [s, s] blocks into the padded plane at
    (y0p, x0p), in place; returns the plane.  The valid blocks of a step
    are disjoint."""
    Hp, Wp = padded.shape
    K = blocks.shape[0]
    ar = torch.arange(s, device=padded.device)
    rows = (y0p[:, None, None] + ar[None, :, None]).expand(K, s, s)
    cols = (x0p[:, None, None] + ar[None, None, :]).expand(K, s, s)
    ok = valid[:, None, None] & (rows >= 0) & (rows < Hp) & (cols >= 0) & \
        (cols < Wp)
    idx = rows.long() * Wp + cols.long()
    padded.view(-1)[idx[ok]] = blocks[ok].to(padded.dtype)
    return padded


def border_gather(padded, y0p, x0p, nvalid: int, *, s: int):
    """border_gather_plain's result (kernel B6 on a CUDA tensor, the plain
    version on a CPU tensor); nvalid is a host int."""
    global gather_launches
    if not on_cuda("border_gather", padded):
        return border_gather_plain(padded, y0p, x0p, nvalid, s=s)
    check("border_gather", padded.device, torch.int32, padded, y0p, x0p)
    _check_s("border_gather", s)
    K = y0p.shape[0]
    if padded.dim() != 2 or y0p.shape != (K,) or x0p.shape != (K,):
        raise ValueError("border_gather: padded must be 2-D, y0p/x0p [K]")
    tops = torch.empty((K, 2 * s + 1), dtype=torch.int32, device=y0p.device)
    lefts = torch.empty((K, 2 * s), dtype=torch.int32, device=y0p.device)
    if K == 0:
        return tops, lefts
    Hp, Wp = padded.shape
    rc = _build.lib().tde_border_gather(
        padded.data_ptr(), Hp, Wp, y0p.data_ptr(), x0p.data_ptr(), K,
        int(nvalid), s, tops.data_ptr(), lefts.data_ptr(), stream_of(padded))
    _build.check_launch("tde_border_gather", rc)
    gather_launches += 1
    return tops, lefts


def window_scatter(padded, blocks, y0p, x0p, valid, *, s: int):
    """window_scatter_plain (kernel B7 on a CUDA tensor, the plain version
    on a CPU tensor): valid blocks written in place; returns the plane."""
    global scatter_launches
    if not on_cuda("window_scatter", padded):
        return window_scatter_plain(padded, blocks, y0p, x0p, valid, s=s)
    check("window_scatter", padded.device, torch.int32, padded, blocks, y0p,
          x0p)
    check("window_scatter", padded.device, torch.bool, valid)
    _check_s("window_scatter", s)
    K = blocks.shape[0]
    if (padded.dim() != 2 or blocks.shape != (K, s, s) or
            any(t.shape != (K,) for t in (y0p, x0p, valid))):
        raise ValueError("window_scatter: padded 2-D, blocks [K, s, s], "
                         "y0p/x0p/valid [K]")
    if K == 0:
        return padded
    Hp, Wp = padded.shape
    rc = _build.lib().tde_window_scatter(
        padded.data_ptr(), Hp, Wp, blocks.data_ptr(), y0p.data_ptr(),
        x0p.data_ptr(), valid.data_ptr(), K, s, stream_of(padded))
    _build.check_launch("tde_window_scatter", rc)
    scatter_launches += 1
    return padded
