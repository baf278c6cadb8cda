"""Kernel B1: the feed expander (``csrc/expand.cu``) and its plain PyTorch
versions.

The host uploads only the picture feed's blocks of ``B`` words that hold
a nonzero word, plus a map; the device rebuilds the zero-padded feed.
Replaces the TPU kernel ``libde265_tpu/fused_decode.py:
_expand_blocks_pallas``, which takes the inverse map ``inv [nb]`` (output
block -> compact row, -1 = zeros); ``_expand_blocks`` is the JAX
package's XLA form, a scatter by the forward map ``idx [M]`` (compact row
-> output block, padding rows >= nb dropped).
"""
from __future__ import annotations

import ctypes as ct

import torch

from . import _build
from ._tensors import check, on_cuda, stream_of

launches = 0  # kernel launches since the last reset (read by chip_smoke)
# (threads a CTA, output blocks a CTA): from scripts/torch_section.py
# --sweep expand on the 1080p P picture's call
TILE = (64, 1)


class _Args(ct.Structure):    # csrc/expand.cu Args
    _fields_ = [("blocks", ct.c_void_p), ("inv", ct.c_void_p),
                ("out", ct.c_void_p), ("total", ct.c_longlong),
                ("M", ct.c_int), ("nb", ct.c_int), ("B", ct.c_int),
                ("threads", ct.c_int), ("per", ct.c_int)]


def expand_blocks_plain(blocks, inv, *, total: int, B: int):
    """[total] int32: output block b is blocks[inv[b]] (zeros where
    inv[b] < 0), the last block cut at total."""
    nb = (total + B - 1) // B
    M = blocks.shape[0]
    rows = torch.cat([blocks.reshape(M, B), blocks.new_zeros((1, B))])
    sel = torch.where(inv[:nb] >= 0, inv[:nb].long(), M).clamp(max=M)
    return rows[sel].reshape(-1)[:total]


def _expand_blocks(blocks, idx, *, total: int, B: int):
    """The XLA scatter form: block idx[m] of the zero-filled feed is
    blocks[m]; rows whose idx is outside [0, nb) are dropped."""
    nb = (total + B - 1) // B
    full = blocks.new_zeros((nb + 1, B))
    ok = (idx >= 0) & (idx < nb)
    full[torch.where(ok, idx.long(), nb)] = blocks.reshape(-1, B)
    return full[:nb].reshape(-1)[:total]


def expand_blocks(blocks, inv, *, total: int, B: int):
    """Kernel B1 on a CUDA tensor, expand_blocks_plain on a CPU tensor.

    blocks: [M, B] int32 compact blocks; inv: [nb] int32.  On the card B
    must be a multiple of 4 and blocks 16-byte aligned (the kernel moves 16
    bytes at a time), else ValueError."""
    global launches
    if not on_cuda("expand_blocks", blocks):
        return expand_blocks_plain(blocks, inv, total=total, B=B)
    check("expand_blocks", blocks.device, torch.int32, blocks, inv)
    nb = (total + B - 1) // B
    if blocks.dim() != 2 or blocks.shape[1] != B or inv.shape != (nb,):
        raise ValueError(f"expand_blocks: blocks {tuple(blocks.shape)}, inv "
                         f"{tuple(inv.shape)} for total={total}, B={B}")
    src = blocks.data_ptr()
    if B % 4 or src % 16:
        raise ValueError(f"expand_blocks: B={B} must be a multiple of 4 and "
                         f"blocks 16-byte aligned (address {src:#x})")
    out = blocks.new_empty(total)
    if total == 0:
        return out
    a = _Args(src, inv.data_ptr(), out.data_ptr(), total, blocks.shape[0],
              nb, B, *TILE)
    rc = _build.lib().tde_expand_blocks(ct.addressof(a), stream_of(blocks))
    _build.check_launch("tde_expand_blocks", rc)
    launches += 1
    return out
