"""Kernel B10: per-sample SAO (``csrc/sao.cu``) and its plain PyTorch
version.

Replaces the TPU kernel ``libde265_tpu/ops/sao_pallas.py:sao_plane_fused``
(with its neighbour pre-pass ``sao_neighbors_jnp``), at the same function
boundary.  One thread per sample resolves its edge-class neighbours itself;
the pass is bound by device memory (the per-sample maps).
"""
from __future__ import annotations

import torch

from . import _build
from ._tensors import check, on_cuda, stream_of
from .sao import sao_plane

launches = 0  # kernel launches since the last reset (read by chip_smoke)


def sao_plane_fused(plane, tmap, emap, bmap, omap, skip, bit_depth: int = 8,
                    edge_ok=None):
    """SAO of one plane; drop-in for ops.sao.sao_plane (kernel B10 on a
    CUDA tensor, the plain version on a CPU tensor).

    plane/tmap/emap/bmap: [H, W] int32; omap: [H, W, 4] int32;
    skip: [H, W] bool; edge_ok: optional [H, W] bool."""
    global launches
    if not on_cuda("sao_plane_fused", plane):
        return sao_plane(plane, tmap, emap, bmap, omap, skip, bit_depth,
                         edge_ok)
    check("sao_plane_fused", plane.device, torch.int32, plane, tmap, emap,
          bmap, omap)
    masks = (skip,) if edge_ok is None else (skip, edge_ok)
    check("sao_plane_fused", plane.device, torch.bool, *masks)
    H, W = plane.shape
    for t in (tmap, emap, bmap, *masks):
        if t.shape != (H, W):
            raise ValueError("sao_plane_fused: map shapes differ")
    if omap.shape != (H, W, 4):
        raise ValueError("sao_plane_fused: omap must be [H, W, 4]")
    out = torch.empty_like(plane)
    rc = _build.lib().tde_sao_plane(
        plane.data_ptr(), tmap.data_ptr(), emap.data_ptr(), bmap.data_ptr(),
        omap.data_ptr(), skip.data_ptr(),
        edge_ok.data_ptr() if edge_ok is not None else None,
        out.data_ptr(), H, W, bit_depth, stream_of(plane))
    _build.check_launch("tde_sao_plane", rc)
    launches += 1
    return out
