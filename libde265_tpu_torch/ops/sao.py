"""Sample-adaptive offset (spec 8.7.3): tables and the plain PyTorch pass.

Port of ``libde265_tpu/ops/sao.py``.  ``sao_plane`` is the plain version of
the Hopper kernel wrapped in ``sao_cuda`` and the CPU path of the port;
``upsample_ctb_params`` and ``edge_boundary_ok`` build its per-sample maps
from the per-CTB parameters, on the device of the plane.
"""
from __future__ import annotations

import numpy as np
import torch

# edge class neighbor offsets (dy, dx) pairs
EO_D = np.array([[[0, -1], [0, 1]],
                 [[-1, 0], [1, 0]],
                 [[-1, -1], [1, 1]],
                 [[1, -1], [-1, 1]]], dtype=np.int32)
EDGE_CAT = np.array([1, 2, 0, 3, 4], dtype=np.int32)


def sao_plane(src, type_map, eo_class_map, band_pos_map, offsets_map,
              skip_map, bit_depth: int = 8, edge_ok=None):
    """Apply SAO to one plane.

    src:          [H, W] int32 (deblocked input)
    type_map:     [H, W] int32 (0 none, 1 band, 2 edge)
    eo_class_map: [H, W] int32 (0..3)
    band_pos_map: [H, W] int32
    offsets_map:  [H, W, 4] int32 (sao offsets, already sign-applied/scaled)
    skip_map:     [H, W] bool (lossless/PCM samples to leave untouched)
    edge_ok:      optional [H, W] bool, False where an edge-offset neighbor
                  crosses a disabled slice/tile boundary
    """
    H, W = src.shape
    dev = src.device
    maxv = (1 << bit_depth) - 1
    o = offsets_map

    # --- band offset: 4-way select ---
    k = ((src >> (bit_depth - 5)) - band_pos_map) & 31
    w = torch.where
    band_off = w(k == 0, o[..., 0], w(k == 1, o[..., 1],
                 w(k == 2, o[..., 2], w(k == 3, o[..., 3], 0))))
    band_res = src + band_off

    # --- edge offset: edge-replicated neighbors, out-of-picture masked ---
    yy = torch.arange(H, device=dev)
    xx = torch.arange(W, device=dev)

    def shifted(dy, dx):
        ys = (yy + dy).clamp(0, H - 1)
        xs = (xx + dx).clamp(0, W - 1)
        return src.index_select(0, ys).index_select(1, xs)

    def inside(dy, dx):
        return (((yy + dy >= 0) & (yy + dy < H))[:, None] &
                ((xx + dx >= 0) & (xx + dx < W))[None, :])

    na = torch.zeros_like(src)
    nb = torch.zeros_like(src)
    valid = torch.ones((H, W), dtype=torch.bool, device=dev)
    for cls in range(4):
        dy0, dx0, dy1, dx1 = (int(v) for v in EO_D[cls].ravel())
        sel = eo_class_map == cls
        na = w(sel, shifted(dy0, dx0), na)
        nb = w(sel, shifted(dy1, dx1), nb)
        valid = w(sel, inside(dy0, dx0) & inside(dy1, dx1), valid)

    edge_idx = 2 + torch.sign(src - na) + torch.sign(src - nb)
    cat = torch.as_tensor(EDGE_CAT, device=dev)[edge_idx.long()]
    edge_off = torch.gather(
        o, 2, (cat - 1).clamp(0, 3).long()[..., None])[..., 0]
    if edge_ok is not None:
        valid = valid & edge_ok
    edge_res = w((cat > 0) & valid, src + edge_off, src)

    out = w(type_map == 1, band_res, w(type_map == 2, edge_res, src))
    out = out.clamp(0, maxv)
    return w(skip_map | (type_map == 0), src, out)


def _ctb_size(ctb_size):
    return ((ctb_size, ctb_size) if np.isscalar(ctb_size)
            else tuple(ctb_size))


def edge_boundary_ok(emap, slice_addr, across_slices, tile_id, across_tiles,
                     ctb_size, H, W):
    """Per-sample mask of edge-offset applicability across slice/tile
    boundaries (native/src/sao.cc neighbor_ok; spec 8.7.3), on emap's
    device.

    emap:          [H, W] eo class per sample (tensor)
    slice_addr:    [ctb_h, ctb_w] SliceAddrRs per CTB
    across_slices: [ctb_h, ctb_w] bool, loop_filter_across_slices of the
                   CTB's slice
    tile_id:       [ctb_h, ctb_w] tile id per CTB (arrays or tensors)
    ctb_size:      CTB size in this channel's samples, an int or a
                   (cs_y, cs_x) pair for anisotropic chroma (4:2:2)
    """
    dev = emap.device
    cs_y, cs_x = _ctb_size(ctb_size)
    ys = torch.arange(H, device=dev)
    xs = torch.arange(W, device=dev)
    yy, xx = (ys // cs_y)[:, None], (xs // cs_x)[None, :]
    A = torch.as_tensor(slice_addr, device=dev)[yy, xx]
    L = torch.as_tensor(across_slices, device=dev)[yy, xx]
    T = torch.as_tensor(tile_id, device=dev)[yy, xx]

    def shifted(m, dy, dx):
        return m[(ys + dy).clamp(0, H - 1)[:, None],
                 (xs + dx).clamp(0, W - 1)[None, :]]

    def ok(dy, dx):
        slice_ok = (shifted(A, dy, dx) == A) | (L & shifted(L, dy, dx))
        tile_ok = bool(across_tiles) | (shifted(T, dy, dx) == T)
        return slice_ok & tile_ok

    out = torch.ones((H, W), dtype=torch.bool, device=dev)
    for cls in range(4):
        dy0, dx0, dy1, dx1 = (int(v) for v in EO_D[cls].ravel())
        out = torch.where(emap == cls, ok(dy0, dx0) & ok(dy1, dx1), out)
    return out


def upsample_ctb_params(sao_rec, c, ctb_w, ctb_h, ctb_size, H, W, device):
    """Per-sample maps (type, eo class, band position: [H, W] int32;
    offsets [H, W, 4] int32) of channel c from the per-CTB SaoParams
    records, expanded on `device`.

    ctb_size is the CTB extent in this channel's samples, an int or a
    (cs_y, cs_x) pair for anisotropic chroma geometry (4:2:2).
    """
    cs_y, cs_x = _ctb_size(ctb_size)

    def up(a):
        t = torch.as_tensor(np.ascontiguousarray(a).astype(np.int32),
                            device=device)
        return t.repeat_interleave(cs_y, 0).repeat_interleave(
            cs_x, 1)[:H, :W].contiguous()

    return (up(sao_rec["type_idx"][:, c].reshape(ctb_h, ctb_w)),
            up(sao_rec["eo_class"][:, c].reshape(ctb_h, ctb_w)),
            up(sao_rec["band_pos"][:, c].reshape(ctb_h, ctb_w)),
            up(sao_rec["offset"][:, c, :].reshape(ctb_h, ctb_w, 4)))
