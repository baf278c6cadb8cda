"""Per-picture helpers of the fused decode and the pipeline: MC
interpolation and merge, cell-grid reshapes, the deblocking edge-parameter
derivation and the deblocking of a picture's planes.

Port of the helpers that ``libde265_tpu/fused_decode.py`` imports from
``libde265_tpu/tpu_decode.py`` (``_wrap16``, ``_mc_plane``, ``_merge``,
``_cells_to_plane``, ``_edge_params_jnp``, ``_chroma_qp_map``; its
``_pad_edge0_cols`` is ``ops.deblock.pad_edge0``).  The names are kept so
that each function can be held against its counterpart.
"""
from __future__ import annotations

from .ops import deblock as dbk
from .ops import deblock_cuda
from .ops.mc import _wrap16  # noqa: F401  (tpu_decode._wrap16)
from .ops.mc import _sep_filter, gather_windows, pred_merge_batch


def _mc_plane(ref_stack, slot, xint, yint, frac_x, frac_y, filters, taps,
              bs: int, bd: int):
    """Interpolate a [N, bs, bs] block batch from the stacked refs.

    ref_stack: [R, Hp, Wp] int32; per-cell integer positions, fractions and
    reference slots ([N] int32); filters: [n_frac, taps] int32 tensor.
    Returns predictions at the 14-bit intermediate scale (int32 dtype).
    """
    win = gather_windows(ref_stack, xint, yint, bs, bs, taps, taps // 2 - 1,
                         slot)
    return _sep_filter(win, frac_x, frac_y, taps, bs, bs, bd - 8, 14 - bd,
                       filters)


# the weighted/default prediction merge of tpu_decode._merge
_merge = pred_merge_batch


def _cells_to_plane(blocks, H4, W4, bs):
    return blocks.reshape(H4, W4, bs, bs).permute(0, 2, 1, 3).reshape(
        H4 * bs, W4 * bs)


# tpu_decode._edge_params_jnp: bS, beta, tc, qp_l, no_p, no_q of one edge
# orientation with the Q side's chroma QP and tc offsets
_edge_params_jnp = dbk.edge_params
# tpu_decode._chroma_qp_map
_chroma_qp_map = dbk.chroma_qp_map


def deblock_planes(planes, grids, recs, slice_idx, slice_addr, tile_id, st,
                   allow=None):
    """Deblock V then H, luma and chroma: the edge parameters of the
    picture in one launch (ops.deblock_cuda.deblock_params, into an arena
    kept for the picture's shape), then one B8 call for luma and one B9
    call for both chroma planes; returns contiguous planes.  On CPU
    tensors each wrapper runs its plain version.

    grids: the packed per-4x4 grids cu4, nzc4, dbf4, qp4 and the bool
    unfilt, and the PU gather's cell grids pf, mv0x, mv0y, mv1x, mv1y,
    poc0, poc1 (deblock_params); recs: the slice records ([n, >=12]:
    disable, beta and tc offsets, across-slices, Cb and Cr QP offsets);
    slice_idx, slice_addr, tile_id: the per-CTB grids; the Q-side cell's
    slice governs (spec 8.7.2).  st: sub_x, sub_y, bd, bdc, mono,
    ctb_size, n_slices, across_tiles.  An edge between slices is filtered
    only where the Q slice allows it, and a tile edge where the picture
    does.  allow: an optional pair of per-4x4 int32 masks (vertical,
    horizontal edges) that also gate every edge, as the halo-padded tiles
    of the sharded decode need (the picture's bounds are interior columns
    and rows there)."""
    prm = deblock_cuda.deblock_params(grids, recs, slice_idx, slice_addr,
                                      tile_id, st, allow)
    y = deblock_cuda.deblock_luma(planes[0], prm["v"], prm["h"],
                                  bit_depth=st["bd"])
    if st["mono"]:
        return [y]
    # chroma edge k lies on luma edge k * sub; the kernel counts
    # (Wc + 7) // 8 and (Hc + 7) // 8 edges, the last one too where Wc or
    # Hc is not a multiple of 8 (104x72 4:2:0: Wc = 52, edge at x = 48);
    # the JAX package keeps Wc // 8 and Hc // 8
    # (libde265_tpu/fused_decode.py:912, :964, libde265_tpu/pipeline.py:408,
    # :432), so on such pictures the port is held against the oracle, not
    # against JAX (ROADMAP C1)
    cbcr = deblock_cuda.deblock_chroma(
        planes[1], planes[2], prm["cv"], prm["ch"], bit_depth=st["bdc"],
        sub_x=st["sub_x"], sub_y=st["sub_y"])
    return [y, cbcr[0], cbcr[1]]
