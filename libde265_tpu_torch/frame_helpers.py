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

import torch

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


def _edge_params_jnp(meta, vertical: bool):
    """Per-4-sample-segment deblocking parameters of one edge orientation
    (bS, beta, tc, qp_l, no_p, no_q, chroma QP and tc offsets) from the
    per-4x4 metadata grids; port of tpu_decode._edge_params_jnp:
    ops.deblock.derive_edge_params and the Q side's chroma offsets."""
    q = (slice(None), slice(2, None, 2)) if vertical else \
        (slice(2, None, 2), slice(None))
    out, tco = dbk._derive_edge_params(meta, vertical)
    out["tco"] = tco
    out["cqo"] = [meta["cqo0"][q], meta["cqo1"][q]]
    return out


def _chroma_qp_map(qpi, is420):
    if is420:
        tab = torch.as_tensor(dbk.CHROMA_QP_TAB, device=qpi.device)
        return torch.where(
            qpi < 30, qpi,
            torch.where(qpi > 43, qpi - 6, tab[(qpi - 30).clamp(0, 13).long()]))
    return qpi.clamp(0, 51)


def deblock_planes(planes, meta, recs, slice_idx, slice_addr, tile_id, st,
                   allow=None):
    """Deblock V then H, luma and chroma: one B8 call for luma and one B9
    call for both chroma planes (ops.deblock_cuda), returning contiguous
    planes.

    meta: the per-4x4 grids of ops.deblock.derive_edge_params but for the
    slice-derived ones, which come from the slice records recs ([n, >=12]:
    disable, beta and tc offsets, across-slices, Cb and Cr QP offsets) and
    the per-CTB slice record indices, slice addresses and tile ids
    (tensors); the Q-side cell's slice governs (spec 8.7.2).  st: sub_x,
    sub_y, bd, bdc, mono, ctb_size, n_slices, across_tiles.  An edge
    between slices is filtered only where the Q slice allows it, and a
    tile edge where the picture does.  allow: an optional pair of per-4x4
    int32 masks (vertical, horizontal edges) that also gate every edge,
    as the halo-padded tiles of the sharded decode need (the picture's
    bounds are interior columns and rows there)."""
    sub_x, sub_y = st["sub_x"], st["sub_y"]
    bd, bdc = st["bd"], st["bdc"]
    is420 = sub_x == 2 and sub_y == 2
    dev = planes[0].device
    pb_h, pb_w = meta["qp"].shape
    cs4 = st["ctb_size"] // 4
    cy = (torch.arange(pb_h, device=dev) // cs4)[:, None]
    cx = (torch.arange(pb_w, device=dev) // cs4)[None, :]
    sidx4 = slice_idx[cy, cx].clamp(0, st["n_slices"] - 1).long()
    disabled4 = recs[sidx4, 1] != 0
    sa4 = slice_addr[cy, cx]
    ti4 = tile_id[cy, cx]
    across4 = recs[sidx4, 9] != 0

    def gate(axis):
        slice_ok = (torch.roll(sa4, 1, dims=axis) == sa4) | across4
        tile_ok = st["across_tiles"] | (torch.roll(ti4, 1, dims=axis) == ti4)
        return (slice_ok & tile_ok & ~disabled4).to(torch.int32)

    allow_v, allow_h = gate(1), gate(0)
    if allow is not None:
        allow_v, allow_h = allow_v * allow[0], allow_h * allow[1]
    meta = dict(meta, bit_depth=bd, beta_off=recs[sidx4, 2],
                tc_off=recs[sidx4, 3], cqo0=recs[sidx4, 10],
                cqo1=recs[sidx4, 11], allow_v=allow_v, allow_h=allow_h)
    tc_table = torch.as_tensor(dbk.TC_TABLE, device=dev)

    def chroma_tc(qp_l, cqo, tco, bs):
        qpc = _chroma_qp_map(qp_l[None] + torch.stack(cqo), is420)
        tc = tc_table[(qpc + 2 + tco[None]).clamp(0, 53).long()] << (bdc - 8)
        return torch.where(bs[None] == 2, tc, 0)

    keys = ("bs", "beta", "tc", "no_p", "no_q")
    pv = _edge_params_jnp(meta, vertical=True)     # [H/4, W/8 - 1]
    ph = _edge_params_jnp(meta, vertical=False)    # [H/8 - 1, W/4]
    y = deblock_cuda.deblock_luma(planes[0], [pv[k] for k in keys],
                                  [ph[k] for k in keys], bit_depth=bd)
    if st["mono"]:
        return [y]
    # chroma edge k lies on luma edge k * sub (parameter column k * sub - 1);
    # the kernel counts (Wc + 7) // 8 and (Hc + 7) // 8 edges, the last
    # one too where Wc or Hc is not a multiple of 8 (104x72 4:2:0: Wc = 52,
    # edge at x = 48); the JAX package keeps Wc // 8 and Hc // 8
    # (libde265_tpu/fused_decode.py:912, :964, libde265_tpu/pipeline.py:408,
    # :432), so on such pictures the port is held against the oracle, not
    # against JAX (ROADMAP C1)
    sv, sh = (slice(None), slice(sub_x - 1, None, sub_x)), \
        slice(sub_y - 1, None, sub_y)
    tc_v = chroma_tc(pv["qp_l"][sv], [c[sv] for c in pv["cqo"]],
                     pv["tco"][sv], pv["bs"][sv])
    tc_h = chroma_tc(ph["qp_l"][sh], [c[sh] for c in ph["cqo"]],
                     ph["tco"][sh], ph["bs"][sh])
    cbcr = deblock_cuda.deblock_chroma(
        planes[1], planes[2], (tc_v, pv["no_p"][sv], pv["no_q"][sv]),
        (tc_h, ph["no_p"][sh], ph["no_q"][sh]), bit_depth=bdc, sub_x=sub_x,
        sub_y=sub_y)
    return [y, cbcr[0], cbcr[1]]
