"""Tile-sharded frame decode over a mesh of devices (the analogue of the
reference's tile worker threads, decctx.cc:963-1061).

Port of ``libde265_tpu/parallel/sharded_decode.py``.  HEVC tiles partition
a picture into independently parseable rectangles: no intra prediction, MV
prediction or CABAC state crosses a tile boundary.  Each mesh entry
reconstructs one tile of the (rows x cols) grid from its own record
batches (TUs, PUs, intra super-waves), with the reference pictures
replicated to every distinct device.

One process drives every entry, as JAX's ``shard_map`` is driven by one
controller: tile t's feed is built on the host, moved to
``mesh.devices[t]`` and run there through the whole-picture program
(``fused_decode._frame_fn``, the formulation without the ring); the
entries may repeat (k tiles on one card, or ``["cpu"] * k``).

Loop filters are the only cross-tile coupling:

- ``loop_filter_across_tiles == False``: filters are gated at tile
  boundaries by the bitstream itself, so each tile runs the ordinary
  whole-picture program, filters included.
- ``loop_filter_across_tiles == True``: each tile is reconstructed
  unfiltered, then exchanges a HALO-sample border (plus the filter
  metadata grids) with its neighbours by copies between the tiles'
  tensors, and runs deblocking + SAO on the halo-padded tile with
  redundant boundary compute: edges within 3 samples of the boundary are
  computed identically on both neighbours.

A tile decodes as if it were a small picture, with motion vectors
pre-biased by ``4 * tile_origin`` so that frame-global reference windows
come out of tile-local cell coordinates.
"""
from __future__ import annotations

import numpy as np
import torch

from ..decoder import FrameProgramData
from ..feed import (_PLANE_CLASS, MAX_REFS, NOREF, _bin_tus, _intra_records,
                    _pack_irec, _pad_rows, has_ccp, has_rdpcm, record_depths)
from ..fused_decode import (_attached, _deblock_section, _frame_fn,
                            _sao_section, _split)
from ..ops.sao import EO_D
from .tiles import Mesh, on_device

# Halo width in luma samples each side.  16 (two 8-sample edge columns)
# keeps BOTH the luma and the 4:2:0 chroma deblocking edge grids
# phase-aligned in the padded tile (chroma pad = 8 chroma samples = one
# chroma edge column), and far exceeds the deblocking reach (edge +-3
# writes, +-4 reads).
HALO = 16


def tile_grid(prog: FrameProgramData):
    """Tile y/x-ranges (luma samples) from the per-CTB tile-id grid.

    Returns (rows, cols): lists of (y0, y1) and (x0, x1).  HEVC tile grids
    are rectangular by construction (pps tile geometry), so the grid is the
    cartesian product rows x cols.
    """
    tid = prog.tile_id
    ctb = prog.ctb_size
    if tid is None or tid.size == 0:
        return [(0, prog.height)], [(0, prog.width)]
    row0 = tid[0]
    xb = [0]
    for i in range(1, len(row0)):
        if row0[i] != row0[i - 1]:
            xb.append(i * ctb)
    xb.append(prog.width)
    col0 = tid[:, 0]
    yb = [0]
    for i in range(1, len(col0)):
        if col0[i] != col0[i - 1]:
            yb.append(i * ctb)
    yb.append(prog.height)
    rows = [(yb[i], min(yb[i + 1], prog.height)) for i in range(len(yb) - 1)]
    cols = [(xb[i], min(xb[i + 1], prog.width)) for i in range(len(xb) - 1)]
    return rows, cols


def tile_columns(prog: FrameProgramData):
    """Tile x-ranges (luma samples); requires a single row of tiles."""
    rows, cols = tile_grid(prog)
    if len(rows) != 1:
        raise ValueError("stream has multiple tile rows; use tile_grid")
    return cols


class _TileView:
    """prog-shaped shim over per-tile filtered record arrays for _bin_tus."""

    def __init__(self, tus, coeff_val, coeff_pos):
        self.tus = tus
        self.coeff_val = coeff_val
        self.coeff_pos = coeff_pos


def _bin_tus_tile(prog, sel, x_off_l, y_off_l, sub_x, sub_y):
    """Per-tile TU binning with tile-local coordinates."""
    tus = prog.tus[sel].copy()
    if len(tus):
        offx = np.where(tus["cidx"] == 0, x_off_l, x_off_l // sub_x)
        offy = np.where(tus["cidx"] == 0, y_off_l, y_off_l // sub_y)
        tus["x"] = tus["x"] - offx
        tus["y"] = tus["y"] - offy
    view = _TileView(tus, prog.coeff_val, prog.coeff_pos)
    view.width = prog.width
    view.scaling_factors = prog.scaling_factors
    return _bin_tus(view)


def _localize_intra_recs(irec, t, th, tw, R, C, sub_x, sub_y, tu_of,
                         tu_local_row):
    """Slice one tile's rows out of the whole-frame intra record array.

    Rows of other tiles keep the shared (step, slot) schedule but lose the
    valid bit; coordinates are rebased to tile-local ones; rrow is
    remapped to the tile-local residual-bin row.  The availability bits
    need no rebasing: intra prediction never crosses a tile boundary, so
    every available border sample of a kept block lies inside the tile.
    """
    out = irec.copy()
    if not len(irec):
        return out
    r, c = t // C, t % C
    cidx = irec[:, 8]
    sx = np.where(cidx == 0, 1, sub_x)
    sy = np.where(cidx == 0, 1, sub_y)
    gx = irec[:, 3] * sx
    gy = irec[:, 2] * sy
    mine = (np.clip(gx // tw, 0, C - 1) == c) & \
        (np.clip(gy // th, 0, R - 1) == r)
    out[:, 4] = np.where(mine, irec[:, 4], 0)
    out[:, 3] = np.where(mine, irec[:, 3] - (c * tw) // sx, 0)
    out[:, 2] = np.where(mine, irec[:, 2] - (r * th) // sy, 0)
    rr = irec[:, 5]
    new_rr = np.full(len(irec), -1, np.int32)
    for lg, sel_g in tu_of.items():
        m = mine & (irec[:, 9] == lg) & (rr >= 0)
        if m.any():
            gtu = sel_g[np.clip(rr[m], 0, len(sel_g) - 1)]
            new_rr[m] = tu_local_row[gtu]
    out[:, 5] = new_rr
    return out


def _pu_table(pus, cap, slot_map):
    """The [cap, 10] PU table of the frame program (mv0x mv0y mv1x mv1y pf
    slot0 slot1 ref_idx0 ref_idx1 slice); slot_map maps the reference
    indices 0..n-1 to stack rows, any other index (an unused list) to 0."""
    pu = np.zeros((cap, 10), np.int32)
    n = len(pus)
    if n:
        for j, f in enumerate(("mv0x", "mv0y", "mv1x", "mv1y")):
            pu[:n, j] = pus[f]
        pu[:n, 4] = pus["pred_flags"]
        lut = np.array([slot_map[i] for i in range(len(slot_map))] + [0],
                       np.int32)
        for l in (0, 1):
            v = pus[f"ref_dpb{l}"].astype(np.int64)
            pu[:n, 5 + l] = lut[np.where((v >= 0) & (v < len(slot_map)), v,
                                         len(slot_map))]
            pu[:n, 7 + l] = np.maximum(pus[f"ref_idx{l}"].astype(np.int32), 0)
        pu[:n, 9] = pus["slice"]
    return pu


def _exchange(xs, h, prev, nxt, axis):
    """Halo exchange along `axis` of every tile's tensor:
    [previous neighbour's tail | x | next neighbour's head], the
    neighbours' slices copied to this tile's device, zeros where the
    lattice has no neighbour (prev[t] / nxt[t] is None); the positional
    edge masks and bs = 0 keep those zeros inert."""
    out = []
    for t, x in enumerate(xs):
        p, q = prev[t], nxt[t]
        tail = None if p is None else \
            xs[p].narrow(axis, xs[p].shape[axis] - h, h)
        head = None if q is None else xs[q].narrow(axis, 0, h)
        parts = []
        for part in (tail, x, head):
            if part is None:
                shape = list(x.shape)
                shape[axis] = h
                part = x.new_zeros(shape)
            parts.append(part.to(x.device))
        out.append(torch.cat(parts, dim=axis))
    return out


def _halo_filter(planes, tfs, std, grid, origins):
    """Deblocking + SAO of every tile on its halo-padded planes (redundant
    boundary compute), after per-tile reconstruction when
    loop_filter_across_tiles is on: the halo exchange along the tile
    lattice (x within rows for every tile first, then y within columns on
    the x-padded arrays, which carries the corners), then the picture
    program's filter sections on each padded tile, then the crop.

    planes: per tile, its unfiltered planes; tfs: per tile, its feed (on
    its device); origins: per tile, its (x0, y0) in the frame.  Returns the
    filtered planes per tile."""
    R, C = grid
    T = R * C
    th, tw = std["H"], std["W"]
    W_frame, H_frame = tw * C, th * R
    sub_x = max(std["sub_x"], 1)
    sub_y = max(std["sub_y"], 1)
    has_chroma = not std["mono"]
    hx, h4 = HALO, HALO // 4
    hcx, hcy = HALO // sub_x, HALO // sub_y
    twc = max(std["cw"], 1)
    thc = max(std["ch"], 1)

    prev_x = [t - 1 if t % C else None for t in range(T)]
    next_x = [t + 1 if t % C != C - 1 else None for t in range(T)]
    prev_y = [t - C if t >= C else None for t in range(T)]
    next_y = [t + C if t < T - C else None for t in range(T)]

    def ex2(xs, hy_, hx_, xaxis=-1, yaxis=-2):
        xs = _exchange(xs, hx_, prev_x, next_x, xaxis)
        return _exchange(xs, hy_, prev_y, next_y, yaxis)

    pp = [ex2([p[0] for p in planes], hx, hx)]
    if has_chroma:
        pp += [ex2([p[c] for p in planes], hcy, hcx) for c in (1, 2)]
    g = {k: ex2([tf[k] for tf in tfs], h4, h4)
         for k in ("qp4", "nzc4", "dbf4", "cu4", "si4", "sa4", "ti4",
                   "pu_idx")}
    sao_m = {k: ex2([tf[k] for tf in tfs], h4, h4, xaxis=1, yaxis=0)
             for k in ("st4", "se4", "sb4", "so4")}

    # The halo filter runs only where every filter crosses tile and slice
    # boundaries (slice-gated filters raise), so SAO's slice/tile mask
    # would be all true: multi_boundary off leaves SAO the positional
    # masks alone (eo_ok_*), as the JAX package's halo SAO has.
    st2 = dict(std)
    st2.update(H=th + 2 * hx, W=tw + 2 * hx, ch=thc + 2 * hcy,
               cw=twc + 2 * hcx, ctb_size=4, across_tiles=True,
               multi_boundary=False, run_deblock=True, run_sao=True)
    out = []
    for t in range(T):
        dev = pp[0][t].device
        tf = tfs[t]
        gx0, gy0 = origins[t]
        with on_device(dev):
            out.append(_halo_filter_tile(
                [p[t] for p in pp], {k: v[t] for k, v in g.items()},
                {k: v[t] for k, v in sao_m.items()}, tf, gx0, gy0, std, st2,
                (W_frame, H_frame)))
    return out


def _halo_filter_tile(planes, g, sao_m, tf, gx0, gy0, std, st2, frame):
    """_halo_filter on one tile's exchanged planes and grids."""
    W_frame, H_frame = frame
    th, tw = std["H"], std["W"]
    sub_x = max(std["sub_x"], 1)
    sub_y = max(std["sub_y"], 1)
    hx = HALO
    hcx, hcy = HALO // sub_x, HALO // sub_y
    twc = max(std["cw"], 1)
    thc = max(std["ch"], 1)
    dev = planes[0].device
    w = torch.where
    pu_idx = g["pu_idx"]
    pb_h, pbw = pu_idx.shape
    recs = tf["slice_recs"]

    # per-cell PU params from the halo'd index grid + unbiased PU table
    pidx = pu_idx.reshape(-1)
    covered = pidx >= 0
    pu = tf["pu_raw"]
    pcell = pu[pidx.long().clamp(0, pu.shape[0] - 1)]
    cell = {"pf": w(covered, pcell[:, 4], 0)}
    for l in (0, 1):
        has = ((cell["pf"] >> l) & 1) != 0
        cell[f"mv{l}x"] = w(has, pcell[:, 2 * l], 0)
        cell[f"mv{l}y"] = w(has, pcell[:, 1 + 2 * l], 0)
        slot = pcell[:, 5 + l].long().clamp(0, MAX_REFS - 1)
        cell[f"poc{l}"] = w(has, tf["ref_pocs"][slot], NOREF)

    # positional edge masks: the picture bounds are interior rows/columns
    # of the padded tile, invisible to the frame program's edge-0 drop
    gxv = gx0 - hx + 4 * torch.arange(pbw, device=dev)
    gyv = gy0 - hx + 4 * torch.arange(pb_h, device=dev)
    in_x = ((gxv >= 0) & (gxv < W_frame))[None, :]
    in_y = ((gyv >= 0) & (gyv < H_frame))[:, None]
    edge_x = ((gxv > 0) & (gxv < W_frame))[None, :]
    edge_y = ((gyv > 0) & (gyv < H_frame))[:, None]
    feed2 = {"qp4": g["qp4"], "nzc4": g["nzc4"], "dbf4": g["dbf4"],
             "cu4": g["cu4"], "slice_idx": g["si4"], "slice_addr": g["sa4"],
             "tile_id": g["ti4"],
             "allow_xv": (edge_x & in_y).to(torch.int32),
             "allow_xh": (in_x & edge_y).to(torch.int32)}

    skip4 = (g["cu4"] & 4) != 0
    if std["pcm_lf_disable"]:
        skip4 = skip4 | ((g["cu4"] & 2) != 0)

    planes2 = list(planes)
    if std["run_deblock"]:
        planes2 = _deblock_section(planes2, feed2, recs, cell, skip4, st2)

    if std["run_sao"]:
        feed2.update(sao_t=sao_m["st4"], sao_eo=sao_m["se4"],
                     sao_band=sao_m["sb4"], sao_off=sao_m["so4"])
        # picture-boundary validity of each edge-offset class on the
        # (interior) global rows and columns of each padded plane
        d = EO_D.tolist()

        def inside(v, axis, n):
            return torch.stack([(v + d[k][0][axis] >= 0) &
                                (v + d[k][0][axis] < n) &
                                (v + d[k][1][axis] >= 0) &
                                (v + d[k][1][axis] < n) for k in range(4)])

        for c, p in enumerate(planes2):
            sx, sy = (1, 1) if c == 0 else (sub_x, sub_y)
            ar_y, ar_x = (torch.arange(n, device=dev) for n in p.shape)
            feed2[f"eo_ok_y{c}"] = inside(gy0 // sy - hx // sy + ar_y, 0,
                                          H_frame // sy)
            feed2[f"eo_ok_x{c}"] = inside(gx0 // sx - hx // sx + ar_x, 1,
                                          W_frame // sx)
        planes2 = _sao_section(planes2, feed2, recs, skip4, st2)

    cropped = [planes2[0][hx:hx + th, hx:hx + tw]]
    if len(planes2) > 1:
        cropped += [p[hcy:hcy + thc, hcx:hcx + twc] for p in planes2[1:]]
    return tuple(cropped)


def _upload(arrays, dev):
    """One host buffer of every int32 array of a tile's feed, uploaded in
    one copy; returns the feed as views of it (bins as sub-dicts)."""
    layout, off = [], 0
    for k, a in arrays.items():
        layout.append((k, off, a.shape))
        off += a.size
    buf = np.empty(max(off, 1), np.int32)
    for (k, o, shp), a in zip(layout, arrays.values()):
        buf[o:o + a.size] = a.reshape(-1)
    return _split(torch.from_numpy(buf).to(dev), layout)


class ShardedTileDecoder:
    """Decode tiled pictures with one tile per mesh entry (row-major over
    the tile grid), bit-exact against the scalar oracle.

    Usage::
        mesh = make_mesh(devices=["cuda:0"] * 8)
        sd = ShardedTileDecoder(mesh)
        planes = sd.decode(prog)          # on mesh.devices[0]

    Raises NotImplementedError for what it does not decode: PCM blocks,
    an across-tiles halo with slice-gated filters (as the JAX package),
    more than MAX_REFS references (the JAX package reads the first
    MAX_REFS and silently maps the rest to the first), and scaling lists,
    cross-component prediction or RDPCM (its tile program has none of
    them: the JAX package decodes such pictures wrong)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.n_dev = mesh.size
        self.dpb = {}
        self._order = []

    # ---- host-side per-tile partitioning -------------------------------

    def _partition(self, prog):
        rows, cols = tile_grid(prog)
        R, C = len(rows), len(cols)
        T = R * C
        if T != self.n_dev:
            raise ValueError(f"{T} tiles ({R}x{C}) vs {self.n_dev} devices")
        tw = cols[0][1] - cols[0][0]
        th = rows[0][1] - rows[0][0]
        if any(x1 - x0 != tw for x0, x1 in cols) or \
                any(y1 - y0 != th for y0, y1 in rows):
            raise ValueError("non-uniform tile sizes unsupported")

        H, W = prog.height, prog.width
        has_chroma = prog.chroma_width > 0
        sub_x = W // prog.chroma_width if has_chroma else 1
        sub_y = H // prog.chroma_height if has_chroma else 1

        irec_w, n_steps, nsteps_pc = _intra_records(prog)

        # map whole-frame (lg, bin row) -> global tu index (the rows of
        # _bin_tus(prog)'s bins, for the intra rrow mapping)
        tu_of = {lg: sel for lg in (2, 3, 4, 5) if len(
            sel := np.nonzero(prog.tus["log2_size"] == lg)[0])}

        # tile (row-major index) of each TU
        if len(prog.tus):
            lum = prog.tus["cidx"] == 0
            tu_x_l = np.where(lum, prog.tus["x"], prog.tus["x"] * sub_x)
            tu_y_l = np.where(lum, prog.tus["y"], prog.tus["y"] * sub_y)
            tu_tile = (np.clip(tu_y_l // th, 0, R - 1) * C +
                       np.clip(tu_x_l // tw, 0, C - 1))
        else:
            tu_tile = np.zeros(0, np.int32)

        # per-tile, per-lg local bin row of each global TU
        tu_local_row = np.full(len(prog.tus), -1, np.int32)
        for lg in (2, 3, 4, 5):
            for t in range(T):
                sel = np.nonzero((prog.tus["log2_size"] == lg) &
                                 (tu_tile == t))[0]
                tu_local_row[sel] = np.arange(len(sel))

        per_tile = []
        for t in range(T):
            y0, y1 = rows[t // C]
            x0, x1 = cols[t % C]
            sel = np.nonzero(tu_tile == t)[0] if len(prog.tus) else \
                np.zeros(0, np.int64)
            bins, _, _ = _bin_tus_tile(prog, sel, x0, y0, sub_x, sub_y)
            xs = _localize_intra_recs(irec_w, t, th, tw, R, C, sub_x, sub_y,
                                      tu_of, tu_local_row)
            per_tile.append({"bins": bins, "irec": xs, "x0": x0, "x1": x1,
                             "y0": y0, "y1": y1})
        return (per_tile, (R, C), (th, tw), sub_x, sub_y, n_steps,
                nsteps_pc, irec_w)

    # ---- device feeds ---------------------------------------------------

    def decode(self, prog: FrameProgramData):
        for what, unsupported in (
                ("PCM blocks", prog.pcms is not None and len(prog.pcms)),
                ("scaling lists", prog.scaling_factors is not None),
                ("cross-component prediction", has_ccp(prog)),
                ("RDPCM", has_rdpcm(prog))):
            if unsupported:
                raise NotImplementedError(f"{what} in sharded decode")
        (per_tile, (R, C), (th, tw), sub_x, sub_y, n_steps, nsteps_pc,
         irec_w) = self._partition(prog)
        T = len(per_tile)
        has_chroma = prog.chroma_width > 0
        bd = prog.bit_depth[0]
        bdc = prog.bit_depth[1] if has_chroma else bd
        twc = tw // sub_x
        thc = th // sub_y

        # the reference stacks (unpadded: the per-cell gather formulation)
        refs, slot_map = self._refs(prog)

        # --- per-tile feeds, padded to the tiles' common capacities ---
        caps = {}
        for pt in per_tile:
            for lg, b in pt["bins"].items():
                for key, n in (("tu", b["n"]), ("co", len(b["cv"])),
                               ("cf", len(b["cfx"]))):
                    caps[f"{key}{lg}"] = max(caps.get(f"{key}{lg}", 1), n)
                for ch in ("y", "cb", "cr"):
                    caps[f"sc{lg}{ch}"] = max(caps.get(f"sc{lg}{ch}", 0),
                                              len(b[f"sc_{ch}"]))
        lgs = sorted({lg for pt in per_tile for lg in pt["bins"]})
        intra_keys = sorted(
            {(_PLANE_CLASS[int(c)], int(lg)) for c, lg in
             zip(irec_w[:, 8], irec_w[:, 9])}) if len(irec_w) else []

        feeds = [{} for _ in range(T)]
        z0 = np.zeros(0, np.int32)
        for lg in lgs:
            tcap = caps[f"tu{lg}"]
            for pt, f in zip(per_tile, feeds):
                b = pt["bins"].get(lg)
                coff = b["coff"] if b else np.zeros(1, np.int32)
                for fld, cap, fill in (("qp", tcap, 0), ("flags", tcap, 0),
                                       ("mid", tcap, 0),
                                       ("cv", caps[f"co{lg}"], 0),
                                       ("cfx", caps[f"cf{lg}"], -1),
                                       ("cfv", caps[f"cf{lg}"], 0)):
                    f[f"bin{lg}.{fld}"] = _pad_rows(
                        b[fld].astype(np.int32) if b else z0, cap, fill)
                f[f"bin{lg}.coff"] = _pad_rows(coff, tcap + 1,
                                               fill=int(coff[-1]))
                for ch in ("y", "cb", "cr"):
                    f[f"bin{lg}.sc_{ch}"] = _pad_rows(
                        b[f"sc_{ch}"] if b else np.zeros((0, 3), np.int32),
                        caps[f"sc{lg}{ch}"], fill=-1)

        pcap = max(len(prog.pus), 1)
        pu_raw = _pu_table(prog.pus, pcap, slot_map)
        tw4, th4 = tw // 4, th // 4
        ctb = prog.ctb_size
        twc_ctb, thc_ctb = tw // ctb, th // ctb
        g4 = {"qp4": prog.qp_y, "nzc4": prog.nonzero_coeff,
              "dbf4": prog.deblock_flags, "cu4": prog.cu_info,
              "pu_idx": prog.pu_idx}
        gctb = {"slice_idx": prog.slice_idx, "slice_addr": prog.slice_addr,
                "tile_id": prog.tile_id}
        if prog.sao is not None and len(prog.sao):
            sh = prog.slice_idx.shape
            for name, fld, extra in (("sao_t", "type_idx", ()),
                                     ("sao_eo", "eo_class", ()),
                                     ("sao_band", "band_pos", ()),
                                     ("sao_off", "offset", (4,))):
                gctb[name] = prog.sao[fld].reshape(*sh, 3, *extra)
        else:
            for name, extra in (("sao_t", ()), ("sao_eo", ()),
                                ("sao_band", ()), ("sao_off", (4,))):
                gctb[name] = np.zeros((*prog.slice_idx.shape, 3, *extra),
                                      np.int32)
        n_slices = max(len(prog.slice_records), 1)
        recs = np.zeros((n_slices, 208), np.int32)
        recs[:len(prog.slice_records)] = prog.slice_records
        ref_pocs = np.array([prog.ref_pocs[i] if i < len(prog.ref_pocs)
                             else NOREF for i in range(MAX_REFS)], np.int32)
        for pt, f in zip(per_tile, feeds):
            y4, x4 = pt["y0"] // 4, pt["x0"] // 4
            yc, xc = pt["y0"] // ctb, pt["x0"] // ctb
            f["irecp"] = _pack_irec(pt["irec"].astype(np.int32))
            # MVs pre-biased by 4 * the tile origin
            f["pu"] = pu_raw.copy()
            f["pu"][:len(prog.pus), 0:4] += 4 * np.array(
                [pt["x0"], pt["y0"]] * 2, np.int32)
            for name, a in g4.items():
                f[name] = a[y4:y4 + th4, x4:x4 + tw4].astype(np.int32)
            for name, a in gctb.items():
                f[name] = a[yc:yc + thc_ctb, xc:xc + twc_ctb].astype(
                    np.int32)
            f["ref_pocs"] = ref_pocs
            f["slice_recs"] = recs
            for c in range(3):
                f[f"pcm{c}"] = np.zeros((0, 2), np.int32)

        std = {
            "H": th, "W": tw, "sub_x": sub_x, "sub_y": sub_y,
            "cw": max(twc, 1), "ch": max(thc, 1),
            "bd": bd, "bdc": bdc, "mono": not has_chroma,
            "ctb_size": ctb, "n_slices": n_slices,
            "use_l1": bool((prog.pus["pred_flags"] & 2).any())
            if len(prog.pus) else False,
            "has_inter": len(prog.pus) > 0,
            "scaling": False, "lgs": tuple(lgs),
            "pcm_lf_disable": bool(prog.pcm_loop_filter_disable),
            "across_tiles": bool(prog.across_tiles),
            "multi_boundary": True,
            "run_deblock": bool(len(prog.slice_records) and
                                not np.all(prog.slice_records[:, 1])),
            "run_sao": bool(len(prog.slice_records) and
                            np.any(prog.slice_records[:, 4] |
                                   prog.slice_records[:, 5])),
            "pallas_mc": False, "segk": 1,
            "steps_cap": max(n_steps, 1),
            "intra_bins": tuple(intra_keys),
        }
        st = std
        halo_mode = bool(prog.across_tiles) and (std["run_deblock"] or
                                                 std["run_sao"])
        if halo_mode:
            # reconstruct unfiltered per tile, then halo-exchange and
            # filter with redundant boundary compute
            st = {**std, "run_deblock": False, "run_sao": False}
            if len(prog.slice_records) and not np.all(
                    prog.slice_records[:, 9]):
                raise NotImplementedError(
                    "across-tiles halo filtering with slice-gated filters")
            self._add_filter_feed(feeds, prog, per_tile, th, tw, pu_raw)

        host = [{"mc_on": len(prog.pus) > 0, "nsteps": nsteps_pc,
                 "n_intra": f["irecp"].shape[1],
                 "depths": record_depths(f["irecp"][0]), "slot_row": []}
                for f in feeds]
        planes = self._run_sharded(refs, feeds, host, st, (R, C),
                                   halo=halo_mode, std=std,
                                   origins=[(pt["x0"], pt["y0"])
                                            for pt in per_tile])
        home = self.mesh.devices[0]
        out = tuple(torch.cat(
            [torch.cat([planes[r * C + c][k].to(home) for c in range(C)],
                       dim=-1) for r in range(R)], dim=-2)
            for k in range(len(planes[0])))
        self._store(prog.poc, out)
        return out

    def _add_filter_feed(self, feeds, prog, per_tile, th, tw, pu_raw):
        """Extra per-tile feeds for the halo filter pass (cell-resolution
        slice/tile grids, cell-resolution SAO maps, unbiased PU table)."""
        ctb = prog.ctb_size
        cs4 = ctb // 4
        tw4, th4 = tw // 4, th // 4
        ph = prog.pu_idx.shape[0]

        def up4(g):
            return np.repeat(np.repeat(g.astype(np.int32), cs4, 0),
                             cs4, 1)[:ph]

        grids = {"sa4": up4(prog.slice_addr), "ti4": up4(prog.tile_id),
                 "si4": up4(prog.slice_idx)}
        ctb_h, ctb_w = prog.slice_idx.shape
        for name, fld, extra in (("st4", "type_idx", ()),
                                 ("se4", "eo_class", ()),
                                 ("sb4", "band_pos", ()),
                                 ("so4", "offset", (4,))):
            if prog.sao is not None and len(prog.sao):
                g = prog.sao[fld].astype(np.int32).reshape(ctb_h, ctb_w, 3,
                                                           *extra)
                grids[name] = np.repeat(np.repeat(g, cs4, 0), cs4, 1)[:ph]
            else:
                grids[name] = np.zeros((ph, ctb_w * cs4, 3, *extra),
                                       np.int32)
        for pt, f in zip(per_tile, feeds):
            y4, x4 = pt["y0"] // 4, pt["x0"] // 4
            for name, gu in grids.items():
                f[name] = np.ascontiguousarray(gu[y4:y4 + th4, x4:x4 + tw4])
            f["pu_raw"] = pu_raw    # frame-consistent MVs for the filters

    def _run_sharded(self, refs, feeds, host, st, grid, halo=False, std=None,
                     origins=None):
        """Tile t's program on mesh.devices[t]: its feed uploaded there,
        the reference stacks replicated once per distinct device; then,
        with halo, the halo exchange and filter.  Returns per tile its
        planes."""
        devs = self.mesh.devices
        refs_on = {}
        tfs, planes = [], []
        for t, dev in enumerate(devs):
            with on_device(dev):
                if dev not in refs_on:
                    refs_on[dev] = [r.to(dev) for r in refs]
                tf = _upload(feeds[t], dev)
                tfs.append(tf)
                planes.append(_frame_fn(*refs_on[dev], tf, None, st,
                                        host[t]))
        if halo:
            planes = _halo_filter(planes, tfs, std, grid, origins)
        return planes

    # ---- DPB ------------------------------------------------------------

    def _refs(self, prog):
        """[MAX_REFS, h, w] reference stacks per plane on mesh.devices[0]
        and the reference index -> stack row map.  A POC not decoded here
        (a seek, a stream started at a CRA, a reference older than the
        DPB window) is read from the planes the parser attached, else
        RuntimeError, as FusedDecoder does (the JAX package reads
        mid-gray).  Raises NotImplementedError for more than MAX_REFS
        references, which the stacks cannot hold."""
        pocs = list(prog.ref_pocs)
        if len(pocs) > MAX_REFS:
            raise NotImplementedError(
                f"picture POC {prog.poc} reads {len(pocs)} references; the "
                f"sharded decode holds at most {MAX_REFS}")
        dev = self.mesh.devices[0]
        slot_map = {}
        stack = [[], [], []]
        H, W = prog.height, prog.width
        cw = max(prog.chroma_width, 1)
        ch = max(prog.chroma_height, 1)

        def full(shape, v):
            return torch.full(shape, v, dtype=torch.int32, device=dev)

        for i, poc in enumerate(pocs):
            planes = self.dpb.get(poc) or _attached(prog, i, dev)
            if planes is None:
                raise RuntimeError(
                    f"picture POC {prog.poc}: reference POC {poc} is neither "
                    "in the decoder's DPB nor attached to the program")
            slot_map[i] = len(stack[0])
            for c in range(3):
                stack[c].append(planes[c] if c < len(planes)
                                else full((1, 1), 0))
        while len(stack[0]) < MAX_REFS:
            stack[0].append(full((H, W), 0))
            stack[1].append(full((ch, cw), 0))
            stack[2].append(full((ch, cw), 0))
        return [torch.stack(s) for s in stack], slot_map

    def _store(self, poc, planes):
        self.dpb[poc] = planes
        self._order.append(poc)
        if len(self._order) > 17:
            old = self._order.pop(0)
            if old in self.dpb and old not in self._order:
                del self.dpb[old]
