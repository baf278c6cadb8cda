"""Whole-picture decode on one device: the PyTorch port of
``libde265_tpu/fused_decode.py``, in both of its formulations.

Per picture the host packs one int32 feed buffer plus a layout (``feed``),
uploads it, and ``_compiled_impl`` runs the picture in the order of the JAX
program: per-cell PU gather, motion compensation, coefficient densify
(kernel B4), dequant + inverse transform (one kernel for every size bin),
residual add, PCM, the intra super-wave scan
on padded planes (its records placed by one kernel from the uploaded wire
records, then one persistent kernel per picture, running the device
functions of kernels B6 and B7 in every step), deblocking (kernels B8, B9)
and SAO (kernel B10).

``FusedDecoder.use_pallas_mc`` selects the formulation, as in the JAX
package (which turns it on for TPU backends); the program reads it as
``st["pallas_mc"]``, its one key:

* on (the default on the card): the production program.  The feed crosses
  as its nonzero blocks and is rebuilt on the device (kernel B1); the
  per-cell PU map is painted from the MC segment feed (B2); inter
  prediction runs per PU x band segment straight from a padded DPB ring
  of ``2*MAX_REFS+1`` slots (B3); the inter residual is placed as band
  stripes (B5); and the program writes its decoded planes, edge-replicated,
  into the picture's own ring slot (the fused store).  The ring is updated
  in place.
* off (the CPU tests' default, and ``ShardedTileDecoder``'s program): the
  per-cell gather formulation, with ``[MAX_REFS, H, W]`` reference stacks
  built per picture.

The device of the tensors selects the implementation of each kernel: on a
CUDA tensor the wrapper launches the hand-written Hopper kernel, on a CPU
tensor it runs the plain PyTorch version.  Host-known values of the feed
(the MC gate, the intra step counts and size bins' depths, the ring rows)
are read from the numpy buffer, so the frame program never waits on the
device.

JAX silently clamps out-of-range gather indices and drops out-of-range
scatter writes (``mode="drop"``), and the feed relies on that with its
sentinel pads.  Here every such index is clamped or redirected to a
trailing scratch element explicitly.

The production formulation packs its feed with the native packer
(``FeedPacker.pack_native``) while the picture has a live native source
and no cross-component prediction has been seen in the stream, else with
the numpy packer (``FeedPacker.pack``), the only one that ships the CCP
fields.  Cross-component prediction and RDPCM run in the residual section.

A picture with more than MAX_REFS references goes to
``pipeline.reconstruct(prog, device_intra=False)``, as in the JAX package,
and so does, on the production formulation, a picture with more than
``mc_seg.MAX_PUS`` PUs, whose indices the segment words cannot hold (the
JAX package writes them wrapped); its references are read from the
decoder's own DPB (the ring slots cropped to the picture, or the dict of
decoded planes); only a POC the decoder does not hold (a seek) is read from
the planes the parser attached, and a reference found in neither raises
RuntimeError.  Its planes are stored like any other picture's.

While torch.profiler records, ``decode`` is the span ``tde.decode`` and its
sections the spans ``tde.pack``, ``tde.upload``, ``tde.unpack``,
``tde.gather``, ``tde.mc``, ``tde.residual``, ``tde.intra``,
``tde.deblock`` and ``tde.sao`` (``tde.routed`` for a routed picture; see
``tracing``).
"""
from __future__ import annotations

import ctypes as ct

import numpy as np
import torch

from . import _native, tracing

from .decoder import FrameProgramData

from . import feed as fdp
from . import pipeline
from .feed import MAX_REFS, NOREF, RING_SLOTS, FeedPacker
from .frame_helpers import (_cells_to_plane, _mc_plane, _merge,
                            deblock_planes)
from .ops import (coef_cuda, deblock_cuda, expand, intra_cuda, mc_seg,
                  sao_cuda)
from .ops import intra_window as iw
from .ops.mc import EPEL_FILTERS, QPEL_FILTERS
from .ops.sao import edge_boundary_ok
from .ops.transform import ccp_add

SPARSE_BLOCK = 1024             # words per block of the sparse upload
SPARSE_ROUND = 256              # its block count is rounded up to this


def _i32(a, device):
    return torch.as_tensor(a, dtype=torch.int32, device=device)


def _scatter(plane, rows, cols, vals, ok, add=False):
    """plane[rows, cols] = vals (or += with add) where ok and in bounds; the
    rest goes to a scratch element and is dropped (JAX's mode="drop").

    The targets that are kept must be distinct, as they are in the feed
    (TUs and PCM blocks do not overlap).  An add therefore reads, adds and
    writes: index_put_'s accumulate mode sorts the indices, and the many
    dropped entries that share the scratch index serialize that sort's
    reduction on a GPU (tens of ms per picture at 1080p)."""
    H, W = plane.shape
    ok = ok & (rows >= 0) & (rows < H) & (cols >= 0) & (cols < W)
    idx = torch.where(ok, rows.long() * W + cols.long(), H * W).reshape(-1)
    flat = torch.cat([plane.reshape(-1), plane.new_zeros(1)])
    v = vals.reshape(-1).to(plane.dtype)
    flat[idx] = flat[idx] + v if add else v
    return flat[:-1].view(H, W)


# ---------------------------------------------------------------------------
# feed unpacking
# ---------------------------------------------------------------------------

def _split(buf, layout):
    """The feed fields as views of the packed buffer (bins as sub-dicts)."""
    feed = {}
    for (k, off, shp) in layout:
        n = int(np.prod(shp))
        a = buf[off:off + n].reshape(shp)
        parts = k.split(".")
        if parts[0].startswith("bin"):
            feed.setdefault(parts[0], {})[parts[1]] = a
        else:
            feed[k] = a
    return feed


def _expand_feed(feed, st):
    """Expand the wire-compact feed fields: TU meta halfwords, the PU SoA
    and the per-4x4 grid word.  The coefficient stream stays CSR (cv/coff)
    for densify_bin, the intra records packed (irecp) for
    intra_cuda.intra_bins.  With st["pallas_mc"] (the production feed) the
    grid is halfwords and the per-cell PU index is painted from the segment
    feed (kernel B2), or is -1 everywhere when the stream has no inter
    picture; the wire PU SoA stays as "pu_wire" for the segment kernels."""
    for k, d in feed.items():
        if k.startswith("bin") and "tm" in d:
            # TU meta halfwords: qp7 (signed) | flags6<<7 | mid3<<13
            tm = d.pop("tm")
            h = torch.stack([tm & 0xFFFF, (tm >> 16) & 0xFFFF],
                            dim=1).reshape(-1)[:d["coff"].shape[0] - 1]
            d["qp"] = ((h & 0x7F) ^ 64) - 64
            d["flags"] = (h >> 7) & 0x3F
            d["mid"] = (h >> 13) & 7
    pu = feed["pu"]
    mv0, mv1, meta, sl = pu[:, 0], pu[:, 1], pu[:, 2], pu[:, 3]
    feed["pu_wire"] = pu
    feed["pu"] = torch.stack(
        [(mv0 << 16) >> 16, mv0 >> 16, (mv1 << 16) >> 16, mv1 >> 16,
         meta & 3, (meta >> 2) & 63, (meta >> 8) & 63,
         (meta >> 14) & 15, (meta >> 18) & 15, sl], dim=1)
    if st["pallas_mc"]:
        # halfword grid (two cells per word): qp8 | nzc1<<8 | dbf4<<9 |
        # cu3<<13
        g4p = feed.pop("g4")
        pb_h = g4p.shape[0]
        W4 = (st["W"] + 3) // 4
        g4 = torch.stack([g4p & 0xFFFF, (g4p >> 16) & 0xFFFF],
                         dim=2).reshape(pb_h, -1)[:, :W4]
        feed["qp4"] = g4 & 0xFF
        feed["nzc4"] = (g4 >> 8) & 1
        feed["dbf4"] = (g4 >> 9) & 0xF
        feed["cu4"] = (g4 >> 13) & 0x7
        if "sg0i" in feed:
            L = 2 if "sg1i" in feed else 1
            kp = max(feed[f"sg{l}i"].shape[1] for l in range(L))
            sidx2 = torch.zeros((pb_h, L, kp), dtype=torch.int32,
                                device=pu.device)
            for l in range(L):
                sidx2[:, l, :feed[f"sg{l}i"].shape[1]] = feed[f"sg{l}i"]
            feed["pu_idx"] = mc_seg.paint_pu_idx(
                torch.stack([feed[f"sg{l}n"] for l in range(L)]), sidx2, pu,
                n_bands=pb_h, W4=W4, L=L)
        else:   # intra-only stream: no inter coverage
            feed["pu_idx"] = torch.full((pb_h, W4), -1, dtype=torch.int32,
                                        device=pu.device)
        return
    g4 = feed.pop("g4")
    feed["qp4"] = g4 & 0xFF
    feed["nzc4"] = (g4 >> 8) & 1
    feed["dbf4"] = (g4 >> 9) & 0xF
    feed["cu4"] = (g4 >> 13) & 0xF
    if "pu_idx" not in feed:
        feed["pu_idx"] = ((g4 >> 17) & 0x7FFF) - 1


def _host_values(hbuf, layout, n_intra: int):
    """Host-side copies of the feed values that steer control flow; the
    depth of each intra size bin from word 0 of the picture's n_intra
    records (feed.record_depths)."""
    hfeed = _split(hbuf, layout)
    return {"mc_on": bool(hfeed["mc_on"][0]),
            "nsteps": np.asarray(hfeed["nsteps"]), "n_intra": n_intra,
            "depths": fdp.record_depths(hfeed["irecp"][0, :n_intra]),
            "slot_row": [int(v) for v in hfeed.get("slot_row", ())]}


def _compiled_impl(refs_y, refs_cb, refs_cr, buf, sf_tables, st, layout,
                   host_buf=None, *, n_intra: int):
    """The whole-picture program on the packed feed.

    refs_*: [MAX_REFS, h, w] int32 reference stacks, or with
    st["pallas_mc"] the DPB ring [RING_SLOTS * Hpad, Wpad] of each plane;
    buf: the uploaded int32 feed; st: the static configuration (a dict, or
    the JAX package's tuple of pairs); layout: (name, offset, shape)
    triples into buf; host_buf: the numpy buffer buf was uploaded from
    (read back from buf if None); n_intra: the picture's intra records
    (the packer's count: the first columns of the irecp field).  Returns
    the decoded planes, followed with pallas_mc by the three rings
    (updated in place)."""
    std = dict(st)
    with tracing.span("tde.unpack"):
        if host_buf is None:
            host_buf = buf.cpu().numpy()
        feed = _split(buf, layout)
        _expand_feed(feed, std)
        host = _host_values(host_buf, layout, n_intra)
    return _frame_fn(refs_y, refs_cb, refs_cr, feed, sf_tables, std, host)


# ---------------------------------------------------------------------------
# the frame program
# ---------------------------------------------------------------------------

def _frame_fn(refs_y, refs_cb, refs_cr, feed, sf_tables, st, host):
    """One picture: returns the decoded planes (Y[, Cb, Cr]) as int32."""
    dev = feed["pu"].device
    H, W = st["H"], st["W"]
    sub_x, sub_y = st["sub_x"], st["sub_y"]
    bd, bdc = st["bd"], st["bdc"]
    has_chroma = not st["mono"]
    pb_h, pb_w = feed["pu_idx"].shape
    w = torch.where

    # ---- per-cell PU parameter gather (from the natively painted pu_idx) --
    with tracing.span("tde.gather"):
        pidx = feed["pu_idx"].reshape(-1)
        covered = pidx >= 0
        # [Pcap, 10]: mv0x mv0y mv1x mv1y pf slot0 slot1 r0 r1 sl
        pu = feed["pu"]
        pc = pidx.long().clamp(0, pu.shape[0] - 1)
        pcell = pu[pc]
        ref_pocs = feed["ref_pocs"]
        cell = {"pf": w(covered, pcell[:, 4], 0)}
        for l in (0, 1):
            has = ((cell["pf"] >> l) & 1) != 0
            cell[f"mv{l}x"] = w(has, pcell[:, 2 * l], 0)
            cell[f"mv{l}y"] = w(has, pcell[:, 1 + 2 * l], 0)
            cell[f"slot{l}"] = w(has, pcell[:, 5 + l], 0)
            slot = pcell[:, 5 + l].long().clamp(0, ref_pocs.shape[0] - 1)
            cell[f"poc{l}"] = w(has, ref_pocs[slot], NOREF)
            cell[f"ridx{l}"] = w(has, pcell[:, 7 + l].clamp(min=0), 0)
        cell["slice"] = pcell[:, 9].clamp(0, st["n_slices"] - 1)

        recs = feed["slice_recs"]
        sl = cell["slice"].long()
        wg = {"weighted": (recs[sl, 6] != 0).to(torch.int32),
              "denom_l": recs[sl, 7], "denom_c": recs[sl, 8]}
        for l in (0, 1):
            r = cell[f"ridx{l}"].long().clamp(max=15)
            wg[f"lw{l}"] = recs[sl, 16 + l * 16 + r]
            wg[f"lo{l}"] = recs[sl, 48 + l * 16 + r]
            for c in (0, 1):
                wg[f"cw{l}{c}"] = recs[sl, 80 + (l * 16 + r) * 2 + c]
                wg[f"co{l}{c}"] = recs[sl, 144 + (l * 16 + r) * 2 + c]

    # ---- inter prediction over the cell grid ----
    with tracing.span("tde.mc"):
        Hc, Wc = H // sub_y, W // sub_x
        if st["has_inter"] and host["mc_on"]:
            y, cbp, crp = _mc_section(refs_y, refs_cb, refs_cr, cell, wg,
                                      st, pb_h, pb_w, feed)
            cov = covered.reshape(pb_h, pb_w)
            m = cov.repeat_interleave(4, 0).repeat_interleave(4, 1)[:H, :W]
            planes = [w(m, y, 0)]
            if has_chroma:
                mc_ = cov.repeat_interleave(4 // sub_y, 0) \
                    .repeat_interleave(4 // sub_x, 1)[:Hc, :Wc]
                planes += [w(mc_, cbp, 0), w(mc_, crp, 0)]
        else:
            planes = [torch.zeros((H, W), dtype=torch.int32, device=dev)]
            if has_chroma:
                planes += [torch.zeros((Hc, Wc), dtype=torch.int32,
                                       device=dev) for _ in range(2)]

    # ---- residual bins (densify + dequant + IDCT) ----
    with tracing.span("tde.residual"):
        bin_res = _residual_section(feed, sf_tables, st)

        # ---- inter residual add + clip ----
        if st["pallas_mc"]:
            _add_residual_stripes(planes, bin_res, feed, st)
        for lg in () if st["pallas_mc"] else st["lgs"]:
            s = 1 << lg
            bf = feed[f"bin{lg}"]
            ar = torch.arange(s, device=dev)
            for c, ch in ((0, "y"), (1, "cb"), (2, "cr")):
                if c > 0 and not has_chroma:
                    continue
                sc = bf[f"sc_{ch}"]  # [cap, 3] rows/x/y ; pad rows = -1
                if sc.shape[0] == 0:
                    continue
                rows = sc[:, 0]
                blk = bin_res[lg][rows.long().clamp(
                    0, bin_res[lg].shape[0] - 1)]
                iy = sc[:, 2, None, None] + ar[None, :, None]
                ix = sc[:, 1, None, None] + ar[None, None, :]
                ok = (rows >= 0)[:, None, None].expand(-1, s, s)
                planes[c] = _scatter(planes[c], iy.expand(-1, s, s),
                                     ix.expand(-1, s, s), blk, ok, add=True)
        planes[0] = planes[0].clamp(0, (1 << bd) - 1)
        if has_chroma:
            planes[1] = planes[1].clamp(0, (1 << bdc) - 1)
            planes[2] = planes[2].clamp(0, (1 << bdc) - 1)

        # ---- PCM scatter (pads carry index 1 << 30 and are dropped) ----
        for c in range(len(planes)):
            pcm = feed[f"pcm{c}"]
            if pcm.shape[0]:
                Wp = planes[c].shape[1]
                idx = pcm[:, 0].long()
                planes[c] = _scatter(planes[c], idx // Wp, idx % Wp,
                                     pcm[:, 1], idx >= 0)

    # ---- intra super-wave scans (one merged scan over all planes) ----
    with tracing.span("tde.intra"):
        planes = _intra_section(planes, feed, bin_res, st, host)

    # ---- loop filters ----
    with tracing.span("tde.deblock"):
        skip4 = (feed["cu4"] & 4) != 0
        if st["pcm_lf_disable"]:
            skip4 = skip4 | ((feed["cu4"] & 2) != 0)
        if st["run_deblock"]:
            planes = _deblock_section(planes, feed, recs, cell, skip4, st)
    with tracing.span("tde.sao"):
        if st["run_sao"]:
            planes = _sao_section(planes, feed, recs, skip4, st)
    if st["pallas_mc"]:
        # the fused store: each decoded plane, edge-replicated, into its
        # ring slot (in place; the MC reads of this picture are done)
        rings = [refs_y, refs_cb, refs_cr]
        for c, plane in enumerate(planes):
            hp = rings[c].shape[0] // RING_SLOTS
            row = host["slot_row"][c]
            rings[c][row:row + hp] = pad_replicate(plane, hp,
                                                   rings[c].shape[1])
        return tuple(planes) + tuple(rings)
    return tuple(planes)


def _residual_section(feed, sf_tables, st):
    """Residuals of every TU size bin of a picture: {lg: [N, S, S] int32},
    the levels themselves where a TU bypasses transform and quantisation.
    B4 densifies all bins in one launch into one buffer, and one launch of
    coef_cuda.residual_bins turns the levels into residuals there (escape
    corrections, dequant + inverse transform, RDPCM); then cross-component
    prediction (st["has_ccp"])."""
    lgs = st["lgs"]
    if not lgs:
        return {}
    bins = [(lg, feed[f"bin{lg}"]) for lg in lgs]
    buf, _ = coef_cuda.densify_bins(
        [(bf["cv"], bf["coff"], bf["qp"].shape[0], 1 << lg)
         for lg, bf in bins])
    bd = st["bd"]
    bin_res = dict(zip(lgs, coef_cuda.residual_bins(
        buf, bins, bd, st["bdc"], sf_tables if st["scaling"] else None)))
    if st.get("has_ccp"):
        # the partners are luma TUs of the same bin, which CCP leaves as
        # they are, so the bins take their terms in any order
        for lg, bf in bins:
            bin_res[lg] = ccp_add(bin_res[lg], bf["ccp_row"],
                                  bf["ccp_scale"], bd, st["bdc"])
    return bin_res


def _attached(prog, i, device):
    """The planes the parser attached for reference i of prog (a full
    decode), as int32 tensors on device, or None (a parse-only program)."""
    if i < len(prog.ref_planes) and prog.ref_planes[i] and \
            prog.ref_planes[i][0] is not None:
        return [torch.from_numpy(p.astype(np.int32)).to(device)
                for p in prog.ref_planes[i] if p is not None]
    return None


def pad_replicate(plane, hp: int, wp: int):
    """The plane at offset (PADT, PADL) of an [hp, wp] slot, its edges
    replicated outward (a clamped index gather: replicate padding is not
    implemented for int32 on every device)."""
    h, w = plane.shape
    dev = plane.device
    rows = (torch.arange(hp, device=dev) - mc_seg.PADT).clamp(0, h - 1)
    cols = (torch.arange(wp, device=dev) - mc_seg.PADL).clamp(0, w - 1)
    return plane[rows[:, None], cols[None, :]]


def _add_residual_stripes(planes, bin_res, feed, st):
    """The production residual add: per plane, the band stripes of every
    size bin (kernel B5), summed and added to the prediction."""
    H = st["H"]
    n_bands = (H + 3) // 4
    for c, ch in enumerate(("y", "cb", "cr")[:len(planes)]):
        Hc = H if c == 0 else st["ch"]
        Wc = st["W"] if c == 0 else st["cw"]
        OR = 4 if c == 0 else 4 // st["sub_y"]
        wout = max(256, (Wc + 127) & ~127)
        acc = None
        for lg in st["lgs"]:
            key = f"rs{lg}{ch}"
            if f"{key}.n" not in feed:
                continue
            stripes = mc_seg.residual_stripes(
                bin_res[lg], feed[f"{key}.n"], feed[f"{key}.sw"], OR=OR,
                S=1 << lg, Wout=wout, n_bands=n_bands)
            acc = stripes if acc is None else acc + stripes
        if acc is not None:
            planes[c] = planes[c] + acc.reshape(n_bands * OR, wout)[:Hc, :Wc]


def _mc_stripe_blocks(refs, feed, st, pb_h, pb_w, N, chroma):
    """The segment MC of one plane class: per list, kernel B3's stripes
    from the ring, cut to the cell blocks [N, rows, cols] of _merge."""
    H, W = st["H"], st["W"]
    sub_x, sub_y = max(st["sub_x"], 1), max(st["sub_y"], 1)
    if chroma:
        Hd, Wd = max(st["ch"], 1), max(st["cw"], 1)
        OR, cs, T, bd = 4 // sub_y, 4 // sub_x, 4, st["bdc"]
    else:
        Hd, Wd, OR, cs, T, bd = H, W, 4, 4, 8, st["bd"]
    hp, _ = mc_seg.pad_sizes(Hd, Wd)
    wout = max(256, (Wd + 127) & ~127)
    out = []
    for l in (0, 1) if st["use_l1"] else (0,):
        sy = mc_seg.mc_stripes(
            refs, feed[f"sg{l}n"], feed[f"sg{l}i"], feed["pu_wire"],
            list_idx=l, OR=OR, T=T, Hpad=hp, Wout=wout, n_bands=pb_h,
            KMAX=st["segk"], bd=bd, chroma=chroma, Hdim=Hd, Wdim=Wd,
            sub_x=sub_x, sub_y=sub_y)
        out.append(sy[:, :, :pb_w * cs].reshape(pb_h, OR, pb_w, cs).permute(
            0, 2, 1, 3).reshape(N, OR, cs))
    return out


def _mc_section(refs_y, refs_cb, refs_cr, cell, wg, st, pb_h, pb_w,
                feed=None):
    """Motion compensation and the weighted/bi merge: with st["pallas_mc"]
    per segment from the DPB rings (kernel B3), else per 4x4 cell from
    [R, h, w] reference stacks (the JAX program's non-Pallas branch)."""
    H, W = st["H"], st["W"]
    sub_x, sub_y = max(st["sub_x"], 1), max(st["sub_y"], 1)
    bd, bdc = st["bd"], st["bdc"]
    use_l1 = st["use_l1"]
    has_chroma = not st["mono"]
    dev = refs_y.device
    N = pb_h * pb_w
    qf = _i32(QPEL_FILTERS, dev)
    ef = _i32(EPEL_FILTERS, dev)
    n = torch.arange(N, device=dev, dtype=torch.int32)
    cy = (n // pb_w) * 4
    cx = (n % pb_w) * 4
    shx = 3 if sub_x == 2 else 2
    shy = 3 if sub_y == 2 else 2
    cs = 4 // sub_x
    csv = 4 // sub_y
    w = torch.where

    preds_l, preds_cb, preds_cr = [], [], []
    if st["pallas_mc"]:
        preds_l = _mc_stripe_blocks(refs_y, feed, st, pb_h, pb_w, N, False)
        if has_chroma:
            preds_cb = _mc_stripe_blocks(refs_cb, feed, st, pb_h, pb_w, N,
                                         True)
            preds_cr = _mc_stripe_blocks(refs_cr, feed, st, pb_h, pb_w, N,
                                         True)
    for l in () if st["pallas_mc"] else (0, 1) if use_l1 else (0,):
        mvx, mvy = cell[f"mv{l}x"], cell[f"mv{l}y"]
        slot = cell[f"slot{l}"]
        preds_l.append(_mc_plane(refs_y, slot, cx + (mvx >> 2),
                                 cy + (mvy >> 2), mvx & 3, mvy & 3, qf, 8, 4,
                                 bd))
        if has_chroma:
            cxc = cx // sub_x + (mvx >> shx)
            cyc = cy // sub_y + (mvy >> shy)
            fcx = (mvx & 7) if sub_x == 2 else ((mvx & 3) << 1)
            fcy = (mvy & 7) if sub_y == 2 else ((mvy & 3) << 1)
            preds_cb.append(_mc_plane(refs_cb, slot, cxc, cyc, fcx, fcy, ef,
                                      4, cs, bdc)[:, :csv, :cs])
            preds_cr.append(_mc_plane(refs_cr, slot, cxc, cyc, fcx, fcy, ef,
                                      4, cs, bdc)[:, :csv, :cs])

    pf = cell["pf"]
    bi = pf == 3
    first0 = (pf & 1) != 0     # the first prediction comes from list 0
    if use_l1:
        fsel = first0[:, None, None]
        p0_l = w(fsel, preds_l[0], preds_l[1])
        p1_l = preds_l[1]
        w0 = w(first0, wg["lw0"], wg["lw1"])
        o0 = w(first0, wg["lo0"], wg["lo1"])
    else:
        p0_l = p1_l = preds_l[0]
        w0, o0 = wg["lw0"], wg["lo0"]
    y_blk = _merge(p0_l, p1_l, bi, wg["weighted"], w0, o0, wg["lw1"],
                   wg["lo1"], wg["denom_l"], bd)
    y_plane = _cells_to_plane(y_blk, pb_h, pb_w, 4)[:H, :W]
    if not has_chroma:
        return y_plane, None, None

    if use_l1:
        pcb0 = w(fsel, preds_cb[0], preds_cb[1])
        pcr0 = w(fsel, preds_cr[0], preds_cr[1])
        pcb1, pcr1 = preds_cb[1], preds_cr[1]
        cbw0 = w(first0, wg["cw00"], wg["cw10"])
        cbo0 = w(first0, wg["co00"], wg["co10"])
        crw0 = w(first0, wg["cw01"], wg["cw11"])
        cro0 = w(first0, wg["co01"], wg["co11"])
    else:
        pcb0 = pcb1 = preds_cb[0]
        pcr0 = pcr1 = preds_cr[0]
        cbw0, cbo0 = wg["cw00"], wg["co00"]
        crw0, cro0 = wg["cw01"], wg["co01"]
    cb_blk = _merge(pcb0, pcb1, bi, wg["weighted"], cbw0, cbo0, wg["cw10"],
                    wg["co10"], wg["denom_c"], bdc)
    cr_blk = _merge(pcr0, pcr1, bi, wg["weighted"], crw0, cro0, wg["cw11"],
                    wg["co11"], wg["denom_c"], bdc)

    def to_plane(blk):
        return blk.reshape(pb_h, pb_w, csv, cs).permute(0, 2, 1, 3).reshape(
            pb_h * csv, pb_w * cs)[:H // sub_y, :W // sub_x]

    return y_plane, to_plane(cb_blk), to_plane(cr_blk)


# ---------------------------------------------------------------------------
# intra super-wave scan
# ---------------------------------------------------------------------------

def _intra_section(planes, feed, bin_res, st, host):
    """The intra scan of a picture: the scan arrays of every size bin from
    the uploaded records (intra_cuda.intra_bins: one memset and one launch
    on the card), then the scan.  A picture without intra records (every
    bin's depth 0) runs nothing and returns its planes."""
    depths = host["depths"]
    if not any(depths[intra_cuda.PLANE_OF[pc], lg]
               for pc, lg in st["intra_bins"]):
        return planes
    bins_by_plane = intra_cuda.intra_bins(feed["irecp"], st["intra_bins"],
                                          st["steps_cap"], depths,
                                          host["n_intra"])
    return _intra_scan_all(planes, bins_by_plane, bin_res, st,
                           host["nsteps"])


def _intra_scan_all(planes, bins_by_plane, bin_res, st, nsteps):
    """The intra scan: each plane padded once, the whole scan on the padded
    planes (intra_cuda.intra_scan: one persistent kernel launch on the
    card), the planes unpadded at the end."""
    shapes = [p.shape for p in planes]
    padded = [iw.pad_plane_for_scan(p, *iw.scan_pad_sizes(*p.shape))
              for p in planes]
    dev = planes[0].device
    tables = {lg: intra_cuda.mode_tables(1 << lg, dev)
              for lg in {lg for b in bins_by_plane.values() for lg in b}}
    intra_cuda.intra_scan(padded, bins_by_plane, bin_res, tables, nsteps,
                          [st["bd"]] + [st["bdc"]] * (len(planes) - 1))
    return [iw.unpad_plane(p, *shp) for p, shp in zip(padded, shapes)]


# ---------------------------------------------------------------------------
# loop filters
# ---------------------------------------------------------------------------

def _edge_ok_jnp(emap, feed, recs, sidx, cs, Hc, Wc, st):
    """Per-sample SAO edge validity across slice/tile boundaries (the JAX
    program's _edge_ok_jnp): ops.sao.edge_boundary_ok on the feed's
    per-CTB grids."""
    return edge_boundary_ok(emap, feed["slice_addr"],
                            recs[sidx.long(), 9] != 0, feed["tile_id"],
                            st["across_tiles"], cs, Hc, Wc)


def _deblock_section(planes, feed, recs, cell, skip4, st):
    """Deblock V then H, luma and chroma (frame_helpers.deblock_planes):
    the edge parameters from the feed's packed per-4x4 grids, the gather's
    cell grids and the skip mask in one launch, then one B8 call for luma
    and one B9 call for both chroma planes, each on the unpadded planes;
    returns contiguous planes.  The feed's optional positional masks
    allow_xv / allow_xh (the sharded decode's halo filter) gate the edges
    too."""
    grids = {k: feed[k] for k in deblock_cuda.GRID_KEYS}
    grids["unfilt"] = skip4
    for k in deblock_cuda.CELL_KEYS:
        grids[k] = cell[k]
    allow = (feed["allow_xv"], feed["allow_xh"]) if "allow_xv" in feed \
        else None
    return deblock_planes(planes, grids, recs, feed["slice_idx"],
                          feed["slice_addr"], feed["tile_id"], st, allow)


def _sao_section(planes, feed, recs, skip4, st):
    """SAO from the per-CTB parameter maps; one B10 kernel per plane.  The
    feed's optional positional masks eo_ok_y{c} / eo_ok_x{c} ([4, Hc] and
    [4, Wc] bool: whether both neighbours of an edge-offset class lie in
    the picture's rows and columns; the sharded decode's halo filter, whose
    padded tile holds the picture bounds inside it) gate edge_ok too."""
    H, W, sub_x, sub_y = st["H"], st["W"], st["sub_x"], st["sub_y"]
    ctb = st["ctb_size"]
    sidx = feed["slice_idx"].clamp(0, st["n_slices"] - 1).long()
    sao_on = [(recs[sidx, 4] != 0).to(torch.int32),
              (recs[sidx, 5] != 0).to(torch.int32)]

    def up(a, cs_y, cs_x, Hc, Wc):
        return a.repeat_interleave(cs_y, 0).repeat_interleave(cs_x, 1)[
            :Hc, :Wc].contiguous()

    def one_plane(c, on, cs_y, cs_x, Hc, Wc, skip, bd):
        t = up(feed["sao_t"][:, :, c] * on, cs_y, cs_x, Hc, Wc)
        e = up(feed["sao_eo"][:, :, c], cs_y, cs_x, Hc, Wc)
        b = up(feed["sao_band"][:, :, c], cs_y, cs_x, Hc, Wc)
        o = up(feed["sao_off"][:, :, c], cs_y, cs_x, Hc, Wc)
        eok = _edge_ok_jnp(e, feed, recs, sidx, (cs_y, cs_x), Hc, Wc, st) \
            if st["multi_boundary"] else None
        if f"eo_ok_x{c}" in feed:
            cls, dev = e.long(), e.device
            pos = feed[f"eo_ok_y{c}"][cls, torch.arange(Hc, device=dev)[
                :, None]] & feed[f"eo_ok_x{c}"][cls, torch.arange(
                    Wc, device=dev)[None, :]]
            eok = pos if eok is None else eok & pos
        return sao_cuda.sao_plane_fused(planes[c].contiguous(), t, e, b, o,
                                        skip, bit_depth=bd, edge_ok=eok)

    skip_l = up(skip4, 4, 4, H, W)
    out = [one_plane(0, sao_on[0], ctb, ctb, H, W, skip_l, st["bd"])]
    if len(planes) > 1:
        Hc, Wc = st["ch"], st["cw"]
        cs_y, cs_x = ctb // sub_y, ctb // sub_x
        skip_c = up(skip4, 4 // sub_y, 4 // sub_x, Hc, Wc)
        out += [one_plane(c, sao_on[1], cs_y, cs_x, Hc, Wc, skip_c, st["bdc"])
                for c in (1, 2)]
    return out


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------

class FusedDecoder:
    """One whole-picture program per picture on `device` (the CUDA card
    unless the caller asks for the CPU).

    Usage:
        fd = FusedDecoder()
        fd.plan_stream(progs)       # optional: final capacities up front
        planes = fd.decode(prog)    # device tensors

    use_pallas_mc (True on the card, False on the CPU, settable) selects
    the production formulation; its references live in the DPB ring
    (LRU over 2*MAX_REFS slots, slot 2*MAX_REFS kept gray), else in a dict
    of decoded planes by POC.  run_deblock / run_sao (as in the JAX
    package) switch the loop filters of every picture off.
    last_wire_bytes: the bytes the last production picture's feed upload
    moved.  pipeline_pictures: the pictures decoded by
    pipeline.reconstruct (more than MAX_REFS references, or on the
    production formulation more than mc_seg.MAX_PUS PUs).
    """

    def __init__(self, device="cuda", run_deblock=True, run_sao=True):
        self.device = torch.device(device)
        self.run_deblock = run_deblock
        self.run_sao = run_sao
        self.packer = FeedPacker()
        self.dpb = {}
        self._order = []
        # the production formulation on the card, as the JAX package turns
        # it on for TPU backends
        self.use_pallas_mc = self.device.type == "cuda"
        self._stack = None
        self._stack_dims = None
        self._slot_of = {}
        self._slot_lru = []
        self.last_wire_bytes = None
        # two host scratch slots of the sparse upload, used in turn; each
        # keeps the event recorded after the copies that read it
        self._scratch = [None, None]
        self._scratch_event = [None, None]
        self._scratch_turn = 0
        self.pipeline_pictures = 0

    def plan_stream(self, progs):
        """Pre-size every capacity watermark from a list of pictures (those
        that go to pipeline.reconstruct need none)."""
        self.packer.plan_stream(
            [p for p in progs if not fdp.routed(p, self.use_pallas_mc)],
            pallas_mc=self.use_pallas_mc)

    def reset(self):
        """Forget every decoded picture: the dict of planes and the ring,
        which the next picture allocates anew (at its own size)."""
        self.dpb.clear()
        self._order.clear()
        self._slot_of = {}
        self._slot_lru = []
        self._stack = None
        self._stack_dims = None

    # -- the padded DPB ring (production formulation) --

    def _ensure_stack(self, prog):
        H, W = prog.height, prog.width
        cw = max(prog.chroma_width, 1)
        ch = max(prog.chroma_height, 1)
        dims = (mc_seg.pad_sizes(H, W), mc_seg.pad_sizes(ch, cw),
                mc_seg.pad_sizes(ch, cw))
        if self._stack is not None and self._stack_dims == dims:
            return dims
        self._stack = [
            torch.full((RING_SLOTS * hh, ww),
                       1 << (prog.bit_depth[min(c, 1)] - 1),
                       dtype=torch.int32, device=self.device)
            for c, (hh, ww) in enumerate(dims)]
        self._stack_dims = dims
        self._slot_of = {}
        self._slot_lru = []
        return dims

    def _alloc_slot(self, poc):
        """The ring slot of `poc`: its own if it has one (touched), else a
        free slot, else the least recently used one."""
        if poc in self._slot_of:
            self._slot_lru.remove(poc)
            self._slot_lru.append(poc)
            return self._slot_of[poc]
        if len(self._slot_lru) >= 2 * MAX_REFS:
            old = self._slot_lru.pop(0)
            slot = self._slot_of.pop(old)
        else:
            slot = len(self._slot_lru)
            used = set(self._slot_of.values())
            while slot in used:
                slot += 1
        self._slot_of[poc] = slot
        self._slot_lru.append(poc)
        return slot

    def _store_stack(self, poc, planes, prog):
        """Write planes decoded elsewhere (a seek) into a ring slot."""
        dims = self._ensure_stack(prog)
        slot = self._alloc_slot(poc)
        for c in range(min(3, len(planes))):
            hh, ww = dims[c]
            self._stack[c][slot * hh:(slot + 1) * hh] = pad_replicate(
                planes[c], hh, ww)

    def _refs(self, prog):
        """The references of `prog` and the reference index -> slot map.

        Production formulation: the rings; a reference not in the ring is
        seeded from the planes the parser attached (a seek), else reads
        the gray slot.  Else: [MAX_REFS, h, w] stacks per plane from this
        decoder's planes, the attached planes, or mid-gray."""
        pocs = list(prog.ref_pocs)
        H, W = prog.height, prog.width
        cw = max(prog.chroma_width, 1)
        ch = max(prog.chroma_height, 1)
        dev = self.device

        if self.use_pallas_mc:
            self._ensure_stack(prog)
            slot_map = {}
            for i, poc in enumerate(pocs[:MAX_REFS]):
                if poc not in self._slot_of:
                    planes = _attached(prog, i, dev)
                    if planes is not None:
                        self._store_stack(poc, planes, prog)
                if poc in self._slot_of:
                    # an active reference must not be evicted by this
                    # picture's own slot
                    self._slot_lru.remove(poc)
                    self._slot_lru.append(poc)
                slot_map[i] = self._slot_of.get(poc, 2 * MAX_REFS)
            return self._stack, slot_map

        def full(shape, v):
            return torch.full(shape, v, dtype=torch.int32, device=dev)

        slot_map = {}
        stack = [[], [], []]
        for i, poc in enumerate(pocs[:MAX_REFS]):
            planes = self.dpb.get(poc) or _attached(prog, i, dev)
            if planes is None:
                planes = [full((H, W), 1 << (prog.bit_depth[0] - 1))]
                if prog.chroma_width:
                    planes += [full((ch, cw), 1 << (prog.bit_depth[c] - 1))
                               for c in (1, 2)]
            slot_map[i] = len(stack[0])
            for c in range(3):
                stack[c].append(planes[c] if c < len(planes)
                                else full((1, 1), 0))
        while len(stack[0]) < MAX_REFS:
            stack[0].append(full((H, W), 0))
            stack[1].append(full((ch, cw), 0))
            stack[2].append(full((ch, cw), 0))
        return [torch.stack(s) for s in stack], slot_map

    def _dpb_refs(self, prog):
        """[Y, Cb, Cr] of every reference of `prog` from this decoder's
        DPB: its ring slot cropped to the picture (production formulation;
        every reference touched in the LRU, so that none is evicted while
        the picture reads it) or its decoded planes; a POC the decoder
        does not hold is read from the planes the parser attached (a seek;
        they seed the ring); else RuntimeError."""
        pocs = list(prog.ref_pocs)
        held = self._slot_of if self.use_pallas_mc else self.dpb
        if self.use_pallas_mc:
            self._ensure_stack(prog)
            for poc in pocs:
                if poc in held:
                    self._slot_lru.remove(poc)
                    self._slot_lru.append(poc)
        refs = []
        for i, poc in enumerate(pocs):
            if poc not in held:
                planes = _attached(prog, i, self.device)
                if planes is None:
                    raise RuntimeError(
                        f"picture POC {prog.poc}: reference POC {poc} is "
                        "neither in the decoder's DPB nor attached to the "
                        "program")
                if not self.use_pallas_mc:
                    refs.append(planes)
                    continue
                self._store_stack(poc, planes, prog)
            refs.append(self._slot_planes(poc, prog) if self.use_pallas_mc
                        else self.dpb[poc])
        return refs

    def _slot_planes(self, poc, prog):
        """The planes of `poc` in the ring: views of its slot, cropped to
        the picture (the slot holds them edge-replicated)."""
        slot = self._slot_of[poc]
        dims = [(prog.height, prog.width)] + \
            [(prog.chroma_height, prog.chroma_width)] * 2
        return [ring[slot * hh + mc_seg.PADT:slot * hh + mc_seg.PADT + h,
                     mc_seg.PADL:mc_seg.PADL + w]
                for ring, (hh, _), (h, w) in zip(
                    self._stack, self._stack_dims,
                    dims[:3 if prog.chroma_width else 1])]

    def _decode_pipeline(self, prog):
        """A picture with more than MAX_REFS references (or PUs beyond the
        segment words' index), as the JAX package decodes the former:
        pipeline.reconstruct with the host intra loop and this decoder's
        loop filter flags, then stored as any decoded picture."""
        planes = pipeline.reconstruct(prog, self.run_deblock, self.run_sao,
                                      device_intra=False, device=self.device,
                                      ref_planes=self._dpb_refs(prog))
        out = tuple(planes[:3 if prog.chroma_width else 1])
        if self.use_pallas_mc:
            self._store_stack(prog.poc, out, prog)
        else:
            self._store(prog.poc, out)
        self.pipeline_pictures += 1
        return out

    def decode(self, prog: FrameProgramData):
        with tracing.span("tde.decode"):
            if fdp.routed(prog, self.use_pallas_mc):
                with tracing.span("tde.routed"):
                    return self._decode_pipeline(prog)
            return self._decode_fused(prog)

    def _decode_fused(self, prog):
        pk = self.packer
        pk.note_rext(prog)
        H, W = prog.height, prog.width
        has_chroma = prog.chroma_width > 0
        sub_x = W // prog.chroma_width if has_chroma else 1
        sub_y = H // prog.chroma_height if has_chroma else 1
        bd = prog.bit_depth[0]
        bdc = prog.bit_depth[1] if has_chroma else bd
        pallas = bool(self.use_pallas_mc)

        refs, slot_map = self._refs(prog)
        slot_row = None
        if pallas:
            # the fused store's slot, allocated before packing: the
            # program writes it through the shipped per-plane ring rows
            slot = self._alloc_slot(prog.poc)
            slot_row = np.array([slot * self._stack_dims[c][0]
                                 for c in range(3)], np.int32)
        with tracing.span("tde.pack"):
            if pallas and not pk.has_ccp and fdp.native_live(prog):
                layout, buf, lgs, n_slices = pk.pack_native(prog, slot_map,
                                                            slot_row)
            else:
                layout, buf, lgs, n_slices = pk.pack(prog, slot_map,
                                                     slot_row,
                                                     pallas_mc=pallas)

        sft = None
        if prog.scaling_factors is not None:
            sft = tuple(
                torch.from_numpy(
                    prog.scaling_factors[lg].astype(np.int32)).to(self.device)
                if lg in prog.scaling_factors else torch.zeros(
                    (6, 1 << lg, 1 << lg), dtype=torch.int32,
                    device=self.device) for lg in (2, 3, 4, 5))

        # sticky program variant, as in the JAX decoder
        pk.has_inter = pk.has_inter or len(prog.pus) > 0
        pk.multi = pk.multi or fdp._multi_boundary(prog)
        st = {
            "H": H, "W": W, "sub_x": sub_x, "sub_y": sub_y,
            "cw": max(prog.chroma_width, 1), "ch": max(prog.chroma_height, 1),
            "bd": bd, "bdc": bdc, "mono": not has_chroma,
            "ctb_size": prog.ctb_size,
            "n_slices": n_slices,
            "use_l1": pk.use_l1,
            "has_inter": pk.has_inter,
            "scaling": sft is not None,
            "lgs": tuple(lgs),
            "pcm_lf_disable": bool(prog.pcm_loop_filter_disable),
            "across_tiles": bool(prog.across_tiles),
            "multi_boundary": pk.multi,
            "run_deblock": bool(self.run_deblock),
            "run_sao": bool(self.run_sao),
            "steps_cap": pk.caps["steps"] or 1,
            "intra_bins": tuple(sorted(pk.intra_lgs)),
            "pallas_mc": pallas,
            "segk": pk.caps["segk"] or 1,
            "has_ccp": pk.has_ccp,
        }
        if not pallas:
            with tracing.span("tde.upload"):
                dbuf = torch.from_numpy(buf).to(self.device)
            out = _compiled_impl(refs[0], refs[1], refs[2], dbuf, sft, st,
                                 layout, host_buf=buf,
                                 n_intra=pk.last_intra)
            self._store(prog.poc, out)
            return out
        with tracing.span("tde.upload"):
            dbuf = self._sparse_upload(buf)
        out_all = _compiled_impl(refs[0], refs[1], refs[2], dbuf, sft, st,
                                 layout, host_buf=buf, n_intra=pk.last_intra)
        n_pl = 3 if has_chroma else 1
        self._stack = list(out_all[n_pl:])
        return tuple(out_all[:n_pl])

    def _sparse_upload(self, buf):
        """Upload the feed's nonzero SPARSE_BLOCK-word blocks and the
        inverse block map, and rebuild the feed on the device (kernel B1);
        a feed with few zero blocks goes up whole.  The compact blocks are
        built in one of two host scratch slots (pinned on the card), used
        in turn: before a slot is refilled, the copies that last read it
        are waited for (their event), so pictures in flight never see
        their upload overwritten."""
        B = SPARSE_BLOCK
        total = int(buf.size)
        nb = (total + B - 1) // B
        turn = self._scratch_turn = self._scratch_turn ^ 1
        if self._scratch_event[turn] is not None:
            self._scratch_event[turn].synchronize()
            self._scratch_event[turn] = None
        scratch = self._scratch[turn]
        if scratch is None or scratch[1].shape[0] < nb:
            pin = self.device.type == "cuda"
            scratch = (torch.empty((nb, B), dtype=torch.int32,
                                   pin_memory=pin),
                       torch.empty(nb, dtype=torch.int32, pin_memory=pin))
            self._scratch[turn] = scratch
        cb_t, inv_t = scratch
        M, ix = compact_blocks(buf, B, cb_t.numpy(), SPARSE_ROUND)
        if M >= nb:
            # few zero blocks: the plain upload is no larger
            self.last_wire_bytes = total * 4
            return torch.from_numpy(buf).to(self.device)
        inv = inv_t.numpy()[:nb]
        inv.fill(-1)
        valid = ix < nb
        inv[ix[valid]] = np.flatnonzero(valid)
        self.last_wire_bytes = (M * B + nb) * 4
        dcb = cb_t[:M].to(self.device, non_blocking=True)
        dinv = inv_t[:nb].to(self.device, non_blocking=True)
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            self._scratch_event[turn] = ev
        return expand.expand_blocks(dcb, dinv, total=total, B=B)

    def _store(self, poc, planes):
        self.dpb[poc] = planes
        self._order.append(poc)
        while len(self._order) > 2 * MAX_REFS:
            old = self._order.pop(0)
            if old in self.dpb and old not in self._order:
                del self.dpb[old]


def compact_blocks_plain(buf, B: int, out, round_to: int = SPARSE_ROUND):
    """The nonzero B-word blocks of buf, in order, into out[:M]: returns
    (M, idx[:M]) with M rounded up to a multiple of round_to blocks
    (padding rows zero, idx 1 << 30), or an M above out's capacity when
    they do not fit (then out is not written)."""
    total = buf.size
    nb = (total + B - 1) // B
    padded = buf if total == nb * B else np.pad(buf, (0, nb * B - total))
    blocks = padded.reshape(nb, B)
    nz = np.flatnonzero(blocks.any(axis=1))
    M = max(round_to, -(-len(nz) // round_to) * round_to)
    if M > out.shape[0]:
        return M, np.zeros(0, np.int32)
    out[:len(nz)] = blocks[nz]
    out[len(nz):M] = 0
    ix = np.full(M, 1 << 30, np.int32)
    ix[:len(nz)] = nz
    return M, ix


def compact_blocks(buf, B: int, out, round_to: int = SPARSE_ROUND):
    """compact_blocks_plain by the native tde265_compact_blocks (one pass
    in C), into the [cap, B] int32 array out."""
    ix = np.empty(out.shape[0], np.int32)
    M = _native.lib().tde265_compact_blocks(
        buf.ctypes.data_as(ct.c_void_p), buf.size, B, round_to,
        out.ctypes.data_as(ct.c_void_p), ix.ctypes.data_as(ct.c_void_p),
        out.shape[0])
    if M < 0:       # more blocks than out holds
        return out.shape[0] + 1, ix[:0]
    return int(M), ix[:M]
