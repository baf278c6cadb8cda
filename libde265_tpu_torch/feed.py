"""Host feed packer: one int32 buffer plus a layout per picture (numpy).

A copy of the numpy packer of ``libde265_tpu/fused_decode.py``
(``_pack_numpy``, ``_grow`` and ``plan_stream``, with ``_bin_tus``,
``_intra_records_native``, ``_plan_intra`` and ``_pack_pcm``; the segment
planning lives in ``ops/mc_seg.py``), kept here so that the port never
imports JAX.  A program without the native intra plan (``prog.ip`` None)
has its intra records scheduled by ``_plan_intra``, as in the JAX
package.  Both of
its formulations are here: with ``pallas_mc`` the production feed (the MC
segment index feed ``sg{l}n``/``sg{l}i``, the residual band feed
``rs{lg}{ch}.n``/``.sw`` in place of ``bin{lg}.sc_*``, reference POCs by
DPB ring slot, the halfword grid ``g4`` and the ring rows ``slot_row``),
else the ``use_pallas_mc=False`` feed.  For the same sequence of pictures
it returns the same ``(layout, buf)`` word for word as the JAX packer,
capacity watermarks included; ``tests/test_torch_feed.py`` holds the two
against each other.  With cross-component prediction latched, both
formulations ship each bin's CCP partner rows and scales.  Where the
chroma bit depth differs from the luma depth (no JAX feed has such a
stream), both packers also ship each TU row's channel (``bin{lg}.cidx``).

``FeedPacker.pack_native`` builds the production feed in C++
(``native/src/feedpack.cc``, through ``tde265_pack_caps`` and
``tde265_pack_feed``) from the program's live native source, word for
word the feed of ``pack(..., pallas_mc=True)``
(``tests/test_torch_native_pack.py``).  It carries no CCP fields, so the
decoder uses it only while no CCP has been seen in the stream.
"""
from __future__ import annotations

import ctypes as ct

import numpy as np

from .decoder import (OP_INTRA, OP_RESIDUAL, TU_INTRA, TU_RDPCM,
                      FrameProgramData)
from .ops import mc_seg
from .ops.deblock import NOREF
from .ops.intra import IntraContext
from .ops.intra_wave import border_plan
from .ops.mc_seg import pus_to_wire  # noqa: F401  (re-exported)

MAX_REFS = 8
RING_SLOTS = 2 * MAX_REFS + 1   # DPB ring slots; slot 2*MAX_REFS is gray

# intra super-wave per-step capacities (blocks of size 1<<lg per scan step);
# MUST match kWaveCap in native/src/intraplan.cc.
WAVE_CAP = {2: 256, 3: 128, 4: 64, 5: 16}

# irec columns (flat per-block intra record feed):
#   0 mode, 1 edge, 2 y0, 3 x0, 4 flags(1 unavail|2 filt|4 strong|8 valid),
#   5 rrow, 6 step, 7 slot, 8 cidx, 9 lg, 10..14 border-availability bitmask
IREC_COLS = 15
AVAIL_WORDS = 5  # ceil((4*32+1)/32) for the largest block size

_PLANE_CLASS = {0: "y", 1: "cb", 2: "cr"}


def _pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def _bin_tus(prog: FrameProgramData):
    """Vectorized size-binning of the TU records.

    Returns ({lg: dict}, tu_bin_lg, tu_bin_row): per-bin TU arrays, the
    CSR coefficient stream and the inter residual scatter targets.

    Coefficient wire format: 8-bit entries, FOUR per int32 word
    (little-endian byte order), positions delta-coded in raster order per
    TU.  A running position P starts at -1; an entry with val!=0 advances P
    by dpos+1 and emits level `val` (4-bit signed, clamped to +-7) at P; a
    zero byte advances P by 15 and emits nothing.  |val|>7 escapes ship as
    (cfx, cfv) corrections added after densification.  coff is in ENTRY
    units (multiples of 4).
    """
    tus = prog.tus
    bins = {}
    tu_bin_lg = np.full(len(tus), -1, np.int32)
    tu_bin_row = np.full(len(tus), -1, np.int32)
    if len(tus) == 0:
        return bins, tu_bin_lg, tu_bin_row

    # cross-component prediction pairing: each scaled chroma TU takes the
    # most recent luma TU in OP_RESIDUAL order, when it has the same size
    # (4:4:4, the same geometry)
    tu_ccp_scale = np.zeros(len(tus), np.int32)
    tu_ccp_partner = np.full(len(tus), -1, np.int64)
    if (tus["cross_comp_scale"] != 0).any():
        ridx = prog.ops["idx"][prog.ops["kind"] == OP_RESIDUAL] \
            .astype(np.int64)
        is_l = tus["cidx"][ridx] == 0
        pos = np.where(is_l, np.arange(len(ridx)), -1)
        last = np.maximum.accumulate(pos)
        sel = (tus["cidx"][ridx] != 0) & \
              (tus["cross_comp_scale"][ridx] != 0) & (last >= 0)
        tt = ridx[sel]
        pp = ridx[np.clip(last, 0, None)][sel]
        same = tus["log2_size"][tt] == tus["log2_size"][pp]
        tt, pp = tt[same], pp[same]
        tu_ccp_scale[tt] = tus["cross_comp_scale"][tt]
        tu_ccp_partner[tt] = pp

    for lg in (2, 3, 4, 5):
        sel = np.nonzero(tus["log2_size"] == lg)[0]
        if len(sel) == 0:
            continue
        n = len(sel)
        t = tus[sel]
        tu_bin_lg[sel] = lg
        tu_bin_row[sel] = np.arange(n)
        S = 1 << lg
        starts = t["coeff_start"].astype(np.int64)
        ncs = t["ncoeff"].astype(np.int64)
        total = int(ncs.sum())
        if total:
            off = np.concatenate([[0], np.cumsum(ncs)[:-1]])
            runs = np.repeat(np.arange(n), ncs)
            j_in = np.arange(total, dtype=np.int64) - np.repeat(off, ncs)
            src = np.clip(np.repeat(starts, ncs) + j_in, 0,
                          len(prog.coeff_val) - 1)
            cval = prog.coeff_val[src].astype(np.int32)
            cposw = prog.coeff_pos[src].astype(np.int32)
            p10 = (cposw >> 6) * S + (cposw & 63)
            # sort by position within each TU (positions unique per TU)
            order = np.argsort(runs * (S * S) + p10, kind="stable")
            runs, p10, cval = runs[order], p10[order], cval[order]
            prev = np.empty(total, np.int64)
            prev[1:] = p10[:-1]
            prev[np.concatenate([[0], off[1:][ncs[1:] > 0]]).astype(
                np.int64)] = -1
            gaps = p10 - prev - 1
            adv = gaps // 15                  # leading zero (advance) bytes
            cnt_c = adv + 1                   # bytes per coefficient
            ent_per_tu = np.zeros(n, np.int64)
            np.add.at(ent_per_tu, runs, cnt_c)
            coff = np.concatenate(
                [[0], np.cumsum((ent_per_tu + 3) & ~3)]).astype(np.int32)
            cum = np.cumsum(cnt_c)
            cum0 = np.concatenate([[0], cum])
            within_incl = cum - cum0[np.repeat(off, ncs)]
            cl = np.clip(cval, -7, 7)
            bytestream = np.zeros(int(coff[-1]), np.uint8)
            bytestream[coff[runs] + within_incl - 1] = \
                ((gaps - 15 * adv) & 0xF) | ((cl & 0xF) << 4)
            cv = bytestream.view(np.int32)
            esc = cval != cl
            cfx = (runs[esc] * S * S + p10[esc]).astype(np.int32)
            cfv = (cval - cl)[esc].astype(np.int32)
        else:
            coff = np.zeros(n + 1, np.int32)
            cv = np.zeros(0, np.int32)
            cfx = np.zeros(0, np.int32)
            cfv = np.zeros(0, np.int32)
        flags = t["flags"].astype(np.int32)
        intra = (flags & TU_INTRA) != 0
        cidx = t["cidx"].astype(np.int32)
        if prog.scaling_factors is not None:
            if lg == 5:
                mid = np.where(intra, 0, 1)
            else:
                mid = cidx + np.where(intra, 0, 3)
        else:
            mid = np.zeros(n, np.int32)
        b = {"qp": t["qp"].astype(np.int32), "flags": flags, "mid": mid,
             "n": n, "cv": cv, "coff": coff, "cfx": cfx, "cfv": cfv}
        # the partner's row in this bin (-1: no CCP term)
        b["ccp_scale"] = tu_ccp_scale[sel]
        ppr = tu_ccp_partner[sel]
        b["ccp_row"] = np.where(
            ppr >= 0, tu_bin_row[np.clip(ppr, 0, None)], -1).astype(np.int32)
        # inter residual scatter targets per channel; a chroma TU whose own
        # cbf is 0 still scatters when it carries a CCP luma term
        inter_nz = ~intra & ((t["ncoeff"] > 0) | (b["ccp_scale"] != 0))
        for ch, m in (("y", inter_nz & (cidx == 0)),
                      ("cb", inter_nz & (cidx == 1)),
                      ("cr", inter_nz & (cidx == 2))):
            rows = np.nonzero(m)[0].astype(np.int32)
            b[f"sc_{ch}"] = np.stack(
                [rows, t["x"][rows].astype(np.int32),
                 t["y"][rows].astype(np.int32)], axis=1) if len(rows) else \
                np.zeros((0, 3), np.int32)
        bins[lg] = b
    return bins, tu_bin_lg, tu_bin_row


def _pack_irec(irec: np.ndarray) -> np.ndarray:
    """Wire-compact intra records: [n, 15] int32 -> [8, n] column-major.

    w0 = mode(6) | edge(4)<<6 | flags(4)<<10 | cidx(2)<<14 | lg(3)<<16 |
         step(13)<<19;  w1 = y0(16) | x0(16)<<16;
    w2 = (rrow+1)(22) | slot(10)<<22 (rrow rides +1: -1 = no residual);
    w3..w7 = availability words."""
    n = irec.shape[0]
    p = np.zeros((8, n), np.int32)
    p[0] = (irec[:, 0] | (irec[:, 1] << 6) | (irec[:, 4] << 10) |
            (irec[:, 8] << 14) | (irec[:, 9] << 16) | (irec[:, 6] << 19))
    p[1] = irec[:, 2] | (irec[:, 3] << 16)
    p[2] = (irec[:, 5] + 1) | (irec[:, 7] << 22)
    p[3:8] = irec[:, 10:15].T
    return p


def bin_depths(cidx, lg, step) -> np.ndarray:
    """Depth (largest step + 1; 0 without a record) of every (plane, lg)
    bin of intra records given by their planes, sizes and steps (numpy
    integer arrays): an int64 array [4, 8] by [plane, lg], in one pass."""
    d = np.zeros(32, np.int64)
    np.maximum.at(d, (cidx & 3) | ((lg & 7) << 2),
                  step.astype(np.int64) + 1)
    return d.reshape(8, 4).T


def record_depths(w0: np.ndarray) -> np.ndarray:
    """bin_depths of wire records from their word 0 alone (_pack_irec):
    pass only the picture's own records, not the padding of the feed's
    capacity (which has plane 0, lg 0)."""
    w = w0.view(np.uint32)      # step's top bit is the sign bit
    return bin_depths(w >> 14, w >> 16, w >> 19)


def _avail_words(av: np.ndarray) -> np.ndarray:
    """Pack a [n, nb] bool availability matrix into [n, AVAIL_WORDS] int32
    (little-endian bit order, bit k of word k>>5 = sample k)."""
    n, nb = av.shape
    padded = np.zeros((n, AVAIL_WORDS * 32), bool)
    padded[:, :nb] = av
    return np.packbits(padded, axis=1, bitorder="little").view(np.int32)


def _intra_records_native(prog: FrameProgramData):
    """Flat intra record array from the native plan (intraplan.cc): per
    block metadata plus border availability bits; the border positions
    and the substitution chain are re-derived on the device."""
    ip = prog.ip
    recs = prog.intras
    n = len(recs)
    steps = ip["step"].astype(np.int32)
    n_steps = int(steps.max(initial=-1)) + 1
    irec = np.zeros((n, IREC_COLS), np.int32)
    irec[:, 0] = recs["mode"]
    irec[:, 1] = ip["edge"]
    irec[:, 2] = recs["y"]
    irec[:, 3] = recs["x"]
    fl = ip["flags"].astype(np.int32) | 8
    irec[:, 4] = fl
    irec[:, 5] = ip["rrow"]
    irec[:, 6] = steps
    irec[:, 7] = ip["slot"]
    irec[:, 8] = recs["cidx"]
    lg_all = recs["log2_size"].astype(np.int32)
    irec[:, 9] = lg_all
    boff = ip["boff"].astype(np.int64)
    bsub = ip["bsub"]
    nsteps_pc = np.zeros(3, np.int32)
    for c in (0, 1, 2):
        m = recs["cidx"] == c
        if m.any():
            nsteps_pc[c] = int(steps[m].max()) + 1
    for lg in (2, 3, 4, 5):
        sel = np.nonzero(lg_all == lg)[0]
        if not len(sel):
            continue
        nb = 4 * (1 << lg) + 1
        bidx = boff[sel][:, None] + np.arange(nb)
        # available <=> substitution maps the sample to itself (native sets
        # bsub[k]=k also for all-unavailable blocks, so mask those out)
        av = (bsub[bidx] == np.arange(nb)) & ((fl[sel] & 1) == 0)[:, None]
        irec[sel, 10:10 + AVAIL_WORDS] = _avail_words(av)
    return irec, n_steps, nsteps_pc


def _plan_intra(prog: FrameProgramData, tu_bin_lg, tu_bin_row):
    """List-schedule the intra blocks into capacity-limited super-waves.

    Python fallback for streams decoded without the native plan (prog.ip is
    None).  Emits the same flat irec array as _intra_records_native.
    """
    if len(prog.intras) == 0:
        return np.zeros((0, IREC_COLS), np.int32), 0, np.zeros(3, np.int32)
    ctx = IntraContext(prog.width, prog.height, prog.ctb_size, prog.cu_info,
                       slice_addr=prog.slice_addr, tile_id=prog.tile_id)
    chroma444 = prog.chroma_width == prog.width and prog.chroma_width > 0

    # residual TU for each intra op (same x/y/cidx, next in decode order)
    resid_of = {}
    pending = {}
    order = []
    for op in prog.ops:
        if op["kind"] == OP_INTRA:
            rec = prog.intras[op["idx"]]
            key = (int(rec["x"]), int(rec["y"]), int(rec["cidx"]))
            pending[key] = int(op["idx"])
            order.append(int(op["idx"]))
        elif op["kind"] == OP_RESIDUAL:
            t = int(op["idx"])
            if not (prog.tus["flags"][t] & TU_INTRA):
                continue
            tu = prog.tus[t]
            key = (int(tu["x"]), int(tu["y"]), int(tu["cidx"]))
            i = pending.get(key)
            if i is not None:
                resid_of[i] = t

    wmaps = {}
    counts = {}   # (cidx, lg) -> list of per-step counts
    rows = []     # irec rows
    n_steps = 0
    nsteps_pc = np.zeros(3, np.int32)
    for i in order:
        rec = prog.intras[i]
        c = int(rec["cidx"])
        if c == 0:
            sub_x = sub_y = 1
            H, Wd = prog.height, prog.width
        else:
            sub_x = prog.width // prog.chroma_width
            sub_y = prog.height // prog.chroma_height
            H, Wd = prog.chroma_height, prog.chroma_width
        if c not in wmaps:
            wmaps[c] = np.zeros(((H + 3) // 4, (Wd + 3) // 4), np.int32)
        wmap = wmaps[c]
        x0, y0 = int(rec["x"]), int(rec["y"])
        lg = int(rec["log2_size"])
        nT = 1 << lg
        pos, subst, unavail = border_plan(ctx, x0, y0, nT, sub_x, sub_y, H, Wd)
        if unavail:
            dep = 0
        else:
            have = subst == np.arange(len(subst))
            cells = pos[have] >> 2
            dep = int(wmap[cells[:, 0], cells[:, 1]].max(initial=0))
        key = (c, lg)
        cap = WAVE_CAP[lg]
        cnt = counts.setdefault(key, [])
        step = dep  # 0-based step index; block must run at step >= dep
        while True:
            while len(cnt) <= step:
                cnt.append(0)
            if cnt[step] < cap:
                break
            step += 1
        slot = cnt[step]
        cnt[step] += 1
        wmap[y0 >> 2:(y0 + nT + 3) >> 2, x0 >> 2:(x0 + nT + 3) >> 2] = step + 1
        n_steps = max(n_steps, step + 1)
        nsteps_pc[c] = max(nsteps_pc[c], step + 1)

        mode = int(rec["mode"])
        filt = False
        if (c == 0 or chroma444) and not ctx.smoothing_disabled:
            if mode != 1 and nT != 4:
                mind = min(abs(mode - 26), abs(mode - 10))
                thresh = 7 if nT == 8 else (1 if nT == 16 else 0)
                filt = True if mode == 0 else (mind > thresh)
        strong = filt and ctx.strong_smoothing and c == 0 and nT == 32
        edge = 0
        if c == 0 and nT < 32:
            edge = {1: 1, 26: 2, 10: 3}.get(mode, 0)
        t = resid_of.get(i)
        rrow = -1
        if t is not None and tu_bin_lg[t] == lg:
            rrow = int(tu_bin_row[t])
        elif t is not None:
            # residual TU size differs from the intra block (cannot happen
            # in HEVC: intra prediction operates per transform block)
            raise ValueError("intra/TU size mismatch")
        nb = 4 * nT + 1
        av = (subst == np.arange(nb)) & (not unavail)
        row = np.zeros(IREC_COLS, np.int32)
        row[0:10] = (mode, edge, y0, x0,
                     (1 * unavail) | (2 * filt) | (4 * strong) | 8,  # 8=valid
                     rrow, step, slot, c, lg)
        row[10:10 + AVAIL_WORDS] = _avail_words(av[None, :])[0]
        rows.append(row)

    return np.stack(rows).astype(np.int32), n_steps, nsteps_pc


def _intra_records(prog: FrameProgramData, tu_bin_lg=None, tu_bin_row=None):
    """(irec, steps, steps per plane) of the picture: from the native plan,
    or scheduled by _plan_intra when the program has none (prog.ip is
    None); tu_bin_lg / tu_bin_row as _bin_tus gives them (computed here
    when not given)."""
    if len(prog.intras) == 0:
        return np.zeros((0, IREC_COLS), np.int32), 0, np.zeros(3, np.int32)
    if prog.ip is None:
        if tu_bin_lg is None:
            _, tu_bin_lg, tu_bin_row = _bin_tus(prog)
        return _plan_intra(prog, tu_bin_lg, tu_bin_row)
    return _intra_records_native(prog)


def two_depths(prog: FrameProgramData) -> bool:
    """Whether the chroma bit depth differs from the luma depth: the feed
    then carries each TU's channel in bin{lg}.cidx, so that the residual
    section takes every TU at its own channel's depth (ROADMAP C8)."""
    return bool(prog.chroma_width) and prog.bit_depth[1] != prog.bit_depth[0]


def _tu_channels(prog: FrameProgramData, lg: int, cap: int):
    """The channel of each TU row of bin lg, zero-padded to cap rows."""
    out = np.zeros(cap, np.int32)
    if len(prog.tus):
        c = prog.tus["cidx"][prog.tus["log2_size"] == lg]
        out[:len(c)] = c
    return out


def _pack_pcm(prog: FrameProgramData, sub_x, sub_y):
    """Flat (plane, index, value) PCM scatter lists (rare blocks)."""
    if prog.pcms is None or len(prog.pcms) == 0:
        return [np.zeros((0, 2), np.int32) for _ in range(3)]
    sh_y = max(prog.bit_depth[0] - prog.pcm_bit_depth[0], 0)
    sh_c = max((prog.bit_depth[1] if prog.chroma_width else 8) -
               prog.pcm_bit_depth[1], 0)
    data = prog.pcm_data.astype(np.int32)
    out = [[], [], []]
    for rec in prog.pcms:
        s = 1 << int(rec["log2_size"])
        p = int(rec["data_start"])
        x, y0 = int(rec["x"]), int(rec["y"])
        yy, xx = np.mgrid[y0:y0 + s, x:x + s]
        out[0].append(np.stack([(yy * prog.width + xx).ravel(),
                                data[p:p + s * s] << sh_y], axis=1))
        p += s * s
        if prog.chroma_width:
            cw, chh = s // sub_x, s // sub_y
            cx, cy = x // sub_x, y0 // sub_y
            for c in (1, 2):
                yy, xx = np.mgrid[cy:cy + chh, cx:cx + cw]
                out[c].append(np.stack([(yy * prog.chroma_width + xx).ravel(),
                                        data[p:p + cw * chh] << sh_c], axis=1))
                p += cw * chh
    return [np.concatenate(o).astype(np.int32) if o else
            np.zeros((0, 2), np.int32) for o in out]


def _pad_rows(a: np.ndarray, cap: int, fill=0) -> np.ndarray:
    """Pad axis 0 to cap (>= len(a))."""
    if len(a) == cap:
        return np.ascontiguousarray(a)
    pad = np.full((cap - len(a),) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, pad])


def has_ccp(prog: FrameProgramData) -> bool:
    return bool(len(prog.tus) and (prog.tus["cross_comp_scale"] != 0).any())


def has_rdpcm(prog: FrameProgramData) -> bool:
    return bool(len(prog.tus) and ((prog.tus["flags"] & TU_RDPCM) != 0).any())


def _check_pu_index(prog: FrameProgramData):
    """The segment words carry 16-bit PU indices (two per word): raise the
    ValueError of mc_seg.plan_segment_indices for a picture with more
    than mc_seg.MAX_PUS PUs, before any native call packs a wrapped
    index."""
    if len(prog.pus) > mc_seg.MAX_PUS:
        raise ValueError(
            f"pack_native: {len(prog.pus)} PUs in the picture; PU "
            f"{len(prog.pus) - 1} does not fit the segment words' 16-bit "
            f"index (at most {mc_seg.MAX_PUS} PUs)")


def routed(prog: FrameProgramData, pallas_mc: bool) -> bool:
    """Whether FusedDecoder sends prog to pipeline.reconstruct: more than
    MAX_REFS references, or on the production formulation (pallas_mc)
    more than mc_seg.MAX_PUS PUs, which the segment words cannot index."""
    return len(prog.ref_pocs) > MAX_REFS or (
        pallas_mc and len(prog.pus) > mc_seg.MAX_PUS)


def native_live(prog: FrameProgramData) -> bool:
    """Whether prog has a live native source (its decoder not freed)."""
    src = getattr(prog, "src", None)
    return src is not None and getattr(src[0], "_ctx", None) is not None


# the native packer's entry keys (enum PackKey of native/src/feedpack.cc)
_KEY = {"tm": 0, "cv": 3, "coff": 4, "cfx": 5, "rs.n": 6, "rs.sw": 7,
        "cfv": 8, "sgn": 9, "sgi": 12, "irecp": 17, "nsteps": 18, "pcm": 19,
        "slice_recs": 20, "pu": 21, "g4": 23, "slice_idx": 27,
        "slice_addr": 28, "tile_id": 30, "sao_t": 31, "sao_eo": 32,
        "sao_band": 33, "sao_off": 34}

# The 64-word caps record of tde265_pack_caps:
#   [0..3] TUs per lg, [4..7] coefficient words per lg,
#   [8..19] inter residual targets per (lg, plane), [20..31] residual band
#   segments K per (lg, plane), [32..33] MC segments K per list,
#   [34] intra blocks, [35] scan steps, [36..38] steps per plane,
#   [39..41] PCM samples per plane, [42] use_l1, [43] has_inter,
#   [44] slices, [45..48] most entries of a TU per lg (unused here),
#   [49..52] escape corrections per lg.


def _multi_boundary(prog: FrameProgramData) -> bool:
    srec = prog.slice_records
    return bool((len(srec) > 1 and not np.all(srec[:, 9])) or
                not prog.across_tiles)


class FeedPacker:
    """Capacity watermarks and the per-picture feed packer of one stream.

    Every array of the feed is padded to a power-of-two watermark that only
    grows, so the layout of a stream changes O(log) times.  The sticky
    latches (use_l1, has_inter, multi) select the program variant, as in
    the JAX decoder.
    """

    def __init__(self):
        self.caps = {"pu": 1, "slices": 1, "steps": 0, "nintra": 0}
        for lg in (2, 3, 4, 5):
            self.caps[f"tu{lg}"] = 0
            self.caps[f"co{lg}"] = 0
            self.caps[f"cf{lg}"] = 0
            for ch in ("y", "cb", "cr"):
                self.caps[f"sc{lg}{ch}"] = 0
        for c in range(3):
            self.caps[f"pcm{c}"] = 0
        self.caps["segk"] = 0   # MC segments per band (production feed)
        self.intra_lgs = set()  # (plane_class, lg) seen
        self.use_l1 = False
        self.has_inter = False
        self.multi = False
        # stream-level RExt features (note_rext): the program variant, and
        # with has_ccp the numpy packer (the only one with the CCP fields)
        self.has_ccp = False
        self.has_rdpcm = False
        # pictures packed by pack_native and by pack
        self.native_packs = 0
        self.numpy_packs = 0
        # intra records of the last packed picture (the first n columns of
        # its irecp field; the rest is zero padding)
        self.last_intra = 0
        self._layout_cache = None   # pack_native's (signature, layout)

    def grow(self, key, n):
        if n > self.caps.get(key, 0):
            self.caps[key] = _pow2(n)
        return self.caps[key]

    def _note_intra_lgs(self, prog):
        for c, lg in set(zip(prog.intras["cidx"].tolist(),
                             prog.intras["log2_size"].tolist())):
            self.intra_lgs.add((_PLANE_CLASS[int(c)], int(lg)))

    def _note_l1(self, prog):
        self.use_l1 = self.use_l1 or (
            bool((prog.pus["pred_flags"] & 2).any()) if len(prog.pus)
            else False)

    def note_rext(self, prog):
        """Latch the stream-level RExt features of prog (sticky)."""
        self.has_ccp = self.has_ccp or has_ccp(prog)
        self.has_rdpcm = self.has_rdpcm or has_rdpcm(prog)

    def plan_stream(self, progs, pallas_mc=False):
        """Pre-size every capacity from a list of pictures, so the whole
        stream packs into one layout (pallas_mc: the production feed's
        segment and residual band watermarks too, from the native caps
        record while the picture has a live native source and no CCP is
        latched)."""
        for prog in progs:
            if len(prog.ref_pocs) > MAX_REFS:
                continue
            self.note_rext(prog)
            if pallas_mc and not self.has_ccp:
                _check_pu_index(prog)
                caps = self.native_caps(prog)
                if caps is not None:
                    self.plan_from_caps(prog, caps)
                    continue
            bins, tl, tr = _bin_tus(prog)
            sub_y0 = prog.height // prog.chroma_height \
                if prog.chroma_height else 1
            for lg, b in bins.items():
                self.grow(f"tu{lg}", b["n"])
                self.grow(f"co{lg}", len(b["cv"]))
                self.grow(f"cf{lg}", len(b["cfx"]))
                for c, ch in enumerate(("y", "cb", "cr")):
                    self.grow(f"sc{lg}{ch}", len(b[f"sc_{ch}"]))
                    if pallas_mc and len(b[f"sc_{ch}"]):
                        self.grow(f"rk{lg}{ch}", self._band_segments(
                            b[f"sc_{ch}"], lg, c, sub_y0, prog.height)[2])
            self.grow("pu", len(prog.pus))
            self.grow("slices", len(prog.slice_records))
            self._note_l1(prog)
            self.has_inter = self.has_inter or len(prog.pus) > 0
            self.multi = self.multi or _multi_boundary(prog)
            if prog.ip is not None:
                n_steps = int(prog.ip["step"].max(initial=-1)) + 1
            else:
                _, n_steps, _ = _intra_records(prog, tl, tr)
            if len(prog.intras):
                self._note_intra_lgs(prog)
            self.grow("steps", n_steps)
            self.grow("nintra", len(prog.intras))
            sub_x = prog.width // prog.chroma_width if prog.chroma_width \
                else 1
            sub_y = prog.height // prog.chroma_height if prog.chroma_height \
                else 1
            pcm = _pack_pcm(prog, sub_x, sub_y)
            for c in range(3):
                self.grow(f"pcm{c}", len(pcm[c]))
            if pallas_mc and len(prog.pus):
                for l in (0, 1):
                    _, _, K = mc_seg.plan_segment_indices(prog.pus, l,
                                                          prog.height)
                    self.grow("segk", K)

    @staticmethod
    def _band_segments(sc, lg, c, sub_y, H):
        """(counts, words, K) of one bin's residual band feed of plane c."""
        OR = 4 if c == 0 else 4 // max(sub_y, 1)
        band, srow, x0s = mc_seg.plan_residual_segments(sc, 1 << lg, OR)
        return mc_seg.pack_band_segments(band, srow, x0s, (H + 3) // 4)

    def pack(self, prog: FrameProgramData, slot_map, slot_row=None,
             pallas_mc=False):
        """Returns (layout, buf, lgs, n_slices): layout is a tuple of
        (name, offset, shape) into the int32 buffer buf.  With pallas_mc,
        the production feed; slot_map then maps reference index -> DPB
        ring slot and slot_row holds the ring row of the picture's own slot
        per plane."""
        H, W = prog.height, prog.width
        has_chroma = prog.chroma_width > 0
        sub_x = W // prog.chroma_width if has_chroma else 1
        sub_y = H // prog.chroma_height if has_chroma else 1
        n_bands = (H + 3) // 4

        # --- PU SoA [Pcap, 5] ---
        pcap = self.grow("pu", max(len(prog.pus), 1))
        pu = np.zeros((pcap, 5), np.int32)
        if len(prog.pus):
            pw = pus_to_wire(prog.pus, slot_map)
            pu[:pw.shape[0]] = pw

        # --- MC segments (production feed): the PU index of each PU x band
        # work unit; windows are re-derived on the device ---
        seg_host = {}
        if pallas_mc:
            lists = (0, 1) if self.use_l1 or (
                len(prog.pus) and bool((prog.pus["pred_flags"] & 2).any())) \
                else (0,)
            for l in lists:
                if l == 1:
                    self.use_l1 = True
                counts, sidx, K = mc_seg.plan_segment_indices(prog.pus, l, H)
                kcap = self.grow("segk", max(K, 1))
                a = np.zeros((n_bands, (kcap + 1) // 2), np.int32)
                a[:, :sidx.shape[1]] = sidx
                seg_host[f"sg{l}i"] = a
                seg_host[f"sg{l}n"] = counts.astype(np.int32)

        # --- TU bins ---
        bins, tl, tr = _bin_tus(prog)
        chans = two_depths(prog)
        host = {}
        lgs = []
        z0 = np.zeros(0, np.int32)
        for lg in (2, 3, 4, 5):
            if self.caps[f"tu{lg}"] == 0 and lg not in bins:
                continue
            b = bins.get(lg)
            tcap = self.grow(f"tu{lg}", b["n"] if b else 1)
            ccap = self.grow(f"co{lg}", len(b["cv"]) if b else 1)
            lgs.append(lg)
            # TU meta, two per word: qp7 (signed) | flags6<<7 | mid3<<13
            tm16 = np.zeros(tcap + (tcap & 1), np.int32)
            if b:
                nb = len(b["qp"])
                tm16[:nb] = (b["qp"] & 0x7F) | ((b["flags"] & 0x3F) << 7) \
                    | ((b["mid"] & 7) << 13)
            host[f"bin{lg}.tm"] = tm16[0::2] | (tm16[1::2] << 16)
            host[f"bin{lg}.cv"] = _pad_rows(b["cv"] if b else z0, ccap)
            coff = b["coff"] if b else np.zeros(1, np.int32)
            host[f"bin{lg}.coff"] = _pad_rows(coff, tcap + 1,
                                              fill=int(coff[-1]))
            if chans:
                host[f"bin{lg}.cidx"] = _tu_channels(prog, lg, tcap)
            fcap = self.grow(f"cf{lg}", len(b["cfx"]) if b else 0)
            if fcap:
                host[f"bin{lg}.cfx"] = _pad_rows(
                    b["cfx"] if b else z0, fcap, fill=-1)
                host[f"bin{lg}.cfv"] = _pad_rows(b["cfv"] if b else z0,
                                                 fcap)
            if self.has_ccp:
                host[f"bin{lg}.ccp_row"] = _pad_rows(
                    b["ccp_row"] if b else z0, tcap, fill=-1)
                host[f"bin{lg}.ccp_scale"] = _pad_rows(
                    b["ccp_scale"] if b else z0, tcap)
            for c, ch in enumerate(("y", "cb", "cr")):
                sc = b[f"sc_{ch}"] if b else np.zeros((0, 3), np.int32)
                cap = self.grow(f"sc{lg}{ch}", len(sc))
                if not pallas_mc:
                    host[f"bin{lg}.sc_{ch}"] = _pad_rows(sc, cap, fill=-1)
                elif cap:
                    cnt, sw, K = self._band_segments(sc, lg, c, sub_y, H)
                    kcap = self.grow(f"rk{lg}{ch}", K)
                    swp = np.zeros((n_bands, kcap), np.int32)
                    swp[:, :sw.shape[1]] = sw
                    host[f"rs{lg}{ch}.n"] = cnt
                    host[f"rs{lg}{ch}.sw"] = swp

        # --- intra super-waves (flat records; scan layout built on device) ---
        irec, n_steps, nsteps_pc = _intra_records(prog, tl, tr)
        self.caps["steps"] = max(self.caps["steps"],
                                 _pow2(n_steps) if n_steps else 0)
        if len(prog.intras):
            self._note_intra_lgs(prog)
        host["nsteps"] = nsteps_pc
        ncap = self.grow("nintra", max(len(irec), 1))
        irecp = np.zeros((8, ncap), np.int32)
        if len(irec):
            irecp[:, :len(irec)] = _pack_irec(irec)
        host["irecp"] = irecp
        self.last_intra = len(irec)

        # intra residuals reference bin_res[lg]: make sure those bins exist
        for (_, lg) in self.intra_lgs:
            if lg not in lgs:
                tcap = self.grow(f"tu{lg}", 1)
                ccap = self.grow(f"co{lg}", 1)
                lgs.append(lg)
                host[f"bin{lg}.qp"] = _pad_rows(z0, tcap)
                host[f"bin{lg}.flags"] = _pad_rows(z0, tcap)
                host[f"bin{lg}.mid"] = _pad_rows(z0, tcap)
                host[f"bin{lg}.cv"] = _pad_rows(z0, ccap)
                host[f"bin{lg}.coff"] = np.zeros(tcap + 1, np.int32)
                if chans:
                    host[f"bin{lg}.cidx"] = _tu_channels(prog, lg, tcap)
                if self.has_ccp:
                    host[f"bin{lg}.ccp_row"] = _pad_rows(z0, tcap, fill=-1)
                    host[f"bin{lg}.ccp_scale"] = _pad_rows(z0, tcap)
                for ch in ("y", "cb", "cr"):
                    cap = self.grow(f"sc{lg}{ch}", 0) or 0
                    if not pallas_mc:
                        host[f"bin{lg}.sc_{ch}"] = _pad_rows(
                            np.zeros((0, 3), np.int32), cap, fill=-1)
                    elif cap:
                        kcap = self.caps.get(f"rk{lg}{ch}", 1) or 1
                        host[f"rs{lg}{ch}.n"] = np.zeros(n_bands, np.int32)
                        host[f"rs{lg}{ch}.sw"] = np.zeros((n_bands, kcap),
                                                          np.int32)
        lgs = sorted(lgs)

        # --- PCM ---
        pcm = _pack_pcm(prog, sub_x, sub_y)
        for c in range(3):
            cap = self.grow(f"pcm{c}", len(pcm[c]))
            host[f"pcm{c}"] = _pad_rows(pcm[c], cap, fill=1 << 30) if cap \
                else np.zeros((0, 2), np.int32)

        # --- grids + slice data ---
        n_slices = self.grow("slices", max(len(prog.slice_records), 1))
        recs = np.zeros((n_slices, 208), np.int32)
        recs[:len(prog.slice_records)] = prog.slice_records
        host["slice_recs"] = recs
        host["pu"] = pu
        if pallas_mc:
            # PU slot fields hold DPB ring positions: POCs by ring slot
            pocs_by_slot = np.full(2 * MAX_REFS + 1, NOREF, np.int32)
            for i, poc in enumerate(prog.ref_pocs[:MAX_REFS]):
                pocs_by_slot[slot_map.get(i, 2 * MAX_REFS)] = poc
            host["ref_pocs"] = pocs_by_slot
        else:
            host["ref_pocs"] = np.array(
                [prog.ref_pocs[i] if i < len(prog.ref_pocs) else NOREF
                 for i in range(MAX_REFS)], np.int32)
        host["mc_on"] = np.array([1 if len(prog.pus) else 0], np.int32)
        # per-4x4 grids in one word: qp(8) | nzc(1) | dbf(4) | cu(4) |
        # pu_idx+1 (15, 0 = uncovered); pu_idx spills to its own field
        # only when the PU count exceeds 15 bits
        g = (prog.qp_y.astype(np.int32) & 0xFF) | \
            ((prog.nonzero_coeff.astype(np.int32) & 1) << 8) | \
            ((prog.deblock_flags.astype(np.int32) & 0xF) << 9) | \
            ((prog.cu_info.astype(np.int32) & 0xF) << 13)
        if pallas_mc:
            # halfword grid, two horizontally adjacent cells per word:
            # qp(8) | nzc(1) | dbf(4) | cu(3); pu_idx is painted on the
            # device from the segment index feed (kernel B2)
            g16 = g & 0xFFFF
            if g16.shape[1] & 1:
                g16 = np.pad(g16, ((0, 0), (0, 1)))
            host["g4"] = g16[:, 0::2] | (g16[:, 1::2] << 16)
        elif self.caps["pu"] < (1 << 15) - 1:
            host["g4"] = g | ((prog.pu_idx.astype(np.int32) + 1) << 17)
        else:
            host["g4"] = g
            host["pu_idx"] = prog.pu_idx.astype(np.int32)
        host["slice_idx"] = prog.slice_idx.astype(np.int32)
        host["slice_addr"] = prog.slice_addr.astype(np.int32)
        host["tile_id"] = prog.tile_id.astype(np.int32)
        sh = (prog.ctb_h, prog.ctb_w)
        if prog.sao is not None and len(prog.sao):
            host["sao_t"] = prog.sao["type_idx"].astype(np.int32).reshape(
                *sh, 3)
            host["sao_eo"] = prog.sao["eo_class"].astype(np.int32).reshape(
                *sh, 3)
            host["sao_band"] = prog.sao["band_pos"].astype(np.int32).reshape(
                *sh, 3)
            host["sao_off"] = prog.sao["offset"].astype(np.int32).reshape(
                *sh, 3, 4)
        else:
            host["sao_t"] = np.zeros((*sh, 3), np.int32)
            host["sao_eo"] = np.zeros((*sh, 3), np.int32)
            host["sao_band"] = np.zeros((*sh, 3), np.int32)
            host["sao_off"] = np.zeros((*sh, 3, 4), np.int32)

        if pallas_mc:
            host["slot_row"] = np.asarray(slot_row, np.int32)
        self._note_l1(prog)

        # --- pack: ONE host->device upload per picture ---
        host.update(seg_host)
        layout = []
        total = 0
        for k in sorted(host):
            layout.append((k, total, tuple(host[k].shape)))
            total += host[k].size
        buf = np.empty(max(total, 1), np.int32)
        for (k, off, shp) in layout:
            a = host[k]
            buf[off:off + a.size] = a.ravel()
        self.numpy_packs += 1
        return tuple(layout), buf, lgs, n_slices

    # -- the native packer (native/src/feedpack.cc) --

    def native_caps(self, prog: FrameProgramData):
        """The 64-word caps record of prog from tde265_pack_caps, or None
        when prog has no live native source.  The call also plans the
        picture into the native packer's one-entry cache, which the
        tde265_pack_feed call of the same picture reads: keep the two back
        to back on one thread.  Raises RuntimeError with the return code
        when the native side rejects the picture."""
        if not native_live(prog):
            return None
        dec, idx = prog.src
        caps = np.zeros(64, np.int32)
        rc = dec._lib.tde265_pack_caps(dec._ctx, idx,
                                       caps.ctypes.data_as(ct.c_void_p))
        if rc != 0:
            raise RuntimeError(f"tde265_pack_caps: program {idx}: return "
                               f"code {rc}")
        return caps

    def plan_from_caps(self, prog: FrameProgramData, caps):
        """plan_stream's growth for one picture of the production feed,
        from its caps record (the watermarks the numpy planning gives)."""
        for lg in (2, 3, 4, 5):
            i = lg - 2
            n_tu = int(caps[i])
            if n_tu == 0:
                continue
            self.grow(f"tu{lg}", n_tu)
            self.grow(f"co{lg}", int(caps[4 + i]))
            self.grow(f"cf{lg}", int(caps[49 + i]))
            for c, ch in enumerate(("y", "cb", "cr")):
                scn = int(caps[8 + i * 3 + c])
                self.grow(f"sc{lg}{ch}", scn)
                if scn:
                    self.grow(f"rk{lg}{ch}", int(caps[20 + i * 3 + c]))
        self.grow("pu", len(prog.pus))
        self.grow("slices", len(prog.slice_records))
        self.use_l1 = self.use_l1 or bool(caps[42])
        self.has_inter = self.has_inter or bool(caps[43])
        self.multi = self.multi or _multi_boundary(prog)
        if int(caps[34]):
            self._note_intra_lgs(prog)
        self.grow("steps", int(caps[35]))
        self.grow("nintra", int(caps[34]))
        for c in range(3):
            self.grow(f"pcm{c}", int(caps[39 + c]))
        if len(prog.pus):
            for l in (0, 1):
                self.grow("segk", int(caps[32 + l]))

    def pack_native(self, prog: FrameProgramData, slot_map, slot_row):
        """pack(prog, slot_map, slot_row, pallas_mc=True) built by the
        native packer from prog's live native source: the same
        (layout, buf, lgs, n_slices), watermarks and latches.  The layout
        is cached on the watermarks it depends on.  Raises ValueError for
        more than mc_seg.MAX_PUS PUs (before any native call) or without a
        live source, RuntimeError when the native side fails."""
        _check_pu_index(prog)
        caps = self.native_caps(prog)
        if caps is None:
            raise ValueError("pack_native: the program has no live native "
                             "source (prog.src)")
        n_bands = (prog.height + 3) // 4

        # watermark growth, as pack grows them
        for lg in (2, 3, 4, 5):
            i = lg - 2
            n_tu, n_co = int(caps[i]), int(caps[4 + i])
            if n_tu or self.caps[f"tu{lg}"]:
                self.grow(f"tu{lg}", max(n_tu, 1))
                self.grow(f"co{lg}", max(n_co, 1))
                self.grow(f"cf{lg}", int(caps[49 + i]))
            for c, ch in enumerate(("y", "cb", "cr")):
                if self.grow(f"sc{lg}{ch}", int(caps[8 + i * 3 + c])):
                    self.grow(f"rk{lg}{ch}", int(caps[20 + i * 3 + c]))
        self.grow("pu", max(len(prog.pus), 1))
        self.use_l1 = self.use_l1 or bool(caps[42])
        lists = (0, 1) if self.use_l1 else (0,)
        for l in lists:
            self.grow("segk", max(int(caps[32 + l]), 1))
        n_steps = int(caps[35])
        self.caps["steps"] = max(self.caps["steps"],
                                 _pow2(n_steps) if n_steps else 0)
        self.grow("nintra", max(int(caps[34]), 1))
        self.last_intra = int(caps[34])
        for c in range(3):
            self.grow(f"pcm{c}", int(caps[39 + c]))
        n_slices = self.grow("slices", max(int(caps[44]), 1))
        if int(caps[34]):
            self._note_intra_lgs(prog)
        for (_, lg) in self.intra_lgs:
            if self.caps[f"tu{lg}"] == 0:
                self.grow(f"tu{lg}", 1)
                self.grow(f"co{lg}", 1)
        lgs = [lg for lg in (2, 3, 4, 5) if self.caps[f"tu{lg}"] > 0]

        chans = two_depths(prog)
        sig = (tuple(sorted(self.caps.items())), lists,
               tuple(prog.pu_idx.shape), (prog.ctb_h, prog.ctb_w), n_bands,
               n_slices, tuple(sorted(self.intra_lgs)), self.has_ccp, chans)
        if self._layout_cache is None or self._layout_cache[0] != sig:
            self._layout_cache = (sig, self._native_layout(
                prog, lgs, lists, n_bands, n_slices, chans))
        layout, entries, total = self._layout_cache[1]
        aux = np.zeros(25, np.int32)    # ref index -> ring slot, twice
        for k, v in slot_map.items():
            aux[k + 1] = v
        for i in range(MAX_REFS):
            aux[17 + i] = slot_map.get(i, 0)
        buf = np.empty(max(total, 1), np.int32)
        dec, idx = prog.src
        rc = dec._lib.tde265_pack_feed(
            dec._ctx, idx, entries.ctypes.data_as(ct.c_void_p),
            len(entries), aux.ctypes.data_as(ct.c_void_p),
            buf.ctypes.data_as(ct.c_void_p), total)
        if rc != 0:
            raise RuntimeError(f"tde265_pack_feed: program {idx}: return "
                               f"code {rc}")
        # the fields filled here: POCs by ring slot, the MC gate, the rows
        # of the picture's own ring slot
        fields = {k: (off, shp) for k, off, shp in layout}
        off = fields["ref_pocs"][0]
        buf[off:off + RING_SLOTS] = NOREF
        for i, poc in enumerate(prog.ref_pocs[:MAX_REFS]):
            buf[off + slot_map.get(i, 2 * MAX_REFS)] = poc
        buf[fields["mc_on"][0]] = 1 if len(prog.pus) else 0
        off = fields["slot_row"][0]
        buf[off:off + 3] = slot_row
        for lg in lgs if chans else ():
            off, (cap,) = fields[f"bin{lg}.cidx"]
            buf[off:off + cap] = _tu_channels(prog, lg, cap)
        self.native_packs += 1
        return layout, buf, lgs, n_slices

    def _native_layout(self, prog, lgs, lists, n_bands, n_slices, chans):
        """(layout, entries [n, 8] int32, total words) of the production
        feed under the current watermarks: every field of pack's layout,
        an entry {key, p0, p1, offset, shape[:4]} for each field that the
        native packer fills (chans: the bin{lg}.cidx fields, filled in
        pack_native)."""
        shapes, ids = {}, {}

        def ent(key, kid, p0, p1, shape):
            shapes[key] = shape
            ids[key] = (_KEY[kid], p0, p1)

        for lg in lgs:
            tcap, ccap = self.caps[f"tu{lg}"], self.caps[f"co{lg}"]
            ent(f"bin{lg}.tm", "tm", lg, 0, ((tcap + 1) // 2,))
            ent(f"bin{lg}.cv", "cv", lg, 0, (ccap,))
            ent(f"bin{lg}.coff", "coff", lg, 0, (tcap + 1,))
            if chans:
                shapes[f"bin{lg}.cidx"] = (tcap,)
            fcap = self.caps[f"cf{lg}"]
            if fcap:
                ent(f"bin{lg}.cfx", "cfx", lg, 0, (fcap,))
                ent(f"bin{lg}.cfv", "cfv", lg, 0, (fcap,))
            for c, ch in enumerate(("y", "cb", "cr")):
                if self.caps[f"sc{lg}{ch}"]:
                    kcap = self.caps.get(f"rk{lg}{ch}", 1) or 1
                    ent(f"rs{lg}{ch}.n", "rs.n", lg, c, (n_bands,))
                    ent(f"rs{lg}{ch}.sw", "rs.sw", lg, c, (n_bands, kcap))
        segk = self.caps["segk"] or 1
        for l in lists:
            ent(f"sg{l}n", "sgn", l, 0, (n_bands,))
            ent(f"sg{l}i", "sgi", l, 0, (n_bands, (segk + 1) // 2))
        ent("irecp", "irecp", 0, 0, (8, self.caps["nintra"]))
        ent("nsteps", "nsteps", 0, 0, (3,))
        for c in range(3):
            ent(f"pcm{c}", "pcm", c, 0, (self.caps[f"pcm{c}"], 2))
        ent("slice_recs", "slice_recs", 0, 0, (n_slices, 208))
        ent("pu", "pu", 0, 0, (self.caps["pu"], 5))
        pb = tuple(prog.pu_idx.shape)
        # p1 = 2: the halfword grid, pu_idx painted on the device (B2)
        ent("g4", "g4", 0, 2, (pb[0], (pb[1] + 1) // 2))
        sh = (prog.ctb_h, prog.ctb_w)
        for k in ("slice_idx", "slice_addr", "tile_id"):
            ent(k, k, 0, 0, sh)
        for k in ("sao_t", "sao_eo", "sao_band"):
            ent(k, k, 0, 0, (*sh, 3))
        ent("sao_off", "sao_off", 0, 0, (*sh, 3, 4))
        shapes["ref_pocs"] = (RING_SLOTS,)
        shapes["mc_on"] = (1,)
        shapes["slot_row"] = (3,)

        layout, entries, total = [], [], 0
        for k in sorted(shapes):
            shp = tuple(shapes[k])
            layout.append((k, total, shp))
            if k in ids:
                row = [*ids[k], total, 0, 0, 0, 0]
                row[4:4 + min(len(shp), 4)] = shp[:4]
                entries.append(row)
            total += int(np.prod(shp, dtype=np.int64))
        return tuple(layout), np.array(entries, np.int32), total
