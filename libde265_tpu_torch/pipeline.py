"""Whole-picture reconstruction from a FrameProgram, stage by stage: the
PyTorch port of ``libde265_tpu/pipeline.py``.

``reconstruct`` runs a picture's program as a sequence of batched stages
on `device` (the CUDA card unless the caller asks for the CPU):

  1. residuals of ALL TUs, size-binned (ops.transform), and
     cross-component prediction                              [device]
  2. motion compensation of all PUs, binned by PU size (ops.mc): one
     clamped window gather per (size, list) from the references
     stacked on the device, interpolation, merge, store       [device]
  3. PCM samples and the inter-TU residual adds               [device]
  4. intra prediction + intra-TU residual adds in decode order:
     one block at a time on the host (ops.intra, the planes come to the
     host and go back), or with device_intra=True the wavefront levels
     of ops.intra_wave on the device
  5. deblocking: edge parameters, then kernel B8 for luma and B9 for
     both chroma planes (ops.deblock_cuda)                   [device]
  6. SAO: per-sample maps, then kernel B10 per plane
     (ops.sao_cuda)                                          [device]

Inter prediction never reads the current picture, and intra neighbours
are final after steps 2-3, so this order equals the serial decode order
(native/src/recon.cc).  On CPU tensors the kernels' wrappers run their
plain PyTorch versions.

``FusedDecoder.decode`` sends every picture with more than MAX_REFS
references here, with the references from its own DPB
(``reconstruct(..., ref_planes=...)``).  ``reconstruct_stream`` decodes a
whole stream as an independent chain, its own pictures feeding back as
references at the stream's bit depth.

Three faults of the JAX module are not carried over (ROADMAP C): the
chroma deblocking counts (Wc + 7) // 8 and (Hc + 7) // 8 edges (C1),
``reconstruct_stream`` keeps samples above 8 bits (C7), and chroma TUs and
chroma MC run at the chroma bit depth (C8).  All chroma
geometries (4:0:0/4:2:0/4:2:2/4:4:4) are handled as in the JAX module:
subsampling per axis from the program's plane dimensions.
"""
from __future__ import annotations

import numpy as np
import torch

from .decoder import (OP_INTRA, OP_RESIDUAL, TU_INTRA, TU_RDPCM,
                      TU_RDPCM_VERTICAL, TU_TQ_BYPASS, TU_TRANSFORM_SKIP,
                      TU_USE_DST, FrameProgramData)
from .frame_helpers import deblock_planes
from .ops import intra as intra_ops
from .ops import intra_wave
from .ops import mc as mc_ops
from .ops import sao as sao_ops
from .ops import sao_cuda
from .ops import transform as tx
from .ops.deblock import NOREF


_NP = {torch.int32: np.int32, torch.int64: np.int64, torch.bool: bool}


def _t(a, device, dtype=torch.int32):
    """numpy array -> tensor of dtype (int32, int64 or bool) on device."""
    return torch.as_tensor(np.ascontiguousarray(a, dtype=_NP[dtype]),
                           device=device)


def _subsampling(prog):
    if prog.chroma_width:
        return (prog.width // prog.chroma_width,
                prog.height // prog.chroma_height)
    return 1, 1


def _store_blocks(plane, xs, ys, blocks, add_clip=None):
    """plane[y:y+h, x:x+w] = blocks[k] for every block k at (xs[k], ys[k])
    (blocks [N, h, w]), in one indexed store; with add_clip=maxv the
    blocks are added and the sums clipped to [0, maxv].  The blocks must
    not overlap and lie inside the plane, as PUs, TUs and PCM blocks do."""
    N, h, w = blocks.shape
    if N == 0:
        return
    W = plane.shape[1]
    dev = plane.device
    ys = torch.as_tensor(np.asarray(ys, np.int64), device=dev)
    xs = torch.as_tensor(np.asarray(xs, np.int64), device=dev)
    ar_h = torch.arange(h, device=dev)[None, :, None]
    ar_w = torch.arange(w, device=dev)[None, None, :]
    idx = (ys[:, None, None] + ar_h) * W + xs[:, None, None] + ar_w
    flat = plane.view(-1)
    vals = blocks.to(plane.dtype)
    if add_clip is not None:
        vals = (flat[idx] + vals).clamp(0, add_clip)
    flat[idx] = vals


# ---------------------------------------------------------------------------
# 1. residuals
# ---------------------------------------------------------------------------

def _compute_residuals(prog: FrameProgramData, device):
    """All TU residuals, size-binned on `device`.

    Returns {log2 size: (TU indices [N] int64, residuals [N, s, s] int32
    tensor)}: the plain TUs of a bin through ops.transform, then the
    transquant-bypass and explicit-RDPCM transform-skip TUs, computed on
    the host as the JAX module computes them (rare; RExt only)."""
    out = {}
    tus = prog.tus
    if len(tus) == 0:
        return out
    flags = tus["flags"]
    # host fallback set: transquant bypass, and explicit RDPCM on
    # transform-skip TUs; RDPCM without transform-skip takes the normal
    # inverse-transform path (mirrors native/src/transform.cc)
    rdpcm_ts = ((flags & TU_RDPCM) != 0) & ((flags & TU_TRANSFORM_SKIP) != 0)
    plain = ((flags & TU_TQ_BYPASS) == 0) & ~rdpcm_ts
    # each TU at its channel's depth (ROADMAP C8)
    bd = prog.bit_depth[0]
    bdc = prog.bit_depth[1] if prog.chroma_width else bd
    for lg in (2, 3, 4, 5):
        sel = np.nonzero((tus["log2_size"] == lg) & plain)[0]
        if len(sel) == 0:
            continue
        levels = tx.scatter_coeffs(tus, prog.coeff_val, prog.coeff_pos, lg,
                                   sel, device)
        qp = _t(tus["qp"][sel], device)
        fact = tx.qp_to_fact(qp)
        tskip = _t((flags[sel] & TU_TRANSFORM_SKIP) != 0, device, torch.bool)
        use_dst = _t((flags[sel] & TU_USE_DST) != 0, device, torch.bool)
        cidx = tus["cidx"][sel].astype(np.int32)
        kw = {}
        if prog.scaling_factors is not None:
            # per-TU matrix id (spec 7.4.5 / 8.6.3): cidx (+3 for inter,
            # except 32x32 which has only intra/inter luma matrices)
            intra = (flags[sel] & TU_INTRA) != 0
            mid = np.where(intra, 0, 1) if lg == 5 else \
                cidx + np.where(intra, 0, 3)
            kw = dict(sf=_t(prog.scaling_factors[lg][mid], device), qp=qp)
        chroma = _t(cidx != 0, device, torch.bool) if bdc != bd else None
        out[lg] = (sel, tx.residual_batch_by_channel(
            levels, fact, tskip, use_dst, lg, bd, bdc, chroma, **kw))

    extra = {}
    for t in np.nonzero(~plain)[0]:
        lg = int(tus["log2_size"][t])
        extra.setdefault(lg, []).append((t, _host_residual(prog, t)))
    for lg, items in sorted(extra.items()):
        idx = np.array([t for t, _ in items], np.int64)
        blocks = _t(np.stack([b for _, b in items]), device)
        if lg in out:
            idx = np.concatenate([out[lg][0], idx])
            blocks = torch.cat([out[lg][1], blocks])
        out[lg] = (idx, blocks)
    return out


def _host_residual(prog, t):
    """The residual of a transquant-bypass or explicit-RDPCM transform-skip
    TU, on the host (int32 [s, s]), as the JAX module computes it."""
    tu = prog.tus[t]
    lg = int(tu["log2_size"])
    s = 1 << lg
    block = np.zeros((s, s), dtype=np.int64)
    start, n = int(tu["coeff_start"]), int(tu["ncoeff"])
    pos = prog.coeff_pos[start:start + n]
    block[pos >> 6, pos & 63] = prog.coeff_val[start:start + n]
    axis = 0 if (tu["flags"] & TU_RDPCM_VERTICAL) else 1
    if tu["flags"] & TU_TQ_BYPASS:
        # transquant bypass: residual = levels (rdpcm: prefix sums)
        if tu["flags"] & TU_RDPCM:
            block = np.cumsum(block, axis=axis)
        return block.astype(np.int32)
    # explicit RDPCM on a transform-skip TU: dequant (8.6.3) +
    # transform-skip scaling, then directional prefix sums
    # (native/src/transform.cc kTransformSkip+kRdpcm path)
    c = int(tu["cidx"])
    bd = prog.bit_depth[c]
    qp = min(max(int(tu["qp"]), 0), 75)
    bd_shift = bd + lg - 5
    if prog.scaling_factors is None:
        fact = np.int64(tx.LEVEL_SCALE[qp % 6]) << (qp // 6)
        bd_shift -= 4  # flat factor 16 folded into the shift
    else:
        intra = bool(tu["flags"] & TU_INTRA)
        mid = ((0 if intra else 1) if lg == 5 else c + (0 if intra else 3))
        sf = prog.scaling_factors[lg][mid].astype(np.int64)
        fact = (sf * int(tx.LEVEL_SCALE[qp % 6])) << (qp // 6)
    deq = np.clip((block * fact + (1 << (bd_shift - 1))) >> bd_shift,
                  -32768, 32767)
    bd_shift2 = max(20 - bd, 0)
    v = ((deq << (5 + lg)) + (1 << (bd_shift2 - 1))) >> bd_shift2
    return np.cumsum(v, axis=axis).astype(np.int32)


def _apply_ccp(prog: FrameProgramData, residuals):
    """RExt cross-component prediction (spec 8.6.6), in place on the bins:
    chroma residual += (scale * luma_residual_term) >> 3, pairing each
    scaled chroma TU with the most recent luma TU in op order (4:4:4 only,
    identical geometry, so the partner lies in the same size bin).  The
    arithmetic is ops.transform.ccp_add: logical uint32 shifts of the luma
    term and int32 wrap-around in the product, as the reference decoder
    (transform.cc:244-260 there) and the JAX module compute them."""
    tus = prog.tus
    if len(tus) == 0 or not (tus["cross_comp_scale"] != 0).any():
        return
    res_ops = prog.ops["idx"][prog.ops["kind"] == OP_RESIDUAL].astype(
        np.int64)
    luma = tus["cidx"][res_ops] == 0
    at = np.arange(len(res_ops))
    last = np.maximum.accumulate(np.where(luma, at, -1))
    partner = np.full(len(tus), -1, np.int64)
    partner[res_ops] = np.where(last >= 0, res_ops[np.maximum(last, 0)], -1)
    scale = tus["cross_comp_scale"].astype(np.int64)
    paired = (tus["cidx"] != 0) & (scale != 0) & (partner >= 0)
    rows = intra_wave.tu_rows(residuals, len(tus))
    bd_y, bd_c = prog.bit_depth[0], prog.bit_depth[1]
    for lg, (idx, res) in residuals.items():
        on = paired[idx]
        if not on.any():
            continue
        part = partner[idx]
        if (tus["log2_size"][part[on]] != lg).any():
            raise ValueError("cross-component prediction: a chroma TU and "
                             "its luma partner differ in size")
        rr = np.where(on, rows[np.maximum(part, 0)], -1)
        residuals[lg] = (idx, tx.ccp_add(res, _t(rr, res.device),
                                          _t(scale[idx], res.device),
                                          bd_y, bd_c))


# ---------------------------------------------------------------------------
# 2-3. motion compensation, PCM, inter residuals
# ---------------------------------------------------------------------------

def _ref_stacks(prog, ref_planes, device):
    """[R, h, w] int32 stacks, one per plane, of the references the PUs
    read, and the stack index of each reference index (numpy)."""
    pus = prog.pus
    pf = pus["pred_flags"]
    used = np.union1d(pus["ref_dpb0"][(pf & 1) != 0],
                      pus["ref_dpb1"][(pf & 2) != 0]).astype(np.int64)
    n_pl = 3 if prog.chroma_width else 1
    slot = np.zeros(max(len(prog.ref_pocs), int(used.max(initial=-1)) + 1),
                    np.int64)
    stacks = [[] for _ in range(n_pl)]
    for k, i in enumerate(used):
        planes = ref_planes[i] if i < len(ref_planes) else None
        if planes is None or planes[0] is None:
            poc = prog.ref_pocs[i] if i < len(prog.ref_pocs) else None
            raise RuntimeError(f"picture POC {prog.poc}: reference {i} "
                               f"(POC {poc}) has no planes")
        slot[i] = k
        for c in range(n_pl):
            p = planes[c]
            stacks[c].append(p.to(device, torch.int32) if torch.is_tensor(p)
                             else _t(p, device))
    return [torch.stack(s) for s in stacks], slot


def _motion_compensate(prog: FrameProgramData, planes, ref_planes=None):
    """Batched MC for all PUs: predictions stored into planes.

    ref_planes: one [Y, Cb, Cr] per entry of prog.ref_pocs (tensors or
    arrays), default prog.ref_planes."""
    pus = prog.pus
    if len(pus) == 0:
        return
    dev = planes[0].device
    recs = prog.slice_records
    bd = prog.bit_depth[0]
    has_chroma = prog.chroma_width > 0
    sx, sy = _subsampling(prog)
    # chroma MV precision: 1/8 chroma-pel on subsampled axes, else the luma
    # 1/4-pel doubled (spec 8.5.3.2.2; mirrors native/src/recon.cc)
    shx, shy = (3 if sx == 2 else 2), (3 if sy == 2 else 2)
    stacks, slot_of = _ref_stacks(
        prog, prog.ref_planes if ref_planes is None else ref_planes, dev)

    def dt(a):
        return _t(a, dev)

    # group PUs by (w, h)
    keys = pus["w"].astype(np.int64) * 1000 + pus["h"]
    for key in np.unique(keys):
        sel = np.nonzero(keys == key)[0]
        w = int(pus["w"][sel[0]])
        h = int(pus["h"][sel[0]])
        px = pus["x"][sel].astype(np.int64)
        py = pus["y"][sel].astype(np.int64)
        pf = pus["pred_flags"][sel]

        preds_l = [None, None]
        preds_c = [[None, None], [None, None]]  # [list][cb/cr]
        for l in range(2):
            if not ((pf >> l) & 1).any():
                continue            # no PU of the bin reads this list
            slot = dt(slot_of[np.clip(pus[f"ref_dpb{l}"][sel], 0,
                                      len(slot_of) - 1)])
            mvx = pus[f"mv{l}x"][sel].astype(np.int64)
            mvy = pus[f"mv{l}y"][sel].astype(np.int64)
            win = mc_ops.gather_windows(stacks[0], px + (mvx >> 2),
                                        py + (mvy >> 2), w, h, 8, 3, slot)
            preds_l[l] = mc_ops.mc_luma_batch(win, dt(mvx & 3), dt(mvy & 3),
                                              w, h, bd)
            if not has_chroma:
                continue
            cx = px // sx + (mvx >> shx)
            cy = py // sy + (mvy >> shy)
            fcx = dt((mvx & 7) if sx == 2 else ((mvx & 3) << 1))
            fcy = dt((mvy & 7) if sy == 2 else ((mvy & 3) << 1))
            for c in range(2):
                winc = mc_ops.gather_windows(stacks[1 + c], cx, cy, w // sx,
                                             h // sy, 4, 1, slot)
                preds_c[l][c] = mc_ops.mc_chroma_batch(
                    winc, fcx, fcy, w // sx, h // sy, prog.bit_depth[1])

        # merge params per PU
        bi = dt(pf == 3).bool()
        first = np.where((pf & 1) != 0, 0, 1)
        sl = pus["slice"][sel]
        weighted = dt(recs[sl, 6] != 0)
        r0 = np.where(first == 0, pus["ref_idx0"][sel],
                      pus["ref_idx1"][sel]).astype(np.int64)
        r1 = np.maximum(pus["ref_idx1"][sel], 0).astype(np.int64)
        one = np.ones_like(first)

        def wp(base, lst, ridx, c=None):
            col = base + lst * 16 + ridx if c is None else \
                base + (lst * 16 + ridx) * 2 + c
            return dt(recs[sl, col])

        def pick(preds):
            # the first list's prediction: list 0 where the PU reads it
            if preds[0] is None or preds[1] is None:
                return preds[0] if preds[1] is None else preds[1]
            return torch.where(dt(first == 0).bool()[:, None, None],
                               preds[0], preds[1])

        def second(preds):
            return preds[1] if preds[1] is not None else preds[0]

        merged = mc_ops.pred_merge_batch(
            pick(preds_l), second(preds_l), bi, weighted, wp(16, first, r0),
            wp(48, first, r0), wp(16, one, r1), wp(48, one, r1),
            dt(recs[sl, 7]), bd)
        _store_blocks(planes[0], px, py, merged)
        for c in range(2 if has_chroma else 0):
            pcs = preds_c[0][c], preds_c[1][c]
            mc = mc_ops.pred_merge_batch(
                pick(pcs), second(pcs), bi, weighted, wp(80, first, r0, c),
                wp(144, first, r0, c), wp(80, one, r1, c),
                wp(144, one, r1, c), dt(recs[sl, 8]), prog.bit_depth[1])
            _store_blocks(planes[1 + c], px // sx, py // sy, mc)


def _apply_pcm(prog: FrameProgramData, planes):
    """Store the raw PCM samples into the planes (spec 8.4.1: pcm_flag CUs
    bypass prediction+residual; samples coded at the sps PCM bit depth),
    one indexed store per plane and block size.

    Safe to run before the intra pass: each block owns its pixels, and
    intra availability excludes not-yet-decoded positions, so pre-placing
    PCM pixels matches decode order exactly (see recon.cc execute_pcm).
    """
    if prog.pcms is None or len(prog.pcms) == 0:
        return
    has_chroma = prog.chroma_width > 0
    sx, sy = _subsampling(prog)
    sh = (max(prog.bit_depth[0] - prog.pcm_bit_depth[0], 0),
          max(prog.bit_depth[1] - prog.pcm_bit_depth[1], 0))
    data = prog.pcm_data.astype(np.int32)
    blocks = {}    # (plane, h, w) -> [xs, ys, sample blocks]
    for rec in prog.pcms:
        s = 1 << int(rec["log2_size"])
        p = int(rec["data_start"])
        x, y = int(rec["x"]), int(rec["y"])
        geo = [(0, s, s, x, y)]
        if has_chroma:
            geo += [(c, s // sy, s // sx, x // sx, y // sy) for c in (1, 2)]
        for c, h, w, bx, by in geo:
            b = blocks.setdefault((c, h, w), ([], [], []))
            b[0].append(bx)
            b[1].append(by)
            b[2].append(data[p:p + h * w].reshape(h, w) << sh[min(c, 1)])
            p += h * w
    for (c, _, _), (xs, ys, vals) in blocks.items():
        _store_blocks(planes[c], xs, ys, _t(np.stack(vals), planes[c].device))


def _add_inter_residuals(prog: FrameProgramData, planes, residuals):
    """planes += the residual of every inter TU, clipped to the plane's
    bit depth: one indexed add per size bin and plane."""
    tus = prog.tus
    for lg, (idx, res) in residuals.items():
        inter = (tus["flags"][idx] & TU_INTRA) == 0
        for c in range(3):
            sel = np.nonzero(inter & (tus["cidx"][idx] == c))[0]
            if len(sel) == 0:
                continue
            t = idx[sel]
            _store_blocks(planes[c], tus["x"][t], tus["y"][t],
                          res[_t(sel, res.device, torch.long)],
                          add_clip=(1 << prog.bit_depth[c]) - 1)


# ---------------------------------------------------------------------------
# 4. intra
# ---------------------------------------------------------------------------

def _intra_context(prog):
    return intra_ops.IntraContext(prog.width, prog.height, prog.ctb_size,
                                  prog.cu_info, slice_addr=prog.slice_addr,
                                  tile_id=prog.tile_id)


def _intra_host(prog: FrameProgramData, planes, residuals):
    """Intra ops in decode order on the host (ops.intra.predict_block),
    each intra TU's residual added after its prediction.  The planes come
    to the host for it and go back to their device."""
    tus = prog.tus
    kind, opi = prog.ops["kind"], prog.ops["idx"].astype(np.int64)
    is_res = kind == OP_RESIDUAL
    intra_tu = np.zeros(len(kind), bool)
    if len(tus):
        intra_tu[is_res] = (tus["flags"][opi[is_res]] & TU_INTRA) != 0
    todo = np.nonzero((kind == OP_INTRA) | intra_tu)[0]
    if len(todo) == 0:
        return
    dev = planes[0].device
    host = [p.cpu().numpy().copy() for p in planes]
    res_host = {lg: r.cpu().numpy() for lg, (_, r) in residuals.items()}
    rows = intra_wave.tu_rows(residuals, len(tus))
    ctx = _intra_context(prog)
    sub_x, sub_y = _subsampling(prog)
    chroma444 = prog.chroma_width == prog.width and prog.chroma_width > 0
    for k in todo:
        if kind[k] == OP_INTRA:
            rec = prog.intras[opi[k]]
            c = int(rec["cidx"])
            intra_ops.predict_block(host[c], ctx, int(rec["x"]),
                                    int(rec["y"]), 1 << int(rec["log2_size"]),
                                    c, int(rec["mode"]),
                                    1 if c == 0 else sub_x,
                                    1 if c == 0 else sub_y,
                                    prog.bit_depth[c],
                                    chroma444=(c != 0 and chroma444))
        else:
            t = opi[k]
            tu = tus[t]
            lg = int(tu["log2_size"])
            s = 1 << lg
            c = int(tu["cidx"])
            x, y = int(tu["x"]), int(tu["y"])
            host[c][y:y + s, x:x + s] = np.clip(
                host[c][y:y + s, x:x + s] + res_host[lg][rows[t]], 0,
                (1 << prog.bit_depth[c]) - 1)
    for c in range(3):
        planes[c] = torch.from_numpy(host[c]).to(dev)


def _intra_wavefront(prog: FrameProgramData, planes, residuals):
    """Intra ops as wavefront levels on the device (ops.intra_wave): one
    batched kernel call per (wave, plane, size)."""
    dev = planes[0].device
    batches = intra_wave.plan_blocks(prog, _intra_context(prog), residuals)
    for (wave, c, lgs), b in batches.items():
        s = 1 << lgs
        P0, P1, WT = (_t(a, dev) for a in intra_wave.build_mode_tables(s))
        planes[c] = intra_wave.intra_wave_kernel(
            planes[c], b["pos"], b["subst"], b["unavail"], b["filt"],
            b["strong"], b["mode"], b["edge"], b["resid"], b["y0"], b["x0"],
            b["valid"], P0, P1, WT, s=s, bit_depth=prog.bit_depth[c])


# ---------------------------------------------------------------------------
# 5-6. loop filters
# ---------------------------------------------------------------------------

def _skip_filter_map4(prog: FrameProgramData):
    """Per-4x4 mask (host) of samples the loop filters must leave
    untouched: transquant-bypass CUs, plus PCM CUs when
    pcm_loop_filter_disable."""
    skip = (prog.cu_info & 4) != 0
    if prog.pcm_loop_filter_disable:
        skip = skip | ((prog.cu_info & 2) != 0)
    return skip


def _paint_motion_grids(prog: FrameProgramData, device):
    """Per-4x4 motion metadata painted from the PU records (the deblocking
    bS input), on `device`: pred flags and MVs (int32), reference POCs
    (int64, NOREF where a list is unused).  The per-PU values are made on
    the host and every 4x4 cell of every PU is painted in one indexed
    store on the device (PUs do not overlap)."""
    pb_h, pb_w = prog.qp_y.shape
    pus = prog.pus
    # rows: pf, mv0x, mv0y, mv1x, mv1y, rp0, rp1
    grids = torch.zeros((7, pb_h * pb_w), dtype=torch.int64, device=device)
    grids[5:] = NOREF
    if len(pus):
        refs = np.asarray(prog.ref_pocs, np.int64)
        pf = pus["pred_flags"].astype(np.int64)
        vals = [pf] + [pus[f"mv{l}{a}"] for l in (0, 1) for a in "xy"] + [
            np.where(((pf >> l) & 1) != 0,
                     refs[np.clip(pus[f"ref_dpb{l}"], 0, len(refs) - 1)]
                     if len(refs) else NOREF, NOREF) for l in (0, 1)]
        w4 = (pus["w"] >> 2).astype(np.int64)
        n = w4 * (pus["h"] >> 2)
        geo = np.stack([pus["x"] >> 2, pus["y"] >> 2, w4, np.cumsum(n) - n])
        vals_t = _t(np.stack(vals), device, torch.int64)
        x4, y4, w4, start = _t(geo, device, torch.int64)
        k = torch.repeat_interleave(
            torch.arange(len(pus), device=device), _t(n, device, torch.int64))
        j = torch.arange(len(k), device=device) - start[k]
        cell = (y4[k] + j // w4[k]) * pb_w + x4[k] + j % w4[k]
        grids[:, cell] = vals_t[:, k]
    grids = grids.view(7, pb_h, pb_w)
    i32 = grids[:5].to(torch.int32)
    return i32[0], [[i32[1], i32[2]], [i32[3], i32[4]]], [grids[5], grids[6]]


def _deblock(prog: FrameProgramData, planes):
    """Deblocking from the program's per-4x4 metadata: the edge parameters
    in one launch, B8 for luma, B9 for both chroma planes
    (frame_helpers.deblock_planes)."""
    recs = prog.slice_records
    # every CTB in a slice with deblocking disabled: nothing to filter
    if np.all(recs[np.clip(prog.slice_idx, 0, len(recs) - 1), 1] != 0):
        return
    dev = planes[0].device
    pf, mv, rp = _paint_motion_grids(prog, dev)
    grids = {"cu4": _t(prog.cu_info, dev), "nzc4": _t(prog.nonzero_coeff, dev),
             "dbf4": _t(prog.deblock_flags, dev), "qp4": _t(prog.qp_y, dev),
             "unfilt": _t(_skip_filter_map4(prog), dev, torch.bool), "pf": pf,
             "mv0x": mv[0][0], "mv0y": mv[0][1], "mv1x": mv[1][0],
             "mv1y": mv[1][1], "poc0": rp[0].to(torch.int32),
             "poc1": rp[1].to(torch.int32)}
    has_chroma = prog.chroma_width > 0
    sub_x, sub_y = _subsampling(prog)
    st = {"sub_x": sub_x, "sub_y": sub_y, "bd": prog.bit_depth[0],
          "bdc": prog.bit_depth[1], "mono": not has_chroma,
          "ctb_size": prog.ctb_size, "n_slices": len(recs),
          "across_tiles": bool(prog.across_tiles)}
    n = 3 if has_chroma else 1
    planes[:n] = deblock_planes(
        [p.contiguous() for p in planes[:n]], grids, _t(recs, dev),
        _t(prog.slice_idx, dev), _t(prog.slice_addr, dev),
        _t(prog.tile_id, dev), st)


def _apply_sao(prog: FrameProgramData, planes):
    """SAO of every plane: per-sample maps from the per-CTB parameters,
    then kernel B10 (ops.sao_cuda.sao_plane_fused), one launch a plane."""
    recs = prog.slice_records
    if not np.any(recs[:, 4] | recs[:, 5]):
        return
    dev = planes[0].device
    skip4 = _t(_skip_filter_map4(prog), dev, torch.bool)
    # per-CTB slice-derived info
    sidx = np.clip(prog.slice_idx, 0, len(recs) - 1)
    sao_on = (_t(recs[sidx, 4] != 0, dev, torch.bool),
              _t(recs[sidx, 5] != 0, dev, torch.bool))
    across_slices = recs[sidx, 9] != 0
    multi = (len(recs) > 1 and
             (not np.all(across_slices))) or not prog.across_tiles
    sub_x, sub_y = _subsampling(prog)
    for c in range(3 if prog.chroma_width else 1):
        H = prog.height if c == 0 else prog.chroma_height
        W = prog.width if c == 0 else prog.chroma_width
        cs = ((prog.ctb_size, prog.ctb_size) if c == 0 else
              (prog.ctb_size // sub_y, prog.ctb_size // sub_x))
        tmap, emap, bmap, omap = sao_ops.upsample_ctb_params(
            prog.sao, c, prog.ctb_w, prog.ctb_h, cs, H, W, dev)
        # per-slice sao enable gates the CTB's type (spec 7.3.8.3)
        yy = (torch.arange(H, device=dev) // cs[0])[:, None]
        xx = (torch.arange(W, device=dev) // cs[1])[None, :]
        tmap = torch.where(sao_on[0 if c == 0 else 1][yy, xx], tmap, 0)
        edge_ok = None
        if multi:
            edge_ok = sao_ops.edge_boundary_ok(
                emap, _t(prog.slice_addr, dev),
                _t(across_slices, dev, torch.bool), _t(prog.tile_id, dev),
                prog.across_tiles, cs, H, W)
        rx = 4 // (1 if c == 0 else sub_x)
        ry = 4 // (1 if c == 0 else sub_y)
        skip = skip4.repeat_interleave(ry, 0).repeat_interleave(rx, 1)[
            :H, :W].contiguous()
        planes[c] = sao_cuda.sao_plane_fused(
            planes[c].contiguous(), tmap.contiguous(), emap, bmap, omap, skip,
            bit_depth=prog.bit_depth[c], edge_ok=edge_ok)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _zero_planes(prog, device):
    return [torch.zeros((prog.height, prog.width), dtype=torch.int32,
                        device=device)] + \
        [torch.zeros((prog.chroma_height, prog.chroma_width),
                     dtype=torch.int32, device=device) for _ in range(2)]


def reconstruct(prog: FrameProgramData, run_deblock=True, run_sao=True,
                device_intra=False, device="cuda", ref_planes=None):
    """Reconstruct a full picture from its FrameProgram on `device`.
    Returns 3 int32 planes (chroma [0, 0] for 4:0:0).

    device_intra=True batches intra blocks into wavefront levels executed
    on the device (ops.intra_wave) instead of the host-sequential loop.
    ref_planes: the reference pictures, one [Y, Cb, Cr] (tensors or
    arrays) per entry of prog.ref_pocs; default prog.ref_planes.  A
    reference that a PU reads and that has no planes raises RuntimeError.
    """
    dev = torch.device(device)
    planes = _zero_planes(prog, dev)
    residuals = _compute_residuals(prog, dev)
    _apply_ccp(prog, residuals)
    _motion_compensate(prog, planes, ref_planes)
    _apply_pcm(prog, planes)
    _add_inter_residuals(prog, planes, residuals)
    if device_intra:
        _intra_wavefront(prog, planes, residuals)
    else:
        _intra_host(prog, planes, residuals)
    if run_deblock and len(prog.slice_records):
        _deblock(prog, planes)
    if run_sao and len(prog.slice_records):
        _apply_sao(prog, planes)
    return planes


def reconstruct_stream(programs, run_deblock=True, run_sao=True,
                       device="cuda"):
    """Decode a whole stream through the pipeline as an independent chain:
    reconstructed pictures feed back as references for later pictures
    (keyed by POC), so no scalar-oracle pixels are consumed; a POC it has
    not decoded (a seek) is read from the planes the parser attached.

    `programs` must be in decode order (as exported).  Yields (poc,
    [Y, Cb, Cr]) per picture on `device`: torch.uint8 planes for 8-bit
    samples, torch.uint16 above, and the references keep every bit.
    """
    store = {}
    for prog in programs:
        refs = [store.get(poc, planes)
                for poc, planes in zip(prog.ref_pocs, prog.ref_planes)]
        planes = reconstruct(prog, run_deblock, run_sao, device=device,
                             ref_planes=refs)
        store[prog.poc] = planes
        yield prog.poc, [
            p.to(torch.uint8 if prog.bit_depth[min(c, 1)] <= 8
                 else torch.uint16) for c, p in enumerate(planes)]
