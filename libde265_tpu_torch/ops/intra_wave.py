"""Intra super-wave math (spec 8.4.4.2): the angular tables, the
prediction of one step's blocks from their raw borders, and the wavefront
planner and kernel of ``pipeline.reconstruct(..., device_intra=True)``.

Port of ``libde265_tpu/ops/intra_wave.py``.  ``build_mode_tables``,
``border_plan`` and ``plan_blocks`` are its host planning (numpy);
``ANGLE`` and ``INV_ANGLE`` come from the port's copy of ``ops/intra.py``.
``wave_predict`` is the math of the JAX program's ``fused_decode.
_wave_body`` between the border gather and the store, shared by
``intra_wave_kernel`` and ``ops.intra_cuda.intra_step_plain`` (the plain
version of the scan kernel's step).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .intra import ANGLE, INV_ANGLE, IntraContext


@functools.lru_cache(maxsize=None)
def build_mode_tables(s: int):
    """Per-(mode, size) angular gather tables.

    Returns (P0, P1, W): int32 [35, s*s], the border indices of the two
    reference samples and the interpolation weight for every output pixel.
    Modes 0/1 rows are unused (planar/DC are computed directly).
    """
    n2 = 2 * s
    P0 = np.zeros((35, s * s), dtype=np.int32)
    P1 = np.zeros((35, s * s), dtype=np.int32)
    W = np.zeros((35, s * s), dtype=np.int32)
    for mode in range(2, 35):
        angle = int(ANGLE[mode])
        inv = int(INV_ANGLE[mode])
        vertical = mode >= 18

        def ref_map(i):
            # spec ref[] index -> border[] index
            if i >= 0:
                return (n2 + i) if vertical else (n2 - i)
            off = (i * inv + 128) >> 8
            if vertical:
                return max(n2 - off, 0)
            return min(n2 + off, 4 * s)

        k = np.arange(s)
        idx = ((k + 1) * angle) >> 5
        fact = ((k + 1) * angle) & 31
        p0 = np.zeros((s, s), dtype=np.int32)
        p1 = np.zeros((s, s), dtype=np.int32)
        w = np.zeros((s, s), dtype=np.int32)
        for a in range(s):          # a = y (vertical modes) or x (horizontal)
            for b in range(s):      # b runs along the reference
                i0 = idx[a] + 1 + b
                if vertical:
                    p0[a, b] = ref_map(i0)
                    p1[a, b] = ref_map(i0 + 1)
                    w[a, b] = fact[a]
                else:
                    p0[b, a] = ref_map(i0)
                    p1[b, a] = ref_map(i0 + 1)
                    w[b, a] = fact[a]
        P0[mode] = p0.ravel()
        P1[mode] = p1.ravel()
        W[mode] = w.ravel()
    return P0, P1, W


def wave_predict(b_raw, meta, aw, resid, P0, P1, WT, s: int, bit_depth: int):
    """Reconstructed [N, s, s] blocks of one super-wave step from their raw
    borders (spec 8.4.4.2): substitution, filtering, prediction, residual
    add and clip.

    b_raw: [N, 4s+1] border samples, k < 2s the left column (bottom to
    top), k = 2s the corner, k > 2s the top row (left to right); only the
    samples whose availability bit is set are read.  meta: [N, 5] records
    (mode, edge, y0, x0, flags 1 unavailable | 2 filter | 4 strong |
    8 valid); aw: [N, AVAIL_WORDS] availability bits; resid: [N, s, s];
    P0/P1/WT: the build_mode_tables(s) rows as tensors."""
    dev = b_raw.device
    w = torch.where
    mode, edge = meta[:, 0], meta[:, 1]
    unavail = (meta[:, 4] & 1) != 0
    filt = (meta[:, 4] & 2) != 0
    strong = (meta[:, 4] & 4) != 0
    N = mode.shape[0]
    n2 = 2 * s
    nb = 4 * s + 1
    maxv = (1 << bit_depth) - 1
    lg = s.bit_length() - 1

    # substitution: each sample takes the last available sample at or
    # before it, else the first available one (jump-propagation ladders)
    k = torch.arange(nb, device=dev)
    fil = ((aw[:, k >> 5] >> (k & 31)) & 1) != 0
    b = w(fil, b_raw, 0)
    sh = 1
    while sh < nb:                       # fill-forward: nearest at-or-before
        b = w(fil, b, torch.cat([b.new_zeros((N, sh)), b[:, :nb - sh]], 1))
        fil = fil | torch.cat([fil.new_zeros((N, sh)), fil[:, :nb - sh]], 1)
        sh *= 2
    sh = 1
    while sh < nb:                       # fill-backward: before the first
        b = w(fil, b, torch.cat([b[:, sh:], b.new_zeros((N, sh))], 1))
        fil = fil | torch.cat([fil[:, sh:], fil.new_zeros((N, sh))], 1)
        sh *= 2
    b = w(unavail[:, None], 1 << (bit_depth - 1), b)

    corner = b[:, n2]
    tap3 = b.clone()
    tap3[:, 1:-1] = (b[:, :-2] + 2 * b[:, 1:-1] + b[:, 2:] + 2) >> 2
    if s == 32:
        thr = 1 << (bit_depth - 5)
        bi_ok = (((corner + b[:, 4 * s] - 2 * b[:, n2 + s]).abs() < thr) &
                 ((corner + b[:, 0] - 2 * b[:, s]).abs() < thr))
        i = torch.arange(1, n2, device=dev, dtype=torch.int32)
        bl = b[:, 0:1]
        tr = b[:, 4 * s:4 * s + 1]
        bilin = b.clone()
        bilin[:, n2 - i] = ((n2 - i)[None, :] * corner[:, None] +
                            i[None, :] * bl + 32) >> 6
        bilin[:, n2 + i] = ((n2 - i)[None, :] * corner[:, None] +
                            i[None, :] * tr + 32) >> 6
        filtered = w((strong & bi_ok)[:, None], bilin,
                     w(filt[:, None], tap3, b))
    else:
        filtered = w(filt[:, None], tap3, b)

    left = filtered[:, :n2].flip(1)
    top = filtered[:, n2 + 1:]
    corner = filtered[:, n2]

    xg = torch.arange(s, device=dev, dtype=torch.int32)[None, None, :]
    yg = torch.arange(s, device=dev, dtype=torch.int32)[None, :, None]
    planar = (((s - 1 - xg) * left[:, :s, None] +
               (xg + 1) * top[:, s, None, None] +
               (s - 1 - yg) * top[:, None, :s] +
               (yg + 1) * left[:, s, None, None] + s) >> (lg + 1))

    dc = ((left[:, :s].sum(1) + top[:, :s].sum(1) + s) >> (lg + 1)).to(
        torch.int32)
    dcp = dc[:, None, None].expand(N, s, s)
    if s < 32:
        dce = dcp.clone()
        dce[:, 0, 1:] = (top[:, 1:s] + 3 * dc[:, None] + 2) >> 2
        dce[:, 1:, 0] = (left[:, 1:s] + 3 * dc[:, None] + 2) >> 2
        dce[:, 0, 0] = (left[:, 0] + 2 * dc + top[:, 0] + 2) >> 2
        dcp = w((edge == 1)[:, None, None], dce, dcp)

    # angular reference fetch: rows of the per-mode tables, then a gather
    # along the filtered border.  Table entries outside the border (only
    # ever paired with weight 0) read as 0, as the JAX one-hot product does.
    mi = mode.long().clamp(0, 34)

    def fetch(tab):
        p = tab[mi].long()
        inside = (p >= 0) & (p < nb)
        return w(inside, torch.gather(filtered, 1, p.clamp(0, nb - 1)), 0)

    g0 = fetch(P0)
    g1 = fetch(P1)
    wt = WT[mi]
    ang = (((32 - wt) * g0 + wt * g1 + 16) >> 5).reshape(N, s, s)
    if s < 32:
        v26 = (top[:, 0, None] + ((left[:, :s] - corner[:, None]) >> 1)).clamp(
            0, maxv)
        v10 = (left[:, 0, None] + ((top[:, :s] - corner[:, None]) >> 1)).clamp(
            0, maxv)
        a26 = ang.clone()
        a26[:, :, 0] = v26
        ang = w((edge == 2)[:, None, None], a26, ang)
        a10 = ang.clone()
        a10[:, 0, :] = v10
        ang = w((edge == 3)[:, None, None], a10, ang)

    pred = w((mode == 0)[:, None, None], planar,
             w((mode == 1)[:, None, None], dcp, ang))
    return (pred + resid).clamp(0, maxv)


# ---------------------------------------------------------------------------
# the wavefront of pipeline.reconstruct(..., device_intra=True)
# ---------------------------------------------------------------------------

def border_plan(ctx: IntraContext, x0c, y0c, nT, sub_x, sub_y, H, W):
    """Static border gather plan for one block (mirrors intra.fill_border).

    Returns (pos [4nT+1, 2], subst [4nT+1], all_unavailable).
    """
    n2 = 2 * nT
    n = 4 * nT + 1
    pos = np.zeros((n, 2), dtype=np.int32)
    avail = np.zeros(n, dtype=bool)
    xL, yL = x0c * sub_x, y0c * sub_y

    def savail(xc, yc):
        return ctx.available(xL, yL, xc * sub_x, yc * sub_y)

    for k in range(n2):
        yc = y0c + n2 - 1 - k
        if x0c > 0 and yc < H and savail(x0c - 1, yc):
            pos[k] = (yc, x0c - 1)
            avail[k] = True
    if x0c > 0 and y0c > 0 and savail(x0c - 1, y0c - 1):
        pos[n2] = (y0c - 1, x0c - 1)
        avail[n2] = True
    for k in range(n2):
        xc = x0c + k
        if y0c > 0 and xc < W and savail(xc, y0c - 1):
            pos[n2 + 1 + k] = (y0c - 1, xc)
            avail[n2 + 1 + k] = True

    subst = np.arange(n, dtype=np.int32)
    if not avail.any():
        return pos, subst, True
    if not avail[0]:
        subst[0] = int(np.argmax(avail))
    for i in range(1, n):
        if not avail[i]:
            subst[i] = subst[i - 1]
    return pos, subst, False


def plan_blocks(prog, ctx: IntraContext, residuals):
    """Group the picture's intra ops into wavefront levels.

    residuals: {log2 size: (TU indices, [N, s, s] int32 tensor)}, as
    pipeline._compute_residuals gives them.  Returns {(wave, cidx,
    log2_size): block-batch dict} in wave order; each batch holds the
    stacked static inputs of intra_wave_kernel (numpy), and its residual
    blocks ("resid") as a tensor on the residuals' device, zero blocks for
    intra ops without a residual TU and for the padding entries.
    """
    from ..decoder import OP_INTRA, OP_RESIDUAL, TU_INTRA

    tus = prog.tus
    rows = tu_rows(residuals, len(tus))
    # associate each intra op with its residual TU (same x/y/cidx, the next
    # intra-flagged residual op in decode order); the other ops are skipped
    # before the loop
    kind, opi = prog.ops["kind"], prog.ops["idx"].astype(np.int64)
    intra_tu = np.zeros(len(kind), bool)
    res = kind == OP_RESIDUAL
    if len(tus):
        intra_tu[res] = (tus["flags"][opi[res]] & TU_INTRA) != 0
    blocks = []           # [rec, TU index or -1]
    pending = {}          # (x, y, cidx) -> block index
    for k in np.nonzero((kind == OP_INTRA) | intra_tu)[0]:
        if kind[k] == OP_INTRA:
            rec = prog.intras[opi[k]]
            key = (int(rec["x"]), int(rec["y"]), int(rec["cidx"]))
            pending[key] = len(blocks)
            blocks.append([rec, -1])
        else:
            t = int(opi[k])
            tu = tus[t]
            key = (int(tu["x"]), int(tu["y"]), int(tu["cidx"]))
            b = pending.get(key)
            if b is not None:
                blocks[b][1] = t

    # wavefront levels per channel (4-pel metadata grids)
    grids = {}
    batches = {}
    chroma444 = prog.chroma_width == prog.width and prog.chroma_width > 0
    for rec, t in blocks:
        c = int(rec["cidx"])
        if c == 0:
            sub_x = sub_y = 1
        else:
            sub_x = prog.width // prog.chroma_width
            sub_y = prog.height // prog.chroma_height
        H = prog.height if c == 0 else prog.chroma_height
        Wd = prog.width if c == 0 else prog.chroma_width
        if c not in grids:
            grids[c] = np.zeros(((H + 3) // 4, (Wd + 3) // 4), dtype=np.int32)
        wmap = grids[c]
        x0, y0 = int(rec["x"]), int(rec["y"])
        lg = int(rec["log2_size"])
        nT = 1 << lg
        pos, subst, unavail = border_plan(ctx, x0, y0, nT, sub_x, sub_y, H, Wd)
        # wave = 1 + max wave of the cells this block's border reads
        if unavail:
            wave = 1
        else:
            have = subst == np.arange(len(subst))  # originally available
            cells = pos[have] >> 2
            wave = 1 + int(wmap[cells[:, 0], cells[:, 1]].max(initial=0))
        wmap[y0 >> 2:(y0 + nT + 3) >> 2, x0 >> 2:(x0 + nT + 3) >> 2] = wave

        mode = int(rec["mode"])
        filt = False
        # smoothing (8.4.4.2.3): luma always eligible; chroma only in 4:4:4
        if (c == 0 or chroma444) and not ctx.smoothing_disabled:
            if mode != 1 and nT != 4:
                mind = min(abs(mode - 26), abs(mode - 10))
                thresh = 7 if nT == 8 else (1 if nT == 16 else 0)
                filt = True if mode == 0 else (mind > thresh)
        strong = filt and ctx.strong_smoothing and c == 0 and nT == 32
        edge = 0
        if c == 0 and nT < 32:
            if mode == 1:
                edge = 1
            elif mode == 26:
                edge = 2
            elif mode == 10:
                edge = 3

        b = batches.setdefault((wave, c, lg), {
            "pos": [], "subst": [], "unavail": [], "filt": [], "strong": [],
            "mode": [], "edge": [], "row": [], "y0": [], "x0": []})
        b["pos"].append(pos)
        b["subst"].append(subst)
        b["unavail"].append(unavail)
        b["filt"].append(filt)
        b["strong"].append(strong)
        b["mode"].append(mode)
        b["edge"].append(edge)
        b["row"].append(rows[t] if t >= 0 else -1)
        b["y0"].append(y0)
        b["x0"].append(x0)

    out = {}
    for key in sorted(batches):
        b = batches[key]
        row = np.asarray(b.pop("row"), np.int64)
        arrs = {k: np.stack(v) if k in ("pos", "subst") else np.asarray(v)
                for k, v in b.items()}
        # pad the batch to a power-of-two size, as the JAX planner does
        # for its trace cache (padded entries carry valid=False and are
        # not stored)
        n = len(arrs["mode"])
        cap = 1 << max(0, (n - 1).bit_length())
        arrs["valid"] = np.ones(n, dtype=bool)
        if cap != n:
            for k, v in list(arrs.items()):
                pad_block = np.zeros((cap - n,) + v.shape[1:], dtype=v.dtype)
                arrs[k] = np.concatenate([v, pad_block])
            row = np.concatenate([row, np.full(cap - n, -1, np.int64)])
        arrs["resid"] = _gather_rows(residuals, key[2], row)
        out[key] = arrs
    return out


def tu_rows(residuals, n_tus):
    """Row of each TU in its size bin of `residuals` (-1: none)."""
    rows = np.full(n_tus, -1, np.int64)
    for idx, _ in residuals.values():
        rows[idx] = np.arange(len(idx))
    return rows


def _gather_rows(residuals, lg, row):
    """[len(row), s, s] int32: bin lg's residual at each row, zeros at -1."""
    s = 1 << lg
    if lg not in residuals:
        dev = next(iter(residuals.values()))[1].device if residuals \
            else torch.device("cpu")
        return torch.zeros((len(row), s, s), dtype=torch.int32, device=dev)
    res = residuals[lg][1]
    padded = torch.cat([res, res.new_zeros((1, s, s))])
    sel = torch.as_tensor(np.where(row >= 0, row, len(res)), device=res.device)
    return padded[sel]


def intra_wave_kernel(plane, pos, subst, unavail, filt, strong, mode, edge,
                      resid, y0, x0, valid, P0, P1, WT, s: int,
                      bit_depth: int = 8):
    """Predict + residual-add one wave of N same-size intra blocks.

    plane: [H, W] int32 tensor, updated in place and returned; pos
    [N, 4s+1, 2], subst [N, 4s+1], unavail/filt/strong/valid [N] bool,
    mode/edge/y0/x0 [N], P0/P1/WT [35, s*s] (build_mode_tables(s)): numpy
    arrays or tensors; resid [N, s, s] int32 tensor.  The borders are
    gathered and substituted by the plan's indices (JAX's
    take_along_axis), so every sample counts as available to
    wave_predict, which does the rest.  Padding entries (valid False) and
    samples outside the plane are not stored."""
    dev = plane.device
    H, W = plane.shape

    def t(a):
        return torch.as_tensor(a, device=dev)

    pos, subst = t(pos).long(), t(subst).long()
    b = torch.gather(plane[pos[..., 0], pos[..., 1]], 1, subst)
    N = b.shape[0]
    flags = (t(unavail).int() | (t(filt).int() << 1) |
             (t(strong).int() << 2) | (t(valid).int() << 3))
    y0, x0 = t(y0).int(), t(x0).int()
    meta = torch.stack([t(mode).int(), t(edge).int(), y0, x0, flags], 1)
    aw = torch.full((N, (4 * s + 32) // 32), -1, dtype=torch.int32,
                    device=dev)
    out = wave_predict(b, meta, aw, resid, t(P0), t(P1), t(WT), s, bit_depth)
    ar = torch.arange(s, device=dev)
    rows = y0[:, None, None] + ar[None, :, None]
    cols = x0[:, None, None] + ar[None, None, :]
    ok = t(valid)[:, None, None] & (rows < H) & (cols < W)
    flat = plane.view(-1)
    idx = (rows.long() * W + cols.long())[ok]
    flat[idx] = out.to(plane.dtype)[ok]
    return plane
