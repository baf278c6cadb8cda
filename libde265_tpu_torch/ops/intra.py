"""Intra prediction (spec 8.4.4.2): the host-sequential implementation.

A copy of ``libde265_tpu/ops/intra.py`` (numpy only), so that the port
imports nothing of the JAX package; ``tests/test_torch_copies.py`` holds
the two equal.  Intra blocks depend on their reconstructed neighbours in
decode order: ``pipeline.reconstruct(..., device_intra=False)`` predicts
them one by one on the host with ``predict_block``; ``ops/intra_wave.py``
is the wavefront-batched version on the device (``device_intra=True``).

Bit-exact counterpart of native/src/intra.cc.
"""
from __future__ import annotations

import numpy as np

ANGLE = np.array([0, 0, 32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17,
                  -21, -26, -32, -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9,
                  13, 17, 21, 26, 32])
INV_ANGLE = np.array([0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -4096, -1638, -910,
                      -630, -482, -390, -315, -256, -315, -390, -482, -630,
                      -910, -1638, -4096, 0, 0, 0, 0, 0, 0, 0, 0, 0])


class IntraContext:
    """Availability helpers for one picture (no-tiles z-scan order)."""

    def __init__(self, width, height, ctb_size, cu_info, constrained=False,
                 strong_smoothing=True, smoothing_disabled=False,
                 slice_addr=None, tile_id=None):
        self.width = width
        self.height = height
        self.log2ctb = int(ctb_size).bit_length() - 1
        self.cu_info = cu_info  # per-4x4 (bit0 = intra)
        self.constrained = constrained
        self.strong_smoothing = strong_smoothing
        self.smoothing_disabled = smoothing_disabled
        self.ctb_w = (width + ctb_size - 1) // ctb_size
        self.slice_addr = slice_addr  # per-CTB [ctb_h, ctb_w] or None
        self.tile_id = tile_id

    def _zscan(self, x, y):
        # no-tiles z-scan index of the 4x4 block at luma (x, y)
        cx, cy = x >> self.log2ctb, y >> self.log2ctb
        base = (cy * self.ctb_w + cx) << (2 * (self.log2ctb - 2))
        px, py = (x >> 2) & ((1 << (self.log2ctb - 2)) - 1), \
                 (y >> 2) & ((1 << (self.log2ctb - 2)) - 1)
        p = 0
        for i in range(self.log2ctb - 2):
            m = 1 << i
            p += (m * m if (px & m) else 0) + (2 * m * m if (py & m) else 0)
        return base + p

    def available(self, x_curr, y_curr, xn, yn):
        if xn < 0 or yn < 0 or xn >= self.width or yn >= self.height:
            return False
        if self._zscan(xn, yn) > self._zscan(x_curr, y_curr):
            return False
        # neighbors in a different slice or tile are unavailable (6.4.1)
        if self.slice_addr is not None:
            ca = (y_curr >> self.log2ctb, x_curr >> self.log2ctb)
            na = (yn >> self.log2ctb, xn >> self.log2ctb)
            if self.slice_addr[na] != self.slice_addr[ca]:
                return False
            if self.tile_id is not None and self.tile_id[na] != self.tile_id[ca]:
                return False
        if self.constrained:
            if not (self.cu_info[yn >> 2, xn >> 2] & 1):
                return False
        return True


def fill_border(plane, ctx: IntraContext, x0c, y0c, nT, cidx, sub_x, sub_y,
                bit_depth):
    """Gather + substitute the 4*nT+1 border samples (spec 8.4.4.2.2)."""
    n2 = 2 * nT
    border = np.zeros(4 * nT + 1, dtype=np.int32)
    avail = np.zeros(4 * nT + 1, dtype=bool)
    h, w = plane.shape
    xL, yL = x0c * sub_x, y0c * sub_y

    def savail(xc, yc):
        return ctx.available(xL, yL, xc * sub_x, yc * sub_y)

    for k in range(n2):
        yc = y0c + n2 - 1 - k
        if x0c > 0 and yc < h and savail(x0c - 1, yc):
            border[k] = plane[yc, x0c - 1]
            avail[k] = True
    if x0c > 0 and y0c > 0 and savail(x0c - 1, y0c - 1):
        border[n2] = plane[y0c - 1, x0c - 1]
        avail[n2] = True
    for k in range(n2):
        xc = x0c + k
        if y0c > 0 and xc < w and savail(xc, y0c - 1):
            border[n2 + 1 + k] = plane[y0c - 1, xc]
            avail[n2 + 1 + k] = True

    if not avail.any():
        border[:] = 1 << (bit_depth - 1)
        return border
    if not avail[0]:
        first = np.argmax(avail)
        border[0] = border[first]
        avail[0] = True
    for i in range(1, 4 * nT + 1):
        if not avail[i]:
            border[i] = border[i - 1]
    return border


def filter_border(border, nT, bit_depth, strong):
    n2 = 2 * nT
    corner = int(border[n2])
    out = border.copy()
    bi = False
    if strong and nT == 32:
        thr = 1 << (bit_depth - 5)
        bi = (abs(corner + border[4 * nT] - 2 * border[n2 + nT]) < thr and
              abs(corner + border[0] - 2 * border[nT]) < thr)
    if bi:
        bl, tr = int(border[0]), int(border[4 * nT])
        i = np.arange(1, n2)
        out[n2 - i] = ((n2 - i) * corner + i * bl + 32) >> 6
        out[n2 + i] = ((n2 - i) * corner + i * tr + 32) >> 6
    else:
        mid = (border[:-2] + 2 * border[1:-1] + border[2:] + 2) >> 2
        out[1:-1] = mid
    return out


def predict_block(plane, ctx: IntraContext, x0, y0, nT, cidx, mode, sub_x,
                  sub_y, bit_depth, chroma444=False):
    """Predict one intra block in place (spec 8.4.4.2.4-8.4.4.2.6)."""
    n2 = 2 * nT
    border = fill_border(plane, ctx, x0, y0, nT, cidx, sub_x, sub_y, bit_depth)

    filt = False
    if (cidx == 0 or chroma444) and not ctx.smoothing_disabled:
        if mode != 1 and nT != 4:
            mind = min(abs(mode - 26), abs(mode - 10))
            thresh = 7 if nT == 8 else (1 if nT == 16 else 0)
            filt = True if mode == 0 else (mind > thresh)
    if filt:
        border = filter_border(border, nT, bit_depth,
                               ctx.strong_smoothing and cidx == 0)

    dst = np.zeros((nT, nT), dtype=np.int32)
    left = border[n2 - 1 - np.arange(n2)]   # p[-1][y]
    top = border[n2 + 1 + np.arange(n2)]    # p[x][-1]
    corner = int(border[n2])
    lg = nT.bit_length() - 1

    if mode == 0:  # planar
        x = np.arange(nT)[None, :]
        y = np.arange(nT)[:, None]
        dst = (((nT - 1 - x) * left[:nT][:, None] + (x + 1) * int(top[nT]) +
                (nT - 1 - y) * top[:nT][None, :] + (y + 1) * int(left[nT]) +
                nT) >> (lg + 1))
    elif mode == 1:  # DC
        dc = (int(left[:nT].sum() + top[:nT].sum()) + nT) >> (lg + 1)
        dst[:, :] = dc
        if cidx == 0 and nT < 32:
            dst[0, 0] = (left[0] + 2 * dc + top[0] + 2) >> 2
            dst[0, 1:] = (top[1:nT] + 3 * dc + 2) >> 2
            dst[1:, 0] = (left[1:nT] + 3 * dc + 2) >> 2
    else:  # angular
        angle = int(ANGLE[mode])
        if mode >= 18:
            ref = np.zeros(3 * nT + 1 + nT, dtype=np.int32)
            base = nT  # ref[base + i] = spec ref[i]
            ref[base:base + n2 + 1] = np.concatenate(([corner], top[:n2]))
            if angle < 0:
                minidx = (nT * angle) >> 5
                for xx in range(-1, minidx - 1, -1):
                    off = (xx * int(INV_ANGLE[mode]) + 128) >> 8
                    # entries whose projection falls outside the border are
                    # never read by the interpolation; clamp for safety
                    ref[base + xx] = border[max(n2 - off, 0)]
            y = np.arange(nT)
            idx = ((y + 1) * angle) >> 5
            fact = ((y + 1) * angle) & 31
            for yy in range(nT):
                i0 = base + idx[yy] + 1
                r1 = ref[i0:i0 + nT]
                r2 = ref[i0 + 1:i0 + nT + 1]
                if fact[yy]:
                    dst[yy] = ((32 - fact[yy]) * r1 + fact[yy] * r2 + 16) >> 5
                else:
                    dst[yy] = r1
            if mode == 26 and cidx == 0 and nT < 32:
                v = top[0] + ((left[:nT] - corner) >> 1)
                dst[:, 0] = np.clip(v, 0, (1 << bit_depth) - 1)
        else:
            ref = np.zeros(3 * nT + 1 + nT, dtype=np.int32)
            base = nT
            ref[base:base + n2 + 1] = np.concatenate(([corner], left[:n2]))
            if angle < 0:
                minidx = (nT * angle) >> 5
                for xx in range(-1, minidx - 1, -1):
                    off = (xx * int(INV_ANGLE[mode]) + 128) >> 8
                    ref[base + xx] = border[min(n2 + off, 4 * nT)]
            x = np.arange(nT)
            idx = ((x + 1) * angle) >> 5
            fact = ((x + 1) * angle) & 31
            for xx in range(nT):
                i0 = base + idx[xx] + 1
                r1 = ref[i0:i0 + nT]
                r2 = ref[i0 + 1:i0 + nT + 1]
                if fact[xx]:
                    dst[:, xx] = ((32 - fact[xx]) * r1 + fact[xx] * r2 + 16) >> 5
                else:
                    dst[:, xx] = r1
            if mode == 10 and cidx == 0 and nT < 32:
                v = left[0] + ((top[:nT] - corner) >> 1)
                dst[0, :] = np.clip(v, 0, (1 << bit_depth) - 1)

    plane[y0:y0 + nT, x0:x0 + nT] = dst
