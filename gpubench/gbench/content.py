"""The content model: seeded synthetic video whose statistics resemble
camera content, so that the encoder's decisions (motion vectors,
merge/skip, CU sizes, residuals) vary as they do on real footage.

A background and `objects` foreground layers, each a texture with a
1/f^a amplitude spectrum (natural images have a close to 1) and random
phase.  The background pans; each object is a soft-edged ellipse that
carries its own texture and moves with its own (sub-pixel) velocity.
Mild Gaussian noise is added to every picture.  Chroma follows the
layers: a tint per layer plus the layer's texture at half resolution.

Picture t of seed s is a pure function of (s, t, the parameters), so the
worker processes that encode different segments of one clip agree.
"""
from __future__ import annotations

import math

import numpy as np


def texture(rng: np.random.Generator, h: int, w: int,
            exponent: float) -> np.ndarray:
    """[h, w] float32, zero mean, unit standard deviation, amplitude
    spectrum 1/f^exponent (random phase)."""
    noise = rng.standard_normal((h, w)).astype(np.float32)
    spec = np.fft.rfft2(noise)
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0
    spec *= (1.0 / f ** exponent).astype(np.float32)
    spec[0, 0] = 0.0
    img = np.fft.irfft2(spec, s=(h, w)).astype(np.float32)
    return img / max(float(img.std()), 1e-6)


def shifted(tex: np.ndarray, dy: float, dx: float, h: int,
            w: int) -> np.ndarray:
    """The [h, w] window of `tex` whose origin is (dy, dx), sampled
    bilinearly (0 <= dy, dx and the window stays inside `tex`)."""
    iy, ix = int(math.floor(dy)), int(math.floor(dx))
    fy, fx = dy - iy, dx - ix
    a = tex[iy:iy + h + 1, ix:ix + w + 1]
    top = a[:-1, :-1] * (1 - fx) + a[:-1, 1:] * fx
    bot = a[1:, :-1] * (1 - fx) + a[1:, 1:] * fx
    return top * (1 - fy) + bot * fy


class Scene:
    """The layers of one seed's clip (`frames` pictures of h x w)."""

    def __init__(self, seed: int, h: int, w: int, frames: int, p: dict):
        rng = np.random.default_rng([int(seed), 0x6B65])
        self.h, self.w, self.p, self.seed = h, w, p, int(seed)
        n = int(p["objects"])
        lo, hi = p["background_speed"]
        self.margin = int(math.ceil(max(p["object_speed"][1], hi) * frames)) + 2
        H, W = h + 2 * self.margin, w + 2 * self.margin
        self.layers = []
        for k in range(n + 1):
            speed = rng.uniform(*(p["background_speed"] if k == 0
                                  else p["object_speed"]))
            ang = rng.uniform(0, 2 * math.pi)
            layer = {
                "tex": texture(rng, H, W, p["spectrum_exponent"]),
                "v": (speed * math.sin(ang), speed * math.cos(ang)),
                "mean": rng.uniform(*p["luma_mean"]),
                "std": rng.uniform(*p["luma_std"]),
                "tint": rng.uniform(-p["chroma_tint"], p["chroma_tint"], 2),
            }
            if k:
                s0, s1 = p["object_size"]
                layer["c"] = (rng.uniform(0.15, 0.85) * h,
                              rng.uniform(0.15, 0.85) * w)
                layer["r"] = (rng.uniform(s0, s1) * h, rng.uniform(s0, s1) * w)
            self.layers.append(layer)

    def frame(self, t: int):
        """Picture t: (y, cb, cr) uint8 planes (4:2:0)."""
        h, w, m, p = self.h, self.w, self.margin, self.p
        y = np.zeros((h, w), np.float32)
        cb = np.zeros((h // 2, w // 2), np.float32)
        cr = np.zeros((h // 2, w // 2), np.float32)
        yy = np.arange(h, dtype=np.float32)[:, None]
        xx = np.arange(w, dtype=np.float32)[None, :]
        for k, L in enumerate(self.layers):
            vy, vx = L["v"]
            tex = shifted(L["tex"], m - vy * t, m - vx * t, h, w)
            val = L["mean"] + L["std"] * tex
            cval = tex[::2, ::2] * p["chroma_std"]
            if k == 0:
                alpha = None
            else:
                cy, cx = L["c"][0] + vy * t, L["c"][1] + vx * t
                ry, rx = L["r"]
                r = np.sqrt(((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2)
                edge = p["edge_px"] / max(min(ry, rx), 1.0)
                alpha = np.clip((1.0 - r) / edge, 0.0, 1.0)
            tb, tr = 128 + L["tint"][0] + cval, 128 + L["tint"][1] - cval
            if alpha is None:
                y, cb, cr = val, tb, tr
            else:
                ca = alpha[::2, ::2]
                y = y * (1 - alpha) + val * alpha
                cb = cb * (1 - ca) + tb * ca
                cr = cr * (1 - ca) + tr * ca
        noise = np.random.default_rng([self.seed, 0x6E6F, t])
        y = y + p["noise_std"] * noise.standard_normal((h, w)).astype(
            np.float32)

        def u8(a):
            return np.clip(np.rint(a), 0, 255).astype(np.uint8)
        return u8(y), u8(cb), u8(cr)
