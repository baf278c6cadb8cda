"""Angular intra prediction tables (spec 8.4.4.2.6).

Port of ``build_mode_tables`` from ``libde265_tpu/ops/intra_wave.py``:
pure numpy, shared by every step of the intra super-wave scan.
"""
from __future__ import annotations

import functools

import numpy as np

from libde265_tpu.ops.intra import ANGLE, INV_ANGLE


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
