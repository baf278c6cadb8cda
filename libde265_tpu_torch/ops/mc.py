"""Motion-compensation interpolation filters (spec 8.5.3.3.3).

Constants of ``libde265_tpu/ops/mc.py``; the interpolation itself lives in
``frame_helpers._mc_plane``.
"""
from __future__ import annotations

import numpy as np

QPEL_FILTERS = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1]], dtype=np.int32)

EPEL_FILTERS = np.array([
    [0, 64, 0, 0], [-2, 58, 10, -2], [-4, 54, 16, -2], [-6, 46, 28, -4],
    [-4, 36, 36, -4], [-4, 28, 46, -6], [-2, 16, 54, -4], [-2, 10, 58, -2]],
    dtype=np.int32)
