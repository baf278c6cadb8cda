"""The fused intra super-wave step (``csrc/intra.cu``, ``tde_intra_step``)
and its plain PyTorch version.

One call does one (plane, size, step) bin of the intra scan on the padded
plane (``ops/intra_window.py``): the border gather (kernel B6's function),
substitution, filtering and prediction (``ops.intra_wave.wave_predict``),
the residual add and clip, and the store (kernel B7's function).  It
replaces the TPU program's step ``fused_decode._wave_body(pallas=True)``:
B6, the XLA math and B7 there, one kernel here.

Design: one CTA per block slot; a slot whose valid bit (``meta[k, 4] & 8``)
is clear returns at once, so valid blocks need not lead.  The CTA has s*s
threads, one per pixel; the raw and the filtered border (4s+1 samples
each) sit in shared memory, and one thread runs the substitution chain.
The CTAs of a launch read their borders while others store their blocks:
that is exact only because the scan's schedule never marks available a
border sample inside a valid block of the same step (samples it marks
unavailable are read too, but substitution discards them);
``tests/test_torch_intra_window.py`` checks the schedule of the test
streams for it.  The step's records are read through base pointers and the step index, the
residual through ``rrow`` straight from the size bin's residual rows, so a
step costs one ctypes call and no tensor slicing.  The work is small (at
most 256 blocks, 16K pixels): a step is bound by launch latency, and
below that by the bytes of the residual rows and the stored blocks.
"""
from __future__ import annotations

import torch

from . import _build
from . import intra_window as iw
from ._tensors import check, on_cuda, stream_of
from .intra_wave import wave_predict

launches = 0  # kernel launches since the last reset (read by chip_smoke)


def intra_step_plain(padded, meta_all, rrow_all, aw_all, step: int, res,
                     P0, P1, WT, *, s: int, bit_depth: int):
    """One bin of one super-wave step on the padded plane, in place: B6's
    function, the wave math, B7's function.

    padded: [Hp, Wp] int32; meta_all [steps, K, 5], rrow_all [steps, K],
    aw_all [steps, K, AVAIL_WORDS]: the bin's scan records, of which row
    `step` is used; res: [n, s, s] residual rows of the size bin (rrow -1:
    none); P0/P1/WT: build_mode_tables(s) as tensors.  Returns padded."""
    meta, rrow, aw = meta_all[step], rrow_all[step], aw_all[step]
    resid = torch.where((rrow >= 0)[:, None, None],
                        res[rrow.long().clamp(0, res.shape[0] - 1)], 0)
    y0p = meta[:, 2] + iw.PAD_T
    x0p = meta[:, 3] + iw.PAD_L
    tops, lefts = iw.border_gather_plain(padded, y0p, x0p, meta.shape[0], s=s)
    out = wave_predict(torch.cat([lefts.flip(1), tops], 1), meta, aw, resid,
                       P0, P1, WT, s, bit_depth)
    return iw.window_scatter_plain(padded, out, y0p, x0p,
                                   (meta[:, 4] & 8) != 0, s=s)


def intra_step(padded, meta_all, rrow_all, aw_all, step: int, res, P0, P1,
               WT, *, s: int, bit_depth: int):
    """intra_step_plain's update (the fused kernel on a CUDA tensor, the
    plain version on a CPU tensor); returns padded."""
    global launches
    if not on_cuda("intra_step", padded):
        return intra_step_plain(padded, meta_all, rrow_all, aw_all, step, res,
                                P0, P1, WT, s=s, bit_depth=bit_depth)
    check("intra_step", padded.device, torch.int32, padded, meta_all,
          rrow_all, aw_all, res, P0, P1, WT)
    n_steps, K = rrow_all.shape
    if s not in (4, 8, 16, 32):
        raise ValueError(f"intra_step: block size {s}")
    if (padded.dim() != 2 or meta_all.shape != (n_steps, K, 5) or
            aw_all.shape[:2] != (n_steps, K) or aw_all.dim() != 3 or
            res.dim() != 3 or res.shape[1:] != (s, s) or res.shape[0] == 0 or
            any(t.shape != (35, s * s) for t in (P0, P1, WT))):
        raise ValueError("intra_step: bad record, residual or table shapes")
    if not 0 <= step < n_steps:
        raise IndexError(f"intra_step: step {step} of {n_steps}")
    if K == 0:
        return padded
    Hp, Wp = padded.shape
    rc = _build.lib().tde_intra_step(
        padded.data_ptr(), Hp, Wp, iw.PAD_T, iw.PAD_L, meta_all.data_ptr(),
        rrow_all.data_ptr(), aw_all.data_ptr(), aw_all.shape[2], step, K,
        res.data_ptr(), res.shape[0], P0.data_ptr(), P1.data_ptr(),
        WT.data_ptr(), s, bit_depth, stream_of(padded))
    _build.check_launch("tde_intra_step", rc)
    launches += 1
    return padded
