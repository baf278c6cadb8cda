"""A 3840x2160 P-GOP whose P pictures hold more PUs than the segment
words can index (``mc_seg.MAX_PUS``), on the card.

The encoder's ``min-8`` split codes every CU of a textured, moving picture
as 8x8 (about 129,000 PUs a 4K P picture), so the production formulation
sends each P picture to ``pipeline.reconstruct`` (ROADMAP C4, F2) with its
references from the DPB ring, and the I picture through the fused
program.  Every picture equals the scalar oracle, ``pipeline_pictures``
counts the routed ones, and the host ms of each picture (``decode`` and a
synchronize, second pass after a reset) is printed (run with ``-s``).
The CPU test of the same route lowers the limit instead
(``tests/test_torch_fused_options.py``).
"""
import functools
import time

import numpy as np
import pytest
import torch

from libde265_tpu_torch import FusedDecoder
from libde265_tpu_torch.encoder import Encoder
from libde265_tpu_torch.ops import mc_seg

from _torch_common import cuda, programs  # noqa: F401 - fixture

W, H = 3840, 2160


@functools.lru_cache(maxsize=None)
def _uhd_p_gop(n=3, qp=30):
    """I, P, P at 3840x2160, every CU 8x8 (bytes)."""
    rng = np.random.default_rng(2160)
    tex = rng.integers(0, 256, (H + 16, W + 16)).astype(np.uint8)
    with Encoder(qp=qp, ctb_size=64) as enc:
        enc.set_parameter("intra-period", 8)
        enc.set_parameter("cb-split-algo", "min-8")
        data = b""
        for t in range(n):
            y = tex[t:t + H, 2 * t:2 * t + W]
            data += enc.encode(y, y[::2, ::2].copy(), y[1::2, 1::2].copy(),
                               pts=t)
        return data + enc.finish()


@pytest.mark.gpu
def test_uhd_pictures_above_max_pus_routed_bit_exact(cuda):  # noqa: F811
    _, progs = programs(_uhd_p_gop())
    assert (progs[0].width, progs[0].height) == (W, H)
    big = [len(p.pus) > mc_seg.MAX_PUS for p in progs]
    assert not big[0] and all(big[1:]), [len(p.pus) for p in progs]
    fd = FusedDecoder()
    fd.plan_stream(progs)
    for rnd in range(2):
        fd.reset()
        fd.pipeline_pictures = 0
        ms = []
        for i, prog in enumerate(progs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fd.decode(prog)
            torch.cuda.synchronize()
            ms.append(1000 * (time.perf_counter() - t0))
            for c in range(3):
                np.testing.assert_array_equal(
                    got[c].cpu().numpy(), prog.planes[c],
                    err_msg=f"pass {rnd} picture {i} plane {c}")
        assert fd.pipeline_pictures == sum(big)
    print(f"4K route: PUs {[len(p.pus) for p in progs]}, routed "
          f"{fd.pipeline_pictures}, host ms a picture (decode + sync) "
          f"{[round(x, 1) for x in ms]}")
