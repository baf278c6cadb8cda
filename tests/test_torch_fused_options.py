"""FusedDecoder's options and routes beyond the default decode.

- run_deblock / run_sao off (the JAX package's constructor flags): the
  planes equal the JAX FusedDecoder's with the same flags on a GOP, in
  both formulations of the port, and a routed picture (more than MAX_REFS
  references, decoded by pipeline.reconstruct) equals the JAX package's
  pipeline.reconstruct with the same flags.
- ROADMAP C4: on the production formulation a picture with more PUs than
  the segment words can index (mc_seg.MAX_PUS, lowered here) goes to
  pipeline.reconstruct instead of raising, and decodes bit-exact.
"""
import functools

import numpy as np
import pytest

import libde265_tpu
from libde265_tpu import pipeline as jpl
from libde265_tpu.fused_decode import FusedDecoder as JaxFusedDecoder

from libde265_tpu_torch import FusedDecoder
from libde265_tpu_torch.feed import MAX_REFS
from libde265_tpu_torch.ops import mc_seg

from _torch_common import gop, gop_bytes, programs, stripe_stream

FORMULATIONS = {"production": True, "per-cell": False}
FLAGS = {"no-deblock": (False, True), "no-sao": (True, False)}


@functools.lru_cache(maxsize=None)
def _jax_planes(flags):
    _, progs = programs(gop_bytes("p-sao"))
    fd = JaxFusedDecoder(*flags)
    fd.plan_stream(progs)
    return progs, [[np.asarray(p) for p in fd.decode(prog)]
                   for prog in progs]


@pytest.mark.parametrize("form", list(FORMULATIONS))
@pytest.mark.parametrize("flags", list(FLAGS))
def test_filter_flags_equal_jax(native_build, flags, form):
    progs, want = _jax_planes(FLAGS[flags])
    fd = FusedDecoder("cpu", *FLAGS[flags])
    fd.use_pallas_mc = FORMULATIONS[form]
    fd.plan_stream(progs)
    off = 0
    for i, prog in enumerate(progs):
        got = fd.decode(prog)
        for c in range(3):
            np.testing.assert_array_equal(got[c].numpy(), want[i][c],
                                          err_msg=f"frame {i} plane {c}")
            off += not np.array_equal(want[i][c], prog.planes[c])
    assert off, "the flags changed no plane"


@pytest.mark.parametrize("flags", list(FLAGS))
def test_routed_picture_filter_flags_equal_jax(native_build, flags):
    """Picture 9 of the stripe stream (9 references) on a fresh decoder,
    its references from the planes the parser attached, as the JAX
    package's pipeline reads them."""
    jprogs = libde265_tpu.Decoder(keep_programs=True)
    list(jprogs.decode_all(stripe_stream()))
    jprog = jprogs.get_program(MAX_REFS + 1)
    want = [np.asarray(p) for p in jpl.reconstruct(
        jprog, *FLAGS[flags], device_intra=False)]
    prog = programs(stripe_stream())[1][MAX_REFS + 1]
    fd = FusedDecoder("cpu", *FLAGS[flags])
    got = fd.decode(prog)
    assert fd.pipeline_pictures == 1
    for c in range(3):
        np.testing.assert_array_equal(got[c].numpy(), want[c])
    assert not np.array_equal(want[0], prog.planes[0])


def test_pictures_beyond_the_pu_index_go_to_the_pipeline(native_build,
                                                         monkeypatch):
    """C4 with the limit lowered below the PU count of every P picture of
    a 416x240 GOP: plan_stream skips them, decode sends them to
    pipeline.reconstruct (references from the ring), and every picture
    equals the oracle; the per-cell formulation has no such index and
    decodes them itself."""
    _, progs = programs(gop(416, 240, 3, **{"intra-period": 8}))
    n_p = sum(len(p.pus) > 0 for p in progs)
    assert n_p == 2
    monkeypatch.setattr(mc_seg, "MAX_PUS",
                        min(len(p.pus) for p in progs if len(p.pus)) - 1)
    for production, routed in ((True, n_p), (False, 0)):
        fd = FusedDecoder("cpu")
        fd.use_pallas_mc = production
        fd.plan_stream(progs)
        for i, prog in enumerate(progs):
            got = fd.decode(prog)
            for c in range(3):
                np.testing.assert_array_equal(got[c].numpy(), prog.planes[c],
                                              err_msg=f"frame {i} plane {c}")
        assert fd.pipeline_pictures == routed
