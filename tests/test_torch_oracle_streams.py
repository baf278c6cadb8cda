"""Streams made for the scalar oracle, through every decode path of the port
(FusedDecoder in both formulations, pipeline.reconstruct and
DeviceDecoder), bit-exact on the CPU:

* unequal bit depths (ROADMAP C8): an 8-bit 4:2:0 B-GOP with SAO whose SPS
  is rewritten to 10-bit chroma (_torch_common.with_chroma_depth).  Its
  slice syntax does not depend on the chroma depth (no PCM, no extended
  precision, no chroma SAO offset of magnitude 7), so the native decoder
  parses the same syntax elements at the new depth, and its planes are the
  oracle.  Every residual, MC, intra, deblocking and SAO stage of a chroma
  plane then runs at 10 bits while luma stays at 8;
* transform skip (ROADMAP C2): the encoder's impulse stream
  (_torch_common.tskip_stream), whose 4x4 chroma TUs take transform skip.
"""
import functools

import numpy as np
import pytest

from libde265_tpu_torch import FusedDecoder, pipeline
from libde265_tpu_torch.decoder import TU_TRANSFORM_SKIP
from libde265_tpu_torch.tpu_decode import DeviceDecoder

from _torch_common import (CHROMA_DEPTH_GOP, chroma_depth_gop, gop,
                           programs, tskip_stream)

STREAMS = {"chroma-depth": chroma_depth_gop, "transform-skip": tskip_stream}


@functools.lru_cache(maxsize=None)
def _programs(name):
    return programs(STREAMS[name]())[1]


def _fused(production):
    def run(progs):
        fd = FusedDecoder(device="cpu")
        fd.use_pallas_mc = production
        return [fd.decode(p) for p in progs]
    return run


def _device_decoder(progs):
    dd = DeviceDecoder(device="cpu")
    return [dd.decode(p) for p in progs]


def _pipeline(progs):
    return [pipeline.reconstruct(p, device="cpu") for p in progs]


PATHS = {"fused-production": _fused(True), "fused-per-cell": _fused(False),
         "pipeline": _pipeline, "device-decoder": _device_decoder}


def test_chroma_depth_stream_parses_the_same_syntax(native_build):
    """The rewritten SPS changes the chroma depth and nothing else that
    the slices code: TUs (but their QP', which adds QpBdOffsetC), PUs,
    intra blocks and SAO parameters equal those of the 8-bit parse."""
    src = programs(gop(w=64, h=64, n=5, **CHROMA_DEPTH_GOP))[1]
    progs = _programs("chroma-depth")
    assert [p.bit_depth[:2] for p in progs] == [(8, 10)] * len(src)
    names = [f for f in src[0].tus.dtype.names if f != "qp"]
    for a, b in zip(src, progs):
        assert np.array_equal(a.tus[names], b.tus[names])
        assert np.array_equal(a.pus, b.pus)
        assert np.array_equal(a.intras, b.intras)
        assert np.array_equal(a.sao, b.sao)
        assert not (np.abs(a.sao["offset"][:, 1:]) == 7).any()
    # the stream exercises what differs: chroma SAO, bi-prediction, and
    # chroma samples above 8 bits
    assert any((p.sao["type_idx"][:, 1:] != 0).any() for p in progs)
    assert any((p.pus["pred_flags"] == 3).any() for p in progs
               if len(p.pus))
    assert max(int(p.planes[1].max()) for p in progs) > 255


def test_transform_skip_stream_has_transform_skip(native_build):
    ts = [int(((p.tus["flags"] & TU_TRANSFORM_SKIP) != 0).sum())
          for p in _programs("transform-skip")]
    assert all(n > 0 for n in ts), ts
    assert any(len(p.pus) for p in _programs("transform-skip"))


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("name", list(STREAMS))
def test_decode_bit_exact(native_build, name, path):
    progs = _programs(name)
    outs = PATHS[path](progs)
    assert len(outs) == len(progs)
    for i, (planes, prog) in enumerate(zip(outs, progs)):
        for c in range(3):
            got = planes[c].numpy()
            bad = np.argwhere(got != prog.planes[c])
            assert not len(bad), (f"{path} picture {i} plane {c}: {len(bad)} "
                                  f"differ, first at {bad[0].tolist()}")
