"""The port's whole-picture program and decoders, bit-exact.

* frame level: the JAX program's captured per-picture inputs
  (refs, buf, sft, st, layout) go through the port's _compiled_impl, which
  must return the JAX program's planes, as captured (the unpadded intra
  scan) and with st["pallas_intra"] set (the padded-plane scan);
* decoder level: FusedDecoder(device="cpu") and PipelinedDecoder equal the
  scalar oracle (prog.planes) on P, B, 2-ref, weighted, 10-bit,
  tiled/multi-slice and all-intra GOPs;
* the entry points run on the CUDA card unless asked for the CPU;
* state carried across pictures: one P picture decoded from the parser's
  reference planes alone, in both packages.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from libde265_tpu import fused_decode as jfd
from libde265_tpu.decoder import TU_RDPCM

from libde265_tpu_torch import FusedDecoder, PipelinedDecoder
from libde265_tpu_torch import fused_decode as tfd

from _torch_common import GOPS, gop_bytes, programs


def _assert_planes(outs, progs):
    assert len(outs) == len(progs)
    for i, (planes, prog) in enumerate(zip(outs, progs)):
        assert len(planes) == 3
        for c, pl in enumerate(planes):
            np.testing.assert_array_equal(pl.numpy(), prog.planes[c],
                                          err_msg=f"frame {i} plane {c}")


@functools.lru_cache(maxsize=None)
def _jax_calls(stream):
    """Run the JAX FusedDecoder over a GOP, recording each picture's program
    inputs and outputs as numpy arrays."""
    _, progs = programs(gop_bytes(stream))
    calls = []
    orig = jfd._compiled

    def probe(refs_y, refs_cb, refs_cr, buf, sft, st, layout):
        out = orig(refs_y, refs_cb, refs_cr, buf, sft, st, layout)
        calls.append(((np.array(refs_y), np.array(refs_cb),
                       np.array(refs_cr), np.array(buf),
                       None if sft is None else [np.array(t) for t in sft],
                       st, layout), [np.asarray(o) for o in out]))
        return out

    jfd._compiled = probe
    try:
        fd = jfd.FusedDecoder()
        fd.plan_stream(progs)
        for p in progs:
            fd.decode(p)
    finally:
        jfd._compiled = orig
    return progs, calls


def _check_frame_programs(stream, pallas_intra):
    progs, calls = _jax_calls(stream)
    assert len(calls) == len(progs)
    for i, ((ry, rcb, rcr, buf, sft, st, layout), want) in enumerate(calls):
        assert not dict(st)["pallas_mc"]
        assert not dict(st)["pallas_intra"]
        if pallas_intra:
            st = {**dict(st), "pallas_intra": True}
        got = tfd._compiled_impl(
            torch.from_numpy(ry), torch.from_numpy(rcb),
            torch.from_numpy(rcr), torch.from_numpy(buf),
            None if sft is None else tuple(map(torch.from_numpy, sft)),
            st, layout)
        assert len(got) == len(want)
        for c in range(len(want)):
            np.testing.assert_array_equal(got[c].numpy(), want[c],
                                          err_msg=f"frame {i} plane {c}")
            np.testing.assert_array_equal(got[c].numpy(),
                                          progs[i].planes[c])


@pytest.mark.parametrize("stream", ["p-sao", "10bit"])
def test_frame_program_matches_jax(native_build, stream):
    _check_frame_programs(stream, pallas_intra=False)


@pytest.mark.parametrize("stream", ["p-sao", "10bit"])
def test_frame_program_pallas_intra_matches_jax(native_build, stream):
    """The JAX planes of the unpadded scan; the JAX padded-plane scan gives
    the same planes (tests/test_intra_window_pallas.py)."""
    _check_frame_programs(stream, pallas_intra=True)


@pytest.mark.parametrize("stream", list(GOPS))
def test_fused_decoder_bit_exact(native_build, stream):
    _, progs = programs(gop_bytes(stream))
    fd = FusedDecoder(device="cpu")
    fd.plan_stream(progs)
    _assert_planes([fd.decode(p) for p in progs], progs)


def test_fused_decoder_all_intra(native_build):
    _, progs = programs(gop_bytes("all-intra"))
    assert all(len(p.pus) == 0 for p in progs)
    fd = FusedDecoder(device="cpu")
    _assert_planes([fd.decode(p) for p in progs], progs)


def test_entry_points_default_to_cuda():
    """Constructing a decoder allocates nothing, so this needs no card."""
    assert FusedDecoder().device.type == "cuda"
    assert PipelinedDecoder().fd.device.type == "cuda"
    assert FusedDecoder(device="cpu").device.type == "cpu"


def test_fused_decoder_watermark_growth(native_build):
    """Without plan_stream the capacities grow mid-stream."""
    _, progs = programs(gop_bytes("tiles"))
    fd = FusedDecoder(device="cpu")
    _assert_planes([fd.decode(p) for p in progs], progs)


@pytest.mark.parametrize("one_core", [False, True],
                         ids=["threaded", "sequential"])
@pytest.mark.parametrize("stream", ["b-tmvp", "10bit"])
def test_pipelined_decoder(native_build, monkeypatch, stream, one_core):
    data = gop_bytes(stream)
    _, progs = programs(data)
    if one_core:
        monkeypatch.setattr("os.cpu_count", lambda: 1)
    _assert_planes(PipelinedDecoder(device="cpu").decode_stream(data), progs)


def test_seek_decode_from_reference_planes(native_build):
    """A P picture decoded by fresh decoders of both packages, its
    references taken from the planes the parser attached."""
    progs, _ = _jax_calls("p-sao")
    k = 3
    assert len(progs[k].pus) and progs[k].ref_planes
    jdec = jfd.FusedDecoder()
    jdec.plan_stream(progs)
    want = [np.asarray(p) for p in jdec.decode(progs[k])]
    tdec = FusedDecoder(device="cpu")
    tdec.plan_stream(progs)
    got = tdec.decode(progs[k])
    for c in range(3):
        np.testing.assert_array_equal(got[c].numpy(), want[c])
        np.testing.assert_array_equal(got[c].numpy(), progs[k].planes[c])


def test_unported_paths_raise(native_build):
    _, progs = programs(gop_bytes("p-sao"))
    p = progs[1]
    fd = FusedDecoder(device="cpu")
    with pytest.raises(NotImplementedError, match="MAX_REFS"):
        fd.decode(dataclasses.replace(p, ref_pocs=list(range(9))))
    tus = p.tus.copy()
    tus["cross_comp_scale"][0] = 1
    with pytest.raises(NotImplementedError, match="A2"):
        fd.decode(dataclasses.replace(p, tus=tus))
    tus = p.tus.copy()
    tus["flags"][0] |= TU_RDPCM
    with pytest.raises(NotImplementedError, match="A2"):
        fd.decode(dataclasses.replace(p, tus=tus))
    with pytest.raises(NotImplementedError, match="ring"):
        tfd._check_config({"fuse_store": True})
    with pytest.raises(ValueError, match="intra plan"):
        fd.decode(dataclasses.replace(progs[0], ip=None))
