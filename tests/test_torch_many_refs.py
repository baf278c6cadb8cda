"""Pictures with more than MAX_REFS (8) references through the port's
FusedDecoder: routed to pipeline.reconstruct with the references read from
the decoder's own DPB.

The stream: 256x64, 12 pictures, 16 vertical stripes whose textures
repeat every 1..16 pictures (_torch_common.stripe_stream), encoded with up
to 15 references: picture t reads t references, so pictures 9-11 go to
the pipeline.  Under parse_only (the production decode) the parser
attaches no reference planes; the port decodes every picture bit-exact
against the oracle in both formulations, while the JAX FusedDecoder fails
on picture 9 there, reading the planes the parser did not attach (ROADMAP
C6).  On a full decode the port equals the JAX FusedDecoder.  A reference
that is neither in the DPB nor attached raises, and no picture reads the
ring's gray slot.  The gpu tests decode the stream on the card and count
the loop-filter kernels of each routed picture.
"""
import functools

import numpy as np
import pytest
import torch

import libde265_tpu
from libde265_tpu.fused_decode import FusedDecoder as JaxFusedDecoder

import libde265_tpu_torch as lt
from libde265_tpu_torch.feed import MAX_REFS
from libde265_tpu_torch.ops import deblock_cuda, sao_cuda

from _torch_common import cuda, stripe_stream  # noqa: F401

ROUTED = (9, 10, 11)
FORMULATIONS = {"production": True, "per-cell": False}


@functools.lru_cache(maxsize=None)
def _programs(parse_only, mod=lt):
    dec = mod.Decoder(keep_programs=True, parse_only=parse_only)
    list(dec.decode_all(stripe_stream()))
    return [dec.get_program(i) for i in range(dec.num_programs())]


def _oracle():
    return _programs(False)


def _assert_oracle(outs, what):
    oracle = _oracle()
    assert len(outs) == len(oracle)
    for i, (planes, prog) in enumerate(zip(outs, oracle)):
        assert len(planes) == 3
        for c, pl in enumerate(planes):
            got = pl.cpu().numpy()
            want = prog.planes[c].astype(np.int32)
            if not np.array_equal(got, want):
                bad = np.argwhere(got != want)
                raise AssertionError(f"{what}: picture {i} plane {c}: "
                                     f"{len(bad)} differ, first at "
                                     f"{bad[0].tolist()}")


def _decoder(production, device="cpu"):
    fd = lt.FusedDecoder(device=device)
    fd.use_pallas_mc = production
    return fd


def test_reference_counts(native_build):
    """Picture t reads t references (the PUs' own count, not the RPS
    size); the parse-only programs carry no reference planes."""
    progs = _programs(True)
    assert [len(p.ref_pocs) for p in progs] == list(range(12))
    assert [i for i, p in enumerate(progs) if len(p.ref_pocs) > MAX_REFS] \
        == list(ROUTED)
    assert all(pl is None for p in progs for r in p.ref_planes for pl in r)


@pytest.mark.parametrize("form", list(FORMULATIONS))
def test_parse_only_decode_bit_exact(native_build, form):
    """Both formulations under parse_only: every picture equals the
    oracle, three of them routed to the pipeline."""
    fd = _decoder(FORMULATIONS[form])
    fd.plan_stream(_programs(True))
    outs = [fd.decode(p) for p in _programs(True)]
    _assert_oracle(outs, form)
    assert fd.pipeline_pictures == len(ROUTED)


@pytest.mark.parametrize("form", list(FORMULATIONS))
def test_pipelined_decoder_returns_routed_pictures_in_order(native_build,
                                                            form):
    pd = lt.PipelinedDecoder(device="cpu")
    pd.fd.use_pallas_mc = FORMULATIONS[form]
    _assert_oracle(pd.decode_stream(stripe_stream()), f"pipelined {form}")
    assert pd.fd.pipeline_pictures == len(ROUTED)


def test_jax_fused_decoder_fails_under_parse_only(native_build):
    """C6: the JAX FusedDecoder sends picture 9 to pipeline.reconstruct,
    which reads prog.ref_planes, and the parse-only program has none."""
    progs = _programs(True, libde265_tpu)
    with pytest.raises(AttributeError):
        JaxFusedDecoder().decode(progs[ROUTED[0]])


def test_full_decode_equals_jax_fused_decoder(native_build):
    """On a full decode (the oracle's planes attached) the port's routed
    pictures equal the JAX FusedDecoder's, in both formulations; the port
    still reads its own DPB, the JAX decoder the attached planes."""
    jprogs = _programs(False, libde265_tpu)
    jfd = JaxFusedDecoder()
    want = {i: [np.asarray(p) for p in jfd.decode(jprogs[i])]
            for i in ROUTED}
    for form, production in FORMULATIONS.items():
        fd = _decoder(production)
        outs = [fd.decode(p) for p in _oracle()]
        assert fd.pipeline_pictures == len(ROUTED)
        for i in ROUTED:
            for c in range(3):
                np.testing.assert_array_equal(
                    outs[i][c].numpy(), want[i][c],
                    err_msg=f"{form} picture {i} plane {c}")


@pytest.mark.parametrize("form", list(FORMULATIONS))
def test_missing_reference_raises(native_build, form):
    """A routed picture whose references the decoder never decoded and the
    program does not carry raises RuntimeError naming the POC; it never
    reads the ring's gray slot."""
    fd = _decoder(FORMULATIONS[form])
    prog = _programs(True)[ROUTED[0]]
    poc = prog.ref_pocs[0]
    with pytest.raises(RuntimeError, match=f"reference POC {poc} "):
        fd.decode(prog)
    assert fd.pipeline_pictures == 0


@pytest.mark.parametrize("form", list(FORMULATIONS))
def test_seek_reads_attached_references(native_build, form):
    """A seek: a fresh decoder starts at a routed picture of the full
    decode; its references come from the planes the parser attached (and
    seed the ring), and the picture equals the oracle."""
    fd = _decoder(FORMULATIONS[form])
    i = ROUTED[-1]
    out = fd.decode(_oracle()[i])
    for c in range(3):
        np.testing.assert_array_equal(out[c].numpy(),
                                      _oracle()[i].planes[c])
    if FORMULATIONS[form]:
        assert set(_oracle()[i].ref_pocs) <= set(fd._slot_of)


def test_every_reference_survives_the_store(native_build):
    """The ring's LRU marks every reference of a routed picture as used,
    not only the first MAX_REFS: with the ring full (pictures 0-10, then
    five other POCs stored after them), picture 11's store evicts one of
    the five, no reference of it, and the picture equals the oracle."""
    fd = _decoder(True)
    progs = _programs(True)
    for p in progs[:ROUTED[-1]]:
        fd.decode(p)
    prog = progs[ROUTED[-1]]
    others = [-100 - k for k in range(2 * MAX_REFS - ROUTED[-1])]
    for poc in others:
        fd._store_stack(poc, [torch.zeros((64, 256), dtype=torch.int32)] +
                        [torch.zeros((32, 128), dtype=torch.int32)] * 2,
                        prog)
    assert len(fd._slot_of) == 2 * MAX_REFS
    out = fd.decode(prog)
    assert set(prog.ref_pocs) | {prog.poc} <= set(fd._slot_of)
    assert len(set(others) - set(fd._slot_of)) == 1
    assert 2 * MAX_REFS not in fd._slot_of.values()
    for c in range(3):
        np.testing.assert_array_equal(out[c].numpy(),
                                      _oracle()[ROUTED[-1]].planes[c])


@pytest.mark.gpu
def test_many_refs_on_card(cuda, native_build):  # noqa: F811
    """FusedDecoder() on the card (production) equals the oracle under
    parse_only; each routed picture launches B8 and B9 once and B10 once
    per plane."""
    fd = lt.FusedDecoder()
    assert fd.use_pallas_mc
    fd.plan_stream(_programs(True))
    outs = []
    for i, p in enumerate(_programs(True)):
        deblock_cuda.luma_launches = deblock_cuda.chroma_launches = 0
        sao_cuda.launches = 0
        outs.append(fd.decode(p))
        torch.cuda.synchronize()
        if i in ROUTED:
            assert (deblock_cuda.luma_launches, deblock_cuda.chroma_launches,
                    sao_cuda.launches) == (1, 1, 3), i
    _assert_oracle(outs, "card")
    assert fd.pipeline_pictures == len(ROUTED)
