"""The port's native feed packer (FeedPacker.pack_native, through
native/src/feedpack.cc) word for word against the port's numpy packer
(FeedPacker.pack with pallas_mc) and the JAX package's _pack_native:
layout, buffer, size bins, slice count, watermarks and latches, on every
stream of tests/test_native_pack.py that exists and on the GOPs of
_torch_common, with capacities grown picture by picture and planned up
front (plan_stream from the native caps against the numpy planning), on
ring-slot maps that are not the identity.

Then the decoder's choice of packer, counted by the packer's counters: a
live native source and no CCP latched packs natively, a program without
one (src = None) or a stream with CCP by numpy; and the packer's
failures: more than 65536 PUs raise ValueError before any native call, a
code from the native side raises RuntimeError.

The gpu test decodes a GOP on the card with every picture packed
natively.
"""
import dataclasses
import pathlib

import numpy as np
import pytest

from libde265_tpu import Decoder
from libde265_tpu.fused_decode import FusedDecoder as JaxFusedDecoder

from libde265_tpu_torch import FusedDecoder
from libde265_tpu_torch.feed import MAX_REFS, FeedPacker

from _torch_common import GOPS, OWN_CORPUS, cuda, gop_bytes  # noqa: F401
from _torch_common import programs
from test_native_pack import STREAMS

CASES = [pathlib.Path(s).stem for s in STREAMS
         if pathlib.Path(s).exists()] + sorted(GOPS)
PATHS = {pathlib.Path(s).stem: pathlib.Path(s) for s in STREAMS}


def _stream(name):
    return PATHS[name].read_bytes() if name in PATHS else gop_bytes(name)


def _parsed(data):
    """(decoder, programs) of a parse-only decode, as PipelinedDecoder
    runs it: the programs keep their live native source."""
    dec = Decoder(parse_only=True, keep_programs=True)
    list(dec.decode_all(data))
    return dec, [dec.get_program(i) for i in range(dec.num_programs())]


def _no_cc(caps):
    return {k: v for k, v in caps.items() if not k.startswith("cc")}


@pytest.mark.parametrize("name", CASES)
def test_pack_native_matches_numpy_and_jax(native_build, name):
    _, progs = _parsed(_stream(name))
    assert progs and all(p.src is not None for p in progs)
    for plan in (False, True):
        numpy_pk, native_pk = FeedPacker(), FeedPacker()
        jfd = JaxFusedDecoder()
        jfd.use_pallas_mc = True
        if plan:
            # the numpy planning: the same programs without their source
            numpy_pk.plan_stream([dataclasses.replace(p, src=None)
                                  for p in progs], pallas_mc=True)
            native_pk.plan_stream(progs, pallas_mc=True)
            jfd.plan_stream(progs)
            assert native_pk.caps == numpy_pk.caps == _no_cc(jfd.caps)
            assert native_pk.intra_lgs == numpy_pk.intra_lgs
        for i, p in enumerate(progs):
            n = min(len(p.ref_pocs), MAX_REFS)
            slot_map = {k: (5 * k + 3) % (2 * MAX_REFS) for k in range(n)}
            slot_row = np.array([i * 7, i * 5, i * 5], np.int32)
            want = numpy_pk.pack(p, slot_map, slot_row, pallas_mc=True)
            got = native_pk.pack_native(p, slot_map, slot_row)
            jax = jfd._pack_native(p, slot_map, slot_row)
            what = f"{name} planned={plan} picture {i}"
            for ref in (want, jax):
                assert got[0] == tuple(ref[0]), what
                np.testing.assert_array_equal(got[1], ref[1], err_msg=what)
                assert got[2] == list(ref[2]) and got[3] == ref[3], what
            assert native_pk.caps == numpy_pk.caps == _no_cc(jfd.caps), what
            assert native_pk.use_l1 == numpy_pk.use_l1 == jfd._use_l1
            assert native_pk.intra_lgs == numpy_pk.intra_lgs == \
                jfd._intra_lgs
        assert (native_pk.native_packs, native_pk.numpy_packs) == \
            (len(progs), 0)
        assert (numpy_pk.native_packs, numpy_pk.numpy_packs) == \
            (0, len(progs))


def _decode(progs, fd):
    outs = [fd.decode(p) for p in progs]
    return outs, (fd.packer.native_packs, fd.packer.numpy_packs)


def test_decoder_packs_natively_with_a_live_source(native_build):
    """FusedDecoder on the production formulation: every picture with a
    live source packs natively, every one without (src = None) by numpy,
    both equal to the oracle; the use_pallas_mc=False feed is numpy's."""
    _, progs = programs(gop_bytes("b-tmvp"))
    n = len(progs)
    for strip, production, counts in ((False, True, (n, 0)),
                                      (True, True, (0, n)),
                                      (False, False, (0, n))):
        fd = FusedDecoder(device="cpu")
        fd.use_pallas_mc = production
        pp = [dataclasses.replace(p, src=None) if strip else p
              for p in progs]
        fd.plan_stream(pp)
        outs, got = _decode(pp, fd)
        assert got == counts, (strip, production)
        for i, (planes, p) in enumerate(zip(outs, progs)):
            for c in range(3):
                np.testing.assert_array_equal(planes[c].numpy(),
                                              p.planes[c], err_msg=str(i))


def test_ccp_latches_the_numpy_packer(native_build):
    """Without plan_stream the first CCP picture latches CCP: the pictures
    before it pack natively, it and every later one by numpy, and the
    numpy feed then carries the CCP fields of every bin.  The stream is
    all intra, so its pictures decode in any order: the ones without CCP
    go first."""
    _, progs = programs((OWN_CORPUS / "chroma444_ccp.h265").read_bytes())
    assert not any(len(p.pus) for p in progs)
    progs.sort(key=lambda p: bool((p.tus["cross_comp_scale"] != 0).any()))
    ccp = [bool((p.tus["cross_comp_scale"] != 0).any()) for p in progs]
    first = ccp.index(True)
    assert first > 0
    fd = FusedDecoder(device="cpu")
    fd.use_pallas_mc = True
    seen = []
    pack = fd.packer.pack

    def spy(*a, **k):
        out = pack(*a, **k)
        seen.append({name for name, _, _ in out[0]})
        return out

    fd.packer.pack = spy
    for i, p in enumerate(progs):
        planes = fd.decode(p)
        assert fd.packer.has_ccp == any(ccp[:i + 1])
        assert (fd.packer.native_packs, fd.packer.numpy_packs) == \
            (min(i + 1, first), max(0, i + 1 - first))
        for c in range(3):
            np.testing.assert_array_equal(planes[c].numpy(), p.planes[c])
    for names in seen:
        bins = {k.split(".")[0] for k in names if k.startswith("bin")}
        assert bins and all(f"{b}.ccp_row" in names and
                            f"{b}.ccp_scale" in names for b in bins)


class _NoNative:
    """A native source whose library must not be called."""
    _ctx = 1

    @property
    def _lib(self):
        raise AssertionError("the native packer was called")


def test_pu_index_guard_raises_before_native(native_build):
    """65537 PUs: the segment words' 16-bit index cannot hold the last
    one, so pack_native (and the native planning) raise ValueError, as
    mc_seg.plan_segment_indices does, before any native call."""
    _, progs = _parsed(gop_bytes("p-sao"))
    p = progs[1]
    pus = np.resize(p.pus, 65537)
    big = dataclasses.replace(p, pus=pus, src=(_NoNative(), 1))
    pk = FeedPacker()
    with pytest.raises(ValueError, match="16-bit"):
        pk.pack_native(big, {0: 0}, np.zeros(3, np.int32))
    with pytest.raises(ValueError, match="16-bit"):
        pk.plan_stream([big], pallas_mc=True)
    ok = dataclasses.replace(p, pus=np.resize(p.pus, 65536),
                             src=(_NoNative(), 1))
    with pytest.raises(AssertionError, match="native packer was called"):
        pk.pack_native(ok, {0: 0}, np.zeros(3, np.int32))


def test_native_failure_raises(native_build, monkeypatch):
    """A code from the native side is a fault, not a case for the numpy
    packer: a program index the parser does not hold fails in
    tde265_pack_caps, an entry key it does not know in
    tde265_pack_feed."""
    dec, progs = _parsed(gop_bytes("p-sao"))
    p = progs[1]
    pk = FeedPacker()
    bad = dataclasses.replace(p, src=(dec, len(progs) + 100))
    with pytest.raises(RuntimeError, match="tde265_pack_caps.*code -1"):
        pk.pack_native(bad, {0: 0}, np.zeros(3, np.int32))
    with pytest.raises(RuntimeError, match="tde265_pack_caps"):
        pk.plan_stream([bad], pallas_mc=True)
    layout = pk._native_layout

    def unknown_key(*a):
        lay, entries, total = layout(*a)
        entries = entries.copy()
        entries[0, 0] = 99
        return lay, entries, total

    monkeypatch.setattr(pk, "_native_layout", unknown_key)
    with pytest.raises(RuntimeError, match="tde265_pack_feed.*code -3"):
        pk.pack_native(p, {0: 0}, np.zeros(3, np.int32))
    assert pk.native_packs == 0


@pytest.mark.gpu
def test_gop_packs_natively_on_card(cuda, native_build):  # noqa: F811
    """FusedDecoder() on the card: a P GOP and a B GOP, every picture
    packed natively, every plane the oracle's."""
    for name in ("p-sao", "b-tmvp"):
        _, progs = programs(gop_bytes(name))
        fd = FusedDecoder()
        assert fd.use_pallas_mc
        fd.plan_stream(progs)
        outs, counts = _decode(progs, fd)
        assert counts == (len(progs), 0), name
        for i, (planes, p) in enumerate(zip(outs, progs)):
            for c in range(3):
                np.testing.assert_array_equal(planes[c].cpu().numpy(),
                                              p.planes[c],
                                              err_msg=f"{name} {i}")
