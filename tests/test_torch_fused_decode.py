"""The port's whole-picture program and decoders, bit-exact.

* frame level: the JAX program's captured per-picture inputs
  (refs, buf, sft, st, layout) go through the port's _compiled_impl (its
  one intra scan, on padded planes), which must return the JAX program's
  planes, as captured (JAX's unpadded intra scan) and with the JAX program
  run again on them with st["pallas_intra"] set (JAX's padded-plane scan,
  its Pallas kernels in interpret mode);
* decoder level: FusedDecoder(device="cpu") and PipelinedDecoder equal the
  scalar oracle (prog.planes) on P, B, 2-ref, weighted, 10-bit,
  tiled/multi-slice and all-intra GOPs;
* the entry points run on the CUDA card unless asked for the CPU;
* state carried across pictures: one P picture decoded from the parser's
  reference planes alone, in both packages;
* the production formulation (use_pallas_mc: segment MC from the padded
  DPB ring, residual band stripes, the painted PU map, the sparse feed
  upload and the fused store): the JAX production program's captured
  inputs give its planes and its ring, the decoders equal the oracle, the
  ring's LRU and its seeding on a seek, and the disjointness of the
  segments that the kernels write from many CTAs at once.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from libde265_tpu import Encoder
from libde265_tpu import fused_decode as jfd
from libde265_tpu.decoder import TU_RDPCM, TU_TQ_BYPASS, TU_TRANSFORM_SKIP

from libde265_tpu_torch import FusedDecoder, PipelinedDecoder
from libde265_tpu_torch import fused_decode as tfd
from libde265_tpu_torch.tpu_decode import DeviceDecoder

from libde265_tpu_torch.feed import FeedPacker, MAX_REFS

from _torch_common import GOPS, gop, gop_bytes, programs


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
    """The port's program on each captured picture against the JAX
    program's planes: as captured, or with pallas_intra the JAX program run
    again with its padded-plane scan."""
    progs, calls = _jax_calls(stream)
    assert len(calls) == len(progs)
    for i, ((ry, rcb, rcr, buf, sft, st, layout), want) in enumerate(calls):
        assert not dict(st)["pallas_mc"]
        assert not dict(st)["pallas_intra"]
        if pallas_intra:
            jst = tuple(sorted({**dict(st), "pallas_intra": True,
                                "pallas_interp": True}.items()))
            want = [np.asarray(o) for o in jfd._compiled(
                ry, rcb, rcr, buf, sft, jst, layout)]
        got = tfd._compiled_impl(
            torch.from_numpy(ry), torch.from_numpy(rcb),
            torch.from_numpy(rcr), torch.from_numpy(buf),
            None if sft is None else tuple(map(torch.from_numpy, sft)),
            st, layout, n_intra=len(progs[i].intras))
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
    """The JAX program rerun with its padded-plane scan (B6 and B7 as
    Pallas kernels in interpret mode), so that the pair holds the port
    against both of JAX's scans."""
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
    assert DeviceDecoder().device.type == "cuda"
    assert DeviceDecoder(device="cpu").device.type == "cpu"


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
    """A picture with intra blocks and no native intra plan no longer
    raises: feed._plan_intra schedules its records, as in the JAX package,
    and it decodes to the oracle's planes.  More
    than MAX_REFS references no longer raise NotImplementedError: such a
    picture goes to pipeline.reconstruct (tests/test_torch_many_refs.py),
    and one whose references are neither in the decoder's DPB nor
    attached to the program raises RuntimeError naming the first missing
    POC instead of reading gray.  The CCP and RDPCM flags that raised
    before they were ported now latch the program variant and decode:
    here flags with no effect (a CCP scale on a luma TU, RDPCM on a
    transformed TU), so the planes stay the oracle's."""
    _, progs = programs(gop_bytes("p-sao"))
    p = progs[1]
    fd = FusedDecoder(device="cpu")
    with pytest.raises(RuntimeError, match="reference POC 1 "):
        fd.decode(dataclasses.replace(p, ref_pocs=list(range(9))))
    got = fd.decode(dataclasses.replace(progs[0], ip=None))
    assert fd.packer.numpy_packs == 1
    for c in range(3):
        np.testing.assert_array_equal(got[c].numpy(), progs[0].planes[c])
    k = np.nonzero((p.tus["cidx"] == 0) & (
        p.tus["flags"] & (TU_TRANSFORM_SKIP | TU_TQ_BYPASS) == 0))[0][0]
    for field, value, latch in (("cross_comp_scale", 1, "has_ccp"),
                                ("flags", TU_RDPCM, "has_rdpcm")):
        tus = p.tus.copy()
        tus[field][k] |= value
        fd = FusedDecoder(device="cpu")
        got = fd.decode(dataclasses.replace(p, tus=tus))
        assert getattr(fd.packer, latch)
        for c in range(3):
            np.testing.assert_array_equal(got[c].numpy(), p.planes[c])


# ---------------------------------------------------------------------------
# the production formulation (use_pallas_mc)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _luma_stream(w, h, n, intra_period):
    """The streams of tests/test_fused_store.py (64x48, 5 pictures, intra
    period 3) and tests/test_fused_config_smoke.py (32x32, 2 pictures,
    intra period 4): moving luma ramps, gray chroma."""
    yy, xx = np.mgrid[0:h, 0:w]
    enc = Encoder(qp=30 if w == 64 else 34, ctb_size=32)
    enc.set_parameter("intra-period", intra_period)
    data = b""
    for t in range(n):
        if w == 64:
            y = (xx * 3 + yy * 2 + 11 * t) % 220 + 10
        else:
            y = (xx * 5 + yy * 3 + 17 * t) % 200 + 20
        data += enc.encode(y.astype(np.uint8), pts=t)
    return data + enc.finish()


STREAMS = {"fused-store": lambda: _luma_stream(64, 48, 5, 3),
           "config-smoke": lambda: _luma_stream(32, 32, 2, 4),
           "long-p": lambda: _luma_stream(32, 32, 2 * MAX_REFS + 5, 64),
           "b-weighted": lambda: gop(**{"intra-period": 8, "b-slices": True,
                                        "weighted-pred": True,
                                        "num-refs": 2})}
STREAMS.update({k: functools.partial(gop_bytes, k) for k in GOPS})


def _production(device="cpu"):
    fd = FusedDecoder(device=device)
    fd.use_pallas_mc = True
    return fd


@pytest.mark.parametrize("stream", list(STREAMS))
def test_fused_decoder_production_bit_exact(native_build, stream):
    _, progs = programs(STREAMS[stream]())
    fd = _production()
    fd.plan_stream(progs)
    _assert_planes([fd.decode(p) for p in progs], progs)
    assert fd._stack is not None and not fd.dpb


@pytest.mark.parametrize("stream", ["tiles", "b-tmvp", "b-weighted"])
def test_production_watermark_growth(native_build, stream):
    """Without plan_stream the production feed's capacities (segments per
    band, residual band words) grow mid-stream, and list 1 joins late."""
    _, progs = programs(STREAMS[stream]())
    fd = _production()
    _assert_planes([fd.decode(p) for p in progs], progs)


def test_production_frame_program_matches_jax(native_build):
    """The JAX production program (_compiled_store, Pallas kernels in
    interpret mode) on the fused-store stream, each picture's inputs
    captured: the port's _compiled_impl gives its planes and its ring."""
    _, progs = programs(STREAMS["fused-store"]())
    calls = []
    orig = jfd._compiled_store

    def probe(refs_y, refs_cb, refs_cr, buf, sft, st, layout):
        args = [np.array(a) for a in (refs_y, refs_cb, refs_cr, buf)]
        out = orig(refs_y, refs_cb, refs_cr, buf, sft, st, layout)
        calls.append((args, sft, st, layout, [np.asarray(o) for o in out]))
        return out

    jfd._compiled_store = probe
    try:
        jd = jfd.FusedDecoder()
        jd.use_pallas_mc = True
        jd.plan_stream(progs)
        for p in progs:
            jd.decode(p)
    finally:
        jfd._compiled_store = orig
    assert len(calls) == len(progs)
    assert any(len(p.pus) for p in progs)
    for i, (args, sft, st, layout, want) in enumerate(calls):
        std = dict(st)
        assert std["pallas_mc"] and std["fuse_store"] and std["g4_half"]
        assert sft is None
        got = tfd._compiled_impl(*map(torch.from_numpy, args), None, st,
                                 layout, n_intra=len(progs[i].intras))
        assert len(got) == len(want) == 6
        for c in range(6):
            np.testing.assert_array_equal(got[c].numpy(), want[c],
                                          err_msg=f"picture {i} output {c}")
        for c in range(3):
            np.testing.assert_array_equal(got[c].numpy(), progs[i].planes[c])


def test_production_sparse_upload(native_build, monkeypatch):
    """With small upload blocks the feed crosses sparse (kernel B1's plain
    version rebuilds it) and the pictures stay bit-exact."""
    monkeypatch.setattr(tfd, "SPARSE_BLOCK", 16)
    monkeypatch.setattr(tfd, "SPARSE_ROUND", 4)
    _, progs = programs(gop_bytes("b-tmvp"))
    fd = _production()
    fd.plan_stream(progs)
    sparse = 0
    for p in progs:
        planes = fd.decode(p)
        for c in range(3):
            np.testing.assert_array_equal(planes[c].numpy(), p.planes[c])
        layout, buf, _, _ = fd.packer.pack(
            p, {}, np.zeros(3, np.int32), pallas_mc=True)
        sparse += fd.last_wire_bytes < buf.size * 4
    assert sparse == len(progs)


def test_production_pipelined_decoder(native_build):
    """PipelinedDecoder drives the ring decoder, parse overlapped."""
    data = gop_bytes("b-tmvp")
    _, progs = programs(data)
    pd = PipelinedDecoder(device="cpu")
    pd.fd.use_pallas_mc = True
    _assert_planes(pd.decode_stream(data), progs)


def test_production_is_the_card_default():
    """Constructing a decoder allocates nothing, so this needs no card."""
    assert FusedDecoder().use_pallas_mc
    assert PipelinedDecoder().fd.use_pallas_mc
    assert not FusedDecoder(device="cpu").use_pallas_mc


def test_ring_lru_slots():
    """2*MAX_REFS slots by LRU; a touched POC keeps its slot; the gray slot
    2*MAX_REFS is never handed out."""
    fd = _production()
    slots = [fd._alloc_slot(poc) for poc in range(2 * MAX_REFS)]
    assert slots == list(range(2 * MAX_REFS))
    assert fd._alloc_slot(3) == 3                 # touch POC 3
    s_new = fd._alloc_slot(100)                   # evicts POC 0 (oldest)
    assert s_new == 0 and 0 not in fd._slot_of
    s_next = fd._alloc_slot(101)                  # then POC 1, not POC 3
    assert s_next == 1 and 3 in fd._slot_of
    assert max(fd._slot_of.values()) < 2 * MAX_REFS
    assert len(set(fd._slot_of.values())) == len(fd._slot_of) == 2 * MAX_REFS


def test_ring_eviction_long_stream(native_build):
    """More than 2*MAX_REFS pictures through the ring: every picture
    bit-exact, the ring's slots stay distinct and hold the newest POCs."""
    _, progs = programs(STREAMS["long-p"]())
    assert len(progs) > 2 * MAX_REFS
    fd = _production()
    _assert_planes([fd.decode(p) for p in progs], progs)
    pocs = [p.poc for p in progs]
    assert sorted(fd._slot_of) == sorted(pocs[-2 * MAX_REFS:])
    assert len(set(fd._slot_of.values())) == 2 * MAX_REFS


def test_production_seek_seeds_the_ring(native_build):
    """A P picture decoded by a fresh production decoder: its references
    are seeded into the ring from the planes the parser attached."""
    _, progs = programs(gop_bytes("p-sao"))
    k = 3
    assert len(progs[k].pus) and progs[k].ref_planes
    fd = _production()
    fd.plan_stream(progs)
    got = fd.decode(progs[k])
    for c in range(3):
        np.testing.assert_array_equal(got[c].numpy(), progs[k].planes[c])
    seeded = set(progs[k].ref_pocs[:MAX_REFS])
    assert seeded and seeded <= set(fd._slot_of)


def _intervals_disjoint(iv):
    iv = sorted(iv)
    return all(a[1] <= b[0] for a, b in zip(iv, iv[1:]))


@pytest.mark.parametrize("stream", ["b-tmvp", "tiles", "weighted", "10bit"])
def test_segments_disjoint(native_build, stream):
    """The MC segments of a band and list, and the residual segments of a
    band and plane, cover disjoint columns on every picture's feed (the
    B3 and B5 kernels write a band's stripe from many CTAs at once)."""
    _, progs = programs(gop_bytes(stream))
    pk = FeedPacker()
    pk.plan_stream(progs, pallas_mc=True)
    n_mc = n_res = 0
    for p in progs:
        n = min(len(p.ref_pocs), MAX_REFS)
        layout, buf, _, _ = pk.pack(p, {i: i for i in range(n)},
                                    np.zeros(3, np.int32), pallas_mc=True)
        feed = {k: buf[o:o + int(np.prod(sh))].reshape(sh)
                for k, o, sh in layout}
        geo = feed["pu"][:, 4]
        for l in (0, 1):
            if f"sg{l}n" not in feed:
                continue
            for band, cnt in enumerate(feed[f"sg{l}n"]):
                words = feed[f"sg{l}i"][band]
                iv = []
                for k in range(cnt):
                    i = (int(words[k >> 1]) >> (16 * (k & 1))) & 0xFFFF
                    x4, w4 = geo[i] & 0x7FF, ((geo[i] >> 22) & 0x1F) + 1
                    iv.append((int(x4), int(x4 + w4)))
                assert _intervals_disjoint(iv), (p.poc, l, band)
                n_mc += len(iv)
        for ch in ("y", "cb", "cr"):
            per_band = {}
            for lg in (2, 3, 4, 5):
                if f"rs{lg}{ch}.n" not in feed:
                    continue
                for band, cnt in enumerate(feed[f"rs{lg}{ch}.n"]):
                    for w in feed[f"rs{lg}{ch}.sw"][band][:cnt]:
                        xs = ((int(w) >> 20) & 0xFFF) * 2
                        per_band.setdefault(band, []).append(
                            (xs, xs + (1 << lg)))
            for band, iv in per_band.items():
                assert _intervals_disjoint(iv), (p.poc, ch, band)
                n_res += len(iv)
    assert n_mc > 0 and n_res > 0
