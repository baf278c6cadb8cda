"""The port's per-op device decoder (libde265_tpu_torch.tpu_decode) against
the JAX package's (libde265_tpu.tpu_decode) and the scalar oracle.

* stages: the JAX module's cell grids, residual bins and cell-grid MC
  equal the pipeline stages that the port's DeviceDecoder runs in their
  place (pipeline._paint_motion_grids, _compute_residuals,
  _motion_compensate) on the same inputs;
* whole decode: DeviceDecoder(device="cpu") equals JAX's DeviceDecoder
  and the oracle on the GOPs of tests/test_tpu_decode.py, the 10-bit and
  tiled GOPs, the parse-only case and the mono_400 corpus stream;
* where the JAX module is at fault (ROADMAP C12-C14) the port is held
  against the oracle: conf_window_104x72 (JAX's chroma deblocking edge
  count, C12), a reference found nowhere (C13: the port raises, a seek
  reads the attached planes) and the stripe stream's pictures with 9-11
  references (C14: JAX raises KeyError);
* on the card: the p-sao GOP decodes as on the CPU, with B8, B9 once and
  B10 three times per picture.
Tolerance 0 throughout.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libde265_tpu
from libde265_tpu import tpu_decode as jtd

import libde265_tpu_torch as lt
from libde265_tpu_torch import pipeline, tpu_decode as ttd
from libde265_tpu_torch.ops import deblock_cuda, sao_cuda

from _torch_common import (OWN_CORPUS, cuda, gop, gop_bytes,  # noqa: F401
                           programs, stripe_stream)

# the five parameter sets of tests/test_tpu_decode.py
PARAMS = {
    "p-sao": {"intra-period": 8, "sao": True},
    "short-gop": {"intra-period": 4},
    "b-tmvp": {"intra-period": 8, "b-slices": True, "tmvp": True},
    "2refs": {"intra-period": 8, "num-refs": 2},
    "weighted": {"intra-period": 8, "weighted-pred": True},
}


@functools.lru_cache(maxsize=None)
def _stream(name):
    if name in PARAMS:
        return gop(**PARAMS[name])
    if name in ("10bit", "tiles"):
        return gop_bytes(name)
    return (OWN_CORPUS / f"{name}.h265").read_bytes()


@functools.lru_cache(maxsize=None)
def _programs(name):
    return programs(_stream(name))[1]


def _mismatch(got, want):
    bad = np.argwhere(got != want)
    return f"{len(bad)} differ, first at {bad[0].tolist()}" if len(bad) \
        else None


def _assert_oracle(outs, progs, what):
    assert len(outs) == len(progs)
    for i, (planes, prog) in enumerate(zip(outs, progs)):
        n = 3 if prog.chroma_width else 1
        assert len(planes) == n, (what, i)
        for c in range(n):
            got = planes[c].cpu().numpy()
            assert got.dtype == np.int32
            err = _mismatch(got, prog.planes[c].astype(np.int32))
            assert err is None, f"{what}: picture {i} plane {c}: {err}"


def _jax_decode(progs):
    jd = jtd.DeviceDecoder()
    return [[np.asarray(p) for p in jd.decode(prog)] for prog in progs]


# ---------------------------------------------------------------------------
# stages: the JAX module's helpers against the pipeline stages that the
# port's DeviceDecoder runs in their place
# ---------------------------------------------------------------------------

def _stage_picture(name, which):
    """The picture of a stage case, found by its content (the native
    encoder does not always give the weighted GOP's picture 1 PUs):
    b-tmvp's first picture with PUs (uni-predicted only) and its first
    with bi-predicted PUs; weighted's first and last pictures with PUs."""
    with_pus = [p for p in _programs(name) if len(p.pus)]
    bi = [p for p in with_pus if (p.pus["pred_flags"] == 3).any()]
    prog = {"P": with_pus[0], "B": bi[0] if bi else None,
            "first": with_pus[0], "last": with_pus[-1]}[which]
    assert prog is not None, (name, which)
    assert bool((prog.pus["pred_flags"] == 3).any()) == (which == "B")
    return prog


STAGE_CASES = [("b-tmvp", "P"), ("b-tmvp", "B"), ("weighted", "first"),
               ("weighted", "last")]
STAGE_IDS = [f"{n}-{w}" for n, w in STAGE_CASES]


@pytest.mark.parametrize("name,which", STAGE_CASES, ids=STAGE_IDS)
def test_motion_grids_equal_jax_cell_grids(native_build, name, which):
    """JAX's _paint_cell_grids (pred flags, MVs, reference POCs of every
    4x4 cell) against pipeline._paint_motion_grids, the deblocking's
    motion input."""
    prog = _stage_picture(name, which)
    cells = jtd._paint_cell_grids(
        prog, {i: i for i in range(len(prog.ref_pocs))})
    pf, mv, rp = pipeline._paint_motion_grids(prog, "cpu")
    h, w = pf.shape
    got = {"pf": pf, "poc0": rp[0], "poc1": rp[1]}
    got.update({f"mv{l}{a}": mv[l][k] for l in (0, 1)
                for k, a in enumerate("xy")})
    for k, g in got.items():
        np.testing.assert_array_equal(g.numpy(), cells[k][:h, :w],
                                      err_msg=k)


@pytest.mark.parametrize("name,which", STAGE_CASES, ids=STAGE_IDS)
def test_residuals_equal_jax_bins(native_build, name, which):
    """JAX's _pack_tu_bins + _residual_bin against
    pipeline._compute_residuals, TU by TU."""
    prog = _stage_picture(name, which)
    jbins, tu_map = jtd._pack_tu_bins(prog)
    want = {lg: np.asarray(jtd._residual_bin(b, lg, prog.bit_depth[0],
                                             False))
            for lg, b in jbins.items()}
    got = pipeline._compute_residuals(prog, "cpu")
    assert sum(len(t) for t, _ in got.values()) == len(tu_map)
    for lg, (tus, res) in got.items():
        for t, r in zip(tus, res.numpy()):
            jlg, row = tu_map[int(t)]
            assert jlg == lg
            np.testing.assert_array_equal(r, want[lg][row],
                                          err_msg=f"TU {t}")


@pytest.mark.parametrize("name,which", STAGE_CASES, ids=STAGE_IDS)
def test_motion_compensation_equals_jax_mc_kernel(native_build, name,
                                                  which):
    """JAX's _mc_kernel (the cell-grid MC, with _weight_grids) against
    pipeline._motion_compensate on the same references (the oracle's
    planes): equal at every inter sample, the pipeline's planes zero
    elsewhere."""
    prog = _stage_picture(name, which)
    n_ref = len(prog.ref_pocs)
    cells = jtd._paint_cell_grids(prog, {i: i for i in range(n_ref)})
    wg = jtd._weight_grids(prog, cells)
    keys = [k for k in cells if k.startswith(("mv", "slot", "pf"))]
    want = jtd._mc_kernel(
        *(jnp.asarray(np.stack([prog.ref_planes[i][c].astype(np.int32)
                                for i in range(n_ref)])) for c in range(3)),
        {k: jnp.asarray(cells[k].reshape(-1)) for k in keys},
        {k: jnp.asarray(v.reshape(-1)) for k, v in wg.items()},
        H=prog.height, W=prog.width, sub_x=2, sub_y=2,
        bd=prog.bit_depth[0], bdc=prog.bit_depth[1],
        use_l1=bool((cells["pf"] & 2).any()))
    planes = pipeline._zero_planes(prog, "cpu")
    pipeline._motion_compensate(prog, planes)
    inter = np.asarray(want[3])
    for c, (got, w) in enumerate(zip(planes, want[:3])):
        r = 4 if c == 0 else 2
        m = inter.repeat(r, 0).repeat(r, 1)[:got.shape[0], :got.shape[1]]
        assert m.any()
        np.testing.assert_array_equal(
            got.numpy(), np.where(m, np.asarray(w), 0), err_msg=f"plane {c}")


# ---------------------------------------------------------------------------
# whole decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(PARAMS) + ["10bit", "tiles"])
def test_decode_equals_jax_and_oracle(native_build, name):
    progs = _programs(name)
    dd = ttd.DeviceDecoder(device="cpu")
    outs = [dd.decode(p) for p in progs]
    _assert_oracle(outs, progs, name)
    for i, (got, want) in enumerate(zip(outs, _jax_decode(progs))):
        for c in range(3):
            np.testing.assert_array_equal(got[c].numpy(), want[c],
                                          err_msg=f"{name} {i} {c}")
    assert dd.pipeline_pictures == 0
    assert set(dd.dpb) == {p.poc for p in progs}


def test_parse_only_decode(native_build):
    """test_parse_only_device_decode of the JAX package: parse-only
    programs (no planes of their own, no reference planes) through the
    port equal the full scalar decode."""
    data = _stream("p-sao")
    oracle = _programs("p-sao")
    dp = lt.Decoder(parse_only=True)
    list(dp.decode_all(data))
    assert dp.num_programs() == len(oracle)
    assert dp.get_program(0).planes[0] is None
    dd = ttd.DeviceDecoder(device="cpu")
    outs = [dd.decode(dp.get_program(i)) for i in range(dp.num_programs())]
    _assert_oracle(outs, oracle, "parse-only")


def test_mono_400(native_build):
    """4:0:0: one plane in and out, as in JAX (which passes luma three
    times to its filter kernel)."""
    progs = _programs("mono_400")
    assert progs[0].chroma_width == 0 and any(len(p.pus) for p in progs)
    dd = ttd.DeviceDecoder(device="cpu")
    outs = [dd.decode(p) for p in progs]
    _assert_oracle(outs, progs, "mono_400")
    for got, want in zip(outs, _jax_decode(progs)):
        assert len(want) == 1
        np.testing.assert_array_equal(got[0].numpy(), want[0])


def test_conf_window_chroma_edges(native_build):
    """C12: 104x72 (52x36 chroma).  The port counts (Wc + 7) // 8 chroma
    edges (frame_helpers.deblock_planes) and equals the oracle; the JAX
    module counts Wc // 8 and leaves the edge at x = 48 unfiltered, so its
    Cb and Cr differ while luma stays exact."""
    progs = _programs("conf_window_104x72")
    assert progs[0].chroma_width == 52
    dd = ttd.DeviceDecoder(device="cpu")
    _assert_oracle([dd.decode(p) for p in progs], progs, "104x72")
    jax_out = _jax_decode(progs[:1])[0]
    np.testing.assert_array_equal(jax_out[0], progs[0].planes[0])
    for c in (1, 2):
        assert _mismatch(jax_out[c], progs[0].planes[c]) is not None, c


def test_missing_reference_raises(native_build):
    """C13: a parse-only P picture whose reference the decoder never
    decoded raises RuntimeError naming the POC (JAX decodes it against
    mid-gray planes)."""
    dp = lt.Decoder(parse_only=True)
    list(dp.decode_all(_stream("p-sao")))
    prog = dp.get_program(1)
    dd = ttd.DeviceDecoder(device="cpu")
    with pytest.raises(RuntimeError,
                       match=f"reference POC {prog.ref_pocs[0]} "):
        dd.decode(prog)
    assert prog.poc not in dd.dpb
    gray = [np.asarray(q) for q in jtd.DeviceDecoder().decode(prog)]
    assert _mismatch(gray[0], _programs("p-sao")[1].planes[0]) is not None


def test_seek_reads_attached_planes(native_build):
    """C13: a fresh decoder starting at picture 3 of a full decode reads its
    references from the planes the parser attached, and every picture
    from there on equals the oracle."""
    progs = _programs("2refs")
    dd = ttd.DeviceDecoder(device="cpu")
    assert progs[3].ref_pocs and progs[3].ref_pocs[0] != progs[3].poc
    _assert_oracle([dd.decode(p) for p in progs[3:]], progs[3:], "seek")


@functools.lru_cache(maxsize=None)
def _stripe_programs(mod):
    dec = mod.Decoder(keep_programs=True, parse_only=True)
    list(dec.decode_all(stripe_stream()))
    return [dec.get_program(i) for i in range(dec.num_programs())]


def test_many_references(native_build):
    """C14: the stripe stream under parse_only: pictures 9-11 read 9-11
    references and go to pipeline.reconstruct with the references from the
    decoder's own DPB, every picture bit-exact; JAX's DeviceDecoder stacks
    the first 8 and raises KeyError at picture 9's PU table."""
    progs = _stripe_programs(lt)
    dd = ttd.DeviceDecoder(device="cpu")
    outs = [dd.decode(p) for p in progs]
    _assert_oracle(outs, programs(stripe_stream())[1], "stripes")
    assert dd.pipeline_pictures == 3
    jd = jtd.DeviceDecoder()
    for p in _stripe_programs(libde265_tpu)[:9]:
        jd.decode(p)
    with pytest.raises(KeyError):
        jd.decode(_stripe_programs(libde265_tpu)[9])


def test_routed_pictures_read_the_dpb(native_build):
    """A picture with CCP flags, which the JAX module sends to its
    pipeline, reads its reference from the decoder's DPB and is counted in
    pipeline_pictures: flags with no effect (a CCP scale on a luma TU)
    keep the oracle's planes."""
    progs = _programs("p-sao")
    dd = ttd.DeviceDecoder(device="cpu")
    dd.decode(progs[0])
    p = progs[1]
    tus = p.tus.copy()
    tus["cross_comp_scale"][np.nonzero(tus["cidx"] == 0)[0][0]] = 1
    out = dd.decode(dataclasses.replace(p, tus=tus, ref_planes=[]))
    assert dd.pipeline_pictures == 1
    _assert_oracle([out], [p], "routed")


def test_loop_filter_flags(native_build):
    """run_deblock / run_sao off: equal to JAX's decoder with the same
    flags."""
    progs = _programs("p-sao")[:2]
    dd = ttd.DeviceDecoder(device="cpu", run_deblock=False, run_sao=False)
    jd = jtd.DeviceDecoder(run_deblock=False, run_sao=False)
    for p in progs:
        got, want = dd.decode(p), jd.decode(p)
        for c in range(3):
            np.testing.assert_array_equal(got[c].numpy(), np.asarray(want[c]))
        assert any(not np.array_equal(g.numpy(), o)
                   for g, o in zip(got, p.planes))


@pytest.mark.gpu
def test_card_equals_cpu(cuda, native_build):  # noqa: F811
    """DeviceDecoder() on the card: the p-sao GOP as on the CPU and the
    oracle, with B8, B9 once and B10 three times per picture."""
    progs = _programs("p-sao")
    dd = ttd.DeviceDecoder()
    assert dd.device.type == "cuda"
    outs = []
    for p in progs:
        deblock_cuda.luma_launches = deblock_cuda.chroma_launches = 0
        sao_cuda.launches = 0
        outs.append(dd.decode(p))
        torch.cuda.synchronize()
        assert all(q.is_cuda for q in outs[-1])
        assert (deblock_cuda.luma_launches, deblock_cuda.chroma_launches,
                sao_cuda.launches) == (1, 1, 3)
    _assert_oracle(outs, progs, "card")
    cpu = ttd.DeviceDecoder(device="cpu")
    for got, p in zip(outs, progs):
        for a, b in zip(got, cpu.decode(p)):
            assert torch.equal(a.cpu(), b)
