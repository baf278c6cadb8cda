"""The port's per-op picture pipeline (libde265_tpu_torch.pipeline and the
op functions it runs) against the JAX package's, bit for bit.

Inputs: the port's test GOPs (_torch_common.GOPS), a 4:2:2 P-GOP made as
tests/test_pipeline_chroma_formats.py makes it, the two 4:4:4 CCP streams
of tests/test_torch_ccp_rdpcm.py, and corpus streams for what the encoder
settings of those do not reach: 4:0:0, 4:2:2, 4:4:4 at 10 bits, PCM,
lossless, Main10 scaling lists, chroma QP offsets (10-bit 4:2:0 is the
GOP "10bit").  Every function
is held against its JAX counterpart on the same inputs (JAX on the CPU;
its only Pallas kernel on this path, SAO, runs as XLA there), and whole
pictures against the scalar oracle (prog.planes).  Tolerance 0.

The two exceptions, where the port equals the oracle and the JAX module
does not (ROADMAP C): the chroma deblocking edge count on the 104x72
corpus stream (C1), and reconstruct_stream on 10-bit samples, which the
JAX module casts to uint8 (C7).  The gpu tests run reconstruct on the
card against the CPU and count the B8, B9 and B10 launches.
"""
import functools

import numpy as np
import pytest
import torch

from libde265_tpu import pipeline as J
from libde265_tpu.ops import deblock as jdbk
from libde265_tpu.ops import intra_wave as jiw
from libde265_tpu.ops import mc as jmc
from libde265_tpu.ops import sao as jsao
from libde265_tpu.ops import transform as jtx

from libde265_tpu_torch import frame_helpers as fh
from libde265_tpu_torch import pipeline as P
from libde265_tpu_torch.ops import deblock as dbk
from libde265_tpu_torch.ops import deblock_cuda, intra_wave, mc, sao, sao_cuda
from libde265_tpu_torch.ops import transform as tx

from _torch_common import cuda  # noqa: F401
from _torch_common import GOPS, OWN_CORPUS, gop, gop_bytes, programs, t32
from test_pipeline_chroma_formats import _gop_stream
from test_torch_ccp_rdpcm import ccp_stream

CORPUS = ("mono_400", "chroma422", "main10_444", "pcm", "lossless",
          "main10_422_scaling", "chroma_qp_offsets")
STREAMS = list(GOPS) + ["422-gop", "ccp-lossy", "ccp-lossless"] + \
    list(CORPUS)


@functools.lru_cache(maxsize=None)
def stream_programs(name):
    """Programs of a full decode (the oracle's planes attached)."""
    if name in GOPS:
        data = gop_bytes(name)
    elif name == "422-gop":
        data = _gop_stream("422", 2, 1)
    elif name.startswith("ccp-"):
        data = ccp_stream(name[4:])
    else:
        data = (OWN_CORPUS / f"{name}.h265").read_bytes()
    return programs(data)[1]


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _eq(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not np.array_equal(got.astype(np.int64), want.astype(np.int64)):
        bad = np.argwhere(got != want)
        raise AssertionError(f"{what}: {len(bad)} differ, first at "
                             f"{bad[0].tolist()}: {got[tuple(bad[0])]} vs "
                             f"{want[tuple(bad[0])]}")


def _planes_eq(got, want, prog, what):
    for c in range(3 if prog.chroma_width else 1):
        _eq(got[c], want[c], f"{what} plane {c}")


def _as_dict(residuals):
    """The port's size bins as the JAX module's {TU index: block}."""
    return {int(t): r for idx, res in residuals.values()
            for t, r in zip(idx, _np(res))}


# ---------------------------------------------------------------------------
# op functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["p-sao", "main10_422_scaling", "lossless"])
def test_scatter_coeffs_matches_jax(native_build, name):
    for prog in stream_programs(name)[:3]:
        tus = prog.tus
        for lg in (2, 3, 4, 5):
            sel = np.nonzero(tus["log2_size"] == lg)[0]
            _eq(tx.scatter_coeffs(tus, prog.coeff_val, prog.coeff_pos, lg,
                                  sel, "cpu"),
                jtx.scatter_coeffs(tus, prog.coeff_val, prog.coeff_pos, lg,
                                   sel), f"{name} lg {lg}")


@pytest.mark.parametrize("bit_depth", [8, 10])
def test_mc_ops_match_jax(bit_depth):
    """gather_windows (coordinates far outside the plane too), the luma and
    chroma interpolation of every fraction pair, on seeded samples."""
    rng = np.random.default_rng(bit_depth)
    plane = rng.integers(0, 1 << bit_depth, (40, 56)).astype(np.int32)
    for taps, center, w, h, nf in ((8, 3, 8, 4, 4), (4, 1, 4, 8, 8)):
        xs = rng.integers(-30, 80, 64)
        ys = rng.integers(-30, 60, 64)
        want = np.stack([jmc.gather_windows(plane, [x], [y], w, h, taps,
                                            center)[0]
                         for x, y in zip(xs, ys)])
        win = mc.gather_windows(t32(plane), xs, ys, w, h, taps, center)
        _eq(win, want, "gather_windows")
        # the same windows from a stack of three planes, picked per window
        stack = np.stack([plane + 1, plane, plane - 1])
        slot = rng.integers(0, 3, 64)
        _eq(mc.gather_windows(t32(stack), xs, ys, w, h, taps, center,
                              t32(slot)), want + 1 - slot[:, None, None],
            "gather_windows (stack)")
        fx, fy = np.meshgrid(np.arange(nf), np.arange(nf))
        fx = np.resize(fx.ravel(), 64).astype(np.int32)
        fy = np.resize(fy.ravel(), 64).astype(np.int32)
        jf = jmc.mc_luma_batch if taps == 8 else jmc.mc_chroma_batch
        pf = mc.mc_luma_batch if taps == 8 else mc.mc_chroma_batch
        _eq(pf(win, t32(fx), t32(fy), w, h, bit_depth),
            jf(want, fx, fy, w, h, bit_depth), f"{taps}-tap filter")


@pytest.mark.parametrize("bit_depth", [8, 10, 12])
def test_pred_merge_batch_matches_jax(bit_depth):
    """Default and explicit weighted merge, uni and bi, with full-range
    int16-scaled predictions, weights, offsets and denominators; the
    picture program's _merge is the same function."""
    rng = np.random.default_rng(100 + bit_depth)
    N = 512
    p0 = rng.integers(-(1 << 15), 1 << 15, (N, 4, 8)).astype(np.int32)
    p1 = rng.integers(-(1 << 15), 1 << 15, (N, 4, 8)).astype(np.int32)
    bi = rng.random(N) < 0.5
    weighted = rng.random(N) < 0.7
    sc = 1 << (bit_depth - 8)
    w0, w1 = (rng.integers(-128, 128, N).astype(np.int32) for _ in range(2))
    o0, o1 = ((rng.integers(-128, 128, N) * sc).astype(np.int32)
              for _ in range(2))
    denom = rng.integers(0, 8, N).astype(np.int32)
    args = (p0, p1, bi, weighted, w0, o0, w1, o1, denom)
    want = jmc.pred_merge_batch(*args, bit_depth=bit_depth)
    got = mc.pred_merge_batch(*(t32(a) for a in args), bit_depth)
    _eq(got, want, "pred_merge_batch")
    assert fh._merge is mc.pred_merge_batch


def _random_meta(rng, h4, w4, bd):
    g = lambda hi: rng.integers(0, hi, (h4, w4))  # noqa: E731
    mv = [[rng.integers(-9, 10, (h4, w4)) for _ in range(2)]
          for _ in range(2)]
    rp = [np.where(g(4) == 0, -10 ** 6, g(3)).astype(np.int64)
          for _ in range(2)]
    return {"intra": g(8) == 0, "nzc": g(2), "tu_edge_v": g(2) == 1,
            "tu_edge_h": g(2) == 1, "pu_edge_v": g(3) == 1,
            "pu_edge_h": g(3) == 1, "qp": g(52), "pf": g(4), "mv": mv,
            "rp": rp, "bit_depth": bd, "beta_off": rng.integers(-6, 7,
                                                                (h4, w4)),
            "tc_off": rng.integers(-6, 7, (h4, w4)), "unfilt": g(5) == 0,
            "allow_v": g(6) != 0, "allow_h": g(6) != 0}


def _meta_t(meta):
    out = {}
    for k, v in meta.items():
        if k in ("mv", "rp"):
            out[k] = [[torch.from_numpy(np.asarray(a)) for a in x]
                      if isinstance(x, list) else torch.from_numpy(x)
                      for x in v]
        elif isinstance(v, np.ndarray):
            out[k] = torch.from_numpy(v.astype(np.int32))
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("shape,bd", [((24, 26), 8), ((18, 33), 10),
                                      ((5, 7), 8)])
def test_derive_edge_params_matches_jax(shape, bd):
    """Seeded per-4x4 grids (even and odd cell counts); scalar offsets
    too."""
    rng = np.random.default_rng(shape[0] * 100 + bd)
    meta = _random_meta(rng, *shape, bd)
    for vertical in (True, False):
        want = jdbk.derive_edge_params(meta, vertical)
        got = dbk.derive_edge_params(_meta_t(meta), vertical)
        assert set(got) == set(want)
        for k in want:
            _eq(got[k], want[k], f"{k} vertical={vertical}")
    meta.update(beta_off=3, tc_off=-2)
    for vertical in (True, False):
        want = jdbk.derive_edge_params(meta, vertical)
        got = dbk.derive_edge_params(_meta_t(meta), vertical)
        for k in want:
            _eq(got[k], want[k], f"{k} scalar offsets")


@pytest.mark.parametrize("bd", [8, 10])
def test_deblock_plane_passes_match_jax(bd):
    """luma_vertical / luma_horizontal / chroma_vertical /
    chroma_horizontal on blocky seeded planes with seeded parameters."""
    rng = np.random.default_rng(bd)
    H, W = 48, 64
    img = (rng.integers(0, 4, (H // 4, W // 4)).repeat(4, 0).repeat(4, 1)
           * (12 << (bd - 8)) + rng.integers(0, 3, (H, W))).astype(np.int32)

    def params(S, E):
        return {"bs": rng.integers(0, 3, (S, E)).astype(np.int32),
                "beta": (rng.integers(0, 64, (S, E)) << (bd - 8)).astype(
                    np.int32),
                "tc": (rng.integers(0, 24, (S, E)) << (bd - 8)).astype(
                    np.int32),
                "no_p": (rng.integers(0, 6, (S, E)) == 0).astype(np.int32),
                "no_q": (rng.integers(0, 6, (S, E)) == 0).astype(np.int32)}

    keys = ("bs", "beta", "tc", "no_p", "no_q")
    for fn, jfn, S, E, src in (
            (dbk.luma_vertical, jdbk.luma_vertical, H // 4, W // 8, img),
            (dbk.luma_horizontal, jdbk.luma_horizontal, W // 4, H // 8,
             img)):
        p = params(S, E)
        _eq(fn(t32(src), [t32(p[k]) for k in keys], bd),
            jfn(src, p, bd), fn.__name__)
    cimg = img[:24, :32]
    for fn, jfn, S, E, rps in (
            (dbk.chroma_vertical, jdbk.chroma_vertical, 12, 4, 2),
            (dbk.chroma_horizontal, jdbk.chroma_horizontal, 8, 3, 4)):
        p = params(S, E)
        tc = np.where(p["bs"] == 2, p["tc"], 0)
        _eq(fn(t32(cimg), t32(tc), t32(p["no_p"]), t32(p["no_q"]), bd, rps),
            jfn(cimg, tc, p["no_p"], p["no_q"], bd, rps), fn.__name__)


@pytest.mark.parametrize("name", ["tiles", "p-sao", "422-gop"])
def test_sao_maps_match_jax(native_build, name):
    """upsample_ctb_params and edge_boundary_ok on every plane of the
    stream's pictures (4 slices and 2x2 tiles, not across, in "tiles")."""
    for prog in stream_programs(name)[:3]:
        recs = prog.slice_records
        sidx = np.clip(prog.slice_idx, 0, len(recs) - 1)
        across = recs[sidx, 9] != 0
        sx, sy = P._subsampling(prog)
        for c in range(3 if prog.chroma_width else 1):
            H = prog.height if c == 0 else prog.chroma_height
            W = prog.width if c == 0 else prog.chroma_width
            cs = (prog.ctb_size, prog.ctb_size) if c == 0 else \
                (prog.ctb_size // sy, prog.ctb_size // sx)
            want = jsao.upsample_ctb_params(prog.sao, c, prog.ctb_w,
                                            prog.ctb_h, cs, H, W)
            got = sao.upsample_ctb_params(prog.sao, c, prog.ctb_w,
                                          prog.ctb_h, cs, H, W, "cpu")
            for g, w in zip(got, want):
                _eq(g, w, f"{name} upsample plane {c}")
            for across_tiles in (False, True):
                _eq(sao.edge_boundary_ok(got[1], prog.slice_addr, across,
                                         prog.tile_id, across_tiles, cs, H,
                                         W),
                    jsao.edge_boundary_ok(want[1], prog.slice_addr, across,
                                          prog.tile_id, across_tiles, cs, H,
                                          W), f"{name} edge_ok plane {c}")


@pytest.mark.parametrize("name", ["all-intra", "p-sao", "main10_444",
                                  "422-gop"])
def test_intra_wave_matches_jax(native_build, name):
    """plan_blocks (border_plan inside) and intra_wave_kernel, batch by
    batch on the same planes, against the JAX wavefront."""
    for prog in stream_programs(name)[:2]:
        res = P._compute_residuals(prog, "cpu")
        ctx = P._intra_context(prog)
        got = intra_wave.plan_blocks(prog, ctx, res)
        want = jiw.plan_blocks(prog, ctx, _as_dict(res))
        assert list(got) == list(want)
        rng = np.random.default_rng(len(got))
        planes = [rng.integers(0, 1 << prog.bit_depth[0], p.shape).astype(
            np.int32) for p in prog.planes]
        tplanes = [t32(p) for p in planes]
        for key, b in want.items():
            g = got[key]
            assert set(g) == set(b)
            for k in b:
                _eq(g[k], b[k], f"{name} {key} {k}")
            c, s = key[1], 1 << key[2]
            tabs = jiw.build_mode_tables(s)
            args = [b[k] for k in ("pos", "subst", "unavail", "filt",
                                   "strong", "mode", "edge", "resid", "y0",
                                   "x0", "valid")]
            planes[c] = np.asarray(jiw.intra_wave_kernel(
                planes[c], *args, *tabs, s=s, bit_depth=prog.bit_depth[c]))
            targs = [g[k] for k in ("pos", "subst", "unavail", "filt",
                                    "strong", "mode", "edge", "resid", "y0",
                                    "x0", "valid")]
            tplanes[c] = intra_wave.intra_wave_kernel(
                tplanes[c], *targs, *(t32(t) for t in tabs), s=s,
                bit_depth=prog.bit_depth[c])
            _eq(tplanes[c], planes[c], f"{name} {key} plane")


# ---------------------------------------------------------------------------
# pipeline stages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", STREAMS)
def test_pipeline_stages_match_jax(native_build, name):
    """_compute_residuals + _apply_ccp, _motion_compensate, _apply_pcm,
    _skip_filter_map4, _paint_motion_grids, _deblock and _apply_sao, each
    on the same inputs as the JAX function (the deblocking on the JAX
    pipeline's planes before its loop filters, SAO on them after its
    deblocking)."""
    for i, prog in enumerate(stream_programs(name)):
        what = f"{name} picture {i}"
        want = J._compute_residuals(prog)
        J._apply_ccp(prog, want)
        res = P._compute_residuals(prog, "cpu")
        P._apply_ccp(prog, res)
        got = _as_dict(res)
        assert set(got) == set(want), what
        for t in want:
            _eq(got[t], want[t], f"{what} TU {t}")

        for fn, jfn in ((P._motion_compensate, J._motion_compensate),
                        (P._apply_pcm, J._apply_pcm)):
            jp = [np.zeros((prog.height, prog.width), np.int32)] + \
                [np.zeros((prog.chroma_height, prog.chroma_width), np.int32)
                 for _ in range(2)]
            tp = [t32(p) for p in jp]
            jfn(prog, jp)
            fn(prog, tp)
            _planes_eq(tp, jp, prog, f"{what} {fn.__name__}")

        _eq(P._skip_filter_map4(prog), J._skip_filter_map4(prog), what)
        pf, mv, rp = P._paint_motion_grids(prog, "cpu")
        jpf, jmv, jrp = J._paint_motion_grids(prog)
        _eq(pf, jpf, f"{what} pf")
        for l in range(2):
            _eq(rp[l], jrp[l], f"{what} rp{l}")
            for c in range(2):
                _eq(mv[l][c], jmv[l][c], f"{what} mv{l}{c}")

        pre = [np.asarray(p, np.int32) for p in
               J.reconstruct(prog, run_deblock=False, run_sao=False)]
        for fn, jfn in ((P._deblock, J._deblock),
                        (P._apply_sao, J._apply_sao)):
            jp = [p.copy() for p in pre]
            tp = [t32(p) for p in pre]
            jfn(prog, jp)
            fn(prog, tp)
            _planes_eq(tp, jp, prog, f"{what} {fn.__name__}")
            pre = [np.asarray(p, np.int32) for p in jp]


@pytest.mark.parametrize("device_intra", [False, True],
                         ids=["host-intra", "device-intra"])
@pytest.mark.parametrize("name", STREAMS)
def test_reconstruct_matches_jax_and_oracle(native_build, name,
                                            device_intra):
    for i, prog in enumerate(stream_programs(name)):
        got = P.reconstruct(prog, device_intra=device_intra, device="cpu")
        assert all(p.dtype == torch.int32 for p in got)
        _planes_eq(got, prog.planes, prog, f"{name} {i} vs oracle")
        _planes_eq(got, J.reconstruct(prog, device_intra=device_intra), prog,
                   f"{name} {i} vs JAX")


def test_conf_window_chroma_edges_repaired(native_build):
    """C1: on the 104x72 corpus stream (52x36 chroma) the port's pipeline
    equals the oracle, and the JAX pipeline's chroma differs, first in
    picture 0's Cb: it drops the last chroma edge column and row
    (pipeline.py:408, :432)."""
    _, progs = programs((OWN_CORPUS / "conf_window_104x72.h265").read_bytes())
    jax_differs = []         # (picture, plane) where JAX's is not the oracle
    for i, prog in enumerate(progs):
        got = P.reconstruct(prog, device="cpu")
        _planes_eq(got, prog.planes, prog, f"104x72 picture {i}")
        want = J.reconstruct(prog)
        _eq(got[0], want[0], f"104x72 picture {i} luma vs JAX")
        jax_differs += [(i, c) for c in (1, 2)
                        if not np.array_equal(want[c], prog.planes[c])]
    assert jax_differs[0] == (0, 1)


def test_reconstruct_stream_8bit(native_build):
    progs = stream_programs("p-sao")
    want = list(J.reconstruct_stream(progs))
    got = list(P.reconstruct_stream(progs, device="cpu"))
    assert [p for p, _ in got] == [p for p, _ in want] == \
        [q.poc for q in progs]
    for prog, (_, g), (_, w) in zip(progs, got, want):
        assert all(p.dtype == torch.uint8 for p in g)
        _planes_eq(g, prog.planes, prog, f"POC {prog.poc} vs oracle")
        _planes_eq(g, w, prog, f"POC {prog.poc} vs JAX")


def test_reconstruct_stream_keeps_10_bits(native_build):
    """C7: a 10-bit GOP (64x48, 3 pictures, intra period 4) as one chain.
    The port's frames and references keep all 10 bits (uint16) and equal
    the oracle; the JAX module casts both to uint8 (pipeline.py:505), so
    its frames differ from the oracle's, first in picture 0's luma."""
    _, progs = programs(gop(w=64, h=48, n=3, bit_depth=10,
                            **{"intra-period": 4}))
    assert max(int(p.planes[0].max()) for p in progs) > 255
    for prog, (poc, planes) in zip(progs, P.reconstruct_stream(
            progs, device="cpu")):
        assert poc == prog.poc
        assert all(p.dtype == torch.uint16 for p in planes)
        _planes_eq(planes, prog.planes, prog, f"POC {poc}")
    jax_differs = [(i, c) for i, (prog, (_, w)) in enumerate(
        zip(progs, J.reconstruct_stream(progs))) for c in range(3)
        if not np.array_equal(w[c], prog.planes[c])]
    assert jax_differs[0] == (0, 0)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("name", ["p-sao", "tiles", "10bit", "b-tmvp",
                                  "main10_444", "mono_400", "422-gop"])
def test_reconstruct_on_card_equals_cpu(cuda, native_build,  # noqa: F811
                                        name):
    """reconstruct on the card (B8, B9, B10 for the loop filters) equals
    reconstruct on the CPU, both intra settings; one B8 and one B9 launch
    and one B10 launch per plane in every picture with deblocking and
    SAO."""
    for prog in stream_programs(name):
        n_pl = 3 if prog.chroma_width else 1
        sao_on = bool(np.any(prog.slice_records[:, 4] |
                             prog.slice_records[:, 5]))
        want = P.reconstruct(prog, device="cpu")
        for device_intra in (False, True):
            deblock_cuda.luma_launches = deblock_cuda.chroma_launches = 0
            sao_cuda.launches = 0
            got = P.reconstruct(prog, device_intra=device_intra,
                                device=cuda)
            assert got[0].is_cuda
            _planes_eq(got, want, prog, f"{name} POC {prog.poc}")
            assert deblock_cuda.luma_launches == 1
            assert deblock_cuda.chroma_launches == (n_pl == 3)
            assert sao_cuda.launches == (n_pl if sao_on else 0)


@pytest.mark.gpu
def test_reconstruct_stream_on_card_keeps_10_bits(cuda,  # noqa: F811
                                                 native_build):
    _, progs = programs(gop(w=64, h=48, n=3, bit_depth=10,
                            **{"intra-period": 4}))
    for prog, (poc, planes) in zip(progs, P.reconstruct_stream(
            progs, device=cuda)):
        assert all(p.is_cuda and p.dtype == torch.uint16 for p in planes)
        _planes_eq([p.cpu() for p in planes], prog.planes, prog,
                   f"POC {poc}")
