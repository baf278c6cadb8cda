"""PyTorch port vs the JAX package on seeded random inputs, integer
equality: dequant + inverse transform, MC interpolation and merge, the
deblocking edge parameters and one intra super-wave step."""
import jax.numpy as jnp
import numpy as np
import pytest

from libde265_tpu import fused_decode as jfd
from libde265_tpu import tpu_decode as jtd
from libde265_tpu.ops import intra_wave as jiw
from libde265_tpu.ops import transform as jtx

from libde265_tpu_torch import frame_helpers as fh
from libde265_tpu_torch.ops import intra_cuda
from libde265_tpu_torch.ops import intra_window as tiw
from libde265_tpu_torch.ops import transform as ttx
from libde265_tpu_torch.ops.mc import EPEL_FILTERS, QPEL_FILTERS

from _torch_common import t32


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("scaling", [False, True], ids=["flat", "lists"])
@pytest.mark.parametrize("lg,bd", [(2, 8), (3, 8), (4, 10), (5, 8), (2, 10)])
def test_residual_batch(lg, bd, scaling):
    rng = np.random.default_rng(100 * lg + bd + scaling)
    s, n = 1 << lg, 37
    levels = rng.integers(-64, 65, (n, s, s))
    levels[rng.random((n, s, s)) < 0.6] = 0
    levels[0, 0, 0] = 32767          # escape-sized levels clip at 16 bits
    levels[1, :2, :2] = -32768
    qp = rng.integers(0, 52 + 6 * (bd - 8), n)
    tskip = rng.random(n) < 0.2
    use_dst = rng.random(n) < 0.5
    kw_j, kw_t = {}, {}
    if scaling:
        sf = rng.integers(1, 256, (n, s, s))
        kw_j = {"sf": jnp.asarray(sf, jnp.int32), "qp": jnp.asarray(qp, jnp.int32)}
        kw_t = {"sf": t32(sf), "qp": t32(qp)}
    want = jtx.residual_batch(
        jnp.asarray(levels, jnp.int32), jtx.qp_to_fact_jnp(jnp.asarray(qp, jnp.int32)),
        jnp.asarray(tskip), jnp.asarray(use_dst), lg, bd, **kw_j)
    got = ttx.residual_batch(t32(levels), ttx.qp_to_fact(t32(qp)),
                             t32(tskip), t32(use_dst), lg, bd, **kw_t)
    _eq(got, want)


def test_wrap16_outside_int16():
    v = np.array([0, 32767, 32768, -32768, -32769, 65535, 70000, -70000,
                  (1 << 30) + 5, -(1 << 30)], np.int64).astype(np.int32)
    _eq(fh._wrap16(t32(v)), jtd._wrap16(jnp.asarray(v)))


@pytest.mark.parametrize("chroma", [False, True], ids=["luma", "chroma"])
@pytest.mark.parametrize("bd,overrange", [(8, False), (10, False),
                                          (10, True)])
def test_mc_plane_and_merge(bd, overrange, chroma):
    """Interpolation with edge clamping, then the weighted / bi merge.
    `overrange` feeds reference samples beyond the bit depth so that the
    int16 intermediates wrap."""
    rng = np.random.default_rng(7 + bd + 2 * overrange + 5 * chroma)
    R, Hp, Wp, N = 3, 24, 40, 96
    hi = 1 << (14 if overrange else bd)
    refs = rng.integers(0, hi, (R, Hp, Wp))
    slot = rng.integers(0, R, N)
    xint = rng.integers(-12, Wp + 12, N)
    yint = rng.integers(-12, Hp + 12, N)
    if chroma:
        filt, taps, bs, nf = EPEL_FILTERS, 4, 2, 8
    else:
        filt, taps, bs, nf = QPEL_FILTERS, 8, 4, 4
    fx, fy = rng.integers(0, nf, N), rng.integers(0, nf, N)
    preds_t, preds_j = [], []
    for _ in range(2):
        args = (slot, xint, yint, fx, fy)
        preds_j.append(jtd._mc_plane(jnp.asarray(refs, jnp.int32),
                                     *(jnp.asarray(a, jnp.int32) for a in args),
                                     jnp.asarray(filt), taps, bs, bd))
        preds_t.append(fh._mc_plane(t32(refs), *(t32(a) for a in args),
                                    t32(filt), taps, bs, bd))
        _eq(preds_t[-1], preds_j[-1])
        slot, xint, yint = (rng.permutation(a) for a in (slot, xint, yint))

    bi = rng.random(N) < 0.5
    weighted = (rng.random(N) < 0.5).astype(np.int32)
    w0, w1 = rng.integers(-128, 128, N), rng.integers(-128, 128, N)
    o0 = rng.integers(-128, 128, N) << (bd - 8)
    o1 = rng.integers(-128, 128, N) << (bd - 8)
    denom = rng.integers(0, 8, N)
    margs = (bi, weighted, w0, o0, w1, o1, denom)
    want = jtd._merge(preds_j[0], preds_j[1],
                      *(jnp.asarray(a) if a.dtype == bool
                        else jnp.asarray(a, jnp.int32) for a in margs), bd)
    got = fh._merge(preds_t[0], preds_t[1], *(t32(a) for a in margs), bd)
    _eq(got, want)


def _rand_meta(rng, h4, w4):
    g = lambda hi: rng.integers(0, hi, (h4, w4))  # noqa: E731
    return {
        "intra": g(2) * (rng.random((h4, w4)) < 0.3), "nzc": g(2),
        "tu_edge_v": g(2), "tu_edge_h": g(2), "pu_edge_v": g(2),
        "pu_edge_h": g(2), "qp": rng.integers(0, 52, (h4, w4)),
        "pf": g(4),
        "mv": [[rng.integers(-9, 10, (h4, w4)) for _ in range(2)]
               for _ in range(2)],
        "rp": [rng.integers(0, 3, (h4, w4)) for _ in range(2)],
        "beta_off": rng.integers(-6, 7, (h4, w4)) * 2,
        "tc_off": rng.integers(-6, 7, (h4, w4)) * 2,
        "cqo0": rng.integers(-4, 5, (h4, w4)),
        "cqo1": rng.integers(-4, 5, (h4, w4)),
        "unfilt": (rng.random((h4, w4)) < 0.1).astype(np.int32),
        "allow_v": (rng.random((h4, w4)) < 0.9).astype(np.int32),
        "allow_h": (rng.random((h4, w4)) < 0.9).astype(np.int32),
    }


def _conv(meta, f):
    out = {}
    for k, v in meta.items():
        if k in ("mv", "rp"):
            out[k] = [[f(a) for a in x] if isinstance(x, list) else f(x)
                      for x in v]
        else:
            out[k] = f(v)
    return out


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("vertical", [True, False], ids=["v", "h"])
def test_edge_params(vertical, bd):
    rng = np.random.default_rng(31 + vertical + bd)
    meta = _rand_meta(rng, 12, 18)
    mj = _conv(meta, lambda a: jnp.asarray(a, jnp.int32))
    mt = _conv(meta, t32)
    mj["bit_depth"] = mt["bit_depth"] = bd
    want = jtd._edge_params_jnp(mj, vertical=vertical)
    got = fh._edge_params_jnp(mt, vertical=vertical)
    for k in ("bs", "beta", "tc", "qp_l", "no_p", "no_q", "tco"):
        _eq(got[k], want[k])
    for c in range(2):
        _eq(got["cqo"][c], want["cqo"][c])
    # the chroma QP map of the deblocking section
    qpi = rng.integers(-5, 60, (7, 9))
    for is420 in (True, False):
        _eq(fh._chroma_qp_map(t32(qpi), is420),
            jtd._chroma_qp_map(jnp.asarray(qpi, jnp.int32), is420))


@pytest.mark.parametrize("s", [4, 8, 16, 32])
def test_wave_body(s):
    """One super-wave step: K disjoint blocks with random modes, edge
    filters, smoothing flags, availability bits and residuals, on a smooth
    plane (so the 32x32 bilinear case triggers) with noise.  The JAX
    program's step on the unpadded plane (its plain gather and scatter)
    against the port's on the padded plane (intra_step_plain on a one-step
    record set, the scan's plain version), unpadded.  No border sample
    outside the picture is available (8.4.4.2.2, as in every schedule):
    the unpadded step reads a clamped sample there, the padded one the
    padding."""
    rng = np.random.default_rng(50 + s)
    H, W, bd = 128, 160, 8
    yy, xx = np.mgrid[0:H, 0:W]
    plane = (60 + yy + xx // 2 + rng.integers(0, 3, (H, W))) % 256
    K = min(jfd.WAVE_CAP[s.bit_length() - 1], 24)
    cells = [(y, x) for y in range(0, H, s) for x in range(0, W, s)]
    assert len(cells) >= K
    pick = rng.permutation(len(cells))[:K]
    meta = np.zeros((K, 5), np.int64)
    for j, c in enumerate(pick):
        meta[j, 2], meta[j, 3] = cells[c]
    meta[:, 0] = rng.integers(0, 35, K)
    meta[:, 1] = rng.integers(0, 4, K) if s < 32 else 0
    # flags: 1 unavailable border | 2 smoothing | 4 strong | 8 valid
    meta[:, 4] = ((rng.random(K) < 0.2) * 1 | (rng.random(K) < 0.6) * 2 |
                  (rng.random(K) < 0.5) * 4 | (rng.random(K) >= 0.15) * 8)
    aw = rng.integers(0, 1 << 31, (K, jfd.AVAIL_WORDS))
    aw[rng.random(K) < 0.5] = -1                 # fully available borders
    j, n2 = np.arange(4 * s + 1), 2 * s
    by = np.where(j < n2, meta[:, 2:3] + n2 - 1 - j, meta[:, 2:3] - 1)
    bx = np.where(j <= n2, meta[:, 3:4] - 1, meta[:, 3:4] + j - n2 - 1)
    bits = np.unpackbits(aw.astype(np.int32).view(np.uint8), axis=1,
                         bitorder="little")
    bits[:, :4 * s + 1] &= (by >= 0) & (by < H) & (bx >= 0) & (bx < W)
    aw = np.packbits(bits, axis=1, bitorder="little").view(np.int32)
    resid = rng.integers(-40, 41, (K, s, s))
    tabs = jiw.build_mode_tables(s)
    want = jfd._wave_body(jnp.asarray(plane, jnp.int32),
                          jnp.asarray(meta, jnp.int32),
                          jnp.asarray(aw, jnp.int32),
                          jnp.asarray(resid, jnp.int32),
                          *(jnp.asarray(t) for t in tabs), s=s, bit_depth=bd,
                          pallas=False)
    padded = tiw.pad_plane_for_scan(t32(plane), *tiw.scan_pad_sizes(H, W))
    intra_cuda.intra_step_plain(padded, t32(meta[None]),
                                t32(np.arange(K)[None]), t32(aw[None]), 0,
                                t32(resid),
                                *(t32(t) for t in tabs), s=s, bit_depth=bd)
    got = tiw.unpad_plane(padded, H, W)
    _eq(got, want)
    assert not np.array_equal(np.asarray(want), plane)
