"""Deblocking (kernels B8/B9's plain versions) vs the JAX package's XLA
passes and its Pallas kernels in interpret mode: the per-orientation
passes at the shapes of tests/test_deblock_pallas.py, and deblock_luma /
deblock_chroma (every vertical, then every horizontal edge of a picture's
planes) against the JAX passes composed as the picture program composes
them.  The edge parameters of a picture (deblock_params) on the packed
per-4x4 grids against the JAX program's _edge_params_jnp, run by its
deblocking section on the same feed, and the port's deblocking section
against that section's planes.  Tolerance 0 (integer math).  On a CUDA
card each kernel is held against its plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libde265_tpu.ops import deblock as jdbk
from libde265_tpu.ops import deblock_pallas as jdbp

from libde265_tpu_torch.ops import deblock_cuda

from _torch_common import cuda, t32  # noqa: F401


def _luma_params(rng, a, b, bd):
    return (rng.integers(0, 3, (a, b)),
            rng.integers(0, 65, (a, b)) << (bd - 8),
            rng.integers(0, 25, (a, b)) << (bd - 8),
            (rng.random((a, b)) < 0.1).astype(np.int32),
            (rng.random((a, b)) < 0.1).astype(np.int32))


def _chroma_params(rng, a, b, bd):
    tcs = rng.integers(0, 25, (2, a, b)) << (bd - 8)
    tcs[rng.random((2, a, b)) < 0.5] = 0
    return (tcs, (rng.random((a, b)) < 0.1).astype(np.int32),
            (rng.random((a, b)) < 0.1).astype(np.int32))


def _luma_case(H, W, bd, horizontal):
    rng = np.random.default_rng(7 + H + W + bd + 100 * horizontal)
    if horizontal:
        img = rng.integers(0, 1 << bd, (H + 8, W))
        return img, _luma_params(rng, (H + 8) // 8, W // 4, bd)
    img = rng.integers(0, 1 << bd, (H, W + 8))
    return img, _luma_params(rng, H // 4, (W + 8) // 8, bd)


def _chroma_case(H, W, per_seg, bd, horizontal):
    rng = np.random.default_rng(11 + H + W + per_seg + bd + 100 * horizontal)
    if horizontal:
        imgs = rng.integers(0, 1 << bd, (2, H + 8, W))
        return imgs, _chroma_params(rng, (H + 8) // 8, -(-W // per_seg), bd)
    imgs = rng.integers(0, 1 << bd, (2, H, W + 8))
    return imgs, _chroma_params(rng, -(-H // per_seg), (W + 8) // 8, bd)


def _j(a):
    return jnp.asarray(a, jnp.int32)


LUMA = [(64, 128, 8), (72, 88, 8), (64, 128, 10)]
# the last case of each: a chroma plane whose width and height are not
# multiples of 8 (104x72 4:2:0: 52x36), whose last edge (x = 48, y = 32)
# the picture program counts since the chroma edge repair
CHROMA_V = [(32, 64, 2, 8), (36, 40, 4, 8), (32, 64, 2, 10), (36, 52, 2, 8)]
CHROMA_H = [(64, 32, 2, 8), (40, 36, 4, 8), (64, 32, 2, 10), (52, 36, 2, 8)]


@pytest.mark.parametrize("H,W,bd", LUMA)
def test_luma_pass_matches_jax(H, W, bd):
    img, prm = _luma_case(H, W, bd, False)
    got = deblock_cuda.luma_pass(t32(img), *map(t32, prm), bit_depth=bd)
    xla = jdbk._luma_pass(_j(img), *map(_j, prm), bit_depth=bd)
    pal = jdbp.luma_pass(_j(img), *map(_j, prm), bit_depth=bd,
                         interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(xla))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pal))


@pytest.mark.parametrize("H,W,bd", LUMA)
def test_luma_pass_h_matches_jax(H, W, bd):
    img, prm = _luma_case(H, W, bd, True)
    got = deblock_cuda.luma_pass_h(t32(img), *map(t32, prm), bit_depth=bd)
    xla = jdbk._luma_pass(_j(img.T), *(_j(a.T) for a in prm),
                          bit_depth=bd).T
    pal = jdbp.luma_pass_h(_j(img), *map(_j, prm), bit_depth=bd,
                           interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(xla))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pal))


@pytest.mark.parametrize("H,W,rps,bd", CHROMA_V)
def test_chroma_pass_matches_jax(H, W, rps, bd):
    imgs, (tcs, no_p, no_q) = _chroma_case(H, W, rps, bd, False)
    got = deblock_cuda.chroma_pass_stacked(
        t32(imgs), t32(tcs), t32(no_p), t32(no_q), bit_depth=bd,
        rows_per_seg=rps).numpy()
    pal = np.asarray(jdbp.chroma_pass_stacked(
        _j(imgs), _j(tcs), _j(no_p), _j(no_q), bit_depth=bd,
        rows_per_seg=rps, interpret=True))
    for c in range(2):
        xla = jdbk._chroma_pass(_j(imgs[c]), _j(tcs[c]), _j(no_p), _j(no_q),
                                bit_depth=bd, rows_per_seg=rps)
        np.testing.assert_array_equal(got[c], np.asarray(xla))
    np.testing.assert_array_equal(got, pal)


@pytest.mark.parametrize("H,W,cps,bd", CHROMA_H)
def test_chroma_pass_h_matches_jax(H, W, cps, bd):
    imgs, (tcs, no_p, no_q) = _chroma_case(H, W, cps, bd, True)
    got = deblock_cuda.chroma_pass_stacked_h(
        t32(imgs), t32(tcs), t32(no_p), t32(no_q), bit_depth=bd,
        cols_per_seg=cps).numpy()
    pal = np.asarray(jdbp.chroma_pass_stacked_h(
        _j(imgs), _j(tcs), _j(no_p), _j(no_q), bit_depth=bd,
        cols_per_seg=cps, interpret=True))
    for c in range(2):
        xla = jdbk._chroma_pass(_j(imgs[c].T), _j(tcs[c].T), _j(no_p.T),
                                _j(no_q.T), bit_depth=bd,
                                rows_per_seg=cps).T
        np.testing.assert_array_equal(got[c], np.asarray(xla))
    np.testing.assert_array_equal(got, pal)


@pytest.mark.parametrize("horizontal", [False, True], ids=["v", "h"])
def test_chroma_pass_filters_the_ragged_last_edge(horizontal):
    """A 52x36 chroma plane has 7 vertical and 5 horizontal edges, the last
    one 4 samples from the picture's end: the pass with all of them differs
    from the pass without the last one exactly around that edge."""
    H, W = (52, 36) if horizontal else (36, 52)
    imgs, (tcs, no_p, no_q) = _chroma_case(H, W, 2, 8, horizontal)
    tcs = np.maximum(tcs, 4)
    no_p, no_q = np.zeros_like(no_p), np.zeros_like(no_q)
    if horizontal:    # params [E, S]: drop the last edge row
        fn, kw = deblock_cuda.chroma_pass_stacked_h, {"cols_per_seg": 2}
        tcs_f, no_p_f, no_q_f = tcs[:, :-1], no_p[:-1], no_q[:-1]
    else:             # params [S, E]: drop the last edge column
        fn, kw = deblock_cuda.chroma_pass_stacked, {"rows_per_seg": 2}
        tcs_f, no_p_f, no_q_f = tcs[:, :, :-1], no_p[:, :-1], no_q[:, :-1]
    full = fn(t32(imgs), t32(tcs), t32(no_p), t32(no_q), bit_depth=8, **kw)
    fewer = fn(t32(imgs), t32(tcs_f), t32(no_p_f), t32(no_q_f), bit_depth=8,
               **kw)
    diff = (full != fewer).numpy()
    if horizontal:
        diff = diff.transpose(0, 2, 1)
    cols = np.flatnonzero(diff.any(axis=(0, 1)))
    assert cols.size and set(cols) <= {2 + 47, 2 + 48}, cols


@pytest.mark.gpu
@pytest.mark.parametrize("horizontal", [False, True], ids=["v", "h"])
@pytest.mark.parametrize("H,W,bd", LUMA)
def test_luma_kernel_matches_plain(cuda, H, W, bd, horizontal):  # noqa: F811
    img, prm = _luma_case(H, W, bd, horizontal)
    fn = deblock_cuda.luma_pass_h if horizontal else deblock_cuda.luma_pass
    got = fn(t32(img, cuda), *(t32(a, cuda) for a in prm), bit_depth=bd)
    want = fn(t32(img), *map(t32, prm), bit_depth=bd)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("horizontal", [False, True], ids=["v", "h"])
@pytest.mark.parametrize("H,W,per_seg,bd", CHROMA_V)
def test_chroma_kernel_matches_plain(cuda, H, W, per_seg, bd,  # noqa: F811
                                     horizontal):
    imgs, prm = _chroma_case(H, W, per_seg, bd, horizontal)
    if horizontal:
        fn, kw = deblock_cuda.chroma_pass_stacked_h, {"cols_per_seg": per_seg}
    else:
        fn, kw = deblock_cuda.chroma_pass_stacked, {"rows_per_seg": per_seg}
    got = fn(t32(imgs, cuda), *(t32(a, cuda) for a in prm), bit_depth=bd,
             **kw)
    want = fn(t32(imgs), *map(t32, prm), bit_depth=bd, **kw)
    assert torch.equal(got.cpu(), want)


# ---------------------------------------------------------------------------
# both orientations of a picture's planes (deblock_luma, deblock_chroma)
# ---------------------------------------------------------------------------

def _smooth(rng, shape, bd):
    """Blocky smooth content: a gradient, an offset per 4x4 block and a
    little noise, so that most edges pass the filter decisions (uniform
    noise fails them)."""
    *lead, h, w = shape
    yy, xx = np.mgrid[0:h, 0:w]
    off = rng.integers(-6, 7, (*lead, (h + 3) // 4, (w + 3) // 4))
    off = off.repeat(4, -2).repeat(4, -1)[..., :h, :w]
    v = ((xx + 2 * yy) // 3 % 160 + off + rng.integers(0, 3, (*lead, h, w)) +
         40) << (bd - 8)
    return np.clip(v, 0, (1 << bd) - 1)


def _picture_case(H, W, sub_x, sub_y, bd):
    """Planes and edge parameters of an H x W picture in the layouts of
    _edge_params_jnp (edge 0 dropped): luma [H/4, W/8-1] and [H/8-1, W/4],
    chroma [., S, (Wc+7)//8 - 1] and [., (Hc+7)//8 - 1, S']."""
    rng = np.random.default_rng(H * 31 + W + 7 * sub_x + 3 * sub_y + bd)
    Hc, Wc = H // sub_y, W // sub_x
    y = _smooth(rng, (H, W), bd)
    cbcr = _smooth(rng, (2, Hc, Wc), bd)
    pv = _luma_params(rng, H // 4, W // 8 - 1, bd)
    ph = _luma_params(rng, H // 8 - 1, W // 4, bd)
    cv = _chroma_params(rng, H // 4, (Wc + 7) // 8 - 1, bd)
    ch = _chroma_params(rng, (Hc + 7) // 8 - 1, W // 4, bd)
    return y, cbcr, pv, ph, cv, ch


def _pad0(a, E):
    return np.concatenate([np.zeros((a.shape[0], 1), a.dtype), a], 1)[:, :E]


def _jax_luma(y, pv, ph, bd, pallas):
    """The JAX passes composed: pad 4 columns, vertical pass, unpad, pad 4
    rows, horizontal pass (XLA: the vertical pass on the transpose), unpad."""
    H, W = y.shape
    pad = np.zeros((H, W + 8), np.int32)
    pad[:, 4:4 + W] = y
    v = [_j(_pad0(a, W // 8)) for a in pv]
    out = (jdbp.luma_pass(_j(pad), *v, bit_depth=bd, interpret=True)
           if pallas else jdbk._luma_pass(_j(pad), *v, bit_depth=bd))
    pad = np.zeros((H + 8, W), np.int32)
    pad[4:4 + H] = np.asarray(out)[:, 4:4 + W]
    h = [_pad0(a.T, H // 8) for a in ph]                 # [W/4, H/8]
    out = (jdbp.luma_pass_h(_j(pad), *(_j(a.T) for a in h), bit_depth=bd,
                            interpret=True) if pallas else
           jdbk._luma_pass(_j(pad.T), *map(_j, h), bit_depth=bd).T)
    return np.asarray(out)[4:4 + H]


def _jax_chroma(cbcr, cv, ch, bd, sub_x, sub_y, pallas):
    """The same for both chroma planes: 2-sample pads, 4 // sub_y rows
    (4 // sub_x columns) a segment, (Wc+7)//8 and (Hc+7)//8 edges."""
    _, Hc, Wc = cbcr.shape
    ev, eh = (Wc + 7) // 8, (Hc + 7) // 8
    pad = np.zeros((2, Hc, Wc + 8), np.int32)
    pad[:, :, 2:2 + Wc] = cbcr
    tcs = np.stack([_pad0(t, ev) for t in cv[0]])
    no_p, no_q = _pad0(cv[1], ev), _pad0(cv[2], ev)
    if pallas:
        out = np.asarray(jdbp.chroma_pass_stacked(
            _j(pad), _j(tcs), _j(no_p), _j(no_q), bit_depth=bd,
            rows_per_seg=4 // sub_y, interpret=True))
    else:
        out = np.stack([np.asarray(jdbk._chroma_pass(
            _j(pad[c]), _j(tcs[c]), _j(no_p), _j(no_q), bit_depth=bd,
            rows_per_seg=4 // sub_y)) for c in range(2)])
    pad = np.zeros((2, Hc + 8, Wc), np.int32)
    pad[:, 2:2 + Hc] = out[:, :, 2:2 + Wc]
    tcs = np.stack([_pad0(t.T, eh).T for t in ch[0]])    # [2, eh, S']
    no_p, no_q = _pad0(ch[1].T, eh).T, _pad0(ch[2].T, eh).T
    if pallas:
        out = np.asarray(jdbp.chroma_pass_stacked_h(
            _j(pad), _j(tcs), _j(no_p), _j(no_q), bit_depth=bd,
            cols_per_seg=4 // sub_x, interpret=True))
    else:
        out = np.stack([np.asarray(jdbk._chroma_pass(
            _j(pad[c].T), _j(tcs[c].T), _j(no_p.T), _j(no_q.T),
            bit_depth=bd, rows_per_seg=4 // sub_x)).T for c in range(2)])
    return out[:, 2:2 + Hc]


# (H, W, sub_x, sub_y, bit depth): the luma shapes above, 104x72 4:2:0
# (52x36 chroma, whose last edges lie 4 samples from the end), 4:2:2 and
# 4:4:4, at bit depths 8 and 10
PICTURES = [(64, 128, 2, 2, 8), (72, 88, 2, 2, 8), (64, 128, 2, 2, 10),
            (72, 104, 2, 2, 8), (72, 104, 2, 2, 10), (40, 80, 2, 1, 8),
            (40, 80, 2, 1, 10), (48, 64, 1, 1, 8), (48, 64, 1, 1, 10)]
FORMAT = {(2, 2): "420", (2, 1): "422", (1, 1): "444"}
PICTURE_IDS = [f"{w}x{h}-{FORMAT[sx, sy]}-bd{bd}"
               for h, w, sx, sy, bd in PICTURES]
LUMA_PICTURES = sorted({(h, w, bd) for h, w, _, _, bd in PICTURES})


@pytest.mark.parametrize("H,W,bd", LUMA_PICTURES)
def test_deblock_luma_matches_jax(H, W, bd):
    y, _, pv, ph, _, _ = _picture_case(H, W, 2, 2, bd)
    got = deblock_cuda.deblock_luma(t32(y), [t32(a) for a in pv],
                                    [t32(a) for a in ph], bit_depth=bd)
    assert got.is_contiguous() and (got.numpy() != y).sum() > H * W // 20
    for pallas in (False, True):
        np.testing.assert_array_equal(got.numpy(),
                                      _jax_luma(y, pv, ph, bd, pallas))


@pytest.mark.parametrize("H,W,sub_x,sub_y,bd", PICTURES, ids=PICTURE_IDS)
def test_deblock_chroma_matches_jax(H, W, sub_x, sub_y, bd):
    _, cbcr, _, _, cv, ch = _picture_case(H, W, sub_x, sub_y, bd)
    got = deblock_cuda.deblock_chroma(
        t32(cbcr[0]), t32(cbcr[1]), [t32(a) for a in cv],
        [t32(a) for a in ch], bit_depth=bd, sub_x=sub_x, sub_y=sub_y)
    assert got.is_contiguous() and (got.numpy() != cbcr).sum() > \
        cbcr.size // 50
    for pallas in (False, True):
        np.testing.assert_array_equal(
            got.numpy(), _jax_chroma(cbcr, cv, ch, bd, sub_x, sub_y, pallas))


def _strided(a, dev, pitch_pad=0):
    """a on dev, as a view with a wider row pitch (pitch_pad more columns,
    16-byte aligned) or with every other column of a [., 2b] tensor."""
    a = np.asarray(a)
    if pitch_pad:
        big = torch.full((a.shape[0] + 1, a.shape[1] + pitch_pad), -9,
                         dtype=torch.int32, device=dev)
        big[1:, pitch_pad:] = t32(a, dev)
        return big[1:, pitch_pad:]
    big = torch.full((*a.shape[:-1], 2 * a.shape[-1]), -9, dtype=torch.int32,
                     device=dev)
    big[..., ::2] = t32(a, dev)
    return big[..., ::2]


@pytest.mark.gpu
@pytest.mark.parametrize("strided", [False, True], ids=["dense", "views"])
@pytest.mark.parametrize(
    "H,W,sub_x,sub_y,bd",
    PICTURES + [(64, 8192, 2, 2, 8), (8192, 64, 2, 2, 8),
                (1088, 1920, 2, 2, 8)],
    ids=PICTURE_IDS + ["8192x64-420-bd8", "64x8192-420-bd8",
                       "1920x1088-420-bd8"])
def test_deblock_kernels_match_plain(cuda, H, W, sub_x, sub_y, bd,  # noqa: F811
                                     strided):
    """One launch each, equal to the plain version; tiles straddle the
    ragged right and bottom edges of every plane here (128-column tiles
    of 16 or 32 rows from column and row -4).  "views": planes with a wider
    row pitch and parameters with a column stride of 2, as the picture
    program hands them over."""
    y, cbcr, pv, ph, cv, ch = _picture_case(H, W, sub_x, sub_y, bd)

    def dev(a, pitch=0):
        return _strided(a, cuda, pitch) if strided else t32(a, cuda)

    n0 = deblock_cuda.luma_launches
    got = deblock_cuda.deblock_luma(dev(y, 132), [dev(a) for a in pv],
                                    [dev(a) for a in ph], bit_depth=bd)
    want = deblock_cuda.deblock_luma(t32(y), [t32(a) for a in pv],
                                     [t32(a) for a in ph], bit_depth=bd)
    assert deblock_cuda.luma_launches == n0 + 1
    assert torch.equal(got.cpu(), want)
    n0 = deblock_cuda.chroma_launches
    got = deblock_cuda.deblock_chroma(
        dev(cbcr[0], 8), dev(cbcr[1], 4), [dev(a) for a in cv],
        [dev(a) for a in ch], bit_depth=bd, sub_x=sub_x, sub_y=sub_y)
    want = deblock_cuda.deblock_chroma(
        t32(cbcr[0]), t32(cbcr[1]), [t32(a) for a in cv],
        [t32(a) for a in ch], bit_depth=bd, sub_x=sub_x, sub_y=sub_y)
    assert deblock_cuda.chroma_launches == n0 + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("tile_h,threads", [(16, 64), (16, 128), (16, 256),
                                            (32, 64), (32, 128),
                                            (32, 256)])
def test_deblock_kernel_tile_shapes(cuda, tile_h, threads):  # noqa: F811
    """Every tile height and CTA size the kernels take (the sweep's
    configurations) gives the plain version's planes."""
    y, cbcr, pv, ph, cv, ch = _picture_case(72, 104, 2, 2, 10)
    saved = dict(deblock_cuda.TILE)
    deblock_cuda.TILE.update(dict.fromkeys(saved, (tile_h, threads)))
    try:
        got_y = deblock_cuda.deblock_luma(
            t32(y, cuda), [t32(a, cuda) for a in pv],
            [t32(a, cuda) for a in ph], bit_depth=10)
        got_c = deblock_cuda.deblock_chroma(
            t32(cbcr[0], cuda), t32(cbcr[1], cuda),
            [t32(a, cuda) for a in cv], [t32(a, cuda) for a in ch],
            bit_depth=10)
    finally:
        deblock_cuda.TILE.update(saved)
    assert torch.equal(got_y.cpu(), deblock_cuda.deblock_luma(
        t32(y), [t32(a) for a in pv], [t32(a) for a in ph], bit_depth=10))
    assert torch.equal(got_c.cpu(), deblock_cuda.deblock_chroma(
        t32(cbcr[0]), t32(cbcr[1]), [t32(a) for a in cv],
        [t32(a) for a in ch], bit_depth=10))


@pytest.mark.gpu
def test_deblock_rejects_unaligned_planes(cuda):  # noqa: F811
    """The kernels load rows with 16-byte loads: a plane whose rows are not
    16-byte aligned raises ValueError (there is no fallback)."""
    y, _, pv, ph, _, _ = _picture_case(64, 128, 2, 2, 8)
    big = t32(np.zeros((64, 136)), cuda)
    big[:, 1:129] = t32(y, cuda)
    with pytest.raises(ValueError, match="aligned"):
        deblock_cuda.deblock_luma(big[:, 1:129], [t32(a, cuda) for a in pv],
                                  [t32(a, cuda) for a in ph])


# ---------------------------------------------------------------------------
# the edge parameters of a picture (deblock_params, tde_deblock_params) and
# frame_helpers.deblock_planes on the packed grids
# ---------------------------------------------------------------------------

def _packed_case(H, W, sub_x, sub_y, bd, mono, ctb, n_slices, tiles,
                 across_tiles, allow, seed):
    """Seeded inputs of deblock_params for an H x W picture: the packed
    per-4x4 grids (cu4 with bits above bit 0 set too, dbf4 all four bits),
    cell grids whose MVs and POCs are set also where pf leaves the list
    unused, raster-order slices (slice 1 filters not across slices, slice
    2 has deblocking disabled, the rest random offsets), a tiles[0] x
    tiles[1] tile grid and optional allow masks."""
    rng = np.random.default_rng(seed)
    h4, w4 = -(-H // 4), -(-W // 4)

    def g(hi):
        return rng.integers(0, hi, (h4, w4)).astype(np.int32)

    grids = {"cu4": g(8) * (rng.random((h4, w4)) < 0.4), "nzc4": g(4),
             "dbf4": g(16), "qp4": g(52),
             "unfilt": rng.random((h4, w4)) < 0.1,
             "pf": g(4).reshape(-1)}
    for l in (0, 1):
        for c in "xy":
            grids[f"mv{l}{c}"] = rng.integers(-9, 10, h4 * w4)
        grids[f"poc{l}"] = rng.integers(0, 3, h4 * w4)
    ch, cw = -(-H // ctb), -(-W // ctb)
    n_slices = min(n_slices, ch * cw)
    starts = np.concatenate([[0], np.sort(rng.choice(
        np.arange(1, ch * cw), n_slices - 1, replace=False))])
    sl = np.searchsorted(starts, np.arange(ch * cw), side="right") - 1
    ty = np.arange(ch) * tiles[0] // ch
    tx = np.arange(cw) * tiles[1] // cw
    recs = np.zeros((n_slices, 208), np.int32)
    recs[:, 2:4] = rng.integers(-6, 7, (n_slices, 2)) * 2
    recs[:, 9] = 1
    recs[:, 10:12] = rng.integers(-12, 13, (n_slices, 2))
    recs[1:2, 9] = 0
    recs[2:3, 1] = 1
    st = {"H": H, "W": W, "sub_x": sub_x, "sub_y": sub_y, "bd": bd,
          "bdc": bd, "mono": mono, "ctb_size": ctb, "n_slices": n_slices,
          "across_tiles": across_tiles}
    masks = None
    if allow:
        masks = [(rng.random((h4, w4)) < 0.9).astype(np.int32)
                 for _ in range(2)]
    return (grids, recs, sl.reshape(ch, cw), starts[sl].reshape(ch, cw),
            ty[:, None] * tiles[1] + tx[None, :], st, masks)


# (H, W, sub_x, sub_y, bit depth, mono, CTB, slices, tiles, across tiles,
# allow masks)
PARAM_CASES = {
    "1080p-420-bd8": (1088, 1920, 2, 2, 8, False, 64, 3, (1, 1), True,
                      False),
    "1080p-420-bd10-tiles": (1088, 1920, 2, 2, 10, False, 64, 4, (2, 3),
                             False, False),
    "104x72-420-bd8": (72, 104, 2, 2, 8, False, 16, 3, (2, 2), False, True),
    "104x72-420-bd10": (72, 104, 2, 2, 10, False, 16, 4, (1, 2), True,
                        False),
    "104x72-422-bd8": (72, 104, 2, 1, 8, False, 16, 3, (2, 2), False, True),
    "104x72-444-bd10": (72, 104, 1, 1, 10, False, 32, 3, (2, 1), False,
                        False),
    "104x72-mono-bd8": (72, 104, 2, 2, 8, True, 16, 3, (2, 2), False, True),
    "128x72-422-bd10": (72, 128, 2, 1, 10, False, 16, 3, (1, 2), False,
                        True),
    "104x72-420-bd8-one-slice": (72, 104, 2, 2, 8, False, 64, 1, (1, 1),
                                 True, False),
}


def _torch_inputs(case, dev="cpu"):
    grids, recs, si, sa, ti, st, masks = case
    return ({k: t32(v, dev) for k, v in grids.items()}, t32(recs, dev),
            t32(si, dev), t32(sa, dev), t32(ti, dev), st,
            None if masks is None else tuple(t32(m, dev) for m in masks))


def _flat_params(prm):
    return [t for k in ("v", "h", "cv", "ch") if k in prm for t in prm[k]]


def _jax_section(case, planes):
    """The JAX program's deblocking section on the same packed feed:
    its planes, and the parameters of each _edge_params_jnp call."""
    from libde265_tpu import fused_decode as jfd
    grids, recs, si, sa, ti, st, masks = case
    h4, w4 = grids["qp4"].shape
    feed = {k: _j(grids[k]) for k in ("cu4", "nzc4", "dbf4", "qp4")}
    feed.update(slice_idx=_j(si), slice_addr=_j(sa), tile_id=_j(ti))
    if masks is not None:
        feed.update(allow_xv=_j(masks[0]), allow_xh=_j(masks[1]))
    cell = {k: _j(grids[k]) for k in deblock_cuda.CELL_KEYS}
    seen = []
    edge_params = jfd._edge_params_jnp

    def record(meta, vertical):
        seen.append(edge_params(meta, vertical))
        return seen[-1]

    jfd._edge_params_jnp = record
    try:
        out = jfd._deblock_section([_j(p) for p in planes], feed, _j(recs),
                                   cell, jnp.asarray(grids["unfilt"]),
                                   dict(st, pallas_deblock=False))
    finally:
        jfd._edge_params_jnp = edge_params
    return [np.asarray(p) for p in out], seen


def _jax_chroma_tc(p, sub, vertical, st):
    """The JAX program's chroma tc of one orientation from its
    _edge_params_jnp output, edge 0 dropped as the port keeps it."""
    from libde265_tpu import tpu_decode as jtd
    from libde265_tpu.ops import deblock as jdb
    s = (slice(None), slice(sub - 1, None, sub)) if vertical else \
        (slice(sub - 1, None, sub), slice(None))
    qpi = p["qp_l"][s][None] + jnp.stack([c[s] for c in p["cqo"]])
    qpc = jtd._chroma_qp_map(qpi, st["sub_x"] == 2 and st["sub_y"] == 2)
    tc = jnp.asarray(jdb.TC_TABLE)[jnp.clip(qpc + 2 + p["tco"][s][None], 0,
                                            53)] << (st["bdc"] - 8)
    return np.asarray(jnp.where(p["bs"][s][None] == 2, tc, 0)), s


@pytest.mark.parametrize("name", list(PARAM_CASES))
def test_deblock_params_match_jax(name):
    """deblock_params on the packed grids (the plain version on the CPU)
    equals the JAX program's _edge_params_jnp, run by its deblocking
    section on the same feed, parameter for parameter, and its chroma tc;
    the port's deblocking section (fused_decode._deblock_section through
    frame_helpers.deblock_planes) gives the JAX section's planes: luma
    always, chroma where the chroma plane is a multiple of 8 in both
    axes (the port filters the last, ragged chroma edge; ROADMAP C1)."""
    from libde265_tpu_torch import fused_decode as tfd
    H, W, sub_x, sub_y, bd, mono, *rest = PARAM_CASES[name]
    case = _packed_case(H, W, sub_x, sub_y, bd, mono, *rest,
                        seed=len(name) * 97 + bd)
    rng = np.random.default_rng(5)
    Hc, Wc = H // sub_y, W // sub_x
    planes = [_smooth(rng, (H, W), bd)] + \
        ([] if mono else list(_smooth(rng, (2, Hc, Wc), bd)))
    want_planes, (pv, ph) = _jax_section(case, planes)

    grids, recs, si, sa, ti, st, allow = _torch_inputs(case)
    prm = deblock_cuda.deblock_params(grids, recs, si, sa, ti, st, allow)
    for d, p in (("v", pv), ("h", ph)):
        for k, got in zip(("bs", "beta", "tc", "no_p", "no_q"), prm[d]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(p[k]),
                                          err_msg=f"{d} {k}")
    assert (prm["v"][0] > 0).any() and (prm["v"][0] == 0).any()
    if not mono:
        for d, p, sub, vertical in (("cv", pv, sub_x, True),
                                    ("ch", ph, sub_y, False)):
            tc, s = _jax_chroma_tc(p, sub, vertical, st)
            np.testing.assert_array_equal(prm[d][0].numpy(), tc)
            np.testing.assert_array_equal(prm[d][1].numpy(),
                                          np.asarray(p["no_p"][s]))
            np.testing.assert_array_equal(prm[d][2].numpy(),
                                          np.asarray(p["no_q"][s]))

    feed = {k: grids[k] for k in deblock_cuda.GRID_KEYS}
    feed.update(slice_idx=si, slice_addr=sa, tile_id=ti)
    if allow is not None:
        feed.update(allow_xv=allow[0], allow_xh=allow[1])
    cell = {k: grids[k] for k in deblock_cuda.CELL_KEYS}
    got = tfd._deblock_section([t32(p) for p in planes], feed, recs, cell,
                               grids["unfilt"], st)
    assert len(got) == len(want_planes) == (1 if mono else 3)
    assert (got[0].numpy() != planes[0]).sum() > H * W // 50
    np.testing.assert_array_equal(got[0].numpy(), want_planes[0])
    if not mono and Wc % 8 == 0 and Hc % 8 == 0:
        for c in (1, 2):
            np.testing.assert_array_equal(got[c].numpy(), want_planes[c])


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(PARAM_CASES))
def test_deblock_params_kernel_matches_plain(cuda, name):  # noqa: F811
    """tde_deblock_params: every array of the arena equal to the plain
    derivation bit for bit, one launch a call; then frame_helpers.
    deblock_planes on the card equal to its plain version, with one
    launch each of the parameters, B8 and B9 (none of B9 for mono)."""
    from libde265_tpu_torch.frame_helpers import deblock_planes
    H, W, sub_x, sub_y, bd, mono, *rest = PARAM_CASES[name]
    case = _packed_case(H, W, sub_x, sub_y, bd, mono, *rest,
                        seed=len(name) * 89 + bd)
    args = _torch_inputs(case)
    dargs = _torch_inputs(case, cuda)
    want = deblock_cuda.deblock_params(*args)
    n0 = deblock_cuda.param_launches
    got = deblock_cuda.deblock_params(*dargs)
    assert deblock_cuda.param_launches == n0 + 1
    got, want = _flat_params(got), _flat_params(want)
    assert len(got) == len(want) == (10 if mono else 16)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and torch.equal(a.cpu(), b), i

    rng = np.random.default_rng(3)
    Hc, Wc = H // sub_y, W // sub_x
    planes = [_smooth(rng, (H, W), bd)] + \
        ([] if mono else list(_smooth(rng, (2, Hc, Wc), bd)))
    want = deblock_planes([t32(p) for p in planes], *args)
    counts = (deblock_cuda.param_launches, deblock_cuda.luma_launches,
              deblock_cuda.chroma_launches)
    for _ in range(2):    # the second call reuses the arena
        got = deblock_planes([t32(p, cuda) for p in planes], *dargs)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
    assert (deblock_cuda.param_launches, deblock_cuda.luma_launches,
            deblock_cuda.chroma_launches) == (
        counts[0] + 2, counts[1] + 2, counts[2] + (0 if mono else 2))


@pytest.mark.gpu
def test_deblock_params_rejects_bad_inputs(cuda):  # noqa: F811
    """The kernel reads every grid densely with its row pitch: a wrong
    dtype raises TypeError, a wrong shape or a strided grid ValueError
    (there is no fallback)."""
    case = _packed_case(72, 104, 2, 2, 8, False, 16, 3, (2, 2), False, True,
                        seed=1)
    grids, recs, si, sa, ti, st, allow = _torch_inputs(case, cuda)

    def call(**kw):
        g = dict(grids, **kw.pop("grids", {}))
        a = dict(recs=recs, slice_idx=si, slice_addr=sa, tile_id=ti, st=st,
                 allow=allow)
        a.update(kw)
        return deblock_cuda.deblock_params(g, **a)

    call()
    with pytest.raises(TypeError):
        call(grids={"qp4": grids["qp4"].to(torch.int16)})
    with pytest.raises(TypeError):
        call(grids={"unfilt": grids["unfilt"].to(torch.int32)})
    with pytest.raises(TypeError):
        call(recs=recs.to(torch.int64))
    with pytest.raises(ValueError):
        call(grids={"pf": grids["pf"][:-1]})
    with pytest.raises(ValueError):
        call(grids={"cu4": grids["cu4"].t().contiguous().t()})
    with pytest.raises(ValueError):
        call(slice_idx=si[:1])
    with pytest.raises(ValueError):
        call(recs=recs[:, :11].contiguous())
    with pytest.raises(ValueError):
        call(st=dict(st, n_slices=recs.shape[0] + 1))
    with pytest.raises(ValueError):
        call(allow=(allow[0][:, :-1].contiguous(), allow[1]))
