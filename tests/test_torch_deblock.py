"""Deblocking passes (kernels B8/B9's plain versions) vs the JAX package's
XLA passes and its Pallas kernels in interpret mode, at the shapes of
tests/test_deblock_pallas.py.  On a CUDA card each kernel is held against
its plain version."""
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
