"""Coefficient densify (kernel B4's plain version) vs the JAX package: the
XLA formulation of the fused program (fused_decode._expand_feed + the dense
scatter), the Pallas kernel in interpret mode and the numpy oracle, at the
shapes of tests/test_coef_pallas.py; all bins of a picture in one call
(densify_bins); the escape corrections vs the JAX program's expression.
On a CUDA card the kernel is held against the plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libde265_tpu import fused_decode as jfd
from libde265_tpu.ops import coef_pallas as cp

from libde265_tpu_torch import fused_decode as tfd
from libde265_tpu_torch.ops import coef_cuda

from _torch_common import (bytes_to_words, cuda, encode_csr,  # noqa: F401
                           poison, random_csr, t32)

SHAPES = {4: 77, 8: 41, 16: 13, 32: 9}


def _xla_levels(cv, coff, N, S):
    """The JAX program's non-Pallas densify (fused_decode.py:1083-1087)."""
    feed = {f"bin{S.bit_length() - 1}": {"cv": jnp.asarray(cv),
                                         "coff": jnp.asarray(coff)}}
    jfd._expand_feed(feed)
    bf = next(iter(feed.values()))
    levels = jnp.zeros((N, S, S), jnp.int32)
    return levels.at[bf["crow"], bf["cpos"] >> 6, bf["cpos"] & 63].set(
        bf["cval"], mode="drop", unique_indices=True)


def _pallas(cv, coff, N, S):
    cap = int(max((coff[1:N + 1] - coff[:N]).max(initial=4), 4))
    return np.asarray(cp.densify_bin(jnp.asarray(cv), jnp.asarray(coff), N=N,
                                     S=S, CAP=1 << (cap - 1).bit_length(),
                                     interpret=True))


def _cases():
    rng = np.random.default_rng(77)
    out = []
    for S, N in SHAPES.items():
        cv, coff = random_csr(rng, N, S, max_nnz=S * S)
        out.append((f"random-{S}", cv, coff, N, S))
    # long gaps: single far coefficients force chains of zero bytes
    bs, offs = [], [0]
    for _ in range(8):
        e = encode_csr([int(rng.integers(32 * 32 - 64, 32 * 32))],
                       [int(rng.integers(1, 8))])
        bs.extend(e)
        offs.append(offs[-1] + len(e))
    out.append(("long-gaps", bytes_to_words(bs), np.array(offs, np.int32), 8,
                32))
    # watermark padding: coff rows past the real TUs repeat the total
    cv, coff = random_csr(rng, 10, 8, max_nnz=12)
    coff = np.concatenate([coff, np.full(32 + 1 - len(coff), coff[-1],
                                         np.int32)])
    out.append(("padded-rows", cv, coff, 32, 8))
    return out


CASES = _cases()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_densify_plain_matches_jax(case):
    _, cv, coff, N, S = case
    got = coef_cuda.densify_bin(t32(cv), t32(coff), N=N, S=S).numpy()
    np.testing.assert_array_equal(got, cp.densify_ref(cv, coff, N=N, S=S))
    np.testing.assert_array_equal(got, np.asarray(_xla_levels(cv, coff, N, S)))
    np.testing.assert_array_equal(got, _pallas(cv, coff, N, S))


def test_densify_empty_bin():
    got = coef_cuda.densify_bin(t32(np.zeros(0)), t32(np.zeros(1)), N=0, S=4)
    assert got.shape == (0, 4, 4)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_densify_kernel_matches_plain(cuda, case):  # noqa: F811
    _, cv, coff, N, S = case
    n0 = coef_cuda.launches
    got = coef_cuda.densify_bin(t32(cv, cuda), t32(coff, cuda), N=N, S=S)
    want = coef_cuda.densify_bin_plain(t32(cv, cuda), t32(coff, cuda), N, S)
    torch.cuda.synchronize()
    assert coef_cuda.launches == n0 + 1
    assert torch.equal(got, want)


def _picture_bins(seed):
    """One picture's four bins (numpy cv, coff, N, S): S = 4 with padding
    rows, S = 8 empty, S = 16 with a TU whose entries run past S*S and a
    last run that ends past cv, S = 32 with long zero-byte gaps."""
    rng = np.random.default_rng(seed)
    cv4, coff4 = random_csr(rng, 90, 4, max_nnz=16)
    coff4 = np.concatenate([coff4, np.full(38, coff4[-1], np.int32)])
    bins = [(cv4, coff4, 127, 4),
            (np.zeros(0, np.int32), np.zeros(1, np.int32), 0, 8)]
    cv, coff = random_csr(rng, 13, 16, max_nnz=256)
    bs = list(cv.view(np.uint8))
    # positions 10, then 10 + 20 * 15 + 4 = 314 >= 256 (dropped)
    past = [9 | (3 << 4)] + [0] * 20 + [3 | (5 << 4), 0, 0]
    tail = [0] * 7 + [2 | ((-4 & 0xF) << 4)] * 9     # 16 entries
    bs += past + tail
    offs = list(coff) + [len(cv) * 4 + len(past), len(bs)]
    cut = 2       # the last TU's run ends two words past cv
    bins.append((bytes_to_words(bs)[:-cut], np.array(offs, np.int32), 15,
                 16))
    bs, offs = [], [0]
    for _ in range(9):
        e = encode_csr(sorted(rng.choice(1024, 3, replace=False)),
                       rng.integers(1, 8, 3))
        bs.extend(e)
        offs.append(offs[-1] + len(e))
    bins.append((bytes_to_words(bs), np.array(offs, np.int32), 9, 32))
    return bins


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_densify_bins_plain_matches_jax(seed):
    bins = _picture_bins(seed)
    buf, views = coef_cuda.densify_bins(
        [(t32(cv), t32(coff), N, S) for cv, coff, N, S in bins])
    assert buf.shape == (sum(N * S * S for *_, N, S in bins) + 1,)
    assert buf[-1] == 0
    off = 0
    for (cv, coff, N, S), v in zip(bins, views):
        assert v.shape == (N, S, S)
        assert v.untyped_storage().data_ptr() == \
            buf.untyped_storage().data_ptr() and v.storage_offset() == off
        off += N * S * S
        # the oracle walks every entry of a run: cv zero-padded past its
        # end (zero bytes write nothing)
        padded = np.concatenate([cv, np.zeros(int(coff[N]) // 4 + 1,
                                              np.int32)])
        np.testing.assert_array_equal(v.numpy(),
                                      cp.densify_ref(padded, coff, N=N, S=S))
        if N:
            np.testing.assert_array_equal(v.numpy(), _pallas(cv, coff, N, S))


def test_densify_bins_rejects_bad_bins():
    cv, coff = t32(np.zeros(4)), t32(np.zeros(3))
    with pytest.raises(ValueError):
        coef_cuda.densify_bins([(cv, coff, 2, 4)] * 5)
    with pytest.raises(ValueError):
        coef_cuda.densify_bins([(cv, coff, 2, 2)])
    with pytest.raises(ValueError):
        coef_cuda.densify_bins([(cv, coff, 3, 4)])


def test_escape_corrections_match_jax():
    """fused_decode._add_escapes (in place into the picture's buffer)
    against the JAX program's correction (libde265_tpu/fused_decode.py,
    the `"cfx" in bf` branch): escape positions, padding rows (cfx = -1)
    and one index past the bin."""
    rng = np.random.default_rng(11)
    shapes = [(4, 60), (8, 9), (32, 3)]
    levels = [rng.integers(-7, 8, (N, S, S)) for S, N in shapes]
    buf = t32(np.concatenate([lv.ravel() for lv in levels] + [[0]]))
    off = 0
    for (S, N), lv in zip(shapes, levels):
        n = N * S * S
        k = int(rng.integers(1, 12))
        cfx = np.concatenate([rng.choice(n, k, replace=False), [-1, -1, n]])
        cfv = np.concatenate([rng.integers(-600, 600, k),
                              rng.integers(1, 50, 3)])
        tfd._add_escapes(buf, off, n, t32(cfx), t32(cfv))
        s = S
        cfx_j, cfv_j = jnp.asarray(cfx, jnp.int32), jnp.asarray(cfv, jnp.int32)
        rr = jnp.where(cfx_j >= 0, jnp.clip(cfx_j, 0) // (s * s), 1 << 30)
        pp = jnp.clip(cfx_j, 0) % (s * s)
        want = jnp.asarray(lv, jnp.int32).at[rr, pp // s, pp % s].add(
            cfv_j, mode="drop", unique_indices=True)
        np.testing.assert_array_equal(buf[off:off + n].view(N, S, S).numpy(),
                                      np.asarray(want))
        off += n


def _on_card(bins, dev):
    return [(t32(cv, dev), t32(coff, dev), N, S) for cv, coff, N, S in bins]


def _hd_bins(rng):
    """Four random bins at the 1080p main path's bin sizes."""
    return [(*random_csr(rng, N, S, max_nnz=S * S), N, S)
            for S, N in ((4, 4096), (8, 2048), (16, 512), (32, 128))]


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [1, 2, 3, "1080p"])
def test_densify_bins_kernel_one_launch(cuda, seed):  # noqa: F811
    bins = (_hd_bins(np.random.default_rng(5)) if seed == "1080p" else
            _picture_bins(seed))
    args = _on_card(bins, cuda)
    poison(sum(N * S * S for *_, N, S in bins) + 1)
    n0 = coef_cuda.launches
    buf, views = coef_cuda.densify_bins(args)
    want, _ = coef_cuda.densify_bins_plain(args)
    torch.cuda.synchronize()
    assert coef_cuda.launches == n0 + 1
    assert torch.equal(buf, want)
    for v, (*_, N, S) in zip(views, bins):
        assert v.shape == (N, S, S)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [(1, 1, 32), (7, 4, 64), (256, 32, 512),
                                  (32, 2, 128)])
def test_densify_bins_kernel_tile_shapes(cuda, tile):  # noqa: F811
    """Every (TUs of a tile, lanes a TU, threads) shape equals the plain
    version (the tile sweep runs these)."""
    tus, lanes, threads = tile
    bins = _picture_bins(4)
    args = _on_card(bins, cuda)
    saved = dict(coef_cuda.TILE), coef_cuda.THREADS
    try:
        for S in coef_cuda.TILE:
            coef_cuda.TILE[S] = (min(tus, 4096 // (S * S)), lanes)
        coef_cuda.THREADS = threads
        poison(sum(N * S * S for *_, N, S in bins) + 1)
        buf, _ = coef_cuda.densify_bins(args)
        want, _ = coef_cuda.densify_bins_plain(args)
        torch.cuda.synchronize()
    finally:
        coef_cuda.TILE.update(saved[0])
        coef_cuda.THREADS = saved[1]
    assert torch.equal(buf, want)


@pytest.mark.gpu
def test_densify_bins_all_empty(cuda):  # noqa: F811
    """Bins with no TU: one launch still writes the scratch element."""
    z = t32(np.zeros(1), cuda)
    poison(1)
    n0 = coef_cuda.launches
    buf, views = coef_cuda.densify_bins([(z, z, 0, 4), (z, z, 0, 32)])
    torch.cuda.synchronize()
    assert coef_cuda.launches == n0 + 1
    assert buf.tolist() == [0] and [v.shape for v in views] == [
        (0, 4, 4), (0, 32, 32)]
