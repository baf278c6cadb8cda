"""Coefficient densify (kernel B4's plain version) vs the JAX package: the
XLA formulation of the fused program (fused_decode._expand_feed + the dense
scatter), the Pallas kernel in interpret mode and the numpy oracle, at the
shapes of tests/test_coef_pallas.py.  On a CUDA card the kernel is held
against the plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libde265_tpu import fused_decode as jfd
from libde265_tpu.ops import coef_pallas as cp

from libde265_tpu_torch.ops import coef_cuda

from _torch_common import (bytes_to_words, cuda, encode_csr,  # noqa: F401
                           random_csr, t32)

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
    cap = int(max((coff[1:] - coff[:-1]).max(initial=4), 4))
    pallas = cp.densify_bin(jnp.asarray(cv), jnp.asarray(coff), N=N, S=S,
                            CAP=1 << (cap - 1).bit_length(), interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))


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
