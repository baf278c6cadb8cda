"""SAO (kernel B10's plain version) vs the JAX package's sao_plane and its
Pallas kernel in interpret mode, at the shapes of tests/test_sao_pallas.py,
and vs the JAX package's host pre-pass in front of that kernel
(sao_pallas.sao_plane_via_pallas) on the maps of two corpus pictures with
SAO.  On a CUDA card the kernel is held against the plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libde265_tpu.ops import sao as jsao
from libde265_tpu.ops.sao_pallas import sao_plane_fused as jsao_fused
from libde265_tpu.ops.sao_pallas import sao_plane_via_pallas

from libde265_tpu_torch import pipeline
from libde265_tpu_torch.ops import sao_cuda

from _torch_common import OWN_CORPUS, cuda, programs, t32  # noqa: F401

CASES = [(48, 80, 8, True), (48, 80, 10, True), (37, 61, 8, True),
         (37, 61, 8, False)]
IDS = ["48x80", "48x80-10bit", "37x61", "37x61-no-edge-mask"]


def _case(H, W, bd, with_edge_ok):
    rng = np.random.default_rng(H * W + bd)
    src = rng.integers(0, 1 << bd, (H, W))
    tmap = rng.integers(0, 3, (H, W))
    emap = rng.integers(0, 4, (H, W))
    bmap = rng.integers(0, 32, (H, W))
    omap = rng.integers(-7, 8, (H, W, 4)) << (bd - 8)
    skip = rng.random((H, W)) < 0.05
    eo = (rng.random((H, W)) > 0.1) if with_edge_ok else None
    return (src, tmap, emap, bmap, omap, skip), eo


@pytest.mark.parametrize("H,W,bd,with_edge_ok", CASES, ids=IDS)
def test_sao_plain_matches_jax(H, W, bd, with_edge_ok):
    args, eo = _case(H, W, bd, with_edge_ok)
    got = sao_cuda.sao_plane_fused(*map(t32, args), bit_depth=bd,
                                   edge_ok=None if eo is None else t32(eo))
    jargs = [jnp.asarray(a) if a.dtype == bool else jnp.asarray(a, jnp.int32)
             for a in args]
    jeo = None if eo is None else jnp.asarray(eo)
    want = jsao.sao_plane(*jargs, bit_depth=bd, edge_ok=jeo)
    pal = jsao_fused(*jargs, bit_depth=bd, edge_ok=jeo, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pal))


@pytest.mark.gpu
@pytest.mark.parametrize("H,W,bd,with_edge_ok", CASES, ids=IDS)
def test_sao_kernel_matches_plain(cuda, H, W, bd, with_edge_ok):  # noqa: F811
    args, eo = _case(H, W, bd, with_edge_ok)
    n0 = sao_cuda.launches
    got = sao_cuda.sao_plane_fused(
        *(t32(a, cuda) for a in args), bit_depth=bd,
        edge_ok=None if eo is None else t32(eo, cuda))
    want = sao_cuda.sao_plane_fused(*map(t32, args), bit_depth=bd,
                                    edge_ok=None if eo is None else t32(eo))
    assert sao_cuda.launches == n0 + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("stream,idx", [("sao_scaling", 0),
                                        ("rd_split_amp_sao", 1)])
def test_sao_equals_via_pallas_on_corpus_maps(native_build, monkeypatch,
                                              stream, idx):
    """Every plane's SAO call of pipeline.reconstruct on a corpus picture
    (its per-sample maps, built from the picture's CTB parameters): the
    port's sao_plane_fused equals the JAX package's sao_plane_via_pallas
    (its neighbour pre-pass, then the Pallas kernel in interpret mode)."""
    prog = programs((OWN_CORPUS / f"{stream}.h265").read_bytes())[1][idx]
    calls = []
    orig = sao_cuda.sao_plane_fused

    def record(*args, **kw):
        out = orig(*args, **kw)
        calls.append((args, kw, out))
        return out

    monkeypatch.setattr(sao_cuda, "sao_plane_fused", record)
    pipeline.reconstruct(prog, device="cpu")
    assert len(calls) == 3
    changed = 0
    for args, kw, out in calls:
        a = [t.numpy() for t in args]
        want = sao_plane_via_pallas(*a, bit_depth=kw["bit_depth"],
                                    edge_ok=kw["edge_ok"], interpret=True)
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))
        changed += int((out.numpy() != a[0]).sum())
    assert changed
