"""Cross-component prediction (CCP) and RDPCM in the port, bit-exact.

* CCP end to end: 4:4:4 streams encoded with the port's Encoder and "ccp"
  on, lossless and lossy, four pictures with an intra period of 4, so
  that CCP rides intra TUs and inter TUs, chroma TUs with no coefficients
  of their own among them (they scatter their luma term as inter
  residual).  The port decodes them on the CPU in both formulations, every
  plane equal to the oracle (prog.planes) and to the JAX FusedDecoder.
* The CCP expression alone (fused_decode.ccp_add) against the JAX
  program's expression on seeded inputs: negative luma residuals, bit
  depths that differ between luma and chroma, scales -8..8, full-range
  values where the 32-bit shifts and the product wrap.
* RDPCM: the programs of tests/test_rdpcm_fused.py, with TU_RDPCM (and,
  lossy, transform skip) injected into the TU records, and a corpus
  picture whose 4x4 TUs get transform skip and RDPCM, decoded by the port
  in both formulations against JAX's pipeline.reconstruct and JAX's
  FusedDecoder.  The injection edits prog.tus, which the native packer
  does not read, so the programs go without their native source
  (src = None) and the numpy packer packs what was edited.

Tolerance 0 everywhere.  The gpu test decodes the CCP streams (packed by
numpy, with their CCP fields) and the RDPCM pictures on the card.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libde265_tpu import pipeline
from libde265_tpu.decoder import (TU_RDPCM, TU_RDPCM_VERTICAL, TU_TQ_BYPASS,
                                  TU_TRANSFORM_SKIP)
from libde265_tpu.fused_decode import FusedDecoder as JaxFusedDecoder

from libde265_tpu_torch import Encoder, FusedDecoder
from libde265_tpu_torch.fused_decode import ccp_add

from _torch_common import OWN_CORPUS, cuda, programs  # noqa: F401
from test_ccp import _monotone_444
from test_rdpcm_fused import _prog_with_rdpcm

MODES = {"lossless": (True, 27), "lossy": (False, 27)}


@functools.lru_cache(maxsize=None)
def ccp_stream(mode):
    """Four 64x64 4:4:4 pictures of a staircase moving 2 samples a
    picture (intra period 4), CCP on."""
    lossless, qp = MODES[mode]
    with Encoder(qp=qp, chroma_format="444") as enc:
        if lossless:
            enc.set_parameter("lossless", True)
        enc.set_parameter("ccp", True)
        enc.set_parameter("intra-period", 4)
        data = b"".join(enc.encode(*(np.roll(a, 2 * t, axis=1)
                                     for a in _monotone_444()))
                        for t in range(4))
        return data + enc.finish()


def _jax_planes(progs):
    jfd = JaxFusedDecoder()
    jfd.plan_stream(progs)
    return [[np.asarray(q) for q in jfd.decode(p)] for p in progs]


@functools.lru_cache(maxsize=None)
def ccp_case(mode):
    """The CCP stream's programs and the JAX FusedDecoder's planes."""
    _, progs = programs(ccp_stream(mode))
    return progs, _jax_planes(progs)


def _port_planes(progs, production, device="cpu"):
    fd = FusedDecoder(device=device)
    fd.use_pallas_mc = production
    fd.plan_stream(progs)
    return [[q.cpu().numpy() for q in fd.decode(p)] for p in progs], fd


@pytest.mark.parametrize("production", [False, True],
                         ids=["per-cell", "production"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_ccp_stream_bit_exact(native_build, mode, production):
    progs, want = ccp_case(mode)
    scaled = [int((p.tus["cross_comp_scale"] != 0).sum()) for p in progs]
    inter = [p for p in progs if len(p.pus)]
    assert scaled[0] > 10 and inter and sum(scaled[1:]) > 0, scaled
    got, fd = _port_planes(progs, production)
    assert fd.packer.has_ccp and fd.packer.native_packs == 0
    for i, p in enumerate(progs):
        for c in range(3):
            np.testing.assert_array_equal(got[i][c], p.planes[c],
                                          err_msg=f"{mode} {i} {c}")
            np.testing.assert_array_equal(got[i][c], want[i][c],
                                          err_msg=f"{mode} {i} {c}")


def _jax_ccp(res, rows, scale, bd, bdc):
    """The JAX picture program's CCP statement on one bin."""
    r_y = res[jnp.clip(rows, 0)]
    term = (r_y.astype(jnp.uint32) << bdc) >> bd
    prod = (scale.astype(jnp.uint32)[:, None, None] * term) \
        .astype(jnp.int32)
    return jnp.where((rows >= 0)[:, None, None], res + (prod >> 3), res)


@pytest.mark.parametrize("bd,bdc", [(8, 8), (8, 10), (10, 8), (12, 8),
                                    (8, 16), (16, 12)])
def test_ccp_expression_matches_jax(bd, bdc):
    rng = np.random.default_rng(bd * 100 + bdc)
    N, S = 40, 8
    res = rng.integers(-(1 << (bd + 1)), 1 << (bd + 1), (N, S, S))
    # a quarter of the TUs at full int32 range: the shifts and the
    # product wrap there
    res[: N // 4] = rng.integers(-(1 << 31), 1 << 31, (N // 4, S, S))
    res = res.astype(np.int32)
    rows = rng.integers(-1, N, N).astype(np.int32)
    rows[::5] = -1
    scale = rng.integers(-8, 9, N).astype(np.int32)
    assert (res < 0).any() and (rows < 0).any() and (scale < 0).any()
    want = np.asarray(_jax_ccp(jnp.asarray(res), jnp.asarray(rows),
                               jnp.asarray(scale), bd, bdc))
    got = ccp_add(torch.from_numpy(res), torch.from_numpy(rows),
                  torch.from_numpy(scale), bd, bdc)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _prog_with_rdpcm_ts4():
    """The first picture of the corpus stream rd_split_amp_sao (96x64,
    intra), whose coded 4x4 TUs get transform skip and TU_RDPCM,
    horizontal and vertical in turn: the lossy program of
    tests/test_rdpcm_fused.py codes no TU below 16x16, so its RDPCM flags
    never meet transform skip."""
    _, progs = programs((OWN_CORPUS / "rd_split_amp_sao.h265").read_bytes())
    prog = progs[0]
    tus = prog.tus
    sel = np.nonzero((tus["ncoeff"] > 0) & (tus["log2_size"] == 2))[0]
    assert len(sel) > 8 and not len(prog.pus)
    tus["flags"][sel] |= TU_RDPCM | TU_TRANSFORM_SKIP
    tus["flags"][sel[1::2]] |= TU_RDPCM_VERTICAL
    return prog


RDPCM = {"lossless": lambda: _prog_with_rdpcm(True),
         "lossy": lambda: _prog_with_rdpcm(False),
         "lossy-ts4": _prog_with_rdpcm_ts4}


@functools.lru_cache(maxsize=None)
def rdpcm_program(name):
    return dataclasses.replace(RDPCM[name](), src=None)


@functools.lru_cache(maxsize=None)
def rdpcm_refs(name):
    """pipeline.reconstruct's planes and the JAX FusedDecoder's."""
    prog = rdpcm_program(name)
    return ([np.asarray(q) for q in pipeline.reconstruct(prog)],
            _jax_planes([prog])[0])


@pytest.mark.parametrize("production", [False, True],
                         ids=["per-cell", "production"])
@pytest.mark.parametrize("name", sorted(RDPCM))
def test_rdpcm_injected_bit_exact(native_build, name, production):
    prog = rdpcm_program(name)
    want, jax = rdpcm_refs(name)
    (got,), fd = _port_planes([prog], production)
    assert fd.packer.has_rdpcm
    assert fd.packer.numpy_packs == 1 and fd.packer.native_packs == 0
    # a flag takes effect on a transform-skip or bypass TU, and then the
    # picture differs from the oracle's (decoded without the flags); the
    # lossy program has none
    f = prog.tus["flags"]
    live = ((f & TU_RDPCM) != 0) & ((f & (TU_TRANSFORM_SKIP |
                                         TU_TQ_BYPASS)) != 0)
    assert live.any() == (name != "lossy")
    assert live.any() == any(not np.array_equal(got[c], prog.planes[c])
                             for c in range(3))
    for c in range(3):
        np.testing.assert_array_equal(got[c], want[c], err_msg=str(c))
        np.testing.assert_array_equal(got[c], jax[c], err_msg=str(c))


@pytest.mark.gpu
def test_ccp_and_rdpcm_on_card(cuda, native_build):  # noqa: F811
    """FusedDecoder() on the card: the CCP streams packed by numpy with
    their CCP fields, the RDPCM pictures, each equal to its CPU reference
    (the oracle, pipeline.reconstruct)."""
    for mode in sorted(MODES):
        _, progs = programs(ccp_stream(mode))
        fd = FusedDecoder()
        names = []
        pack = fd.packer.pack

        def spy(*a, **k):
            out = pack(*a, **k)
            names.extend(n for n, _, _ in out[0])
            return out

        fd.packer.pack = spy
        fd.plan_stream(progs)
        for i, p in enumerate(progs):
            planes = fd.decode(p)
            for c in range(3):
                np.testing.assert_array_equal(planes[c].cpu().numpy(),
                                              p.planes[c],
                                              err_msg=f"{mode} {i} {c}")
        assert fd.packer.numpy_packs == len(progs)
        assert any(n.endswith(".ccp_row") for n in names)
        assert any(n.endswith(".ccp_scale") for n in names)
    for name in sorted(RDPCM):
        prog = rdpcm_program(name)
        want, _ = rdpcm_refs(name)
        (got,), _ = _port_planes([prog], True, device="cuda")
        for c in range(3):
            np.testing.assert_array_equal(got[c], want[c], err_msg=str(c))
