"""Intra records of programs without the native intra plan (prog.ip None):
feed._plan_intra, the port of the JAX package's list scheduler.

* its records equal the JAX package's _plan_intra and the port's records
  from the native plan (_intra_records_native) word for word, with the
  step counts, on every picture of every GOP of _torch_common.GOPS;
* FusedDecoder decodes such programs bit-exact in both formulations: with
  no live native source they are packed by numpy (the records from
  _plan_intra); with one, the production formulation still packs them
  natively (the native packer reads its own plan), as the JAX package
  dispatches;
* plan_stream sizes the same watermarks from _plan_intra as from the
  native plan;
* ShardedTileDecoder decodes such programs too, as the JAX package's.
"""
import dataclasses
import functools

import numpy as np
import pytest

from libde265_tpu import fused_decode as jfd

from libde265_tpu_torch import FusedDecoder, feed

from _torch_common import GOPS, gop_bytes, programs

FORMULATIONS = {"production": True, "per-cell": False}


@functools.lru_cache(maxsize=None)
def _programs(name):
    return programs(gop_bytes(name))[1]


def _no_plan(progs, keep_src=False):
    return [dataclasses.replace(p, ip=None,
                                src=p.src if keep_src else None)
            for p in progs]


@pytest.mark.parametrize("name", list(GOPS))
def test_records_equal_jax_and_native(native_build, name):
    n = 0
    for i, prog in enumerate(_programs(name)):
        if not len(prog.intras):
            continue
        _, tl, tr = feed._bin_tus(prog)
        got = feed._plan_intra(prog, tl, tr)
        _, jtl, jtr = jfd._bin_tus(prog)
        for what, want in (("jax", jfd._plan_intra(prog, jtl, jtr)),
                           ("native", feed._intra_records_native(prog))):
            np.testing.assert_array_equal(got[0], want[0],
                                          err_msg=f"{what} {i}")
            assert got[1] == want[1], (what, i)
            np.testing.assert_array_equal(got[2], want[2])
        # the dispatch: no native plan -> _plan_intra
        np.testing.assert_array_equal(
            feed._intra_records(_no_plan([prog])[0], tl, tr)[0], got[0])
        n += 1
    assert n


@pytest.mark.parametrize("form", list(FORMULATIONS))
@pytest.mark.parametrize("name", ["p-sao", "all-intra", "tiles", "10bit"])
def test_decode_without_native_plan(native_build, name, form):
    progs = _programs(name)
    fd = FusedDecoder(device="cpu")
    fd.use_pallas_mc = FORMULATIONS[form]
    bare = _no_plan(progs)
    fd.plan_stream(bare)
    for i, (prog, p) in enumerate(zip(progs, bare)):
        got = fd.decode(p)
        for c in range(3):
            np.testing.assert_array_equal(got[c].numpy(), prog.planes[c],
                                          err_msg=f"{name} {i} {c}")
    assert (fd.packer.numpy_packs, fd.packer.native_packs) == (len(progs), 0)


def test_live_source_still_packs_natively(native_build):
    """prog.ip None with a live native source: the production formulation
    packs natively, as JAX does (the native packer plans intra itself)."""
    progs = _programs("p-sao")
    fd = FusedDecoder(device="cpu")
    fd.use_pallas_mc = True
    for prog, p in zip(progs, _no_plan(progs, keep_src=True)):
        got = fd.decode(p)
        for c in range(3):
            np.testing.assert_array_equal(got[c].numpy(), prog.planes[c])
    assert (fd.packer.native_packs, fd.packer.numpy_packs) == (len(progs), 0)


@pytest.mark.parametrize("form", list(FORMULATIONS))
def test_plan_stream_watermarks(native_build, form):
    """The steps and intra-block watermarks planned from _plan_intra equal
    those planned from the native plan."""
    progs = _programs("tiles")
    caps = []
    for pp in (progs, _no_plan(progs)):
        pk = feed.FeedPacker()
        pk.plan_stream(pp, pallas_mc=FORMULATIONS[form])
        caps.append((pk.caps["steps"], pk.caps["nintra"],
                     sorted(pk.intra_lgs)))
    assert caps[0] == caps[1] and caps[0][0] > 0


def test_sharded_tile_decoder_without_native_plan(native_build):
    """ShardedTileDecoder schedules the whole picture's records with
    _plan_intra when the program has no native plan, as the JAX package's
    does (libde265_tpu/parallel/sharded_decode.py), and decodes the tiled
    stream of tests/test_sharded_decode.py (128x128, 2x2 tiles, filtered
    across them) bit-exact."""
    from libde265_tpu_torch.parallel import ShardedTileDecoder, make_mesh
    from test_sharded_decode import _make_stream
    progs = programs(_make_stream(True, W=128, H=128, cols=2, rows=2,
                                  frames=3))[1]
    sd = ShardedTileDecoder(make_mesh(devices=["cpu"] * 4))
    for i, (prog, p) in enumerate(zip(progs, _no_plan(progs))):
        got = sd.decode(p)
        for c in range(3):
            np.testing.assert_array_equal(got[c].cpu().numpy(),
                                          prog.planes[c],
                                          err_msg=f"{i} {c}")
