"""The port's ShardedTileDecoder: one tile of a picture per mesh entry.

Tiled streams of the in-repo encoder (tests/test_sharded_decode.py's:
256x64 with 4 tile columns, 128x128 with 2x2 and 256x128 with 2x4 tiles,
each with and without loop filtering across tiles) decode bit-exact
against the scalar oracle on "cpu" entries; the host-side partition
(tile grid, per-tile TU bins, localized intra records) equals the JAX
package's, and one halo-exchange case equals the JAX ShardedTileDecoder's
planes.  The JAX package's raises are kept, and the port raises where the
JAX package decodes wrong: more than MAX_REFS references (ROADMAP C10),
scaling lists, CCP and RDPCM, and a reference it does not hold with no
planes attached.  The gpu test decodes on the card with four
entries of one CUDA device and counts each picture's kernel launches.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from libde265_tpu.decoder import TU_RDPCM
from libde265_tpu.parallel import make_mesh as jax_make_mesh
from libde265_tpu.parallel import sharded_decode as jsd

from libde265_tpu_torch.feed import MAX_REFS
from libde265_tpu_torch.ops import (coef_cuda, deblock_cuda, intra_cuda,
                                    sao_cuda)
from libde265_tpu_torch.parallel import (ShardedTileDecoder, make_mesh,
                                         tile_columns, tile_grid)
from libde265_tpu_torch.parallel import sharded_decode as tsd

from _torch_common import cuda, programs, stripe_stream  # noqa: F401
from test_sharded_decode import _make_stream

# (rows, cols) of the tile grid -> (width, height, frames) of the stream
GRIDS = {(1, 4): (256, 64, 6), (2, 2): (128, 128, 4), (2, 4): (256, 128, 4)}


@functools.lru_cache(maxsize=None)
def _programs(grid, across, frames=None):
    R, C = grid
    W, H, n = GRIDS[grid]
    data = _make_stream(across, W=W, H=H, cols=C, rows=R,
                        frames=frames or n)
    return programs(data)[1]


def _assert_oracle(planes, prog, what):
    for c in range(3):
        got = planes[c].cpu().numpy()
        want = prog.planes[c].astype(np.int32)
        if not np.array_equal(got, want):
            bad = np.argwhere(got != want)
            raise AssertionError(f"{what} plane {c}: {len(bad)} differ, "
                                 f"first at {bad[0].tolist()}")


@pytest.mark.parametrize("across", [False, True],
                         ids=["gated", "halo-exchange"])
@pytest.mark.parametrize("grid", list(GRIDS), ids=["1x4", "2x2", "2x4"])
def test_sharded_tile_decode(native_build, grid, across):
    progs = _programs(grid, across)
    assert progs[0].across_tiles == across
    sd = ShardedTileDecoder(make_mesh(devices=["cpu"] * (grid[0] * grid[1])))
    for i, prog in enumerate(progs):
        _assert_oracle(sd.decode(prog), prog, f"frame {i}")


@pytest.mark.parametrize("grid", list(GRIDS), ids=["1x4", "2x2", "2x4"])
def test_tile_feeds_carry_packed_records(native_build, monkeypatch, grid):
    """Each tile program gets its localized intra records packed as the
    picture program's feed carries them (irecp, no flat irec) and the
    depth of each size bin from them; the tiles still equal the oracle."""
    from libde265_tpu_torch.feed import _pack_irec, bin_depths
    from libde265_tpu_torch.ops.intra_cuda import unpack_records
    from libde265_tpu_torch.parallel import sharded_decode as sdm
    calls, frame_fn = [], sdm._frame_fn

    def record(*args):
        calls.append((args[3], args[6]))
        return frame_fn(*args)

    monkeypatch.setattr(sdm, "_frame_fn", record)
    sd = ShardedTileDecoder(make_mesh(devices=["cpu"] * (grid[0] * grid[1])))
    for i, prog in enumerate(_programs(grid, True)):
        calls.clear()
        parts = sd._partition(prog)[0]
        _assert_oracle(sd.decode(prog), prog, f"frame {i}")
        assert len(calls) == len(parts)
        for (feed, host), pt in zip(calls, parts):
            assert "irec" not in feed and "irec" not in host
            irec = pt["irec"]
            np.testing.assert_array_equal(
                unpack_records(feed["irecp"].numpy()), irec)
            np.testing.assert_array_equal(
                feed["irecp"].numpy(), _pack_irec(irec))
            assert host["n_intra"] == len(irec) == len(prog.intras)
            np.testing.assert_array_equal(
                host["depths"], bin_depths(irec[:, 8], irec[:, 9],
                                           irec[:, 6]))


@pytest.mark.parametrize("grid", list(GRIDS), ids=["1x4", "2x2", "2x4"])
def test_partition_equals_jax(native_build, grid):
    """tile_grid, the per-tile TU bins and the localized intra records of
    every picture equal the JAX package's."""
    T = grid[0] * grid[1]
    tdec = ShardedTileDecoder(make_mesh(devices=["cpu"] * T))
    jdec = jsd.ShardedTileDecoder(jax_make_mesh(T))
    for i, prog in enumerate(_programs(grid, True)):
        assert tile_grid(prog) == jsd.tile_grid(prog)
        got, want = tdec._partition(prog), jdec._partition(prog)
        assert got[1:6] == want[1:6]
        for a, b in zip(got[6:], want[6:]):
            np.testing.assert_array_equal(a, b)
        for t, (g, w) in enumerate(zip(got[0], want[0])):
            assert {k: g[k] for k in "x0 x1 y0 y1".split()} == \
                {k: w[k] for k in "x0 x1 y0 y1".split()}
            np.testing.assert_array_equal(g["irec"], w["irec"])
            assert g["bins"].keys() == w["bins"].keys()
            for lg, b in g["bins"].items():
                keys = set(b) & set(w["bins"][lg])
                assert {"cv", "coff", "cfx", "cfv", "qp", "sc_y"} <= keys
                for k in keys:
                    np.testing.assert_array_equal(
                        b[k], w["bins"][lg][k],
                        err_msg=f"frame {i} tile {t} bin {lg} {k}")
    assert tile_columns(_programs((1, 4), False)[0]) == \
        [(0, 64), (64, 128), (128, 192), (192, 256)]
    with pytest.raises(ValueError, match="multiple tile rows"):
        tile_columns(_programs((2, 2), False)[0])


def test_localize_intra_recs_equals_jax(native_build):
    """The localized records of each tile of an I picture of the 2x4
    grid, from the whole-frame records."""
    prog = _programs((2, 4), False)[0]
    jdec = jsd.ShardedTileDecoder(jax_make_mesh(8))
    _, _, (th, tw), sub_x, sub_y, _, _, irec = jdec._partition(prog)
    tu_of = {lg: np.nonzero(prog.tus["log2_size"] == lg)[0]
             for lg in (2, 3, 4, 5)}
    rng = np.random.default_rng(3)
    tu_local_row = rng.integers(0, 50, len(prog.tus)).astype(np.int32)
    for t in range(8):
        args = (irec, t, th, tw, 2, 4, sub_x, sub_y, tu_of, tu_local_row)
        np.testing.assert_array_equal(tsd._localize_intra_recs(*args),
                                      jsd._localize_intra_recs(*args))


def test_halo_exchange_equals_jax_sharded_decoder(native_build):
    """An I and a P picture of the 1x4 halo-exchange stream: the port's
    planes equal the JAX ShardedTileDecoder's (and the oracle's)."""
    progs = _programs((1, 4), True, frames=2)
    jdec = jsd.ShardedTileDecoder(jax_make_mesh(4))
    tdec = ShardedTileDecoder(make_mesh(devices=["cpu"] * 4))
    for i, prog in enumerate(progs):
        want = [np.asarray(p) for p in jdec.decode(prog)]
        got = tdec.decode(prog)
        for c in range(3):
            np.testing.assert_array_equal(got[c].numpy(), want[c],
                                          err_msg=f"frame {i} plane {c}")
        _assert_oracle(got, prog, f"frame {i}")


def test_kept_raises(native_build):
    """The JAX package's raises: tile count against device count,
    non-uniform tiles, PCM, slice-gated filters with the halo exchange."""
    prog = _programs((1, 4), True)[0]
    with pytest.raises(ValueError, match=r"4 tiles \(1x4\) vs 2 devices"):
        ShardedTileDecoder(make_mesh(devices=["cpu"] * 2)).decode(prog)
    sd = ShardedTileDecoder(make_mesh(devices=["cpu"] * 4))
    uneven = programs(_make_stream(False, W=224, frames=1))[1][0]
    assert len({x1 - x0 for x0, x1 in tile_columns(uneven)}) > 1
    with pytest.raises(ValueError, match="non-uniform tile sizes"):
        sd.decode(uneven)
    pcm = dataclasses.replace(prog, pcms=np.zeros(1, np.int32))
    with pytest.raises(NotImplementedError, match="PCM"):
        sd.decode(pcm)
    recs = prog.slice_records.copy()
    recs[:, 9] = 0
    with pytest.raises(NotImplementedError, match="slice-gated"):
        sd.decode(dataclasses.replace(prog, slice_records=recs))


@pytest.mark.parametrize("feature", ["scaling", "ccp", "rdpcm"])
def test_unsupported_features_raise(native_build, feature):
    """The tile program has no scaling lists, CCP or RDPCM (the JAX
    package's sets none of them and decodes such a picture wrong)."""
    prog = _programs((1, 4), False)[1]
    tus = prog.tus.copy()
    if feature == "ccp":
        tus["cross_comp_scale"][tus["cidx"] == 1] = 1
        prog = dataclasses.replace(prog, tus=tus)
    elif feature == "rdpcm":
        tus["flags"] |= TU_RDPCM
        prog = dataclasses.replace(prog, tus=tus)
    else:
        prog = dataclasses.replace(prog, scaling_factors={})
    sd = ShardedTileDecoder(make_mesh(devices=["cpu"] * 4))
    with pytest.raises(NotImplementedError):
        sd.decode(prog)


def test_more_than_max_refs_raises(native_build):
    """C10: the stripe stream (one tile) decodes bit-exact up to picture
    8, which reads MAX_REFS references; picture 9 reads 9 and raises,
    where the JAX package maps the ninth to the first reference."""
    progs = programs(stripe_stream())[1]
    sd = ShardedTileDecoder(make_mesh(devices=["cpu"]))
    for i, prog in enumerate(progs[:MAX_REFS + 1]):
        _assert_oracle(sd.decode(prog), prog, f"picture {i}")
    assert len(progs[MAX_REFS + 1].ref_pocs) == MAX_REFS + 1
    with pytest.raises(NotImplementedError, match="9 references"):
        sd.decode(progs[MAX_REFS + 1])


def test_reference_not_held_reads_attached_planes_or_raises(native_build):
    """A P picture on a fresh decoder (a seek): its references come from
    the planes the parser attached, and the picture equals the oracle; a
    program without them raises RuntimeError, where the JAX package
    reads mid-gray."""
    prog = _programs((1, 4), False)[1]
    assert len(prog.pus) and len(prog.ref_pocs)
    sd = ShardedTileDecoder(make_mesh(devices=["cpu"] * 4))
    _assert_oracle(sd.decode(prog), prog, "seek")
    bare = dataclasses.replace(prog, ref_planes=[])
    with pytest.raises(RuntimeError, match="neither in the decoder's DPB"):
        ShardedTileDecoder(make_mesh(devices=["cpu"] * 4)).decode(bare)


@pytest.mark.gpu
@pytest.mark.parametrize("across", [False, True],
                         ids=["gated", "halo-exchange"])
def test_sharded_decode_on_card(cuda, native_build, across):  # noqa: F811
    """Four entries of the card on the 1x4 stream: the oracle's planes on
    the card; per picture one B8 and one B9 launch and three B10 launches
    per tile (in the tile program, or in the halo filter), B4 and the
    intra scan in the pictures that have residuals and intra blocks."""
    progs = _programs((1, 4), across)
    sd = ShardedTileDecoder(make_mesh(devices=["cuda:0"] * 4))
    scans = b4 = 0
    for i, prog in enumerate(progs):
        deblock_cuda.luma_launches = deblock_cuda.chroma_launches = 0
        sao_cuda.launches = coef_cuda.launches = intra_cuda.scan_launches = 0
        out = sd.decode(prog)
        torch.cuda.synchronize()
        assert all(p.is_cuda for p in out)
        _assert_oracle(out, prog, f"frame {i}")
        assert (deblock_cuda.luma_launches, deblock_cuda.chroma_launches,
                sao_cuda.launches) == (4, 4, 12), i
        scans += intra_cuda.scan_launches
        b4 += coef_cuda.launches
    assert scans >= 4 and b4 >= 4
