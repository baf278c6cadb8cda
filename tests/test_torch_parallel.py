"""The port's libde265_tpu_torch.parallel: the segment splitter and the
GOP-parallel decoder, the mesh, the row/column-sharded filter pipeline and
the data-parallel residual batch.

On the CPU the mesh entries are "cpu" devices (repeats allowed); the JAX
counterparts run on the virtual 8-device CPU platform of conftest.py.  The
streams are tests/test_gop_parallel.py's (12 frames, IDR every 3) and an
open-GOP one whose intra pictures after the first are CRA.  The gpu tests
run the same on the card with several entries of one CUDA device and
count the kernel launches.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libde265_tpu.encoder import Encoder
from libde265_tpu.ops.deblock import _luma_pass as jax_luma_pass
from libde265_tpu.parallel.gop_parallel import \
    split_segments as jax_split_segments

import libde265_tpu_torch as lt
from libde265_tpu_torch.ops import coef_cuda, deblock_cuda, sao_cuda
from libde265_tpu_torch.ops.deblock_cuda import luma_pass
from libde265_tpu_torch.parallel import (GopParallelDecoder, make_mesh,
                                         shard_residual_batch,
                                         sharded_filter_pipeline,
                                         split_segments)
from libde265_tpu_torch.parallel.tiles import split_sizes

from _torch_common import cuda, programs  # noqa: F401
from test_gop_parallel import _stream


def _cra_stream(n_frames=9, period=3):
    """An open-GOP P stream: intra pictures after the first are CRA."""
    enc = Encoder(qp=30, ctb_size=32)
    enc.set_parameter("intra-period", period)
    enc.set_parameter("open-gop", True)
    yy, xx = np.mgrid[0:48, 0:64]
    data = b""
    for t in range(n_frames):
        y = ((xx * 5 + yy + 7 * t) % 211 + 20).astype(np.uint8)
        data += enc.encode(y, pts=t)
    return data + enc.finish()


STREAMS = {"idr-every-3": _stream, "idr-every-4": lambda: _stream(12, 4),
           "open-gop-cra": _cra_stream}


@pytest.mark.parametrize("split_at_cra", [False, True])
@pytest.mark.parametrize("stream", list(STREAMS))
def test_split_segments_equals_jax(native_build, stream, split_at_cra):
    data = STREAMS[stream]()
    got = split_segments(data, split_at_cra)
    assert got == jax_split_segments(data, split_at_cra)
    if stream == "open-gop-cra":
        assert len(got) == (3 if split_at_cra else 1)
    else:
        assert len(got) == 12 // int(stream[-1])


def _assert_oracle(outs, data):
    _, progs = programs(data)
    assert len(outs) == len(progs)
    for i, (planes, prog) in enumerate(zip(outs, progs)):
        for c, pl in enumerate(planes):
            np.testing.assert_array_equal(pl.cpu().numpy(), prog.planes[c],
                                          err_msg=f"frame {i} plane {c}")


def test_gop_parallel_bit_exact(native_build):
    """Four segments on four "cpu" entries, in segment order: the oracle's
    planes, segment i on entry i."""
    data = _stream()
    gp = GopParallelDecoder(["cpu"] * 4)
    outs = gp.decode_stream(data)
    _assert_oracle(outs, data)
    assert gp.last_assignment == [0, 1, 2, 3]
    assert gp.last_parse_s > 0


def test_gop_parallel_round_robin_and_cra(native_build):
    """Three CRA segments over two entries: round robin, and each CRA
    segment decodes on its own."""
    data = _cra_stream()
    gp = GopParallelDecoder(["cpu", "cpu"], split_at_cra=True)
    _assert_oracle(gp.decode_stream(data), data)
    assert gp.last_assignment == [0, 1, 0]


def test_no_cpu_fallback():
    """Without CUDA and without devices= both raise; the JAX make_mesh
    falls back to the host CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is here: the defaults find it")
    with pytest.raises(RuntimeError, match="need 4 devices, have 0"):
        make_mesh(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GopParallelDecoder()


def test_mesh():
    mesh = make_mesh(3, devices=["cpu"] * 4)
    assert mesh.size == 3 and mesh.axis_names == ("tiles",)
    assert all(d == torch.device("cpu") for d in mesh.devices)
    with pytest.raises(RuntimeError, match="need 5 devices, have 4"):
        make_mesh(5, devices=["cpu"] * 4)
    assert lt.make_mesh is make_mesh
    assert split_sizes(1928, 4) == [484, 484, 480, 480]
    assert split_sizes(10, 4) == [4, 4, 2, 0]


def _filter_inputs(n, seed=5):
    """tests/test_parallel.py's inputs: a 32n x 264 padded plane, random
    bS, fixed beta/tc."""
    H, W = 32 * n, 256
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (H, W + 8), dtype=np.int32)
    Ev, Eh = W // 8, H // 8
    bs_v = rng.integers(0, 3, (H // 4, Ev), dtype=np.int32)
    bs_h = rng.integers(0, 3, ((W + 8) // 4, Eh), dtype=np.int32)
    v = [bs_v, np.full(bs_v.shape, 48, np.int32),
         np.full(bs_v.shape, 6, np.int32), np.zeros(bs_v.shape, np.int32),
         np.zeros(bs_v.shape, np.int32)]
    h = [bs_h, np.full(bs_h.shape, 48, np.int32),
         np.full(bs_h.shape, 6, np.int32), np.zeros(bs_h.shape, np.int32),
         np.zeros(bs_h.shape, np.int32)]
    return [img] + v + h


def _single(args):
    v = luma_pass(*args[:6], bit_depth=8)
    return luma_pass(v.T.contiguous(), *args[6:], bit_depth=8).T


@pytest.mark.parametrize("n_dev", [8, 3])
def test_sharded_filter_pipeline(native_build, n_dev):
    """8 row shards (and 3 uneven ones) equal the port's single-device
    composition and the JAX package's _luma_pass composition."""
    arrs = _filter_inputs(8)
    args = [torch.from_numpy(a) for a in arrs]
    fn = sharded_filter_pipeline(make_mesh(devices=["cpu"] * n_dev))
    got = fn(*args).numpy()
    np.testing.assert_array_equal(got, _single(args).numpy())
    ja = [jnp.asarray(a) for a in arrs]
    v = jax_luma_pass(*ja[:6], bit_depth=8)
    want = np.asarray(jax_luma_pass(v.T, *ja[6:], bit_depth=8)).T
    np.testing.assert_array_equal(got, want)


def test_shard_residual_batch():
    """Each array split along dim 0 into one chunk per entry (the first
    chunks one row longer), chunk i on entry i."""
    mesh = make_mesh(devices=["cpu"] * 3)
    rng = np.random.default_rng(1)
    levels = torch.from_numpy(rng.integers(-9, 9, (10, 4, 4), np.int32))
    fact = torch.arange(10, dtype=torch.int32)
    tskip = fact % 2 == 0
    use_dst = fact % 3 == 0
    out = shard_residual_batch(mesh, levels, fact, tskip, use_dst)
    assert len(out) == 4
    for whole, chunks in zip((levels, fact, tskip, use_dst), out):
        assert [len(c) for c in chunks] == [4, 3, 3]
        assert all(c.device == d for c, d in zip(chunks, mesh.devices))
        assert torch.equal(torch.cat(chunks), whole)


@pytest.mark.gpu
def test_gop_parallel_on_card(cuda, native_build):  # noqa: F811
    """Two entries of the card: the oracle's planes on the card, each
    picture one B8, one B9 and three B10 launches, B4 in the pictures
    with residuals."""
    data = _stream()
    deblock_cuda.luma_launches = deblock_cuda.chroma_launches = 0
    sao_cuda.launches = coef_cuda.launches = 0
    gp = GopParallelDecoder(["cuda:0"] * 2)
    outs = gp.decode_stream(data)
    torch.cuda.synchronize()
    assert all(p.is_cuda for planes in outs for p in planes)
    _assert_oracle(outs, data)
    assert gp.last_assignment == [0, 1, 0, 1]
    assert (deblock_cuda.luma_launches, deblock_cuda.chroma_launches,
            sao_cuda.launches) == (12, 12, 36)
    assert coef_cuda.launches > 0


@pytest.mark.gpu
def test_sharded_filter_pipeline_on_card(cuda):  # noqa: F811
    """4 row shards on the card: B8 once per shard and pass, equal to the
    single-device composition on the card and to the CPU's."""
    args = [torch.from_numpy(a) for a in _filter_inputs(8)]
    dargs = [a.to(cuda) for a in args]
    fn = sharded_filter_pipeline(make_mesh(devices=["cuda:0"] * 4))
    deblock_cuda.luma_launches = 0
    got = fn(*dargs)
    torch.cuda.synchronize()
    assert deblock_cuda.luma_launches == 8
    assert torch.equal(got, _single(dargs))
    assert torch.equal(got.cpu(), _single(args))
