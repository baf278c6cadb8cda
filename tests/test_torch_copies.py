"""The port's copies of the JAX package's JAX-free modules (``decoder``,
``encoder``, ``_native``, ``profiles``, ``ops.intra``) behave as the
originals: the same programs, field by field, the same encoded bytes, the
same tables and the same intra predictions."""
import dataclasses

import numpy as np
import pytest

import libde265_tpu
from libde265_tpu.models import profiles as jprofiles
from libde265_tpu.ops import intra as jintra

import libde265_tpu_torch as lt
from libde265_tpu_torch import profiles
from libde265_tpu_torch.ops import intra as pintra
from libde265_tpu_torch.ops import intra_wave

from _torch_common import gop_bytes


def _assert_same(a, b, where):
    """Recursive equality of program fields (arrays by dtype and value)."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def _programs(mod, data, **kw):
    dec = mod.Decoder(keep_programs=True, **kw)
    list(dec.decode_all(data))
    return [dec.get_program(i) for i in range(dec.num_programs())]


@pytest.mark.parametrize("parse_only", [False, True],
                         ids=["decode", "parse_only"])
@pytest.mark.parametrize("stream", ["p-sao", "tiles"])
def test_decoder_programs_equal(native_build, stream, parse_only):
    data = gop_bytes(stream)
    want = _programs(libde265_tpu, data, parse_only=parse_only)
    got = _programs(lt, data, parse_only=parse_only)
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert type(g).__module__ == "libde265_tpu_torch.decoder"
        # src: (the decoder that exported the program, its index)
        assert type(g.src[0]) is lt.Decoder
        _assert_same(g.src[1:], w.src[1:], f"picture {i} src")
        for f in dataclasses.fields(w):
            if f.name != "src":
                _assert_same(getattr(g, f.name), getattr(w, f.name),
                             f"picture {i} {f.name}")


@pytest.mark.parametrize("bit_depth", [8, 10])
def test_encoder_bytes_equal(native_build, bit_depth):
    rng = np.random.default_rng(bit_depth)
    dt = np.uint16 if bit_depth > 8 else np.uint8
    frames = [rng.integers(0, 1 << bit_depth, (48, 64)).astype(dt)
              for _ in range(3)]
    out = []
    for mod in (libde265_tpu, lt):
        with mod.Encoder(qp=32, ctb_size=32, bit_depth=bit_depth) as enc:
            enc.set_parameter("intra-period", 2)
            out.append(b"".join(enc.encode(y) for y in frames) +
                       enc.finish())
    assert len(out[0]) > 0 and out[0] == out[1]


def test_angle_tables_equal():
    for got, want in ((intra_wave.ANGLE, jintra.ANGLE),
                      (intra_wave.INV_ANGLE, jintra.INV_ANGLE),
                      (pintra.ANGLE, jintra.ANGLE),
                      (pintra.INV_ANGLE, jintra.INV_ANGLE)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bit_depth", [8, 10])
def test_intra_module_equal(bit_depth):
    """ops.intra: the port's copy predicts every block as the JAX
    module's does (fill_border, filter_border and predict_block, every
    mode, size and plane kind, luma strong smoothing on and off), with the
    same IntraContext availability (slices, tiles, constrained intra)."""
    rng = np.random.default_rng(bit_depth)
    H, W, ctb = 64, 96, 32
    cu_info = rng.integers(0, 2, (H // 4, W // 4)).astype(np.uint8)
    slice_addr = np.array([[0, 0, 0], [3, 3, 3]])
    tile_id = np.array([[0, 0, 1], [0, 0, 1]])
    for kw in ({}, {"constrained": True, "strong_smoothing": False},
               {"slice_addr": slice_addr, "tile_id": tile_id}):
        ctxs = [m.IntraContext(W, H, ctb, cu_info, **kw)
                for m in (pintra, jintra)]
        for _ in range(24):
            nT = int(rng.choice([4, 8, 16, 32]))
            x0 = int(rng.integers(0, (W - nT) // 4 + 1)) * 4
            y0 = int(rng.integers(0, (H - nT) // 4 + 1)) * 4
            cidx = int(rng.integers(0, 2))
            plane = rng.integers(0, 1 << bit_depth, (H, W)).astype(np.int32)
            assert all(ctxs[0].available(x0, y0, x0 - 1, y0 + k) ==
                       ctxs[1].available(x0, y0, x0 - 1, y0 + k)
                       for k in range(-1, 2 * nT))
            borders = [m.fill_border(plane, c, x0, y0, nT, cidx, 1, 1,
                                     bit_depth)
                       for m, c in zip((pintra, jintra), ctxs)]
            np.testing.assert_array_equal(*borders)
            for strong in (False, True):
                np.testing.assert_array_equal(
                    pintra.filter_border(borders[0], nT, bit_depth, strong),
                    jintra.filter_border(borders[1], nT, bit_depth, strong))
            for mode in range(35):
                out = []
                for m, c in zip((pintra, jintra), ctxs):
                    p = plane.copy()
                    m.predict_block(p, c, x0, y0, nT, cidx, mode, 1, 1,
                                    bit_depth, chroma444=cidx == 1)
                    out.append(p)
                np.testing.assert_array_equal(*out)


@pytest.mark.parametrize("size", [(416, 240), (1920, 1088), (3840, 2160)])
def test_profiles_level_equal(size):
    for fps in (25.0, 60.0):
        assert dataclasses.astuple(profiles.min_level_for(*size, fps)) == \
            dataclasses.astuple(jprofiles.min_level_for(*size, fps))
