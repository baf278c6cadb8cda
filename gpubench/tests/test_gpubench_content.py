"""The content model and the encode are fixed by the seed; the reference
reads one hash a picture and agrees with a decoder that conforms."""
import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(1, str(ROOT))

from gbench import reference, streams  # noqa: E402
from gbench.content import Scene  # noqa: E402

import _tiny  # noqa: E402


def _lib():
    from libde265_tpu_torch import _native
    return Path(_native.build_tree()) / "libtde265.so"


def test_scene_is_a_function_of_the_seed():
    p = _tiny.tiny_config("b1080_ra")["content"]
    a, b = Scene(2**33 + 5, 64, 128, 8, p), Scene(2**33 + 5, 64, 128, 8, p)
    c = Scene(2**33 + 6, 64, 128, 8, p)
    for t in (0, 3, 7):
        fa, fb, fc = a.frame(t), b.frame(t), c.frame(t)
        assert all(np.array_equal(x, y) for x, y in zip(fa, fb))
        assert not np.array_equal(fa[0], fc[0])
        assert fa[0].shape == (64, 128) and fa[1].shape == (32, 64)
        assert fa[0].dtype == np.uint8
    assert not np.array_equal(a.frame(0)[0], a.frame(1)[0])


@pytest.mark.parametrize("like", _tiny.configs())
def test_encode_is_a_function_of_the_seed(tmp_path, like):
    """The segments come from the configuration's content seed; the run's
    seed draws only their order, so every seed decodes the same work."""
    cfg = _tiny.tiny_config(like)
    lib = _lib()
    one = streams.clip_for(tmp_path / "a", lib, cfg, 77, workers=2)
    two = streams.clip_for(tmp_path / "b", lib, cfg, 77, workers=2)
    again = streams.clip_for(tmp_path / "a", lib, cfg, 77)
    assert one.data == two.data == again.data and again.cached
    assert not one.cached and one.encode_s > 0 and again.encode_s == 0.0
    others = [streams.clip_for(tmp_path / "a", lib, cfg, s)
              for s in range(2**40, 2**40 + 6)]
    assert all(o.cached for o in others)
    assert all(sorted(o.segments) == sorted(one.segments) for o in others)
    assert len({o.data for o in others}) > 1
    assert len(one.segments) == cfg["segments"]
    assert sorted(one.order) == list(range(cfg["segments"]))
    hashes = reference.picture_hashes(one.data)
    assert len(hashes) == one.pictures
    assert all(len(h) == 3 for h in hashes)
    cfg2 = dict(cfg, content_seed=cfg["content_seed"] + 1)
    assert streams.clip_for(tmp_path / "a", lib, cfg2, 77,
                            workers=2).data != one.data


def test_reference_agrees_with_the_native_decoder(tmp_path):
    """The hashes the encoder wrote, against the planes of the repository's
    scalar decoder (a second witness of the expected pictures)."""
    from libde265_tpu_torch import Decoder
    cfg = _tiny.tiny_config("b1080_ra")
    clip = streams.clip_for(tmp_path, _lib(), cfg, 5, workers=2)
    hashes = reference.picture_hashes(clip.data)
    dec = Decoder(keep_programs=True)
    list(dec.decode_all(clip.data))
    assert dec.num_programs() == len(hashes)
    for i in range(dec.num_programs()):
        planes = dec.get_program(i).planes
        assert reference.judge(planes, hashes[i]) == 0
        bad = [p.astype(np.int32) for p in planes]
        bad[2][1, 1] ^= 1
        assert reference.judge(bad, hashes[i]) == 1
        bad[0][0, 0] = 256
        assert reference.judge(bad, hashes[i]) == 2


def test_sei_reader_on_emulation_prevention():
    assert reference.rbsp(b"\x50\x01\x00\x00\x03\x01\x00\x00\x03") == \
        b"\x00\x00\x01\x00\x00"
    units = reference.nal_units(b"\x00\x00\x00\x01\x40\x01\xaa"
                                b"\x00\x00\x01\x42\x01\xbb")
    assert [t for t, _ in units] == [32, 33]
