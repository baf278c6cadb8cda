"""The metric readers' arithmetic: a rate over all the window, the
layers' means, and the rooflines' work counted from the picture."""
import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(1, str(ROOT))

from gbench import driver, peaks, profiling, spec, stats, streams  # noqa

import _tiny  # noqa: E402


def _run(**kw):
    r = driver.Run(seed=1, seconds=1.0, trace=True, device="cpu", config={},
                   mix={})
    r.window = driver.Window(**kw.pop("window", {}))
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def test_fps_is_every_picture_over_all_the_window():
    r = _run(window=dict(wall_s=2.5, pictures=96,
                         latencies_s=[0.5, 0.5, 0.5, 1.0]))
    assert spec.reader("fps").read(r) == pytest.approx(96 / 2.5)
    with pytest.raises(ValueError):
        stats.rate(1, 0)


COPIES = [m["name"] for m in _tiny.bench()["per_layer"]
          if m["name"].endswith(_tiny.NOFPS) or m["name"] == "fps.unbounded"]


@pytest.mark.parametrize("name", COPIES)
def test_a_copy_reads_with_its_base_reader(name):
    """fps.unbounded is fps, and each .nofps metric its base, read in the
    cells that report fps per layer only: the copy's read is the base
    file's, and the copy lists none of the base's cells."""
    base = "fps" if name == "fps.unbounded" else name.removesuffix(
        _tiny.NOFPS)
    read = spec.reader(name).read
    assert read.__globals__["__file__"] == spec.reader(base).__file__
    r = _run(window=dict(wall_s=2.5, pictures=96))
    assert read(r) == spec.reader(base).read(r)
    b = _tiny.bench()
    ms = {m["name"]: m for m in b["end_to_end"] + b["per_layer"]}
    assert not set(ms[name]["workloads"]) & set(ms[base]["workloads"])


def test_requests_of_each_kind():
    """A clip request is the whole clip every time; segment requests come
    in rounds that each visit every segment once, in seeded orders."""
    clip = streams.Clip(segments=[b"a", b"b", b"c"], order=[0, 1, 2],
                        data=b"abc", pictures=3, encode_s=0.0, cached=True,
                        workers=0)
    assert driver.request_streams({"request": "clip"}, clip) == [b"abc"]
    order = driver.request_order({"request": "clip"}, 1, 5)
    assert [next(order) for _ in range(4)] == [0, 0, 0, 0]
    mix = {"request": "segment"}
    assert driver.request_streams(mix, clip) == [b"a", b"b", b"c"]
    order = driver.request_order(mix, 3, 2**31 + 9)
    rounds = [[next(order) for _ in range(3)] for _ in range(6)]
    assert all(sorted(r) == [0, 1, 2] for r in rounds)
    assert len({tuple(r) for r in rounds}) > 1
    again = driver.request_order(mix, 3, 2**31 + 9)
    assert [next(again) for _ in range(18)] == sum(rounds, [])
    with pytest.raises(ValueError):
        driver.request_streams({"request": "picture"}, clip)


def test_overlap_ratio_and_stage_means():
    probe = driver.Probe(parse_s=0.40, pictures=10,
                         decode_s=[0.03] * 10, wire_bytes=[100, 300, None])
    r = _run(window=dict(wall_s=2.0, pictures=40), probe=probe)
    assert spec.reader("parse_ms").read(r) == pytest.approx(40.0)
    assert spec.reader("decode_ms").read(r) == pytest.approx(30.0)
    assert spec.reader("overlap_ratio").read(r) == pytest.approx(50 / 40)
    assert spec.reader("h2d_bytes").read(r) == pytest.approx(200.0)
    r = _run(window=dict(wall_s=2.0, pictures=40, parse_s=[0.1, 0.3]))
    assert spec.reader("gop_parse_share").read(r) == pytest.approx(20.0)


def test_readers_without_their_source_read_nothing():
    r = _run(window=dict(wall_s=1.0, pictures=1))
    for name in ("parse_ms", "decode_ms", "overlap_ratio", "h2d_bytes",
                 "gop_parse_share", "device_idle_share", "mc_roofline",
                 "intra_scan_roofline", "device_mem_gib"):
        assert spec.reader(name).read(r) is None, name


def test_idle_share_from_the_union_of_intervals():
    class E:
        def __init__(self, s, e, name, cuda):
            from torch.autograd import DeviceType
            self.time_range = type("T", (), {"start": s, "end": e})
            self.name = name
            self.device_type = DeviceType.CUDA if cuda else DeviceType.CPU
    ev = [E(0, 100, "a", True), E(50, 150, "b", True), E(300, 400, "a", True),
          E(140, 320, "FusedDecoder.decode", False),
          E(220, 230, "aten::copy_", False)]
    tr = profiling.read(ev, window_s=0.001)
    assert tr.busy_s == pytest.approx(250e-6)
    assert tr.device_s == pytest.approx({"a": 200e-6, "b": 100e-6})
    assert tr.gaps_s == pytest.approx({"aten::copy_": 150e-6})
    r = _run(trace_data=tr)
    assert spec.reader("device_idle_share").read(r) == pytest.approx(75.0)
    ev[-1] = E(200, 210, "aten::copy_", False)     # over before the middle
    assert profiling.read(ev, 0.001).gaps_s == pytest.approx(
        {"FusedDecoder.decode": 150e-6})
    assert profiling.read([E(0, 1, "x", False)], 1.0) is None


@pytest.fixture(scope="module")
def programs(tmp_path_factory):
    from libde265_tpu_torch import Decoder, _native
    lib = Path(_native.build_tree()) / "libtde265.so"
    cfg = _tiny.tiny_config("b1080_ra")
    clip = streams.clip_for(tmp_path_factory.mktemp("c"), lib, cfg, 9,
                            workers=2)
    dec = Decoder(parse_only=True, keep_programs=True)
    list(dec.decode_all(clip.data))
    return [dec.get_program(i) for i in range(dec.num_programs())]


def _recast(rec, dtype):
    return {k: rec[k].astype(dtype) for k in rec.dtype.names}


def test_mc_work_from_the_picture(programs):
    mc = spec.reader("mc_roofline")
    inter = [p for p in programs if len(p.pus)]
    assert inter and not len(programs[0].pus)
    for p in inter:
        b, o = mc.pu_work(p.pus)
        assert b > 0 and o > 0
        assert mc.pu_work(_recast(p.pus, np.int64)) == (b, o)
        assert mc.pu_work(_recast(p.pus, np.int32)) == (b, o)
    one = np.zeros(1, programs[1].pus.dtype)
    one["w"], one["h"], one["pred_flags"] = 16, 8, 1
    # integer vector: read and write each sample once, 3 ops a sample
    assert mc.pu_work(one) == (2 * (16 * 8 + 2 * 8 * 4), 3 * (16 * 8 + 64))
    one["mv0x"] = 1
    b, o = mc.pu_work(one)
    assert b == 16 * 8 + 64 + 23 * 8 + 2 * 11 * 4
    assert o == 3 * 192 + 16 * 16 * 8 + 16 * 8 * 4


def test_intra_work_from_the_picture(programs):
    ir = spec.reader("intra_scan_roofline")
    p = programs[0]
    b, o = ir.intra_work(p.intras, p.tus)
    assert b > 0 and o > 0
    assert ir.intra_work(_recast(p.intras, np.int64),
                         _recast(p.tus, np.int32)) == (b, o)


def test_roofline_share_of_a_trace(programs):
    mc = spec.reader("mc_roofline")
    tr = profiling.Trace(busy_s=1e-3, window_s=1e-2,
                         device_s={"mc_kernel(int const*)": 1e-3,
                                   "paint_kernel(int)": 1e-4,
                                   "deblock_kernel": 5.0})
    r = _run(trace_data=tr, traced_programs=programs)
    share = mc.read(r)
    nbytes = sum(mc.pu_work(p.pus)[0] for p in programs)
    ops = sum(mc.pu_work(p.pus)[1] for p in programs)
    assert share == pytest.approx(100 * peaks.least_seconds(nbytes, ops)
                                  / 1.1e-3)
    assert 0 < share < 100
    assert spec.reader("intra_scan_roofline").read(r) is None
