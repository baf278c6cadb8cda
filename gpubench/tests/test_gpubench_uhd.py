"""The 4K configuration ``uhd2160_ra``, its cell ``uhd2160_ra.stream`` and
the one reader it adds, ``parse_threads`` (the counter the program notes
on ``tde.request``); the cell reports the accepted per-layer metrics of
the stream cells, listed in their ``workloads``.  A clip of its own
(192x128, CTB 32, so 4 WPP rows) holds WPP rows and QP groups; the cell's
whole runs, with the control and the faults, are those of
``test_gpubench_run.py`` over its tiny copy."""
import copy
import json
import os
import sys
import types
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(ROOT))

from gbench import driver, profiling, spec, streams  # noqa: E402

CELL = "uhd2160_ra.stream"
SEED = 2**31 + 1818


def _run(**kw):
    r = driver.Run(seed=1, seconds=1.0, trace=True, device="cpu", config={},
                   mix={})
    for k, v in kw.items():
        setattr(r, k, v)
    return r


def tiny_uhd() -> dict:
    cfg = copy.deepcopy(json.loads(
        (BENCH / "configs" / "uhd2160_ra.json").read_text()))
    cfg.update(name="tiny_uhd", width=192, height=128, segments=2,
               pictures_per_segment=5)
    cfg["encoder"]["ctb-size"] = 32
    return cfg


def test_configuration_and_cell_load_by_name():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = {c["name"]: c for c in bench["configs"]}["uhd2160_ra"]
    cell = spec.cell(ROOT, CELL, False)
    cfg = cell.config
    assert (cfg["width"], cfg["height"], cfg["bit_depth"]) == (3840, 2160, 8)
    assert cfg["reduced"] == entry["reduced"] == [
        "keyint", "open-gop", "bframes", "qg-size", "weightp", "crf",
        "FramesToBeEncoded"]
    changed = [k for k in cfg["source_settings"]
               if cfg["source_settings"][k] != cfg["used_settings"][k]]
    assert sorted(changed) == sorted(cfg["reduced"])
    assert set(cfg["why_reduced"]) == set(cfg["reduced"])
    enc = cfg["encoder"]
    assert enc["wpp"] and enc["adaptive-qp"] and enc["sei-hash"]
    assert (enc["qp"], enc["ctb-size"], enc["num-refs"]) == (27, 64, 3)
    assert cfg["segments"] * cfg["pictures_per_segment"] == 64
    assert cell.workload["chips"] == 1 and cell.mix["entry"] == "pipelined"
    assert [m["name"] for m, _ in cell.metrics] == ["device_mem_gib",
                                                    "setup_s"]


def test_cell_reports_the_stream_metrics_and_parse_threads():
    """Every per-layer metric of b1080_ra.stream (none of GopParallelDecoder's
    gop_parse_share), then parse_threads, the one metric of this cell only."""
    per_layer = [m["name"] for m, _ in spec.cell(ROOT, CELL, True).metrics]
    ra = [m["name"] for m, _ in spec.cell(ROOT, "b1080_ra.stream",
                                          True).metrics]
    assert per_layer == ra + ["parse_threads"]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    m = {x["name"]: x for x in bench["per_layer"]}["parse_threads"]
    assert m == {"name": "parse_threads", "unit": "threads",
                 "better": "higher", "source": "program_counter",
                 "layer": "decoder", "moves": "device_mem_gib",
                 "workloads": [CELL]}


def test_parse_threads_reads_nothing_without_its_counter(monkeypatch):
    """None without a trace, from a program without spans, and from one
    whose tde.request Record notes no counter (a program before it)."""
    from libde265_tpu_torch import tracing
    pt = spec.reader("parse_threads")
    assert pt.read(_run()) is None
    tr = profiling.Trace(busy_s=0.0, window_s=1.0)
    rec = tracing.Record("tde.request", 1, 0, 1, 1, None, 1)
    monkeypatch.setattr(tracing, "records", lambda: [rec])
    assert pt.read(_run(trace_data=tr)) is None
    monkeypatch.setattr(tracing, "records",
                        lambda: [rec._replace(args={"parse_threads": 4})])
    assert pt.read(_run(trace_data=tr)) == 4
    old = types.SimpleNamespace(name="tde.request")     # a Record, no args
    monkeypatch.setattr(tracing, "records", lambda: [old])
    assert pt.read(_run(trace_data=tr)) is None
    monkeypatch.setitem(sys.modules, "libde265_tpu_torch.tracing", None)
    import libde265_tpu_torch
    monkeypatch.delattr(libde265_tpu_torch, "tracing", raising=False)
    assert pt.read(_run(trace_data=tr)) is None


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    from libde265_tpu_torch import _native
    lib = Path(_native.build_tree()) / "libtde265.so"
    return streams.clip_for(tmp_path_factory.mktemp("c"), lib, tiny_uhd(),
                            SEED, workers=2)


def test_tiny_clip_has_wpp_rows_and_qp_groups(clip):
    from libde265_tpu_torch import Decoder
    dec = Decoder(parse_only=True, keep_programs=True)
    list(dec.decode_all(clip.data))
    progs = [dec.get_program(i) for i in range(dec.num_programs())]
    assert len(progs) == 10 and progs[0].ctb_h == 4
    assert any(len(set(p.qp_y.ravel().tolist())) > 1 for p in progs)
    tr = profiling.Trace(busy_s=1e-3, window_s=1e-2,
                         device_s={"intra_scan_kernel(ScanArgs)": 1e-3})
    r = _run(trace_data=tr, traced_programs=progs)
    assert spec.reader("intra_scan_roofline").read(r) > 0


@pytest.mark.parametrize("cpus,workers", [(8, 6), (3, 0), (32, 6)])
def test_span_readers_under_a_cpu_profile(clip, monkeypatch, cpus, workers):
    """A PipelinedDecoder's decode of the tiny clip under a CPU profile:
    parse_threads reads the workers the rule gave the parse, and the span
    readers of the cell read a number each."""
    from torch.profiler import ProfilerActivity, profile

    from libde265_tpu_torch import FusedDecoder, PipelinedDecoder, tracing
    monkeypatch.setattr(os, "sched_getaffinity",
                        lambda pid: set(range(cpus)))
    fd = FusedDecoder(device="cpu")
    fd.use_pallas_mc = True
    pd = PipelinedDecoder(fused=fd)
    pd.warm(clip.data)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        pd.decode_stream(clip.data)
    try:
        assert pd.parse_threads == workers
        r = _run(trace_data=profiling.Trace(busy_s=0.0, window_s=1.0))
        assert spec.reader("parse_threads").read(r) == workers
        assert spec.reader("parse_busy_ms").read(r) > 0
        for name in ("parse_wait_ms", "pack_ms", "intra_ms", "deblock_ms"):
            assert spec.reader(name).read(r) >= 0, name
    finally:
        tracing.clear()
