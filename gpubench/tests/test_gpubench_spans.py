"""The readers of the program's spans (``source`` ``program_span``): None
without a profiled stretch and with a program that has no spans; under a
CPU profile of a tiny decode, the span's self ms a picture that
``libde265_tpu_torch.tracing.summary()`` gives."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from gbench import driver, profiling, spec  # noqa: E402

import _tiny  # noqa: E402

SPANS = {"pack_ms": "tde.pack", "upload_ms": "tde.upload",
         "unpack_ms": "tde.unpack", "gather_ms": "tde.gather",
         "mc_ms": "tde.mc", "residual_ms": "tde.residual",
         "intra_ms": "tde.intra", "deblock_ms": "tde.deblock",
         "sao_ms": "tde.sao", "decode_other_ms": "tde.decode",
         "parse_wait_ms": "tde.stream.wait", "parse_busy_ms": "tde.parse"}


def _run(trace_data):
    r = driver.Run(seed=1, seconds=1.0, trace=True, device="cpu", config={},
                   mix={})
    r.trace_data = trace_data
    return r


def _stream(n=4, w=96, h=64):
    from libde265_tpu_torch.encoder import Encoder
    yy, xx = np.mgrid[0:h, 0:w]
    with Encoder(qp=30, ctb_size=32) as enc:
        enc.set_parameter("intra-period", 2)
        data = b""
        for t in range(n):
            y = ((xx * 3 + yy * 2 + 7 * t) % 220 + 10).astype(np.uint8)
            cb = ((xx[::2, ::2] + 5 * t) % 200 + 20).astype(np.uint8)
            cr = ((yy[::2, ::2] * 2 - 3 * t) % 200 + 20).astype(np.uint8)
            data += enc.encode(y, cb, cr, pts=t)
        return data + enc.finish()


@pytest.fixture(scope="module")
def profiled():
    """A PipelinedDecoder's decode of a tiny stream on the CPU (the
    production formulation) under torch.profiler; the Records stay until
    the module's tests are done."""
    from torch.profiler import ProfilerActivity, profile

    from libde265_tpu_torch import FusedDecoder, PipelinedDecoder, tracing
    data = _stream()
    fd = FusedDecoder(device="cpu")
    fd.use_pallas_mc = True
    pd = PipelinedDecoder(fused=fd)
    pd.warm(data)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        pd.decode_stream(data)
    yield tracing.summary()
    tracing.clear()


def test_entries_of_the_span_metrics():
    """Each span metric is listed by one rule (``_tiny.span_workloads``):
    the cells that report its rate (fps, or fps.unbounded for a ``.nofps``
    copy), less the parse spans' in GopParallelDecoder's cells; it moves
    fps, and a copy what fps.unbounded moves."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    ms = {m["name"]: m for m in bench["per_layer"]
          if m["source"] == "program_span"}
    assert {n.removesuffix(_tiny.NOFPS) for n in ms} == set(SPANS)
    layer = {m["name"]: m for m in bench["per_layer"]}
    for name, m in ms.items():
        rate = _tiny.rate_metric(name)
        moves = layer[rate]["moves"] if rate in layer else rate
        assert (m["unit"], m["better"], m["moves"]) == ("ms", "lower", moves)
        want = _tiny.span_workloads(bench, name)
        assert sorted(m["workloads"]) == sorted(want), name
        assert len(set(m["workloads"])) == len(m["workloads"])


@pytest.mark.parametrize("name", list(SPANS))
def test_none_without_a_profiled_stretch(name):
    assert spec.reader(name).read(_run(None)) is None


@pytest.mark.parametrize("name", list(SPANS))
def test_none_from_a_program_without_spans(name, monkeypatch):
    import libde265_tpu_torch
    monkeypatch.delattr(libde265_tpu_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "libde265_tpu_torch.tracing", None)
    tr = profiling.Trace(busy_s=0.0, window_s=1.0)
    assert spec.reader(name).read(_run(tr)) is None


@pytest.mark.parametrize("name", list(SPANS))
def test_self_ms_a_picture(profiled, name):
    n = profiled["tde.decode"]["count"]
    assert n == 4
    got = spec.reader(name).read(_run(profiling.Trace(busy_s=0.0,
                                                      window_s=1.0)))
    want = profiled.get(SPANS[name], {}).get("self_ms", 0.0) / n
    assert got == pytest.approx(want)
    if name != "parse_wait_ms":     # the parse may outrun every picture
        assert got > 0
