"""The port's spans (libde265_tpu_torch.tracing) on tiny streams, on the
CPU.

Off (no profiler recording), every span site returns the shared no-op and
nothing is recorded.  Under a CPU torch.profiler over
PipelinedDecoder.decode_stream, in both formulations: each picture is one
tde.decode holding the nine named sections, under the request's
tde.request, all of one request id; the parse thread's tde.parse spans
carry that id and have no profiler event; the self times add up to each
tde.decode; each calling-thread span matches its profiler event on the
profiler's absolute timeline; and the decoded planes are those of an
untraced decode.  Also the self-time arithmetic of summary(), the spans of
GopParallelDecoder and of a picture routed to pipeline.reconstruct.
"""
import statistics
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from libde265_tpu_torch import FusedDecoder, PipelinedDecoder, tracing
from libde265_tpu_torch.ops import mc_seg
from libde265_tpu_torch.parallel import GopParallelDecoder

from _torch_common import gop, gop_bytes, programs
from test_gop_parallel import _stream

SECTIONS = ("tde.pack", "tde.upload", "tde.unpack", "tde.gather", "tde.mc",
            "tde.residual", "tde.intra", "tde.deblock", "tde.sao")
FORMULATIONS = {"production": True, "per-cell": False}


def _pipelined(production):
    fd = FusedDecoder(device="cpu")
    fd.use_pallas_mc = production
    return PipelinedDecoder(fused=fd)


def _traced(fn):
    """fn() under a CPU torch.profiler: (its result, the Records it left,
    their summary(), the profiler), the Records cleared before and
    after."""
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    recs, summ = tracing.records(), tracing.summary()
    tracing.clear()
    return out, recs, summ, prof


@pytest.fixture(scope="module")
def stream():
    return gop_bytes("p-sao")


@pytest.fixture(scope="module", params=list(FORMULATIONS))
def traced(request, native_build, stream):
    pd = _pipelined(FORMULATIONS[request.param])
    pd.warm(stream)
    outs, recs, summ, prof = _traced(
        lambda: pd.decode_stream(stream, chunk=1 << 10))
    return {"pd": pd, "outs": outs, "recs": recs, "summary": summ,
            "prof": prof, "n": len(programs(stream)[1])}


def test_off_every_site_returns_the_shared_noop(native_build, stream,
                                                monkeypatch):
    seen = []
    span = tracing.span

    def spy(name):
        ctx = span(name)
        seen.append((name, ctx))
        return ctx

    monkeypatch.setattr(tracing, "span", spy)
    tracing.clear()
    pd = _pipelined(True)
    pd.decode_stream(stream, chunk=1 << 10)
    names = {n for n, _ in seen}
    assert {"tde.request", "tde.decode", *SECTIONS} <= names
    assert all(ctx is tracing.NOOP for _, ctx in seen)
    assert tracing.NOOP.thread_span("tde.parse") is tracing.NOOP
    assert tracing.records() == [] and tracing.summary() == {}


def test_each_picture_is_one_decode_of_named_sections(traced):
    recs = traced["recs"]
    main = threading.get_ident()
    (req,) = [r for r in recs if r.name == "tde.request"]
    assert req.parent is None and req.thread == main
    assert {r.request for r in recs} == {req.request}
    decodes = [r for r in recs if r.name == "tde.decode"]
    assert len(decodes) == traced["n"]
    for d in decodes:
        assert d.parent == req.id and d.thread == main
        kids = sorted((r for r in recs if r.parent == d.id),
                      key=lambda r: r.start_ns)
        assert [k.name for k in kids] == list(SECTIONS)
    for w in (r for r in recs if r.name == "tde.stream.wait"):
        assert w.parent == req.id
    parse = [r for r in recs if r.name == "tde.parse"]
    assert parse and all(r.thread != main and r.parent is None
                         for r in parse)
    events = {e.name for e in traced["prof"].events()}
    assert "tde.parse" not in events
    assert {"tde.request", "tde.decode", *SECTIONS} <= events


def test_self_times_add_up_to_each_decode(traced):
    recs = traced["recs"]
    for d in (r for r in recs if r.name == "tde.decode"):
        kids = [r for r in recs if r.parent == d.id]
        assert all(d.start_ns <= k.start_ns <= k.end_ns <= d.end_ns
                   for k in kids)
    s = traced["summary"]
    d = s["tde.decode"]
    assert d["count"] == traced["n"]
    parts = d["self_ms"] + sum(s[n]["self_ms"] for n in SECTIONS)
    assert parts == pytest.approx(d["total_ms"], rel=1e-9, abs=1e-6)
    for n in SECTIONS:
        assert s[n]["self_ms"] == pytest.approx(s[n]["total_ms"])
    assert 0 < d["self_ms"] < d["total_ms"]


def test_spans_match_their_profiler_events(traced):
    """start and end of each calling-thread span against its profiler
    event, on the absolute timeline (trace_start_ns + the event's range):
    within 50 us at the median."""
    recs = traced["recs"]
    prof = traced["prof"]
    t0 = prof.profiler.kineto_results.trace_start_ns()
    events = {}
    for e in prof.events():
        if e.name.startswith("tde."):
            events.setdefault(e.name, []).append(e)
    diffs = []
    for name, evs in events.items():
        rs = sorted((r for r in recs if r.name == name),
                    key=lambda r: r.start_ns)
        evs.sort(key=lambda e: e.time_range.start)
        assert len(rs) == len(evs), name
        for r, e in zip(rs, evs):
            diffs.append(abs(t0 + 1e3 * e.time_range.start - r.start_ns))
            diffs.append(abs(t0 + 1e3 * e.time_range.end - r.end_ns))
    # every span but tde.stream.wait, which the parse can outrun, has its
    # events: one request, a decode and its sections a picture
    n = traced["n"]
    always = {"tde.request": 1, "tde.decode": n, **dict.fromkeys(SECTIONS, n)}
    assert {k: len(events.get(k, [])) for k in always} == always
    assert statistics.median(diffs) < 50e3


def test_planes_equal_with_tracing_on_and_off(traced, stream):
    pd = traced["pd"]
    pd.reset()
    off = pd.decode_stream(stream, chunk=1 << 10)
    assert len(off) == len(traced["outs"]) == traced["n"]
    for a, b in zip(traced["outs"], off):
        for pa, pb in zip(a, b):
            assert torch.equal(pa, pb)


def test_summary_counts_total_and_self_time():
    """Self time is the duration less its direct children; a grandchild
    counts in its parent only; clear() forgets every Record."""
    def body():
        with tracing.span("a"):
            time.sleep(0.002)
            for _ in range(2):
                with tracing.span("b"):
                    with tracing.span("c"):
                        time.sleep(0.001)

    _, recs, s, _ = _traced(body)
    by = {n: [r for r in recs if r.name == n] for n in "abc"}
    (a,), bs, cs = by["a"], by["b"], by["c"]
    assert [b.parent for b in bs] == [a.id] * 2
    assert sorted(c.parent for c in cs) == sorted(b.id for b in bs)
    assert tracing.records() == [] and tracing.summary() == {}
    ms = [(r.end_ns - r.start_ns) / 1e6 for r in recs]
    dur = dict(zip((r.id for r in recs), ms))
    assert s["a"]["count"] == 1 and s["b"]["count"] == s["c"]["count"] == 2
    assert s["a"]["total_ms"] == pytest.approx(dur[a.id])
    assert s["a"]["self_ms"] == pytest.approx(
        dur[a.id] - sum(dur[b.id] for b in bs))
    assert s["b"]["self_ms"] == pytest.approx(
        sum(dur[b.id] for b in bs) - sum(dur[c.id] for c in cs))
    assert s["c"]["self_ms"] == pytest.approx(s["c"]["total_ms"])
    assert s["c"]["total_ms"] >= 2.0


def test_gop_parallel_spans(native_build):
    """One request: the concurrent parse, a plan a segment and a decode a
    picture under it."""
    data = _stream()
    gp = GopParallelDecoder(["cpu"] * 2)
    outs, recs, _, _ = _traced(lambda: gp.decode_stream(data))
    (req,) = [r for r in recs if r.name == "tde.request"]
    top = [r.name for r in sorted((r for r in recs if r.parent == req.id),
                                  key=lambda r: r.start_ns)]
    n_seg = len(gp.last_assignment)
    assert n_seg == 4
    assert top[0] == "tde.gop.parse" and top.count("tde.gop.parse") == 1
    assert top.count("tde.gop.plan") == n_seg
    assert top.count("tde.decode") == len(outs) == len(programs(data)[1])
    assert {r.request for r in recs} == {req.request}


def test_routed_picture_is_one_routed_span(native_build, monkeypatch):
    """A picture sent to pipeline.reconstruct: its tde.decode holds one
    tde.routed and none of the fused program's sections."""
    _, progs = programs(gop(416, 240, 3, **{"intra-period": 8}))
    monkeypatch.setattr(mc_seg, "MAX_PUS",
                        min(len(p.pus) for p in progs if len(p.pus)) - 1)
    fd = FusedDecoder("cpu")
    fd.use_pallas_mc = True
    fd.plan_stream(progs)
    outs, recs, _, _ = _traced(lambda: [fd.decode(p) for p in progs])
    assert fd.pipeline_pictures == 2
    decodes = sorted((r for r in recs if r.name == "tde.decode"),
                     key=lambda r: r.start_ns)
    kids = [[r.name for r in recs if r.parent == d.id] for d in decodes]
    assert kids == [list(SECTIONS), ["tde.routed"], ["tde.routed"]]
    for i, prog in enumerate(progs):
        np.testing.assert_array_equal(outs[i][0].numpy(), prog.planes[0])
