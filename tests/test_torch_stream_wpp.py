"""PipelinedDecoder's parse with the native substream workers.

The parse thread's Decoder is given ``stream.parse_workers()`` workers:
the CPUs the process may run on, less the calling thread and the parse
thread, and 0 where that leaves fewer than two.  The native parse splits a
picture's WPP rows or tiles over them, and only for a picture whose PPS
enables WPP or tiles.  Here, on small streams of the kinds that matter:

- a WPP stream with the settings of the benchmark's 4K configuration
  (``uhd2160_ra``: WPP, adaptive QP a CTB, a B pyramid with TMVP and 3
  references, SAO, sign hiding, no AMP or rectangular partitions), CTB 32
  so that 384x256 has 8 rows;
- a stream of 2x2 tiles in one slice;
- a stream with neither (the benchmark's 1080p clips are of this kind).

For each: the programs parsed with workers equal those parsed without,
field by field (the records by their named fields), and PipelinedDecoder
with workers equals the scalar oracle plane by plane.  Then the rule, and
the counter ``parse_threads`` as PipelinedDecoder keeps it and notes it
on its ``tde.request`` span.
"""
import functools
import os
import sys

import numpy as np
import pytest

from libde265_tpu_torch import FusedDecoder, PipelinedDecoder, tracing
from libde265_tpu_torch import stream as stream_mod
from libde265_tpu_torch.encoder import Encoder

from _torch_common import REPO, gop_bytes, programs

sys.path.insert(0, str(REPO / "scripts"))
import parse_threads  # noqa: E402 - the comparison PERF.md's figures use

UHD_SETTINGS = {"intra-period": 16, "b-pyramid": True, "pyramid-levels": 2,
                "num-refs": 3, "tmvp": True, "wpp": True,
                "adaptive-qp": True, "sao": True, "sign-hiding": True,
                "amp": False, "rect-parts": False, "me-range": 57}
TILE_SETTINGS = {"intra-period": 4, "sao": True, "tile-cols": 2,
                 "tile-rows": 2}


@functools.lru_cache(maxsize=None)
def _textured(settings, w=384, h=256, n=9, ctb=32, qp=27):
    """A stream (bytes) of textured content that pans, with a flat
    band and a noisy one, so that adaptive QP picks several CTB QPs."""
    rng = np.random.default_rng(18)
    tex = rng.integers(0, 256, (h + 64, w + 64)).astype(np.float64)
    tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1)) / 3
    yy, xx = np.mgrid[0:h, 0:w]
    with Encoder(qp=qp, ctb_size=ctb) as enc:
        for k, v in settings:
            enc.set_parameter(k, v)
        data = b""
        for t in range(n):
            win = tex[2 * t:2 * t + h, 3 * t:3 * t + w]
            y = np.where(yy < h // 3, 96 + 0.05 * win,
                         40 + 0.7 * win * (xx / w))
            cb = 110 + 0.1 * win[::2, ::2]
            cr = 140 - 0.1 * win[::2, ::2]
            data += enc.encode(*(np.clip(p, 0, 255).astype(np.uint8)
                                 for p in (y, cb, cr)), pts=t)
        return data + enc.finish()


STREAMS = {
    "wpp-aq": lambda: _textured(tuple(UHD_SETTINGS.items())),
    "tiles": lambda: _textured(tuple(TILE_SETTINGS.items()), n=5),
    "plain": lambda: gop_bytes("p-sao"),
}


def _cpus(monkeypatch, n):
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(n)))


@pytest.mark.parametrize("name", list(STREAMS))
def test_programs_equal_with_workers(native_build, name):
    data = STREAMS[name]()
    _, base = parse_threads.parse(data, 0)
    assert len(base) > 1
    for threads in (2, 4):
        _, got = parse_threads.parse(data, threads)
        assert len(got) == len(base)
        for i, (p, q) in enumerate(zip(base, got)):
            bad = parse_threads.differing_fields(p, q)
            assert not bad, (name, threads, i, bad)


def test_wpp_stream_has_rows_and_qp_groups(native_build):
    """The WPP stream is what the test means: 8 CTB rows, and more than
    one QP a picture (adaptive QP a CTB)."""
    _, progs = parse_threads.parse(STREAMS["wpp-aq"](), 0)
    assert progs[0].ctb_h == 8
    assert any(len(np.unique(p.qp_y)) > 1 for p in progs)
    assert any(len(p.pus) for p in progs)


@pytest.mark.parametrize("name", list(STREAMS))
def test_pipelined_with_workers_bit_exact(native_build, monkeypatch, name):
    """On 6 CPUs the rule gives 4 workers; the decode, production
    formulation on the CPU, equals the scalar oracle."""
    data = STREAMS[name]()
    _, progs = programs(data)
    _cpus(monkeypatch, 6)
    fd = FusedDecoder(device="cpu")
    fd.use_pallas_mc = True
    pd = PipelinedDecoder(fused=fd)
    pd.warm(data)
    outs = pd.decode_stream(data, chunk=1 << 12)
    assert pd.parse_threads == 4
    assert len(outs) == len(progs)
    for i, (planes, prog) in enumerate(zip(outs, progs)):
        for c, pl in enumerate(planes):
            np.testing.assert_array_equal(pl.numpy(), prog.planes[c],
                                          err_msg=f"{name} {i} plane {c}")


@pytest.mark.parametrize("cpus,workers", [(1, 0), (2, 0), (3, 0), (4, 2),
                                          (7, 5), (8, 6), (9, 6),
                                          (32, 6)])
def test_parse_workers_rule(monkeypatch, cpus, workers):
    _cpus(monkeypatch, cpus)
    assert stream_mod.parse_workers() == workers
    pd = PipelinedDecoder(device="cpu")
    assert pd.parse_threads == 0
    pd._parser()
    assert pd.parse_threads == workers


@pytest.mark.parametrize("cpus,workers", [(3, 0), (8, 6)])
def test_parse_threads_noted_on_the_request(native_build, monkeypatch,
                                            cpus, workers):
    """The counter is noted on the tde.request span's Record while the
    profiler records, and on nothing when it does not."""
    from torch.profiler import ProfilerActivity, profile
    data = gop_bytes("p-sao")
    _cpus(monkeypatch, cpus)
    pd = PipelinedDecoder(device="cpu")
    tracing.clear()
    pd.decode_stream(data)
    assert tracing.records() == []
    with profile(activities=[ProfilerActivity.CPU]):
        pd.decode_stream(data)
    reqs = [r for r in tracing.records() if r.name == "tde.request"]
    tracing.clear()
    assert len(reqs) == 1
    assert reqs[0].args == {"parse_threads": workers}
    assert pd.parse_threads == workers
