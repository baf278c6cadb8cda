"""The general traffic generator: drives one entry of the program with
the requests a traffic mix describes, over a window of fixed length, and
records what the metric readers read.

A mix (``traffic/<mix>.json``) names:

- ``entry``: the program's object that serves a request.
  ``pipelined`` is one ``PipelinedDecoder`` kept across the window; a
  request is ``reset()`` then ``decode_stream(stream, on_frame=...)``.
  ``gop_parallel`` is one ``GopParallelDecoder`` over the cell's device;
  a request is ``decode_stream(stream)``, whose pictures are then
  handed on one by one.
- ``request``: ``clip`` (every request is the whole clip) or ``segment``
  (a request is one of the clip's independently encoded segments, in
  rounds: each round visits every segment once, in an order drawn from
  the seed, so that every seed sends the same set of requests).
- ``profile_requests``: how many requests the traced run profiles.
- ``check``: which pictures are compared with the reference:
  every picture of the first request, then in each later request drawn
  (from the seed, with probability ``request_share``) ``pictures``
  pictures (0: all of them), at most ``max`` pictures in all.

Requests are sent in a closed loop, one at a time: a request starts when
the previous one's pictures are synchronised on the device.  The window
ends with the first request that ends ``seconds`` or more after the
window started; every request of the window counts.
"""
from __future__ import annotations

import contextlib
import time
import traceback
from dataclasses import dataclass, field

import numpy as np

from . import profiling, reference


@dataclass
class Window:
    wall_s: float = 0.0
    requests: int = 0
    pictures: int = 0
    latencies_s: list = field(default_factory=list)
    parse_s: list = field(default_factory=list)   # gop_parallel's parse
    failed: int = 0
    missing: int = 0
    errors: list = field(default_factory=list)
    memory_peak_bytes: int = 0


@dataclass
class Probe:
    """Each layer alone on the cell's request streams (traced runs)."""
    parse_s: float = 0.0          # parse-only host seconds, all pictures
    pictures: int = 0
    decode_s: list = field(default_factory=list)   # synced, per picture
    wire_bytes: list = field(default_factory=list)  # per picture (or None)


@dataclass
class Run:
    """What one run measured; the metric readers read it."""
    seed: int
    seconds: float
    trace: bool
    device: str
    config: dict
    mix: dict
    setup_s: float = 0.0
    window: Window = None
    trace_data: profiling.Trace = None
    traced_programs: list = field(default_factory=list)
    probe: Probe = None
    programs: list = field(default_factory=list)   # per request stream
    checked: int = 0
    mismatched: int = 0


def request_order(mix: dict, n_streams: int, seed: int):
    """Request r's stream index, for r = 0, 1, ..."""
    if mix["request"] == "clip":
        while True:
            yield 0
    rnd = 0
    while True:
        perm = np.random.default_rng([int(seed), 0x6F72, rnd]).permutation(
            n_streams)
        yield from (int(j) for j in perm)
        rnd += 1


def request_streams(mix: dict, clip):
    if mix["request"] == "clip":
        return [clip.data]
    if mix["request"] == "segment":
        return list(clip.segments)
    raise ValueError(f"unknown request kind {mix['request']!r}")


class Entry:
    """The program's entry a mix drives, on `device`."""

    def __init__(self, mix: dict, device: str):
        import libde265_tpu_torch as lt
        self.kind = mix["entry"]
        self.device = device
        if self.kind == "pipelined":
            self.obj = lt.PipelinedDecoder(device=device)
        elif self.kind == "gop_parallel":
            self.obj = lt.GopParallelDecoder(devices=[device])
        else:
            raise ValueError(f"unknown entry {self.kind!r}")

    def warm(self, clip_data: bytes, streams):
        """Every shape the window's requests use, once: PipelinedDecoder's
        own warm-up decodes the whole clip (each segment's pictures among
        them); GopParallelDecoder has none, so each request is served."""
        if self.kind == "pipelined":
            self.obj.warm(clip_data)
            return
        for s in streams:
            self.serve(s, lambda i, planes: None, None)

    def serve(self, stream: bytes, on_frame, window: Window | None):
        if self.kind == "pipelined":
            self.obj.reset()
            self.obj.decode_stream(stream, on_frame=on_frame)
            return
        frames = self.obj.decode_stream(stream)
        if window is not None:
            window.parse_s.append(self.obj.last_parse_s)
        for i, planes in enumerate(frames):
            on_frame(i, planes)


def make_sync(device: str):
    import torch
    if torch.device(device).type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


class Checker:
    """Copies the sampled pictures off the device as the window produces
    them (8-bit samples and each plane's range, into host buffers, without
    waiting), and judges them against the reference once it has closed."""

    def __init__(self, mix: dict, seed: int, streams, device: str,
                 sizes, bit_depth: int):
        import torch
        self.p = mix["check"]
        self.seed = int(seed)
        self.want = [reference.picture_hashes(s) for s in streams]
        self.sizes = sizes          # [(h, w)] of the planes
        self.bit_depth = bit_depth
        if bit_depth > 8:
            raise ValueError("the checker copies 8-bit samples")
        n = sum(h * w for h, w in sizes)
        pin = torch.device(device).type == "cuda"
        cap = int(self.p["max"])
        self.buf = torch.empty((cap, n), dtype=torch.uint8, pin_memory=pin)
        self.rng_buf = torch.empty((cap, len(sizes), 2), dtype=torch.int32,
                                   pin_memory=pin)
        self.keys = []              # (stream index, picture index)
        self._pick = None

    def plan(self, r: int, j: int):
        """The pictures of request r (stream j) to check."""
        n = len(self.want[j])
        if r == 0:
            self._pick = set(range(n))
            return
        rng = np.random.default_rng([self.seed, 0x636B, r])
        self._pick = set()
        if rng.random() < float(self.p["request_share"]):
            k = int(self.p["pictures"]) or n
            self._pick = {int(i) for i in rng.choice(n, min(k, n),
                                                     replace=False)}

    def take(self, j: int, i: int, planes):
        import torch
        if i not in self._pick or len(self.keys) >= self.buf.shape[0]:
            return
        k = len(self.keys)
        flat = torch.cat([p.reshape(-1).to(torch.uint8) for p in planes])
        ranges = torch.stack([torch.stack(torch.aminmax(p)) for p in planes])
        self.buf[k, :flat.numel()].copy_(flat, non_blocking=True)
        self.rng_buf[k, :len(planes)].copy_(ranges.to(torch.int32),
                                            non_blocking=True)
        self.keys.append((j, i, len(planes)))

    def judge(self):
        """(pictures checked, pictures that differ from the reference);
        call after the device is synchronised."""
        bad = 0
        top = (1 << self.bit_depth) - 1
        for k, (j, i, n_pl) in enumerate(self.keys):
            raw, off, planes = self.buf[k].numpy(), 0, []
            for h, w in self.sizes[:n_pl]:
                planes.append(raw[off:off + h * w].reshape(h, w))
                off += h * w
            rng = self.rng_buf[k].numpy()
            ok_range = all(rng[c, 0] >= 0 and rng[c, 1] <= top
                           for c in range(n_pl))
            want = self.want[j][i]
            if not ok_range or reference.judge(planes, want,
                                               self.bit_depth) > 0:
                bad += 1
        return len(self.keys), bad


def run_window(entry: Entry, streams, order, seconds: float, sync,
               checker: Checker, expected, device: str) -> Window:
    import torch
    is_cuda = torch.device(device).type == "cuda"
    win = Window()
    sync()
    if is_cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = 0
    while True:
        j = next(order)
        checker.plan(r, j)
        emitted = [0]

        def on_frame(i, planes, j=j):
            emitted[0] += 1
            checker.take(j, i, planes)

        ts = time.perf_counter()
        try:
            entry.serve(streams[j], on_frame, win)
            sync()
        except Exception:  # noqa: BLE001 - a failed request is counted
            win.failed += 1
            win.errors.append(traceback.format_exc(limit=4))
        te = time.perf_counter()
        win.latencies_s.append(te - ts)
        win.pictures += emitted[0]
        win.missing += max(0, expected[j] - emitted[0])
        r += 1
        if te - t0 >= seconds:
            break
    win.wall_s = te - t0
    win.requests = r
    if is_cuda:
        win.memory_peak_bytes = torch.cuda.max_memory_allocated()
    return win


@contextlib.contextmanager
def decode_spans():
    """A torch.profiler span named FusedDecoder.decode around every call
    of the program's public FusedDecoder.decode while profiling."""
    import torch
    from libde265_tpu_torch.fused_decode import FusedDecoder
    orig = FusedDecoder.decode

    def decode(self, prog):
        with torch.profiler.record_function("FusedDecoder.decode"):
            return orig(self, prog)

    FusedDecoder.decode = decode
    try:
        yield
    finally:
        FusedDecoder.decode = orig


def profile_requests(entry: Entry, streams, order, n: int, sync):
    """torch.profiler over `n` further requests; (Trace or None, the
    stream index of each request).  Off the card there is no device
    trace: (None, [])."""
    import torch
    if torch.device(entry.device).type != "cuda":
        return None, []
    served = []

    def go():
        for _ in range(n):
            j = next(order)
            served.append(j)
            with torch.profiler.record_function("gpubench.request"):
                entry.serve(streams[j], lambda i, planes: None, None)
            sync()

    with decode_spans():
        tr = profiling.profile(go, sync)
    # a profile that was taken again served its requests again
    return tr, served[-n:]


def probe_layers(streams, device: str, sync) -> tuple:
    """Each layer alone: the native parse of every request stream
    (parse-only Decoder, as PipelinedDecoder's parse thread runs it; host
    seconds), then FusedDecoder.decode of each parse-only program,
    synchronised, after a reset at the start of each stream (a warm pass,
    then the timed one), with the upload bytes of each picture.  Returns
    (Probe, programs per stream)."""
    from libde265_tpu_torch import Decoder, FusedDecoder
    probe, programs = Probe(), []
    for s in streams:
        dec = Decoder(parse_only=True, keep_programs=True)
        t0 = time.perf_counter()
        list(dec.decode_all(s))
        probe.parse_s += time.perf_counter() - t0
        progs = [dec.get_program(i) for i in range(dec.num_programs())]
        probe.pictures += len(progs)
        programs.append(progs)
    fd = FusedDecoder(device=device)
    fd.plan_stream([p for progs in programs for p in progs])
    for timed in (False, True):
        for progs in programs:
            fd.reset()
            for p in progs:
                fd.last_wire_bytes = None
                t0 = time.perf_counter()
                fd.decode(p)
                sync()
                if timed:
                    probe.decode_s.append(time.perf_counter() - t0)
                    probe.wire_bytes.append(fd.last_wire_bytes)
    return probe, programs
