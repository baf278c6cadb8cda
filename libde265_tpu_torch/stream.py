"""Overlapped streaming decode: host CABAC parse || feed pack || device run.

Port of ``libde265_tpu/stream.py``.  The native parser runs on a
background thread (it releases the GIL) and exports one FrameProgram per
picture; the calling thread packs and launches each picture as soon as its
program appears.  On a CUDA device the launches are asynchronous, so the
card works on picture N while the host packs N+1 and the parser runs
further ahead.  Within a picture whose PPS enables WPP or tiles, the
native parse splits the substreams (CTB rows or tiles) over worker threads
of its own (``parse_workers``); the programs are the same as one thread's.
"""
from __future__ import annotations

import ctypes as ct
import os
import threading
import time

from . import tracing
from .decoder import Decoder
from .fused_decode import FusedDecoder


# The most parse workers a decoder takes: the count measured to help on
# 4K WPP rows (2 / 4 / 6 workers parsed a 64-picture clip 1.16 / 1.54 /
# 1.67x faster on an 8-CPU host), so that decoders side by side on a
# larger host do not each claim every CPU.
MAX_PARSE_WORKERS = 6


def parse_workers() -> int:
    """Worker threads for the native WPP-row / tile substream parse: the
    CPUs this process may run on, less the calling thread and the parse
    thread, at most MAX_PARSE_WORKERS; 0 where that leaves fewer than two
    (the native parse splits a picture only with two or more).  The native
    parse starts them only for a picture whose PPS enables WPP or tiles.

    The rule assumes one decoder per process; two decoders in one process
    each take the count.  It was measured with one decoder on an 8-CPU
    host, where it moved the parse and not the end-to-end rate."""
    n = min(len(os.sched_getaffinity(0)) - 2, MAX_PARSE_WORKERS)
    return n if n >= 2 else 0


class PipelinedDecoder:
    """Stream decoder with parse/pack/execute overlap.

    `fused` is the FusedDecoder that decodes the pictures; without one, a
    FusedDecoder on `device` (the CUDA card unless the caller asks for the
    CPU).  An explicit `fused` keeps its own device.

    Usage::
        pd = PipelinedDecoder()
        pd.warm(data)                      # optional: final capacities
        outs = pd.decode_stream(data)      # list of device plane tuples
    """

    def __init__(self, fused: FusedDecoder | None = None, device="cuda"):
        self.fd = fused if fused is not None else FusedDecoder(device=device)
        # counter: the substream workers of the last parse (parse_workers)
        self.parse_threads = 0

    def _parser(self) -> Decoder:
        """A parse-only Decoder that keeps its programs, with the
        substream workers parse_workers() gives."""
        self.parse_threads = parse_workers()
        return Decoder(parse_only=True, keep_programs=True,
                       threads=self.parse_threads)

    def warm(self, data: bytes):
        """Parse, plan and decode the stream once, so that every capacity
        watermark is final, then reset; returns the number of pictures."""
        dec = self._parser()
        list(dec.decode_all(data))
        progs = [dec.get_program(i) for i in range(dec.num_programs())]
        self.fd.plan_stream(progs)
        for p in progs:
            self.fd.decode(p)
        self.reset()
        return len(progs)

    def reset(self):
        """Forget the decoded pictures, the DPB ring included, so that the
        next stream (of any size) reads none of this one's references."""
        self.fd.reset()

    def decode_stream(self, data: bytes, chunk: int = 1 << 16,
                      on_frame=None):
        """Decode an Annex-B stream with all three stages overlapped,
        pushing `chunk` bytes at a time to the parser.

        Returns one tuple of device planes per picture, in decode order;
        with `on_frame`, calls on_frame(i, planes) for each picture as it
        is launched instead, and returns [].

        On a one-core host the parse thread would contend with packing
        instead of overlapping it, so the pipeline parses first there.
        """
        with tracing.span("tde.request") as req:
            return self._decode_stream(data, chunk, on_frame, req)

    def _decode_stream(self, data, chunk, on_frame, req):
        dec = self._parser()
        req.note(parse_threads=self.parse_threads)
        outs = []

        def emit(i):
            planes = self.fd.decode(dec.get_program(i))
            if on_frame is not None:
                on_frame(i, planes)
            else:
                outs.append(planes)

        if (os.cpu_count() or 1) < 2:
            list(dec.decode_all(data))
            for i in range(dec.num_programs()):
                emit(i)
            return outs
        done = threading.Event()
        err = []

        def parse():
            try:
                mv = memoryview(data)
                for off in range(0, len(data), chunk):
                    dec.push(bytes(mv[off:off + chunk]))
                dec.flush()
                # drive the decode pump (parse-only: programs are exported,
                # pictures carry no pixels and are released immediately)
                more = ct.c_int(1)
                while more.value:
                    more.value = 0
                    with req.thread_span("tde.parse"):
                        dec._lib.de265_decode(dec._ctx, ct.byref(more))
                    while dec._lib.de265_peek_next_picture(dec._ctx):
                        dec._lib.de265_release_next_picture(dec._ctx)
            except Exception as e:  # noqa: BLE001 - re-raised by the caller
                err.append(e)
            finally:
                done.set()

        t = threading.Thread(target=parse, daemon=True)
        t.start()
        i = 0
        try:
            while True:
                while i < dec.num_programs():
                    emit(i)
                    i += 1
                if done.is_set() and i == dec.num_programs():
                    break
                # waiting for the parse thread: one span a wait, not a poll
                with tracing.span("tde.stream.wait"):
                    while i >= dec.num_programs() and not done.is_set():
                        time.sleep(0.0002)
        finally:
            t.join()
        if err:
            raise err[0]
        return outs
