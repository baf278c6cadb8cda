"""Overlapped streaming decode: host CABAC parse || feed pack || device run.

Port of ``libde265_tpu/stream.py``.  The native parser runs on a
background thread (it releases the GIL) and exports one FrameProgram per
picture; the calling thread packs and launches each picture as soon as its
program appears.  On a CUDA device the launches are asynchronous, so the
card works on picture N while the host packs N+1 and the parser runs
further ahead.
"""
from __future__ import annotations

import ctypes as ct
import os
import threading
import time

from . import tracing
from .decoder import Decoder
from .fused_decode import FusedDecoder


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

    def warm(self, data: bytes):
        """Parse, plan and decode the stream once, so that every capacity
        watermark is final, then reset; returns the number of pictures."""
        dec = Decoder(parse_only=True, keep_programs=True)
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
        dec = Decoder(parse_only=True, keep_programs=True)
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
