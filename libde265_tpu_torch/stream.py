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

from .decoder import Decoder

from .fused_decode import FusedDecoder


_CHUNK = 1 << 16   # bytes pushed to the parser at a time


class PipelinedDecoder:
    """Stream decoder with parse/pack/execute overlap on `device` (the
    CUDA card unless the caller asks for the CPU).

    Usage::
        pd = PipelinedDecoder()
        outs = pd.decode_stream(data)      # list of device plane tuples
    """

    def __init__(self, device="cuda"):
        self.fd = FusedDecoder(device=device)

    def decode_stream(self, data: bytes):
        """Decode an Annex-B stream with all three stages overlapped;
        returns one tuple of device planes per picture, in decode order.

        On a one-core host the parse thread would contend with packing
        instead of overlapping it, so the pipeline parses first there.
        """
        dec = Decoder(parse_only=True, keep_programs=True)
        if (os.cpu_count() or 1) < 2:
            list(dec.decode_all(data))
            return [self.fd.decode(dec.get_program(i))
                    for i in range(dec.num_programs())]
        done = threading.Event()
        err = []

        def parse():
            try:
                mv = memoryview(data)
                for off in range(0, len(data), _CHUNK):
                    dec.push(bytes(mv[off:off + _CHUNK]))
                dec.flush()
                # drive the decode pump (parse-only: programs are exported,
                # pictures carry no pixels and are released immediately)
                more = ct.c_int(1)
                while more.value:
                    more.value = 0
                    dec._lib.de265_decode(dec._ctx, ct.byref(more))
                    while dec._lib.de265_peek_next_picture(dec._ctx):
                        dec._lib.de265_release_next_picture(dec._ctx)
            except Exception as e:  # noqa: BLE001 - re-raised by the caller
                err.append(e)
            finally:
                done.set()

        t = threading.Thread(target=parse, daemon=True)
        t.start()
        outs = []
        try:
            while True:
                n = dec.num_programs()
                while len(outs) < n:
                    outs.append(self.fd.decode(dec.get_program(len(outs))))
                if done.is_set() and len(outs) == dec.num_programs():
                    break
                if len(outs) >= n:
                    time.sleep(0.0002)
        finally:
            t.join()
        if err:
            raise err[0]
        return outs
