"""Faults planted underneath the timed path, for the control and the
tests that show the comparison fails: never entered by a benchmark run.

Each is a context manager that patches the program's classes while it is
entered, so that every entry (PipelinedDecoder, GopParallelDecoder and
the FusedDecoders they build) runs the faulty path.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(cls, name, make):
    orig = getattr(cls, name)
    setattr(cls, name, make(orig))
    try:
        yield
    finally:
        setattr(cls, name, orig)


def sao_off():
    """The control: the program's own switch that skips SAO
    (FusedDecoder.run_sao = False), breaking conformance."""
    from libde265_tpu_torch.fused_decode import FusedDecoder

    def make(orig):
        def decode(self, prog):
            self.run_sao = False
            return orig(self, prog)
        return decode
    return _patched(FusedDecoder, "decode", make)


def stale():
    """A step that returns its state unchanged: each decode returns the
    previous picture's planes (the first returns its own)."""
    from libde265_tpu_torch.fused_decode import FusedDecoder

    def make(orig):
        last = []

        def decode(self, prog):
            out = orig(self, prog)
            prev = last[0] if last else out
            last[:] = [tuple(p.clone() for p in out)]
            return prev
        return decode
    return _patched(FusedDecoder, "decode", make)


def altered():
    """An answer altered where it is produced: one luma sample of every
    picture is changed by one."""
    from libde265_tpu_torch.fused_decode import FusedDecoder

    def make(orig):
        def decode(self, prog):
            out = list(orig(self, prog))
            y = out[0].clone()
            y[0, 0] = y[0, 0] ^ 1
            out[0] = y
            return tuple(out)
        return decode
    return _patched(FusedDecoder, "decode", make)


@contextlib.contextmanager
def half():
    """Half of the batch left out: every second picture the program
    decodes (counted across requests) is never handed on."""
    from libde265_tpu_torch.parallel.gop_parallel import GopParallelDecoder
    from libde265_tpu_torch.stream import PipelinedDecoder
    count = [0]

    def keep():
        count[0] += 1
        return count[0] % 2 == 1

    def make_pd(orig):
        def decode_stream(self, data, chunk=1 << 16, on_frame=None):
            def some(i, planes):
                if keep():
                    on_frame(i, planes)
            return orig(self, data, chunk, some if on_frame else None)
        return decode_stream

    def make_gp(orig):
        def decode_stream(self, data):
            return [f for f in orig(self, data) if keep()]
        return decode_stream

    with _patched(PipelinedDecoder, "decode_stream", make_pd), \
            _patched(GopParallelDecoder, "decode_stream", make_gp):
        yield


FAULTS = {"sao_off": sao_off, "stale": stale, "altered": altered,
          "half": half}
