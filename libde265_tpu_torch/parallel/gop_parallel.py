"""Segment-(GOP-)level parallel decode across devices.

Port of ``libde265_tpu/parallel/gop_parallel.py``.  An Annex-B stream is a
sequence of independently decodable segments delimited by IRAP pictures
with closed prediction (IDR/BLA, optionally CRA), each prefixed with the
parameter sets seen so far.  The segments are parsed concurrently, one
native parse-only decoder per thread (the native parse releases the GIL),
then each is decoded by its own FusedDecoder on ``devices[i % len]``, in
segment order.  As in the JAX package, parse and decode do not overlap.
"""
from __future__ import annotations

import threading
import time

import torch

from .. import tracing
from ..decoder import Decoder
from ..fused_decode import FusedDecoder
from .tiles import cuda_devices, on_device

_IDR_TYPES = (19, 20)
_BLA_TYPES = (16, 17, 18)
_CRA = 21
_PARAM_SETS = (32, 33, 34)  # VPS/SPS/PPS


def _nal_starts(data: bytes):
    out, i = [], 0
    while True:
        i = data.find(b"\x00\x00\x01", i)
        if i < 0:
            return out
        # include a preceding zero byte (4-byte start code) in the unit
        begin = i - 1 if i > 0 and data[i - 1] == 0 else i
        out.append((begin, i + 3))
        i += 3


def split_segments(data: bytes, split_at_cra: bool = False):
    """Split at closed-prediction IRAP boundaries; each segment is prefixed
    with every parameter set seen so far (so it decodes standalone)."""
    starts = _nal_starts(data)
    if not starts:
        return [data]
    segments = []
    headers = b""
    cur = b""
    for k, (begin, hdr) in enumerate(starts):
        end = starts[k + 1][0] if k + 1 < len(starts) else len(data)
        unit = data[begin:end]
        t = (data[hdr] >> 1) & 0x3F
        if t in _PARAM_SETS:
            headers += unit
            cur += unit
            continue
        boundary = t in _IDR_TYPES or t in _BLA_TYPES or \
            (split_at_cra and t == _CRA)
        if boundary and cur.strip(b"\x00"):
            has_vcl = any((cur[h] >> 1) & 0x3F < 32
                          for _, h in _nal_starts(cur))
            if has_vcl:
                segments.append(cur)
                cur = headers
        cur += unit
    if cur.strip(b"\x00") and any((cur[h] >> 1) & 0x3F < 32
                                  for _, h in _nal_starts(cur)):
        segments.append(cur)
    return segments


def parse_segments(segs):
    """The FrameProgram list of each segment, every segment parsed on its
    own thread by a parse-only Decoder (in segment order)."""
    progs = [None] * len(segs)
    err = []

    def parse(i):
        try:
            dec = Decoder(parse_only=True, keep_programs=True)
            list(dec.decode_all(segs[i]))
            progs[i] = [dec.get_program(k)
                        for k in range(dec.num_programs())]
        except Exception as e:  # noqa: BLE001 - re-raised by the caller
            err.append(e)

    threads = [threading.Thread(target=parse, args=(i,))
               for i in range(len(segs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if err:
        raise err[0]
    return progs


class GopParallelDecoder:
    """Decode IRAP-delimited segments concurrently parsed, one FusedDecoder
    per segment on devices[i % len(devices)].

    devices=None takes every CUDA device and raises RuntimeError without
    one (no fallback to the CPU); k segments on one card:
    devices=["cuda:0"] * k, on the host: ["cpu"] * k.  After a decode,
    last_assignment holds the device index of each segment and
    last_parse_s the seconds of the concurrent parse.

    Usage::
        gp = GopParallelDecoder()
        frames = gp.decode_stream(data)   # [planes, ...] in decode order
    """

    def __init__(self, devices=None, split_at_cra: bool = False):
        devs = cuda_devices() if devices is None else list(devices)
        if not devs:
            raise RuntimeError("GopParallelDecoder: no CUDA device; pass "
                               "devices= (e.g. ['cpu'] * k)")
        self.devices = [torch.device(d) for d in devs]
        self.split_at_cra = split_at_cra
        self.last_assignment = []
        self.last_parse_s = None

    def decode_stream(self, data: bytes):
        with tracing.span("tde.request"):
            return self._decode_stream(data)

    def _decode_stream(self, data):
        segs = split_segments(data, self.split_at_cra)
        t0 = time.perf_counter()
        with tracing.span("tde.gop.parse"):
            progs_per_seg = parse_segments(segs)
        self.last_parse_s = time.perf_counter() - t0
        out = []
        self.last_assignment = []
        for i, progs in enumerate(progs_per_seg):
            k = i % len(self.devices)
            dev = self.devices[k]
            with on_device(dev):
                with tracing.span("tde.gop.plan"):
                    fd = FusedDecoder(device=dev)
                    fd.plan_stream(progs)
                out.extend(fd.decode(p) for p in progs)
            self.last_assignment.append(k)
        return out
