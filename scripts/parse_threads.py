#!/usr/bin/env python3
"""Seconds of the native parse of a clip with and without its substream
workers, and the programs compared field by field.

    python3 scripts/parse_threads.py --threads 0 2 4 6 --repeat 3 \
        build/gpubench/streams/uhd2160_ra-*/segment*.h265

The files are concatenated in the order given (the benchmark's clip is its
segments in a seeded order; any order holds the same pictures).  Each
repeat times, for every worker count in turn (the order reversed on odd
repeats), ``Decoder(parse_only=True, keep_programs=True, threads=n)``
over the whole clip, as ``PipelinedDecoder``'s parse thread runs it (after
one untimed parse), then reads the programs (not timed) and compares each
with the first count's (``0`` should come first), field by field: the
records by their named fields (not the padding between them), arrays by
value, the intra plan's dict by key.  One JSON line a (repeat, count) and a summary line, to
standard output and to ``--out``.

With ``--pipelined`` it times instead whole requests of the clip through
one kept ``PipelinedDecoder`` on the card (``warm``, then per request
``reset`` and ``decode_stream``, synchronised), its parse given each worker
count in turn in place of the ``parse_workers()`` rule: whether the
workers move the end-to-end rate.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from libde265_tpu_torch.decoder import Decoder  # noqa: E402
from libde265_tpu_torch.stream import parse_workers  # noqa: E402


def same(a, b) -> bool:
    """Whether two program fields hold the same values."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        if not (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)):
            return False
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
        if a.dtype.names:
            return all(np.array_equal(a[k], b[k]) for k in a.dtype.names)
        return np.array_equal(a, b)
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def differing_fields(p, q) -> list:
    """The names of the FrameProgramData fields in which p and q differ
    (``src``, the live native source, is not content)."""
    return [f.name for f in dataclasses.fields(p)
            if f.name != "src" and not same(getattr(p, f.name),
                                            getattr(q, f.name))]


def parse(data: bytes, threads: int):
    dec = Decoder(parse_only=True, keep_programs=True, threads=threads)
    t0 = time.perf_counter()
    list(dec.decode_all(data))
    s = time.perf_counter() - t0
    return s, [dec.get_program(i) for i in range(dec.num_programs())]


def pipelined(data: bytes, counts, repeat: int, device: str) -> list:
    """One line a (repeat, count): seconds and ms a picture of a request."""
    import torch

    from libde265_tpu_torch import PipelinedDecoder, stream
    rule = stream.parse_workers
    pd = PipelinedDecoder(device=device)
    n_pics = pd.warm(data)
    lines = []
    try:
        for r in range(repeat):
            for t in (counts if r % 2 == 0 else counts[::-1]):
                stream.parse_workers = lambda t=t: t
                pd.reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pd.decode_stream(data, on_frame=lambda i, planes: None)
                torch.cuda.synchronize()
                s = time.perf_counter() - t0
                lines.append({"repeat": r, "threads": pd.parse_threads,
                              "request_s": s, "fps": n_pics / s,
                              "ms_a_picture": 1000 * s / n_pics})
                print(json.dumps(lines[-1]), flush=True)
    finally:
        stream.parse_workers = rule
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("streams", nargs="+", type=Path)
    ap.add_argument("--threads", type=int, nargs="+", default=[0, 2, 4, 6])
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--pipelined", action="store_true")
    a = ap.parse_args(argv)
    data = b"".join(p.read_bytes() for p in a.streams)
    if a.pipelined:
        lines = pipelined(data, a.threads, a.repeat, "cuda")
        summary = {"pipelined": True, "rule_workers": parse_workers(),
                   "median_fps": {t: statistics.median(
                       x["fps"] for x in lines if x["threads"] == t)
                       for t in a.threads}}
        return _finish(lines, summary, a.out, True)
    lines, secs, base = [], {t: [] for t in a.threads}, None
    parse(data, a.threads[0])       # warm-up: page cache, allocator
    for r in range(a.repeat):
        for t in (a.threads if r % 2 == 0 else a.threads[::-1]):
            s, progs = parse(data, t)
            secs[t].append(s)
            if base is None:
                base = progs
            diff = sorted({f"{i}:{name}" for i, (p, q) in
                           enumerate(zip(base, progs))
                           for name in differing_fields(p, q)})
            lines.append({"repeat": r, "threads": t, "seconds": s,
                          "ms_a_picture": 1000 * s / max(len(progs), 1),
                          "pictures": len(progs),
                          "equal": len(progs) == len(base) and not diff,
                          "differing": diff[:20]})
            print(json.dumps(lines[-1]), flush=True)
    summary = {"bytes": len(data), "pictures": len(base),
               "rule_workers": parse_workers(),
               "median_seconds": {t: statistics.median(v)
                                  for t, v in secs.items()},
               "all_equal": all(x["equal"] for x in lines)}
    return _finish(lines, summary, a.out, summary["all_equal"])


def _finish(lines, summary, out, ok) -> int:
    print(json.dumps(summary), flush=True)
    if out:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text("".join(json.dumps(x) + "\n"
                               for x in lines + [summary]))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
