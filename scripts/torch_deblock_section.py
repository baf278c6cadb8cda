#!/usr/bin/env python3
"""The port's deblocking section on one CUDA card, for one checkout.

    python3 scripts/torch_deblock_section.py [--root DIR] [--sweep]

Measures libde265_tpu_torch as DIR holds it (default: this checkout), on
the 1920x1088 P-GOP of chip_smoke.py (this checkout's): the first I and the
first P picture, each decoded after the pictures before it, then its
deblocking section run alone on the arguments it had
(chip_smoke.deblock_section: synced ms, device ms, device operations by
name).  With --sweep (this checkout's kernels), B8 and B9 on the P
picture's calls at every tile height and CTA size the kernels take:
device ms per call (torch.profiler over ten calls), back to back and with
the L2 cache flushed before each call, each result equal to the plain
version.  Prints one JSON line per reading, with the card's
nvidia-smi line.  To compare two checkouts, run both in one call on one
card (parent, change, change, parent): DIR may be a `git archive` of the
parent unpacked in a directory that .gitignore lists.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
SWEEP = [(th, nt) for th in (16, 32) for nt in (64, 128, 256)]


def kernel_ms(fn, n=10, flush=None):
    """Device ms per call of the deblocking kernel over n calls; with
    flush (a tensor larger than the L2 cache), each call after a write of
    it, so that the call reads its inputs from device memory."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            if flush is not None:
                flush.fill_(i)
            fn()
        torch.cuda.synchronize()
    us = sum(cs._device_us(e) for e in prof.key_averages()
             if "deblock_kernel" in e.key)
    return us / n / 1000 if us > 0 else None


def sweep(progs, first_p, smi):
    import torch
    import chip_smoke as cs
    import libde265_tpu_torch as lt
    from libde265_tpu_torch.ops import deblock_cuda as dc
    fd = lt.FusedDecoder()
    fd.plan_stream(progs)
    caps = cs.capture_inputs(fd, progs[:first_p + 1])[first_p]
    saved = dict(dc.TILE)
    flush = torch.empty(32 << 20, dtype=torch.int32, device="cuda")  # 128 MB
    try:
        for th, nt in SWEEP:
            dc.TILE.update(dict.fromkeys(saved, (th, nt)))
            row = {"tile_h": th, "threads": nt}
            for name in ("deblock_luma", "deblock_chroma"):
                (args, kw), = caps[name]
                fn = getattr(dc, name)
                got = fn(*args, **kw)
                want = getattr(dc, f"{name}_plain")(*args, **kw)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"{name} at tile_h {th}, {nt} "
                                         f"threads differs from plain")
                row[f"{name}_ms"] = kernel_ms(lambda: fn(*args, **kw))
                row[f"{name}_cold_ms"] = kernel_ms(lambda: fn(*args, **kw),
                                                   flush=flush)
            print(json.dumps({"sweep": row, "card": smi}), flush=True)
    finally:
        dc.TILE.update(saved)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose libde265_tpu_torch is measured")
    ap.add_argument("--sweep", action="store_true",
                    help="also sweep B8/B9 tile heights and CTA sizes")
    a = ap.parse_args()
    root = Path(a.root).resolve()
    sys.path.insert(0, str(root))
    import libde265_tpu_torch as lt     # the measured checkout's port
    if Path(lt.__file__).resolve().parent.parent != root:
        raise SystemExit(f"imported {lt.__file__}, not the port of {root}")
    # this checkout's chip_smoke (stream and readings), even where DIR has
    # one of its own
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    smi = cs.card_check()
    from libde265_tpu_torch import _native
    from libde265_tpu_torch.ops import _build
    _native.build_tree()
    _build.lib()
    data, _ = cs.make_stream(cs.BUILD / "chip_smoke" / "1080p_8f.h265", 1920,
                             1088, 8, 32, {"intra-period": 4, "sao": True})
    _, progs = cs.oracle_programs(data)
    is_intra = [len(p.pus) == 0 for p in progs]
    first_i, first_p = is_intra.index(True), is_intra.index(False)
    lt.PipelinedDecoder().decode_stream(data)       # CUDA set-up, untimed
    for what, idx in (("I", first_i), ("P", first_p)):
        sms, dms, ops = cs.deblock_section(progs, idx)
        print(json.dumps({"root": str(root), "picture": f"{what} {idx}",
                          "synced_ms": sms, "device_ms": dms,
                          "device_ops": sum(ops.values()),
                          "ops": sorted(([v, k[:100]] for k, v in
                                         ops.items()), reverse=True),
                          "card": smi}), flush=True)
    if a.sweep:
        sweep(progs, first_p, smi)


if __name__ == "__main__":
    main()
