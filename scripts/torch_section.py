#!/usr/bin/env python3
"""Sections of the port's picture program on one CUDA card, for one
checkout, and the tile sweeps of their kernels.

    python3 scripts/torch_section.py [--root DIR] [--sweep deblock|densify]

Measures libde265_tpu_torch as DIR holds it (default: this checkout), on
the 1920x1088 P-GOP of chip_smoke.py (this checkout's): the first I and the
first P picture, each decoded after the pictures before it, then its
deblocking section and its residual section (B4 densify of every size bin,
escape corrections, dequant + inverse transform) run alone on the
arguments they had (chip_smoke.section_alone: synced ms, device ms, device
operations by name).  A checkout whose picture program runs the residual
section inline (no fused_decode._residual_section) gets the same
statements run on its modules (`residual_inline`).

--sweep deblock (this checkout's kernels): B8 and B9 on the P picture's
calls at every tile height and CTA size the kernels take.  --sweep
densify: B4 on the P picture's call, each size bin alone at every tile
size, lanes per TU and CTA size, then the whole call with each CTA size's
best shapes and with the shapes the wrapper uses.  Device ms per call
(torch.profiler over ten calls), back to back and with the L2 cache flushed
before each call, each result equal to the plain version.  Prints one JSON
line per reading, with the card's nvidia-smi line.  To compare two
checkouts, run both in one call on one card (parent, change, change,
parent): DIR may be a `git archive` of the parent unpacked in a directory
that .gitignore lists.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
DEBLOCK_SWEEP = [(th, nt) for th in (16, 32) for nt in (64, 128, 256)]
DENSIFY_TILE_BYTES = (4096, 8192, 16384, 32768)
DENSIFY_LANES = (4, 8, 16, 32)
DENSIFY_THREADS = (128, 256, 512)


def kernel_ms(fn, mark, n=10, flush=None):
    """Device ms per call of the kernels whose name holds `mark` over n
    calls; with flush (a tensor larger than the L2 cache), each call after
    a write of it, so that the call reads its inputs from device memory."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            if flush is not None:
                flush.fill_(i)
            fn()
        torch.cuda.synchronize()
    us = sum(cs._device_us(e) for e in prof.key_averages() if mark in e.key)
    return us / n / 1000 if us > 0 else None


def _p_picture_calls(progs, first_p):
    import chip_smoke as cs
    import libde265_tpu_torch as lt
    fd = lt.FusedDecoder()
    fd.plan_stream(progs)
    return cs.capture_inputs(fd, progs[:first_p + 1])[first_p]


def _flush():
    import torch
    return torch.empty(32 << 20, dtype=torch.int32, device="cuda")  # 128 MB


def sweep_deblock(progs, first_p, smi):
    import torch
    from libde265_tpu_torch.ops import deblock_cuda as dc
    caps = _p_picture_calls(progs, first_p)
    saved = dict(dc.TILE)
    flush = _flush()
    try:
        for th, nt in DEBLOCK_SWEEP:
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
                run = lambda: fn(*args, **kw)    # noqa: E731
                row[f"{name}_ms"] = kernel_ms(run, "deblock_kernel")
                row[f"{name}_cold_ms"] = kernel_ms(run, "deblock_kernel",
                                                   flush=flush)
            print(json.dumps({"sweep": row, "card": smi}), flush=True)
    finally:
        dc.TILE.update(saved)


def sweep_densify(progs, first_p, smi):
    import torch
    from libde265_tpu_torch.ops import coef_cuda as cc
    (bins,), _ = _p_picture_calls(progs, first_p)["densify_bins"][0]
    saved = dict(cc.TILE), cc.THREADS
    flush = _flush()

    def measure(sel, row):
        got, _ = cc.densify_bins(sel)
        want, _ = cc.densify_bins_plain(sel)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"densify_bins {row} differs from plain")
        run = lambda: cc.densify_bins(sel)    # noqa: E731
        row["ms"] = kernel_ms(run, "densify_bins_kernel")
        row["cold_ms"] = kernel_ms(run, "densify_bins_kernel", flush=flush)
        print(json.dumps({"sweep": row, "card": smi}), flush=True)
        return row["ms"]

    try:
        for threads in DENSIFY_THREADS:
            cc.THREADS = threads
            best = {}
            for b in bins:
                S = b[3]
                for nbytes in DENSIFY_TILE_BYTES:
                    tus = max(1, nbytes // (4 * S * S))
                    for lanes in DENSIFY_LANES:
                        cc.TILE[S] = (tus, lanes)
                        ms = measure([b], {"S": S, "N": b[2], "tus": tus,
                                           "lanes": lanes,
                                           "threads": threads})
                        if ms is not None and ms < best.get(S, (1e9,))[0]:
                            best[S] = (ms, tus, lanes)
                cc.TILE[S] = saved[0][S]
            cc.TILE.update({S: v[1:] for S, v in best.items()})
            measure(bins, {"bins": "all", "threads": threads,
                           "tile": {S: cc.TILE[S] for S in cc.TILE}})
        cc.TILE.update(saved[0])
        cc.THREADS = saved[1]
        measure(bins, {"bins": "all", "threads": cc.THREADS, "tile":
                       {S: cc.TILE[S] for S in cc.TILE}, "wrapper": True})
    finally:
        cc.TILE.update(saved[0])
        cc.THREADS = saved[1]


def residual_inline(fdm, feed, sf_tables, st):
    """The residual section as a picture program without
    _residual_section runs it inside _frame_fn (one densify_bin call per
    size bin, the escape corrections on a copy of the levels with a scratch
    element): the same statements, on that checkout's modules."""
    import torch
    coef_cuda, tx, w = fdm.coef_cuda, fdm.tx, torch.where
    bd = st["bd"]
    bin_res = {}
    for lg in st["lgs"]:
        s = 1 << lg
        bf = feed[f"bin{lg}"]
        n = bf["qp"].shape[0]
        levels = coef_cuda.densify_bin(bf["cv"], bf["coff"], N=n, S=s)
        if "cfx" in bf:
            cfx = bf["cfx"].long()
            ok = (cfx >= 0) & (cfx < n * s * s)
            idx = w(ok, cfx, n * s * s)
            flat = torch.cat([levels.reshape(-1), levels.new_zeros(1)])
            flat[idx] = flat[idx] + bf["cfv"]
            levels = flat[:-1].view(n, s, s)
        flags = bf["flags"]
        tskip = (flags & fdm.TU_TRANSFORM_SKIP) != 0
        use_dst = (flags & fdm.TU_USE_DST) != 0
        bypass = (flags & fdm.TU_TQ_BYPASS) != 0
        if st["scaling"]:
            sf = sf_tables[lg - 2][bf["mid"].long()]
            res = tx.residual_batch(levels, tx.qp_to_fact(bf["qp"]), tskip,
                                    use_dst, lg, bd, sf=sf, qp=bf["qp"])
        else:
            res = tx.residual_batch(levels, tx.qp_to_fact(bf["qp"]), tskip,
                                    use_dst, lg, bd)
        bin_res[lg] = w(bypass[:, None, None], levels, res)
    return bin_res


def sections(progs, idx):
    """(name, (synced ms, device ms, device operations by name)) of the
    deblocking and the residual section of picture idx."""
    import chip_smoke as cs
    import libde265_tpu_torch as lt
    fdm = lt.fused_decode
    if hasattr(fdm, "_residual_section"):
        residual = cs.residual_section(progs, idx)
    else:
        residual = cs.section_alone(
            progs, idx, "_frame_fn",
            run=lambda _y, _cb, _cr, feed, sf_tables, st, _host:
            residual_inline(fdm, feed, sf_tables, st))
    return [("deblocking", cs.deblock_section(progs, idx)),
            ("residual", residual)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose libde265_tpu_torch is measured")
    ap.add_argument("--sweep", choices=("deblock", "densify"),
                    help="also sweep that kernel's tile shapes")
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
        for sec, (sms, dms, ops) in sections(progs, idx):
            print(json.dumps({"root": str(root), "section": sec,
                              "picture": f"{what} {idx}",
                              "synced_ms": sms, "device_ms": dms,
                              "device_ops": sum(ops.values()),
                              "ops": sorted(([v, k[:100]] for k, v in
                                             ops.items()), reverse=True),
                              "card": smi}), flush=True)
    if a.sweep == "deblock":
        sweep_deblock(progs, first_p, smi)
    elif a.sweep == "densify":
        sweep_densify(progs, first_p, smi)


if __name__ == "__main__":
    main()
