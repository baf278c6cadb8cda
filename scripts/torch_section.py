#!/usr/bin/env python3
"""Sections of the port's picture program on one CUDA card, for one
checkout, and the tile sweeps of their kernels.

    python3 scripts/torch_section.py [--root DIR]
                                     [--sweep deblock|densify|expand]

Measures libde265_tpu_torch as DIR holds it (default: this checkout), on
the 1920x1088 P-GOP of chip_smoke.py (this checkout's): the first I and the
first P picture, each decoded after the pictures before it, then its
deblocking section, its residual section (B4 densify of every size bin,
escape corrections, dequant + inverse transform) and its feed upload
(FusedDecoder._sparse_upload: block compaction into a pinned slot, copies,
B1; and beside it the whole feed of the picture uploaded instead) run
alone on the arguments they had (chip_smoke.section_alone: synced ms,
device ms, device operations by name), and the deblocking section's host
time alone (`deblock_host`: perf_counter_ns over batches of calls, no
profiler and no synchronisation inside a batch: the time the calling
thread spends to enqueue the section, which is what paces a decode whose
card is mostly idle), the same of its residual section (`residual_host`:
B4, then the dequant + inverse transform of every size bin, on the
picture's own feed) and of its intra section (`intra_host`:
the records into the scan's per-bin arrays and the scan, on the picture's
own feed, residuals and plane shapes, as the measured checkout runs the
section).  A checkout whose picture program
runs the residual section inline (no fused_decode._residual_section) gets
the same statements run on its modules (`residual_inline`).  Then the host
time of each step of one B1 wrapper call on the P picture's inputs
(`launch_steps`: perf_counter_ns over 1,000 calls of each step).

--sweep deblock (this checkout's kernels): B8 and B9 on the P picture's
calls at every tile height and CTA size the kernels take.  --sweep
densify: B4 on the P picture's call, each size bin alone at every tile
size, lanes per TU and CTA size, then the whole call with each CTA size's
best shapes and with the shapes the wrapper uses.  --sweep expand: B1 on
the P picture's call at every CTA size and output blocks per CTA, with
its CUDA-event ms, and its library yardstick rows[sel].  Device ms per call
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
EXPAND_SWEEP = [(nt, per) for nt in (64, 128, 256) for per in (1, 2, 4)]


def kernel_ms(fn, mark, n=10, flush=None):
    """Device ms per call of the kernels whose name holds `mark` over n
    calls (mark "" for all of them); with flush (a tensor larger than the
    L2 cache), each call after a write of it, so that the call reads its
    inputs from device memory (the fill kernel of that write not
    counted)."""
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
             if mark in e.key and (flush is None or
                                   "FillFunctor" not in e.key))
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


def sweep_deblock(caps, smi):
    import torch
    from libde265_tpu_torch.ops import deblock_cuda as dc
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


def sweep_densify(caps, smi):
    import torch
    from libde265_tpu_torch.ops import coef_cuda as cc
    (bins,), _ = caps["densify_bins"][0]
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


def sweep_expand(caps, smi):
    import torch
    import chip_smoke as cs
    from libde265_tpu_torch.ops import expand as ex
    (blocks, inv), kw = caps["expand_blocks"][0]
    saved = ex.TILE
    flush = _flush()
    want = ex.expand_blocks_plain(blocks, inv, **kw)
    try:
        for nt, per in EXPAND_SWEEP:
            ex.TILE = (nt, per)
            got = ex.expand_blocks(blocks, inv, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"expand_blocks at {nt} threads, {per} "
                                     f"blocks a CTA differs from plain")
            run = lambda: ex.expand_blocks(blocks, inv, **kw)  # noqa: E731
            row = {"threads": nt, "blocks_per_cta": per,
                   "ms": kernel_ms(run, "expand_kernel"),
                   "cold_ms": kernel_ms(run, "expand_kernel", flush=flush),
                   "event_ms": cs.median_ms(run),
                   "wrapper": (nt, per) == saved}
            print(json.dumps({"sweep": row, "card": smi}), flush=True)
    finally:
        ex.TILE = saved
    lib = cs.expand_library_call(blocks, inv, **kw)
    print(json.dumps({"sweep": {"library": "rows[sel]",
                                "ms": kernel_ms(lib, ""),
                                "cold_ms": kernel_ms(lib, "", flush=flush),
                                "event_ms": cs.median_ms(lib)},
                      "card": smi}), flush=True)


def launch_steps(caps, root, smi, n=1000):
    """Host us of each step of one expand_blocks call on the P picture's
    inputs, as the measured checkout's wrapper takes them (perf_counter_ns
    over n calls of the step alone, no sync inside), and of the whole
    wrapper and rows[sel] the same way."""
    import ctypes as ct
    import time
    import torch
    import chip_smoke as cs
    from libde265_tpu_torch.ops import _build, _tensors, expand
    (blocks, inv), kw = caps["expand_blocks"][0]
    total, B = kw["total"], kw["B"]
    nb = (total + B - 1) // B
    out = expand.expand_blocks(blocks, inv, **kw)
    fn = _build.lib().tde_expand_blocks
    ptrs = (blocks.data_ptr(), inv.data_ptr(), out.data_ptr())
    stream = _tensors.stream_of(blocks)
    if hasattr(expand, "_Args"):     # one argument struct, built per call
        def call():
            a = expand._Args(*ptrs, total, blocks.shape[0], nb, B,
                             *expand.TILE)
            return fn(ct.addressof(a), stream)
    else:                            # eight converted arguments
        def call():
            return fn(ptrs[0], blocks.shape[0], ptrs[1], nb, ptrs[2], total,
                      B, stream)
    dev = blocks.device
    steps = {
        "on_cuda": lambda: _tensors.on_cuda("expand_blocks", blocks),
        "check": lambda: _tensors.check("expand_blocks", dev, torch.int32,
                                        blocks, inv),
        "shape checks": lambda: (blocks.dim() != 2 or blocks.shape[1] != B
                                 or inv.shape != (nb,)),
        "alignment check": lambda: B % 4 or blocks.data_ptr() % 16,
        "torch.empty": lambda: torch.empty(total, dtype=torch.int32,
                                           device=dev),
        "new_empty": lambda: blocks.new_empty(total),
        "_build.lib()": _build.lib,
        "data_ptr x3": lambda: (blocks.data_ptr(), inv.data_ptr(),
                                out.data_ptr()),
        "stream_of": lambda: _tensors.stream_of(blocks),
        "current_stream().cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "ctypes call": call,
        "check_launch": lambda: _build.check_launch("tde_expand_blocks", 0),
        "expand_blocks": lambda: expand.expand_blocks(blocks, inv, **kw),
        "rows[sel]": cs.expand_library_call(blocks, inv, total, B),
    }
    us = {}
    for name, step in steps.items():
        for _ in range(10):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(n):
            step()
        us[name] = (time.perf_counter_ns() - t0) / n / 1000
        torch.cuda.synchronize()
    print(json.dumps({"root": str(root), "launch_steps_us": us,
                      "card": smi}), flush=True)


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


def section_host(progs, idx, name, batches=7, n=100):
    """Host us per call of fused_decode.<name> (a section of the picture
    program) on picture idx's arguments (the pictures before it decoded
    first; _timed_batches)."""
    import libde265_tpu_torch as lt
    fdm = lt.fused_decode
    fd = lt.FusedDecoder()
    fd.plan_stream(progs)
    for p in progs[:idx]:
        fd.decode(p)
    section, seen = getattr(fdm, name), []

    def record(*a, **k):
        seen.append((a, k))
        return section(*a, **k)

    setattr(fdm, name, record)
    try:
        fd.decode(progs[idx])
    finally:
        setattr(fdm, name, section)
    a, k = seen[0]
    return _timed_batches(lambda: section(*a, **k), batches, n)


def _timed_batches(fn, batches, n):
    """Host us of fn: the mean of each batch of n calls (perf_counter_ns
    around the batch, synchronised before and after it, not inside),
    median and least over the batches; and the synced us of one call,
    median over the batches' first calls."""
    import time
    import statistics
    import torch
    for _ in range(10):
        fn()
    means, synced = [], []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        fn()
        torch.cuda.synchronize()
        synced.append((time.perf_counter_ns() - t0) / 1000)
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        means.append((time.perf_counter_ns() - t0) / n / 1000)
        torch.cuda.synchronize()
    return {"host_us": statistics.median(means), "host_us_min": min(means),
            "host_us_batches": means, "synced_us": statistics.median(synced)}


def intra_host(progs, idx, batches=7, n=20):
    """Host us per run of the intra section of picture idx (the pictures
    before it decoded first; _timed_batches): the picture's _frame_fn
    arguments captured while it decodes, its residuals from them
    (_residual_section), zero planes of its shapes before the scan; then
    fused_decode._intra_section.  n is small: each call enqueues the scan,
    some hundreds of us of device time at 1080p."""
    import torch
    import libde265_tpu_torch as lt
    fdm = lt.fused_decode
    fd = lt.FusedDecoder()
    fd.plan_stream(progs)
    for p in progs[:idx]:
        fd.decode(p)
    frame_fn, seen = fdm._frame_fn, []

    def record(*a):
        seen.append(a)
        return frame_fn(*a)

    fdm._frame_fn = record
    try:
        fd.decode(progs[idx])
    finally:
        fdm._frame_fn = frame_fn
    _, _, _, feed, sf_tables, st, host = seen[0]
    bin_res = fdm._residual_section(feed, sf_tables, st)
    dev = feed["pu"].device
    shapes = [(st["H"], st["W"])] + \
        ([] if st["mono"] else [(st["ch"], st["cw"])] * 2)
    planes = [torch.zeros(s, dtype=torch.int32, device=dev) for s in shapes]
    return _timed_batches(
        lambda: fdm._intra_section(planes, feed, bin_res, st, host), batches,
        n)


def sections(progs, idx):
    """(name, (synced ms, device ms, device operations by name)) of the
    deblocking, the residual and the upload section of picture idx, and of
    the whole-feed upload of the same picture."""
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
    upload, whole = cs.upload_section(progs, idx)
    return [("deblocking", cs.deblock_section(progs, idx)),
            ("residual", residual), ("upload", upload),
            ("upload (whole feed)", whole)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose libde265_tpu_torch is measured")
    ap.add_argument("--sweep", choices=("deblock", "densify", "expand"),
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
        for sec, name in (("deblock_host", "_deblock_section"),
                          ("residual_host", "_residual_section")):
            print(json.dumps({"root": str(root), "section": sec,
                              "picture": f"{what} {idx}",
                              **section_host(progs, idx, name),
                              "card": smi}), flush=True)
        print(json.dumps({"root": str(root), "section": "intra_host",
                          "picture": f"{what} {idx}",
                          "intra_records": len(progs[idx].intras),
                          **intra_host(progs, idx), "card": smi}),
              flush=True)
    caps = _p_picture_calls(progs, first_p)
    launch_steps(caps, root, smi)
    if a.sweep:
        {"deblock": sweep_deblock, "densify": sweep_densify,
         "expand": sweep_expand}[a.sweep](caps, smi)


if __name__ == "__main__":
    main()
