#!/usr/bin/env python3
"""The persistent intra scan of one 1080p I picture on one CUDA card: its
CTA-size sweep, the clock64() phases of its steps and its ablations.

    python3 scripts/scan_probe.py [--root DIR] [--threads N ...]
                                  [--no-stamps] [--no-ablate]

Decodes the first picture of chip_smoke.py's 1920x1088 all-intra stream
with libde265_tpu_torch as DIR holds it (default: this checkout), the
scan's arguments recorded, then runs that scan alone: CUDA-event median ms
(launch included) and device ms (torch.profiler) a launch, each result
equal to the planes the decode left.  For a DIR whose kernel has a
build-time CTA size (csrc/intra.cu TDE_SCAN_THREADS; the decode's library
has 1024), each other size given (default 256, 512) is a build of its own.
Unless --no-stamps, the kernel is built again with TDE_SCAN_STAMPS defined
(each warp sums clock64() spans over the phases of a step) and run on the
same scan: per plane, cycles a step in each phase for the consumer warps
(mean and max over the warps) and the producer warp.  Unless --no-ablate,
the timing-only builds of TDE_SCAN_ABLATE (wrong output, not compared):
1 the producer warp alone, 2 its compaction alone (no record copies), 3
the consumer warps alone (every step on the first step's blocks).
One JSON line a reading, with the card's nvidia-smi line.  To compare two
checkouts, run both in one call on one card (parent, change, change,
parent): DIR may be a `git archive` of the parent unpacked in a directory
that .gitignore lists.
"""
from __future__ import annotations

import argparse
import ctypes as ct
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
ABLATIONS = {1: "producer alone", 2: "producer's compaction alone",
             3: "consumers alone"}
PHASES = ("barrier", "records, residual and gather", "filter and DC",
          "prediction and store", "producer")


def launch(lib, planes, scan):
    """The scan on `planes` through the kernel of library `lib`."""
    import torch
    from libde265_tpu_torch.ops import _build, intra_cuda
    a, _ = intra_cuda.fill_scan_args(planes, *scan)
    rc = lib.tde_intra_scan(ct.addressof(a),
                            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("tde_intra_scan (variant)", rc)
    return planes


def stamps(trace, src, root, smi):
    """The stamped kernel on the scan: per plane, cycles a step in each
    phase (consumer warps' mean and max, the producer's)."""
    import torch
    from libde265_tpu_torch.ops import _build, intra_cuda
    lib = _build.variant(src, ["TDE_SCAN_STAMPS"])
    planes = [p.clone() for p in trace.initial.values()]
    a, _ = intra_cuda.fill_scan_args(planes, *trace.scan)
    threads = lib.tde_scan_threads()
    nw = threads // 32
    buf = torch.zeros((len(planes), 32, len(PHASES)), dtype=torch.int64,
                      device=planes[0].device)
    a.stamps = buf.data_ptr()
    rc = lib.tde_intra_scan(ct.addressof(a),
                            torch.cuda.current_stream().cuda_stream)
    _build.check_launch("tde_intra_scan (stamps)", rc)
    torch.cuda.synchronize()
    for g, w in zip(planes, trace.final.values()):
        if not torch.equal(g, w):
            raise AssertionError("the stamped scan differs from the decode")
    acc = buf.cpu().numpy()
    for c in range(len(planes)):
        steps = a.planes[c].nsteps
        cons = acc[c, :nw - 1] / steps
        print(json.dumps({
            "root": str(root), "plane": c, "steps": steps,
            "threads": threads,
            "consumer_cycles_a_step_mean": dict(zip(
                PHASES[:4], cons[:, :4].mean(0).round(1).tolist())),
            "consumer_cycles_a_step_max": dict(zip(
                PHASES[:4], cons[:, :4].max(0).round(1).tolist())),
            "producer_cycles_a_step": dict(zip(
                (PHASES[0], PHASES[4]),
                (acc[c, nw - 1, [0, 4]] / steps).round(1).tolist())),
            "card": smi}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose libde265_tpu_torch is measured")
    ap.add_argument("--threads", type=int, nargs="+", default=[256, 512])
    ap.add_argument("--no-stamps", action="store_true")
    ap.add_argument("--no-ablate", action="store_true")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import libde265_tpu_torch as lt     # the measured checkout's port
    if Path(lt.__file__).resolve().parent.parent != root:
        raise SystemExit(f"imported {lt.__file__}, not the port of {root}")
    # this checkout's chip_smoke (stream, capture and readings)
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    smi = cs.card_check()
    import torch
    from libde265_tpu_torch import _native
    from libde265_tpu_torch.ops import _build, intra_cuda
    _native.build_tree()
    _build.lib()
    data, _ = cs.make_stream(cs.BUILD / "chip_smoke" / "1080p_intra_4f.h265",
                             1920, 1088, 4, 32,
                             {"intra-period": 1, "sao": True})
    _, progs = cs.oracle_programs(data)
    fd = lt.FusedDecoder()
    fd.plan_stream(progs)
    trace = cs.capture_inputs(fd, progs[:1])[0]["intra_scan"]
    shape = cs.scan_shape(trace)
    steps = max(shape["steps"])

    src = root / "libde265_tpu_torch" / "csrc" / "intra.cu"
    sized = b"TDE_SCAN_THREADS" in src.read_bytes()
    default = _build.lib().tde_scan_threads() if sized else None

    def reading(nt, fn, **extra):
        ev = cs.median_ms(fn)
        dev = cs.measured_device_ms(fn, "intra_scan", "intra_scan_kernel")
        print(json.dumps({"root": str(root), "threads": nt, **extra,
                          "steps": steps, "event_ms": ev, "device_ms": dev,
                          "device_us_a_step": 1e3 * dev / steps,
                          "scan_shape": shape, "card": smi}), flush=True)

    sizes = sorted({default, *args.threads}) if sized else [None]
    for nt in sizes:
        if nt == default:
            def run():
                return intra_cuda.intra_scan(
                    [p.clone() for p in trace.initial.values()], *trace.scan)
        else:
            lib = _build.variant(src, [f"TDE_SCAN_THREADS={nt}"])

            def run(lib=lib):
                return launch(lib, [p.clone() for p in trace.initial.values()],
                              trace.scan)
        got = run()
        torch.cuda.synchronize()
        for g, w in zip(got, trace.final.values()):
            if not torch.equal(g, w):
                raise AssertionError(f"threads {nt}: the scan differs from "
                                     f"the decode")
        reading(nt, run)
    if sized and not args.no_stamps:
        stamps(trace, src, root, smi)
    if sized and not args.no_ablate:
        for k, what in ABLATIONS.items():
            lib = _build.variant(src, [f"TDE_SCAN_ABLATE={k}"])
            reading(default, lambda lib=lib: launch(
                lib, [p.clone() for p in trace.initial.values()],
                trace.scan), ablation=what)
    print(smi)


if __name__ == "__main__":
    main()
