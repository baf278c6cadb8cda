#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the CUDA card.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell (BENCHMARK.json's workload), its
configuration, traffic mix and metric readers are found by name (see
gbench/spec.py).  The run builds the native library (through the
program), encodes the clip from the seed (or takes it from the cache under
build/gpubench/), builds the program's entry, warms it on the cell's own
requests, then measures for --seconds seconds (gbench/driver.py) and
judges the sampled pictures against the reference (gbench/reference.py).

Standard output: information lines, then as its last line one JSON
object: correct, attempted, failed, metrics (the end-to-end metrics with
--trace 0, the per-layer ones with --trace 1), device, with --trace 1
breakdown, and last checks (each number compared with its limit).  The
checks are also the last lines of standard error.  Exits 1 without a
result where torch sees no CUDA card or fewer than the cell asks for, and
3 where JAX or the JAX package is loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
# the program under test lives beside the benchmark, at the checkout's root
sys.path.insert(1, str(HERE.parent))

FORBIDDEN = ("jax", "jaxlib", "flax", "libde265_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def cache_env(root: Path):
    """Every build and kernel cache inside the checkout, at fixed paths."""
    base = root / "build" / "gpubench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(base / sub)


def host_sample() -> tuple:
    """(CPU seconds of the process, all its threads; of the calling
    thread alone)."""
    return time.process_time(), time.thread_time()


def host_line(a: tuple, b: tuple, pictures: int, wall_s: float) -> str:
    """The window's CPU seconds: the calling thread (the one that packs
    and launches) is busy most of the wall time, so its CPU seconds a
    picture say how fast the host ran the same work."""
    cpu, thread = b[0] - a[0], b[1] - a[1]
    n = max(pictures, 1)
    return (f"gpubench: host over the window: process cpu {cpu:.3f} s "
            f"({1000 * cpu / n:.3f} ms a picture), calling thread "
            f"{thread:.3f} s ({1000 * thread / n:.3f} ms a picture, busy "
            f"{thread / max(wall_s, 1e-9):.3f} of the wall)")


def steady_host():
    """One process with few threads: torch's CPU pool at one thread (the
    program's CPU work runs on the calling thread and the parse threads it
    starts).  Called before torch is imported."""
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, fault=None, log=print):
    """One run of cell `name` on `device`; returns (result, check lines).
    `fault` (tests and the control script only) is a context manager
    entered around the program's construction, warm-up and window."""
    import contextlib

    from gbench import driver, spec, streams

    cell = spec.cell(root, name, trace)
    cfg, mix = cell.config, cell.mix

    from libde265_tpu_torch import _native
    t0 = time.perf_counter()
    lib = Path(_native.build_tree()) / "libtde265.so"
    native_s = time.perf_counter() - t0
    clip = streams.clip_for(root, lib, cfg, seed)
    log(f"gpubench: clip {cfg['name']} seed {seed}: {clip.pictures} "
        f"pictures, {len(clip.data)} bytes, "
        f"{clip.mbit_per_s(cfg['fps']):.4f} Mbit/s at {cfg['fps']} fps, "
        f"segment order {clip.order}, md5 {clip.md5()}, encode_s {clip.encode_s:.3f} "
        f"({'cached' if clip.cached else f'{clip.workers} workers'}), "
        f"cpus {os.cpu_count()}, native build {native_s:.3f} s")

    run = driver.Run(seed=seed, seconds=seconds, trace=trace, device=device,
                     config=cfg, mix=mix)
    req = driver.request_streams(mix, clip)
    sync = driver.make_sync(device)
    h, w = cfg["height"], cfg["width"]
    checker = driver.Checker(mix, seed, req, device,
                             [(h, w), (h // 2, w // 2), (h // 2, w // 2)],
                             cfg["bit_depth"])
    expected = [len(x) for x in checker.want]
    order = driver.request_order(mix, len(req), seed)
    with (fault or contextlib.nullcontext)():
        entry = driver.Entry(mix, device)
        entry.warm(clip.data, req)
        sync()
        host0 = host_sample()
        t_window = time.perf_counter()
        run.setup_s = t_window - t_start - clip.encode_s
        run.window = win = driver.run_window(entry, req, order, seconds,
                                             sync, checker, expected, device)
        host1 = host_sample()
    if trace:
        run.trace_data, served = driver.profile_requests(
            entry, req, order, int(mix["profile_requests"]), sync)
        del entry
        run.probe, run.programs = driver.probe_layers(req, device, sync)
        run.traced_programs = [p for j in served for p in run.programs[j]]
    else:
        del entry
    sync()
    run.checked, run.mismatched = checker.judge()
    from libde265_tpu_torch.ops import _build
    log(f"gpubench: setup_s {run.setup_s:.4f}, kernel build "
        f"{_build.build_seconds} s; window {win.wall_s:.4f} s, "
        f"{win.requests} requests, {win.pictures} pictures")
    lat = sorted(1000 * x for x in win.latencies_s)
    if lat:
        q = [lat[int(f * (len(lat) - 1))] for f in (0, 0.25, 0.5, 0.75, 1)]
        log(f"gpubench: request ms min/q1/median/q3/max "
            f"{' / '.join(f'{v:.2f}' for v in q)}; first "
            f"{[round(1000 * x, 1) for x in win.latencies_s[:4]]}; "
            f"torch threads {_threads()}, cpus allowed "
            f"{len(os.sched_getaffinity(0))}")
    log(host_line(host0, host1, win.pictures, win.wall_s))
    for e in win.errors[:3]:
        log(f"gpubench: failed request:\n{e}")

    metrics = {}
    for m, mod in cell.metrics:
        v = mod.read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    attempted = sum(expected[j] for j in _served_streams(mix, len(req),
                                                         seed, win.requests))
    need = expected[0 if mix["request"] == "clip" else
                    next(driver.request_order(mix, len(req), seed))]
    checks = {
        "mismatched": {"value": run.mismatched, "limit": 0},
        "missing": {"value": win.missing, "limit": 0},
        "failed_requests": {"value": win.failed, "limit": 0},
        "too_few_checked": {"value": max(0, need - run.checked),
                            "limit": 0},
    }
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": attempted,
              "failed": win.missing, "metrics": metrics,
              "device": _device(device, win)}
    if trace and run.trace_data is not None:
        result["device"]["busy_s"] = run.trace_data.busy_s
        result["device"]["window_s"] = run.trace_data.window_s
        result["breakdown"] = run.trace_data.breakdown()
    result["checks"] = checks
    lines = [f"check {k} {c['value']} limit {c['limit']} (pictures "
             f"checked {run.checked})" for k, c in checks.items()]
    return result, lines


def _threads():
    import torch
    return torch.get_num_threads()


def _served_streams(mix, n, seed, requests):
    from gbench import driver
    order = driver.request_order(mix, n, seed)
    return [next(order) for _ in range(requests)]


def _device(device: str, win) -> dict:
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(win.memory_peak_bytes)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    faulthandler.enable()
    root = HERE.parent
    cache_env(root)
    steady_host()
    from gbench import spec
    bench = spec.load_json(root / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(
        a.workload)
    if chips is None:
        print(f"gpubench: no workload {a.workload!r}", file=sys.stderr)
        return 2
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gpubench: the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    result, lines = run_cell(root, a.workload, a.seed, a.seconds,
                             bool(a.trace), "cuda:0", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"gpubench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(f"gpubench: card {card_line()}", flush=True)
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
