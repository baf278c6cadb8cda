#!/usr/bin/env python3
"""Run cells of the benchmark one after another, each run its own process
(as the benchmark's check runs them), and summarise the spread of each
metric: the distance between the first and third quartile as a share of
the median (statistics.quantiles, n=4).

    python3 gpubench/measure.py --out chiprun_out/runs.jsonl \
        b1080_ra.stream:101:40:0 b1080_ra.stream:102:40:0 ...

Each argument is workload:seed:seconds:trace.  Every run's last standard
output line (the result), exit code, seconds and the ends of its output
go to --out, one JSON object a line; the summary is printed.
"""
import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from gbench import stats  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=1200)
    ap.add_argument("runs", nargs="+")
    a = ap.parse_args()
    out = Path(a.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    values = defaultdict(list)
    with open(out, "a") as f:
        for spec in a.runs:
            w, seed, secs, trace = spec.split(":")
            cmd = [sys.executable, str(HERE / "run.py"), "--workload", w,
                   "--seed", seed, "--seconds", secs, "--trace", trace]
            t0 = time.perf_counter()
            try:
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=a.timeout, cwd=HERE.parent)
                rc, so, se = r.returncode, r.stdout, r.stderr
            except subprocess.TimeoutExpired as e:
                rc, so, se = 124, e.stdout or "", e.stderr or ""
                so = so.decode() if isinstance(so, bytes) else so
                se = se.decode() if isinstance(se, bytes) else se
            dt = time.perf_counter() - t0
            lines = so.strip().splitlines()
            try:
                res = json.loads(lines[-1]) if lines else None
            except json.JSONDecodeError:
                res = None
            rec = {"workload": w, "seed": int(seed), "seconds": float(secs),
                   "trace": int(trace), "rc": rc, "wall_s": dt,
                   "result": res, "stdout_tail": so[-3000:],
                   "stderr_tail": se[-3000:]}
            f.write(json.dumps(rec) + "\n")
            f.flush()
            short = {k: v["value"] for k, v in (res or {}).get(
                "metrics", {}).items()}
            print(f"{w} seed {seed} trace {trace}: rc {rc} "
                  f"{dt:.1f} s correct {(res or {}).get('correct')} "
                  f"{json.dumps(short)}", flush=True)
            if res is None:
                print(se[-2000:], flush=True)
            else:
                for k, v in res.get("metrics", {}).items():
                    values[(w, int(trace), k)].append(v["value"])
    for (w, trace, k), vs in sorted(values.items()):
        if len(vs) >= 2:
            med = sorted(vs)[len(vs) // 2]
            sp = stats.spread(vs) if len(vs) >= 2 else 0.0
            print(f"summary {w} trace {trace} {k}: n {len(vs)} median "
                  f"{med} spread {sp:.5f} values {vs}")


if __name__ == "__main__":
    main()
