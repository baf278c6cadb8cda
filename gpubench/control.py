#!/usr/bin/env python3
"""The control and the planted faults of a cell, at the cell's own size,
on the card: never part of a benchmark run.

    python3 gpubench/control.py --workload b1080_ra.stream \
        --fault sao_off --seconds 10 --seeds 11 12 13

Runs the cell once a seed in this process with the fault entered around
the program's construction, warm-up and window (gbench/faults.py), and
prints each run's checks: the control has to come out not correct.
--fault none runs the program as it is (the lower reading).
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import run  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True,
                    choices=["none", "sao_off", "stale", "altered", "half"])
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args()
    run.cache_env(HERE.parent)
    from gbench import faults
    fault = None if a.fault == "none" else faults.FAULTS[a.fault]
    for seed in a.seeds:
        res, lines = run.run_cell(HERE.parent, a.workload, seed, a.seconds,
                                  False, "cuda:0", time.perf_counter(),
                                  fault=fault)
        print(json.dumps({"workload": a.workload, "fault": a.fault,
                          "seed": seed, "correct": res["correct"],
                          "checks": res["checks"],
                          "metrics": res["metrics"]}), flush=True)


if __name__ == "__main__":
    main()
