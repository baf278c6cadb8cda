"""End-to-end decode speed of one checkout of the port, for comparing two
trees on the same card: the 1080p P-GOP and all-intra streams of
chip_smoke.py's phase 3 through PipelinedDecoder(), every frame held
bit-exact, several runs each, and the native parse alone.

    python3 e2e_ab.py [--root DIR] [--reps N]

--root is the checkout whose libde265_tpu_torch is measured (default: this
one); its native library and CUDA kernels are built there.  The streams
are encoded once under this checkout's build/chip_smoke (the same files
as chip_smoke.py's).  Run parent and change in turns in one call (parent,
change, change, parent) and compare only within it.  Prints one JSON
object per run: ms per picture end to end for each run of each stream,
their median, and the parse alone.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose port is measured")
    ap.add_argument("--reps", type=int, default=10,
                    help="decodes of each stream")
    args = ap.parse_args()
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))     # ahead of this checkout
    import torch
    import libde265_tpu_torch as lt
    if Path(lt.__file__).resolve().parent.parent != root:
        raise SystemExit(f"imported {lt.__file__}, not the port of {root}")
    smi = cs.card_check()
    cs.build_native()
    from libde265_tpu_torch.ops import _build
    _build.lib()

    streams = []
    for name, frames, period in (("P-GOP", 8, 4), ("all-intra", 4, 1)):
        fname = (f"1080p_{frames}f.h265" if period == 4
                 else "1080p_intra_4f.h265")
        data, _ = cs.make_stream(cs.BUILD / "chip_smoke" / fname, 1920,
                                 1088, frames, 32,
                                 {"intra-period": period, "sao": True})
        streams.append((name, data, cs.oracle_programs(data)[1]))
    warm = lt.PipelinedDecoder()
    for _, data, _ in streams:
        warm.decode_stream(data)
    torch.cuda.synchronize()

    out = {"root": str(root), "card": smi, "reps": args.reps}
    for name, data, progs in streams:
        ms = []
        for _ in range(args.reps):
            _, dt = cs.main_path_run(f"1080p {name}", data, progs)
            ms.append(1000 * dt / len(progs))
        out[name] = {"e2e_ms_per_picture": ms,
                     "median": statistics.median(ms),
                     "parse_ms_per_picture": cs.parse_ms(data)}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
