"""A throwaway checkout for the CPU tests: the real BENCHMARK.json plus a
tiny configuration of each kind (random access and all intra) and a cell
for each traffic mix, the configuration files in the temporary directory
only, so that the harness is shown to find them by name."""
from __future__ import annotations

import copy
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

TINY = {"width": 128, "height": 64, "fps": 30}


def tiny_config(name: str, like: str) -> dict:
    cfg = json.loads((BENCH / "configs" / f"{like}.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg.update(TINY, name=name)
    if like == "b1080_ra":
        cfg.update(segments=2, pictures_per_segment=8)
    else:
        cfg.update(segments=3, pictures_per_segment=1)
    return cfg


def make_root(tmp: Path) -> Path:
    """tmp holding BENCHMARK.json with the tiny cells added and their
    configuration files under tmp/gpubench/configs/."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp / "gpubench" / "configs").mkdir(parents=True, exist_ok=True)
    for name, like in (("tiny_ra", "b1080_ra"), ("tiny_ai", "b1080_ai")):
        path = f"gpubench/configs/{name}.json"
        (tmp / path).write_text(json.dumps(tiny_config(name, like)))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": path, "reduced": [], "why": "test"})
    for cfg, mix in (("tiny_ra", "stream"), ("tiny_ai", "stream"),
                     ("tiny_ra", "segments")):
        bench["workloads"].append({"name": f"{cfg}.{mix}", "config": cfg,
                                   "traffic": mix, "chips": 1,
                                   "why": "test"})
    tiny = {"b1080_ra.stream": "tiny_ra.stream",
            "b1080_ai.stream": "tiny_ai.stream",
            "b1080_ra.segments": "tiny_ra.segments"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        for w in list(m.get("workloads", [])):
            m["workloads"].append(tiny[w])
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
