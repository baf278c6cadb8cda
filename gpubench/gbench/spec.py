"""Everything the harness runs is found by name: the cell in
``BENCHMARK.json``, its configuration file (``configs/<config>.json``,
named by the configuration's ``file``), its traffic mix
(``traffic/<traffic>.json``) and the reader of each metric
(``metrics/<metric>.py``).  A later change adds a configuration, a mix or
a metric by adding files and entries, without editing any file here."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent


@dataclass
class Cell:
    root: Path          # the checkout (BENCHMARK.json's directory)
    bench: dict
    workload: dict
    config: dict        # the configuration file's contents
    mix: dict           # the traffic mix's parameters
    metrics: list       # [(entry of BENCHMARK.json, reader module)]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    """Whether `metric` is reported in cell `cell`: listed there, or in
    every cell where it lists none."""
    return cell in metric["workloads"] if "workloads" in metric else True


def reader(name: str):
    """The module metrics/<name>.py (loaded by its path: metric names
    hold dots)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"gpubench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not callable(getattr(mod, "read", None)):
        raise ValueError(f"{path} has no read(run)")
    return mod


def cell(root: Path, name: str, trace: bool) -> Cell:
    """The cell `name` of root/BENCHMARK.json with the metrics a run with
    `trace` reports (the per-layer ones with trace, else the end-to-end
    ones)."""
    bench = load_json(root / "BENCHMARK.json")
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = by_name[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / cfgs[w["config"]]["file"])
    if config["name"] != w["config"]:
        raise ValueError(f"{cfgs[w['config']]['file']} names "
                         f"{config['name']!r}, not {w['config']!r}")
    mix = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    kind = "per_layer" if trace else "end_to_end"
    metrics = [(m, reader(m["name"])) for m in bench[kind]
               if applies(m, name)]
    return Cell(root=root, bench=bench, workload=w, config=config, mix=mix,
                metrics=metrics)
