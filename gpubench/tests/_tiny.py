"""A throwaway checkout for the CPU tests, derived from BENCHMARK.json
alone: beside every configuration and cell a tiny copy (``tiny_<config>``,
``tiny_<cell>``), listed by every metric that lists the real cell, with
the tiny configuration files in the temporary directory only, so that
the harness is shown to find them by name.  A configuration or cell added
as files and entries gets its tiny copy with no edit here."""
from __future__ import annotations

import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from gbench import spec  # noqa: E402

CTBS_WIDE, CTBS_HIGH = 3, 2     # two CTB rows: WPP or tiles, 2 substreams
MAX_PX = 50_000
SPAN_PARSE = ("parse_wait_ms", "parse_busy_ms")   # PipelinedDecoder's parse
# a per-layer metric's copy in the cells that report fps per layer only
NOFPS = ".nofps"


def bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cells(root: Path = ROOT) -> list:
    """The names of root/BENCHMARK.json's cells, in its order."""
    return [w["name"] for w in bench(root)["workloads"]]


def configs(root: Path = ROOT) -> list:
    """The names of root/BENCHMARK.json's configurations, in its order."""
    return [c["name"] for c in bench(root)["configs"]]


def tiny(name: str) -> str:
    return f"tiny_{name}"


def tiny_config(config: str, root: Path = ROOT) -> dict:
    """The tiny copy of root/BENCHMARK.json's configuration `config`, by
    one rule: 3x2 CTBs of its own ctb-size, at most 3 (at least 2)
    segments of at most 8 pictures; encoder settings, content model and
    bit depth as in its file."""
    entry = {c["name"]: c for c in bench(root)["configs"]}[config]
    cfg = json.loads((root / entry["file"]).read_text())
    ctb = int(cfg["encoder"]["ctb-size"])
    cfg.update(name=tiny(config), width=CTBS_WIDE * ctb,
               height=CTBS_HIGH * ctb,
               segments=max(2, min(int(cfg["segments"]), 3)),
               pictures_per_segment=min(int(cfg["pictures_per_segment"]),
                                        8))
    assert cfg["width"] * cfg["height"] <= MAX_PX, config
    return cfg


def make_root(tmp: Path, src: Path = ROOT) -> Path:
    """tmp holding src's BENCHMARK.json with the tiny configurations and
    cells added, and their configuration files under tmp/gpubench/configs/."""
    b = bench(src)
    (tmp / "gpubench" / "configs").mkdir(parents=True, exist_ok=True)
    for c in list(b["configs"]):
        path = f"gpubench/configs/{tiny(c['name'])}.json"
        (tmp / path).write_text(json.dumps(tiny_config(c["name"], src)))
        b["configs"].append({"name": tiny(c["name"]), "source": "test",
                             "file": path, "reduced": [], "why": "test"})
    for w in list(b["workloads"]):
        b["workloads"].append(dict(w, name=tiny(w["name"]),
                                   config=tiny(w["config"]), why="test"))
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [tiny(w) for w in m["workloads"]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(b))
    return tmp


def made_up(root: Path, like: str) -> str:
    """A made-up configuration and its cell added to root as files and
    entries only: a copy of cell `like`'s configuration file under the name
    ``made_up_<config>`` with sign hiding switched, an entry in ``configs``
    and ``workloads``, a cell on `like`'s mix, listed by every metric that
    lists `like`.  Returns the cell."""
    b = bench(root)
    w = {x["name"]: x for x in b["workloads"]}[like]
    entry = {c["name"]: c for c in b["configs"]}[w["config"]]
    cfg = json.loads((root / entry["file"]).read_text())
    name = cfg["name"] = f"made_up_{cfg['name']}"
    cfg["encoder"]["sign-hiding"] = not cfg["encoder"].get("sign-hiding")
    path = f"gpubench/configs/{name}.json"
    (root / path).write_text(json.dumps(cfg))
    b["configs"].append(dict(entry, name=name, file=path, why="test"))
    cell = f"{name}.{w['traffic']}"
    b["workloads"].append(dict(w, name=cell, config=name, why="test"))
    for m in b["end_to_end"] + b["per_layer"]:
        if like in m.get("workloads", []):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return cell


def copy_root(tmp: Path, src: Path = ROOT) -> Path:
    """tmp holding src's BENCHMARK.json and the configuration files it
    names: a checkout to add files and entries to."""
    b = bench(src)
    for c in b["configs"]:
        (tmp / c["file"]).parent.mkdir(parents=True, exist_ok=True)
        (tmp / c["file"]).write_text((src / c["file"]).read_text())
    (tmp / "BENCHMARK.json").write_text(json.dumps(b))
    return tmp


def rate_metric(metric: str) -> str:
    """The rate whose cells a per-layer metric lists: ``fps`` (end to
    end), or for a ``.nofps`` copy ``fps.unbounded`` (per layer)."""
    return "fps.unbounded" if metric.endswith(NOFPS) else "fps"


def span_workloads(b: dict, metric: str) -> list:
    """The cells a ``program_span`` metric lists, by one rule: the cells
    that report its rate (``rate_metric``), less, for the parse spans of
    PipelinedDecoder, the cells whose mix's entry is ``gop_parallel``."""
    rate = {m["name"]: m for m in b["end_to_end"] + b["per_layer"]}[
        rate_metric(metric)]
    base = metric.removesuffix(NOFPS)
    return [w["name"] for w in b["workloads"]
            if spec.applies(rate, w["name"])
            and not (base in SPAN_PARSE and _entry(w) == "gop_parallel")]


def _entry(workload: dict) -> str:
    mix = BENCH / "traffic" / f"{workload['traffic']}.json"
    return json.loads(mix.read_text())["entry"]
