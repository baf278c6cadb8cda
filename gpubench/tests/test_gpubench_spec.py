"""BENCHMARK.json against the benchmark's files and the contract's
limits on names, units, keys and sizes."""
import json
import math
import re
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from gbench import spec  # noqa: E402

import _tiny  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["gpubench"]
    assert 1 <= len(bench["command"]) <= 32
    assert bench["command"][1] == "gpubench/run.py"
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p


def test_check_fits_with_24_cells(bench):
    rs = bench["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_entries_have_only_contract_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_names_units_and_text(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            for key in ("why", "layer", "source"):
                if key in e:
                    text = e[key]
                    assert 1 <= len(text) <= 200 and "\n" not in text \
                        and "\t" not in text, (e["name"], key)
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        ns = [n for g, n in names if g == group]
        assert len(ns) == len(set(ns))
    metric_names = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(metric_names) == len(set(metric_names))
    for c in bench["configs"]:
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k)
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_bounds_and_sources(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_configs_match_their_files(bench):
    files = set()
    for c in bench["configs"]:
        assert c["file"].startswith("gpubench/")
        assert c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        changed = [k for k in cfg["source_settings"]
                   if cfg["source_settings"][k] != cfg["used_settings"][k]]
        assert sorted(changed) == sorted(c["reduced"])
        for key in ("SourceWidth", "SourceHeight", "InputBitDepth",
                    "InputChromaFormat", "QP", "MaxCUWidth"):
            assert key not in c["reduced"]
        assert (cfg["width"], cfg["height"]) == (
            cfg["used_settings"]["SourceWidth"],
            cfg["used_settings"]["SourceHeight"])
        assert any(w["config"] == c["name"] for w in bench["workloads"])


def test_cells_find_their_files(bench):
    e2e = bench["end_to_end"]
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4)
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        for trace in (False, True):
            cell = spec.cell(ROOT, w["name"], trace)
            assert cell.config["name"] == w["config"]
            assert cell.metrics
        reported = [m["name"] for m in e2e if spec.applies(m, w["name"])]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(spec.applies(m, w["name"]) for m in bench["per_layer"])
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, math.floor(len(bench["workloads"]) * 0.25))


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader(bench, kind):
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench[kind]:
        mod = spec.reader(m["name"])
        assert callable(mod.read)
        for w in m.get("workloads", []):
            assert w in cells


def test_no_stray_files(bench):
    """Every mix and metric file is named by BENCHMARK.json."""
    mixes = {w["traffic"] for w in bench["workloads"]}
    assert {p.stem for p in (BENCH / "traffic").glob("*.json")} == mixes
    metrics = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    assert {p.name[:-3] for p in (BENCH / "metrics").glob("*.py")} == metrics
    cfgs = {Path(c["file"]).name for c in bench["configs"]}
    assert {p.name for p in (BENCH / "configs").glob("*.json")} == cfgs


def test_tiny_copies_follow_one_rule(tmp_path):
    """Every configuration and cell gets a tiny copy in the temporary
    directory only, shrunk by one rule, and every metric that lists a cell
    lists its copy."""
    root = _tiny.make_root(tmp_path)
    real = _tiny.bench()
    tiny = _tiny.bench(root)
    for c in real["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        t = spec.load_json(root / f"gpubench/configs/{_tiny.tiny(c['name'])}"
                           ".json")
        ctb = cfg["encoder"]["ctb-size"]
        assert t["width"] % ctb == 0 and t["height"] % ctb == 0
        assert t["height"] // ctb >= 2 and t["width"] // ctb >= 2
        assert t["width"] * t["height"] <= 50_000
        assert t["segments"] == max(2, min(cfg["segments"], 3))
        assert t["pictures_per_segment"] == min(cfg["pictures_per_segment"],
                                                8)
        for key in ("encoder", "content", "bit_depth", "content_seed"):
            assert t[key] == cfg[key], key
        assert not (BENCH / "configs" / f"{t['name']}.json").exists()
    by_name = {w["name"]: w for w in tiny["workloads"]}
    for w in real["workloads"]:
        t = by_name[_tiny.tiny(w["name"])]
        assert (t["config"], t["traffic"], t["chips"]) == (
            _tiny.tiny(w["config"]), w["traffic"], w["chips"])
    for m in tiny["end_to_end"] + tiny["per_layer"]:
        for w in m.get("workloads", []):
            if not w.startswith("tiny_"):
                assert _tiny.tiny(w) in m["workloads"], (m["name"], w)


def test_throwaway_config_from_a_temporary_directory(tmp_path):
    """A made-up configuration (b1080_ai's file under a new name, sign
    hiding off) and its cell, added by new files and entries only, run
    whole on the CPU through their tiny copy: correct, and not correct
    with a planted fault."""
    import time

    import torch

    import run
    from gbench import faults
    torch.set_num_threads(2)
    src = _tiny.copy_root(tmp_path / "src")
    cell = _tiny.made_up(src, "b1080_ai.stream")
    assert not (BENCH / "configs" / "made_up_b1080_ai.json").exists()
    root = _tiny.make_root(tmp_path / "root", src=src)
    cfg = spec.cell(root, _tiny.tiny(cell), False).config
    assert cfg["name"] == "tiny_made_up_b1080_ai"
    assert cfg["encoder"]["sign-hiding"] is False

    def one(fault=None):
        return run.run_cell(root, _tiny.tiny(cell), 2**31 + 77, 1.0, False,
                            "cpu", time.perf_counter(), fault=fault,
                            log=lambda *a: None)[0]
    res = one()
    assert res["correct"], res["checks"]
    assert {"fps", "setup_s"} <= set(res["metrics"])
    bad = one(faults.FAULTS["altered"])
    assert not bad["correct"] and bad["checks"]["mismatched"]["value"] > 0
