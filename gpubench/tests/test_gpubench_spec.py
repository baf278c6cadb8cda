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


def test_throwaway_config_from_a_temporary_directory(tmp_path):
    """A configuration and cells added by new files and entries only."""
    root = _tiny.make_root(tmp_path)
    cell = spec.cell(root, "tiny_ra.stream", False)
    assert cell.config["name"] == "tiny_ra"
    assert cell.config["width"] == _tiny.TINY["width"]
    assert not (BENCH / "configs" / "tiny_ra.json").exists()
    names = [m["name"] for m, _ in cell.metrics]
    assert names == ["fps", "device_mem_gib", "setup_s"]
    per_layer = [m["name"] for m, _ in
                 spec.cell(root, "tiny_ai.stream", True).metrics]
    assert "intra_scan_roofline" in per_layer
    assert "mc_roofline" not in per_layer
