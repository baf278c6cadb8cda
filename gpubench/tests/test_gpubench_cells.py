"""Every cell of BENCHMARK.json is one the harness takes as files and
entries: it resolves for both kinds of run, its configuration file names
itself, each metric that lists it has a reader, its tiny copy
(``_tiny.make_root``) reports the same metrics, and the span metrics list
it by their rule.  So does a made-up configuration and its cell, added in
a temporary directory.  Encodes and runs nothing."""
import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from gbench import spec  # noqa: E402

import _tiny  # noqa: E402


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return _tiny.make_root(tmp_path_factory.mktemp("root"))


def _check(root: Path, tiny_root: Path, cell: str):
    b = _tiny.bench(root)
    w = {x["name"]: x for x in b["workloads"]}[cell]
    entry = {c["name"]: c for c in b["configs"]}[w["config"]]
    cfg = json.loads((root / entry["file"]).read_text())
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"]
    for trace in (False, True):
        real = spec.cell(root, cell, trace)     # a reader without read raises
        assert real.config["name"] == w["config"]
        tiny = spec.cell(tiny_root, _tiny.tiny(cell), trace)
        assert tiny.config["name"] == _tiny.tiny(w["config"])
        assert tiny.mix == real.mix
        assert [m["name"] for m, _ in tiny.metrics] == \
            [m["name"] for m, _ in real.metrics]
    for m in b["per_layer"]:
        if m["source"] == "program_span":
            want = cell in _tiny.span_workloads(b, m["name"])
            assert spec.applies(m, cell) == want, m["name"]


@pytest.mark.parametrize("cell", _tiny.cells())
def test_cell_is_taken_as_files_and_entries(tiny_root, cell):
    _check(ROOT, tiny_root, cell)


def test_made_up_configuration_is_taken(tmp_path):
    root = _tiny.copy_root(tmp_path / "src")
    cell = _tiny.made_up(root, "b1080_ai.stream")
    assert cell not in _tiny.cells()
    _check(root, _tiny.make_root(tmp_path / "tiny", src=root), cell)
