"""Whole runs of the harness: on the CPU, every cell of BENCHMARK.json
through its tiny copy (``_tiny.make_root``) with the look for a card
skipped (the program as it is comes out correct; the control and each
planted fault come out not correct), and on the card (marked gpu) every
cell as it stands."""
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import run  # noqa: E402
from gbench import faults, spec  # noqa: E402

import _tiny  # noqa: E402

CELLS = [_tiny.tiny(c) for c in _tiny.cells()]
SEED = 2**31 + 4242


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    import torch
    torch.set_num_threads(2)
    return _tiny.make_root(tmp_path_factory.mktemp("root"))


def _run(root, cell, fault=None, trace=False, seconds=1.0):
    return run.run_cell(root, cell, SEED, seconds, trace, "cpu",
                        time.perf_counter(), fault=fault,
                        log=lambda *a: None)


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(root, cell):
    res, lines = _run(root, cell)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    assert "setup_s" in res["metrics"]
    assert len(lines) == len(res["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_per_layer_metrics(root, cell):
    """The line holds only the cell's per-layer metrics, and each of them
    that the host's clock gives (the probe's) reads above 0; the profiled
    ones need a card."""
    res, _ = _run(root, cell, trace=True)
    assert res["correct"]
    listed = {m["name"]: m for m, _ in spec.cell(root, cell, True).metrics}
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(got) <= set(listed)
    host = [n for n, m in listed.items() if m["source"] == "host_clock"]
    assert host and all(got.get(n, 0) > 0 for n in host), got


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["sao_off", "stale", "altered", "half"])
def test_control_and_faults_are_not_correct(root, cell, fault):
    res, _ = _run(root, cell, fault=faults.FAULTS[fault])
    assert not res["correct"], (fault, res["checks"])
    c = res["checks"]
    if fault == "half":
        assert c["missing"]["value"] > 0
    else:
        assert c["mismatched"]["value"] > 0


def test_exits_without_a_card_or_a_program(tmp_path):
    """With no card the CLI exits 1 and prints no result; in a directory
    that holds only BENCHMARK.json and gpubench/ it fails before one."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "gpubench/run.py", "--workload",
                        _tiny.cells()[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert not any(line.startswith("{") for line in r.stdout.splitlines())


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", _tiny.cells())
def test_cell_on_the_card(card, cell):
    r = subprocess.run([sys.executable, "gpubench/run.py", "--workload",
                        cell, "--seed", str(SEED), "--seconds", "3",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
