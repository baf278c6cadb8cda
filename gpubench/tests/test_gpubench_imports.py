"""What the benchmark's processes load: never JAX or the JAX package
(top-level names compared whole), and the reference nothing of the
program; and nothing it runs reads the repository's other scripts."""
import ast
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

PROBE = """
import json, sys
sys.path.insert(0, {bench!r}); sys.path.insert(1, {root!r})
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _loaded(body: str):
    code = PROBE.format(bench=str(BENCH), root=str(ROOT), body=body)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax():
    body = """
import run, measure, control
from gbench import (content, driver, en265, faults, profiling, reference,
                    spec, stats, streams)
import libde265_tpu_torch
from libde265_tpu_torch import parallel, stream, fused_decode
from pathlib import Path
for p in sorted(Path({bench!r}, 'metrics').glob('*.py')):
    spec.reader(p.name[:-3])
""".format(bench=str(BENCH))
    mods = _loaded(body)
    assert "libde265_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "libde265_tpu"}


def test_reference_loads_nothing_of_the_program():
    mods = _loaded("from gbench import reference, content, streams, "
                   "en265, stats, peaks")
    assert not mods & {"libde265_tpu_torch", "libde265_tpu", "jax", "torch"}


def test_no_import_of_the_repository_scripts():
    """No source of the benchmark imports bench.py, chip_smoke.py,
    e2e_ab.py, scripts/ or tests/ (copies say where they came from)."""
    banned = {"bench", "chip_smoke", "e2e_ab", "scripts", "tests",
              "__graft_entry__"}
    for path in BENCH.rglob("*.py"):
        if "tests" in path.relative_to(BENCH).parts:
            continue
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in banned, (path, n)
