"""Every constant the PyTorch port copied equals the JAX package's array,
and importing the port never imports JAX or the JAX package."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import libde265_tpu.fused_decode as jfd
from libde265_tpu.ops import deblock as jdbk
from libde265_tpu.ops import intra_wave as jiw
from libde265_tpu.ops import mc as jmc
from libde265_tpu.ops import sao as jsao
from libde265_tpu.ops import transform as jtx

from libde265_tpu_torch import feed
from libde265_tpu_torch.ops import deblock, intra_wave, mc, sao, transform

REPO = Path(__file__).resolve().parent.parent

TABLES = [
    ("QPEL_FILTERS", mc.QPEL_FILTERS, jmc.QPEL_FILTERS),
    ("EPEL_FILTERS", mc.EPEL_FILTERS, jmc.EPEL_FILTERS),
    ("DCT32", transform.DCT32, jtx.DCT32),
    ("DST4", transform.DST4, jtx.DST4),
    ("LEVEL_SCALE", transform.LEVEL_SCALE, jtx.LEVEL_SCALE),
    ("BETA_TABLE", deblock.BETA_TABLE, jdbk.BETA_TABLE),
    ("TC_TABLE", deblock.TC_TABLE, jdbk.TC_TABLE),
    ("CHROMA_QP_TAB", deblock.CHROMA_QP_TAB, jdbk.CHROMA_QP_TAB),
    ("EO_D", sao.EO_D, jsao.EO_D),
    ("EDGE_CAT", sao.EDGE_CAT, jsao.EDGE_CAT),
]


@pytest.mark.parametrize("name,got,want", TABLES, ids=[t[0] for t in TABLES])
def test_table_equal(name, got, want):
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("s", [4, 8, 16, 32])
def test_dct_matrix_and_mode_tables(s):
    np.testing.assert_array_equal(transform.dct_matrix(s), jtx.dct_matrix(s))
    for got, want in zip(intra_wave.build_mode_tables(s),
                         jiw.build_mode_tables(s)):
        np.testing.assert_array_equal(got, want)


def test_feed_constants():
    assert feed.WAVE_CAP == jfd.WAVE_CAP
    assert feed.MAX_REFS == jfd.MAX_REFS
    assert feed.NOREF == jfd.NOREF
    assert feed.IREC_COLS == jfd.IREC_COLS
    assert feed.AVAIL_WORDS == jfd.AVAIL_WORDS


def _imported_by_chip_smoke():
    """Every module chip_smoke.py imports, at any depth of its code."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
            mods.update(f"{node.module}.{a.name}" for a in node.names)
    return sorted(mods)


def test_port_imports_no_jax():
    """Importing every module of the port, and everything chip_smoke.py
    imports, loads neither JAX nor the JAX package libde265_tpu."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    smoke = _imported_by_chip_smoke()
    for m in ("intra_cuda", "mc_seg", "expand"):
        assert f"libde265_tpu_torch.ops.{m}" in smoke, m
    code = f"""
import importlib, pkgutil, sys
import libde265_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in ("intra_window", "mc_seg", "expand"):
    assert "libde265_tpu_torch.ops." + m in names, names
for name in names:
    importlib.import_module(name)
for name in {smoke!r}:
    try:
        importlib.import_module(name)
    except ModuleNotFoundError:
        pass   # "from pkg import name" where name is not a module
bad = sorted(m for m in sys.modules
             if m in ("jax", "libde265_tpu") or
             m.startswith(("jax.", "jaxlib", "libde265_tpu.")))
assert not bad, bad
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
