"""The port's native build (libde265_tpu_torch._native.build_tree) is safe
for concurrent processes: four processes that start at once on an empty
build directory all return a complete build, and only one of them builds.
A failed build raises with the build's output.

The CMake project is a small stand-in for native/ written into pytest's
tmp_path: a shared library, a tool linked against it, and a step that
fails if two builds run it at the same time and logs every run.
"""
import importlib.util
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

NATIVE = Path(__file__).resolve().parent.parent / "libde265_tpu_torch" / \
    "_native.py"

CMAKE = """\
cmake_minimum_required(VERSION 3.10)
project(lockcheck C)
add_custom_command(OUTPUT stamp.txt
                   COMMAND ${CMAKE_COMMAND} -DLOG=@LOG@
                           -P ${CMAKE_SOURCE_DIR}/slow.cmake
                   WORKING_DIRECTORY ${CMAKE_BINARY_DIR})
add_custom_target(slow ALL DEPENDS stamp.txt)
add_library(core SHARED core.c)
add_dependencies(core slow)
add_executable(tool tool.c)
target_link_libraries(tool core)
"""

SLOW = """\
if(EXISTS busy)
  message(FATAL_ERROR "two builds at once")
endif()
file(WRITE busy "")
file(APPEND ${LOG} "x")
execute_process(COMMAND ${CMAKE_COMMAND} -E sleep 1)
file(REMOVE busy)
file(WRITE stamp.txt "")
"""

# each process loads _native.py alone (no torch import), builds, and
# checks that the tool runs
CHILD = """\
import importlib.util, subprocess, sys
spec = importlib.util.spec_from_file_location("native_copy", sys.argv[1])
m = importlib.util.module_from_spec(spec)
spec.loader.exec_module(m)
build = m.build_tree(sys.argv[2], sys.argv[3])
out = subprocess.run([str(build / "tool")], capture_output=True, text=True,
                     check=True).stdout
assert out.strip() == "42", out
"""


def _project(root: Path, core_c: str) -> Path:
    src = root / "src"
    src.mkdir()
    log = root / "runs.log"
    (src / "CMakeLists.txt").write_text(CMAKE.replace("@LOG@", str(log)))
    (src / "slow.cmake").write_text(SLOW)
    (src / "core.c").write_text(core_c)
    (src / "tool.c").write_text(textwrap.dedent("""\
        #include <stdio.h>
        int answer(void);
        int main(void) { printf("%d\\n", answer()); return 0; }
        """))
    return src


def test_native_build_concurrent_processes(tmp_path):
    src = _project(tmp_path, "int answer(void) { return 42; }\n")
    build = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(NATIVE),
                               str(build), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    assert (tmp_path / "runs.log").read_text() == "x"   # one build ran
    assert (build / ".native.lock").exists()


def test_native_build_failure_raises_with_output(tmp_path):
    src = _project(tmp_path, "int answer(void) { return 42 }\n")
    spec = importlib.util.spec_from_file_location("native_copy", NATIVE)
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    with pytest.raises(RuntimeError, match="ninja.*failed") as e:
        m.build_tree(tmp_path / "build", src)
    assert "core.c" in str(e.value)
    assert tmp_path / "build" not in m._built
