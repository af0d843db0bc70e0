"""Nothing the benchmark runs imports JAX, the JAX package or chip_smoke.

Top-level module names are compared whole: ``cigwas_tpu_torch`` begins
with ``cigwas_tpu`` and is the program under test."""

from __future__ import annotations

import ast
import subprocess
import sys

from h100bench import harness

from conftest import HERE, ROOT


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_of_the_benchmark_imports_a_forbidden_module():
    for path in HERE.rglob("*.py"):
        assert not _imports(path) & set(harness.FORBIDDEN), path


def test_the_names_are_compared_whole():
    assert "cigwas_tpu_torch" not in harness.FORBIDDEN
    assert "cigwas_tpu" in harness.FORBIDDEN


RUN = """
import sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads(2)
from h100bench import harness
import tempfile
from pathlib import Path
import conftest
import shutil
base = Path(tempfile.mkdtemp())
here, bench = conftest.make_tiny(base)
for w in bench["workloads"]:
    c = harness.cell(w["name"], bench, here=here)
    harness.run(c, bench, 11, 0.01, False, device="cpu")
shutil.rmtree(base)
print(harness.forbidden_modules())
"""


def test_a_run_loads_no_forbidden_module():
    """A whole run of every tiny cell in a fresh process, then sys.modules."""
    code = RUN.format(root=str(ROOT), tests=str(HERE / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
