"""Nothing the benchmark runs is JAX or the JAX package (compared by whole
top-level module names: ``realsr_tpu_torch`` begins with ``realsr_tpu``),
and the reference takes nothing of the program under test: by the sources'
imports, and by what a run has loaded."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "realsr_tpu"}


def _imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _sources(top: str) -> list:
    return [os.path.join(d, f) for d, _, fs in os.walk(top) for f in fs if f.endswith(".py")]


def test_no_source_imports_jax_or_the_jax_package():
    found = {p: _imports(p) & FORBIDDEN for p in _sources(BENCH)}
    assert not {p: n for p, n in found.items() if n}
    assert any("realsr_tpu_torch" in _imports(p) for p in _sources(BENCH))  # the scan sees whole names


def test_the_reference_imports_nothing_of_the_program():
    for p in _sources(os.path.join(BENCH, "reference")):
        assert not _imports(p) & {"realsr_tpu_torch", "realsr_tpu"}, p


def _loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport json, sys\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("import benchmark.reference.tiling, benchmark.reference.rrdbnet")
    assert "torch" in loaded and not loaded & (FORBIDDEN | {"realsr_tpu_torch"})


def test_a_run_loads_no_jax(tmp_path):
    code = (
        "import sys; sys.path.insert(0, 'benchmark/tests')\n"
        "import torch, conftest\n"
        "from benchmark import run\n"
        f"root = conftest.make_root({str(tmp_path)!r})\n"
        "r = run.run_cell('tiny.tiny', 3, 0.2, True, root=root, devices=[torch.device('cpu')])\n"
        "assert r['correct'] and not run.forbidden_modules(), r\n"
    )
    loaded = _loaded_after(code)
    assert "realsr_tpu_torch" in loaded and not loaded & FORBIDDEN
