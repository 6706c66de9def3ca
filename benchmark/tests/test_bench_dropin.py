"""The harness finds a configuration, a traffic mix and a per-layer metric
by name, so a later change adds them as new files and entries and edits
none; and a timed run never falls back to the CPU."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

from benchmark import run, traffic
from conftest import BENCH, ROOT, make_root

METRIC = '''"""Test metric: input megapixels completed."""


def read(records):
    return sum(w * h for w, h in records["done"]) / 1e6 or None
'''


def _digest(top: str) -> dict:
    out = {}
    for d, _, fs in os.walk(top):
        if "__pycache__" in d or "_build" in d:
            continue
        for f in fs:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), top)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_files_are_found_by_name(tmp_path, cpu_run):
    before = _digest(BENCH)
    root = make_root(tmp_path)
    with open(os.path.join(root, "metrics", "tiny.input_mp.py"), "w") as f:
        f.write(METRIC)
    with open(tmp_path / "BENCHMARK.json") as f:
        spec = json.load(f)
    spec["per_layer"].append({"name": "tiny.input_mp", "unit": "MP", "better": "higher", "source": "host_clock",
                              "layer": "model", "moves": "output_mp_per_s", "workloads": ["tiny.tiny"]})
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(spec, f)

    cell, centry = run.cell_of(spec, "tiny.tiny")
    cfg = run.load_config(root, centry)
    assert cfg["num_rrdb"] == 1 and len(cfg["convs"]) == 1 + 15 + 5
    mix = traffic.load_mix(root, cell["traffic"])
    a = traffic.make_images(mix, 9, torch.device("cpu"))
    b = traffic.make_images(mix, 9, torch.device("cpu"))
    c = traffic.make_images(mix, 10, torch.device("cpu"))
    assert [x.shape for x in a] == [(40, 72, 3)] * 3 and all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert run.read_metric(root, "tiny.input_mp", {"done": [(72, 40)] * 5}) == 72 * 40 * 5 / 1e6
    assert run.read_metric(root, "tiny.input_mp", {"done": []}) is None

    r = cpu_run(root, trace=True)
    assert r["correct"] and r["metrics"]["tiny.input_mp"]["unit"] == "MP"
    assert r["metrics"]["tiny.input_mp"]["value"] > 0
    assert _digest(BENCH) == before


def test_a_huge_or_negative_seed_draws_alike(tmp_path):
    root = make_root(tmp_path)
    mix = traffic.load_mix(root, "tiny")
    for seed in (2**31 + 5, 2**70, -3):
        x = traffic.make_images(mix, seed, torch.device("cpu"))
        assert np.array_equal(x[1], traffic.make_images(mix, seed, torch.device("cpu"))[1])


def _run(cwd: str) -> subprocess.CompletedProcess:
    cmd = [sys.executable, "benchmark/run.py", "--workload", "df2k-x4.photo-1024x768", "--seed", "1",
           "--seconds", "1", "--trace", "0"]
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=300)


def test_a_run_without_a_card_fails_and_prints_no_result():
    assert not torch.cuda.is_available()
    out = _run(ROOT)
    assert out.returncode == 3 and out.stdout.strip() == ""
    assert "needs 1 CUDA card" in out.stderr


def test_a_run_beside_nothing_but_the_benchmark_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("_build", "__pycache__"))
    out = _run(str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""
