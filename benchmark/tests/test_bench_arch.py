"""The architecture is a lookup: a configuration names its
``arch/<name>.py`` (``rrdbnet`` where it names none), and the harness takes
weights, model files, the plain forward and the control's rounding from it.

- A second architecture from new files alone: ``toy_arch.py`` beside this
  file dropped in as ``arch/toy.py``, with a configuration naming it, a
  traffic mix, a limits file and ``BENCHMARK.json`` entries; a CPU run of
  that cell is correct, reports its end-to-end metrics, and its control
  fails the cell's limits. No file of the benchmark is edited.
- A configuration naming an architecture with no module fails, naming the
  path it looked for.
- Identity pins: the sha256 of the ``.bin`` a run writes and of the
  reference's u8 outputs for the seed ``SEED``, taken with the harness's
  RRDB code as it stood before the lookup, for the tiny cell (through
  ``run.run_cell``, and through ``arch/rrdbnet.py`` with one RGBA image)
  and for ``realsr-df2k-x4``'s weights with one image at tile 32. The
  reference's hashes rest on PyTorch's float32 CPU convs (pinned with
  PyTorch 2.13 on x86-64).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from benchmark import compare, run, traffic
from benchmark.reference import tiling
from benchmark.weights import STREAM_IMAGES, generator
from conftest import BENCH, make_root

HERE = os.path.dirname(os.path.abspath(__file__))
CPU = torch.device("cpu")
SEED = 20261020

PINS = {
    "tiny": {
        "image": ((37, 50, 4), "84872272b243906fa6a7941fd912fc8b6b0a96f9c43a30b6cba8c8f3e9212ce3"),
        "bin": "2c8cbc319ebbf2331789d932c93cf759f6e39ad21d7616d7d651bcad30056d36",
        "reference_u8": "546f245b143aadfb2e23470bad63fa0c298feb7bb435339be0121cd21fdf58ac",
    },
    "realsr-df2k-x4": {
        "image": ((20, 36, 3), "1b5cc1a608605ab418d0750bbcc7638d9eb5823d41c189ce0160ea07fc42fc1e"),
        "bin": "34e5922a2ec93f91e6be706875b1f5723f2d47ab40afbbc8a679bea25347e60b",
        "reference_u8": "3951c734eb9286515a2a36ebd91df0356643ceee4243feb8581f203c0f5c92ed",
    },
}
# the tiny cell's run at SEED: the .bin it writes; the reference's outputs
# of its two sampled images
RUN_PINS = {
    "bin": ["2c8cbc319ebbf2331789d932c93cf759f6e39ad21d7616d7d651bcad30056d36"],
    "reference_u8": ["3848c9725776d4a0ee45656ab0d57ac762e348eb001d3707a6391604bb9a66b3",
                     "89b87e640878e7afcc24ff89a67d4840055096bcb26ae5e4ea1716b16799c7e4"],
}

# the toy cell's limits: over seeds 1-15 on the CPU the program read rmse
# 0.48-0.53 and max_abs 1-2, the float8 control rmse 1.78-3.12 and max_abs 11-17
TOY_LIMITS = {"rmse_u8": {"limit": 1.0, "lower": 0.53, "upper": 1.78},
              "max_abs_u8": {"limit": 6, "lower": 2, "upper": 11}}


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _files(top: str) -> dict:
    out = {}
    for d, _, fs in os.walk(top):
        if "__pycache__" in d or "_build" in d:
            continue
        for f in fs:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), top)] = _sha(fh.read())
    return out


def _add_cell(tmp_path, root: str, config: dict, workload: str, mix: str, files: dict) -> None:
    """Writes ``files`` ({path under root: JSON object or source text}) and
    appends the configuration and the cell (``config`` under the traffic
    ``mix``) to the root's BENCHMARK.json."""
    for rel, body in files.items():
        with open(os.path.join(root, rel), "w") as f:
            f.write(body if isinstance(body, str) else json.dumps(body))
    with open(tmp_path / "BENCHMARK.json") as f:
        spec = json.load(f)
    spec["configs"].append(config)
    spec["workloads"].append({"name": workload, "config": config["name"], "traffic": mix, "chips": 1,
                              "why": "a CPU run"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(workload)
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(spec, f)


def test_a_second_architecture_needs_new_files_only(tmp_path):
    root = make_root(tmp_path)
    before = _files(root)
    with open(os.path.join(HERE, "toy_arch.py")) as f:
        source = f.read()
    toy = {"architecture": "toy", "nf": 16, "in_ch": 3, "out_ch": 3, "scale": 4, "prepadding": 10, "tilesize": 32,
           "storage": "mixed", "peak": "bfloat16"}
    mix = {"driver": "interactive", "images": [{"w": 72, "h": 40, "count": 3, "channels": 3}], "check_samples": 2}
    added = {"arch/toy.py": source, "configs/toy.json": toy, "traffic/toy.json": mix,
             "limits/toy.tiny.json": TOY_LIMITS}
    _add_cell(tmp_path, root, {"name": "toy", "source": "tests", "file": "benchmark/configs/toy.json",
                               "reduced": [], "why": "a CPU run"}, "toy.tiny", "toy", added)
    after = _files(root)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == set(added) and not set(added) & set(_files(BENCH))

    r = run.run_cell("toy.tiny", SEED, 0.3, False, root=root, devices=[CPU], control=True)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0, r["check"]
    assert set(r["check"]) == {"failed", "rmse_u8", "max_abs_u8"}
    assert set(r["metrics"]) == {"output_mp_per_s", "image_ms_p50", "image_ms_p95", "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    limits = compare.load_limits(root, "toy.tiny")
    assert not compare.judge(r["control"][run.CONTROL], limits, 0)[0], r["control"]

    cfg = run.load_config(root, run.cell_of(run.load_spec(root), "toy.tiny")[1])
    assert cfg["scale"] == 4 and cfg["macs_per_input_px"] == 9 * 16 * (3 + 48)


def test_an_architecture_without_a_module_fails_naming_its_path(tmp_path):
    root = make_root(tmp_path)
    cfg = {"architecture": "nothing", "prepadding": 10, "tilesize": 32, "storage": "mixed", "peak": "bfloat16"}
    _add_cell(tmp_path, root, {"name": "nothing", "source": "tests", "file": "benchmark/configs/nothing.json",
                               "reduced": [], "why": "a CPU run"}, "nothing.tiny", "tiny",
              {"configs/nothing.json": cfg, "limits/nothing.tiny.json": TOY_LIMITS})
    with pytest.raises(FileNotFoundError, match=re.escape(os.path.join(root, "arch", "nothing.py"))):
        run.run_cell("nothing.tiny", SEED, 0.3, False, root=root, devices=[CPU])


@pytest.mark.parametrize("name", sorted(PINS))
def test_weights_and_reference_are_as_pinned(tmp_path, name):
    root = make_root(tmp_path) if name == "tiny" else BENCH
    entry = {c["name"]: c for c in run.load_spec(root)["configs"]}[name]
    cfg = run.load_config(root, entry)
    arch = run.arch_of(root, cfg)
    pin = PINS[name]
    weights = arch.weights(cfg, SEED, CPU)
    _, bin_path = arch.model_files(cfg, weights, str(tmp_path))
    with open(bin_path, "rb") as f:
        assert _sha(f.read()) == pin["bin"]
    (h, w, c), image_sha = pin["image"]
    img = traffic.photo(generator(SEED, STREAM_IMAGES, CPU), h, w, c, CPU).numpy()
    assert _sha(img.tobytes()) == image_sha
    ref = tiling.upscale(img, arch.net(cfg, weights), cfg["scale"], 32, cfg["prepadding"], CPU)
    assert ref.shape == (4 * h, 4 * w, c) and _sha(np.ascontiguousarray(ref).tobytes()) == pin["reference_u8"]


def test_a_run_writes_and_compares_as_pinned(tmp_path, monkeypatch):
    got = {"bin": [], "reference_u8": []}
    real_rmtree, real_upscale = shutil.rmtree, tiling.upscale

    def rmtree(path, *a, **k):
        p = os.path.join(path, "model.bin")
        if os.path.exists(p):
            with open(p, "rb") as f:
                got["bin"].append(_sha(f.read()))
        return real_rmtree(path, *a, **k)

    def upscale(*a, **k):
        out = real_upscale(*a, **k)
        got["reference_u8"].append(_sha(np.ascontiguousarray(out).tobytes()))
        return out

    root = make_root(tmp_path)
    monkeypatch.setattr(run.shutil, "rmtree", rmtree)
    monkeypatch.setattr(tiling, "upscale", upscale)
    r = run.run_cell("tiny.tiny", SEED, 0.3, False, root=root, devices=[CPU])
    assert r["correct"] and got == RUN_PINS
