"""Shared set-up of the benchmark's CPU tests: the repository's root on the
path, and a benchmark root of a tiny cell that a CPU run can hold.

Run from the repository's root: ``python -m pytest benchmark/tests -q``
(the tests marked ``gpu`` skip without a card; on one they run the
control at the cells' own sizes).
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {"num_rrdb": 1, "nf": 16, "gc": 8}


def make_root(tmp, mesh: bool = False) -> str:
    """A checkout's copy of the benchmark with one more cell, ``tiny.tiny``:
    a 1-RRDB, nf 16 RRDBNet at tile 32 on 72 x 40 images, mixed precision."""
    from realsr_tpu_torch.models.rrdbnet import RRDBNetSpec
    from realsr_tpu_torch.ncnn.synth import make_rrdbnet_param_text

    tmp = str(tmp)
    root = os.path.join(tmp, "benchmark")
    for d in ("configs", "traffic", "limits", "drivers", "metrics"):
        shutil.copytree(os.path.join(BENCH, d), os.path.join(root, d))
    with open(os.path.join(root, "configs", "tiny.param"), "w") as f:
        f.write(make_rrdbnet_param_text(RRDBNetSpec(**TINY)))
    cfg = {"param": "tiny.param", **TINY, "in_ch": 3, "out_ch": 3, "num_upsample": 2, "prepadding": 10,
           "tilesize": 32, "storage": "mixed", "peak": "bfloat16"}
    mix = {"driver": "interactive", "mesh": mesh, "images": [{"w": 72, "h": 40, "count": 3, "channels": 3}],
           "check_samples": 2}
    for sub, name, obj in (("configs", "tiny", cfg), ("traffic", "tiny", mix),
                           ("limits", "tiny.tiny", {"rmse_u8": {"limit": 1.0}, "max_abs_u8": {"limit": 8}})):
        with open(os.path.join(root, sub, f"{name}.json"), "w") as f:
            json.dump(obj, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny", "source": "tests", "file": "benchmark/configs/tiny.json", "reduced": [],
                            "why": "a CPU run"})
    spec["workloads"].append({"name": "tiny.tiny", "config": "tiny", "traffic": "tiny", "chips": 1, "why": "a CPU run"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny.tiny")
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


@pytest.fixture
def cpu_run():
    """run.run_cell of the tiny cell on CPU devices (the look for a card
    skipped)."""
    import torch

    from benchmark import run

    def go(root, seed=20261017, seconds=0.3, trace=False, cards=1, **kw):
        return run.run_cell("tiny.tiny", seed, seconds, trace, root=root, devices=[torch.device("cpu")] * cards, **kw)

    return go
