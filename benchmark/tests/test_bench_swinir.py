"""The Real-SwinIR architecture of the harness (``arch/swinir.py``, the
reference ``reference/swinir.py``, the readers of its Swin kernels).

- The published configuration's work: ``macs_per_input_px`` 30,669,552 (the
  Swin layers 26,542,080, the bodies 2,628,000, conv_first 6,480, the tail
  1,492,992) and the per-token counts of K8 and K9.
- A tiny SwinIR cell (embed 32, 2 heads, depths [2, 2]) from new files
  alone, run through ``run.run_cell`` on CPU devices as the toy is in
  ``test_bench_arch.py``: correct, its end-to-end metrics, its control
  failing its limits; traced, the program's Swin counters read.
- The readers on recorded kernels and counters, and None where the program
  recorded none of theirs (the parent of the change that added them).
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from benchmark import compare, run
from conftest import BENCH, make_root

CPU = torch.device("cpu")
SEED = 4294967311  # past 32 bits
CELL = "swinir-l-x4.photo-1024x768"
NEW = ("model.swin_mfu_pct", "kernel.window_attn_roofline_pct", "kernel.swin_norm_roofline_pct",
       "swin.useful_token_pct")
TINY = {"architecture": "swinir", "upscale": 4, "in_chans": 3, "img_size": 64, "window_size": 8, "img_range": 1.0,
        "depths": [2, 2], "embed_dim": 32, "num_heads": [2, 2], "mlp_ratio": 2, "upsampler": "nearest+conv",
        "resi_connection": "3conv", "prepadding": 10, "tilesize": 32, "storage": "mixed", "peak": "bfloat16"}
# the tiny cell's limits: over 5 seeds on the CPU the program read rmse
# 0.86-1.57 and max_abs 4-6 (conv_last's gain, set for the published width,
# spreads the tiny model's output wide), the float8 control rmse 11.8-26.9
# and max_abs 55-108
LIMITS = {"rmse_u8": {"limit": 4.0}, "max_abs_u8": {"limit": 20}}


def _config():
    return run.load_config(BENCH, run.cell_of(run.load_spec(BENCH), CELL)[1])


def test_published_work_counts():
    cfg = _config()
    assert cfg["scale"] == 4 and cfg["macs_per_input_px"] == 30_669_552
    assert cfg["window_attn_flops_per_token"] == 54 * 61_440
    assert cfg["window_attn_bytes_per_token"] == 54 * 1_920
    assert cfg["swin_norm_bytes_per_token"] == 340_320
    arch = run.arch_of(BENCH, cfg)
    with open(os.path.join(os.path.dirname(BENCH), "benchmark", "configs", "realswinir-l-x4.json")) as f:
        assert json.load(f)["macs_per_input_px"] == arch.macs_per_input_px(cfg)


def test_published_state_dict_keys():
    """The weights carry SwinIR's keys and shapes at the published settings
    (28,013,059 parameters), as the program's loader reads them."""
    from realsr_tpu_torch.models import swinir as S

    cfg = _config()
    arch = run.arch_of(BENCH, cfg)
    small = dict(cfg, depths=[1], num_heads=[8])  # one layer: the keys' shapes without the full draw
    sd = arch.weights(small, SEED, CPU)
    spec = S.SwinIRSpec(depths=(1,), num_heads=(8,))
    assert {k: tuple(v.shape) for k, v in sd.items()} == dict(S.state_keys(spec))
    assert sum(int(torch.Size(s).numel()) for _, s in S.state_keys(S.SwinIRSpec())) == cfg["parameters"]


def _add_tiny(tmp_path) -> str:
    root = make_root(tmp_path)
    with open(os.path.join(root, "configs", "swinir-tiny.json"), "w") as f:
        json.dump(TINY, f)
    with open(os.path.join(root, "limits", "swinir.tiny.json"), "w") as f:
        json.dump(LIMITS, f)
    with open(tmp_path / "BENCHMARK.json") as f:
        spec = json.load(f)
    spec["configs"].append({"name": "swinir-tiny", "source": "tests", "file": "benchmark/configs/swinir-tiny.json",
                            "reduced": [], "why": "a CPU run"})
    spec["workloads"].append({"name": "swinir.tiny", "config": "swinir-tiny", "traffic": "tiny", "chips": 1,
                              "why": "a CPU run"})
    for m in spec["per_layer"]:
        if m["name"] in NEW:
            m["workloads"].append("swinir.tiny")
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(spec, f)
    return root


def test_a_tiny_swinir_cell_runs_from_new_files(tmp_path):
    root = _add_tiny(tmp_path)
    r = run.run_cell("swinir.tiny", SEED, 0.3, False, root=root, devices=[CPU], control=True)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0, r["check"]
    assert set(r["metrics"]) == {"output_mp_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    limits = compare.load_limits(root, "swinir.tiny")
    assert not compare.judge(r["control"][run.CONTROL], limits, 0)[0], r["control"]


def test_a_traced_tiny_swinir_cell_reads_the_swin_counters(tmp_path, monkeypatch):
    """Traced on the CPU with the program's tracer on: the useful-token
    share (72 x 40 at tile 32: tiles of 52 x 52, 28 x 52, 52 x 28 and
    28 x 28 with the halo, padded to whole windows) and the MFU read; the kernel shares,
    which need a card's kernels, read None."""
    from realsr_tpu_torch import engine as engine_mod
    from realsr_tpu_torch.utils import trace

    on = trace.StageTimer(enabled=True)
    monkeypatch.setattr(trace, "tracer", on)
    monkeypatch.setattr(engine_mod, "tracer", on)
    root = _add_tiny(tmp_path)
    r = run.run_cell("swinir.tiny", SEED, 0.3, True, root=root, devices=[CPU])
    m = {k: v["value"] for k, v in r["metrics"].items()}
    own = 72 * 40
    ran = 2 * 56 * 56 + 32 * 56 + 2 * 56 * 32 + 32 * 32
    assert m["swin.useful_token_pct"] == pytest.approx(100 * own / ran)
    assert m["model.swin_mfu_pct"] > 0
    assert "kernel.window_attn_roofline_pct" not in m and "kernel.swin_norm_roofline_pct" not in m


def test_readers_on_recorded_kernels():
    """The roofline shares on a recorded window: one 1024 x 768 photo done
    (12 tiles of 276 x 276, 280 x 280 tokens each) and kernel rows of known
    length."""
    from benchmark.roofline import PEAK_BYTES_PER_S

    cfg = _config()
    tokens = 12 * 280 * 280
    k8_least = tokens * cfg["window_attn_bytes_per_token"] / PEAK_BYTES_PER_S
    k9_least = tokens * cfg["swin_norm_bytes_per_token"] / PEAK_BYTES_PER_S
    kernels = [(0, "void window_attn_kernel<8, 30>", 2 * k8_least), (0, "void swin_norm_kernel<240>", 4 * k9_least),
               (0, "void tail_kernel<12, 28, true>", 1.0)]
    records = {"config": cfg, "done": [(1024, 768)], "window_s": 1.0, "chips": 1, "spans": {},
               "device": {"kernels": kernels}}
    assert run.read_metric(BENCH, "kernel.window_attn_roofline_pct", records) == pytest.approx(50.0)
    assert run.read_metric(BENCH, "kernel.swin_norm_roofline_pct", records) == pytest.approx(25.0)
    assert run.read_metric(BENCH, "model.swin_mfu_pct", records) == pytest.approx(
        100 * 2 * 30_669_552 * 1024 * 768 / 989e12)


@pytest.mark.parametrize("name", NEW)
def test_readers_find_nothing(name):
    records = {"config": _config(), "done": [], "window_s": 1.0, "chips": 1, "spans": {},
               "device": {"kernels": [(0, "void rdb_kernel<17>", 1.0)]}}
    assert run.read_metric(BENCH, name, records) is None


def test_entries_name_the_cell():
    spec = run.load_spec(BENCH)
    e2e, layer = run.reported(spec, CELL)
    assert {m["name"] for m in e2e} == {"output_mp_per_s", "setup_s"}
    assert {m["name"] for m in layer} == set(NEW)
