"""The operation counts behind the benchmark's model and kernel metrics."""

from __future__ import annotations

import json
import os

import pytest

from benchmark import roofline
from benchmark.ncnn import macs_per_input_px, parse_convs
from conftest import BENCH


def _cfg(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(BENCH, "configs", cfg["param"])) as f:
        return cfg, parse_convs(f.read())


@pytest.mark.parametrize("name, macs, params, convs", [
    ("realsr-df2k-x4", 17_926_848, 16_697_987, 351),
    ("realesrgan-x4plus-anime-6b", 5_706_432, 4_467_779, 96),
])
def test_macs_and_parameters_from_the_param(name, macs, params, convs):
    cfg, cs = _cfg(name)
    assert len(cs) == convs
    assert macs_per_input_px(cs) == macs == cfg["macs_per_input_px"]
    assert sum(c.weights + (c.cout if c.bias else 0) for c in cs) == params == cfg["parameters"]


def test_the_param_counts_upsampled_convs_at_their_scale():
    _, cs = _cfg("realsr-df2k-x4")
    area = {c.name: c.area for c in cs}
    assert area["conv_first"] == area["trunk_conv"] == 1
    assert area["upconv1"] == 4 and area["upconv2"] == area["HRconv"] == area["conv_last"] == 16


def test_block_and_tail_macs():
    assert roofline.rdb_macs_per_px(64, 32) == 239_616
    assert roofline.tail_macs_per_out_px(64, 3) == 54_976
    cfg, cs = _cfg("realsr-df2k-x4")
    by = {c.name: c.macs_per_input_px for c in cs}
    tail = by["upconv2"] + by["HRconv"] + by["conv_last"]
    assert tail == 16 * 75_456  # upconv2 as the graph writes it: 9 taps
    assert tail - 16 * roofline.tail_macs_per_out_px(64, 3) == 16 * 5 * 64 * 64
    trunk = sum(v for k, v in by.items() if k.startswith("Conv_"))
    assert trunk == 69 * roofline.rdb_macs_per_px(64, 32)


@pytest.mark.parametrize("name, blocks", [("realsr-df2k-x4", 69), ("realesrgan-x4plus-anime-6b", 18)])
def test_trunk_and_tail_work(name, blocks):
    cfg, _ = _cfg(name)
    px = 12 * 276 * 276
    ops, moved = roofline.trunk_work(cfg, px)
    assert ops == 2 * blocks * 239_616 * px
    assert moved == blocks * px * 64 * 10
    ops, moved = roofline.tail_work(cfg, px)
    assert ops == 2 * 54_976 * 16 * px
    assert moved == px * 4 * 64 * 2 + px * 16 * 3 * 4
    # both compute-bound on the H100
    assert roofline.least_seconds(ops, moved) == ops / roofline.PEAK_FLOPS["bfloat16"]


def test_power_limit_says_why_without_a_card():
    assert isinstance(roofline.power_limit(), str)
