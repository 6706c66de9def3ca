"""The per-layer metrics' readers on recorded records, and the device
trace's arithmetic (busy time as a union, idle gaps charged to the host's
innermost open event)."""

from __future__ import annotations

import collections

import pytest

from benchmark import devtrace, run
from benchmark.roofline import PEAK_FLOPS
from conftest import BENCH


@pytest.fixture
def records():
    spec = run.load_spec(BENCH)
    _, centry = run.cell_of(spec, "df2k-x4.photo-1024x768")
    cfg = run.load_config(BENCH, centry)
    kernels = [(0, "void rdb_kernel<17, float, 64, 32>(Params)", 0.001)] * (69 * 20)
    kernels += [(0, "void tail_kernel<12, 28, true, __nv_bfloat16>(TailParams)", 0.004)] * 20
    kernels += [(0, "elementwise_kernel", 0.0005)] * 100
    return {
        "config": cfg, "workload": "df2k-x4.photo-1024x768", "chips": 1, "window_s": 1.7,
        "done": [(1024, 768)] * 10, "latencies_ms": [170.0] * 10,
        "spans": {"h2d+prep": [0.01, 10], "dispatch": [0.02, 20], "fetch(D2H)": [1.5, 10]},
        "device": {"window_s": 1.75, "busy_s": {0: 1.70}, "kernels": kernels},
    }


def test_model_mfu(records):
    want = 100 * 2 * 17_926_848 * 1024 * 768 * 10 / (1.7 * 989e12)
    assert run.read_metric(BENCH, "model.mfu_pct", records) == pytest.approx(want)


def test_rooflines(records):
    px = 10 * 12 * 276 * 276
    trunk = 2 * 69 * 239_616 * px / PEAK_FLOPS["bfloat16"]
    tail = 2 * 54_976 * 16 * px / PEAK_FLOPS["bfloat16"]
    assert run.read_metric(BENCH, "kernel.trunk_roofline_pct", records) == pytest.approx(100 * trunk / (69 * 20 * 0.001))
    assert run.read_metric(BENCH, "kernel.tail_roofline_pct", records) == pytest.approx(100 * tail / (20 * 0.004))
    records["device"]["kernels"] = [k for k in records["device"]["kernels"] if "tail" not in k[1]]
    assert run.read_metric(BENCH, "kernel.tail_roofline_pct", records) is None


def test_idle_enqueue_and_mesh(records):
    assert run.read_metric(BENCH, "device.idle_pct", records) == pytest.approx(100 * (1 - 1.70 / 1.75))
    assert run.read_metric(BENCH, "engine.enqueue_ms", records) == pytest.approx(3.0)
    assert run.read_metric(BENCH, "mesh.idlest_card_pct", records) is None
    records["device"]["busy_s"] = {0: 1.7, 1: 1.4, 2: 1.6, 3: 1.65}
    assert run.read_metric(BENCH, "mesh.idlest_card_pct", records) == pytest.approx(100 * (1 - 1.4 / 1.75))
    records["device"] = None
    for name in ("device.idle_pct", "kernel.trunk_roofline_pct", "mesh.idlest_card_pct"):
        assert run.read_metric(BENCH, name, records) is None


def test_reported_metrics_follow_the_workload_lists():
    spec = run.load_spec(BENCH)
    e2e, layer = run.reported(spec, "df2k-x4.photo-1024x768")
    assert {m["name"] for m in e2e} == {"output_mp_per_s", "image_ms_p50", "image_ms_p95", "setup_s"}
    assert "mesh.idlest_card_pct" not in {m["name"] for m in layer}
    e2e, layer = run.reported(spec, "df2k-x4.mesh4-photo-2048x1024")
    assert "mesh.idlest_card_pct" in {m["name"] for m in layer}
    spec["end_to_end"][1]["workloads"] = ["x"]
    spec["per_layer"].append({"name": "y", "moves": "image_ms_p50"})
    assert "y" not in {m["name"] for m in run.reported(spec, "df2k-x4.photo-1024x768")[1]}


def test_union_and_gaps():
    assert devtrace._union([(5, 7), (0, 2), (1, 3), (7, 9)]) == [[0, 3], [5, 9]]
    gaps = [(3, 5), (9, 10), (20, 30)]
    host = [(0, 100, "outer"), (2, 6, "inner"), (8, 9, "ended"), (19, 40, "copy")]
    assert devtrace._charge(gaps, host) == collections.Counter({"inner": 2e-9, "outer": 1e-9, "copy": 10e-9})
    assert devtrace._charge([(1, 2)], []) == collections.Counter({"host: none traced": 1e-9})
