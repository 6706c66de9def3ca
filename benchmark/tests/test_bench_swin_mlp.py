"""K10's roofline share (``metrics/kernel.swin_mlp_roofline_pct.py``): its
entry, and its reading on recorded kernel rows."""

import pytest

from benchmark import run
from conftest import BENCH

CELL = "swinir-l-x4.photo-1024x768"
NAME = "kernel.swin_mlp_roofline_pct"


def _config():
    return run.load_config(BENCH, run.cell_of(run.load_spec(BENCH), CELL)[1])


def test_entry_names_the_swinir_cell():
    spec = run.load_spec(BENCH)
    m = {x["name"]: x for x in spec["per_layer"]}[NAME]
    assert (m["layer"], m["source"], m["moves"], m["workloads"]) == ("kernels", "device_trace", "output_mp_per_s",
                                                                      [CELL])
    assert NAME in {x["name"] for x in run.reported(spec, CELL)[1]}


@pytest.mark.parametrize("share", [100.0, 40.0])
def test_reader_on_recorded_kernels(share):
    """One 1024 x 768 photo done (12 tiles of 276 x 276, 280 x 280 tokens
    each): 54 layers of 2 x 2 x 240 x 480 operations a token, bound by
    them (480 flop a byte of h read and m written), over the rows named
    swin_mlp only."""
    cfg = _config()
    ops = 12 * 280 * 280 * 54 * 2 * 2 * 240 * 480
    assert ops / (12 * 280 * 280 * 54 * 2 * 240 * 2) == 480
    least = ops / 989e12
    kernels = [(0, "void swin_mlp_kernel<48>(mlp::Params)", least * 100 / share),
               (0, "void swin_norm_kernel<240>", 1.0), (0, "nvjet_tst_128x240", 1.0)]
    records = {"config": cfg, "done": [(1024, 768)], "window_s": 1.0, "chips": 1, "spans": {},
               "device": {"kernels": kernels}}
    assert run.read_metric(BENCH, NAME, records) == pytest.approx(share)


def test_reader_without_the_kernel_reads_none():
    """The parent's trace (products on cuBLAS, GELU elementwise) and an
    untraced run have nothing to read."""
    cfg = _config()
    base = {"config": cfg, "done": [(1024, 768)], "window_s": 1.0, "chips": 1, "spans": {}}
    parent = [(0, "nvjet_tst_128x240", 1.0), (0, "vectorized_elementwise_kernel<8, GeluCUDAKernelImpl>", 1.0)]
    assert run.read_metric(BENCH, NAME, {**base, "device": {"kernels": parent}}) is None
    assert run.read_metric(BENCH, NAME, {**base, "device": None}) is None
