"""The plain reference held to the program on the CPU at a tiny size: the
port's float32 engine (plain convs) against ``reference/`` on the same
weights and images, and the reference's pieces against their definitions."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.ncnn import parse_convs, write_bin
from benchmark.reference.rrdbnet import forward, fp8
from benchmark.reference.tiling import cubic_matrix, padded_px, reflect101, tiles, upscale
from benchmark.traffic import photo
from benchmark.weights import generator, split, trained_weights
from conftest import TINY


@pytest.fixture(scope="module")
def tiny_model(tmp_path_factory):
    from realsr_tpu_torch.models.rrdbnet import RRDBNetSpec
    from realsr_tpu_torch.ncnn.synth import make_rrdbnet_param_text

    d = tmp_path_factory.mktemp("model")
    param = d / "x4.param"
    param.write_text(make_rrdbnet_param_text(RRDBNetSpec(**TINY)))
    convs = parse_convs(param.read_text())
    w, b = trained_weights(convs, 5, torch.device("cpu"), TINY["num_rrdb"])
    write_bin(str(d / "x4.bin"), convs, w.numpy(), b.numpy())
    return str(param), str(d / "x4.bin"), split(convs, w, b)


@pytest.mark.parametrize("shape", [(40, 72, 3), (37, 50, 4), (1, 33, 3)])
def test_reference_matches_the_float32_engine(tiny_model, shape):
    from realsr_tpu_torch.engine import EngineConfig, RealSR

    param, bin_, layers = tiny_model
    h, w, c = shape
    img = photo(generator(11, 2, torch.device("cpu")), h, w, c, torch.device("cpu")).numpy()
    eng = RealSR(gpuid=-1, config=EngineConfig(tilesize=32, prepadding=10, storage="float32"))
    eng.load(param, bin_)
    got = eng.process(img)
    want = upscale(img, layers, TINY["num_rrdb"], 2, 32, 10, torch.device("cpu"))
    assert got.shape == want.shape == (4 * h, 4 * w, c)
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and np.mean(d == 0) >= 0.999


def test_the_fp8_control_reads_far_worse(tiny_model):
    _, _, layers = tiny_model
    img = photo(generator(12, 2, torch.device("cpu")), 40, 40, 3, torch.device("cpu")).numpy()
    exact = upscale(img, layers, TINY["num_rrdb"], 2, 32, 10, torch.device("cpu"))
    low = upscale(img, layers, TINY["num_rrdb"], 2, 32, 10, torch.device("cpu"), quant=fp8)
    assert np.abs(low.astype(int) - exact.astype(int)).max() >= 4


def test_fp8_rounds_to_e4m3_with_one_scale():
    t = torch.tensor([448.0, 1.0, -3.3, 0.0])
    q = fp8(t)
    assert q[0] == 448.0 and q[1] == 1.0 and q[2] == -3.25 and q[3] == 0.0


@pytest.mark.parametrize("n", [1, 2, 5, 17])
def test_reflect101_is_numpy_reflect(n):
    pad = 10
    idx = reflect101(n, pad, pad)
    if n > 1 and n > pad:
        assert np.array_equal(np.arange(n)[idx], np.pad(np.arange(n), pad, mode="reflect"))
    assert idx.min() >= 0 and idx.max() < n


def test_tiles_cover_the_image_once():
    cover = np.zeros((700, 1000), int)
    for x0, y0, w, h in tiles(1000, 700, 256):
        cover[y0 : y0 + h, x0 : x0 + w] += 1
    assert (cover == 1).all()
    assert padded_px(1024, 768, 256, 10) == 12 * 276 * 276


def test_cubic_matrix_is_ncnns_bicubic():
    from realsr_tpu_torch.ops.resize import _resize_matrix

    for n in (1, 3, 32, 37):
        m = cubic_matrix(n, 4 * n)
        assert np.allclose(m.sum(1), 1.0, atol=1e-6)
        assert np.allclose(m, _resize_matrix(n, 4 * n, "bicubic"), atol=1e-6)


def test_forward_checks_the_layer_count(tiny_model):
    _, _, layers = tiny_model
    with pytest.raises(ValueError):
        forward(torch.zeros(1, 3, 8, 8), layers[:-1], TINY["num_rrdb"], 2)
