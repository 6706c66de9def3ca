"""The port's upload (``engine._upload``, the counterpart of the JAX engine's
``jax.device_put``) on the CPU: the same bytes as ``torch.tensor``, one
call per stack and per band from every entry point, and outputs still held
to the JAX package's."""

import os

import numpy as np
import pytest
import torch

from realsr_tpu.engine import EngineConfig as JaxConfig
from realsr_tpu.engine import RealSR as JaxRealSR
from realsr_tpu_torch import engine as engine_mod
from realsr_tpu_torch.engine import EngineConfig, RealSR
from realsr_tpu_torch.ops.pad import _index_tensor, reflect101_indices

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _files(d):
    return os.path.join(d, "x4.param"), os.path.join(d, "x4.bin")


@pytest.fixture(scope="module")
def engines(tiny_model_dir):
    jax_e = JaxRealSR(gpuid=-1, config=JaxConfig(tilesize=16, storage="float32", compilation_cache=False))
    jax_e.load(*_files(tiny_model_dir))
    port = RealSR(gpuid=-1, config=EngineConfig(tilesize=16, storage="float32"))
    port.load(*_files(tiny_model_dir))
    return jax_e, port


def _close(got, want):
    """The parity tests' gate: u8 >= 99.9 % equal, max diff 1."""
    d = np.abs(got.astype(int) - want.astype(int))
    assert got.shape == want.shape
    assert np.mean(d == 0) >= 0.999 and d.max() <= 1


@pytest.mark.parametrize("case", ["stack", "band rows", "rgba", "ragged"])
def test_upload_same_bytes_as_torch_tensor(case):
    rng = np.random.default_rng(3)
    rows = None
    if case == "stack":
        a = rng.integers(0, 256, (3, 12, 10, 3), np.uint8)
    elif case == "band rows":
        a = rng.integers(0, 256, (30, 17, 3), np.uint8)
        rows = reflect101_indices(30, 4, 4)[6:26]  # a band's rows with context
    elif case == "rgba":
        a = rng.integers(0, 256, (1, 9, 14, 4), np.uint8)
    else:
        a = rng.integers(0, 256, (1, 7, 13, 3), np.uint8)[:, ::1, 1:12]  # a view
    want = torch.tensor(a if rows is None else a[rows], device=CPU)
    got = engine_mod._upload(a, CPU, rows)
    assert got.dtype == want.dtype == torch.uint8 and got.device == CPU
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 7, 30])
@pytest.mark.parametrize("pad", [0, 3, 10])
def test_pad_indices_made_on_the_device_match_the_host_ones(n, pad):
    """The reflect-101 pad's indices, made on the tensor's device so that no
    upload waits for the card, are the host table's."""
    np.testing.assert_array_equal(_index_tensor(n, pad, CPU).numpy(), reflect101_indices(n, pad, pad))


@pytest.fixture
def recorded(monkeypatch):
    """The shapes of every ``_upload`` result, the real upload underneath."""
    shapes = []
    real = engine_mod._upload

    def record(array, device, rows=None):
        out = real(array, device, rows)
        shapes.append(tuple(out.shape))
        return out

    monkeypatch.setattr(engine_mod, "_upload", record)
    return shapes


def test_process_uploads_once_per_image(engines, recorded):
    jax_e, port = engines
    img = np.random.default_rng(5).integers(0, 256, (21, 34, 4), np.uint8)
    _close(port.process(img), jax_e.process(img))
    assert recorded == [(1, 21, 34, 4)]


def test_process_batch_uploads_one_stack(engines, recorded):
    jax_e, port = engines
    imgs = [np.random.default_rng(k).integers(0, 256, (18, 23, 3), np.uint8) for k in range(3)]
    outs = port.process_batch(imgs)
    assert recorded == [(3, 18, 23, 3)]
    for got, want in zip(outs, jax_e.process_batch(imgs)):
        _close(got, want)


@pytest.mark.parametrize("btr", [1, 2])
def test_process_banded_uploads_each_band_with_context(engines, recorded, btr):
    """One upload per band: its tile rows plus 2 x prepadding context rows,
    the image's full width."""
    jax_e, port = engines
    h, w, c = 70, 34, 3
    img = np.random.default_rng(btr).integers(0, 256, (h, w, c), np.uint8)
    got = port.process_banded(img, band_tile_rows=btr)
    _close(got, jax_e.process_banded(img, band_tile_rows=btr))
    np.testing.assert_array_equal(got, port.process(img))  # bands are seamless
    bands, whole = recorded[:-1], recorded[-1]
    pad, rows = port.prepadding, 16 * btr
    want = [(rows + 2 * pad, w, c)] * (h // rows) + ([(h % rows + 2 * pad, w, c)] if h % rows else [])
    assert bands == want and whole == (1, h, w, c)
