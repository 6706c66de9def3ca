"""The port's band streaming, chunking, device budget, process_cpu and tail
resolution on the CPU, against the JAX package's engine and against the
port's own whole-image path."""

import os

import numpy as np
import pytest
import torch

from realsr_tpu.engine import EngineConfig as JaxConfig
from realsr_tpu.engine import RealSR as JaxRealSR
from realsr_tpu.ops.pad import reflect101_pad_w as jax_pad_w
from realsr_tpu_torch.engine import Device, EngineConfig, RealSR, _resolve_tail
from realsr_tpu_torch.ops.pad import reflect101_pad_w

torch.set_num_threads(2)

# ragged grids at tile 16 (tests/test_engine.py's banding shapes)
BAND_SHAPES = [(70, 34, 3), (52, 20, 4)]


def _files(d):
    return os.path.join(d, "x4.param"), os.path.join(d, "x4.bin")


def _jax_engine(d, tta=False, **cfg):
    e = JaxRealSR(gpuid=-1, tta_mode=tta, config=JaxConfig(tilesize=16, storage="float32",
                                                           compilation_cache=False, **cfg))
    e.load(*_files(d))
    return e


def _port_engine(d, tta=False, **cfg):
    e = RealSR(gpuid=-1, tta_mode=tta, config=EngineConfig(**{"tilesize": 16, "storage": "float32", **cfg}))
    e.load(*_files(d))
    return e


@pytest.fixture(scope="module")
def engines(tiny_model_dir):
    return _jax_engine(tiny_model_dir), _port_engine(tiny_model_dir)


def _close(got, want):
    d = np.abs(got.astype(int) - want.astype(int))
    assert got.shape == want.shape
    assert np.mean(d == 0) >= 0.999 and d.max() <= 1


@pytest.mark.parametrize("btr", [1, 2, 3])
@pytest.mark.parametrize("shape", BAND_SHAPES)
def test_banded_matches_jax_banded(engines, shape, btr):
    jax_e, port = engines
    img = np.random.default_rng(sum(shape) + btr).integers(0, 256, shape, np.uint8)
    _close(port.process_banded(img, band_tile_rows=btr), jax_e.process_banded(img, band_tile_rows=btr))


@pytest.mark.parametrize("btr", [1, 2, 3])
@pytest.mark.parametrize("shape", BAND_SHAPES)
def test_banded_matches_whole_exactly(engines, shape, btr):
    """Bands carry real context rows: bit-identical to the whole image,
    ragged bottom rows and alpha included."""
    _, port = engines
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, np.uint8)
    np.testing.assert_array_equal(port.process_banded(img, band_tile_rows=btr), port.process(img))


def test_banded_tta_matches_whole_and_jax(tiny_model_dir):
    port = _port_engine(tiny_model_dir, tta=True)
    jax_e = _jax_engine(tiny_model_dir, tta=True)
    img = np.random.default_rng(4).integers(0, 256, (40, 24, 3), np.uint8)
    banded = port.process_banded(img, band_tile_rows=1)
    np.testing.assert_array_equal(banded, port.process(img))
    _close(banded, jax_e.process_banded(img, band_tile_rows=1))


def test_banded_progress_reaches_one(engines):
    _, port = engines
    fracs = []
    port.process_banded(np.zeros((40, 24, 3), np.uint8), progress_cb=fracs.append, band_tile_rows=1)
    assert fracs[-1] == pytest.approx(1.0) and all(b >= a for a, b in zip(fracs, fracs[1:]))


@pytest.mark.parametrize("pad,w", [(3, 7), (6, 7), (10, 7), (10, 1), (2, 3)])
def test_reflect101_pad_w_matches_jax(pad, w):
    x = np.random.default_rng(w).random((1, 5, w, 3), dtype=np.float32)
    want = np.asarray(jax_pad_w(x, pad))
    got = reflect101_pad_w(torch.from_numpy(x), pad).numpy()
    np.testing.assert_array_equal(got, want)


def test_equalized_band_rows_match_jax():
    for ytiles in range(1, 60):
        for btr in range(1, 70):
            assert RealSR._equalized_band_rows(ytiles, btr) == JaxRealSR._equalized_band_rows(ytiles, btr)


@pytest.mark.parametrize("budget_mb", ["0", "1", "64", "2048"])
def test_auto_band_tile_rows_match_jax(engines, budget_mb, monkeypatch):
    jax_e, port = engines
    monkeypatch.setenv("REALSR_TPU_BAND_BUDGET_MB", budget_mb)
    for w in (1, 17, 640, 6200, 20000):
        for c in (3, 4):
            for tilesize in (16, 128, 200):
                assert port._auto_band_tile_rows(w, c, tilesize) == jax_e._auto_band_tile_rows(w, c, tilesize)


def test_budget_matches_jax(engines, monkeypatch):
    """needs_banding and max_batch_images agree with JAX's over a grid."""
    jax_e, port = engines
    for budget_mb in ("0", "1", "2048"):
        monkeypatch.setenv("REALSR_TPU_BAND_BUDGET_MB", budget_mb)
        for shape in ((100, 100, 3), (6000, 6200, 3), (6000, 6200, 4), (4000, 5000, 4), (20000, 20000, 3)):
            assert port.needs_banding(shape) == jax_e.needs_banding(shape)
            assert port.max_batch_images(shape) == jax_e.max_batch_images(shape)


def test_needs_banding_trigger(engines, monkeypatch):
    _, port = engines
    assert not port.needs_banding((100, 100, 3))
    assert port.needs_banding((20000, 20000, 3))  # 19 GB of u8 output
    # a 48 MP photo at the default budget: ~60 B per input pixel with
    # float32 storage (mixed mode's too)
    assert port.needs_banding((6000, 8000, 3)) and not port.needs_banding((3000, 4000, 3))
    monkeypatch.setenv("REALSR_TPU_BAND_BUDGET_MB", "0")
    assert port.needs_banding((100, 100, 3))


def test_process_routes_to_banded(engines, monkeypatch):
    """process() bands when over budget; the output is the same."""
    _, port = engines
    img = np.random.default_rng(8).integers(0, 256, (40, 24, 3), np.uint8)
    full = port.process(img)
    monkeypatch.setenv("REALSR_TPU_BAND_BUDGET_MB", "0")
    calls = []
    banded = port.process_banded
    monkeypatch.setattr(port, "process_banded", lambda *a, **k: calls.append(1) or banded(*a, **k))
    np.testing.assert_array_equal(full, port.process(img))
    assert calls == [1]


def test_process_batch_splits_over_budget_stack(engines, monkeypatch):
    _, port = engines
    imgs = [np.random.default_rng(k).integers(0, 256, (26, 30, 3), np.uint8) for k in range(5)]
    ref = [port.process(i) for i in imgs]
    per = port._footprint_bytes(26, 30, 3)
    monkeypatch.setattr(port, "_band_budget_bytes", lambda: int(per * 2.5))
    assert port.max_batch_images((26, 30, 3)) == 2
    for a, b in zip(port.process_batch(imgs), ref):  # sub-stacks of 2, 2, 1
        np.testing.assert_array_equal(a, b)


def test_process_batch_bands_each_when_single_over_budget(engines, monkeypatch):
    _, port = engines
    imgs = [np.random.default_rng(k).integers(0, 256, (40, 24, 3), np.uint8) for k in range(2)]
    ref = [port.process(i) for i in imgs]
    monkeypatch.setenv("REALSR_TPU_BAND_BUDGET_MB", "0")
    for a, b in zip(port.process_batch(imgs), ref):  # cap 1: each image bands
        np.testing.assert_array_equal(a, b)


def test_fetch_passes_host_arrays(engines):
    _, port = engines
    a = np.arange(12, dtype=np.uint8).reshape(2, 2, 3)
    assert port.fetch(a) is a
    np.testing.assert_array_equal(port.fetch(torch.from_numpy(a)), a)


@pytest.mark.parametrize("tta", [False, True])
@pytest.mark.parametrize("max_batch", [0, 1, 2, 3, 4, 8, 16])
def test_chunking_matches_jax(tiny_model_dir, max_batch, tta, monkeypatch):
    jax_e = JaxRealSR(gpuid=-1, tta_mode=tta, config=JaxConfig(
        tilesize=16, storage="float32", max_batch=max_batch, compilation_cache=False))
    jax_e.load(*_files(tiny_model_dir))
    port = _port_engine(tiny_model_dir, tta=tta, max_batch=max_batch)
    for budget_mb in ("1", "2048"):
        monkeypatch.setenv("REALSR_TPU_BAND_BUDGET_MB", budget_mb)
        for n in range(1, 41):
            assert port._chunking(16, n) == jax_e._chunking(16, n)


def test_max_batch_caps_chunks(tiny_model_dir):
    """max_batch=2 runs no forward on more than 2 tiles; the output stays
    within u8 rounding of the default engine's."""
    capped, default = _port_engine(tiny_model_dir, max_batch=2), _port_engine(tiny_model_dir)
    seen = []
    fwd = capped.bundle.forward
    capped.bundle.forward = lambda p, x: seen.append(x.shape[0]) or fwd(p, x)
    img = np.random.default_rng(9).integers(0, 256, (60, 50, 4), np.uint8)
    _close(capped.process(img), default.process(img))
    assert max(seen) == 2 and len(seen) == sum(-(-n // 2) for n in (9, 3, 3, 1))


def test_process_cpu_on_cpu_engine_is_process(engines):
    _, port = engines
    img = np.random.default_rng(10).integers(0, 256, (21, 17, 4), np.uint8)
    np.testing.assert_array_equal(port.process_cpu(img), port.process(img))
    assert port._cpu_sibling is None


def test_process_cpu_builds_a_cpu_sibling(tiny_model_dir):
    """An engine bound to a card answers process_cpu from a CPU sibling:
    the same model files, the CPU's tile size, the kernel variant and its
    trunk form re-resolved to plain convs. Here a CPU engine on the kernel
    variant (its wrappers' plain versions) stands in for the card engine."""
    card = _port_engine(tiny_model_dir, variant="cuda", trunk="chained")
    card.device = Device("gpu", torch.device("cpu"))
    img = np.random.default_rng(11).integers(0, 256, (23, 19, 4), np.uint8)
    got = card.process_cpu(img)
    sib = card._cpu_sibling
    assert sib is not None and sib.device.platform == "cpu"
    assert (sib.variant, sib.trunk, sib.tilesize) == ("dense", "per_rdb", 200)
    assert sib.config.storage == "float32" and sib.tail == "interleaved"
    np.testing.assert_array_equal(got, _port_engine(tiny_model_dir, tilesize=200).process(img))
    card.process_cpu(img)
    assert card._cpu_sibling is sib


@pytest.mark.parametrize(
    "tail,variant,platform,env,want",
    [
        ("auto", "dense", "gpu", None, "interleaved"),
        ("auto", "scatter", "gpu", None, "interleaved"),
        ("auto", "cuda", "gpu", None, "kernel"),
        ("auto", "cuda", "cpu", None, "interleaved"),
        ("auto", "dense", "cpu", None, "interleaved"),
        ("packed", "dense", "gpu", None, "packed"),
        ("auto", "dense", "gpu", "3", "kernel"),
        ("auto", "cuda", "gpu", "0", "interleaved"),
        ("auto", "cuda", "gpu", "2", "kernel_hr"),
        ("interleaved", "cuda", "gpu", "3", "interleaved"),
    ],
)
def test_resolve_tail(tail, variant, platform, env, want, monkeypatch):
    """"auto" is the kernel tail on the kernel variant only (the JAX engine
    keeps the interleaved tail on its conv variants); REALSR_TPU_PACKED_TAIL
    overrides "auto", never an explicit tail."""
    if env is None:
        monkeypatch.delenv("REALSR_TPU_PACKED_TAIL", raising=False)
    else:
        monkeypatch.setenv("REALSR_TPU_PACKED_TAIL", env)
    assert _resolve_tail(tail, variant, platform) == want
