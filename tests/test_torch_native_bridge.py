"""The port's embedded-interpreter bridge (``realsr_tpu_torch.native_bridge``)
at the Python level: every case of ``tests/test_native_bridge.py`` on
``gpuid [-1]``, the port's own rules (CUDA ids, warm-up), and its output
against the JAX package's bridge on the same tiny model."""

import json

import numpy as np
import pytest
import torch

from realsr_tpu import native_bridge as jax_nb
from realsr_tpu_torch import native_bridge as nb
from realsr_tpu_torch.engine import EngineConfig, RealSR

torch.set_num_threads(2)


def _config(d, gpuid=(-1,), tilesize=16):
    return json.dumps({
        "gpuid": list(gpuid),
        "tilesize": [tilesize] * len(gpuid),
        "jobs_proc": [1] * len(gpuid),
        "prepadding": 10,
        "tta_mode": False,
        "parampath": d + "/x4.param",
        "modelpath": d + "/x4.bin",
    })


@pytest.fixture(scope="module")
def bridge(tiny_model_dir):
    assert nb.init(_config(tiny_model_dir)) == 4
    assert nb.num_engines() == 1
    return nb


@pytest.fixture
def keep_engines():
    """Tests that re-init the bridge restore the module fixture's engines."""
    saved = nb._engines
    yield
    nb._engines = saved


def test_device_count_is_cudas(bridge):
    """The CUDA pool's size: 0 on this host, so the C++ CLI answers -g 0
    with "invalid gpu device", as the port's Python CLI does."""
    assert bridge.device_count() == torch.cuda.device_count() == 0


def test_process_roundtrip(bridge, rng):
    img = rng.integers(0, 256, (10, 12, 3), dtype=np.uint8)
    out = bridge.process(0, img.tobytes(), 12, 10, 3)
    assert len(out) == 40 * 48 * 3


def test_async_matches_sync(bridge, rng):
    """process_async + fetch == process, and handles are consumed."""
    img = rng.integers(0, 256, (10, 12, 3), dtype=np.uint8)
    sync = bridge.process(0, img.tobytes(), 12, 10, 3)
    h = bridge.process_async(0, img.tobytes(), 12, 10, 3)
    assert isinstance(h, int) and h > 0
    assert bridge.fetch(h) == sync
    with pytest.raises(KeyError):
        bridge.fetch(h)  # consumed


def test_bridge_mesh_mode(tiny_model_dir, rng, monkeypatch, keep_engines):
    """REALSR_TPU_MESH=all through the bridge on gpuid all -1: one mesh
    engine over the CPU pool, aliased to every gpuid slot; output bit-equal
    to the single engine's."""
    monkeypatch.setenv("REALSR_TPU_MESH", "all")
    assert nb.init(_config(tiny_model_dir, gpuid=(-1, -1))) == 4
    assert nb.num_engines() == 2  # both slots alias the mesh engine
    assert nb._engines[0] is nb._engines[1]
    assert nb._engines[0].mesh.devices == (torch.device("cpu"),)  # the CPU pool
    img = rng.integers(0, 256, (20, 24, 3), dtype=np.uint8)
    out = nb.process(1, img.tobytes(), 24, 20, 3)
    ref = RealSR(gpuid=-1, config=EngineConfig(tilesize=16))
    ref.load(tiny_model_dir + "/x4.param", tiny_model_dir + "/x4.bin")
    assert out == ref.process(img).tobytes()


@pytest.mark.parametrize("gpuid", [(0, 1), (0,), (-1, 0)])
def test_bridge_mesh_needs_cuda_for_card_ids(tiny_model_dir, monkeypatch, keep_engines, gpuid):
    """A mesh for card ids (any id >= 0) needs CUDA: without it init raises
    rather than running the mesh on the CPU."""
    monkeypatch.setenv("REALSR_TPU_MESH", "all")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        nb.init(_config(tiny_model_dir, gpuid=gpuid))


def test_bridge_mesh_bad_value_raises(tiny_model_dir, monkeypatch, keep_engines):
    monkeypatch.setenv("REALSR_TPU_MESH", "0,0")
    with pytest.raises(ValueError, match="invalid REALSR_TPU_MESH"):
        nb.init(_config(tiny_model_dir))


def test_process_bands_over_budget_image(bridge, rng, monkeypatch):
    """The native surface routes over-budget images through band streaming
    like the Python CLI: output identical, the result a host array."""
    img = rng.integers(0, 256, (40, 24, 3), dtype=np.uint8)
    ref = bridge.process(0, img.tobytes(), 24, 40, 3)
    monkeypatch.setenv("REALSR_TPU_BAND_BUDGET_MB", "0")
    assert bridge.process(0, img.tobytes(), 24, 40, 3) == ref
    h = bridge.process_async(0, img.tobytes(), 24, 40, 3)
    assert isinstance(bridge._handles[h][1], np.ndarray)
    assert bridge.fetch(h) == ref


def test_batch_async_over_budget_splits(bridge, rng, monkeypatch):
    imgs = [rng.integers(0, 256, (10, 12, 3), dtype=np.uint8) for _ in range(3)]
    refs = [bridge.process(0, im.tobytes(), 12, 10, 3) for im in imgs]
    monkeypatch.setenv("REALSR_TPU_BAND_BUDGET_MB", "0")
    handles = bridge.process_batch_async(
        0, [im.tobytes() for im in imgs], 12, 10, 3
    )
    assert [bridge.fetch(h) for h in handles] == refs


def test_batch_async_matches_singles(bridge, rng):
    """One stack for the batch; each image's output as its single run's
    (float32 on the CPU: the chunk batch changes no value)."""
    imgs = [rng.integers(0, 256, (10, 12, 3), dtype=np.uint8) for _ in range(3)]
    handles = bridge.process_batch_async(0, [im.tobytes() for im in imgs], 12, 10, 3)
    assert len(handles) == 3 and len(set(handles)) == 3
    for h, im in zip(handles, imgs):
        got = np.frombuffer(bridge.fetch(h), np.uint8)
        want = np.frombuffer(bridge.process(0, im.tobytes(), 12, 10, 3), np.uint8)
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 1 and np.mean(d == 0) >= 0.999


def test_batch_async_registers_after_every_dispatch(bridge, rng, monkeypatch):
    """A sub-stack that raises leaves no handle behind (handles are staged
    and registered only after every sub-stack dispatched)."""
    eng = bridge._engines[0]
    imgs = [rng.integers(0, 256, (10, 12, 3), dtype=np.uint8) for _ in range(4)]
    per = eng._footprint_bytes(10, 12, 3)
    monkeypatch.setattr(eng, "_band_budget_bytes", lambda: 2 * per)  # sub-stacks of 2
    calls = []
    real = eng._process_stack_device

    def flaky(stack, *a, **kw):
        calls.append(len(stack))
        if len(calls) == 2:
            raise RuntimeError("out of memory")
        return real(stack, *a, **kw)

    monkeypatch.setattr(eng, "_process_stack_device", flaky)
    before = dict(bridge._handles)
    with pytest.raises(RuntimeError, match="out of memory"):
        bridge.process_batch_async(0, [im.tobytes() for im in imgs], 12, 10, 3)
    assert calls == [2, 2] and bridge._handles == before


def test_async_handles_interleave(bridge, rng):
    """Multiple in-flight results fetch correctly out of order — the C++
    save threads fetch in whatever order the queue yields."""
    imgs = [rng.integers(0, 256, (8, 8, 3), dtype=np.uint8) for _ in range(3)]
    handles = [bridge.process_async(0, im.tobytes(), 8, 8, 3) for im in imgs]
    outs = {h: bridge.fetch(h) for h in reversed(handles)}
    for h, im in zip(handles, imgs):
        assert outs[h] == bridge.process(0, im.tobytes(), 8, 8, 3)


def test_warmup_never_raises(bridge, tmp_path):
    """Warm-up never raises: a first image it cannot decode prints
    "precompile skipped" and counts 0 programs."""
    assert bridge.warmup(str(tmp_path / "missing.png")) == 0


def test_gpu_id_needs_cuda(tiny_model_dir, keep_engines):
    """An id >= 0 needs CUDA and raises without it: no path carries on on
    the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nb.init(_config(tiny_model_dir, gpuid=(0,)))


def test_cpu_init_sets_threads(tiny_model_dir, keep_engines, monkeypatch):
    """gpuid all -1: -j's proc count becomes torch's CPU thread count."""
    seen = []
    from realsr_tpu_torch.utils import cputhreads

    monkeypatch.setattr(cputhreads, "configure_cpu_threads", lambda n, verbose=False: seen.append(n) or True)
    cfg = json.loads(_config(tiny_model_dir))
    cfg["jobs_proc"] = [3]
    nb.init(json.dumps(cfg))
    assert seen == [3]


def test_bridge_matches_jax_bridge(tiny_model_dir, bridge, rng, keep_engines):
    """The port's bridge against the JAX package's bridge on the same tiny
    model and config: u8 >= 99.9 % equal, sync and async."""
    saved = jax_nb._engines
    try:
        assert jax_nb.init(_config(tiny_model_dir)) == 4
        for shape in ((10, 12, 3), (17, 23, 4)):
            img = rng.integers(0, 256, shape, dtype=np.uint8)
            h, w, c = shape
            want = np.frombuffer(jax_nb.process(0, img.tobytes(), w, h, c), np.uint8)
            got = np.frombuffer(bridge.fetch(bridge.process_async(0, img.tobytes(), w, h, c)), np.uint8)
            d = np.abs(got.astype(int) - want.astype(int))
            assert got.shape == want.shape == (16 * h * w * c,)
            assert np.mean(d == 0) >= 0.999 and d.max() <= 1
    finally:
        jax_nb._engines = saved
