"""The port's mesh mode (``parallel/mesh.py``, ``RealSR(mesh=...)``) on the
CPU: meshes of 2 and 3 shards of the CPU device against the port's single
engine (bit-equal) and against the JAX package's mesh engine on its virtual
8-CPU mesh, and ``REALSR_TPU_MESH`` through the port's CLI."""

import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from realsr_tpu.engine import EngineConfig as JaxConfig
from realsr_tpu.engine import RealSR as JaxRealSR
from realsr_tpu.parallel import mesh as jax_mesh
from realsr_tpu_torch import cli
from realsr_tpu_torch.engine import EngineConfig, RealSR
from realsr_tpu_torch.parallel import mesh as port_mesh
from realsr_tpu_torch.parallel.mesh import make_mesh, mesh_from_env
from realsr_tpu_torch.tiling.planner import plan_tiles

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _files(d):
    return os.path.join(d, "x4.param"), os.path.join(d, "x4.bin")


def _engine(d, k=0, tta=False, **cfg):
    """The port's engine at tile 16, float32: single (k = 0) or on a mesh of
    k shards of the CPU."""
    config = EngineConfig(**{"tilesize": 16, "storage": "float32", **cfg})
    e = RealSR(gpuid=-1, tta_mode=tta, config=config, mesh=make_mesh([CPU] * k) if k else None)
    e.load(*_files(d))
    return e


@pytest.fixture(scope="module")
def single(tiny_model_dir):
    return _engine(tiny_model_dir)


@pytest.fixture(scope="module")
def meshes(tiny_model_dir):
    return {k: _engine(tiny_model_dir, k) for k in (2, 3)}


def _close(got, want):
    d = np.abs(got.astype(int) - want.astype(int))
    assert got.shape == want.shape
    assert np.mean(d == 0) >= 0.999 and d.max() <= 1, (np.mean(d == 0), d.max())


@pytest.mark.parametrize("k", [2, 3])
def test_mesh_matches_single_device(single, meshes, k):
    img = np.random.default_rng(k).integers(0, 256, (40, 48, 3), np.uint8)  # 15 tiles at T=16
    assert meshes[k].mesh.size == k
    np.testing.assert_array_equal(meshes[k].process(img), single.process(img))


@pytest.mark.parametrize("k", [2, 3])
def test_mesh_ragged_and_alpha(single, meshes, k):
    img = np.random.default_rng(10 + k).integers(0, 256, (33, 21, 4), np.uint8)
    np.testing.assert_array_equal(meshes[k].process(img), single.process(img))


@pytest.mark.parametrize("k", [2, 3])
def test_mesh_process_batch(single, meshes, k):
    imgs = [np.random.default_rng(20 + i).integers(0, 256, (20, 18, 3), np.uint8) for i in range(3)]
    for a, b in zip(meshes[k].process_batch(imgs), single.process_batch(imgs)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", [2, 3])
def test_mesh_float16_parity_mode(tiny_model_dir, k):
    one = _engine(tiny_model_dir, storage="float16")
    m = _engine(tiny_model_dir, k, storage="float16")
    assert m.storage_dtype == torch.float16 and m.variant == "dense"
    img = np.random.default_rng(30 + k).integers(0, 256, (40, 24, 3), np.uint8)
    np.testing.assert_array_equal(m.process(img), one.process(img))


def test_submesh(tiny_model_dir):
    """A mesh of one shard (like REALSR_TPU_MESH=0) also works."""
    m = _engine(tiny_model_dir, 1)
    img = np.random.default_rng(40).integers(0, 256, (20, 20, 3), np.uint8)
    assert m.process(img).shape == (80, 80, 3)


@pytest.mark.parametrize("k", [2, 3])
def test_mesh_tta_matches_single(tiny_model_dir, k):
    one = _engine(tiny_model_dir, tta=True)
    m = _engine(tiny_model_dir, k, tta=True)
    img = np.random.default_rng(50 + k).integers(0, 256, (20, 24, 3), np.uint8)
    np.testing.assert_array_equal(m.process(img), one.process(img))


@pytest.mark.parametrize("k", [2, 3])
def test_mesh_oversized_image_bands_per_device(single, meshes, k, monkeypatch):
    """The band budget caps each device's memory: an over-budget image bands
    under a mesh too, bit-equal to the single engine's whole image."""
    img = np.random.default_rng(60 + k).integers(0, 256, (64, 40, 3), np.uint8)
    want = single.process(img)
    monkeypatch.setenv("REALSR_TPU_BAND_BUDGET_MB", "0")
    assert meshes[k].needs_banding(img.shape)
    calls = []
    banded = meshes[k].process_banded
    monkeypatch.setattr(meshes[k], "process_banded", lambda *a, **kw: calls.append(1) or banded(*a, **kw))
    np.testing.assert_array_equal(meshes[k].process(img), want)
    assert calls == [1]


@pytest.mark.parametrize("k", [2, 3])
def test_chunks_dealt_round_robin(tiny_model_dir, k, monkeypatch):
    """Whole chunks go to the shards in turn: each shard's private output
    holds only its own tiles (no pixel written by two shards), every shard
    gets chunks (5 chunks of at most 2 tiles here), the merge is their max,
    and progress is fenced once a round."""
    m = _engine(tiny_model_dir, k, max_batch=2)
    seen = {}
    merge = m._merge
    monkeypatch.setattr(m, "_merge", lambda shards: seen.setdefault("parts", [s[2].clone() for s in shards])
                        and merge(shards))
    fracs = []
    img = np.random.default_rng(70 + k).integers(1, 256, (40, 48, 3), np.uint8)
    out = m.process(img, progress_cb=fracs.append)
    parts = torch.stack(seen["parts"])
    assert parts.shape[0] == k
    assert int(((parts > 0).sum(0) > 1).sum()) == 0
    assert all(bool(p.any()) for p in parts)
    np.testing.assert_array_equal(parts.amax(0)[0].numpy(), out)
    chunks = sum(m._chunking(16, len(ix))[1] for ix in plan_tiles(48, 40, 16, 10).buckets.values())
    assert len(fracs) == -(-chunks // k) and fracs[-1] == pytest.approx(1.0)


@pytest.mark.parametrize("k", [2, 3])
def test_mesh_chunk_batch_is_the_single_engines(single, meshes, k):
    """No rounding of the batch to a device multiple: every chunk has a
    shape the single engine launches (JAX rounds; the port deals)."""
    for n in range(1, 30):
        assert meshes[k]._chunking(16, n) == single._chunking(16, n)


def test_mesh_params_on_each_device(meshes):
    m = meshes[3]
    assert list(m._params_on) == [CPU] and m._devices() == [CPU] * 3


@pytest.mark.parametrize("k", [2, 3])
def test_mesh_matches_jax_mesh_engine(tiny_model_dir, meshes, k):
    """The port's mesh engine against the JAX package's mesh engine on the
    virtual 8-CPU mesh: u8 >= 99.9 % equal."""
    assert len(jax.devices()) == 8
    jax_e = JaxRealSR(config=JaxConfig(tilesize=16, storage="float32", compilation_cache=False),
                      mesh=jax_mesh.make_mesh(jax.devices()))
    jax_e.load(*_files(tiny_model_dir))
    for shape in ((40, 48, 3), (33, 21, 4)):
        img = np.random.default_rng(80 + k + shape[2]).integers(0, 256, shape, np.uint8)
        _close(meshes[k].process(img), jax_e.process(img))


def test_make_mesh_and_pool():
    assert port_mesh.default_pool() == [CPU]  # no CUDA on this host
    m = make_mesh()
    assert m.devices == (CPU,) and m.size == 1
    assert make_mesh(["cpu", CPU]).devices == (CPU, CPU)
    with pytest.raises(ValueError):
        make_mesh([])
    with pytest.raises(ValueError, match="one kind"):
        RealSR(mesh=port_mesh.Mesh((CPU, torch.device("meta"))))


@pytest.mark.parametrize("spec", ["0,0", "0,99", "x", "", ",", "-1", "1"])
def test_mesh_from_env_errors_match_jax(spec):
    """Bad REALSR_TPU_MESH values raise JAX's ValueError texts (the pool
    sizes differ: JAX's virtual 8-CPU pool, the port's one CPU)."""
    with pytest.raises(ValueError) as port_err:
        mesh_from_env(spec)
    try:
        jax_mesh.mesh_from_env(spec)
        jax_text = None  # valid on JAX's 8-device pool, not on the port's 1
    except ValueError as ex:
        jax_text = str(ex).replace("pool has 8 devices", "pool has 1 devices")
    assert "invalid REALSR_TPU_MESH" in str(port_err.value)
    if jax_text is not None:
        assert str(port_err.value) == jax_text
    else:
        assert str(port_err.value) == f"invalid REALSR_TPU_MESH {spec!r} (pool has 1 devices)"


def test_pool_for_the_callers_ids():
    """The CPU pool only for ids all -1; card ids need CUDA, and raise
    without it rather than giving the CPU pool."""
    assert port_mesh.pool_for([-1]) == port_mesh.pool_for([-1, -1]) == [CPU]
    for gpuid in ([0], [0, 1], [-1, 0]):
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            port_mesh.pool_for(gpuid)
    assert mesh_from_env("all", [CPU, CPU]).devices == (CPU, CPU)
    with pytest.raises(ValueError, match=r"pool has 2 devices"):
        mesh_from_env("2", [CPU, CPU])


def test_mesh_from_env_all_and_list():
    assert mesh_from_env("all").devices == (CPU,)
    assert mesh_from_env("0").devices == (CPU,)


@pytest.fixture(scope="module")
def cli_model_dir(tmp_path_factory):
    from realsr_tpu_torch.models.rrdbnet import RRDBNetSpec
    from realsr_tpu_torch.ncnn.synth import make_model_dir

    d = tmp_path_factory.mktemp("mesh_cli") / "models-DF2K"
    make_model_dir(str(d), RRDBNetSpec(num_rrdb=1, nf=16, gc=8), seed=3)
    return str(d)


def test_mesh_mode_cli(cli_model_dir, tmp_path, monkeypatch, capsys):
    """REALSR_TPU_MESH=all through the port's CLI (-g -1: the CPU pool): one
    mesh engine, the -v mesh line, PNG pixels equal to the single run; a bad
    value prints JAX's diagnostic and exits -1; without -g the CLI still
    needs CUDA."""
    src = tmp_path / "a.png"
    Image.fromarray(np.random.default_rng(90).integers(0, 256, (24, 30, 3), np.uint8)).save(src)
    out1, out2 = tmp_path / "single.png", tmp_path / "mesh.png"
    monkeypatch.delenv("REALSR_TPU_MESH", raising=False)
    assert cli.main(["-i", str(src), "-o", str(out1), "-m", cli_model_dir, "-g", "-1"]) == 0
    monkeypatch.setenv("REALSR_TPU_MESH", "all")
    assert cli.main(["-i", str(src), "-o", str(out2), "-m", cli_model_dir, "-g", "-1", "-v"]) == 0
    assert "mesh mode: 1 devices" in capsys.readouterr().err
    np.testing.assert_array_equal(np.asarray(Image.open(out1)), np.asarray(Image.open(out2)))
    monkeypatch.setenv("REALSR_TPU_MESH", "0,99")
    assert cli.main(["-i", str(src), "-o", str(out2), "-m", cli_model_dir, "-g", "-1"]) == -1
    assert "invalid REALSR_TPU_MESH '0,99'" in capsys.readouterr().err
    monkeypatch.setenv("REALSR_TPU_MESH", "all")
    assert cli.main(["-i", str(src), "-o", str(out2), "-m", cli_model_dir]) == -1
    assert "no CUDA device found" in capsys.readouterr().err
