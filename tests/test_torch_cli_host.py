"""The port's CLI on the CPU: -j on -g -1, file sharding, banded images
through the pipeline, a matcher-rejected graph; held to the JAX CLI where it
has the same behaviour."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from realsr_tpu import cli as jax_cli
from realsr_tpu.ncnn.bin import write_weights
from realsr_tpu.ncnn.param import parse_param
from realsr_tpu.ncnn.synth import make_model_dir, make_rrdbnet_param_text, synth_weights
from realsr_tpu_torch import cli
from realsr_tpu_torch.utils import cputhreads
from tests.conftest import TINY_SPEC

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("clihost") / "models-DF2K"
    make_model_dir(str(d), TINY_SPEC, seed=5)
    return str(d)


@pytest.fixture
def threads():
    """torch's thread count, restored after the test."""
    saved = torch.get_num_threads()
    yield
    torch.set_num_threads(saved)


def _images(d, n, shape=(6, 5, 3)):
    d.mkdir()
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, shape, np.uint8)).save(d / f"{i}.png")
    return str(d)


def test_cli_j_sets_cpu_threads(model_dir, tmp_path, threads, capsys):
    src = _images(tmp_path / "in", 1)
    rc = cli.main(["-i", src, "-o", _images(tmp_path / "out", 0), "-m", model_dir, "-g", "-1",
                   "-j", "1:3:2", "-v"])
    assert rc == 0 and torch.get_num_threads() == 3
    assert "cpu intra-op threads: 3" in capsys.readouterr().err


def test_cli_cpu_threads_default_two(model_dir, tmp_path, threads):
    torch.set_num_threads(5)
    src = _images(tmp_path / "in", 1)
    assert cli.main(["-i", src, "-o", _images(tmp_path / "out", 0), "-m", model_dir, "-g", "-1"]) == 0
    assert torch.get_num_threads() == 2


def test_cpu_threads_notice_when_setting_does_not_take(threads, monkeypatch, capsys):
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    assert not cputhreads.configure_cpu_threads(torch.get_num_threads() + 1)
    assert not cputhreads.configure_cpu_threads(0)
    cputhreads.notice_cpu_threads_ignored()
    assert "-j proc thread count does not tune" in capsys.readouterr().err


def test_cli_shard_matches_jax_cli(model_dir, tmp_path, monkeypatch):
    """Shard 1 of 2: the same files as the JAX CLI writes."""
    src = _images(tmp_path / "in", 5)
    monkeypatch.setenv("REALSR_TPU_NUM_SHARDS", "2")
    monkeypatch.setenv("REALSR_TPU_SHARD", "1")
    outs = {}
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        out = _images(tmp_path / name, 0)
        assert main(["-i", src, "-o", out, "-m", model_dir, "-g", "-1", "-t", "32"]) == 0
        outs[name] = sorted(os.listdir(out))
    assert outs["port"] == outs["jax"] == ["1.png", "3.png"]


@pytest.mark.parametrize("shard,num", [(0, 3), (2, 3), (0, 1)])
def test_cli_shard_slices_sorted_listing(model_dir, tmp_path, monkeypatch, shard, num):
    src = _images(tmp_path / "in", 5)
    monkeypatch.setenv("REALSR_TPU_NUM_SHARDS", str(num))
    monkeypatch.setenv("REALSR_TPU_SHARD", str(shard))
    out = _images(tmp_path / "out", 0)
    assert cli.main(["-i", src, "-o", out, "-m", model_dir, "-g", "-1", "-t", "32"]) == 0
    assert sorted(os.listdir(out)) == [f"{i}.png" for i in range(5)][shard::num]


@pytest.mark.parametrize("shard,num", [(2, 2), (-1, 2), (5, 3)])
def test_cli_invalid_shard_pair(model_dir, tmp_path, monkeypatch, capsys, shard, num):
    """An invalid pair returns -1 with the JAX CLI's message, and writes
    nothing."""
    src = _images(tmp_path / "in", 2)
    monkeypatch.setenv("REALSR_TPU_NUM_SHARDS", str(num))
    monkeypatch.setenv("REALSR_TPU_SHARD", str(shard))
    out = _images(tmp_path / "out", 0)
    for main in (jax_cli.main, cli.main):
        capsys.readouterr()
        assert main(["-i", src, "-o", out, "-m", model_dir, "-g", "-1"]) == -1
        assert "invalid REALSR_TPU_SHARD / REALSR_TPU_NUM_SHARDS" in capsys.readouterr().err
    assert os.listdir(out) == []


@pytest.mark.parametrize("shape", [(45, 38, 3), (33, 40, 4)])
def test_cli_banded_writes_the_whole_image_pixels(model_dir, tmp_path, monkeypatch, shape):
    """An image above the band budget goes through the pipeline in bands
    (fetch passes the host array through) and the PNG has the unbanded
    run's pixels."""
    src = tmp_path / "in.png"
    Image.fromarray(np.random.default_rng(2).integers(0, 256, shape, np.uint8)).save(src)
    args = ["-i", str(src), "-m", model_dir, "-g", "-1", "-t", "32"]
    assert cli.main(args + ["-o", str(tmp_path / "whole.png")]) == 0
    monkeypatch.setenv("REALSR_TPU_BAND_BUDGET_MB", "0")
    assert cli.main(args + ["-o", str(tmp_path / "banded.png")]) == 0
    whole, banded = (np.asarray(Image.open(tmp_path / f)) for f in ("whole.png", "banded.png"))
    assert banded.shape == (4 * shape[0], 4 * shape[1], shape[2])
    np.testing.assert_array_equal(banded, whole)


def test_cli_runs_a_matcher_rejected_graph(tmp_path):
    """A graph the RRDBNet matcher rejects (bilinear upsamplers) loads on
    the generic executor and writes its 4x PNG."""
    text = make_rrdbnet_param_text(TINY_SPEC).replace("0=1 1=2.0 2=2.0", "0=2 1=2.0 2=2.0")
    mdir = tmp_path / "models-DF2K-bilinear"
    mdir.mkdir()
    (mdir / "x4.param").write_text(text)
    write_weights(parse_param(text), synth_weights(parse_param(text), seed=1), str(mdir / "x4.bin"))
    src, out = tmp_path / "in.png", tmp_path / "out.png"
    Image.fromarray(np.random.default_rng(3).integers(0, 256, (13, 17, 4), np.uint8)).save(src)
    assert cli.main(["-i", str(src), "-o", str(out), "-m", str(mdir), "-g", "-1"]) == 0
    assert np.asarray(Image.open(out)).shape == (52, 68, 4)


@pytest.fixture
def group(monkeypatch):
    """Stand in for an initialized torch.distributed process group: sets
    (rank, world size), or None for no group."""
    import torch.distributed as dist

    state = {"group": None}
    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: state["group"] is not None)
    monkeypatch.setattr(dist, "get_rank", lambda: state["group"][0])
    monkeypatch.setattr(dist, "get_world_size", lambda: state["group"][1])
    monkeypatch.delenv("REALSR_TPU_SHARD", raising=False)
    monkeypatch.delenv("REALSR_TPU_NUM_SHARDS", raising=False)
    return lambda g: state.update(group=g)


@pytest.mark.parametrize(
    "rank_world,env,want",
    [
        ((1, 2), {}, ["1.png", "3.png"]),  # process 1 of 2 writes the odd files
        ((1, 2), {"REALSR_TPU_NUM_SHARDS": "2", "REALSR_TPU_SHARD": "0"}, ["0.png", "2.png"]),  # env wins
        (None, {}, ["0.png", "1.png", "2.png", "3.png"]),  # no group: every file
    ],
)
def test_cli_shard_identity_from_torch_distributed(model_dir, tmp_path, monkeypatch, group, rank_world, env, want):
    """The counterpart of the JAX CLI's shard identity from an initialized
    jax.distributed runtime (tests/test_cli.py)."""
    src = _images(tmp_path / "in", 4)
    group(rank_world)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out = _images(tmp_path / "out", 0)
    assert cli.main(["-i", src, "-o", out, "-m", model_dir, "-g", "-1", "-t", "32"]) == 0
    assert sorted(os.listdir(out)) == want


def test_cli_shard_identity_from_a_real_group(model_dir, tmp_path, monkeypatch):
    """A gloo group of one process: rank 0 of 1 writes every file, and the
    CUDA runtime is not initialized by reading it."""
    import torch.distributed as dist

    monkeypatch.delenv("REALSR_TPU_NUM_SHARDS", raising=False)
    src = _images(tmp_path / "in", 3)
    out = _images(tmp_path / "out", 0)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        assert cli.main(["-i", src, "-o", out, "-m", model_dir, "-g", "-1", "-t", "32"]) == 0
    finally:
        dist.destroy_process_group()
    assert sorted(os.listdir(out)) == ["0.png", "1.png", "2.png"]
    assert not torch.cuda.is_initialized()
