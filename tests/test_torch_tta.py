"""The port's TTA (``-x``) against the JAX package's, on the CPU."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from realsr_tpu import engine as JE
from realsr_tpu.ops import tta as JT
from realsr_tpu_torch import cli
from realsr_tpu_torch import engine as TE
from realsr_tpu_torch.ops import tta as TT

torch.set_num_threads(2)


@pytest.mark.parametrize("k", range(8))
def test_d4_transform_and_inverse_bit_equal_jax(k):
    x = np.random.default_rng(k).random((2, 5, 7, 3)).astype(np.float32)
    t = TT.d4_transform(torch.from_numpy(x), k)
    np.testing.assert_array_equal(t.numpy(), np.asarray(JT.d4_transform(jnp.asarray(x), k)))
    np.testing.assert_array_equal(
        TT.d4_inverse(t, k).numpy(), np.asarray(JT.d4_inverse(jnp.asarray(t.numpy()), k))
    )
    np.testing.assert_array_equal(TT.d4_inverse(t, k).numpy(), x)


def test_auto_batch_matches_jax():
    for tile in (32, 64, 128, 200, 256, 400, 1000, 2000):
        for tta in (False, True):
            for budget in (256 << 20, 2048 << 20):
                for nf, dsize in ((64, 2), (64, 4), (16, 4)):
                    args = (tile, tta, budget, nf, dsize)
                    assert TE._auto_batch(*args) == JE._auto_batch(*args), args


@pytest.fixture(scope="module")
def tta_engines(tiny_model_dir):
    files = (os.path.join(tiny_model_dir, "x4.param"), os.path.join(tiny_model_dir, "x4.bin"))
    jax_e = JE.RealSR(
        gpuid=-1, tta_mode=True,
        config=JE.EngineConfig(tilesize=32, storage="float32", compilation_cache=False),
    )
    jax_e.load(*files)
    port = TE.RealSR(gpuid=-1, tta_mode=True, config=TE.EngineConfig(tilesize=32, storage="float32"))
    port.load(*files)
    return jax_e, port


# 32 x 32: one square tile; 20 x 37: two non-square tiles; RGBA 23 x 19
@pytest.mark.parametrize("shape", [(32, 32, 3), (20, 37, 3), (23, 19, 4)])
def test_tta_engine_matches_jax(tta_engines, shape):
    jax_e, port = tta_engines
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, np.uint8)
    want = jax_e.process(img)
    got = port.process(img)
    assert got.shape == want.shape == (4 * shape[0], 4 * shape[1], shape[2])
    diff = np.abs(got.astype(int) - want.astype(int))
    assert np.mean(diff == 0) >= 0.999 and diff.max() <= 1


def test_tta_forward_batches(tta_engines):
    """Square tiles run the 8 variants as one forward, non-square ones as
    two forwards of 4; chunks hold 8 times fewer tiles."""
    _, port = tta_engines
    batches = []
    orig = port.bundle.forward
    port.bundle.forward = lambda p, x: batches.append(tuple(x.shape[:3])) or orig(p, x)
    try:
        port.process(np.zeros((32, 32, 3), np.uint8))
        port.process(np.zeros((20, 37, 3), np.uint8))
    finally:
        port.bundle.forward = orig
    assert batches == [(8, 52, 52), (4, 40, 52), (4, 52, 40), (4, 40, 25), (4, 25, 40)]


def test_cli_tta_writes_4x_png(tiny_model_dir, tmp_path):
    model = tmp_path / "models-DF2K"
    model.mkdir()
    for f in ("x4.param", "x4.bin"):
        os.symlink(os.path.join(tiny_model_dir, f), model / f)
    src, out = tmp_path / "in.png", tmp_path / "out.png"
    Image.fromarray(np.random.default_rng(9).integers(0, 256, (11, 13, 3), np.uint8)).save(src)
    rc = cli.main(["-i", str(src), "-o", str(out), "-m", str(model), "-x", "-g", "-1"])
    assert rc == 0
    assert np.asarray(Image.open(out)).shape == (44, 52, 3)
