"""The port's RRDBNet forward and pre/post ops against the JAX package."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from realsr_tpu.models import rrdbnet as R
from realsr_tpu.ops import pad as JP
from realsr_tpu.ops import resize as JR
from realsr_tpu_torch.models import rrdbnet as TR
from realsr_tpu_torch.ops import pad as TP
from realsr_tpu_torch.ops import rdb_kernel as TK
from realsr_tpu_torch.ops import resize as TRS
from tests.conftest import TINY_SPEC

torch.set_num_threads(2)

PORT_SPEC = TR.RRDBNetSpec(**{
    f: getattr(TINY_SPEC, f)
    for f in ("num_rrdb", "num_rdb_per_rrdb", "nf", "gc", "in_ch", "out_ch", "num_upsample")
})


@pytest.fixture(scope="module")
def jax_params():
    return R.init_rrdbnet_params(TINY_SPEC, seed=3)


def test_init_params_match_jax_draws(jax_params):
    port = TR.init_rrdbnet_params(PORT_SPEC, seed=3)
    conv = TR.params_from_jax(jax_params)
    for group in conv:
        for k in conv[group]:
            np.testing.assert_array_equal(port[group][k], conv[group][k])


@pytest.mark.parametrize("variant", ["dense", "scatter", "cuda"])
def test_forward_matches_jax_f32(jax_params, variant):
    """f32 forward, the port's variant against JAX's (dense for 'cuda',
    whose trunk takes the plain RDB on CPU tensors)."""
    x = np.random.default_rng(8).random((2, 12, 10, 3)).astype(np.float32)
    jp = R.repack_scatter(jax_params) if variant == "scatter" else jax_params
    y_jax = np.asarray(R.rrdbnet_forward(
        jp, jnp.asarray(x), TINY_SPEC, storage_dtype=jnp.float32,
        variant="scatter" if variant == "scatter" else "dense",
    ))
    tp = TR.params_from_jax(jax_params)
    if variant == "scatter":
        tp = TR.repack_scatter(tp)
    elif variant == "cuda":
        packed = TK.pack_rdb_params(tp["rdb"], torch.float32)
        n_rdb = PORT_SPEC.num_rrdb * PORT_SPEC.num_rdb_per_rrdb
        tp = dict(tp, rdb={k: v.reshape(n_rdb, -1) for k, v in packed.items()})
    y = TR.rrdbnet_forward(tp, torch.from_numpy(x), PORT_SPEC, variant=variant).numpy()
    assert y.shape == y_jax.shape == (2, 48, 40, 3)
    assert np.abs(y - y_jax).max() <= 1e-4 * max(1.0, np.abs(y_jax).max())


@pytest.mark.parametrize("variant", ["dense", "scatter"])
def test_forward_matches_jax_mixed(jax_params, variant):
    """Mixed mode (float32 state, bfloat16 operands) against JAX's. Both
    round the same operands; where two f32 sums in another order straddle a
    bf16 rounding boundary they round one ulp apart and the flip spreads, so
    the limit is relative (observed 3.7e-3 of max|y|). The port's error
    against float32 must also be the size of JAX's own: a port that skipped
    the operand rounding would have none."""
    x = np.random.default_rng(8).random((2, 12, 10, 3)).astype(np.float32)
    jp = R.repack_scatter(jax_params) if variant == "scatter" else jax_params
    y_jax, y32 = (
        np.asarray(R.rrdbnet_forward(
            p, jnp.asarray(x), TINY_SPEC, storage_dtype=jnp.float32, variant=v, op_dtype=od,
        ))
        for p, v, od in ((jp, variant, jnp.bfloat16), (jax_params, "dense", None))
    )
    tp = TR.params_from_jax(jax_params)
    if variant == "scatter":
        tp = TR.repack_scatter(tp)
    y = TR.rrdbnet_forward(
        tp, torch.from_numpy(x), PORT_SPEC, torch.float32, variant, torch.bfloat16
    ).numpy()
    assert y.shape == y_jax.shape == (2, 48, 40, 3)
    assert np.abs(y - y_jax).max() <= 1e-2 * np.abs(y_jax).max()
    rms = lambda a: float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))  # noqa: E731
    assert 0.8 <= rms(y - y32) / rms(y_jax - y32) <= 1.25


@pytest.mark.parametrize(
    "shape,pad", [((9, 11, 3), 3), ((4, 3, 3), 10), ((1, 1, 3), 2), ((2, 6, 5, 3), 5)]
)
def test_reflect101_pad_bit_equal(shape, pad):
    a = np.random.default_rng(0).random(shape).astype(np.float32)
    want = np.asarray(JP.reflect101_pad2d(jnp.asarray(a), pad))
    np.testing.assert_array_equal(TP.reflect101_pad2d(torch.from_numpy(a), pad).numpy(), want)


@pytest.mark.parametrize("shape", [(2, 5, 7, 1), (1, 13, 9, 1), (3, 1, 2, 1)])
def test_bicubic_x4_matches_jax(shape):
    """Same interpolation matrix; the matmuls may sum in another order, so
    f32 agrees to an ulp of 255 and the engine's u8 rounding is bit-equal."""
    a = np.random.default_rng(1).integers(0, 256, shape).astype(np.float32)
    want = np.asarray(JR.bicubic_x4(jnp.asarray(a)))
    got = TRS.resize_bicubic(torch.from_numpy(a), 4 * shape[1], 4 * shape[2]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    u8 = lambda v: np.clip(np.floor(v + 0.5), 0, 255).astype(np.uint8)  # noqa: E731
    np.testing.assert_array_equal(u8(got), u8(want))


def test_nearest_x2_bit_equal():
    a = np.random.default_rng(2).random((2, 3, 5, 4)).astype(np.float32)
    want = np.asarray(JR.nearest_x2(jnp.asarray(a)))
    np.testing.assert_array_equal(TRS.nearest_x2(torch.from_numpy(a)).numpy(), want)
