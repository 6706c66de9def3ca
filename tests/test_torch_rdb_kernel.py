"""The port's fused-RDB module against the JAX package's Pallas RDB kernels.

The CUDA kernel itself runs only on the card (tests/test_torch_gpu.py);
here its plain PyTorch version, which the wrapper takes for CPU tensors, is
held to the JAX kernels in interpret mode and to the XLA scatter oracle, on
the same numpy inputs.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from realsr_tpu.models import rrdbnet as R
from realsr_tpu.ops import rdb_kernel as K
from realsr_tpu_torch.models.rrdbnet import params_from_jax
from realsr_tpu_torch.ops import rdb_kernel as TK

torch.set_num_threads(2)

NF, GC = 16, 8


def _mk_params(nf, gc, seed=0, wstd=0.15):
    """One RDB's HWIO params, as tests/test_rdb_kernel.py makes them."""
    rng = np.random.default_rng(seed)
    cins = [nf, nf + gc, nf + 2 * gc, nf + 3 * gc, nf + 4 * gc]
    couts = [gc] * 4 + [nf]
    p = {}
    for i, (ci, co) in enumerate(zip(cins, couts), 1):
        p[f"w{i}"] = rng.normal(0, wstd, (3, 3, ci, co)).astype(np.float32)
        p[f"b{i}"] = rng.normal(0, 0.05, (co,)).astype(np.float32)
    return p


def _packed(p_hwio, op_dtype):
    return TK.pack_rdb_params(params_from_jax({"rdb": p_hwio})["rdb"], op_dtype)


def _jax_rdb(x, p_hwio, op_dtype=None, gc=GC):
    """JAX rdb_apply (interpret mode) on NHWC numpy ``x``."""
    H, W = x.shape[1:3]
    sp = R.repack_scatter({"rdb": p_hwio})["rdb"]
    WB = K.round_wb(W)
    BLK, nblk = K.plan_rows(H, target_blk=4)
    kp = K.pack_rdb_params(sp, dtype=op_dtype or jnp.float32)
    yf = K.rdb_apply(
        K.to_flat(jnp.asarray(x), WB, BLK * nblk), kp, H=H, W=W, WB=WB,
        BLK=BLK, nblk=nblk, nf=NF, gc=gc, op_dtype=op_dtype, interpret=True,
    )
    return np.asarray(K.from_flat(yf, H, W, WB))


@pytest.mark.parametrize("hw", [(10, 13), (8, 8)])
def test_rdb_reference_matches_jax_f32(hw):
    H, W = hw
    p = _mk_params(NF, GC)
    x = np.random.default_rng(1).random((2, H, W, NF)).astype(np.float32)
    got = TK.rdb_reference(
        torch.from_numpy(x), _packed(p, torch.float32), torch.float32, torch.float32
    ).numpy()
    oracle = np.asarray(
        R._rdb_scatter(jnp.asarray(x), R.repack_scatter({"rdb": p})["rdb"], jnp.float32)
    )
    np.testing.assert_allclose(got, oracle, atol=5e-5)
    np.testing.assert_allclose(got, _jax_rdb(x, p), atol=5e-5)


def test_rdb_reference_matches_jax_mixed():
    """f32 state, bf16 operands: both round x and c1..c4 to bf16 at the
    same points and only the order of the f32 sums differs, but where two
    sums straddle a rounding boundary a c_i lands one bf16 ulp apart, so the
    bound is relative to the output's scale (as chip_smoke.py's). Weights
    at fan-in scale keep the convs from amplifying that; gc = 16 because
    bf16 weights pack in 16-channel tensor-core blocks."""
    H, W, gc = 9, 11, 16
    p = _mk_params(NF, gc, seed=3, wstd=0.05)
    x = np.random.default_rng(4).random((1, H, W, NF)).astype(np.float32)
    got = TK.rdb_reference(
        torch.from_numpy(x), _packed(p, torch.bfloat16), torch.float32, torch.bfloat16
    ).numpy()
    want = _jax_rdb(x, p, op_dtype=jnp.bfloat16, gc=gc)
    assert np.abs(got - want).max() <= 1e-3 * max(1.0, np.abs(want).max())


def test_plain_trunk_matches_jax_resident():
    """Six RDBs with distinct weights and the RRDB residual after each
    third: the port's rdb_trunk (plain on CPU) against rdb_apply_resident."""
    H, W = 10, 13
    ps = [_mk_params(NF, GC, seed=s) for s in range(6)]
    x = np.random.default_rng(1).random((2, H, W, NF)).astype(np.float32)

    WB = K.round_wb(W)
    BLK, nblk = K.plan_rows(H, target_blk=4)
    kps = [
        K.pack_rdb_params(R.repack_scatter({"rdb": p})["rdb"], dtype=jnp.float32)
        for p in ps
    ]
    kp = {k: jnp.stack([d[k] for d in kps]) for k in kps[0]}
    yc = K.rdb_apply_resident(
        K.to_flat(jnp.asarray(x), WB, BLK * nblk, top=8), kp, H=H, W=W, WB=WB,
        BLK=BLK, nblk=nblk, nf=NF, gc=GC, n_rdb=6, interpret=True,
    )
    want = np.asarray(K.from_flat(yc, H, W, WB))

    packed = [_packed(p, torch.float32) for p in ps]
    stacked = {k: torch.stack([d[k] for d in packed]) for k in ("w", "b")}
    launches = dict(TK.LAUNCHES)
    got = TK.rdb_trunk(torch.from_numpy(x), stacked).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5)
    assert TK.LAUNCHES == launches  # the plain version launches nothing


@pytest.mark.parametrize("nf,gc,op", [(16, 8, torch.float32), (32, 16, torch.bfloat16)])
def test_pack_unpack_roundtrip(nf, gc, op):
    p = params_from_jax({"rdb": _mk_params(nf, gc, seed=2)})["rdb"]
    packed = TK.pack_rdb_params(p, op)
    assert packed["w"].shape == (9 * sum((nf + i * gc) * (gc if i < 4 else nf) for i in range(5)),)
    back = TK.unpack_rdb_params(packed, nf)
    for k, v in p.items():
        want = torch.from_numpy(v).to(op if k.startswith("w") else torch.float32)
        np.testing.assert_array_equal(back[k].float().numpy(), want.float().numpy())


def test_mma_fragment_order():
    """Spot-check the tensor-core layout: lane 4g + t of the first B
    fragment holds rows 2t, 2t+1, 2t+8, 2t+9 (input channels of tap 0) of
    column g (output channel), for conv 1."""
    nf, gc = 32, 16
    w1 = np.arange(gc * nf * 9, dtype=np.float32).reshape(gc, nf, 3, 3)
    perm = TK._perm(nf, gc, "scatter", True)
    dense = np.moveaxis(w1, 0, -1).ravel()  # conv 1 as [cin][3][3][cout]
    frag = dense[perm[:128]].reshape(8, 4, 4)  # [g][t][4 values]
    for g in range(8):
        for t in range(4):
            rows = [2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]
            np.testing.assert_array_equal(frag[g, t], w1[g, rows, 0, 0])
    assert np.array_equal(np.sort(perm), np.arange(perm.size))


def test_rdb_apply_cpu_takes_plain_version():
    p = _packed(_mk_params(NF, GC, seed=5), torch.float32)
    x = torch.from_numpy(np.random.default_rng(6).random((1, 7, 9, NF)).astype(np.float32))
    u = x * 0.5
    want = TK.rdb_reference(x, p, torch.float32, torch.float32, u)
    torch.testing.assert_close(TK.rdb_apply(x, p, u), want, rtol=0, atol=0)


def test_rdb_apply_rejects_other_devices():
    p = _packed(_mk_params(NF, GC), torch.float32)
    x = torch.empty((1, 4, 4, NF), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TK.rdb_apply(x, p)


def test_library_build_needs_nvcc(monkeypatch, tmp_path):
    """No nvcc, no kernel: the build raises instead of falling back."""
    from realsr_tpu_torch.ops import build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("REALSR_TPU_TORCH_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        TK._library()
