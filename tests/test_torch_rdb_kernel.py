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


@pytest.mark.parametrize(
    "nf,gc,op,key",
    [
        (16, 8, torch.float32, "w"),
        (32, 16, torch.bfloat16, "w"),  # mma.sync fragment order (K3)
        (32, 16, torch.bfloat16, "wg"),  # wgmma order (K1)
        (64, 32, torch.bfloat16, "wg"),
    ],
)
def test_pack_unpack_roundtrip(nf, gc, op, key):
    p = params_from_jax({"rdb": _mk_params(nf, gc, seed=2)})["rdb"]
    packed = TK.pack_rdb_params(p, op)
    assert packed[key].shape == (9 * sum((nf + i * gc) * (gc if i < 4 else nf) for i in range(5)),)
    assert ("wg" in packed) == (op == torch.bfloat16)
    back = TK.unpack_rdb_params(packed, nf, key=key)
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


@pytest.mark.parametrize("nf,gc", [(32, 16), (64, 32)])
def test_wgmma_slice_order(nf, gc):
    """Spot-check the wgmma kernel's B layout: a k16 slice of N outputs is
    K-major without swizzle, element (n, k) at (n // 8) * 128 + (k // 8) *
    64 + (n % 8) * 8 + k % 8; the slices follow (conv, source, tap,
    16-channel block). Checked: conv 1's first slice (x, tap 0, channels
    0..15), conv 2's slice of source c1 at tap 4, and conv 5's last slice."""
    ws = {i: np.arange(i * 10**6, i * 10**6 + (gc if i < 5 else nf) * (nf + (i - 1) * gc) * 9,
                       dtype=np.float64).reshape(gc if i < 5 else nf, nf + (i - 1) * gc, 3, 3)
          for i in range(1, 6)}
    perm = TK._perm(nf, gc, "scatter", True, "wgmma")
    dense = np.concatenate([np.moveaxis(ws[i], 0, -1).ravel() for i in range(1, 6)])
    packed = dense[perm]
    n_steps = [9 * (nf + (i - 1) * gc) // 16 for i in range(1, 6)]
    starts = np.cumsum([0] + [s * 16 * (gc if i < 4 else nf) for i, s in enumerate(n_steps)])

    def slice_at(conv, step):
        n_out = gc if conv < 5 else nf
        o = starts[conv - 1] + step * 16 * n_out
        return packed[o : o + 16 * n_out]

    def check(conv, step, cin0, tap):
        got = slice_at(conv, step)
        n_out = gc if conv < 5 else nf
        for n in range(n_out):
            for k in range(16):
                idx = (n // 8) * 128 + (k // 8) * 64 + (n % 8) * 8 + k % 8
                assert got[idx] == ws[conv][n, cin0 + k, tap // 3, tap % 3], (conv, step, n, k)

    check(1, 0, 0, 0)
    # conv 2: x takes 9 taps x nf / 16 steps, then c1 (channels nf..) tap by tap
    check(2, 9 * nf // 16 + 4 * (gc // 16), nf, 4)
    # conv 5's last step: c4's last 16 channels at tap 8
    check(5, n_steps[4] - 1, nf + 4 * gc - 16, 8)
    assert np.array_equal(np.sort(perm), np.arange(perm.size))


# shapes for rdb_geometry: the main path's chunk, single and ragged tiles,
# sides below every patch side, one pixel
GEOMETRY_SHAPES = [(8, 148, 148), (1, 148, 148), (8, 148, 52), (2, 23, 17), (1, 5, 7), (3, 1, 40), (1, 1, 1)]


@pytest.mark.parametrize("B,H,W", GEOMETRY_SHAPES)
@pytest.mark.parametrize("nf,gc,sms", [(64, 32, 132), (32, 16, 16)])
def test_rdb_geometry_matches_brute_force(B, H, W, nf, gc, sms):
    """rdb_geometry against a block-by-block count: each block's five
    regions rounded up to 64-row tiles times K x N, the blocks, the waves on
    ``sms`` SMs, and the patch side that minimises waves x block price."""
    useful = B * H * W * 9 * sum((nf + i * gc) * (gc if i < 4 else nf) for i in range(5))

    def count(tile):
        blocks, macs = 0, 0
        for _ in range(B):
            for _y in range(0, H, tile):
                for _x in range(0, W, tile):
                    blocks += 1
                    for r in range(1, 6):
                        side = tile + 10 - 2 * r
                        rows = -(-(side * side) // 64) * 64
                        macs += rows * 9 * (nf + (r - 1) * gc) * (gc if r < 5 else nf)
        return blocks, macs

    prices = {}
    for tile in TK.WGMMA_TILES:
        blocks, macs = count(tile)
        waves = -(-blocks // sms)
        prices[tile] = waves * (macs // blocks + TK.BLOCK_OVERHEAD_MACS)
    best = min(prices.values())
    want = max(t for t, c in prices.items() if c == best)
    geo = TK.rdb_geometry(B, H, W, nf, gc, sms)
    blocks, macs = count(want)
    assert geo.tile == want
    assert geo.patches == (-(-H // want), -(-W // want))
    assert geo.blocks == blocks
    assert geo.waves == pytest.approx(blocks / sms)
    assert geo.fill == pytest.approx(blocks / (-(-blocks // sms) * sms))
    assert geo.mac_factor == pytest.approx(macs / useful)
    if (B, H, W, nf, sms) == (8, 148, 148, 64, 132):
        assert (geo.tile, geo.blocks) == (17, 648)


@pytest.mark.parametrize("B,H,W", GEOMETRY_SHAPES)
@pytest.mark.parametrize("nf,gc,sms", [(64, 32, 132), (32, 16, 16)])
def test_packed_geometry_matches_brute_force(B, H, W, nf, gc, sms):
    """packed_geometry (K5) against a block-by-block count: each block's
    five packed rectangles over their first output's region, rounded up to
    64-row tiles, times K x N; the side of PACKED_TILES that minimises waves
    x block price."""
    useful = B * H * W * 9 * sum((nf + i * gc) * (gc if i < 4 else nf) for i in range(5))
    # (region, K, N) of rectangles A..E
    rects = [(1, 9 * nf, 2 * gc), (2, 9 * gc, gc), (3, 9 * (nf + 2 * gc), 2 * gc + nf), (4, 9 * gc, gc + nf),
             (5, 9 * gc, nf)]

    def count(tile):
        blocks, macs = 0, 0
        for _ in range(B):
            for _y in range(0, H, tile):
                for _x in range(0, W, tile):
                    blocks += 1
                    for r, k, n in rects:
                        side = tile + 10 - 2 * r
                        macs += -(-(side * side) // 64) * 64 * k * n
        return blocks, macs

    prices = {}
    for tile in TK.PACKED_TILES:
        blocks, macs = count(tile)
        prices[tile] = -(-blocks // sms) * (macs // blocks + TK.BLOCK_OVERHEAD_MACS)
    want = max(t for t, c in prices.items() if c == min(prices.values()))
    geo = TK.packed_geometry(B, H, W, nf, gc, sms)
    blocks, macs = count(want)
    assert geo.tile == want
    assert geo.patches == (-(-H // want), -(-W // want))
    assert geo.blocks == blocks
    assert geo.waves == pytest.approx(blocks / sms)
    assert geo.mac_factor == pytest.approx(macs / useful)
    if (B, H, W, nf, sms) == (8, 148, 148, 64, 132):
        assert (geo.tile, geo.blocks, TK.packed_block_macs(12, nf, gc)) == (12, 1352, 68_419_584)
        assert geo.mac_factor == pytest.approx(2.203, abs=5e-4)


@pytest.mark.parametrize("nf,gc", [(64, 32), (32, 16)])
def test_packed_smem_fits_each_built_side(nf, gc):
    """K5's shared memory (the mirror of rdb_modes_wgmma.cu::PackedLayout)
    fits one block (232,448 bytes on the card) at each patch side it is
    built for, and not at 13 for nf = 64: the partial sums cap the side at
    12."""
    limit = 232_448
    for tile in TK.PACKED_TILES:
        assert TK.packed_smem_bytes(tile, nf, gc) <= limit
    # hand count at T = 12, nf = 64: planes 137,216 + partials 67,392 + ring
    # 2 x 12,288 + 5 barriers + the 1,024-byte alignment
    assert TK.packed_smem_bytes(12, 64, 32) == 137_216 + 67_392 + 24_576 + 40 + 1024
    if nf == 64:
        assert TK.packed_smem_bytes(13, nf, gc) > limit


def test_plain_trunk_threads_operand_plane():
    """Mixed mode on the CPU: rdb_trunk threads each RDB's bfloat16 operand
    plane into the next (the plain path's counterpart of the kernel's
    shadow), and equals the trunk of lone rdb_apply calls, which round x
    themselves, exactly."""
    H, W, gc = 9, 11, 16
    ps = [_mk_params(NF, gc, seed=10 + s, wstd=0.05) for s in range(6)]
    packed = [_packed(p, torch.bfloat16) for p in ps]
    stacked = {k: torch.stack([d[k] for d in packed]) for k in packed[0]}
    x = torch.from_numpy(np.random.default_rng(2).random((2, H, W, NF)).astype(np.float32))
    t = u = x
    for k in range(6):
        if k % 3 == 0:
            u = t
        t = TK.rdb_apply(t, {n: v[k] for n, v in stacked.items()}, u if k % 3 == 2 else None)
    got = TK.rdb_trunk(x, stacked)
    assert torch.equal(got, t)


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
