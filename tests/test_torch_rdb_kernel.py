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
import torch.nn.functional as F

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


def _jax_rdb(x, p_hwio, op_dtype=None, gc=GC, nf=NF):
    """JAX rdb_apply (interpret mode) on NHWC numpy ``x``."""
    H, W = x.shape[1:3]
    sp = R.repack_scatter({"rdb": p_hwio})["rdb"]
    WB = K.round_wb(W)
    BLK, nblk = K.plan_rows(H, target_blk=4)
    kp = K.pack_rdb_params(sp, dtype=op_dtype or jnp.float32)
    yf = K.rdb_apply(
        K.to_flat(jnp.asarray(x), WB, BLK * nblk), kp, H=H, W=W, WB=WB,
        BLK=BLK, nblk=nblk, nf=nf, gc=gc, op_dtype=op_dtype, interpret=True,
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
        (32, 16, torch.bfloat16, "w"),  # the plain versions' layout
        (32, 16, torch.bfloat16, "wg"),  # wgmma order (K1, K3, K4)
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


def test_tf32_split_keeps_float32():
    """tf32_split: hi has 10 mantissa bits (the low 13 of float32 are zero),
    rounded to nearest with ties away from zero; lo is the remainder
    rounded the same way; hi + lo is within 2^-21 of v, relative, over
    values of many exponents and signs."""
    rng = np.random.default_rng(0)
    v = (rng.normal(0, 1, 20000) * np.exp2(rng.integers(-60, 60, 20000))).astype(np.float32)
    hi, lo = TK.tf32_split(v)
    assert hi.dtype == lo.dtype == np.float32
    for t in (hi, lo):
        assert not (t.view(np.uint32) & np.uint32(0x1FFF)).any()
    np.testing.assert_array_less(np.abs(v - hi), np.abs(v) * 2.0**-11 * (1 + 2.0**-20))
    err = np.abs(v.astype(np.float64) - hi.astype(np.float64) - lo.astype(np.float64))
    np.testing.assert_array_less(err, np.abs(v).astype(np.float64) * 2.0**-21)
    # ties: 1 + 2^-11 + 2^-23 rounds up, 1 + 2^-11 (half an ulp) away from zero
    t = np.array([1 + 2.0**-11, -(1 + 2.0**-11), 1 + 2.0**-11 - 2.0**-23], np.float32)
    np.testing.assert_array_equal(TK.tf32_split(t)[0], np.array([1 + 2.0**-10, -(1 + 2.0**-10), 1.0], np.float32))


@pytest.mark.parametrize("nf,gc", [(32, 16), (64, 32)])
def test_tf32_slice_order(nf, gc):
    """Spot-check the float32 kernel's B layout ("wt"): each k8 step of N
    outputs is its tf32 hi slice, then its lo slice, each K-major without
    swizzle with element (n, k) at (n // 8) * 64 + (k // 4) * 32 + (n % 8) *
    4 + k % 4; the steps follow (conv, source, tap, 8-channel block).
    Checked: conv 1's first step (x, tap 0, channels 0..7), conv 2's step of
    source c1 at tap 4, and conv 5's last step."""
    rng = np.random.default_rng(3)
    ws = {i: rng.normal(0, 1, (gc if i < 5 else nf, nf + (i - 1) * gc, 3, 3)).astype(np.float32)
          for i in range(1, 6)}
    p = {**{f"w{i}": ws[i] for i in ws}, **{f"b{i}": np.zeros(gc if i < 5 else nf, np.float32) for i in ws}}
    wt = TK.pack_rdb_params(p, torch.float32)["wt"].numpy()
    assert wt.shape == (2 * TK.rdb_macs_per_pixel(nf, gc),)
    n_steps = [9 * (nf + (i - 1) * gc) // 8 for i in range(1, 6)]
    starts = np.cumsum([0] + [s * 2 * 8 * (gc if i < 4 else nf) for i, s in enumerate(n_steps)])

    def check(conv, step, cin0, tap):
        n_out = gc if conv < 5 else nf
        o = starts[conv - 1] + step * 2 * 8 * n_out
        hi, lo = wt[o : o + 8 * n_out], wt[o + 8 * n_out : o + 16 * n_out]
        for n in range(n_out):
            for k in range(8):
                idx = (n // 8) * 64 + (k // 4) * 32 + (n % 8) * 4 + k % 4
                want_hi, want_lo = TK.tf32_split(ws[conv][n, cin0 + k, tap // 3, tap % 3])
                assert (hi[idx], lo[idx]) == (want_hi, want_lo), (conv, step, n, k)

    check(1, 0, 0, 0)
    # conv 2: x takes 9 taps x nf / 8 steps, then c1 (channels nf..) tap by tap
    check(2, 9 * nf // 8 + 4 * (gc // 8), nf, 4)
    # conv 5's last step: c4's last 8 channels at tap 8
    check(5, n_steps[4] - 1, nf + 4 * gc - 8, 8)
    perm = TK._perm(nf, gc, "scatter", True, "tf32")
    assert np.array_equal(np.sort(perm), np.arange(perm.size))


@pytest.mark.parametrize("nf,gc,op", [(32, 16, torch.float32), (64, 32, torch.float32), (32, 16, torch.bfloat16)])
def test_tf32_weights_round_trip(nf, gc, op):
    """float32 operands pack "wt" (twice "w"'s length) beside "w", bfloat16
    operands do not; "wt" unpacks (hi + lo) to within 2^-21 of the weights."""
    p = params_from_jax({"rdb": _mk_params(nf, gc, seed=4)})["rdb"]
    packed = TK.pack_rdb_params(p, op)
    assert ("wt" in packed) == (op == torch.float32)
    if op != torch.float32:
        return
    assert packed["wt"].dtype == torch.float32 and packed["wt"].numel() == 2 * packed["w"].numel()
    back = TK.unpack_rdb_params(packed, nf, key="wt")
    for k, v in p.items():
        if k.startswith("w"):
            np.testing.assert_array_less(np.abs(back[k].numpy() - v), np.abs(v) * 2.0**-21 + 1e-30)
        else:
            np.testing.assert_array_equal(back[k].numpy(), v)


def _device_split(a: np.ndarray):
    """The float32 kernel's split of its activations as the tensor cores
    read them (hopper.cuh::split_tf32): hi = ``a`` truncated to tf32, lo =
    ``a - hi`` truncated to tf32."""

    def trunc(t):
        return (np.ascontiguousarray(t, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)

    hi = trunc(a)
    return hi, trunc(a - hi)


def _tf32_rdb(x: np.ndarray, p: dict, nf: int, gc: int) -> np.ndarray:
    """The float32 kernel's arithmetic on the CPU: every conv input (x, c1..c4,
    kept in float32) split into tf32 hi + lo as the kernel splits it, every
    weight from "wt", each conv the sum lo x hi + hi x lo + hi x hi of three
    convs (summed in float64 here, in float32 on the card), bias after."""
    hi_t, lo_t = TK._tf32_unslice(p["wt"], nf, gc)
    perm = torch.from_numpy(TK._perm(nf, gc, "scatter", True, "tf32"))
    dense = []
    for t in (hi_t, lo_t):
        d = torch.empty_like(t)
        d[perm] = t
        dense.append(TK.unpack_rdb_params({"w": d, "b": p["b"]}, nf))
    w_hi, w_lo = dense

    def conv(feats, i):
        a_hi, a_lo = (torch.from_numpy(t).double() for t in _device_split(torch.cat(feats, 1).numpy()))
        wh, wl = w_hi[f"w{i}"].double(), w_lo[f"w{i}"].double()
        s = F.conv2d(a_lo, wh, padding=1) + F.conv2d(a_hi, wl, padding=1) + F.conv2d(a_hi, wh, padding=1)
        return (s + w_hi[f"b{i}"].double()[:, None, None]).float()

    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    feats = [xt]
    for i in range(1, 5):
        feats.append(F.leaky_relu(conv(feats, i), 0.2))
    y = 0.2 * conv(feats, 5) + xt
    return y.permute(0, 2, 3, 1).numpy()


def test_tf32_product_matches_jax_f32():
    """The 3xTF32 split product, emulated on the CPU for one RDB at nf 32,
    gc 16, against JAX's float32 rdb_apply (interpret mode, f32 operands at
    Precision.HIGHEST) within the float32 tests' 5e-5 (the split leaves
    ~2^-20 of each product), and against the kernel's plain version; one
    tf32 product alone misses by far more."""
    nf, gc, H, W = 32, 16, 9, 11
    p_hwio = _mk_params(nf, gc, seed=6, wstd=0.05)
    p = _packed(p_hwio, torch.float32)
    x = np.random.default_rng(7).normal(0, 0.5, (2, H, W, nf)).astype(np.float32)
    got = _tf32_rdb(x, p, nf, gc)
    np.testing.assert_allclose(got, _jax_rdb(x, p_hwio, gc=gc, nf=nf), atol=5e-5)
    plain = TK.rdb_reference(torch.from_numpy(x), p, torch.float32, torch.float32).numpy()
    np.testing.assert_allclose(got, plain, atol=5e-5)
    # one tf32 product alone (hi x hi) misses the float32 result by far more
    hi_only = {"w": torch.from_numpy(TK.tf32_split(p["w"].numpy())[0]), "b": p["b"]}
    coarse = TK.rdb_reference(torch.from_numpy(TK.tf32_split(x)[0]), hi_only, torch.float32, torch.float32).numpy()
    assert np.abs(coarse - plain).max() > 10 * np.abs(got - plain).max()


@pytest.mark.parametrize("nf,gc", [(64, 32), (32, 16)])
def test_tf32_smem_fits_each_built_side(nf, gc):
    """The float32 kernel's shared memory (the mirror of
    rdb_wgmma.cuh::LayoutF32) fits one block (232,448 bytes on the card) at
    each patch side it is built for, and not at 11 for nf = 64: the float32
    planes cap the side at 10."""
    limit = 232_448
    for tile in TK.TF32_TILES:
        assert TK.tf32_smem_bytes(tile, nf, gc) <= limit
    # hand count at T = 10, nf = 64: window 2 x 400 x 128 + c1..c4 4 x 32 x
    # (18^2 + 16^2 + 14^2 + 12^2) = 220,160, two 4 KB slots (one k8 step of
    # c5, hi and lo), 5 barriers, the 1,024-byte alignment
    assert TK.tf32_smem_bytes(10, 64, 32) == 220_160 + 2 * 4096 + 40 + 1024
    # T = 9: window 2 x 361 x 128 padded to 47,104 per sub-plane, slots 12 KB
    assert TK.tf32_smem_bytes(9, 64, 32) == 2 * 47_104 + 4 * 32 * (17**2 + 15**2 + 13**2 + 11**2) + 24_576 + 1064
    if nf == 64:
        assert TK.tf32_smem_bytes(11, nf, gc) > limit


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
def test_tf32_geometry_matches_brute_force(B, H, W, nf, gc, sms):
    """tf32_geometry (K1's float32 patch side) against a block-by-block
    count: K1's regions, the waves on ``sms`` SMs, and the side of
    TF32_TILES that minimises waves x (block MACs + the tf32 block price)."""
    useful = B * H * W * TK.rdb_macs_per_pixel(nf, gc)

    def count(tile):
        blocks, macs = 0, 0
        for _ in range(B):
            for _y in range(0, H, tile):
                for _x in range(0, W, tile):
                    blocks += 1
                    for r in range(1, 6):
                        side = tile + 10 - 2 * r
                        macs += -(-(side * side) // 64) * 64 * 9 * (nf + (r - 1) * gc) * (gc if r < 5 else nf)
        return blocks, macs

    prices = {}
    for tile in TK.TF32_TILES:
        blocks, macs = count(tile)
        prices[tile] = -(-blocks // sms) * (macs // blocks + TK.TF32_BLOCK_OVERHEAD_MACS)
    want = max(t for t, c in prices.items() if c == min(prices.values()))
    geo = TK.tf32_geometry(B, H, W, nf, gc, sms)
    blocks, macs = count(want)
    assert geo.tile == want
    assert geo.patches == (-(-H // want), -(-W // want))
    assert geo.blocks == blocks
    assert geo.mac_factor == pytest.approx(macs / useful)
    if (B, H, W, nf, sms) == (8, 148, 148, 64, 132):
        assert (geo.tile, geo.blocks) == (10, 1800)
        assert geo.mac_factor == pytest.approx(1.998, abs=5e-4)


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


@pytest.mark.parametrize("B,H,W", GEOMETRY_SHAPES)
@pytest.mark.parametrize("nf,gc,sms", [(64, 32, 132), (32, 16, 16)])
def test_packed_tf32_geometry_matches_brute_force(B, H, W, nf, gc, sms):
    """packed_tf32_geometry (K5's float32 instances) against a block-by-block
    count of the packed rectangles' issued MACs: the side of
    PACKED_TF32_TILES that minimises waves x (MACs + the float32 block
    price); every side it may pick fits one block's shared memory, and its
    patches cover every output pixel."""
    useful = B * H * W * 9 * sum((nf + i * gc) * (gc if i < 4 else nf) for i in range(5))
    prices, counts = {}, {}
    for tile in TK.PACKED_TF32_TILES:
        blocks = B * -(-H // tile) * -(-W // tile)
        counts[tile] = (blocks, blocks * TK.packed_block_macs(tile, nf, gc))
        prices[tile] = -(-blocks // sms) * (TK.packed_block_macs(tile, nf, gc) + TK.TF32_BLOCK_OVERHEAD_MACS)
        assert TK.packed_tf32_smem_bytes(tile, nf, gc) <= TK.SMEM_BLOCK
    want = max(t for t, c in prices.items() if c == min(prices.values()))
    geo = TK.packed_tf32_geometry(B, H, W, nf, gc, sms)
    assert geo.tile == want
    py, px = geo.patches
    assert py * want >= H > (py - 1) * want and px * want >= W > (px - 1) * want
    assert geo.blocks == counts[want][0]
    assert geo.waves == pytest.approx(counts[want][0] / sms)
    assert geo.mac_factor == pytest.approx(counts[want][1] / useful)
    if (B, H, W, nf, sms) == (8, 148, 148, 64, 132):
        assert (geo.tile, geo.blocks) == (8, 2888)
        assert geo.mac_factor == pytest.approx(3.083, abs=5e-4)


@pytest.mark.parametrize("nf,gc", [(64, 32), (32, 16)])
def test_packed_tf32_smem_fits_each_built_side(nf, gc):
    """K5's float32 shared memory (PackedLayout on LayoutF32) fits one block
    at each side it is built for, and not at 9 for nf = 64: float32 planes
    and the partial sums cap the side at 8."""
    for tile in TK.PACKED_TF32_TILES:
        assert TK.packed_tf32_smem_bytes(tile, nf, gc) <= TK.SMEM_BLOCK
    # hand count at T = 8, nf = 64: the window 2 x 41 KB sub-planes (18^2
    # pixels of 128 bytes, padded to 1,024) + c1..c4 4 x 32 x (16^2 + 14^2 +
    # 12^2 + 10^2) = 173,056, partials max(14^2 x 36, 10^2 x 36 + 8^2 x 68) x
    # 4 = 31,808, two 12 KB slots, 5 barriers, the alignment
    assert TK.packed_tf32_smem_bytes(8, 64, 32) == 173_056 + 31_808 + 2 * 12_288 + 40 + 1024
    if nf == 64:
        assert TK.packed_tf32_smem_bytes(9, nf, gc) > TK.SMEM_BLOCK


@pytest.mark.parametrize("nf,gc", [(64, 32), (32, 16)])
def test_packed_tf32_weights_round_trip(nf, gc):
    """pack_rdb_params(float32, sched="packed") packs "wt": the five packed
    rectangles' k8 steps, each as its tf32 hi slice then its lo slice, which
    unpack (hi + lo) to within 2^-21 of the weights; rectangle C's first k8
    step of c1 (after x's 9 x nf / 8 steps) holds, for its output column n,
    the tf32 split of the weight of c1's first 8 channels at tap 0 for c3
    (n < gc), c4 (n < 2 gc) or c5."""
    p = params_from_jax({"rdb": _mk_params(nf, gc, seed=9)})["rdb"]
    packed = TK.pack_rdb_params(p, torch.float32, "packed")
    assert packed["wt"].numel() == 2 * packed["w"].numel() == 2 * TK.rdb_macs_per_pixel(nf, gc)
    back = TK.unpack_rdb_params(packed, nf, "packed", key="wt")
    for k, v in p.items():
        if k.startswith("w"):
            np.testing.assert_array_less(np.abs(back[k].numpy() - v), np.abs(v) * 2.0**-21 + 1e-30)
        else:
            np.testing.assert_array_equal(back[k].numpy(), v)
    sizes = TK._rect_sizes(nf, gc, "packed")
    n_c = 2 * gc + nf
    assert [n for _, n in sizes] == [2 * gc, gc, n_c, gc + nf, nf]
    o = 2 * (sizes[0][0] + sizes[1][0]) + (9 * nf // 8) * 2 * 8 * n_c
    wt = packed["wt"].numpy()
    hi, lo = wt[o : o + 8 * n_c], wt[o + 8 * n_c : o + 16 * n_c]
    for n in range(n_c):
        conv, co = (3, n) if n < gc else (4, n - gc) if n < 2 * gc else (5, n - 2 * gc)
        for k in range(8):
            idx = (n // 8) * 64 + (k // 4) * 32 + (n % 8) * 4 + k % 4
            want = TK.tf32_split(p[f"w{conv}"][co, nf + k, 0, 0])
            assert (hi[idx], lo[idx]) == want, (n, k)


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
        TK._tf32_library("f32_nf64")
