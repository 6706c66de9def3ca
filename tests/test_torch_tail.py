"""The port's packed-phase tail and its kernel module against the JAX package.

The CUDA tail kernel runs only on the card (tests/test_torch_gpu.py); here
the plain versions its wrappers take for CPU tensors are held to JAX's
einsum packed tail and to its Pallas tail kernels in interpret mode, on the
same numpy inputs.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realsr_tpu.models import rrdbnet as R
from realsr_tpu.ops import tail_kernel as JTK
from realsr_tpu_torch.engine import EngineConfig, RealSR
from realsr_tpu_torch.loader import load_model, resolve_forms
from realsr_tpu_torch.models import rrdbnet as TR
from realsr_tpu_torch.ops import tail_kernel as TK

torch.set_num_threads(2)


def _tail_params(nf, seed):
    """HWIO tail params, drawn as tests/test_packed_tail.py draws them."""
    rng = np.random.default_rng(seed)

    def conv(ci, co):
        return (
            rng.normal(0, 0.1, (3, 3, ci, co)).astype(np.float32),
            rng.normal(0, 0.05, (co,)).astype(np.float32),
        )

    (tw, tb), (u0, c0), (u1, c1), (hw, hb), (lw, lb) = (
        conv(nf, nf), conv(nf, nf), conv(nf, nf), conv(nf, nf), conv(nf, 3)
    )
    return {
        "trunk": {"w": tw, "b": tb},
        "up": {"w": np.stack([u0, u1]), "b": np.stack([c0, c1])},
        "hr": {"w": hw, "b": hb},
        "last": {"w": lw, "b": lb},
    }


def _inputs(nf, shape, seed):
    rng = np.random.default_rng(seed)
    fea = rng.normal(0, 1, (*shape, nf)).astype(np.float32)
    body = rng.normal(0, 1, (*shape, nf)).astype(np.float32)
    return fea, body


def _jax_tail(params, fea, body, nf, od=jnp.float32, kernel=0):
    """JAX's packed tail (PACKED_TAIL on; conftest restores the flags),
    its kernels in interpret mode."""
    spec = R.RRDBNetSpec(num_rrdb=1, nf=nf, gc=nf // 2)
    R.PACKED_TAIL, R.PACKED_TAIL_KERNEL = True, kernel
    origs = (JTK.hr_last_packed, JTK.up2_hr_last_packed)
    JTK.hr_last_packed = functools.partial(origs[0], interpret=True)
    JTK.up2_hr_last_packed = functools.partial(origs[1], interpret=True)
    try:
        return np.asarray(R._pallas_tail(
            params, jnp.asarray(fea), jnp.asarray(body), spec, jnp.float32,
            jnp.dtype(od), None if od == jnp.float32 else od,
        ))
    finally:
        JTK.hr_last_packed, JTK.up2_hr_last_packed = origs


def _port_tail(params_hwio, fea, body, nf, tail, od=torch.float32):
    spec = TR.RRDBNetSpec(num_rrdb=1, nf=nf, gc=nf // 2)
    p = TR.params_from_jax(params_hwio)
    if tail in ("kernel_hr", "kernel"):
        p["tail"] = TK.pack_tail_params(p, od)
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)  # noqa: E731
    return TR._tail(p, nchw(fea), nchw(body), spec, torch.float32, od, tail).numpy()


def test_phase_split_and_packed_weights_bit_equal_jax():
    params = _tail_params(64, seed=40)
    p = TR.params_from_jax(params)
    w = params["up"]["w"][1]
    kj, kt = R._phase_split(jnp.asarray(w)), TR._phase_split(w)
    for a in (0, 1):
        for b in (0, 1):
            np.testing.assert_array_equal(kt[a][b], np.asarray(kj[a][b]))
    # JAX's up2 packing (rrdbnet.py _packed_tail, kernel mode 2)
    w2_jax = jnp.stack([
        jnp.transpose(
            jnp.stack([kj[c][d][s, t] for s in (0, 1) for t in (0, 1)]), (2, 0, 1)
        ).reshape(64, 256)
        for c in (0, 1)
        for d in (0, 1)
    ])
    w2, b2 = TK.up2_weights(p["up"]["w"][1], p["up"]["b"][1])
    np.testing.assert_array_equal(w2, np.asarray(w2_jax))
    np.testing.assert_array_equal(b2, params["up"]["b"][1].reshape(64, 1))
    want = JTK.pack_tail_weights(
        params["hr"]["w"], params["hr"]["b"], params["last"]["w"], params["last"]["b"],
        dtype=np.float32,
    )
    got = TK.pack_tail_weights(p["hr"]["w"], p["hr"]["b"], p["last"]["w"], p["last"]["b"])
    for g, wnt in zip(got, want):
        assert g.shape == wnt.shape
        np.testing.assert_array_equal(g, np.asarray(wnt))


@pytest.mark.parametrize("name", ["w2", "w1", "w9", "w0"])
def test_wgmma_layout_round_trips(name):
    """The kernel's operands, k16 slices in wgmma's layout (w9 in W9-packed
    columns, w0 up1's phases side by side), unpack bit-equal to the JAX
    package's matrices (bf16-rounded; w0 its packed tail's k1c); b3 stays
    the JAX package's padded bias and b0 is its up1 bias tiled over the
    four phases."""
    params = _tail_params(64, seed=41)
    p = TR.params_from_jax(params)
    tp = TK.pack_tail_params(p, torch.bfloat16)
    dense = dict(zip(("w2", "w1", "w9"), TK._dense(tp)), w0=TK._dense_up1(tp))
    k1 = R._phase_split(jnp.asarray(params["up"]["w"][0]))
    k1c = jnp.concatenate([k1[0][0], k1[0][1], k1[1][0], k1[1][1]], axis=-1)  # rrdbnet.py _packed_tail
    kj = R._phase_split(jnp.asarray(params["up"]["w"][1]))
    w2_jax = jnp.stack([
        jnp.concatenate([kj[c][d][s, t] for s in (0, 1) for t in (0, 1)], 0)
        for c in (0, 1)
        for d in (0, 1)
    ])  # [4, 256, 64]: rows tap-major x cin
    w1_j, _, w9_j, b3_j = JTK.pack_tail_weights(
        params["hr"]["w"], params["hr"]["b"], params["last"]["w"], params["last"]["b"],
        dtype=np.float32,
    )
    want = {
        "w2": np.asarray(w2_jax),
        "w1": np.asarray(w1_j).T,
        "w9": np.asarray(w9_j).reshape(9, 8, 64).transpose(0, 2, 1).reshape(576, 8),
        "w0": np.asarray(k1c).reshape(256, 256),
    }[name]
    assert torch.equal(dense[name], torch.from_numpy(np.array(want)).to(torch.bfloat16))
    assert tp[name].numel() == {"w2": 4 * 256 * 64, "w1": 576 * 64, "w9": 64 * TK.W9N, "w0": 256 * 256}[name]
    assert tp["b3"].tolist() == np.asarray(b3_j).ravel().tolist()
    assert tp["b0"].tolist() == np.tile(params["up"]["b"][0], 4).tolist()


def test_wgmma_layout_is_k16_slices():
    """Spot check of one element per slice position: element (k, n) of k16
    slice s sits at s * 16 N + (n // 8) * 128 + (k // 8) * 64 + (n % 8) * 8
    + k % 8 (8 x 8 core matrices, the k halves side by side)."""
    dense = np.arange(32 * 24, dtype=np.float32).reshape(32, 24)
    packed = TK._wg_pack(dense)
    for s in range(2):
        for k in range(16):
            for n in range(24):
                at = s * 16 * 24 + (n // 8) * 128 + (k // 8) * 64 + (n % 8) * 8 + k % 8
                assert packed[at] == dense[16 * s + k, n]
    assert torch.equal(TK._wg_unpack(torch.from_numpy(packed), 32, 24), torch.from_numpy(dense))


def _tf32_unpack(packed: torch.Tensor, k: int, n: int):
    """Inverse of TK._tf32_pack: the hi and lo parts, ``[k, n]`` each."""
    cols, rows = (torch.from_numpy(a) for a in TK._step_order("tf32", n))
    steps = packed.reshape(k // 8, 2, 8 * n)
    out = []
    for part in (0, 1):
        dense = torch.empty((k // 8, 8, n), dtype=packed.dtype)
        dense[:, rows, cols] = steps[:, part]
        out.append(dense.reshape(k, n))
    return out


@pytest.mark.parametrize("name", ["w2t", "w1t", "w9t", "w0t"])
def test_tf32_slices_round_trip(name):
    """float32 operands also pack the float32 kernel's "w2t" / "w1t" /
    "w9t" / "w0t": per k8 step the tf32 hi slice, then the lo slice, in the order of
    _wg_pack's k16 slices (the same matrices, the same passes): hi + lo
    unslice to the dense float32 weights within 2^-21, relative, and bf16
    operands pack none of them."""
    p = TR.params_from_jax(_tail_params(64, seed=44))
    tp = TK.pack_tail_params(p, torch.float32)
    assert name not in TK.pack_tail_params(p, torch.bfloat16)
    k, n, passes = {"w2t": (256, 128, 2), "w1t": (576, 64, 1), "w9t": (64, TK.W9N, 1), "w0t": (256, 256, 1)}[name]
    dense = tp[name[:2]].reshape(passes, -1)
    packed = tp[name].reshape(passes, -1)
    assert tp[name].dtype == torch.float32 and tp[name].numel() == 2 * tp[name[:2]].numel()
    for c in range(passes):
        want = TK._wg_unpack(dense[c], k, n).double()
        hi, lo = _tf32_unpack(packed[c], k, n)
        for t in (hi, lo):
            assert not (t.numpy().view(np.uint32) & np.uint32(0x1FFF)).any()
        err = (hi.double() + lo.double() - want).abs()
        assert bool((err <= want.abs() * 2.0**-21).all())


def test_tf32_slice_layout():
    """Spot check of _tf32_pack: element (k, n) of k8 step s sits in the
    step's hi slice at s * 16 N + (n // 8) * 64 + (k // 4) * 32 + (n % 8) * 4
    + k % 4 (8 x 4 core matrices, the k halves side by side), its lo part 8 N
    further on."""
    rng = np.random.default_rng(45)
    dense = rng.normal(0, 1, (24, 16)).astype(np.float32)
    packed = TK._tf32_pack(dense)
    assert packed.shape == (2 * 24 * 16,)
    for s in range(3):
        for k in range(8):
            for n in range(16):
                at = s * 16 * 16 + (n // 8) * 64 + (k // 4) * 32 + (n % 8) * 4 + k % 4
                hi, lo = TK.tf32_split(dense[8 * s + k, n])
                assert (packed[at], packed[at + 8 * 16]) == (hi, lo)


def test_w9_conv_last_equals_plain_conv_last_f32():
    """The kernel's W9-packed conv_last (one K = 64 product per z pixel, then
    nine shifted sums) against the plain version's K = 576 conv, float32."""
    params = _tail_params(64, seed=42)
    p = TR.params_from_jax(params)
    tp = TK.pack_tail_params(p, torch.float32)
    _, _, w9 = TK._dense(tp)
    z = torch.from_numpy(
        np.abs(np.random.default_rng(43).normal(0, 0.5, (2, 13, 22, 64))).astype(np.float32)
    )
    want = TR._nhwc(TR.conv3x3(TR._nchw(z), p["last"]["w"], p["last"]["b"]))
    w9c = TK._wg_unpack(tp["w9"], 64, TK.W9N)
    got = TK.conv_last_w9(z, w9c, tp["b3"])
    assert got.shape == want.shape == (2, 13, 22, 3)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    assert w9.shape == (576, 8)


@pytest.mark.parametrize("tail,kernel", [("kernel", 2), ("kernel_hr", 1)])
def test_w9_form_of_kernel_tails_matches_jax_kernels(tail, kernel):
    """K6 and K7 with conv_last in the kernel's W9-packed form (P2 and z from
    the plain version, float32) against JAX's Pallas kernels in interpret
    mode, within the plain versions' tolerance."""
    params = _tail_params(64, seed=15)
    fea, body = _inputs(64, (2, 7, 9), seed=16)
    want = _jax_tail(params, fea, body, 64, kernel=kernel)
    spec = TR.RRDBNetSpec(num_rrdb=1, nf=64, gc=32)
    p = TR.params_from_jax(params)
    tp = TK.pack_tail_params(p, torch.float32)
    w2, w1, _ = TK._dense(tp)
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)  # noqa: E731
    trunk = TR.conv3x3(nchw(body), p["trunk"]["w"], p["trunk"]["b"])
    fea_t = TR._nhwc(nchw(fea) + trunk)
    y1 = TR.up1_phases(fea_t, torch.as_tensor(p["up"]["w"][0]), torch.as_tensor(p["up"]["b"][0]),
                       torch.float32, torch.float32)
    P2 = TR.up2_phases(TR.p1_phases(y1, 64), w2, tp["b2"], torch.float32, torch.float32)
    z = TR.interleave_phases(TR.conv_phases(P2, w1, tp["b1"], TR.LRELU_SLOPE, torch.float32, torch.float32))
    got = TK.conv_last_w9(z, TK._wg_unpack(tp["w9"], 64, TK.W9N), tp["b3"]).numpy()
    assert got.shape == want.shape == (2, 28, 36, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


def _check_geometry(geometry, tiles, smem, B, H, W, form):
    """The chosen patch shape is built, even, fits one block's shared memory
    and tiles the 4x output with no patch row or column left empty; its grid
    is at most one block per SM; its cost is the least of the shapes."""
    g = geometry(B, H, W, form)
    th, tw = g.tile
    assert g.tile in tiles and th % 2 == 0 and tw % 2 == 0
    assert smem(th, tw, form) <= TK.SMEM_LIMIT
    py, px = g.patches
    assert py * th >= 4 * H > (py - 1) * th and px * tw >= 4 * W > (px - 1) * tw
    assert g.blocks == B * py * px and g.grid == min(g.blocks, 132)
    assert 0 < g.fill <= 1 and g.mac_factor >= 1

    def cost(t):
        blocks = B * -(-4 * H // t[0]) * -(-4 * W // t[1])
        return -(-blocks // 132) * TK.tail_block_macs(*t, form)

    assert cost(g.tile) == min(cost(t) for t in tiles if smem(*t, form) <= TK.SMEM_LIMIT)
    return g


@pytest.mark.parametrize("B,H,W", [(8, 148, 148), (2, 37, 21), (1, 5, 7), (1, 1, 1)])
@pytest.mark.parametrize("with_up2", [True, False])
def test_tail_geometry_fits_and_covers(B, H, W, with_up2):
    """K6 (with_up2: up1 and up2 inside) and K7: :func:`_check_geometry`."""
    g = _check_geometry(TK.tail_geometry, TK.TAIL_TILES, TK.tail_smem_bytes, B, H, W,
                        TK.K6 if with_up2 else TK.K7)
    if (B, H, W) == (8, 148, 148):
        assert g.tile == (12, 28) and g.blocks == 8800


@pytest.mark.parametrize("B,H,W", [(8, 148, 148), (5, 276, 276), (2, 37, 21), (1, 5, 7), (1, 1, 1)])
def test_fused_tail_geometry_fits_and_covers(B, H, W):
    """K6 with up1 inside: :func:`_check_geometry`; 8 x 148² and the cells'
    chunks of 276² take 12 x 28, and up1 issues 16 x 256 x 256 MACs a
    patch: y1 fills one 64-row tile at every patch shape."""
    g = _check_geometry(TK.tail_geometry, TK.TAIL_TILES, TK.tail_smem_bytes, B, H, W, TK.K6)
    if (B, H, W) in ((8, 148, 148), (5, 276, 276)):
        assert g.tile == (12, 28)
    for t in TK.TAIL_TILES + TK.TAIL_TF32_TILES:
        r = TK._regions(*t)
        assert r["y1"] <= 64
        up2 = 4 * 64 * -(-r["sub"] // 64) * 256 * 64
        assert TK.tail_block_macs(*t) - TK.tail_block_macs(*t, TK.K7) - up2 == 64 * 256 * 256


@pytest.mark.parametrize("B,H,W", [(8, 148, 148), (2, 37, 21), (9, 37, 37), (1, 1, 1)])
@pytest.mark.parametrize("with_up2", [True, False])
def test_tail_tf32_geometry_fits_and_covers(B, H, W, with_up2):
    """The float32 instances' patch shape, K6 (with_up2) and K7:
    :func:`_check_geometry` with float32 planes over TAIL_TF32_TILES; the
    12 x 28 and 16 x 16 of the bfloat16 instances do not fit."""
    form = TK.K6 if with_up2 else TK.K7
    g = _check_geometry(TK.tail_tf32_geometry, TK.TAIL_TF32_TILES, TK.tail_tf32_smem_bytes, B, H, W, form)
    for t in TK.TAIL_TILES:
        assert TK.tail_tf32_smem_bytes(*t, form) > TK.SMEM_LIMIT
    if (B, H, W) == (8, 148, 148):
        assert g.tile == (10, 14) and g.blocks == 20640
        # hand count, K7: z 12 x 16 and two P2 14 x 18 pixels, each two
        # sub-planes of 128-byte pixels padded to 1 KB; 2 x 16 KB slots; 8
        # barriers
        sub = lambda p: -(-p * 128 // 1024) * 1024  # noqa: E731
        if not with_up2:
            assert TK.tail_tf32_smem_bytes(10, 14, form) == 2 * (sub(192) + 2 * sub(252)) + 32768 + 64


@pytest.mark.parametrize("B,H,W", [(8, 148, 148), (2, 37, 21), (9, 37, 37), (1, 1, 1)])
def test_fused_tail_tf32_geometry_fits_and_covers(B, H, W):
    """K6 with up1 inside at float32: :func:`_check_geometry`; at 8 x 148²
    10 x 14, whose block holds the fea window 6 x 7, the 2x window 9 x 11,
    z 12 x 16 and P2 14 x 18 pixels, each two sub-planes of 128-byte pixels
    padded to 1 KB, 2 x 32 KB slots and 6 barriers."""
    g = _check_geometry(TK.tail_tf32_geometry, TK.TAIL_TF32_TILES, TK.tail_tf32_smem_bytes, B, H, W, TK.K6)
    for t in TK.TAIL_TILES:
        assert TK.tail_tf32_smem_bytes(*t) > TK.SMEM_LIMIT
    if (B, H, W) == (8, 148, 148):
        assert g.tile == (10, 14) and g.blocks == 20640
        sub = lambda p: -(-p * 128 // 1024) * 1024  # noqa: E731
        assert TK.tail_tf32_smem_bytes(10, 14) == 2 * (sub(42) + sub(99) + sub(192) + sub(252)) + 65536 + 48


def test_tail_block_macs_count_the_stages():
    """tail_block_macs against the stages counted by hand at 16 x 16: up1
    over 7 x 7 y1 pixels in one tile (K6), up2 4 sub-phases of 10 x 10
    pixels in 2 tiles, HRconv and conv_last over 18 x 18 z pixels in 6
    tiles; shared memory: the fea window 8 x 8 (K6), the 2x window 12 x 12,
    z 18 x 18, P2 20 x 20."""
    k7 = 384 * (576 * 64 + 64 * 32)
    assert TK.tail_block_macs(16, 16) == 64 * 256 * 256 + 4 * 128 * 256 * 64 + k7
    assert TK.tail_block_macs(16, 16, TK.K7) == k7
    assert TK.tail_smem_bytes(16, 16) == 128 * (8 * 8 + 12 * 12 + 18 * 18 + 20 * 20) + 2 * 32768 + 48
    assert TK.tail_smem_bytes(16, 16, TK.K7) == 128 * (18 * 18 + 2 * 20 * 20) + 2 * 16384 + 64
    # a base pixel: up1 4 x 256 x 64, the rest 16 x 64 x (256 + 576) + 16 x 3 x 576
    assert 16 * TK.tail_macs_per_pixel() == 945_152 == 4 * 256 * 64 + 16 * 64 * (256 + 576) + 16 * 3 * 576
    assert 16 * TK.tail_macs_per_pixel(TK.K7) == 16 * (576 * 64 + 3 * 576)


@pytest.mark.parametrize("H,W", [(7, 9), (8, 8), (5, 12)])
def test_packed_tail_matches_jax_f32(H, W):
    params = _tail_params(16, seed=1)
    fea, body = _inputs(16, (2, H, W), seed=2)
    want = _jax_tail(params, fea, body, 16)
    got = _port_tail(params, fea, body, 16, "packed")
    assert got.shape == want.shape == (2, 4 * H, 4 * W, 3)
    # same taps, float32 sums in another order
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


def test_packed_tail_matches_jax_mixed():
    """Mixed mode: both round the same operands; sums in another order can
    round a bf16 operand one ulp apart, so the limit is relative, and the
    error against float32 must be JAX's own size (tests/test_torch_model.py
    rule)."""
    params = _tail_params(16, seed=3)
    fea, body = _inputs(16, (1, 6, 11), seed=4)
    want = _jax_tail(params, fea, body, 16, jnp.bfloat16)
    exact = _jax_tail(params, fea, body, 16)
    got = _port_tail(params, fea, body, 16, "packed", torch.bfloat16)
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
    rms = lambda a: float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))  # noqa: E731
    assert 0.8 <= rms(got - exact) / rms(want - exact) <= 1.25


@pytest.mark.parametrize("H,W", [(7, 9), (12, 12)])
@pytest.mark.parametrize("tail,kernel", [("kernel", 2), ("kernel_hr", 1)])
def test_kernel_plain_versions_match_jax_kernels(tail, kernel, H, W):
    """K6 (up1_up2_hr_last_packed) and K7 (hr_last_packed) on CPU tensors take
    their plain versions; held to JAX's Pallas kernels in interpret mode,
    float32, nf = 64. CPU calls launch nothing."""
    params = _tail_params(64, seed=15)
    fea, body = _inputs(64, (2, H, W), seed=16)
    want = _jax_tail(params, fea, body, 64, kernel=kernel)
    launches = dict(TK.LAUNCHES)
    got = _port_tail(params, fea, body, 64, tail)
    assert TK.LAUNCHES == launches
    assert got.shape == want.shape == (2, 4 * H, 4 * W, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("od", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,W", [(2, 7, 9), (1, 12, 5)])
def test_fused_entry_plain_version_matches_up1_then_p1_entry(od, B, H, W):
    """K6's plain version (up1_up2_hr_last_packed on CPU tensors) against
    up1_phases (the packed tail's up1, cuDNN's conv on the card) rounded to
    the operand type and then up2_hr_last_reference: y1 within one
    rounding step of the operand type (the two sum in another order; the
    same bits in float32 to 1e-6), the outputs within the mixed tolerance
    (1e-2 of the output's scale; float32 2e-4 absolute)."""
    p = TR.params_from_jax(_tail_params(64, seed=47))
    tp = TK.pack_tail_params(p, od)
    fea = torch.from_numpy(np.random.default_rng(48).normal(0, 1, (B, H, W, 64)).astype(np.float32))
    w, b = torch.as_tensor(p["up"]["w"][0]), torch.as_tensor(p["up"]["b"][0])
    y1 = TR.up1_phases(fea, w, b, od, torch.float32).to(od)
    y1_fused = TK.up1_reference(fea, tp)
    assert y1_fused.dtype == od and y1_fused.shape == y1.shape == (B, H + 1, W + 1, 256)
    step = 2.0**-7 if od == torch.bfloat16 else 1e-6
    d = (y1_fused.float() - y1.float()).abs()
    assert bool((d <= step * y1.float().abs() + 1e-6).all())
    launches = dict(TK.LAUNCHES)
    got = TK.up1_up2_hr_last_packed(fea.to(od), tp)
    assert TK.LAUNCHES == launches
    want = TK.up2_hr_last_reference(y1, tp)
    assert got.shape == want.shape == (B, 4 * H, 4 * W, 3) and got.dtype == torch.float32
    if od == torch.bfloat16:
        assert (got - want).abs().max().item() <= 1e-2 * want.abs().max().item()
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-4)


def test_fused_kernel_tail_matches_jax_kernel_tail_mixed():
    """The K6 tail in mixed mode (up1 inside K6's plain version) against
    JAX's packed tail on its Pallas K6 (mode 2, interpret mode), bfloat16
    operands: the rule of test_packed_tail_matches_jax_mixed (1e-2 of the
    output's scale; the error against float32 JAX's own size)."""
    params = _tail_params(64, seed=49)
    fea, body = _inputs(64, (2, 6, 11), seed=50)
    want = _jax_tail(params, fea, body, 64, jnp.bfloat16, kernel=2)
    exact = _jax_tail(params, fea, body, 64)
    got = _port_tail(params, fea, body, 64, "kernel", torch.bfloat16)
    assert got.shape == want.shape == (2, 24, 44, 3)
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
    rms = lambda a: float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))  # noqa: E731
    assert 0.8 <= rms(got - exact) / rms(want - exact) <= 1.25


@pytest.mark.parametrize("tail", ["packed", "kernel_hr", "kernel"])
def test_packed_and_interleaved_tails_agree_f32(tail):
    """Every packed form reproduces the interleaved tail's taps and zero
    borders; only the order of the float32 sums differs. A border-only
    input probes the zero padding."""
    params = _tail_params(64, seed=5)
    fea, body = _inputs(64, (1, 6, 7), seed=6)
    fea[:, 1:-1, 1:-1] = 0.0
    for f, b in ((fea, body), _inputs(64, (2, 5, 9), seed=7)):
        want = _port_tail(params, f, b, 64, "interleaved")
        np.testing.assert_allclose(_port_tail(params, f, b, 64, tail), want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("raw", ["0", "1", "2", "3", "4", "5", "off", ""])
def test_packed_tail_env_parsed_as_jax(raw, tiny_model_dir, monkeypatch):
    from realsr_tpu.engine import EngineConfig as JaxConfig
    from realsr_tpu.engine import RealSR as JaxRealSR

    monkeypatch.setenv("REALSR_TPU_PACKED_TAIL", raw)
    e = JaxRealSR(gpuid=-1, config=JaxConfig(tilesize=32, compilation_cache=False))
    e.load(os.path.join(tiny_model_dir, "x4.param"), os.path.join(tiny_model_dir, "x4.bin"))
    level = (1 + R.PACKED_TAIL_KERNEL) if R.PACKED_TAIL else 0
    # the port's "auto" tail: the variable's level where it is set, K6
    # where it is not on a card's kernel variant, interleaved on the CPU
    spec = TR.RRDBNetSpec(num_rrdb=1)
    assert resolve_forms(spec, "cpu").tail == TR.TAIL_MODES[level]
    assert resolve_forms(spec, "gpu").tail == (TR.TAIL_MODES[level] if raw else "kernel")


@pytest.fixture(scope="module")
def nf64_model(tmp_path_factory):
    from realsr_tpu_torch.ncnn.synth import make_model_dir

    d = tmp_path_factory.mktemp("nf64") / "models-DF2K"
    return make_model_dir(str(d), TR.RRDBNetSpec(num_rrdb=1, nf=64, gc=32), seed=2)


@pytest.mark.parametrize("tail", ["kernel_hr", "kernel"])
def test_explicit_kernel_tail_raises_without_an_instance(tail, nf64_model, tiny_model_dir):
    """The tail kernel has bfloat16 and float32 instances at nf = 64: float16
    operands and other widths raise; float32 loads with its tf32 slices."""
    with pytest.raises(NotImplementedError, match="none for torch.float16"):
        load_model(*nf64_model, torch.float16, torch.float16, tail=tail)
    tiny = (os.path.join(tiny_model_dir, "x4.param"), os.path.join(tiny_model_dir, "x4.bin"))
    with pytest.raises(ValueError, match="nf=64"):
        load_model(*tiny, torch.float32, torch.bfloat16, tail=tail)
    e = RealSR(gpuid=-1, config=EngineConfig(tilesize=32, storage="float16", tail=tail))
    with pytest.raises(NotImplementedError, match="none for torch.float16"):
        e.load(*nf64_model)
    b = load_model(*nf64_model, torch.float32, torch.float32, tail=tail)
    assert b.tail == tail and {"w1t", "w9t"} <= set(b.params["tail"])


def test_auto_tail(nf64_model, monkeypatch):
    """'auto' is the interleaved tail on the CPU; the loader's 'auto' is the
    kernel where it has an instance (bfloat16 and float32 operands, as JAX's
    float32 Pallas engine ends on its kernel tail); the environment
    overrides 'auto'."""
    monkeypatch.delenv("REALSR_TPU_PACKED_TAIL", raising=False)
    e = RealSR(gpuid=-1, config=EngineConfig(tilesize=32, storage="mixed"))
    e.load(*nf64_model)
    assert e.tail == "interleaved"
    assert load_model(*nf64_model, torch.float32, torch.bfloat16, tail="auto").tail == "kernel"
    assert load_model(*nf64_model, torch.float32, torch.float32, tail="auto").tail == "kernel"
    assert load_model(*nf64_model, torch.float16, torch.float16, tail="auto").tail == "interleaved"
    monkeypatch.setenv("REALSR_TPU_PACKED_TAIL", "2")
    e.load(*nf64_model)
    assert e.tail == "kernel_hr" and "tail" in e._params


@pytest.mark.parametrize("tail,kernel", [("kernel", 2), ("kernel_hr", 1)])
def test_float32_engine_kernel_tail_matches_jax_kernel_tail(tail, kernel, nf64_model, monkeypatch):
    """A float32 CPU engine on the K6 (K7) tail, its kernels' plain versions,
    against the same engine whose forward is the JAX package's float32
    Pallas forward ending on its packed kernel tail (PACKED_TAIL_KERNEL 2 for
    REALSR_TPU_PACKED_TAIL=3, 1 for =2; every Pallas kernel in interpret
    mode, the tail's at any side): u8 values equal on >= 99.9 %, max diff 1
    (the two sum in another order)."""
    from realsr_tpu.loader import load_model as jax_load
    from realsr_tpu.ops import rdb_kernel as JK

    img = np.random.default_rng(46).integers(0, 256, (14, 17, 3), np.uint8)
    e = RealSR(gpuid=-1, config=EngineConfig(tilesize=32, storage="float32", variant="cuda", tail=tail))
    e.load(*nf64_model)
    assert e.tail == tail
    got = e.process(img)

    jb = jax_load(*nf64_model, storage_dtype=jnp.float32, variant="pallas")
    monkeypatch.setattr(R, "PACKED_TAIL_MIN_SIDE", 0)
    R.PACKED_TAIL, R.PACKED_TAIL_KERNEL, R.RESIDENT_TRUNK = True, kernel, False
    calls = []
    for mod, names in ((JK, ("rdb_apply",)), (JTK, ("hr_last_packed", "up2_hr_last_packed"))):
        for n in names:
            def interpreted(*a, _f=getattr(mod, n), _n=n, **kw):
                calls.append(_n)
                return _f(*a, interpret=True, **kw)

            monkeypatch.setattr(mod, n, interpreted)

    def jax_forward(_, tiles):
        y = R.rrdbnet_forward(jb.params, jnp.asarray(tiles.numpy()), jb.spec, storage_dtype=jnp.float32,
                              variant="pallas", op_dtype=jnp.float32)
        return torch.from_numpy(np.array(y))

    monkeypatch.setattr(e.bundle, "forward", jax_forward)
    want = e.process(img)
    # (traced once each: the JAX forward scans its RDBs)
    assert "rdb_apply" in calls and calls.count("up2_hr_last_packed" if kernel == 2 else "hr_last_packed") == 1
    assert got.shape == want.shape == (56, 68, 3)
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and np.mean(d == 0) >= 0.999


def test_engine_kernel_tail_matches_interleaved_mixed(nf64_model):
    """A mixed CPU engine on the K6 tail (its plain version) against the
    interleaved one: the packed form rounds tap sums, the interleaved form
    each tap, so the two are held by PSNR, not u8 equality."""
    img = np.random.default_rng(3).integers(0, 256, (21, 26, 3), np.uint8)
    outs = {}
    for tail in ("interleaved", "kernel", "packed"):
        e = RealSR(gpuid=-1, config=EngineConfig(tilesize=32, storage="mixed", tail=tail))
        e.load(*nf64_model)
        outs[tail] = e.process(img).astype(np.float64)
    assert outs["kernel"].shape == (84, 104, 3)
    for tail in ("kernel", "packed"):
        mse = np.mean((outs[tail] - outs["interleaved"]) ** 2)
        assert mse == 0 or 10 * np.log10(255.0**2 / mse) >= 40.0
