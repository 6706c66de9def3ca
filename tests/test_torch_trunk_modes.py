"""The kernel trunk's alternative modes against the JAX package, on the CPU.

K5 (the K-packed schedule), K3 (the chained layout) and K4 (the paired bf16
carry) run on the card only (tests/test_torch_gpu.py); here their plain
PyTorch versions, which the wrappers take for CPU tensors, are held to the
JAX package's Pallas kernels in interpret mode, one block and a whole tiny
forward per mode, and the engine's mode selection to the JAX engine's.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realsr_tpu.models import rrdbnet as R
from realsr_tpu.ops import rdb_kernel as K
from realsr_tpu_torch.engine import EngineConfig, RealSR
from realsr_tpu_torch.loader import resolve_forms
from realsr_tpu_torch.models import rrdbnet as TR
from realsr_tpu_torch.models.rrdbnet import params_from_jax
from realsr_tpu_torch.ops import rdb_kernel as TK
from tests.conftest import TINY_SPEC

torch.set_num_threads(2)

NF, GC = 16, 8
PORT_SPEC = TR.RRDBNetSpec(**{
    f: getattr(TINY_SPEC, f)
    for f in ("num_rrdb", "num_rdb_per_rrdb", "nf", "gc", "in_ch", "out_ch", "num_upsample")
})


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


def _port_packed(p_hwio, op_dtype, sched="scatter"):
    return TK.pack_rdb_params(params_from_jax({"rdb": p_hwio})["rdb"], op_dtype, sched)


def _stack(p, n):
    return {k: torch.stack([v] * n) for k, v in p.items()}


def _rect_matrices(p, nf, gc, key="w"):
    """The port's packed-schedule weights ``p[key]`` as the JAX package lays
    out its rectangles: ``[N, 9 * cin]`` per rectangle, contraction index
    (source, tap, channel)."""
    if key == "wg":  # the wgmma order -> the [K][N] layout
        dense = {k: v.float().numpy() for k, v in TK.unpack_rdb_params(p, nf, "packed", key).items()}
        p = TK.pack_rdb_params(dense, torch.float32, "packed")
    w = p["w"].float().numpy()
    out, o = [], 0
    for sources, convs in TK._rects("packed"):
        n = sum(gc if i < 5 else nf for i in convs)
        cols = []
        for j in sources:
            c = nf if j == 0 else gc
            blk = w[o : o + c * 9 * n].reshape(c, 9, n)
            cols.append(blk.transpose(2, 1, 0).reshape(n, 9 * c))
            o += c * 9 * n
        out.append(np.concatenate(cols, 1))
    assert o == w.size
    return out


# -- K5: the K-packed schedule ----------------------------------------------


@pytest.mark.parametrize(
    "nf,gc,op,key",
    [(16, 8, torch.float32, "w"), (16, 8, torch.bfloat16, "w"), (32, 16, torch.bfloat16, "w"),
     (32, 16, torch.bfloat16, "wg"), (64, 32, torch.bfloat16, "wg")],
)
def test_packed_weights_equal_jax_rectangles(nf, gc, op, key):
    """Both copies of the packed schedule's weights, the plain versions'
    ("w") and the wgmma kernel's ("wg", K5), hold JAX's rectangles."""
    p = _mk_params(nf, gc, seed=2)
    jdt = jnp.float32 if op == torch.float32 else jnp.bfloat16
    kp = K.pack_rdb_params(R.repack_scatter({"rdb": p})["rdb"], dtype=jdt, sched="packed")
    assert kp["w0"].shape == (2 * gc, 9 * nf)
    assert kp["w1"].shape == (gc, 9 * gc)
    assert kp["w2"].shape == (2 * gc + nf, 9 * (nf + 2 * gc))
    port = _port_packed(p, op, "packed")
    for r, m in enumerate(_rect_matrices(port, nf, gc, key)):
        want = np.asarray(kp[f"w{r}"]).astype(np.float32)
        assert m.shape == want.shape
        np.testing.assert_array_equal(m, want)
    bias = np.concatenate([np.asarray(kp[f"b{i}"])[:, 0] for i in range(1, 6)])
    np.testing.assert_array_equal(port["b"].numpy(), bias)


@pytest.mark.parametrize("hw", [(10, 13), (8, 8)])
def test_packed_reference_matches_jax_f32(hw):
    """JAX's own bound for its packed kernel against the scatter oracle."""
    H, W = hw
    p = _mk_params(NF, GC)
    x = np.random.default_rng(1).random((2, H, W, NF)).astype(np.float32)
    WB = K.round_wb(W)
    BLK, nblk = K.plan_rows(H, target_blk=4)
    kp = K.pack_rdb_params(R.repack_scatter({"rdb": p})["rdb"], dtype=jnp.float32, sched="packed")
    yf = K.rdb_apply(
        K.to_flat(jnp.asarray(x), WB, BLK * nblk), kp, H=H, W=W, WB=WB, BLK=BLK,
        nblk=nblk, nf=NF, gc=GC, sched="packed", interpret=True,
    )
    want = np.asarray(K.from_flat(yf, H, W, WB))
    pp = _port_packed(p, torch.float32, "packed")
    launches = dict(TK.LAUNCHES)
    got = TK.rdb_apply_packed(torch.from_numpy(x), pp).numpy()
    assert TK.LAUNCHES == launches  # the CPU takes the plain version
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_packed_reference_matches_jax_mixed_chain():
    """Two packed RDBs in mixed mode (float32 state, bfloat16 operands):
    both round the same operands, and only the order of the f32 sums inside
    a rectangle differs, so c1..c4 may land one bf16 ulp apart where two
    sums straddle a rounding boundary; the bound is relative to the
    output's scale, as for K1 (tests/test_torch_rdb_kernel.py)."""
    H, W = 9, 11
    p = _mk_params(NF, GC, seed=3)
    x = np.random.default_rng(4).random((1, H, W, NF)).astype(np.float32)
    WB = K.round_wb(W)
    BLK, nblk = K.plan_rows(H, target_blk=5)
    kp = K.pack_rdb_params(R.repack_scatter({"rdb": p})["rdb"], dtype=jnp.bfloat16, sched="packed")
    kw = dict(H=H, W=W, WB=WB, BLK=BLK, nblk=nblk, nf=NF, gc=GC, op_dtype=jnp.bfloat16,
              sched="packed", interpret=True)
    yf = K.rdb_apply(K.to_flat(jnp.asarray(x), WB, BLK * nblk), kp, **kw)
    yf = K.rdb_apply(K.re_apron(yf, WB), kp, **kw)
    want = np.asarray(K.from_flat(yf, H, W, WB))
    pp = _port_packed(p, torch.bfloat16, "packed")
    got = TK.rdb_apply_packed(TK.rdb_apply_packed(torch.from_numpy(x), pp), pp).numpy()
    assert np.abs(got - want).max() <= 1e-3 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("nf,gc", [(32, 16), (64, 32)])
def test_packed_wgmma_order_round_trips(nf, gc):
    """pack_rdb_params(sched="packed") writes "wg" (the wgmma order, K5)
    beside "w"; _perm is a permutation and both unpack to the same dense
    weights, bf16-rounded."""
    p = params_from_jax({"rdb": _mk_params(nf, gc, seed=7)})["rdb"]
    packed = TK.pack_rdb_params(p, torch.bfloat16, "packed")
    perm = TK._perm(nf, gc, "packed", True, "wgmma")
    assert np.array_equal(np.sort(perm), np.arange(perm.size))
    assert packed["wg"].shape == packed["w"].shape == (TK.rdb_macs_per_pixel(nf, gc),)
    from_wg = TK.unpack_rdb_params(packed, nf, "packed", "wg")
    from_w = TK.unpack_rdb_params(packed, nf, "packed", "w")
    for k, v in p.items():
        want = torch.from_numpy(v).to(torch.bfloat16 if k.startswith("w") else torch.float32)
        assert torch.equal(from_wg[k], want) and torch.equal(from_w[k], want)


def test_packed_wgmma_slice_order():
    """Spot-check K5's B layout: rectangle C's first k16 slice (source x,
    tap 0, channels 0..15) holds, K-major without swizzle, element (n, k) at
    (n // 8) * 128 + (k // 8) * 64 + (n % 8) * 8 + k % 8, its columns c3's gc
    outputs, then c4's, then c5's nf."""
    nf, gc = 32, 16
    ws = {i: np.arange(i * 10**6, i * 10**6 + (gc if i < 5 else nf) * (nf + (i - 1) * gc) * 9,
                       dtype=np.float64).reshape(gc if i < 5 else nf, nf + (i - 1) * gc, 3, 3)
          for i in range(1, 6)}
    packed = np.concatenate([np.moveaxis(ws[i], 0, -1).ravel() for i in range(1, 6)])[
        TK._perm(nf, gc, "packed", True, "wgmma")]
    # rectangles A (K 9 nf, N 2 gc) and B (K 9 gc, N gc) come first
    start = 9 * nf * 2 * gc + 9 * gc * gc
    n_c = 2 * gc + nf
    got = packed[start : start + 16 * n_c]
    for n in range(n_c):
        conv, co = (3, n) if n < gc else (4, n - gc) if n < 2 * gc else (5, n - 2 * gc)
        for k in range(16):
            assert got[(n // 8) * 128 + (k // 8) * 64 + (n % 8) * 8 + k % 8] == ws[conv][co, k, 0, 0], (n, k)


def test_packed_trunk_threads_operand_plane_and_matches_jax():
    """The packed trunk on the CPU, with the bf16 operand plane threaded
    from RDB to RDB as on the card, equals the chain of lone packed RDBs
    exactly, and the JAX packed chain within the mixed bound (two RDBs, as
    test_packed_reference_matches_jax_mixed_chain); three RDBs fold the
    RRDB residual as rdb_trunk's other schedule does."""
    H, W = 9, 11
    p = _mk_params(NF, GC, seed=3)
    x = np.random.default_rng(4).random((1, H, W, NF)).astype(np.float32)
    WB = K.round_wb(W)
    BLK, nblk = K.plan_rows(H, target_blk=5)
    kp = K.pack_rdb_params(R.repack_scatter({"rdb": p})["rdb"], dtype=jnp.bfloat16, sched="packed")
    kw = dict(H=H, W=W, WB=WB, BLK=BLK, nblk=nblk, nf=NF, gc=GC, op_dtype=jnp.bfloat16,
              sched="packed", interpret=True)
    yf = K.rdb_apply(K.to_flat(jnp.asarray(x), WB, BLK * nblk), kp, **kw)
    yf = K.rdb_apply(K.re_apron(yf, WB), kp, **kw)
    want = np.asarray(K.from_flat(yf, H, W, WB))
    pp = _port_packed(p, torch.bfloat16, "packed")
    xt = torch.from_numpy(x)
    launches = dict(TK.LAUNCHES)
    got = TK.rdb_trunk(xt, _stack(pp, 2), "packed")
    assert TK.LAUNCHES == launches
    assert torch.equal(got, TK.rdb_apply_packed(TK.rdb_apply_packed(xt, pp), pp))
    assert np.abs(got.numpy() - want).max() <= 1e-3 * max(1.0, np.abs(want).max())
    t3 = TK.rdb_apply_packed(TK.rdb_apply_packed(TK.rdb_apply_packed(xt, pp), pp), pp, xt)
    assert torch.equal(TK.rdb_trunk(xt, _stack(pp, 3), "packed"), t3)


# -- K3: the chained layout ------------------------------------------------


@pytest.mark.parametrize("hw_tb", [(10, 13, 4), (8, 8, 8), (9, 11, 3)])
def test_chained_trunk_matches_jax(hw_tb):
    """Two full RRDBs (six chained calls, the residual folded into each
    third by the device flag) against JAX's rdb_apply_chained on its TOP=8
    layout, and bit-equal to the port's per-RDB trunk."""
    H, W, tb = hw_tb
    p = _mk_params(NF, GC)
    x = np.random.default_rng(1).random((2, H, W, NF)).astype(np.float32)
    WB = K.round_wb(W)
    BLK, nblk = K.plan_rows(H, target_blk=tb)
    kp = K.pack_rdb_params(R.repack_scatter({"rdb": p})["rdb"], dtype=jnp.float32)
    tf = K.to_flat(jnp.asarray(x), WB, BLK * nblk, top=8)
    kw = dict(H=H, W=W, WB=WB, BLK=BLK, nblk=nblk, nf=NF, gc=GC, interpret=True)
    f0, f1 = jnp.zeros((1,), jnp.int32), jnp.ones((1,), jnp.int32)
    for _ in range(2):
        u = tf
        for f in (f0, f0, f1):
            tf = K.rdb_apply_chained(tf, kp, u, f, **kw)
    want = np.asarray(K.from_flat(tf[:, :, 8 * WB : (8 + BLK * nblk) * WB], H, W, WB))

    stacked = _stack(_port_packed(p, torch.float32), 6)
    xt = torch.from_numpy(x)
    got = TK.rdb_trunk_chained(xt, stacked)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)
    assert torch.equal(got, TK.rdb_trunk(xt, stacked))


def test_chained_layout_and_flag():
    """The layout holds the image at the apron offset and zeros elsewhere;
    one call writes the image only, folding u where the flag is 1."""
    p = _port_packed(_mk_params(NF, GC, seed=5), torch.float32)
    x = torch.from_numpy(np.random.default_rng(6).random((1, 7, 9, NF)).astype(np.float32))
    xc = TK.to_chained(x)
    assert xc.shape == (1, 16 + 10, 16 + 10, NF)
    assert torch.equal(TK.from_chained(xc, 7, 9), x) and xc.abs().sum() == x.abs().sum()
    uc = TK.to_chained(x * 0.5)
    for flag in (0, 1):
        out = torch.zeros_like(xc)
        TK.rdb_apply_chained(xc, p, uc, torch.tensor([flag], dtype=torch.int32), 7, 9, out)
        want = TK.rdb_apply(x, p, x * 0.5 if flag else None)
        assert torch.equal(TK.from_chained(out, 7, 9), want)
        rest = out.clone()
        TK.from_chained(rest, 7, 9).zero_()
        assert not rest.any()


def _chained_by_patches(xc, p, uc, flag, H, W, tile, shadow, conv=None):
    """K3's blocks on the CPU, float32: each ``tile`` x ``tile`` patch of the
    H x W image computes its RDB from the (tile + 10)^2 window of the chained
    layout at the patch's place, zeros past the layout (as TMA fills them),
    c1..c4 by valid 3x3 convs over the shrinking regions, zeroed outside the
    image; the output (with 0.2 y + u where ``flag``) goes to the image
    pixels of a zero layout, and bf16 of it to ``shadow``'s. ``conv(inp,
    i)``: conv i on its valid region (default: float32 with bias)."""
    nf = xc.shape[-1]
    w = TK.unpack_rdb_params(p, nf)
    conv = conv or (lambda inp, i: torch.nn.functional.conv2d(inp, w[f"w{i}"], w[f"b{i}"]))
    out = torch.zeros_like(xc)
    A, S0 = TK.CHAIN_APRON, tile + 10
    lay = torch.nn.functional.pad(xc.permute(0, 3, 1, 2), (0, S0, 0, S0))
    for py0 in range(0, H, tile):
        for px0 in range(0, W, tile):
            feats = [lay[:, :, py0 : py0 + S0, px0 : px0 + S0]]  # image rows py0 - 5 ...
            for i in range(1, 6):
                inp = torch.cat([f[:, :, i - 1 - j : f.shape[2] - (i - 1 - j), i - 1 - j : f.shape[3] - (i - 1 - j)]
                                 for j, f in enumerate(feats)], 1)
                c = conv(inp, i)
                if i < 5:
                    ys = torch.arange(c.shape[2]) + py0 - A + i
                    xs = torch.arange(c.shape[3]) + px0 - A + i
                    inside = ((ys >= 0) & (ys < H))[:, None] & ((xs >= 0) & (xs < W))[None, :]
                    feats.append(torch.where(inside, torch.nn.functional.leaky_relu(c, 0.2), 0.0))
            h, wd = min(tile, H - py0), min(tile, W - px0)
            y = 0.2 * c[:, :, :h, :wd] + feats[0][:, :, A : A + h, A : A + wd]
            if flag:
                y = 0.2 * y + uc.permute(0, 3, 1, 2)[:, :, A + py0 : A + py0 + h, A + px0 : A + px0 + wd]
            out[:, A + py0 : A + py0 + h, A + px0 : A + px0 + wd] = y.permute(0, 2, 3, 1)
            shadow[:, A + py0 : A + py0 + h, A + px0 : A + px0 + wd] = y.permute(0, 2, 3, 1)
    return out


@pytest.mark.parametrize("tile", [17, 12])
def test_chained_patches_at_other_sides_match_jax(tile):
    """K3 on wgmma takes K1's patch sides (17 at the main path's chunk),
    which need not divide the layout's rounding to 16: the patch-by-patch
    emulation of its blocks (windows read past the layout as zeros, c1..c4
    masked to the image, image pixels written) at a side other than 16
    matches JAX's chained kernel (interpret mode) with and without the
    flagged residual, leaves the aprons zero, and writes the shadow."""
    H, W = 21, 19
    p = _mk_params(NF, GC, seed=11)
    x = np.random.default_rng(12).random((2, H, W, NF)).astype(np.float32)
    u = np.random.default_rng(13).random((2, H, W, NF)).astype(np.float32)
    WB = K.round_wb(W)
    BLK, nblk = K.plan_rows(H, target_blk=4)
    kp = K.pack_rdb_params(R.repack_scatter({"rdb": p})["rdb"], dtype=jnp.float32)
    kw = dict(H=H, W=W, WB=WB, BLK=BLK, nblk=nblk, nf=NF, gc=GC, interpret=True)
    tf = K.to_flat(jnp.asarray(x), WB, BLK * nblk, top=8)
    tu = K.to_flat(jnp.asarray(u), WB, BLK * nblk, top=8)
    pp = _port_packed(p, torch.float32)
    xc, uc = TK.to_chained(torch.from_numpy(x)), TK.to_chained(torch.from_numpy(u))
    assert xc.shape[1] == -(-H // 16) * 16 + 10 and (xc.shape[1] - 10) % tile
    for flag in (0, 1):
        yc = K.rdb_apply_chained(tf, kp, tu, jnp.full((1,), flag, jnp.int32), **kw)
        want = np.asarray(K.from_flat(yc[:, :, 8 * WB : (8 + BLK * nblk) * WB], H, W, WB))
        shadow = torch.zeros_like(xc)
        got = _chained_by_patches(xc, pp, uc, flag, H, W, tile, shadow)
        np.testing.assert_allclose(TK.from_chained(got, H, W).numpy(), want, atol=5e-5)
        rest = got.clone()
        TK.from_chained(rest, H, W).zero_()
        assert not rest.any()
        assert torch.equal(shadow, got)
        # the port's plain chained version, with the shadow, agrees
        out, sh = torch.zeros_like(xc), torch.zeros_like(xc)
        TK.rdb_apply_chained(xc, pp, uc, torch.tensor([flag], dtype=torch.int32), H, W, out, shadow=sh)
        np.testing.assert_allclose(out.numpy(), got.numpy(), atol=5e-5)
        assert torch.equal(sh, out)


def _tf32_conv(p, nf):
    """conv(inp, i) of float32 K3's (and K1's) blocks: the activations split
    as the kernel splits them (hi = tf32 truncation, lo = the rest,
    truncated by the tensor cores), the weights' hi and lo from "wt", the
    three products lo x hi + hi x lo + hi x hi summed (in float64 here),
    then the bias."""
    gc = (p["b"].numel() - nf) // 4
    hi, lo = TK._tf32_unslice(p["wt"], nf, gc)
    perm = torch.from_numpy(TK._perm(nf, gc, "scatter", True, "tf32"))
    ws = []
    for t in (hi, lo):
        d = torch.empty_like(t)
        d[perm] = t
        ws.append(TK.unpack_rdb_params({"w": d, "b": p["b"]}, nf))

    def trunc(t):
        return (t.contiguous().view(torch.int32) & -8192).view(torch.float32)

    def conv(inp, i):
        a_hi = trunc(inp)
        a_lo = trunc(inp - a_hi)
        wh, wl = ws[0][f"w{i}"].double(), ws[1][f"w{i}"].double()
        f = torch.nn.functional.conv2d
        s = f(a_lo.double(), wh) + f(a_hi.double(), wl) + f(a_hi.double(), wh)
        return (s + ws[0][f"b{i}"].double()[:, None, None]).float()

    return conv


@pytest.mark.parametrize("tile", TK.TF32_TILES)
def test_chained_tf32_patches_match_jax(tile):
    """float32 K3 takes float32 K1's patch sides (tf32_geometry's; 10 at the
    main path's chunk) and its split 3xTF32 product: the patch-by-patch
    emulation of its blocks with that product matches JAX's float32 chained
    kernel (interpret mode, Precision.HIGHEST) within 5e-5, with and without
    the flagged residual, and leaves the aprons zero."""
    H, W = 21, 19
    assert TK.tf32_geometry(2, H, W, NF, GC).tile in TK.TF32_TILES
    p = _mk_params(NF, GC, seed=14, wstd=0.1)
    x = np.random.default_rng(15).random((2, H, W, NF)).astype(np.float32)
    u = np.random.default_rng(16).random((2, H, W, NF)).astype(np.float32)
    WB = K.round_wb(W)
    BLK, nblk = K.plan_rows(H, target_blk=4)
    kp = K.pack_rdb_params(R.repack_scatter({"rdb": p})["rdb"], dtype=jnp.float32)
    kw = dict(H=H, W=W, WB=WB, BLK=BLK, nblk=nblk, nf=NF, gc=GC, interpret=True)
    tf = K.to_flat(jnp.asarray(x), WB, BLK * nblk, top=8)
    tu = K.to_flat(jnp.asarray(u), WB, BLK * nblk, top=8)
    pp = _port_packed(p, torch.float32)
    xc, uc = TK.to_chained(torch.from_numpy(x)), TK.to_chained(torch.from_numpy(u))
    for flag in (0, 1):
        yc = K.rdb_apply_chained(tf, kp, tu, jnp.full((1,), flag, jnp.int32), **kw)
        want = np.asarray(K.from_flat(yc[:, :, 8 * WB : (8 + BLK * nblk) * WB], H, W, WB))
        got = _chained_by_patches(xc, pp, uc, flag, H, W, tile, torch.zeros_like(xc), _tf32_conv(pp, NF))
        np.testing.assert_allclose(TK.from_chained(got, H, W).numpy(), want, atol=5e-5)
        rest = got.clone()
        TK.from_chained(rest, H, W).zero_()
        assert not rest.any()


# -- K4: the paired carry --------------------------------------------------


def test_paired_chain_matches_jax():
    """Twelve paired calls against JAX's rdb_apply_paired (interpret): both
    read the same hi operands and split center = (0.2 c5 + hi) + lo the same
    way, so they differ only where a summation-order difference flips a
    bf16 rounding (of c1..c4, or of hi itself). Measured here: hi + lo
    within 1.1e-4 of the state's scale (bound 1e-3, K1's mixed bound);
    98.3 % of hi values equal, the others one bf16 ulp apart with lo
    making up the difference, so each plane alone is within 3.3e-3 of the
    scale (bound 1e-2). The carry also sits in the mixed error class
    against the exact float32 chain, as JAX's own test requires of its
    kernel."""
    H, W = 10, 13
    p = _mk_params(NF, GC, wstd=0.03)
    x = np.random.default_rng(1).random((2, H, W, NF)).astype(np.float32)
    WB = K.round_wb(W)
    BLK, nblk = K.plan_rows(H, target_blk=4)
    Hp = BLK * nblk
    kp16 = K.pack_rdb_params(R.repack_scatter({"rdb": p})["rdb"], dtype=jnp.bfloat16)
    kw = dict(H=H, W=W, WB=WB, BLK=BLK, nblk=nblk, nf=NF, gc=GC, interpret=True)
    N = 12
    x32 = jnp.asarray(x)
    hi0 = x32.astype(jnp.bfloat16)
    lo0 = (x32 - hi0.astype(jnp.float32)).astype(jnp.bfloat16)
    hi = K.to_flat(hi0, WB, Hp)
    lo = K.to_flat(lo0, WB, Hp)[:, :, 5 * WB : (5 + Hp) * WB]
    for _ in range(N):
        hic, lo = K.rdb_apply_paired(hi, lo, kp16, **kw)
        hi = K.re_apron(hic, WB)
    j_hi = np.asarray(K.from_flat(hi[:, :, 5 * WB : (5 + Hp) * WB].astype(jnp.float32), H, W, WB))
    j_lo = np.asarray(K.from_flat(lo.astype(jnp.float32), H, W, WB))

    pp = _port_packed(p, torch.bfloat16)
    th, tl = TK._split(torch.from_numpy(x))
    np.testing.assert_array_equal(th.float().numpy(), np.asarray(hi0.astype(jnp.float32)))
    for _ in range(N):
        th, tl = TK.rdb_apply_paired(th, tl, pp)
    got = th.float().numpy() + tl.float().numpy()
    want = j_hi + j_lo
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() <= 1e-3 * scale
    # each plane: one bf16 ulp of the state where hi flipped
    assert np.abs(th.float().numpy() - j_hi).max() <= 1e-2 * scale
    assert np.abs(tl.float().numpy() - j_lo).max() <= 1e-2 * scale

    p32 = _port_packed(p, torch.float32)
    t = torch.from_numpy(x)
    m = torch.from_numpy(x)
    for _ in range(N):
        t = TK.rdb_apply(t, p32)
        m = TK.rdb_apply(m, pp)
    e_paired = np.abs(got - t.numpy()).mean()
    e_mixed = np.abs(m.numpy() - t.numpy()).mean()
    assert e_paired < 1.2 * e_mixed, (e_paired, e_mixed)


def test_paired_trunk_residual_order():
    """The paired trunk folds 0.2 (hi + lo) + (u_hi + u_lo) in float32, as
    the JAX trunk sums it, and re-splits: lo stays the rounding remainder."""
    p = _port_packed(_mk_params(NF, GC, seed=4, wstd=0.03), torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(2).random((1, 9, 7, NF)).astype(np.float32))
    hi, lo = TK._split(x)
    h1, l1 = TK.rdb_apply_paired(hi, lo, p)
    h2, l2 = TK.rdb_apply_paired(h1, l1, p, (hi, lo))
    u = hi.float() + lo.float()
    h_, l_ = TK.rdb_paired_reference(h1, l1, p)
    want = 0.2 * (h_.float() + l_.float()) + u
    assert torch.equal(h2, want.to(torch.bfloat16))
    assert torch.equal(l2, (want - h2.float()).to(torch.bfloat16))


# -- the slice: a tiny forward per mode --------------------------------------


@pytest.fixture(scope="module")
def jax_params():
    return R.init_rrdbnet_params(TINY_SPEC, seed=3)


def _jax_forward(params, x, *, op_dtype, chained=False, paired=False, sched="scatter"):
    """JAX's variant='pallas' forward with its Pallas kernels in interpret
    mode and the mode's module flags set, restored after."""
    names = ("rdb_apply", "rdb_apply_chained", "rdb_apply_paired", "rdb_apply_resident")
    orig = {n: getattr(K, n) for n in names}
    flags = (R.CHAINED_TRUNK, R.PAIRED_CARRY, R.RESIDENT_TRUNK, K.SCHED)
    pp = dict(params)
    pp["rdb"] = jax.tree.map(
        np.asarray,
        K.pack_rdb_params(R.repack_scatter(params)["rdb"], dtype=op_dtype, sched=sched),
    )
    try:
        for n in names:
            setattr(K, n, functools.partial(orig[n], interpret=True))
        R.CHAINED_TRUNK, R.PAIRED_CARRY, R.RESIDENT_TRUNK, K.SCHED = chained, paired, False, sched
        return np.asarray(R.rrdbnet_forward(
            pp, jnp.asarray(x), TINY_SPEC, storage_dtype=jnp.float32, variant="pallas",
            op_dtype=op_dtype,
        ))
    finally:
        for n in names:
            setattr(K, n, orig[n])
        R.CHAINED_TRUNK, R.PAIRED_CARRY, R.RESIDENT_TRUNK, K.SCHED = flags


def _port_forward(params, x, op_dtype, trunk="per_rdb", sched="scatter"):
    tp = params_from_jax(params)
    packed = TK.pack_rdb_params(tp["rdb"], op_dtype, sched)
    n_rdb = PORT_SPEC.num_rrdb * PORT_SPEC.num_rdb_per_rrdb
    tp = dict(tp, rdb={k: v.reshape(n_rdb, -1) for k, v in packed.items()})
    return TR.rrdbnet_forward(
        tp, torch.from_numpy(x), PORT_SPEC, torch.float32, "cuda", op_dtype,
        trunk=trunk, sched=sched,
    ).numpy()


def _psnr(a, ref):
    mse = float(np.mean((a.astype(np.float64) - ref) ** 2))
    return 10 * np.log10(float(np.abs(ref).max()) ** 2 / mse)


MODES = {"chained": dict(trunk="chained"), "packed": dict(sched="packed")}
X_TINY = np.random.default_rng(8).random((1, 12, 10, 3)).astype(np.float32)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_forward_f32_matches_jax(jax_params, mode):
    kw = MODES[mode]
    want = _jax_forward(
        jax_params, X_TINY, op_dtype=jnp.float32, chained=mode == "chained",
        sched=kw.get("sched", "scatter"),
    )
    got = _port_forward(jax_params, X_TINY, torch.float32, **kw)
    assert got.shape == want.shape == (1, 48, 40, 3)
    assert np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max())


@pytest.fixture(scope="module")
def f32_reference(jax_params):
    return np.asarray(R.rrdbnet_forward(
        jax_params, jnp.asarray(X_TINY), TINY_SPEC, storage_dtype=jnp.float32
    )).astype(np.float64)


@pytest.mark.parametrize("mode", ["chained", "packed", "paired"])
def test_forward_mixed_psnr_matches_jax(jax_params, f32_reference, mode):
    """Mixed mode per trunk form: the port's PSNR against float32 within
    0.5 dB of the JAX package's in the same mode."""
    kw = dict(MODES.get(mode, {"trunk": "paired"}))
    want = _jax_forward(
        jax_params, X_TINY, op_dtype=jnp.bfloat16, chained=mode == "chained",
        paired=mode == "paired", sched=kw.get("sched", "scatter"),
    )
    got = _port_forward(jax_params, X_TINY, torch.bfloat16, **kw)
    db, db_jax = _psnr(got, f32_reference), _psnr(want, f32_reference)
    assert abs(db - db_jax) <= 0.5, (db, db_jax)
    assert db < 200  # the bf16 operands do round


# -- the engine's surfaces ---------------------------------------------------


@pytest.mark.parametrize(
    "raw,want", [("packed", "packed"), ("scatter", "scatter"), ("", None), ("PACKED", None),
                 (" packed", None), ("packed\n", None), ("1", None)]
)
def test_sched_env_parsed_as_jax(raw, want, monkeypatch):
    """Only the exact strings count, as in the JAX engine (engine.py:298-304):
    they override the requested schedule on the kernel trunk."""
    monkeypatch.setenv("REALSR_TPU_SCHED", raw)
    spec = TR.RRDBNetSpec(num_rrdb=1)
    assert resolve_forms(spec, "gpu", "float32", "cuda", trunk="per_rdb").sched == (want or "scatter")
    assert resolve_forms(spec, "gpu", "float32", "cuda", trunk="per_rdb", sched="packed").sched == (want or "packed")
    assert (want is not None) == (raw in ("scatter", "packed"))


@pytest.fixture(scope="module")
def files(tiny_model_dir):
    return os.path.join(tiny_model_dir, "x4.param"), os.path.join(tiny_model_dir, "x4.bin")


def _engine(files, **cfg):
    e = RealSR(gpuid=-1, config=EngineConfig(tilesize=32, variant="cuda", **cfg))
    e.load(*files)
    return e


@pytest.mark.parametrize(
    "chained,paired,storage,want",
    [(False, False, "mixed", "per_rdb"), (True, False, "float32", "chained"),
     (False, True, "mixed", "paired"), (False, True, "float32", "per_rdb"),
     (True, True, "mixed", "chained")],
)
def test_trunk_auto_reads_module_flags(files, monkeypatch, chained, paired, storage, want):
    """chained beats paired; paired applies to mixed mode only (JAX
    rrdbnet.py:392-397)."""
    monkeypatch.setattr(TR, "CHAINED_TRUNK", chained)
    monkeypatch.setattr(TR, "PAIRED_CARRY", paired)
    monkeypatch.delenv("REALSR_TPU_SCHED", raising=False)
    e = _engine(files, storage=storage)
    assert (e.trunk, e.sched) == (want, "scatter")


def test_sched_env_overrides_config_on_kernel_trunk(files, monkeypatch):
    monkeypatch.setenv("REALSR_TPU_SCHED", "packed")
    e = _engine(files, storage="float32")
    assert (e.trunk, e.sched) == ("per_rdb", "packed")
    monkeypatch.setenv("REALSR_TPU_SCHED", "nonsense")
    assert _engine(files, storage="float32", sched="packed").sched == "packed"
    # plain convs: the variable has no effect there, as in the JAX engine
    monkeypatch.setenv("REALSR_TPU_SCHED", "packed")
    e = RealSR(gpuid=-1, config=EngineConfig(tilesize=32, storage="float32"))
    e.load(*files)
    assert (e.variant, e.sched) == ("dense", "scatter")


@pytest.mark.parametrize(
    "cfg,match",
    [
        (dict(trunk="chained", sched="packed"), "per-RDB trunk only"),
        (dict(trunk="paired", sched="packed"), "per-RDB trunk only"),
        (dict(trunk="paired", storage="float32"), "mixed mode only"),
        (dict(trunk="paired", storage="bfloat16"), "mixed mode only"),
        (dict(trunk="chained", variant="dense"), "variant 'cuda'"),
        (dict(sched="packed", variant="scatter"), "variant 'cuda'"),
        (dict(trunk="resident"), "unknown trunk"),
        (dict(sched="k-packed"), "unknown sched"),
    ],
)
def test_impossible_combinations_raise(files, monkeypatch, cfg, match):
    """What the JAX package cannot run raises; no other mode runs instead."""
    monkeypatch.delenv("REALSR_TPU_SCHED", raising=False)
    cfg = dict(dict(tilesize=32, variant="cuda", storage="mixed"), **cfg)
    e = RealSR(gpuid=-1, config=EngineConfig(**cfg))
    with pytest.raises(ValueError, match=match):
        e.load(*files)


@pytest.mark.parametrize("mode", ["chained", "packed", "paired"])
def test_float32_trunk_modes_pass_the_gate(files, monkeypatch, mode):
    """A float32 engine on the kernel trunk takes the chained layout and the
    packed schedule, whose kernels have float32 instances (their weights
    packed as tf32 slices, "wt", in the mode's schedule); the paired carry
    stays mixed-only (ValueError, as the JAX package's), and float16 on the
    kernel trunk still raises."""
    monkeypatch.delenv("REALSR_TPU_SCHED", raising=False)
    kw = {"packed": dict(sched="packed")}.get(mode, dict(trunk=mode))
    if mode == "paired":
        with pytest.raises(ValueError, match="mixed mode only"):
            _engine(files, storage="float32", **kw)
    else:
        e = _engine(files, storage="float32", **kw)
        assert (e.trunk, e.sched) == (kw.get("trunk", "per_rdb"), kw.get("sched", "scatter"))
        rdb = e._params["rdb"]
        assert rdb["wt"].dtype == torch.float32 and rdb["wt"].shape[-1] == 2 * rdb["w"].shape[-1]
    assert TK._OPERANDS["rdb_apply_paired"] == (torch.bfloat16,)
    assert all(torch.float32 in TK._OPERANDS[f] for f in ("rdb_apply", "rdb_apply_packed", "rdb_apply_chained"))
    with pytest.raises(NotImplementedError, match="float16"):
        _engine(files, storage="float16", **kw)


def test_env_packed_with_chained_trunk_raises(files, monkeypatch):
    monkeypatch.setenv("REALSR_TPU_SCHED", "packed")
    with pytest.raises(ValueError, match="per-RDB trunk only"):
        _engine(files, trunk="chained")


@pytest.mark.parametrize("mode", ["chained", "packed", "paired"])
def test_engine_mode_runs_on_cpu(files, monkeypatch, mode):
    """Each mode's engine on the CPU (the plain versions) against the
    per-RDB kernel engine: float32 modes give equal u8 pixels (chained
    bit-equal), the mixed paired carry within one u8 step on almost all."""
    monkeypatch.delenv("REALSR_TPU_SCHED", raising=False)
    storage = "mixed" if mode == "paired" else "float32"
    kw = {"packed": dict(sched="packed")}.get(mode, dict(trunk=mode))
    img = np.random.default_rng(5).integers(0, 256, (21, 18, 3), np.uint8)
    ref = _engine(files, storage=storage).process(img)
    launches = dict(TK.LAUNCHES)
    got = _engine(files, storage=storage, **kw).process(img)
    assert TK.LAUNCHES == launches
    d = np.abs(got.astype(int) - ref.astype(int))
    if mode == "chained":
        np.testing.assert_array_equal(got, ref)
    assert d.max() <= 1 and np.mean(d == 0) >= 0.99
