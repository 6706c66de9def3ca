"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Imports no JAX, so it also runs where JAX is absent (the machine with the
card): ``python -m pytest --noconftest tests/test_torch_gpu.py -q``
(tests/conftest.py imports JAX). Without a CUDA device every test skips.
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch

from realsr_tpu_torch.models.rrdbnet import RRDBNetSpec, init_rrdbnet_params, tf32
from realsr_tpu_torch.ops import rdb_kernel as TK
from realsr_tpu_torch.ops import tail_kernel as TLK

torch.set_num_threads(2)


def _packed(nf, gc, op_dtype, seed=8, wstd=0.05, sched="scatter"):
    """One RDB's random OIHW weights, packed for the kernel."""
    rng = np.random.default_rng(seed)
    p = {}
    for i in range(1, 6):
        cin, cout = nf + (i - 1) * gc, gc if i < 5 else nf
        p[f"w{i}"] = rng.normal(0, wstd, (cout, cin, 3, 3)).astype(np.float32)
        p[f"b{i}"] = rng.normal(0, 0.05, (cout,)).astype(np.float32)
    return TK.pack_rdb_params(p, op_dtype, sched)


def _state(cuda, shape, dtype, seed=7):
    return torch.from_numpy(np.random.default_rng(seed).random(shape).astype(np.float32)).to(cuda, dtype)


def _rel(got, want):
    return (got.float() - want.float()).abs().max().item() / max(1.0, want.float().abs().max().item())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with tf32(False):  # the plain versions' float32 convs compute in float32
        yield torch.device("cuda", 0)


# K1 on odd tile sizes (partial patches), a tile smaller than every patch
# side, and the main path's 148 x 148
K1_SHAPES = ((1, 12, 12), (2, 23, 17), (1, 5, 7), (1, 148, 148))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", K1_SHAPES)
@pytest.mark.parametrize(
    "state,op,nf,gc,tol",
    [
        (torch.float32, torch.float32, 32, 16, 1e-4),  # 3xTF32 wgmma
        (torch.float32, torch.float32, 64, 32, 1e-4),
        (torch.float32, torch.bfloat16, 32, 16, 1e-3),  # wgmma, mixed
        (torch.float32, torch.bfloat16, 64, 32, 1e-3),
        (torch.bfloat16, torch.bfloat16, 32, 16, 1e-2),  # bf16 state: 1 ulp
        (torch.bfloat16, torch.bfloat16, 64, 32, 1e-2),
    ],
)
def test_kernel_matches_plain(cuda, shape, state, op, nf, gc, tol):
    """With and without the RRDB residual: within the tolerance of the
    plain version, two runs bit-equal, one launch counted per call."""
    x = _state(cuda, (*shape, nf), state)
    p = {k: v.to(cuda) for k, v in _packed(nf, gc, op).items()}
    for u in (None, x * 0.5):
        launches = TK.LAUNCHES["rdb_apply"]
        got = TK.rdb_apply(x, p, u)
        torch.cuda.synchronize()
        assert TK.LAUNCHES["rdb_apply"] == launches + 1
        assert got.shape == x.shape and got.dtype == x.dtype
        assert _rel(got, TK.rdb_reference(x, p, state, op, u)) <= tol
        assert torch.equal(got, TK.rdb_apply(x, p, u))


@pytest.mark.gpu
@pytest.mark.parametrize("nf,gc", [(32, 16), (64, 32)])
def test_wgmma_shadow_is_the_bf16_output(cuda, nf, gc):
    """The operand plane K1 writes beside a float32 output is bf16 of it."""
    x = _state(cuda, (2, 23, 17, nf), torch.float32)
    p = {k: v.to(cuda) for k, v in _packed(nf, gc, torch.bfloat16).items()}
    out, sh = TK._rdb_wgmma(x, x.to(torch.bfloat16), p, x * 0.5, shadow=True)
    torch.cuda.synchronize()
    assert torch.equal(sh, out.to(torch.bfloat16))
    assert torch.equal(out, TK.rdb_apply(x, p, x * 0.5))


@pytest.mark.gpu
@pytest.mark.parametrize("state,nf,gc,tol", [(torch.float32, 64, 32, 1e-3), (torch.float32, 32, 16, 1e-3),
                                             (torch.bfloat16, 32, 16, 1e-2)])
def test_kernel_trunk_matches_plain_trunk(cuda, state, nf, gc, tol):
    """Six RDBs with distinct weights (two RRDBs) on K1, the operand plane
    threaded from launch to launch, against the plain trunk; bit-equal over
    two runs, six launches."""
    x = _state(cuda, (2, 23, 17, nf), state)
    packs = [_packed(nf, gc, torch.bfloat16, seed=20 + k) for k in range(6)]
    stacked = {k: torch.stack([d[k] for d in packs]).to(cuda) for k in packs[0]}
    launches = TK.LAUNCHES["rdb_apply"]
    got = TK.rdb_trunk(x, stacked)
    torch.cuda.synchronize()
    assert TK.LAUNCHES["rdb_apply"] == launches + 6
    t = u = x
    for k in range(6):
        if k % 3 == 0:
            u = t
        pk = {"w": stacked["w"][k], "b": stacked["b"][k]}
        t = TK.rdb_reference(t, pk, state, torch.bfloat16, u if k % 3 == 2 else None)
    assert _rel(got, t) <= tol
    assert torch.equal(got, TK.rdb_trunk(x, stacked))


@pytest.mark.gpu
def test_kernel_rejects_shapes_it_has_no_instance_for(cuda):
    x = torch.zeros((1, 8, 8, 16), device=cuda)
    p = {k: v.to(cuda) for k, v in _packed(16, 16, torch.bfloat16).items()}
    with pytest.raises(ValueError, match="no tensor-core kernel"):
        TK.rdb_apply(x, p)


@pytest.mark.gpu
def test_tf32_kernel_rejects_shapes_it_has_no_instance_for(cuda):
    """No float32 RDB kernel remains outside the tensor cores: nf, gc = 16,
    8 raises where the CUDA-core kernel once took it."""
    x = torch.zeros((1, 8, 8, 16), device=cuda)
    p = {k: v.to(cuda) for k, v in _packed(16, 8, torch.float32).items()}
    with pytest.raises(ValueError, match="no tensor-core kernel"):
        TK.rdb_apply(x, p)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", TK.TF32_TILES)
@pytest.mark.parametrize("nf,gc", [(32, 16), (64, 32)])
def test_tf32_kernel_at_each_patch_side(cuda, tile, nf, gc):
    """K1's float32 instances (3xTF32 wgmma) at each patch side they are
    built for, on a ragged 2 x 37 x 21 with the residual: within 1e-4 of
    the plain version (TF32 off), bit-equal over two runs."""
    x = _state(cuda, (2, 37, 21, nf), torch.float32)
    p = {k: v.to(cuda) for k, v in _packed(nf, gc, torch.float32).items()}
    got = TK._rdb_tf32(x, p, x * 0.5, tile)
    torch.cuda.synchronize()
    assert _rel(got, TK.rdb_reference(x, p, torch.float32, torch.float32, x * 0.5)) <= 1e-4
    assert torch.equal(got, TK._rdb_tf32(x, p, x * 0.5, tile))


@pytest.mark.gpu
@pytest.mark.parametrize("nf,gc", [(32, 16), (64, 32)])
def test_tf32_trunk_matches_plain_trunk(cuda, nf, gc):
    """Six float32 RDBs with distinct weights (two RRDBs) on K1's float32
    instances against the plain trunk with TF32 off: within 1e-4, six
    launches, bit-equal over two runs."""
    x = _state(cuda, (2, 23, 17, nf), torch.float32)
    packs = [_packed(nf, gc, torch.float32, seed=40 + k) for k in range(6)]
    stacked = {k: torch.stack([d[k] for d in packs]).to(cuda) for k in packs[0]}
    launches = TK.LAUNCHES["rdb_apply"]
    got = TK.rdb_trunk(x, stacked)
    torch.cuda.synchronize()
    assert TK.LAUNCHES["rdb_apply"] == launches + 6
    t = u = x
    for k in range(6):
        if k % 3 == 0:
            u = t
        pk = {"w": stacked["w"][k], "b": stacked["b"][k]}
        t = TK.rdb_reference(t, pk, torch.float32, torch.float32, u if k % 3 == 2 else None)
    assert _rel(got, t) <= 1e-4
    assert torch.equal(got, TK.rdb_trunk(x, stacked))


@pytest.mark.gpu
def test_float32_engine_runs_the_tf32_kernel(cuda, tmp_path):
    """A float32 engine on variant "auto" runs its trunk on K1's float32
    instances (three RDB launches per chunk of a one-RRDB graph) and keeps
    >= 99.9 % of u8 values equal to the float32 plain engine's, max diff 1."""
    from realsr_tpu_torch.engine import EngineConfig, RealSR
    from realsr_tpu_torch.ncnn.synth import make_model_dir

    files = make_model_dir(str(tmp_path / "m"), RRDBNetSpec(num_rrdb=1, nf=32, gc=16))
    img = (np.random.default_rng(3).random((30, 41, 3)) * 255).astype(np.uint8)
    kern = RealSR(gpuid=0, config=EngineConfig(tilesize=32, storage="float32"))
    kern.load(*files)
    assert kern.variant == "cuda"
    launches = TK.LAUNCHES["rdb_apply"]
    got = kern.process(img)
    assert TK.LAUNCHES["rdb_apply"] > launches and (TK.LAUNCHES["rdb_apply"] - launches) % 3 == 0
    plain = RealSR(gpuid=0, config=EngineConfig(tilesize=32, storage="float32", variant="dense"))
    plain.load(*files)
    d = np.abs(got.astype(int) - plain.process(img).astype(int))
    assert (d == 0).mean() >= 0.999 and d.max() <= 1


def _tail_operands(cuda, op_dtype):
    p = init_rrdbnet_params(RRDBNetSpec(num_rrdb=1, nf=64, gc=32), seed=4)
    return {k: v.to(cuda) for k, v in TLK.pack_tail_params(p, op_dtype).items()}


@pytest.mark.gpu
@pytest.mark.parametrize("with_up2", [True, False])
@pytest.mark.parametrize("B,H,W", [(1, 5, 7), (2, 37, 21), (1, 1, 1), (9, 37, 37)])
def test_tail_kernel_matches_plain(cuda, with_up2, B, H, W):
    """K6 (with_up2) and K7 on odd, non-square tiles (ragged patches), a
    single base pixel, and a batch of more patches than the card has SMs
    (persistent blocks take several, 12 x 28 patches): the kernel's error
    against the float32 plain tail is at most max(2 x the plain bf16
    version's, 1e-3), the JAX suite's rule for its tail kernel; two runs are
    bit-equal; one launch is counted per call."""
    fn, ref = (
        (TLK.up2_hr_last_packed, TLK.up2_hr_last_reference)
        if with_up2
        else (TLK.hr_last_packed, TLK.hr_last_reference)
    )
    shape = (B, H + 1, W + 1, 256) if with_up2 else (B, H, W, 1024)
    x = torch.from_numpy(
        np.abs(np.random.default_rng(5).normal(0, 0.5, shape)).astype(np.float32)
    ).to(cuda, torch.bfloat16)
    tp = _tail_operands(cuda, torch.bfloat16)
    launches = TLK.LAUNCHES[fn.__name__]
    got = fn(x, tp)
    torch.cuda.synchronize()
    assert TLK.LAUNCHES[fn.__name__] == launches + 1
    assert got.shape == (B, 4 * H, 4 * W, 3) and got.dtype == torch.float32
    exact = ref(x.float(), _tail_operands(cuda, torch.float32))
    e_plain = (ref(x, tp) - exact).abs().max().item()
    e_kernel = (got - exact).abs().max().item()
    assert e_kernel <= max(2 * e_plain, 1e-3), (e_kernel, e_plain)
    assert torch.equal(got, fn(x, tp))


@pytest.mark.gpu
def test_tail_kernel_has_no_float16_instance(cuda):
    tp = _tail_operands(cuda, torch.float32)
    x = torch.zeros((1, 6, 6, 256), device=cuda, dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="not torch.float16"):
        TLK.up2_hr_last_packed(x, tp)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", TLK.TAIL_TF32_TILES)
@pytest.mark.parametrize("with_up2", [True, False])
@pytest.mark.parametrize("B,H,W", [(1, 5, 7), (2, 37, 21), (9, 37, 37)])
def test_tf32_tail_kernel_matches_plain(cuda, tile, with_up2, B, H, W):
    """K6 and K7's float32 instances (3xTF32 wgmma) at each patch shape they
    are built for, on ragged tiles and on more patches than SMs: within
    1e-4 of the float32 plain version's scale (TF32 off), as float32 K1;
    two runs bit-equal; one launch counted per call."""
    name = "up2_hr_last_packed" if with_up2 else "hr_last_packed"
    ref = TLK.up2_hr_last_reference if with_up2 else TLK.hr_last_reference
    shape = (B, H + 1, W + 1, 256) if with_up2 else (B, H, W, 1024)
    x = torch.from_numpy(np.abs(np.random.default_rng(6).normal(0, 0.5, shape)).astype(np.float32)).to(cuda)
    tp = _tail_operands(cuda, torch.float32)
    launches = TLK.LAUNCHES[name]
    got = TLK._launch(name, x, tp, with_up2, tile)
    torch.cuda.synchronize()
    assert TLK.LAUNCHES[name] == launches + 1
    assert got.shape == (B, 4 * H, 4 * W, 3) and got.dtype == torch.float32
    assert _rel(got, ref(x, tp)) <= 1e-4
    assert torch.equal(got, TLK._launch(name, x, tp, with_up2, tile))


# the trunk modes' kernels (K5 packed, K3 chained, K4 paired): a small and a
# ragged shape, bf16 operands; mixed tolerance as K1's (bf16 flips of c1..c4)
SHAPES = ((1, 12, 12), (2, 23, 17))


@pytest.mark.gpu
@pytest.mark.parametrize("tile", TK.PACKED_TILES)
@pytest.mark.parametrize("state,nf,gc,tol", [(torch.float32, 64, 32, 1e-3), (torch.bfloat16, 32, 16, 1e-2)])
def test_packed_kernel_at_each_patch_side(cuda, tile, state, nf, gc, tol):
    """K5 at each patch side it is built for, with the residual and the
    bf16 shadow: within the tolerance of the plain version, the shadow
    bf16 of the output."""
    x = _state(cuda, (2, 37, 21, nf), state)
    p = {k: v.to(cuda) for k, v in _packed(nf, gc, torch.bfloat16, sched="packed").items()}
    out, sh = TK._rdb_wgmma(x, x.to(torch.bfloat16), p, x * 0.5, True, tile, packed=True)
    torch.cuda.synchronize()
    assert _rel(out, TK.rdb_packed_reference(x, p, state, torch.bfloat16, x * 0.5)) <= tol
    assert torch.equal(sh, out.to(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("tile", TK.WGMMA_TILES)
def test_paired_kernel_at_each_patch_side(cuda, tile):
    x = _state(cuda, (2, 37, 21, 64), torch.float32)
    hi, lo = TK._split(x)
    u = TK._split(x * 0.5)
    p = {k: v.to(cuda) for k, v in _packed(64, 32, torch.bfloat16).items()}
    h2, l2 = TK.rdb_apply_paired(hi, lo, p, u, tile=tile)
    wh, wl = TK.rdb_paired_reference(hi, lo, p, u)
    assert _rel(h2.float() + l2.float(), wh.float() + wl.float()) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("state,tol", [(torch.float32, 1e-3), (torch.bfloat16, 1e-2)])
def test_packed_trunk_matches_plain_trunk(cuda, state, tol):
    """Six RDBs on K5 with the operand plane threaded from launch to launch
    (K5 writes the bf16 shadow as K1 does) against the plain packed trunk;
    six launches, bit-equal over two runs."""
    x = _state(cuda, (2, 23, 17, 32), state)
    packs = [_packed(32, 16, torch.bfloat16, seed=30 + k, sched="packed") for k in range(6)]
    stacked = {k: torch.stack([d[k] for d in packs]).to(cuda) for k in packs[0]}
    launches = TK.LAUNCHES["rdb_apply_packed"]
    got = TK.rdb_trunk(x, stacked, "packed")
    torch.cuda.synchronize()
    assert TK.LAUNCHES["rdb_apply_packed"] == launches + 6
    t = u = x
    for k in range(6):
        if k % 3 == 0:
            u = t
        pk = {"w": stacked["w"][k], "b": stacked["b"][k]}
        t = TK.rdb_packed_reference(t, pk, state, torch.bfloat16, u if k % 3 == 2 else None)
    assert _rel(got, t) <= tol
    assert torch.equal(got, TK.rdb_trunk(x, stacked, "packed"))


@pytest.mark.gpu
def test_float16_engine_runs_plain_convs(cuda, tmp_path):
    """float16 on variant "auto" loads and runs on plain convs; an explicit
    "cuda" raises: the kernels have no float16 instance."""
    from realsr_tpu_torch.engine import EngineConfig, RealSR
    from realsr_tpu_torch.ncnn.synth import make_model_dir

    files = make_model_dir(str(tmp_path / "m"), RRDBNetSpec(num_rrdb=1, nf=32, gc=16))
    e = RealSR(gpuid=0, config=EngineConfig(tilesize=32, storage="float16"))
    e.load(*files)
    assert e.variant == "dense"
    assert e.process(np.zeros((9, 11, 3), np.uint8)).shape == (36, 44, 3)
    with pytest.raises(NotImplementedError, match="no float16 instance"):
        RealSR(gpuid=0, config=EngineConfig(tilesize=32, storage="float16", variant="cuda")).load(*files)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize(
    "state,nf,gc,tol",
    [(torch.float32, 32, 16, 1e-3), (torch.float32, 64, 32, 1e-3), (torch.bfloat16, 32, 16, 1e-2)],
)
def test_packed_kernel_matches_plain(cuda, shape, state, nf, gc, tol):
    x = _state(cuda, (*shape, nf), state)
    p = {k: v.to(cuda) for k, v in _packed(nf, gc, torch.bfloat16, sched="packed").items()}
    for u in (None, x * 0.5):
        launches = TK.LAUNCHES["rdb_apply_packed"]
        got = TK.rdb_apply_packed(x, p, u)
        torch.cuda.synchronize()
        assert TK.LAUNCHES["rdb_apply_packed"] == launches + 1
        assert _rel(got, TK.rdb_packed_reference(x, p, state, torch.bfloat16, u)) <= tol
        assert torch.equal(got, TK.rdb_apply_packed(x, p, u))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("state,nf,gc", [(torch.float32, 32, 16), (torch.bfloat16, 64, 32)])
def test_chained_kernel_matches_scatter_kernel(cuda, shape, state, nf, gc):
    """K3 computes K1's arithmetic on the chained layout with K1's stages:
    its image is within K1's tolerance of K1's output, with and without the
    flagged residual, and of its plain version; its aprons stay zero."""
    B, H, W = shape
    x = _state(cuda, (B, H, W, nf), state)
    u = _state(cuda, (B, H, W, nf), state, seed=9)
    p = {k: v.to(cuda) for k, v in _packed(nf, gc, torch.bfloat16).items()}
    xc, uc = TK.to_chained(x), TK.to_chained(u)
    for flag in (0, 1):
        out = torch.zeros_like(xc)
        f = torch.tensor([flag], dtype=torch.int32, device=cuda)
        launches = TK.LAUNCHES["rdb_apply_chained"]
        TK.rdb_apply_chained(xc, p, uc, f, H, W, out)
        torch.cuda.synchronize()
        assert TK.LAUNCHES["rdb_apply_chained"] == launches + 1
        img = TK.from_chained(out, H, W)
        tol = 1e-3 if state == torch.float32 else 1e-2
        assert _rel(img, TK.rdb_apply(x, p, u if flag else None)) <= tol
        want = TK.rdb_chained_reference(xc, p, uc, f, H, W, torch.zeros_like(xc), state, torch.bfloat16)
        assert _rel(out, want) <= tol
        rest = out.clone()
        TK.from_chained(rest, H, W).zero_()
        assert not rest.any()  # nothing written outside the image


@pytest.mark.gpu
@pytest.mark.parametrize("tile", TK.WGMMA_TILES)
@pytest.mark.parametrize("state,nf,gc", [(torch.float32, 64, 32), (torch.bfloat16, 32, 16)])
def test_chained_kernel_at_each_patch_side(cuda, tile, state, nf, gc):
    """K3 on wgmma at each of K1's patch sides, none of which need match the
    layout's rounding to 16, on a ragged 2 x 37 x 21 with the residual folded
    into u = out (as the trunk's closing step does): within K1's tolerance
    of K1, the shadow (mixed mode) bf16 of the output, aprons of both zero."""
    B, H, W = 2, 37, 21
    x = _state(cuda, (B, H, W, nf), state)
    u = _state(cuda, (B, H, W, nf), state, seed=9)
    p = {k: v.to(cuda) for k, v in _packed(nf, gc, torch.bfloat16).items()}
    xc, out = TK.to_chained(x), TK.to_chained(u)
    mixed = state == torch.float32
    xs = xc.to(torch.bfloat16) if mixed else None
    sh = torch.zeros_like(xc, dtype=torch.bfloat16) if mixed else None
    f = torch.ones(1, dtype=torch.int32, device=cuda)
    TK.rdb_apply_chained(xc, p, out, f, H, W, out, xs, sh, tile)
    torch.cuda.synchronize()
    assert _rel(TK.from_chained(out, H, W), TK.rdb_apply(x, p, u)) <= (1e-3 if mixed else 1e-2)
    for t in (out,) + ((sh,) if mixed else ()):
        rest = t.clone()
        TK.from_chained(rest, H, W).zero_()
        assert not rest.any()
    if mixed:
        assert torch.equal(sh, out.to(torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("nf,gc", [(32, 16), (64, 32)])
def test_paired_kernel_matches_plain(cuda, shape, nf, gc):
    """K4 on hi + lo planes, with and without the residual: hi + lo within
    the mixed tolerance of the plain version's."""
    x = _state(cuda, (*shape, nf), torch.float32)
    hi, lo = TK._split(x)
    uh, ul = TK._split(x * 0.5)
    p = {k: v.to(cuda) for k, v in _packed(nf, gc, torch.bfloat16).items()}
    for u in (None, (uh, ul)):
        launches = TK.LAUNCHES["rdb_apply_paired"]
        h2, l2 = TK.rdb_apply_paired(hi, lo, p, u)
        torch.cuda.synchronize()
        assert TK.LAUNCHES["rdb_apply_paired"] == launches + 1
        assert h2.dtype == l2.dtype == torch.bfloat16
        wh, wl = TK.rdb_paired_reference(hi, lo, p, u)
        assert _rel(h2.float() + l2.float(), wh.float() + wl.float()) <= 1e-3
        # lo stays a rounding remainder of hi
        assert (l2.float().abs() <= h2.float().abs() * 2.0**-8 + 1e-30).all()


@pytest.mark.gpu
def test_paired_kernel_has_no_float32_instance(cuda):
    """K4 is the paired carry of mixed mode: float32 operands raise."""
    x = torch.zeros((1, 8, 8, 32), device=cuda, dtype=torch.bfloat16)
    p32 = {k: v.to(cuda) for k, v in _packed(32, 16, torch.float32).items()}
    with pytest.raises(ValueError, match="mixed mode only"):
        TK.rdb_apply_paired(x, x, p32)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", TK.TF32_TILES)
@pytest.mark.parametrize("nf,gc", [(32, 16), (64, 32)])
def test_tf32_chained_kernel_matches_tf32_kernel(cuda, tile, nf, gc):
    """float32 K3 is float32 K1's stages on the chained layout: at each
    patch side, on a ragged 2 x 37 x 21, with and without the flagged
    residual (u = out, as the trunk's closing step), bit-equal to float32
    K1; aprons zero; one launch counted per call."""
    B, H, W = 2, 37, 21
    x = _state(cuda, (B, H, W, nf), torch.float32)
    u = _state(cuda, (B, H, W, nf), torch.float32, seed=9)
    p = {k: v.to(cuda) for k, v in _packed(nf, gc, torch.float32).items()}
    xc = TK.to_chained(x)
    for flag in (0, 1):
        out = TK.to_chained(u)
        f = torch.tensor([flag], dtype=torch.int32, device=cuda)
        launches = TK.LAUNCHES["rdb_apply_chained"]
        TK.rdb_apply_chained(xc, p, out, f, H, W, out, tile=tile)
        torch.cuda.synchronize()
        assert TK.LAUNCHES["rdb_apply_chained"] == launches + 1
        assert torch.equal(TK.from_chained(out, H, W), TK._rdb_tf32(x, p, u if flag else None, tile))
        rest = out.clone()
        TK.from_chained(rest, H, W).zero_()
        assert not rest.any()


@pytest.mark.gpu
@pytest.mark.parametrize("tile", TK.PACKED_TF32_TILES)
@pytest.mark.parametrize("nf,gc", [(32, 16), (64, 32)])
def test_tf32_packed_kernel_at_each_patch_side(cuda, tile, nf, gc):
    """float32 K5 (the packed rectangles on float32 planes, 3xTF32) at each
    patch side, on a ragged 2 x 37 x 21 with the residual: within 1e-4 of
    the plain packed version (TF32 off), bit-equal over two runs."""
    x = _state(cuda, (2, 37, 21, nf), torch.float32)
    p = {k: v.to(cuda) for k, v in _packed(nf, gc, torch.float32, sched="packed").items()}
    got = TK._rdb_tf32(x, p, x * 0.5, tile, packed=True)
    torch.cuda.synchronize()
    want = TK.rdb_packed_reference(x, p, torch.float32, torch.float32, x * 0.5)
    assert _rel(got, want) <= 1e-4
    assert torch.equal(got, TK._rdb_tf32(x, p, x * 0.5, tile, packed=True))


@pytest.mark.gpu
@pytest.mark.parametrize("nf,gc", [(32, 16), (64, 32)])
def test_tf32_chained_trunk_bit_equal_to_tf32_trunk(cuda, nf, gc):
    """Six float32 RDBs (two RRDBs) on float32 K3's rotating buffers are
    bit-equal to the float32 K1 trunk: the same stages, patches and
    residual folds on another layout."""
    x = _state(cuda, (2, 23, 17, nf), torch.float32)
    packs = [_packed(nf, gc, torch.float32, seed=50 + k) for k in range(6)]
    stacked = {k: torch.stack([d[k] for d in packs]).to(cuda) for k in packs[0]}
    assert torch.equal(TK.rdb_trunk_chained(x, stacked), TK.rdb_trunk(x, stacked))


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [dict(trunk="chained"), dict(sched="packed")])
def test_float32_engine_runs_trunk_mode_kernels(cuda, tmp_path, cfg):
    """A float32 engine with a trunk mode runs it on the mode's float32
    kernel (three launches per chunk of a one-RRDB graph, none of K1's) and
    keeps >= 99.9 % of u8 values equal to the float32 plain engine's, max
    diff 1."""
    from realsr_tpu_torch.engine import EngineConfig, RealSR
    from realsr_tpu_torch.ncnn.synth import make_model_dir

    files = make_model_dir(str(tmp_path / "m"), RRDBNetSpec(num_rrdb=1, nf=32, gc=16))
    img = (np.random.default_rng(3).random((30, 41, 3)) * 255).astype(np.uint8)
    e = RealSR(gpuid=0, config=EngineConfig(tilesize=32, storage="float32", **cfg))
    e.load(*files)
    key = "rdb_apply_chained" if "trunk" in cfg else "rdb_apply_packed"
    before = dict(TK.LAUNCHES)
    got = e.process(img)
    n = TK.LAUNCHES[key] - before[key]
    assert n > 0 and n % 3 == 0 and TK.LAUNCHES["rdb_apply"] == before["rdb_apply"]
    plain = RealSR(gpuid=0, config=EngineConfig(tilesize=32, storage="float32", variant="dense"))
    plain.load(*files)
    d = np.abs(got.astype(int) - plain.process(img).astype(int))
    assert (d == 0).mean() >= 0.999 and d.max() <= 1


@pytest.mark.gpu
def test_float32_engine_runs_the_tf32_tail(cuda, tmp_path):
    """A float32 engine on "auto" at nf = 64 ends on float32 K6, one launch
    per chunk, and keeps >= 99.9 % of u8 values equal to the float32 plain
    engine's (cuDNN convs for the trunk and the interleaved tail), max diff
    1."""
    from realsr_tpu_torch.engine import EngineConfig, RealSR
    from realsr_tpu_torch.ncnn.synth import make_model_dir

    files = make_model_dir(str(tmp_path / "m"), RRDBNetSpec(num_rrdb=1, nf=64, gc=32))
    img = (np.random.default_rng(4).random((30, 41, 3)) * 255).astype(np.uint8)
    e = RealSR(gpuid=0, config=EngineConfig(tilesize=32, storage="float32"))
    e.load(*files)
    assert (e.variant, e.tail) == ("cuda", "kernel")
    launches = TLK.LAUNCHES["up2_hr_last_packed"]
    got = e.process(img)
    assert TLK.LAUNCHES["up2_hr_last_packed"] > launches
    plain = RealSR(gpuid=0, config=EngineConfig(tilesize=32, storage="float32", variant="dense", tail="interleaved"))
    plain.load(*files)
    d = np.abs(got.astype(int) - plain.process(img).astype(int))
    assert (d == 0).mean() >= 0.999 and d.max() <= 1


@pytest.mark.gpu
@pytest.mark.parametrize("trunk", ["chained", "paired"])
def test_trunk_kernels_match_per_rdb_kernel(cuda, trunk):
    """Six RDBs (two RRDBs) on K3 / K4 against the K1 trunk, mixed mode,
    within K1's mixed tolerance: chained computes the same arithmetic with
    K1's stages on its layout, threading its bf16 operand planes; paired's
    hi + lo carries ~16 bits where K1 carries float32."""
    x = _state(cuda, (2, 23, 17, 32), torch.float32)
    stacked = {k: torch.stack([v] * 6).to(cuda) for k, v in _packed(32, 16, torch.bfloat16).items()}
    want = TK.rdb_trunk(x, stacked)
    fn = TK.rdb_trunk_chained if trunk == "chained" else TK.rdb_trunk_paired
    assert _rel(fn(x, stacked), want) <= 1e-3


class _Counted:
    replays = 0  # replays of _counted graphs in the process


def _counted(base):
    """The engine's graph class ``base`` with each graph's recorded
    launches ({wrapper: n}, the wrappers' counts during the recording, the
    second run of the chunk's work) and the replays counted."""

    class Counted(base):
        def capture(self, fn):
            runs = []

            def body():
                before = {**TK.LAUNCHES, **TLK.LAUNCHES}
                fn()
                if runs:
                    after = {**TK.LAUNCHES, **TLK.LAUNCHES}
                    self.launches = {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
                runs.append(1)

            super().capture(body)

        def replay(self):
            _Counted.replays += 1
            super().replay()

    return Counted


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["mixed", "float32"])
def test_banded_equals_whole_on_card(cuda, tmp_path, monkeypatch, storage):
    """An image streamed in bands, on K1 and K6 (at nf = 64), is
    bit-identical to the whole-image run: a ragged RGBA grid at 1 and 2 tile
    rows per band, and through process() at a forced zero budget against a
    whole run at that budget's chunk batch."""
    from realsr_tpu_torch import engine as engine_mod
    from realsr_tpu_torch.engine import EngineConfig, RealSR
    from realsr_tpu_torch.ncnn.synth import make_model_dir

    files = make_model_dir(str(tmp_path / "m"), RRDBNetSpec(num_rrdb=1, nf=64, gc=32))
    e = RealSR(gpuid=0, config=EngineConfig(tilesize=32, storage=storage))
    e.load(*files)
    assert (e.variant, e.tail) == ("cuda", "kernel")
    img = np.random.default_rng(5).integers(0, 256, (75, 50, 4), np.uint8)
    monkeypatch.setattr(engine_mod, "_CudaGraph", _counted(engine_mod._CudaGraph))
    e.precompile(50, 75, channels=4)
    # precompile captured the image's programs, each launching K1 and K6
    assert e.programs() and all(p.graph.launches.get("rdb_apply") and p.graph.launches.get("up2_hr_last_packed")
                                for p in e.programs().values())
    whole = e.process(img)
    for btr in (1, 2):
        # each band's chunks replay those programs
        replays = _Counted.replays
        banded = e.process_banded(img, band_tile_rows=btr)
        assert _Counted.replays > replays
        np.testing.assert_array_equal(banded, whole)
    # a zero budget also caps chunks at one tile (_auto_batch), and cuDNN
    # picks its algorithm by batch: hold it to a whole run at that batch
    one = RealSR(gpuid=0, config=EngineConfig(tilesize=32, storage=storage, max_batch=1))
    one.load(*files)
    whole = one.process(img)
    monkeypatch.setenv("REALSR_TPU_BAND_BUDGET_MB", "0")
    assert e.needs_banding(img.shape) and e._chunking(32, 8) == (1, 8)
    np.testing.assert_array_equal(e.process(img), whole)


@pytest.mark.gpu
def test_process_cpu_on_card_engine(cuda, tmp_path):
    """A card engine answers process_cpu from its CPU sibling (float32, plain
    convs): >= 99.9 % of u8 values equal to a float32 plain card engine's,
    max diff 1; the card engine's own output does not move."""
    from realsr_tpu_torch.engine import EngineConfig, RealSR
    from realsr_tpu_torch.ncnn.synth import make_model_dir

    files = make_model_dir(str(tmp_path / "m"), RRDBNetSpec(num_rrdb=1, nf=64, gc=32))
    e = RealSR(gpuid=0, config=EngineConfig(tilesize=32))
    e.load(*files)
    img = np.random.default_rng(6).integers(0, 256, (24, 31, 3), np.uint8)
    before = e.process(img)
    got = e.process_cpu(img)
    assert e._cpu_sibling.device.platform == "cpu" and e._cpu_sibling.variant == "dense"
    plain = RealSR(gpuid=0, config=EngineConfig(tilesize=32, storage="float32", variant="dense"))
    plain.load(*files)
    d = np.abs(got.astype(int) - plain.process(img).astype(int))
    assert (d == 0).mean() >= 0.999 and d.max() <= 1
    np.testing.assert_array_equal(e.process(img), before)


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["mixed", "float32"])
def test_mesh_of_two_shards_on_card(cuda, tmp_path, storage, monkeypatch):
    """A mesh of two shards of the one card deals whole chunks to them and
    is bit-equal to the single engine planning as the mesh plans (its pick
    and per-bucket batches over two shards), whole and banded."""
    from realsr_tpu_torch.engine import EngineConfig, RealSR
    from realsr_tpu_torch.ncnn.synth import make_model_dir
    from realsr_tpu_torch.parallel.mesh import make_mesh

    files = make_model_dir(str(tmp_path / "m"), RRDBNetSpec(num_rrdb=1, nf=64, gc=32))
    single = RealSR(gpuid=0, config=EngineConfig(storage=storage, max_batch=2))
    single.load(*files)
    mesh = RealSR(config=EngineConfig(storage=storage, max_batch=2), mesh=make_mesh([cuda, cuda]))
    mesh.load(*files)
    monkeypatch.setattr(single, "_chunking", mesh._chunking)
    monkeypatch.setattr(single, "_pick_tilesize", mesh._pick_tilesize)
    img = np.random.default_rng(9).integers(0, 256, (300, 420, 4), np.uint8)
    want = single.process(img)
    assert mesh.tilesize == 0 and mesh.last_tilesize == 0
    np.testing.assert_array_equal(mesh.process(img), want)
    assert mesh.last_tilesize == single.last_tilesize == single._pick_tilesize(420, 300)
    np.testing.assert_array_equal(mesh.process_banded(img, band_tile_rows=1), want)


@pytest.mark.gpu
def test_pick_on_card(cuda, tmp_path):
    """The card engine picks per image among 128 / 192 / 256 (kernel
    variant) and 128 / 192 (plain convs; on 1024 x 768 192's 20 + 4 tiles
    run as 3 chunks of 7 and one of 4, fewer padded pixels than 128's 48);
    banded output equals whole."""
    from realsr_tpu_torch.engine import EngineConfig, RealSR
    from realsr_tpu_torch.ncnn.synth import make_model_dir

    files = make_model_dir(str(tmp_path / "m"), RRDBNetSpec(num_rrdb=1, nf=64, gc=32))
    e = RealSR(gpuid=0, config=EngineConfig())
    e.load(*files)
    dense = RealSR(gpuid=0, config=EngineConfig(variant="dense"))
    dense.load(*files)
    assert e.tilesize == 0 and e._pick_tilesize(1024, 768) == 256 and dense._pick_tilesize(1024, 768) == 192
    img = np.random.default_rng(10).integers(0, 256, (290, 300, 3), np.uint8)
    whole = e.process(img)
    assert e.last_tilesize == e._pick_tilesize(300, 290)
    np.testing.assert_array_equal(e.process_banded(img, band_tile_rows=1), whole)


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["mixed", "float32"])
def test_graphs_on_card(cuda, tmp_path, storage):
    """Each chunk of a precompiled key replays its graph, and a key met
    twice is captured: bit-equal to the same engine run eagerly, RGB and
    RGBA; fetch comes down after the image's done event, equal to .cpu()."""
    from realsr_tpu_torch import engine as engine_mod
    from realsr_tpu_torch.engine import EngineConfig, RealSR
    from realsr_tpu_torch.ncnn.synth import make_model_dir

    files = make_model_dir(str(tmp_path / "m"), RRDBNetSpec(num_rrdb=1, nf=64, gc=32))
    e = RealSR(gpuid=0, config=EngineConfig(storage=storage, tilesize=64))
    e.load(*files)
    assert e.graphs
    assert e.precompile(150, 70, channels=4) == len(e.programs()) > 0
    for shape in ((70, 150, 4), (64, 64, 3), (64, 64, 3)):
        img = np.random.default_rng(sum(shape)).integers(0, 256, shape, np.uint8)
        got = e.process(img)
        graphs = e.config
        e.config = dataclasses.replace(e.config, cuda_graphs=False)
        assert not e.graphs
        want = e.process(img)
        e.config = graphs
        np.testing.assert_array_equal(got, want)
    assert (64 + 20, 64 + 20) in {key[1:3] for key in e.programs()}
    buf = e.process_device(img)
    assert engine_mod.done_event(buf) is not None
    np.testing.assert_array_equal(e.fetch(buf), buf.cpu().numpy())
    # the device's shared pool outlives an engine's graphs: a later engine
    # captures into it after the first engine and its graphs are gone
    del e, buf
    gc.collect()
    again = RealSR(gpuid=0, config=EngineConfig(storage=storage, tilesize=64))
    again.load(*files)
    assert again.precompile(64, 64) == len(again.programs()) == 1
    np.testing.assert_array_equal(again.process(img), want)


@pytest.fixture
def traced(monkeypatch):
    """A fresh tracer, on, in place of the process's in the engine."""
    from realsr_tpu_torch import engine as engine_mod
    from realsr_tpu_torch.utils import trace

    t = trace.StageTimer(enabled=True)
    monkeypatch.setattr(trace, "tracer", t)
    monkeypatch.setattr(engine_mod, "tracer", t)
    return t


def _traced_engine(tmp_path, mesh=None):
    from realsr_tpu_torch.engine import EngineConfig, RealSR
    from realsr_tpu_torch.ncnn.synth import make_model_dir

    files = make_model_dir(str(tmp_path / "m"), RRDBNetSpec(num_rrdb=1, nf=32, gc=16))
    e = RealSR(gpuid=0, config=EngineConfig(tilesize=32, variant="dense", max_batch=4), mesh=mesh)
    e.load(*files)
    return e


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 2])
def test_traced_chunk_device_times_on_card(cuda, tmp_path, traced, shards):
    """With tracing on, each chunk of an image gives one ``chunk.device``
    entry on its card once the image has come down (none before), a child
    of its dispatch span, of positive length; a mesh of two shards of the
    card adds one ``merge.device`` a request; the timing events return to
    the pool."""
    from realsr_tpu_torch.parallel.mesh import make_mesh

    e = _traced_engine(tmp_path, make_mesh([cuda, cuda]) if shards > 1 else None)
    img = np.random.default_rng(11).integers(0, 256, (70, 90, 3), np.uint8)
    buf = e.process_device(img)
    assert "chunk.device" not in traced._count
    got = e.fetch(buf)
    recs = traced.records()
    dispatch = {r.id: r for r in recs if r.name == "dispatch"}
    timed = [r for r in recs if r.name == "chunk.device"]
    assert dispatch and len(timed) == len(dispatch) == traced._count["chunk.device"]
    for r in timed:
        assert r.card == "cuda:0" and r.parent in dispatch and r.attrs["device_s"] > 0
        assert r.request == dispatch[r.parent].request
    assert traced._count.get("merge.device", 0) == (shards > 1) == traced._count.get("mesh.merge", 0)
    assert traced._pool["cuda:0"]
    np.testing.assert_array_equal(got, buf.cpu().numpy())


@pytest.mark.gpu
def test_traced_chunks_replay_after_warmup(cuda, tmp_path, traced):
    """An image met thrice: its keys' first chunks ran eagerly, the second
    were captured, and the third image's chunks are all replays."""
    e = _traced_engine(tmp_path)
    img = np.random.default_rng(12).integers(0, 256, (70, 90, 3), np.uint8)
    e.process(img)
    e.process(img)
    before = dict(traced._count)
    e.process(img)
    delta = {k: traced._count[k] - before.get(k, 0) for k in ("chunks.replayed", "chunks.captured", "chunks.eager")}
    n = traced._count["dispatch"] - before["dispatch"]
    assert n > 0 and delta == {"chunks.replayed": n, "chunks.captured": 0, "chunks.eager": 0}


# -- SwinIR: K8 window attention, K9 residual add + LayerNorm -----------------


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W", [(2, 40, 40), (1, 24, 56), (4, 280, 280)])
@pytest.mark.parametrize("shift", [0, 4])
def test_window_attn_kernel_matches_plain(cuda, B, H, W, shift):
    """K8 at width 240 in 8 heads (the main path's 4 x 280^2 among the
    shapes), shifted and not: within one bf16 step of the outputs' scale of
    the plain version on the same bf16 bias (exp and the order of the sums
    differ), and of the plain version on the float32 bias (K8 adds the bias
    in bf16, like its other operands: 3.7e-3 at 4 x 280^2 with N(0, 1)
    tables), two runs bit-equal, one launch counted per call."""
    from realsr_tpu_torch.ops import swin_kernel as SK

    g = torch.Generator().manual_seed(B * H + W + shift)
    qkv = (torch.randn(B, H, W, 720, generator=g) * 0.5).to(cuda, torch.bfloat16)
    bias = SK.attention_bias(torch.randn(225, 8, generator=g), 8).to(cuda)
    packed = SK.pack_bias(bias).to(cuda)
    launches = SK.LAUNCHES["window_attn"]
    got = SK.window_attn(qkv, bias, packed, 8, 8, shift)
    torch.cuda.synchronize()
    assert SK.LAUNCHES["window_attn"] == launches + 1
    want = SK.window_attn_plain(qkv, bias.to(torch.bfloat16).float(), 8, 8, shift)
    assert got.shape == want.shape == (B, H, W, 240) and got.dtype == torch.bfloat16
    assert _rel(got, want) <= 1e-2
    assert _rel(got, SK.window_attn_plain(qkv, bias, 8, 8, shift)) <= 1e-2
    assert torch.equal(got, SK.window_attn(qkv, bias, packed, 8, 8, shift))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["add_norm", "embed", "add", "norm"])
def test_swin_norm_kernel_matches_plain(cuda, mode):
    """K9 at width 240 over a token count that leaves a block part empty:
    the residual as the plain version's (the f32 sum; after the patch
    embed's norm within f32 rounding), the bf16 output within one step."""
    from realsr_tpu_torch.ops import swin_kernel as SK

    g = torch.Generator().manual_seed(len(mode))
    n, c = 1003, 240
    x = (torch.randn(n, c, generator=g) * 3 + 1).to(cuda)
    branch = torch.randn(n, c, generator=g).to(cuda, torch.bfloat16)
    w, b, pw, pb = ((1 + 0.1 * torch.randn(c, generator=g)).to(cuda) for _ in range(4))
    args = {"add_norm": (x, branch, w, b), "embed": (x, None, w, b), "add": (x, branch, None, None),
            "norm": (x, None, w, b)}[mode]
    kw = {"pre": (pw, pb)} if mode == "embed" else {"write_res": mode != "norm"}
    launches = SK.LAUNCHES["swin_norm"]
    res, out = SK.swin_norm(*args, **kw)
    torch.cuda.synchronize()
    assert SK.LAUNCHES["swin_norm"] == launches + 1
    want_res, want_out = SK.swin_norm_plain(*args, **kw)
    assert (res is None) == (want_res is None) == (mode == "norm")
    if res is not None:
        assert (res - want_res).abs().max().item() <= (1e-5 if mode == "embed" else 0)
    assert out.dtype == torch.bfloat16 and _rel(out, want_out) <= 2 ** -6


@pytest.mark.gpu
@pytest.mark.parametrize("storage", ["mixed", "float32"])
def test_swinir_graphs_on_card(cuda, tmp_path, storage):
    """A SwinIR engine at width 240 (one RSTB of two layers): its chunks
    replay graphs, bit-equal to the same engine run eagerly, RGB and RGBA;
    an eager chunk launches K8 once a layer and K9 2 x layers + 3 times,
    and the tail runs on K6. A card runs SwinIR on its kernels alone, which
    have mixed instances only: a float32 engine's load raises."""
    from realsr_tpu_torch.engine import EngineConfig, RealSR
    from realsr_tpu_torch.models import swinir as S
    from realsr_tpu_torch.ops import swin_kernel as SK

    spec = S.SwinIRSpec(depths=(2,), num_heads=(8,))
    files = S.save_model(str(tmp_path / "m"), spec, S.init_state(spec, 5))
    e = RealSR(gpuid=0, config=EngineConfig(storage=storage, tilesize=64))
    if storage != "mixed":
        with pytest.raises(ValueError, match="mixed precision"):
            e.load(*files)
        return
    e.load(*files)
    assert e.graphs and e.bundle.tail == "kernel"
    assert set(e.kernel_groups()) == {("swin_kernel", "swin"), ("tail_kernel", "k6")}
    for shape in ((70, 150, 4), (64, 64, 3), (64, 64, 3), (64, 64, 3)):
        img = np.random.default_rng(sum(shape)).integers(0, 256, shape, np.uint8)
        got = e.process(img)
        graphs = e.config
        e.config = dataclasses.replace(e.config, cuda_graphs=False)
        before = dict(SK.LAUNCHES)
        want = e.process(img)
        if shape[0] == 64:  # one tile, one chunk
            assert SK.LAUNCHES["window_attn"] - before["window_attn"] == 2
            assert SK.LAUNCHES["swin_norm"] - before["swin_norm"] == 7
        e.config = graphs
        np.testing.assert_array_equal(got, want)
    assert e.programs()
