"""Real-SwinIR on the port's normal path, on the CPU, against the plain
float32 reference of the benchmark (``benchmark/reference/swinir.py``,
SwinIR's own layout and formulas; it imports nothing of the port).

A tiny model (embed 32, 2 heads, depths [2, 2], window 8) on seeded
weights (``models/swinir.py::init_state``) runs through ``RealSR.load`` /
``process``; on the CPU the kernels' wrappers take their plain versions.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch
from PIL import Image

from benchmark.reference import swinir as ref
from benchmark.reference import tiling
from benchmark.reference.precision import fp8
from realsr_tpu_torch import cli
from realsr_tpu_torch.engine import EngineConfig, RealSR
from realsr_tpu_torch.loader import load_model
from realsr_tpu_torch.models import swinir as S
from realsr_tpu_torch.models.rrdbnet import RRDBNetSpec
from realsr_tpu_torch.ops import swin_kernel as SK
from realsr_tpu_torch.ops.tta import d4_inverse, d4_transform

CPU = torch.device("cpu")
TINY = S.SwinIRSpec(depths=(2, 2), embed_dim=32, num_heads=(2, 2))
CFG = {"window_size": 8, "img_range": 1.0, "depths": [2, 2], "num_heads": [2, 2]}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(state dict, (json, pth)) of the tiny model."""
    sd = S.init_state(TINY, seed=3)
    return sd, S.save_model(str(tmp_path_factory.mktemp("swinir")), TINY, sd)


def _img(h, w, c=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), dtype=np.uint8)


def _reference(img, sd, tile=32, quant=None):
    return tiling.upscale(img, lambda x: ref.forward(x, sd, CFG, quant), 4, tile, 10, CPU)


def _gaps(got, want):
    d = got.astype(np.int64) - want.astype(np.int64)
    return float(np.sqrt((d * d).mean())), int(np.abs(d).max())


def _engine(files, **kw):
    e = RealSR(gpuid=-1, config=EngineConfig(**{"tilesize": 32, **kw}))
    e.load(*files)
    return e


def test_float32_forward_matches_reference(tiny):
    """The float32 forward on a tile whose sides are not whole windows
    (21 x 27: padded by reflection to 24 x 32, cropped after) agrees with
    the reference to float32 rounding through 4 layers and 3 convs (1e-4
    of outputs of about 0..1)."""
    sd, files = tiny
    bundle = load_model(*files, storage_dtype=torch.float32)
    x = torch.from_numpy(_img(21, 27, seed=1)).float()[None] / 255
    got = bundle.forward(bundle.params, x)
    want = ref.forward(x.permute(0, 3, 1, 2), sd, CFG).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (1, 84, 108, 3)
    assert (got - want).abs().max().item() < 1e-4


# the mixed mode against the float32 reference, in u8 steps: bf16 operands
# of every product move about a third of the values by one step (readings
# 0.31-0.35 rmse, at most 1 step); the same reference with its operands
# rounded to float8 reads rmse > 3 and steps of 15, so these limits fail it
MIXED_RMSE, MIXED_MAX = 0.8, 4


@pytest.mark.parametrize("storage,tail", [("float32", "interleaved"), ("float32", "kernel"), ("mixed", "interleaved"),
                                          ("mixed", "kernel")])
def test_engine_matches_reference(tiny, storage, tail):
    """The engine's u8 output (tile 32, halo 10, every tile a chunk of the
    bucket's batch) against the reference's, tiled alike: float32 within
    one step on a few values (u8 rounding of equal sums in another order),
    mixed within :data:`MIXED_RMSE` / :data:`MIXED_MAX`; the K6 tail's plain
    form ("kernel") and the interleaved convs both."""
    sd, files = tiny
    img = _img(37, 45)
    e = _engine(files, storage=storage, tail=tail)
    assert e.bundle.tail == tail
    rmse, widest = _gaps(e.process(img), _reference(img, sd))
    if storage == "float32":
        assert rmse < 0.05 and widest <= 1
    else:
        assert rmse <= MIXED_RMSE and widest <= MIXED_MAX


def test_mixed_limits_fail_the_float8_reference(tiny):
    """The mixed mode's limits are tight enough that computing one step
    lower, every product's operands in float8, fails them."""
    sd, _ = tiny
    img = _img(37, 45)
    rmse, widest = _gaps(_reference(img, sd, quant=fp8), _reference(img, sd))
    assert rmse > MIXED_RMSE or widest > MIXED_MAX


def test_kernel_path_on_the_cpu_runs_the_plain_forms(tiny, monkeypatch):
    """The card's mixed forms (K8, K9 and K10 through their wrappers, the
    K6 tail) on CPU tensors take the plain versions and give the plain
    forward's output, its MLP taken as K10's plain version (one rounding of
    the hidden, where ``F.linear``, ``F.gelu``, ``F.linear`` round twice);
    nothing is launched. The tiny widths have no kernel instance, so the
    loader refuses the kernel variant for them, and the forward runs the
    wrappers' dispatch on the plain variant's parameters with K8's packed
    bias and K10's packed weights added."""
    sd, files = tiny
    x = torch.from_numpy(_img(24, 40, seed=2)).float()[None] / 255
    launches = dict(SK.LAUNCHES)
    plain = load_model(*files, storage_dtype=torch.float32, op_dtype=torch.bfloat16, variant="dense", tail="kernel")
    with pytest.raises(ValueError, match="is built for"):
        load_model(*files, storage_dtype=torch.float32, op_dtype=torch.bfloat16, variant="cuda", tail="kernel")
    bl = plain.params["blocks"]
    w1, w2 = SK.pack_mlp(bl["fc1_w"], bl["fc2_w"], chunk=16)
    blocks = {**bl, "attn_packed": SK.pack_bias(bl["attn_bias"]), "mlp_w1": w1, "mlp_w2": w2}
    got = S.swinir_forward({**plain.params, "blocks": blocks}, x, TINY, torch.float32, torch.bfloat16, kernels=True,
                           tail="kernel")
    monkeypatch.setattr(S, "_mlp", lambda b, i, h: SK.swin_mlp_plain(h, b["fc1_w"][i], b["fc1_b"][i],
                                                                     b["fc2_w"][i], b["fc2_b"][i]))
    torch.testing.assert_close(got, plain.forward(plain.params, x), rtol=0, atol=0)
    assert SK.LAUNCHES == launches


@pytest.mark.parametrize("spec,storage,op,match", [
    (S.SwinIRSpec(), torch.float32, torch.float32, "mixed precision"),
    (S.SwinIRSpec(), torch.bfloat16, torch.bfloat16, "mixed precision"),
    (S.SwinIRSpec(), torch.float16, torch.float16, "mixed precision"),
    # Real-SwinIR-M: embed 180 in 6 heads of 30
    (S.SwinIRSpec(embed_dim=180, num_heads=(6,) * 6, depths=(6,) * 6), torch.float32, torch.bfloat16,
     "built for widths"),
    (S.SwinIRSpec(embed_dim=240, num_heads=(6,) * 9), torch.float32, torch.bfloat16, "heads"),
    # a hidden of 4C: K10 is built for 240 -> 480 -> 240
    (S.SwinIRSpec(mlp_ratio=4.0), torch.float32, torch.bfloat16, r"swin_mlp is built for \(width, hidden\) in "
                                                                 r"\(\(240, 480\),\); the model has 240, 960"),
])
def test_kernel_variant_refuses_what_its_kernels_lack(tmp_path, spec, storage, op, match):
    """The kernel variant (a card's) of a SwinIR model at a precision or
    width K8 / K9 / K10 have no instance for raises, naming what is missing,
    before it reads the weights; it never falls back to the plain forms."""
    import dataclasses
    import json

    path = tmp_path / "x4.json"
    path.write_text(json.dumps({"architecture": "swinir", **dataclasses.asdict(spec)}))
    with pytest.raises(ValueError, match=match):
        load_model(str(path), str(tmp_path / "absent.pth"), storage_dtype=storage, op_dtype=op, variant="cuda")


def _mlp_case(c, hidden, seed):
    """bf16 tokens and fc1 / fc2 weights whose pre-activations spread over
    GELU's curved range (about N(0, 1.6))."""
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(2000, c, generator=g).to(torch.bfloat16)
    w1 = (torch.randn(hidden, c, generator=g) * 1.6 / c ** 0.5).to(torch.bfloat16)
    b1 = (torch.randn(hidden, generator=g) * 0.5).to(torch.bfloat16)
    w2 = (torch.randn(c, hidden, generator=g) / hidden ** 0.5).to(torch.bfloat16)
    b2 = (torch.randn(c, generator=g) * 0.1).to(torch.bfloat16)
    return h, w1, b1, w2, b2


@pytest.mark.parametrize("c,hidden", [(240, 480), (32, 64)])
def test_swin_mlp_plain_rounds_the_hidden_once(c, hidden):
    """K10's plain version against F.linear(F.gelu(F.linear(.)), .) in
    float32 on the same bf16 operands: apart only by the hidden's one
    rounding to bf16 (each value within 2^-8 of itself) and the output's,
    so within 2^-8 (|m| + (1 + 2^-8) sum_k |hidden_k w2_k|) of it, plus
    float32's sums; closer on average than the route it replaces, which
    rounds fc1's output and GELU's."""
    import torch.nn.functional as F

    h, w1, b1, w2, b2 = _mlp_case(c, hidden, c)
    got = SK.swin_mlp_plain(h, w1, b1, w2, b2)
    hid = F.gelu(F.linear(h.float(), w1.float(), b1.float()))
    exact = F.linear(hid, w2.float(), b2.float())
    u = 2.0 ** -8
    bound = u * exact.abs() + (1 + u) * u * (hid.abs() @ w2.float().abs().T) + 1e-5
    assert got.dtype == torch.bfloat16 and got.shape == (2000, c)
    assert ((got.float() - exact).abs() <= bound).all()
    twice = F.linear(F.gelu(F.linear(h, w1, b1)), w2, b2)
    assert (got.float() - exact).abs().mean() < (twice.float() - exact).abs().mean()


@pytest.mark.parametrize("kernels", [True, False])
def test_mlp_form_follows_the_kernel_form(tiny, monkeypatch, kernels):
    """The kernel form's MLP is one sk.swin_mlp call a Swin layer and no
    F.gelu (a stand-in counts the calls and returns zeros); the plain form
    keeps F.linear, F.gelu, F.linear and never calls K10's wrapper."""
    import torch.nn.functional as F

    sd, files = tiny
    plain = load_model(*files, storage_dtype=torch.float32, op_dtype=torch.bfloat16, variant="dense")
    bl = plain.params["blocks"]
    w1, w2 = SK.pack_mlp(bl["fc1_w"], bl["fc2_w"], chunk=16)
    p = {**plain.params, "blocks": {**bl, "attn_packed": SK.pack_bias(bl["attn_bias"]), "mlp_w1": w1, "mlp_w2": w2}}
    calls = {"swin_mlp": 0, "gelu": 0}
    gelu = F.gelu

    def stand_in(h, *a):
        calls["swin_mlp"] += 1
        assert len(a) == 5 and a[4][0].shape == (64 * 32,)
        return torch.zeros_like(h)

    def counted_gelu(*a, **k):
        calls["gelu"] += 1
        return gelu(*a, **k)

    monkeypatch.setattr(SK, "swin_mlp", stand_in)
    monkeypatch.setattr(F, "gelu", counted_gelu)
    x = torch.from_numpy(_img(16, 24, seed=4)).float()[None] / 255
    S.swinir_forward(p, x, TINY, torch.float32, torch.bfloat16, kernels=kernels, tail="interleaved")
    layers = sum(TINY.depths)
    assert calls == ({"swin_mlp": layers, "gelu": 0} if kernels else {"swin_mlp": 0, "gelu": layers})


@pytest.mark.parametrize("c,hidden,chunk", [(240, 480, SK.MLP_CHUNK), (32, 64, 16)])
def test_pack_mlp_streams_each_chunks_slices(c, hidden, chunk):
    """K10's operands: per chunk of the hidden, fc1's k16 slices of W1[j]^T
    and fc2's of W2[:, j]^T, each in wgmma's K-major order (the tail's
    packing of a [K, N] matrix), for every layer of a stack; a chunk that
    does not divide the hidden, or is no whole number of k-steps, raises."""
    from realsr_tpu_torch.ops.tail_kernel import _wg_pack

    g = torch.Generator().manual_seed(chunk)
    w1, w2 = torch.randn(2, hidden, c, generator=g), torch.randn(2, c, hidden, generator=g)
    p1, p2 = SK.pack_mlp(w1, w2, chunk)
    assert p1.dtype == p2.dtype == torch.bfloat16 and p1.shape == p2.shape == (2, hidden * c)
    b1, b2 = w1.to(torch.bfloat16).float().numpy(), w2.to(torch.bfloat16).float().numpy()
    for layer in range(2):
        want1 = np.concatenate([_wg_pack(b1[layer, j:j + chunk].T) for j in range(0, hidden, chunk)])
        want2 = np.concatenate([_wg_pack(b2[layer, :, j:j + chunk].T) for j in range(0, hidden, chunk)])
        np.testing.assert_array_equal(p1[layer].float().numpy(), want1)
        np.testing.assert_array_equal(p2[layer].float().numpy(), want2)
    for bad in (chunk + 8, 3 * hidden):
        with pytest.raises(ValueError, match="pack_mlp"):
            SK.pack_mlp(w1, w2, bad)


def test_k10_gelu_holds_its_bounds():
    """K10's GELU as csrc/swin_kernel.cu writes it (gelu_erf: its
    coefficients read from the source, its float32 operations in turn, the
    card's ex2 as exp2 in float32) against x Phi(x) with the exact erf:
    within 6e-6 of |GELU(x)| for |x| <= 4.5 and 1e-6 beyond, on every
    float32 step of [-1, 1] in 2^-12 and a fine grid out to +-12: far
    inside the 2^-8 of the bf16 rounding that follows it."""
    import math
    import re

    with open(os.path.join(os.path.dirname(SK.__file__), "..", "csrc", "swin_kernel.cu")) as f:
        src = f.read()
    body = src[src.index("__device__ __forceinline__ float gelu_erf(float x) {"):]
    body = body[:body.index("\n}\n")]
    coef = [float(v) for v in re.findall(r"p = (?:fmaf\(p, v, )?(-?[0-9.e-]+)f", body)]
    lim = float(re.search(r"fminf\(u, ([0-9.]+)f\)", body).group(1))
    k = float(re.search(r"x \* \(x \* (-[0-9.]+)f\)", body).group(1))
    assert len(coef) == 11 and lim == 4.5
    f32 = np.float32
    x = np.concatenate([np.arange(-4096, 4097) / 4096, np.linspace(-12, 12, 480001)]).astype(f32)
    u = np.abs(x)
    v = (np.minimum(u, f32(lim)) * f32(2 / lim) - f32(1)).astype(f32)
    p = f32(coef[0])
    for c in coef[1:]:
        p = (p * v + f32(c)).astype(f32)
    e = np.exp2((x * (x * f32(k))).astype(f32)).astype(f32)
    got = (np.maximum(x, f32(0)) - (u * p).astype(f32) * e).astype(np.float64)
    xd = x.astype(np.float64)
    want = 0.5 * xd * (1 + np.array([math.erf(t / math.sqrt(2)) for t in xd]))
    err = np.abs(got - want)
    inner = np.abs(xd) <= lim
    assert (err[inner] <= 6e-6 * np.abs(want[inner]) + 1e-30).all(), err[inner].max()
    assert err[~inner].max() <= 1e-6


def test_shift_mask_and_bias_index_are_swinirs():
    """The port's region mask, relative-position index and bias gather are
    SwinIR's ``calculate_mask``, ``relative_position_index`` and
    ``table[index].view(N, N, -1).permute(2, 0, 1)``, on maps of whole
    windows that are not square."""
    for h, w in ((16, 16), (24, 40), (40, 8)):
        torch.testing.assert_close(SK.shift_mask(h, w, 8, 4), ref.calculate_mask(h, w, 8, 4, CPU))
    assert torch.equal(SK.relative_position_index(8), ref.relative_position_index(8).view(-1))
    table = torch.randn(225, 3)
    want = table[ref.relative_position_index(8).view(-1)].view(64, 64, -1).permute(2, 0, 1)
    assert torch.equal(SK.attention_bias(table, 8), want)


def test_packed_bias_is_each_lanes_accumulator_order():
    """K8's bias operand: value v of lane l of row tile m of head h is the
    bias at the mma.sync accumulator's place (n-tile v // 4, rows g and
    g + 8 for v % 4 < 2 and not, columns 2c and 2c + 1)."""
    bias = torch.randn(2, 8, 64, 64).to(torch.bfloat16).float()
    packed = SK.pack_bias(bias).view(2, 8, 4, 32, 32)
    for lane in (0, 5, 31):
        g, c = lane // 4, lane % 4
        for v in (0, 3, 13, 30):
            nt, e = divmod(v, 4)
            row = 16 * 2 + g + 8 * (e >= 2)
            col = nt * 8 + 2 * c + e % 2
            assert packed[1, 5, 2, lane, v].item() == bias[1, 5, row, col].item()


def test_window_attention_plain_matches_reference():
    """The plain K8 (q, k, v straight from the qkv product's map, roll and
    partition inside) against the reference's block path on the same qkv
    values: shifted and not, float32."""
    g = torch.Generator().manual_seed(4)
    b, h, w, c, heads = 2, 16, 24, 32, 2
    qkv = torch.randn(b, h, w, 3 * c, generator=g)
    table = torch.randn(225, heads, generator=g)
    bias = SK.attention_bias(table, 8)
    for shift in (0, 4):
        got = SK.window_attn_plain(qkv, bias, heads, 8, shift)
        t = torch.roll(qkv, (-shift, -shift), (1, 2)) if shift else qkv
        win = ref.window_partition(t, 8).view(-1, 64, 3 * c)
        q, k, v = win.reshape(-1, 64, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
        attn = q @ k.transpose(-2, -1) + bias[None]
        if shift:
            mask = ref.calculate_mask(h, w, 8, shift, CPU)
            attn = (attn.view(b, -1, heads, 64, 64) + mask[None, :, None]).view(-1, heads, 64, 64)
        o = (torch.softmax(attn, -1) @ v).transpose(1, 2).reshape(-1, 8, 8, c)
        want = ref.window_reverse(o, 8, h, w)
        want = torch.roll(want, (shift, shift), (1, 2)) if shift else want
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("wrapped", [True, False])
def test_pth_loader_reads_the_published_layout(tiny, tmp_path, wrapped):
    """The ``.pth`` in SwinIR's key layout with its ``attn_mask`` (shifted
    blocks, at img_size) and ``relative_position_index`` buffers, under
    ``params_ema`` or bare: the buffers are not read (a wrong mask changes
    nothing) and the forward is the saved model's."""
    sd, files = tiny
    full = dict(sd)
    for i, depth in enumerate(TINY.depths):
        for j in range(depth):
            blk = f"layers.{i}.residual_group.blocks.{j}"
            full[blk + ".attn.relative_position_index"] = ref.relative_position_index(8)
            if j % 2:
                full[blk + ".attn_mask"] = torch.full((64, 64, 64), 7.0)  # not SwinIR's: must not be read
    path = str(tmp_path / "x4.pth")
    torch.save({"params_ema": full, "params": {}} if wrapped else full, path)
    x = torch.from_numpy(_img(16, 24, seed=5)).float()[None] / 255
    want = load_model(*files, storage_dtype=torch.float32)
    got = load_model(files[0], path, storage_dtype=torch.float32)
    assert got.spec == want.spec == TINY and got.scale == 4 and got.graph is None
    torch.testing.assert_close(got.forward(got.params, x), want.forward(want.params, x), rtol=0, atol=0)


@pytest.mark.parametrize("bad,match", [
    ({"architecture": "rrdbnet"}, "not a SwinIR model"),
    ({"window": 8}, "unknown SwinIR settings"),
    ({"upsampler": "pixelshuffle"}, "nearest\\+conv"),
    ({"num_heads": [2, 4]}, "one count for every RSTB"),
])
def test_json_settings_the_forward_does_not_run_raise(tmp_path, bad, match):
    import json

    cfg = {"architecture": "swinir", "depths": [2, 2], "embed_dim": 32, "num_heads": [2, 2], **bad}
    path = tmp_path / "x4.json"
    path.write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match=match):
        S.read_spec(str(path))


def test_banded_and_tta_through_the_swinir_bundle(tiny):
    """process_banded is bit-equal to process (band by band, each tile's
    window the whole run's); TTA averages the 8 dihedral variants of each
    tile: a one-tile image against the reference's own average."""
    sd, files = tiny
    img = _img(70, 50, c=4, seed=6)
    e = _engine(files)
    np.testing.assert_array_equal(e.process_banded(img, band_tile_rows=1), e.process(img))
    small = _img(20, 20, seed=7)
    tta = RealSR(gpuid=-1, tta_mode=True, config=EngineConfig(tilesize=32, storage="float32"))
    tta.load(*files)
    pad = tiling.reflect101(20, 10, 10)
    x = torch.from_numpy(small[pad][:, pad]).float()[None] / 255
    acc = sum(d4_inverse(ref.forward(d4_transform(x, k).permute(0, 3, 1, 2), sd, CFG).permute(0, 2, 3, 1), k)
              for k in range(8)) / 8
    want = torch.floor(acc[0, 40:120, 40:120] * 255 + 0.5).clamp(0, 255).to(torch.uint8).numpy()
    rmse, widest = _gaps(tta.process(small), want)
    assert rmse < 0.05 and widest <= 1


def test_chunk_granule_and_counters_follow_the_model(tiny, monkeypatch):
    """The chunk granule is the model's tile bytes at the tile with the
    engine's halo (Real-SwinIR-L: 4 tiles of 256 + 2 x 10 in mixed mode,
    so a 1024 x 768 photo's 12 tiles run as 3 chunks of 4); with tracing on
    each chunk counts its Swin tokens (padding to whole windows included)
    and its tiles' own pixels."""
    from realsr_tpu_torch import engine as engine_mod
    from realsr_tpu_torch.utils import trace

    big = S.SwinIRSpec()
    assert S.tile_bytes(big, 276, 276) == 280 * 280 * (3 * 4 * 240 + 2 * 240 + 2 * 5 * 240)
    assert engine_mod._batch_for(S.tile_bytes(big, 276, 276), False, 2048 << 20) == 4
    _, files = tiny
    e = _engine(files, tilesize=64, storage="mixed")
    assert e._auto_batch(64) == engine_mod._batch_for(S.tile_bytes(TINY, 84, 84), False, 2048 << 20) == 8
    t = trace.StageTimer(enabled=True)
    monkeypatch.setattr(engine_mod, "tracer", t)
    e.process(_img(64, 64))
    assert t._count["swin.tokens.run"] == 88 * 88 and t._count["swin.tokens.own"] == 64 * 64


def test_cli_runs_a_swinir_model_dir(tiny, tmp_path):
    """``-m`` a directory with ``x4.json`` and ``x4.pth`` (any name): the
    CLI resolves it, takes the halo of 10 and writes the 4x image, equal to
    the library's output."""
    _, files = tiny
    src, out = tmp_path / "in.png", tmp_path / "out.png"
    img = _img(30, 41, seed=8)
    Image.fromarray(img).save(src)
    mdir = os.path.dirname(files[0])
    assert cli.main(["-i", str(src), "-o", str(out), "-m", mdir, "-g", "-1", "-t", "32"]) == 0
    np.testing.assert_array_equal(np.asarray(Image.open(out)), _engine(files, storage="float32").process(img))


@pytest.mark.parametrize("storage,want", [
    ("mixed", (("swin_kernel", "swin"), ("tail_kernel", "k6"))),
    ("float32", "mixed precision"),
    ("float16", "on its kernels only"),
])
def test_card_kernel_groups_of_a_swinir_engine(storage, want, monkeypatch):
    """What a card engine of Real-SwinIR-L builds, resolved without a card:
    K8/K9's group and K6 in mixed mode. A card runs SwinIR on its kernels
    alone: float32 storage (the kernel variant, which has no float32
    instance) and float16 (the plain variant) raise."""
    import tempfile

    from realsr_tpu_torch import engine as engine_mod

    monkeypatch.delenv("REALSR_TPU_PACKED_TAIL", raising=False)
    monkeypatch.delenv("REALSR_TPU_FAST_START", raising=False)
    big = S.SwinIRSpec()
    files = S.save_model(tempfile.mkdtemp(), big, {k: torch.zeros(s) for k, s in S.state_keys(big)})
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            engine_mod.card_kernel_groups(EngineConfig(storage=storage), *files)
    else:
        assert engine_mod.card_kernel_groups(EngineConfig(storage=storage), *files) == want


def test_chunk_plans_of_the_benchmark_cells():
    """The chunk plans of the RRDB cells stay what they were: a 1024 x 768
    photo at tile 256 runs 2 chunks of 6, a 1280 x 720 frame 3 of 5 (its
    ragged row a bucket of its own), a 2048 x 1024 photo on a mesh of four
    8 of 4 (mixed DF2K engines, the CPU standing in for the cards)."""
    from realsr_tpu_torch.ncnn.synth import make_model_dir
    from realsr_tpu_torch.parallel.mesh import make_mesh
    from realsr_tpu_torch.tiling.planner import plan_tiles
    import tempfile

    files = make_model_dir(tempfile.mkdtemp(), RRDBNetSpec(num_rrdb=1))

    def plan(mesh, w, h):
        e = RealSR(gpuid=-1, config=EngineConfig(tilesize=256, storage="mixed"), mesh=mesh)
        e.load(*files)
        p = plan_tiles(w, h, 256, 10)
        buckets = {s: [(0, p.tiles[t].x0, p.tiles[t].y0) for t in idx] for s, idx in p.buckets.items()}
        return sorted(len(chunk) for _, _, chunk, _ in e._chunk_list(buckets, 256))

    assert plan(None, 1024, 768) == [6, 6]
    assert plan(None, 1280, 720) == [5, 5, 5]
    assert plan(make_mesh([CPU] * 4), 2048, 1024) == [4] * 8
