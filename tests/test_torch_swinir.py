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


def test_kernel_path_on_the_cpu_runs_the_plain_forms(tiny):
    """The card's mixed forms (K8 and K9 through their wrappers, the K6
    tail) on CPU tensors take the plain versions and give the plain
    forward's output; nothing is launched. The tiny widths have no kernel
    instance, so the loader refuses the kernel variant for them, and the
    forward runs the wrappers' dispatch on the plain variant's parameters
    with K8's packed bias added."""
    sd, files = tiny
    x = torch.from_numpy(_img(24, 40, seed=2)).float()[None] / 255
    launches = dict(SK.LAUNCHES)
    plain = load_model(*files, storage_dtype=torch.float32, op_dtype=torch.bfloat16, variant="dense", tail="kernel")
    with pytest.raises(ValueError, match="is built for"):
        load_model(*files, storage_dtype=torch.float32, op_dtype=torch.bfloat16, variant="cuda", tail="kernel")
    blocks = {**plain.params["blocks"], "attn_packed": SK.pack_bias(plain.params["blocks"]["attn_bias"])}
    got = S.swinir_forward({**plain.params, "blocks": blocks}, x, TINY, torch.float32, torch.bfloat16, kernels=True,
                           tail="kernel")
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
])
def test_kernel_variant_refuses_what_its_kernels_lack(tmp_path, spec, storage, op, match):
    """The kernel variant (a card's) of a SwinIR model at a precision or
    width K8 / K9 have no instance for raises, naming what is missing,
    before it reads the weights; it never falls back to the plain forms."""
    import dataclasses
    import json

    path = tmp_path / "x4.json"
    path.write_text(json.dumps({"architecture": "swinir", **dataclasses.asdict(spec)}))
    with pytest.raises(ValueError, match=match):
        load_model(str(path), str(tmp_path / "absent.pth"), storage_dtype=storage, op_dtype=op, variant="cuda")


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
