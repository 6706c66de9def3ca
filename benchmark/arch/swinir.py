"""Real-SwinIR (SwinIR's real_sr task, ``upsampler='nearest+conv'``,
``resi_connection='3conv'``): what the harness needs of a configuration of
this architecture.

A configuration holds SwinIR's constructor settings by their published
names (``embed_dim``, ``depths``, ``num_heads``, ``window_size``,
``mlp_ratio``, ``img_range``, ``upscale``, ...). The weights are drawn from
the seed as SwinIR's ``_init_weights`` draws them, with the departures the
configuration lists under ``assumed`` (:func:`weights`); the model files
are the program's SwinIR format, a ``.json`` of the settings and a ``.pth``
of the state dict in SwinIR's key layout under ``params_ema``; the plain
forward is ``reference/swinir.py``.

``describe`` adds the work counts of the readers of the Swin kernels, per
token a Swin layer runs (:func:`tokens`: the tile with its halo, padded to
whole windows):
K8's operations and bytes (q, k and v read, the output written) and K9's
bytes over the forward (each residual, branch and output read or written
once).
"""

from __future__ import annotations

import json
import os
import sys

import torch

from benchmark.reference.precision import fp8
from benchmark.reference.swinir import forward
from benchmark.reference.tiling import tiles
from benchmark.weights import STREAM_WEIGHTS, generator

QUANT = fp8  # the configuration's bf16 operands, one step down
NUM_FEAT = 64  # SwinIR's num_feat of the nearest+conv upsampler
LINEAR_STD = 0.02  # _init_weights: trunc_normal_(std=.02), cut at +-2 (100 sigma: a normal draw)
BIAS_STD = 0.02  # departure: _init_weights sets Linear and LayerNorm biases to 0
LN_SCALE_STD = 0.1  # departure: LayerNorm scales 1 + N(0, 0.1) where _init_weights sets 1
# departure: conv_last's weights centred over its 3 x 3 taps (a flat map of
# features gives no output: their means would shift whole channels out of
# range) and scaled by this, so that the output spreads around SwinIR's mean
# over the u8 range (std ~20) with under 1 % clipped (PERF.md, the cell's
# readings: at most 0.008 %)
LAST_GAIN = 128.0
SETTINGS = ("upscale", "in_chans", "img_size", "window_size", "img_range", "depths", "embed_dim", "num_heads",
            "mlp_ratio", "upsampler", "resi_connection")


def _convs(cfg: dict) -> list:
    """(name, cin, cout, k) of every conv, in the state dict's order."""
    c, q = cfg["embed_dim"], cfg["embed_dim"] // 4
    three = lambda p: [(f"{p}.0", c, q, 3), (f"{p}.2", q, q, 1), (f"{p}.4", q, c, 3)]  # noqa: E731
    out = [("conv_first", cfg["in_chans"], c, 3)]
    for i in range(len(cfg["depths"])):
        out += three(f"layers.{i}.conv")
    out += three("conv_after_body") + [("conv_before_upsample.0", c, NUM_FEAT, 3)]
    out += [(n, NUM_FEAT, NUM_FEAT, 3) for n in ("conv_up1", "conv_up2", "conv_hr")]
    return out + [("conv_last", NUM_FEAT, cfg["in_chans"], 3)]


def macs_per_input_px(cfg: dict) -> int:
    """MACs per input pixel as the network is written: every Swin layer
    (qkv, q k^T and . v over its window, proj, fc1, fc2), the convs at their
    resolution (the tail's at 2x and 4x)."""
    c, n = cfg["embed_dim"], cfg["window_size"] ** 2
    hidden = int(c * cfg["mlp_ratio"])
    swin = sum(cfg["depths"]) * (3 * c * c + 2 * n * c + c * c + 2 * c * hidden)
    res = {"conv_up1": 4, "conv_up2": 16, "conv_hr": 16, "conv_last": 16}
    return swin + sum(k * k * ci * co * res.get(name, 1) for name, ci, co, k in _convs(cfg))


def tokens(cfg: dict, w: int, h: int) -> int:
    """Swin tokens of a w x h image, which every Swin layer runs: its tiles
    with the halo, each side padded to whole windows (the work counts of
    :func:`describe` are per such token)."""
    win, pad = cfg["window_size"], cfg["prepadding"]
    side = lambda n: -(-(n + 2 * pad) // win) * win  # noqa: E731
    return sum(side(tw) * side(th) for _, _, tw, th in tiles(w, h, cfg["tilesize"]))


def describe(cfg: dict, cfg_dir: str) -> dict:
    c, layers, rstbs = cfg["embed_dim"], sum(cfg["depths"]), len(cfg["depths"])
    n = cfg["window_size"] ** 2
    return {
        "scale": cfg["upscale"], "macs_per_input_px": macs_per_input_px(cfg),
        # K8 per token and layer: q k^T and . v over the window's n keys;
        # q, k, v read and the output written in bfloat16
        "window_attn_flops_per_token": layers * 2 * 2 * n * c,
        "window_attn_bytes_per_token": layers * (3 * c + c) * 2,
        # K9 per token over the forward, float32 residuals (4 bytes a
        # value) and bfloat16 branches and outputs (2): the patch embed's
        # (read, residual, output: 10C), two a layer (read, branch,
        # residual, output: 12C), one an RSTB's residual (12C, the last 8C
        # with no residual written) and the long skip's (8C); its
        # operations (about 10 a value) are not counted
        "swin_norm_bytes_per_token": c * (10 + 24 * layers + 12 * (rstbs - 1) + 8 + 8),
    }


def weights(cfg: dict, seed: int, device) -> dict:
    """SwinIR's state dict (float32 on ``device``) by its published keys,
    drawn from the seed: Linear weights and the bias tables N(0, 0.02),
    convs PyTorch's default (weights and biases U(+-1/sqrt(fan-in))), with
    the departures of :data:`BIAS_STD`, :data:`LN_SCALE_STD` and
    :data:`LAST_GAIN`."""
    g = generator(seed, STREAM_WEIGHTS, device)
    c, ws = cfg["embed_dim"], cfg["window_size"]
    hidden = int(c * cfg["mlp_ratio"])
    sd = {}

    def normal(shape, std, mean=0.0):
        return torch.randn(shape, generator=g, device=device) * std + mean

    def uniform(shape, bound):
        return (torch.rand(shape, generator=g, device=device) * 2 - 1) * bound

    def norm(name):
        sd[name + ".weight"] = normal((c,), LN_SCALE_STD, 1.0)
        sd[name + ".bias"] = normal((c,), BIAS_STD)

    def linear(name, cin, cout):
        sd[name + ".weight"] = normal((cout, cin), LINEAR_STD)
        sd[name + ".bias"] = normal((cout,), BIAS_STD)

    convs = {name: (ci, co, k) for name, ci, co, k in _convs(cfg)}

    def conv(name):
        ci, co, k = convs[name]
        bound = (ci * k * k) ** -0.5
        sd[name + ".weight"] = uniform((co, ci, k, k), bound)
        sd[name + ".bias"] = uniform((co,), bound)

    conv("conv_first")
    norm("patch_embed.norm")
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        for j in range(depth):
            b = f"layers.{i}.residual_group.blocks.{j}"
            norm(b + ".norm1")
            sd[b + ".attn.relative_position_bias_table"] = normal(((2 * ws - 1) ** 2, heads), LINEAR_STD)
            linear(b + ".attn.qkv", c, 3 * c)
            linear(b + ".attn.proj", c, c)
            norm(b + ".norm2")
            linear(b + ".mlp.fc1", c, hidden)
            linear(b + ".mlp.fc2", hidden, c)
        for k in (0, 2, 4):
            conv(f"layers.{i}.conv.{k}")
    norm("norm")
    for name in ("conv_after_body.0", "conv_after_body.2", "conv_after_body.4", "conv_before_upsample.0",
                 "conv_up1", "conv_up2", "conv_hr", "conv_last"):
        conv(name)
    last = sd["conv_last.weight"]
    sd["conv_last.weight"] = (last - last.mean(dim=(2, 3), keepdim=True)) * LAST_GAIN
    return sd


def model_files(cfg: dict, weights: dict, workdir: str) -> tuple:
    """``x4.json`` (the architecture and the settings) and ``x4.pth`` (the
    state dict under ``params_ema``, as SwinIR's checkpoints hold it)."""
    json_path, pth_path = os.path.join(workdir, "x4.json"), os.path.join(workdir, "x4.pth")
    with open(json_path, "w") as f:
        json.dump({"architecture": "swinir", **{k: cfg[k] for k in SETTINGS}}, f)
    torch.save({"params_ema": {k: v.cpu() for k, v in weights.items()}}, pth_path)
    return json_path, pth_path


def net(cfg: dict, weights: dict, quant=None):
    return lambda x: forward(x, weights, cfg, quant)


def check_trace(records: dict, cfg: dict) -> None:
    """Say on stderr where the trace lacks rows: every chunk runs one K8 a
    Swin layer, 2 K9 a layer + one an RSTB + 2 (the patch embed, the long
    skip), one K6. torch.profiler has been seen to drop rows of a graph
    replay late in a process."""
    names = [n for _, n, _ in records["device"]["kernels"]]
    spans = records["spans"]
    chunks = sum(spans[k][1] for k in ("chunks.replayed", "chunks.captured", "chunks.eager") if k in spans)
    layers = sum(cfg["depths"])
    want = {"window_attn": layers, "swin_norm": 2 * layers + len(cfg["depths"]) + 2, "tail_kernel": 1}
    got = {k: sum(k in n for n in names) for k in want}
    if chunks and any(got[k] != v * chunks for k, v in want.items()):
        print(f"benchmark: the trace holds {got} kernel rows for {chunks} chunks: "
              f"{ {k: v * chunks for k, v in want.items()} } were expected", file=sys.stderr)
