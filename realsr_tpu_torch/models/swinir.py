"""Real-SwinIR (Liang et al., "SwinIR: Image Restoration Using Swin
Transformer", ICCVW 2021; github.com/JingyunLiang/SwinIR, task ``real_sr``,
``upsampler='nearest+conv'``) forward in PyTorch.

The network, with C = ``embed_dim`` and tokens the pixels of the map:

- pad bottom and right by reflection to a multiple of the window,
  subtract the RGB mean (times ``img_range``); conv_first 3x3 -> C;
- patch embed: LayerNorm of the tokens (the residual stream starts here);
- per RSTB: ``depth`` Swin layers, then its '3conv' body (3x3 C -> C/4,
  LeakyReLU 0.2, 1x1, LeakyReLU 0.2, 3x3 C/4 -> C) on the map, plus the
  RSTB's input;
- a Swin layer: ``x += proj(WA(LN1(x)))``; ``x += fc2(GELU(fc1(LN2(x))))``,
  WA the window attention of ``ops/swin_kernel.py`` (odd layers shifted by
  half a window, with SwinIR's region mask), q scaled by ``head_dim ** -0.5``;
- a final LayerNorm, conv_after_body ('3conv'), plus conv_first's output;
- conv_before_upsample 3x3 C -> 64 with LeakyReLU 0.01, then RRDBNet's
  tail: nearest x2 + conv + LeakyReLU 0.2 twice, conv_hr + LeakyReLU 0.2,
  conv_last 64 -> 3; plus the mean, cropped to the input's 4x.

Precision: the residual stream is carried in ``storage_dtype``; every
product reads ``op_dtype`` operands and sums in float32; LayerNorm
statistics and the softmax are float32. In the mixed mode (float32 stream,
bfloat16 operands) the products of the Swin layers and the 3conv bodies
run in bfloat16 (``F.linear``, cuDNN), the attention on K8 and each
residual add with the LayerNorm after it on K9 (``kernels``); conv_first
runs in float32 on bfloat16-rounded operands, as RRDBNet's does, and the
tail after conv_before_upsample is RRDBNet's: ``up1_phases`` and K6
(``tail="kernel"``) or the interleaved convs. The kernels' wrappers take
their plain versions for a tensor on the CPU.

Parameters come from SwinIR's published state dict (:func:`params_from_state`),
Linear weights with q's rows scaled by ``head_dim ** -0.5`` at load, the
attention bias gathered from its table, and the per-layer weights stacked.
Public functions take and return NHWC like ``models/rrdbnet.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from realsr_tpu_torch.models.rrdbnet import LRELU_SLOPE, conv3x3, up1_phases
from realsr_tpu_torch.ops import swin_kernel as sk
from realsr_tpu_torch.ops.resize import nearest_x2

RGB_MEAN = (0.4488, 0.4371, 0.4040)  # SwinIR's mean for 3 input channels
BEFORE_UP_SLOPE = 0.01  # nn.LeakyReLU's default, after conv_before_upsample
NUM_FEAT = 64  # SwinIR's num_feat of the nearest+conv upsampler
TAIL_FORMS = ("interleaved", "kernel")  # the tails the SwinIR forward runs


@dataclasses.dataclass(frozen=True)
class SwinIRSpec:
    """SwinIR's constructor settings (their published names); the defaults
    are Real-SwinIR-L x4's (``main_test_swinir.py`` real_sr, large)."""

    upscale: int = 4
    in_chans: int = 3
    img_size: int = 64
    window_size: int = 8
    img_range: float = 1.0
    depths: Tuple[int, ...] = (6,) * 9
    embed_dim: int = 240
    num_heads: Tuple[int, ...] = (8,) * 9
    mlp_ratio: float = 2.0
    upsampler: str = "nearest+conv"
    resi_connection: str = "3conv"
    qkv_bias: bool = True
    patch_norm: bool = True
    ape: bool = False

    @property
    def scale(self) -> int:
        return self.upscale

    @property
    def heads(self) -> int:
        return self.num_heads[0]

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.heads

    @property
    def hidden(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)

    def error(self) -> Optional[str]:
        """Why this forward cannot run the settings, or None."""
        if (self.upsampler, self.resi_connection, self.upscale) != ("nearest+conv", "3conv", 4):
            return (f"the SwinIR forward runs upsampler 'nearest+conv', resi_connection '3conv', upscale 4; "
                    f"got {self.upsampler!r}, {self.resi_connection!r}, {self.upscale}")
        if self.in_chans != 3 or self.ape or not self.patch_norm:
            return f"the SwinIR forward runs in_chans 3, ape False, patch_norm True; got {self}"
        if len(set(self.num_heads)) != 1 or len(self.num_heads) != len(self.depths):
            return f"num_heads must be one count for every RSTB; got {self.num_heads} for depths {self.depths}"
        if self.embed_dim % self.heads or self.embed_dim % 4:
            return f"embed_dim {self.embed_dim} is not a multiple of {self.heads} heads and of 4"
        return None


def read_spec(path: str) -> SwinIRSpec:
    """The ``.json`` of a SwinIR model: ``"architecture": "swinir"`` and the
    constructor's settings by their published names (others take
    SwinIR's defaults as :class:`SwinIRSpec` gives them). Raises
    ``ValueError`` on another architecture, an unknown key or settings the
    forward does not run."""
    with open(path) as f:
        cfg = json.load(f)
    if cfg.get("architecture") != "swinir":
        raise ValueError(f"{path}: not a SwinIR model (architecture {cfg.get('architecture')!r})")
    names = {f.name for f in dataclasses.fields(SwinIRSpec)}
    unknown = sorted(set(cfg) - names - {"architecture"})
    if unknown:
        raise ValueError(f"{path}: unknown SwinIR settings {unknown}")
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items() if k in names}
    spec = SwinIRSpec(**kw)
    err = spec.error()
    if err:
        raise ValueError(f"{path}: {err}")
    return spec


def load_state(path: str) -> Dict[str, torch.Tensor]:
    """A SwinIR ``.pth``: the state dict, or the ``params_ema`` (else
    ``params``) entry of a training checkpoint, as SwinIR's test script
    reads it."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("params_ema", "params"):
        if isinstance(sd, dict) and key in sd and isinstance(sd[key], dict):
            return sd[key]
    return sd


def _conv3_weights(sd, prefix, od) -> dict:
    """A '3conv' body's weights (``prefix.0``, ``.2``, ``.4``) in ``od``."""
    return {f"{k}{i}": sd[f"{prefix}.{2 * i}.{name}"].to(od)
            for i in range(3) for k, name in (("w", "weight"), ("b", "bias"))}


def params_from_state(sd: Dict[str, torch.Tensor], spec: SwinIRSpec, op_dtype, kernels: bool) -> dict:
    """The forward's parameters (CPU tensors) from SwinIR's published state
    dict (``layers.{i}.residual_group.blocks.{j}.attn.qkv.weight``, ...).
    Its ``attn_mask`` and ``relative_position_index`` buffers are not read:
    the mask follows each map's size and the index is SwinIR's formula.
    Linear and conv weights of the Swin layers, bodies and
    conv_before_upsample are in ``op_dtype``; q's rows of each qkv carry
    the ``head_dim ** -0.5`` scale; ``attn_bias`` is each layer's table
    gathered to ``[heads, N, N]`` and, with ``kernels``, ``attn_packed`` its
    K8 operand. LayerNorms, conv_first and the tail stay float32."""
    sd = {k: v.float() for k, v in sd.items()}
    c, w = spec.embed_dim, spec.window_size
    scale = spec.head_dim ** -0.5
    blocks = [f"layers.{i}.residual_group.blocks.{j}." for i, d in enumerate(spec.depths) for j in range(d)]

    def stack(name, dt=torch.float32):
        return torch.stack([sd[b + name] for b in blocks]).to(dt).contiguous()

    qkv_w, qkv_b = stack("attn.qkv.weight"), (stack("attn.qkv.bias") if spec.qkv_bias
                                              else torch.zeros(len(blocks), 3 * c))
    qkv_w[:, :c] *= scale
    qkv_b[:, :c] *= scale
    bias = torch.stack([sk.attention_bias(sd[b + "attn.relative_position_bias_table"], w) for b in blocks])
    p = {
        "conv_first": {"w": sd["conv_first.weight"], "b": sd["conv_first.bias"]},
        "pe_norm": {"w": sd["patch_embed.norm.weight"], "b": sd["patch_embed.norm.bias"]},
        "blocks": {
            "n1w": stack("norm1.weight"), "n1b": stack("norm1.bias"),
            "n2w": stack("norm2.weight"), "n2b": stack("norm2.bias"),
            "qkv_w": qkv_w.to(op_dtype), "qkv_b": qkv_b.to(op_dtype),
            "proj_w": stack("attn.proj.weight", op_dtype), "proj_b": stack("attn.proj.bias", op_dtype),
            "fc1_w": stack("mlp.fc1.weight", op_dtype), "fc1_b": stack("mlp.fc1.bias", op_dtype),
            "fc2_w": stack("mlp.fc2.weight", op_dtype), "fc2_b": stack("mlp.fc2.bias", op_dtype),
            "attn_bias": bias,
        },
        "rstb": [_conv3_weights(sd, f"layers.{i}.conv", op_dtype) for i in range(len(spec.depths))],
        "norm": {"w": sd["norm.weight"], "b": sd["norm.bias"]},
        "body": _conv3_weights(sd, "conv_after_body", op_dtype),
        "before_up": {"w": sd["conv_before_upsample.0.weight"].to(op_dtype),
                      "b": sd["conv_before_upsample.0.bias"].to(op_dtype)},
        "up": {"w": torch.stack([sd["conv_up1.weight"], sd["conv_up2.weight"]]),
               "b": torch.stack([sd["conv_up1.bias"], sd["conv_up2.bias"]])},
        "hr": {"w": sd["conv_hr.weight"], "b": sd["conv_hr.bias"]},
        "last": {"w": sd["conv_last.weight"], "b": sd["conv_last.bias"]},
        "mean": torch.tensor(RGB_MEAN),
    }
    p["rstb"] = {k: torch.stack([r[k] for r in p["rstb"]]) for k in p["rstb"][0]}
    if kernels:
        p["blocks"]["attn_packed"] = sk.pack_bias(bias)
    return p


def kernel_error(spec: SwinIRSpec, storage_dtype, op_dtype) -> Optional[str]:
    """Why K8 / K9 have no instance for ``spec``'s widths at this precision,
    or None: they run the mixed mode (float32 residual stream, bfloat16
    operands) alone."""
    if (storage_dtype, op_dtype) != (torch.float32, torch.bfloat16):
        return (f"window_attn and swin_norm run mixed precision (float32 storage, bfloat16 operands) only; "
                f"the engine asks for {storage_dtype} storage with {op_dtype} operands")
    if spec.embed_dim not in sk.NORM_WIDTHS:
        return f"swin_norm is built for widths {sk.NORM_WIDTHS}, the model has {spec.embed_dim}"
    return sk.attn_error(spec.heads, spec.head_dim, spec.window_size)


def padded_side(n: int, spec: SwinIRSpec) -> int:
    """A tile side after ``check_image_size``'s pad to whole windows."""
    return -(-n // spec.window_size) * spec.window_size


def tile_bytes(spec: SwinIRSpec, ph: int, pw: int) -> int:
    """Device bytes a chunk holds per tile of ``ph`` x ``pw`` (with its
    halo) at the peak of the forward, a Swin layer: per token three float32
    residual streams (the RSTB's input, the stream and its next) and the
    bfloat16 LayerNorm output, with the larger of the attention's (qkv,
    its output, proj's output) and the MLP's (fc1's output and GELU's)
    bfloat16 activations."""
    c = spec.embed_dim
    per_token = 3 * 4 * c + 2 * c + 2 * max(3 * c + c + c, 2 * spec.hidden)
    return padded_side(ph, spec) * padded_side(pw, spec) * per_token


def chunk_counts(spec: SwinIRSpec, ph: int, pw: int, batch: int, real: int, pad: int) -> dict:
    """The tracer's counters of one chunk of ``batch`` tiles ``ph`` x ``pw``
    (``real`` of them not pad duplicates, halo ``pad``): ``swin.tokens.run``
    the tokens every Swin layer runs (padding to whole windows included),
    ``swin.tokens.own`` the real tiles' own pixels."""
    return {"swin.tokens.run": batch * padded_side(ph, spec) * padded_side(pw, spec),
            "swin.tokens.own": real * (ph - 2 * pad) * (pw - 2 * pad)}


def _tokens(t: torch.Tensor) -> torch.Tensor:
    """NCHW map (channels-last in memory) -> tokens ``[N, C]``."""
    return t.permute(0, 2, 3, 1).reshape(-1, t.shape[1])


def _map(t: torch.Tensor, b: int, h: int, w: int) -> torch.Tensor:
    """Tokens ``[N, C]`` -> the NCHW view of their NHWC map."""
    return t.view(b, h, w, -1).permute(0, 3, 1, 2)


def _conv3(x, p, i=None):
    """A '3conv' body on the NCHW ``x`` in the weights' type (``p`` stacked
    over RSTBs where ``i`` is given)."""
    g = (lambda k: p[k]) if i is None else (lambda k: p[k][i])  # noqa: E731
    x = F.leaky_relu(F.conv2d(x, g("w0"), g("b0"), padding=1), LRELU_SLOPE)
    x = F.leaky_relu(F.conv2d(x, g("w1"), g("b1")), LRELU_SLOPE)
    return F.conv2d(x, g("w2"), g("b2"), padding=1)


def _tail(p, f, od, storage_dtype, tail):
    """conv_before_upsample's output NHWC ``f`` -> NHWC float32 at 4x:
    RRDBNet's up1 phases and K6 (``tail`` "kernel") or its interleaved
    convs."""
    if tail == "kernel":
        from realsr_tpu_torch.ops.tail_kernel import up2_hr_last_packed

        y1 = up1_phases(f, p["up"]["w"][0], p["up"]["b"][0], od, storage_dtype)
        return up2_hr_last_packed(y1.to(od).contiguous(), p["tail"])

    def conv(x, group, s=None, slope=LRELU_SLOPE):
        w, b = (p[group]["w"], p[group]["b"]) if s is None else (p[group]["w"][s], p[group]["b"][s])
        return conv3x3(x.permute(0, 3, 1, 2), w, b, slope, od).permute(0, 2, 3, 1)

    for s in range(2):
        f = conv(nearest_x2(f), "up", s).to(storage_dtype)
    return conv(conv(f, "hr").to(storage_dtype), "last", slope=None)


def swinir_forward(p: dict, x: torch.Tensor, spec: SwinIRSpec, storage_dtype=torch.float32, op_dtype=None,
                   kernels: bool = False, tail: str = "interleaved") -> torch.Tensor:
    """Normalized NHWC input ``[B, H, W, 3]`` in [0, 1] -> NHWC float32
    ``[B, 4H, 4W, 3]``. ``kernels``: the attention on K8 and the residual
    adds and LayerNorms on K9 (mixed mode: float32 ``storage_dtype``,
    bfloat16 ``op_dtype``), else their plain versions at these types."""
    od = op_dtype if op_dtype is not None else storage_dtype
    if tail not in TAIL_FORMS:
        raise ValueError(f"unknown SwinIR tail {tail!r}; expected one of {TAIL_FORMS}")
    # the plain attention reads the float32 bias, not K8's packed operand
    attn = sk.window_attn if kernels else (lambda q, b, _, *a: sk.window_attn_plain(q, b, *a))
    norm = sk.swin_norm if kernels else (lambda *a, **k: sk.swin_norm_plain(*a, **k, out_dtype=od))
    B, H, W, _ = x.shape
    ws, c, heads = spec.window_size, spec.embed_dim, spec.heads
    hp, wp = padded_side(H, spec), padded_side(W, spec)
    x = x.float().permute(0, 3, 1, 2)
    if (hp, wp) != (H, W):
        x = F.pad(x, (0, wp - W, 0, hp - H), mode="reflect")
    x = ((x - p["mean"].view(1, 3, 1, 1)) * spec.img_range).contiguous(memory_format=torch.channels_last)
    fea = conv3x3(x, p["conv_first"]["w"], p["conv_first"]["b"], None, od).to(storage_dtype)
    fea = _tokens(fea.contiguous(memory_format=torch.channels_last))

    bl = p["blocks"]
    packed = bl.get("attn_packed")
    res, h = norm(fea, None, bl["n1w"][0], bl["n1b"][0], pre=(p["pe_norm"]["w"], p["pe_norm"]["b"]))
    layer = 0
    for i, depth in enumerate(spec.depths):
        rstb_in = res
        for j in range(depth):
            qkv = F.linear(h, bl["qkv_w"][layer], bl["qkv_b"][layer]).view(B, hp, wp, 3 * c)
            a = attn(qkv, bl["attn_bias"][layer], None if packed is None else packed[layer], heads, ws,
                     ws // 2 if j % 2 else 0)
            del qkv
            res, h = norm(res, F.linear(a.view(-1, c), bl["proj_w"][layer], bl["proj_b"][layer]),
                          bl["n2w"][layer], bl["n2b"][layer])
            del a
            m = F.linear(F.gelu(F.linear(h, bl["fc1_w"][layer], bl["fc1_b"][layer])),
                         bl["fc2_w"][layer], bl["fc2_b"][layer])
            if j + 1 < depth:
                res, h = norm(res, m, bl["n1w"][layer + 1], bl["n1b"][layer + 1])
            else:  # the body's first conv reads the sum itself, in the operand type
                res, h = norm(res, m, None, None)
            layer += 1
        body = _tokens(_conv3(_map(h, B, hp, wp), p["rstb"], i).contiguous(memory_format=torch.channels_last))
        last = i + 1 == len(spec.depths)
        nw, nb = (p["norm"]["w"], p["norm"]["b"]) if last else (bl["n1w"][layer], bl["n1b"][layer])
        res, h = norm(rstb_in, body, nw, nb, write_res=not last)
        del rstb_in
    del res
    body = _tokens(_conv3(_map(h, B, hp, wp), p["body"]).contiguous(memory_format=torch.channels_last))
    _, s = norm(fea, body, None, None, write_res=False)
    f = F.conv2d(_map(s, B, hp, wp), p["before_up"]["w"], p["before_up"]["b"], padding=1)
    f = F.leaky_relu(f, BEFORE_UP_SLOPE).permute(0, 2, 3, 1)
    out = _tail(p, f, od, storage_dtype, tail).float()
    out = out / spec.img_range + p["mean"]
    return out[:, : H * spec.upscale, : W * spec.upscale]


def state_keys(spec: SwinIRSpec) -> list:
    """(key, shape) of SwinIR's state dict at ``spec``, in its order (the
    parameters; the ``attn_mask`` and ``relative_position_index`` buffers
    left out)."""
    c, q, f, ws = spec.embed_dim, spec.embed_dim // 4, NUM_FEAT, spec.window_size
    conv = lambda n, ci, co, k: [(n + ".weight", (co, ci, k, k)), (n + ".bias", (co,))]  # noqa: E731
    three = lambda n: conv(n + ".0", c, q, 3) + conv(n + ".2", q, q, 1) + conv(n + ".4", q, c, 3)  # noqa: E731
    norm = lambda n: [(n + ".weight", (c,)), (n + ".bias", (c,))]  # noqa: E731
    lin = lambda n, ci, co: [(n + ".weight", (co, ci)), (n + ".bias", (co,))]  # noqa: E731
    out = conv("conv_first", spec.in_chans, c, 3) + norm("patch_embed.norm")
    for i, (depth, heads) in enumerate(zip(spec.depths, spec.num_heads)):
        for j in range(depth):
            b = f"layers.{i}.residual_group.blocks.{j}"
            out += norm(b + ".norm1") + [(b + ".attn.relative_position_bias_table", ((2 * ws - 1) ** 2, heads))]
            out += lin(b + ".attn.qkv", c, 3 * c) + lin(b + ".attn.proj", c, c) + norm(b + ".norm2")
            out += lin(b + ".mlp.fc1", c, spec.hidden) + lin(b + ".mlp.fc2", spec.hidden, c)
        out += three(f"layers.{i}.conv")
    out += norm("norm") + three("conv_after_body") + conv("conv_before_upsample.0", c, f, 3)
    for n in ("conv_up1", "conv_up2", "conv_hr"):
        out += conv(n, f, f, 3)
    return out + conv("conv_last", f, spec.in_chans, 3)


def init_state(spec: SwinIRSpec, seed: int = 0, last_gain: float = 16.0) -> Dict[str, torch.Tensor]:
    """Random (deterministic) float32 weights in SwinIR's key layout: Linear
    weights, biases and bias tables N(0, 0.02), LayerNorm scales
    1 + N(0, 0.1), convs U(+-1/sqrt(fan-in)); conv_last centred over its
    taps and times ``last_gain``, so the output spreads around the mean."""
    rng = np.random.default_rng(seed)
    shapes = dict(state_keys(spec))
    sd = {}
    for key, shape in shapes.items():
        weight = shapes.get(key[: -len("bias")] + "weight", shape)
        if len(weight) == 4:  # a conv's weight or bias
            v = rng.uniform(-1, 1, shape) / np.sqrt(np.prod(weight[1:]))
        elif "norm" in key and key.endswith(".weight"):
            v = 1 + rng.normal(0, 0.1, shape)
        else:
            v = rng.normal(0, 0.02, shape)
        sd[key] = torch.from_numpy(np.asarray(v, np.float32))
    w = sd["conv_last.weight"]
    sd["conv_last.weight"] = (w - w.mean(dim=(2, 3), keepdim=True)) * last_gain
    return sd


def save_model(directory: str, spec: SwinIRSpec, state: Dict[str, torch.Tensor], scale: int = 4) -> tuple:
    """Write a SwinIR model as the loader reads it: ``x<scale>.json`` (the
    architecture and the settings) and ``x<scale>.pth`` (``state`` under
    ``params_ema``); returns their paths."""
    os.makedirs(directory, exist_ok=True)
    jp, tp = os.path.join(directory, f"x{scale}.json"), os.path.join(directory, f"x{scale}.pth")
    with open(jp, "w") as f:
        json.dump({"architecture": "swinir", **dataclasses.asdict(spec)}, f)
    torch.save({"params_ema": state}, tp)
    return jp, tp
