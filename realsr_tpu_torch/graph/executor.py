"""Generic executor for parsed ncnn graphs, on NHWC torch tensors.

Counterpart of ``realsr_tpu/graph/executor.py``: graphs the RRDBNet matcher
rejects run here layer by layer, as plain PyTorch ops (JAX's generic path
runs no Pallas kernel, so none is needed here). Blobs are NHWC; the ncnn
channel axis (0 of CHW) is NHWC axis 3. Convolutions run through
``F.conv2d`` on the NCHW view of an NHWC blob (channels-last memory) with
OIHW weights, so :func:`convert_weights_oihw` keeps the .bin layout and only
flattens the depthwise groups.

Precision follows the JAX executor: blobs are held in ``storage_dtype``
(the engine passes its operand type: the generic path has no float32-carry
form), convolutions and inner products read operands rounded to it and sum
in float32, and elementwise math runs in float32 before rounding back.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from realsr_tpu_torch.ncnn.param import Layer, ParamGraph
from realsr_tpu_torch.ops.pad import reflect101_indices
from realsr_tpu_torch.ops.resize import nearest_x2, resize_nhwc

# ncnn 3D blobs are CHW; batch-extended NHWC axis for each ncnn axis.
_NCNN_AXIS_TO_NHWC = {0: 3, 1: 1, 2: 2}


def convert_weights_oihw(
    weights: Dict[str, Dict[str, np.ndarray]],
) -> Dict[str, Dict[str, np.ndarray]]:
    """The .bin records as ``F.conv2d`` takes them: Convolution stays OIHW;
    ConvolutionDepthWise ``[g, O/g, I/g, kh, kw]`` becomes ``[O, I/g, kh,
    kw]`` (output channel ``g * O/g + o``, the JAX executor's order)."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for name, rec in weights.items():
        new = dict(rec)
        w = rec.get("weight")
        if w is not None and w.ndim == 5:
            g, og, ig, kh, kw = w.shape
            new["weight"] = np.ascontiguousarray(w.reshape(g * og, ig, kh, kw))
        out[name] = new
    return out


def weights_from_jax(
    weights: Dict[str, Dict[str, np.ndarray]],
) -> Dict[str, Dict[str, np.ndarray]]:
    """The JAX executor's converted weights (HWIO convs, depthwise too) ->
    this executor's (OIHW); every other record is copied as float32."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for name, rec in weights.items():
        new = {k: np.asarray(v, np.float32) for k, v in rec.items()}
        w = new.get("weight")
        if w is not None and w.ndim == 4:
            new["weight"] = np.ascontiguousarray(w.transpose(3, 2, 0, 1))
        out[name] = new
    return out


def _f32(t) -> torch.Tensor:
    return t.float() if isinstance(t, torch.Tensor) else torch.as_tensor(np.asarray(t, np.float32))


def _operand(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype``, as float32 (float32 sums)."""
    return t.to(dtype).float()


def _apply_activation(x: torch.Tensor, layer: Layer) -> torch.Tensor:
    """Fused conv activation (ncnn Convolution param 9 + -23310)."""
    act = layer.pi(9)
    if act == 0:
        return x
    if act == 1:
        return torch.clamp_min(x, 0.0)
    if act == 2:
        slope = layer.pa(10, [0.0])[0]
        return torch.where(x >= 0, x, x * slope)
    if act == 3:
        lo, hi = layer.pa(10, [0.0, 6.0])[:2]
        return torch.clamp(x, lo, hi)
    if act == 4:
        return torch.sigmoid(x)
    if act == 5:
        return x * torch.tanh(F.softplus(x))  # mish
    if act == 6:
        p = layer.pa(10, [1.0 / 6.0, 0.5])
        return x * torch.clamp(x * p[0] + p[1], 0.0, 1.0)  # hardswish
    raise NotImplementedError(f"{layer.name}: activation_type {act}")


def _conv(x: torch.Tensor, layer: Layer, params, storage_dtype) -> torch.Tensor:
    kw = layer.pi(1)
    kh = layer.pi(11, kw)
    dw = layer.pi(2, 1)
    dh = layer.pi(12, dw)
    sw = layer.pi(3, 1)
    sh = layer.pi(13, sw)
    pad_left = layer.pi(4, 0)
    pad_right = layer.pi(15, pad_left)
    pad_top = layer.pi(14, pad_left)
    pad_bottom = layer.pi(16, pad_top)
    groups = layer.pi(7, 1) if layer.type == "ConvolutionDepthWise" else 1

    xc = _operand(x, storage_dtype).permute(0, 3, 1, 2)  # NCHW view, channels-last memory
    if (pad_left, pad_top) == (pad_right, pad_bottom) and min(pad_left, pad_top) >= 0:
        padding = (pad_top, pad_left)
    else:
        xc = F.pad(xc, (pad_left, pad_right, pad_top, pad_bottom))
        padding = (0, 0)
    w = _operand(torch.as_tensor(params["weight"], device=x.device), storage_dtype)
    y = F.conv2d(xc, w, None, (sh, sw), padding, (dh, dw), groups).permute(0, 2, 3, 1)
    if layer.pi(5):
        y = y + _f32(params["bias"]).to(x.device)
    return _apply_activation(y, layer).to(storage_dtype)


def _eltwise(inputs: List[torch.Tensor], layer: Layer, storage_dtype) -> torch.Tensor:
    op = layer.pi(0)
    xs = [x.float() for x in inputs]
    if op == 0:  # PROD
        y = xs[0]
        for x in xs[1:]:
            y = y * x
    elif op == 1:  # SUM, optional per-input coeffs (x4.param: [0.2, 1.0])
        coeffs = layer.pa(1, [])
        if coeffs:
            y = xs[0] * coeffs[0]
            for x, c in zip(xs[1:], coeffs[1:]):
                y = y + x * c
        else:
            y = xs[0]
            for x in xs[1:]:
                y = y + x
    elif op == 2:  # MAX
        y = xs[0]
        for x in xs[1:]:
            y = torch.maximum(y, x)
    else:
        raise NotImplementedError(f"{layer.name}: eltwise op {op}")
    return y.to(storage_dtype)


_BINARY_OPS: Dict[int, Callable] = {
    0: torch.add,
    1: torch.sub,
    2: torch.mul,
    3: torch.div,
    4: torch.maximum,
    5: torch.minimum,
    6: torch.pow,
    7: lambda a, b: b - a,
    8: lambda a, b: b / a,
}


@functools.lru_cache(maxsize=None)
def _scalar_on(bits: bytes, device: torch.device) -> torch.Tensor:
    """The float32 scalar of these 4 bytes as a 0-d tensor on ``device``,
    made once per value and device: a layer's scalar is uploaded once, not
    by a blocking copy on every call. Keyed by the bytes, so -0.0 and 0.0
    stay apart; float32, so ``pow`` gets the same operand as before."""
    return torch.from_numpy(np.frombuffer(bits, np.float32).copy()).reshape(()).to(device)


def _binary_op(inputs: List[torch.Tensor], layer: Layer, storage_dtype) -> torch.Tensor:
    op = layer.pi(0)
    a = inputs[0].float()
    if layer.pi(1):  # with_scalar
        b = _scalar_on(np.float32(layer.pf(2)).tobytes(), a.device)
    else:
        b = inputs[1].float()
    if op not in _BINARY_OPS:
        raise NotImplementedError(f"{layer.name}: binary op {op}")
    return _BINARY_OPS[op](a, b).to(storage_dtype)


def _interp(x: torch.Tensor, layer: Layer) -> torch.Tensor:
    rtype = layer.pi(0)
    kind = {1: "nearest", 2: "bilinear", 3: "bicubic"}.get(rtype)
    if kind is None:
        raise NotImplementedError(f"{layer.name}: resize_type {rtype}")
    out_h = layer.pi(3, 0) or int(round(x.shape[1] * layer.pf(1, 1.0)))
    out_w = layer.pi(4, 0) or int(round(x.shape[2] * layer.pf(2, 1.0)))
    if kind == "nearest" and out_h == 2 * x.shape[1] and out_w == 2 * x.shape[2]:
        return nearest_x2(x)
    return resize_nhwc(x, out_h, out_w, kind)


def _pixel_shuffle(x: torch.Tensor, layer: Layer) -> torch.Tensor:
    r = layer.pi(0, 1)
    mode = layer.pi(1, 0)
    n, h, w, c = x.shape
    co = c // (r * r)
    if mode == 0:  # ncnn default: in channel = co*r*r + sh*r + sw
        x = x.reshape(n, h, w, co, r, r).permute(0, 1, 4, 2, 5, 3)  # n h rh w rw co
    else:  # mode 1: in channel = (sh*r + sw)*co + c
        x = x.reshape(n, h, w, r, r, co).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, co)


def _border_index(n: int, lo: int, hi: int, ptype: int, device) -> torch.Tensor:
    """Source index of each padded position: edge (1) clamps, reflect (2)
    mirrors without edge duplication (ncnn's reflect, numpy's "reflect")."""
    if ptype == 1:
        idx = np.clip(np.arange(-lo, n + hi), 0, n - 1)
    else:
        idx = reflect101_indices(n, lo, hi)
    return torch.from_numpy(idx).to(device)


def _padding(x: torch.Tensor, layer: Layer, storage_dtype) -> torch.Tensor:
    top, bottom = layer.pi(0), layer.pi(1)
    left, right = layer.pi(2), layer.pi(3)
    ptype = layer.pi(4)
    if ptype == 0:
        return F.pad(x, (0, 0, left, right, top, bottom), value=layer.pf(5)).to(storage_dtype)
    if ptype in (1, 2):
        x = x.index_select(1, _border_index(x.shape[1], top, bottom, ptype, x.device))
        return x.index_select(2, _border_index(x.shape[2], left, right, ptype, x.device))
    raise NotImplementedError(f"{layer.name}: padding type {ptype}")


def _pooling(x: torch.Tensor, layer: Layer, storage_dtype) -> torch.Tensor:
    ptype = layer.pi(0, 0)  # 0 = max, 1 = avg
    if ptype not in (0, 1):
        raise NotImplementedError(f"{layer.name}: pooling_type {ptype}")
    xf = x.float()
    if layer.pi(4, 0):  # global pooling -> [N, 1, 1, C] like ncnn's [C] blob
        y = xf.amax(dim=(1, 2), keepdim=True) if ptype == 0 else xf.mean(dim=(1, 2), keepdim=True)
        return y.to(storage_dtype)
    kw = layer.pi(1, 0)
    kh = layer.pi(11, kw)
    sw = layer.pi(2, 1)
    sh = layer.pi(12, sw)
    if any(layer.pi(k, 0) for k in (3, 13, 14, 15)):
        raise NotImplementedError(f"{layer.name}: padded pooling")
    pad_mode = layer.pi(5, 0)
    if pad_mode == 0:
        # ncnn's default 'full' mode ceils the output extent; this floors,
        # which is the same only where the windows tile the input exactly
        if (x.shape[1] - kh) % sh or (x.shape[2] - kw) % sw:
            raise NotImplementedError(f"{layer.name}: full-pad (ceil) pooling with a partial tail window")
    elif pad_mode != 1:  # 1 = valid (floor)
        raise NotImplementedError(f"{layer.name}: pad_mode {pad_mode}")
    pool = F.max_pool2d if ptype == 0 else F.avg_pool2d
    y = pool(xf.permute(0, 3, 1, 2), (kh, kw), (sh, sw)).permute(0, 2, 3, 1)
    return y.to(storage_dtype)


def _crop(x: torch.Tensor, layer: Layer) -> torch.Tensor:
    woff, hoff, coff = layer.pi(0), layer.pi(1), layer.pi(2)
    outw, outh, outc = layer.pi(3), layer.pi(4), layer.pi(5)
    n, h, w, c = x.shape
    outw = outw if outw else w - woff
    outh = outh if outh else h - hoff
    outc = outc if outc else c - coff
    return x[:, hoff : hoff + outh, woff : woff + outw, coff : coff + outc]


def _flat(x: torch.Tensor) -> torch.Tensor:
    """ncnn flattens CHW: NHWC -> [N, C*H*W]; a flat blob passes through."""
    return x if x.dim() == 2 else x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)


def _inner_product(x: torch.Tensor, layer: Layer, params, storage_dtype) -> torch.Tensor:
    w = _operand(torch.as_tensor(params["weight"], device=x.device), storage_dtype)
    y = _operand(_flat(x), storage_dtype) @ w.T  # [num_output, in_features]
    if layer.pi(1):
        y = y + _f32(params["bias"]).to(x.device)
    return _apply_activation(y, layer).to(storage_dtype)


def _unary(x: torch.Tensor, fn, storage_dtype) -> torch.Tensor:
    return fn(x.float()).to(storage_dtype)


def build_forward(
    graph: ParamGraph,
    input_blob: Optional[str] = None,
    output_blob: Optional[str] = None,
    storage_dtype=torch.float32,
) -> Callable[[Dict[str, Dict[str, torch.Tensor]], torch.Tensor], torch.Tensor]:
    """Build ``fn(params, x_nhwc) -> y_nhwc`` executing the graph, with
    ``params`` from :func:`convert_weights_oihw` (numpy or tensors). A
    consumed blob that no earlier layer produces raises ``ValueError`` here;
    a layer type or option the executor lacks raises
    ``NotImplementedError`` when it runs, as in the JAX executor."""
    inputs = graph.input_blobs()
    if input_blob is None:
        if len(inputs) != 1:
            raise ValueError(f"graph has {len(inputs)} inputs; specify input_blob")
        input_blob = inputs[0]
    if output_blob is None:
        outs = graph.output_blobs()
        if len(outs) != 1:
            raise ValueError(f"graph has {len(outs)} outputs; specify output_blob")
        output_blob = outs[0]

    # every consumed blob must come from an earlier layer (ncnn's loader
    # enforces the same order): a mis-wired graph fails at load
    produced = {input_blob}
    for layer in graph.layers:
        for b in layer.inputs:
            if b not in produced:
                raise ValueError(f"{layer.name}: input blob {b!r} is not produced by any earlier layer")
        produced.update(layer.outputs)
    if output_blob not in produced:
        raise ValueError(f"output blob {output_blob!r} is never produced")

    # each blob's last consumer, so intermediates are freed as the run goes
    last_use: Dict[str, int] = {output_blob: len(graph.layers)}
    for idx, layer in enumerate(graph.layers):
        for b in layer.inputs:
            last_use[b] = max(last_use.get(b, -1), idx)
    sd = storage_dtype

    def forward(params, x):
        blobs: Dict[str, torch.Tensor] = {input_blob: x.to(sd)}
        for idx, layer in enumerate(graph.layers):
            t = layer.type
            if t == "Input":
                if layer.outputs[0] != input_blob:
                    raise ValueError(f"graph input {layer.outputs[0]!r} != bound {input_blob!r}")
                continue
            ins = [blobs[b] for b in layer.inputs]
            if t == "Split":
                outs = [ins[0]] * len(layer.outputs)
            elif t in ("Convolution", "ConvolutionDepthWise"):
                outs = [_conv(ins[0], layer, params[layer.name], sd)]
            elif t == "Concat":
                outs = [torch.cat(ins, dim=_NCNN_AXIS_TO_NHWC[layer.pi(0, 0)])]
            elif t == "Eltwise":
                outs = [_eltwise(ins, layer, sd)]
            elif t == "BinaryOp":
                outs = [_binary_op(ins, layer, sd)]
            elif t == "Interp":
                outs = [_interp(ins[0], layer)]
            elif t == "ReLU":
                slope = layer.pf(0, 0.0)
                fn = (lambda v: torch.clamp_min(v, 0.0)) if slope == 0 else (
                    lambda v: torch.where(v >= 0, v, v * slope))
                outs = [_unary(ins[0], fn, sd)]
            elif t == "PReLU":
                # per-channel learned slope; a single slope broadcasts like
                # ncnn's num_slope == 1
                s = _f32(params[layer.name]["slope"]).to(ins[0].device)
                s = s.reshape((1,) * (ins[0].dim() - 1) + (-1,)) if s.numel() > 1 else s
                outs = [_unary(ins[0], lambda v: torch.where(v >= 0, v, v * s), sd)]
            elif t == "Pooling":
                outs = [_pooling(ins[0], layer, sd)]
            elif t == "Clip":
                outs = [_unary(ins[0], lambda v: torch.clamp(v, layer.pf(0), layer.pf(1)), sd)]
            elif t == "Sigmoid":
                outs = [_unary(ins[0], torch.sigmoid, sd)]
            elif t == "TanH":
                outs = [_unary(ins[0], torch.tanh, sd)]
            elif t == "AbsVal":
                outs = [ins[0].abs()]
            elif t == "Dropout":
                scale = layer.pf(0, 1.0)
                outs = [ins[0] if scale == 1.0 else (ins[0] * scale).to(sd)]
            elif t == "PixelShuffle":
                outs = [_pixel_shuffle(ins[0], layer)]
            elif t == "Padding":
                outs = [_padding(ins[0], layer, sd)]
            elif t == "Crop":
                outs = [_crop(ins[0], layer)]
            elif t == "Flatten":
                outs = [_flat(ins[0])]
            elif t == "InnerProduct":
                outs = [_inner_product(ins[0], layer, params[layer.name], sd)]
            elif t in ("Noop", "Packing", "Cast"):
                # ncnn's layout and dtype plumbing: pass-throughs here
                outs = [ins[0]] * max(1, len(layer.outputs))
            else:
                raise NotImplementedError(f"{layer.name}: layer type {t!r}")
            for b, v in zip(layer.outputs, outs):
                blobs[b] = v
            for b in layer.inputs:
                if last_use.get(b, -1) <= idx and b in blobs and b != output_blob:
                    del blobs[b]
        return blobs[output_blob]

    return forward
