"""RRDBNet (ESRGAN-style) forward in PyTorch.

Counterpart of ``realsr_tpu/models/rrdbnet.py``. The DF2K graph
(models/models-DF2K/x4.param) is: conv_first (3 -> nf) -> num_rrdb x RRDB ->
trunk conv + long skip -> num_upsample x (nearest-x2 + conv + lrelu) ->
HRconv + lrelu -> conv_last (nf -> 3). An RRDB is three residual dense
blocks (RDB) and the residual ``0.2 * chain + x``; an RDB is five densely
concatenated 3x3 convs with LeakyReLU(0.2) on the first four and the
residual ``0.2 * c5 + x``.

Precision follows the JAX package: convs read ``op_dtype`` operands and sum
in float32; carried activations are rounded to ``storage_dtype``. Storage
float32 with bfloat16 operands is the mixed mode. Every conv rounds its
operands to ``op_dtype`` and runs in float32, which is the JAX package's
``preferred_element_type=float32``. For float32 operands on a GPU, TF32
must be off (:func:`disable_tf32`; the engine's float32 mode calls it) to
match the JAX package's ``Precision.HIGHEST``; bfloat16 and float16 values
are exact in TF32, so for them TF32 changes only the order of the sums.

Parameters are numpy or torch trees of OIHW convs (:func:`params_from_jax`
converts the JAX package's HWIO trees). Public functions take and return
NHWC like the JAX package; internally the convs run on NCHW views.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from realsr_tpu_torch.ops.resize import nearest_x2

LRELU_SLOPE = 0.2
RESIDUAL_SCALE = 0.2


@dataclasses.dataclass(frozen=True)
class RRDBNetSpec:
    """Static architecture hyperparameters recovered from the .param graph."""

    num_rrdb: int = 23
    num_rdb_per_rrdb: int = 3
    nf: int = 64
    gc: int = 32
    in_ch: int = 3
    out_ch: int = 3
    num_upsample: int = 2  # nearest-x2 stages => scale = 2**num_upsample

    @property
    def scale(self) -> int:
        return 2**self.num_upsample


def disable_tf32() -> None:
    """Turn TF32 off for cuDNN convs and matmuls, process-wide (torch has
    no per-call switch): a float32 conv on the card then computes in
    float32, as the JAX package's Precision.HIGHEST does."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def operand(t: torch.Tensor, op_dtype) -> torch.Tensor:
    """``t`` rounded to ``op_dtype``, as float32."""
    return t.float() if op_dtype == torch.float32 else t.to(op_dtype).float()


def conv3x3(x, w, b, slope=None, op_dtype=None):
    """3x3 stride-1 pad-1 conv on NCHW ``x`` with OIHW ``w``; float32 sums,
    optional LeakyReLU. Returns float32; the caller rounds to storage."""
    od = op_dtype if op_dtype is not None else x.dtype
    y = F.conv2d(
        operand(x, od), operand(torch.as_tensor(w, device=x.device), od),
        None if b is None else torch.as_tensor(b, device=x.device).float(),
        padding=1,
    )
    return y if slope is None else _lrelu(y, slope)


def _lrelu(v, slope=LRELU_SLOPE):
    return torch.where(v >= 0, v, v * slope)


def _bias(b, ref):
    return torch.as_tensor(b, device=ref.device).float()[:, None, None]


def _rdb(x, p, storage_dtype, op_dtype=None):
    """Residual dense block on NCHW ``x`` (storage dtype); returns the same."""
    feats = [x]
    for i in range(1, 5):
        c = conv3x3(torch.cat(feats, 1), p[f"w{i}"], p[f"b{i}"], LRELU_SLOPE, op_dtype)
        feats.append(c.to(storage_dtype))
    c5 = conv3x3(torch.cat(feats, 1), p["w5"], p["b5"], None, op_dtype)
    return (RESIDUAL_SCALE * c5 + x.float()).to(storage_dtype)


def _rdb_scatter(x, p, storage_dtype, op_dtype=None):
    """The RDB with its weights regrouped by source (see repack_scatter):
    the same math as :func:`_rdb` with the convs' output channels as
    ``(4gc+nf, 3gc+nf, 2gc+nf, gc+nf, nf)``."""
    od = op_dtype
    gc = p["b1"].shape[-1]
    px = conv3x3(x, p["sw0"], None, None, od)
    c1 = _lrelu(px[:, :gc] + _bias(p["b1"], px)).to(storage_dtype)
    p1 = conv3x3(c1, p["sw1"], None, None, od)
    c2 = _lrelu(px[:, gc : 2 * gc] + p1[:, :gc] + _bias(p["b2"], px)).to(storage_dtype)
    p2 = conv3x3(c2, p["sw2"], None, None, od)
    c3 = _lrelu(
        px[:, 2 * gc : 3 * gc] + p1[:, gc : 2 * gc] + p2[:, :gc] + _bias(p["b3"], px)
    ).to(storage_dtype)
    p3 = conv3x3(c3, p["sw3"], None, None, od)
    c4 = _lrelu(
        px[:, 3 * gc : 4 * gc]
        + p1[:, 2 * gc : 3 * gc]
        + p2[:, gc : 2 * gc]
        + p3[:, :gc]
        + _bias(p["b4"], px)
    ).to(storage_dtype)
    p4 = conv3x3(c4, p["sw4"], None, None, od)
    c5 = (
        px[:, 4 * gc :]
        + p1[:, 3 * gc :]
        + p2[:, 2 * gc :]
        + p3[:, gc:]
        + p4
        + _bias(p["b5"], px)
    )
    return (RESIDUAL_SCALE * c5 + x.float()).to(storage_dtype)


def repack_scatter(params):
    """Stacked dense params -> scatter params (numpy, OIHW).

    For source s (0 = the block input x with nf channels, 1..4 = c1..c4 with
    gc channels), concatenate along output channels the input-channel slices
    of w_i (i > s) that multiply source s.
    """
    rdb = params["rdb"]
    gc, nf = rdb["w1"].shape[-4], rdb["w1"].shape[-3]

    def src_slice(i, s):
        lo = s * gc + (nf - gc if s > 0 else 0)
        hi = lo + (nf if s == 0 else gc)
        return rdb[f"w{i}"][..., lo:hi, :, :]

    out = {f"b{i}": rdb[f"b{i}"] for i in range(1, 6)}
    for s in range(5):
        out[f"sw{s}"] = np.concatenate([src_slice(i, s) for i in range(s + 1, 6)], axis=-4)
    new = dict(params)
    new["rdb"] = out
    return new


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _tail(params, fea, body, spec, storage_dtype, od):
    """Trunk conv + long skip + upsampler + HRconv + conv_last (NCHW)."""
    trunk = conv3x3(body, params["trunk"]["w"], params["trunk"]["b"], None, od)
    fea = (fea.float() + trunk).to(storage_dtype)
    for s in range(spec.num_upsample):
        fea = _nchw(nearest_x2(_nhwc(fea)))
        fea = conv3x3(
            fea, params["up"]["w"][s], params["up"]["b"][s], LRELU_SLOPE, od
        ).to(storage_dtype)
    fea = conv3x3(fea, params["hr"]["w"], params["hr"]["b"], LRELU_SLOPE, od)
    fea = fea.to(storage_dtype)
    return conv3x3(fea, params["last"]["w"], params["last"]["b"], None, od)


def rrdbnet_forward(
    params: Dict[str, Any],
    x: torch.Tensor,
    spec: RRDBNetSpec,
    storage_dtype=torch.float32,
    variant: str = "dense",
    op_dtype=None,
) -> torch.Tensor:
    """Normalized NHWC input in [0, 1] -> NHWC float32 (before denorm).

    ``params`` (OIHW convs): ``conv_first``, ``trunk``, ``hr``, ``last``:
    ``{w, b}``; ``up``: ``{w, b}`` stacked ``[num_upsample, ...]``; ``rdb``:
    ``{w1..w5, b1..b5}`` stacked ``[num_rrdb, num_rdb, ...]`` for 'dense',
    ``{sw0..sw4, b1..b5}`` (repack_scatter) for 'scatter', and
    ``{w, b}`` stacked ``[num_rrdb * 3, ...]`` (ops.rdb_kernel.
    pack_rdb_params) for 'cuda', which runs the trunk on the fused RDB
    kernel (the counterpart of the JAX package's 'pallas').
    """
    od = op_dtype if op_dtype is not None else storage_dtype
    x = _nchw(x.to(storage_dtype))
    fea = conv3x3(x, params["conv_first"]["w"], params["conv_first"]["b"], None, od)
    fea = fea.to(storage_dtype)

    if variant == "cuda":
        from realsr_tpu_torch.ops.rdb_kernel import rdb_trunk

        body = _nchw(rdb_trunk(_nhwc(fea).contiguous(), params["rdb"]))
    elif variant in ("dense", "scatter"):
        rdb_fn = _rdb_scatter if variant == "scatter" else _rdb
        t = fea
        for g in range(spec.num_rrdb):
            u = t
            for j in range(spec.num_rdb_per_rrdb):
                pj = {k: v[g, j] for k, v in params["rdb"].items()}
                t = rdb_fn(t, pj, storage_dtype, od)
            t = (RESIDUAL_SCALE * t.float() + u.float()).to(storage_dtype)
        body = t
    else:
        raise ValueError(f"unknown variant {variant!r}")
    return _nhwc(_tail(params, fea, body, spec, storage_dtype, od))


def _oihw(w) -> np.ndarray:
    """HWIO ``[..., kh, kw, cin, cout]`` -> OIHW ``[..., cout, cin, kh, kw]``."""
    w = np.asarray(w, np.float32)
    return np.ascontiguousarray(np.moveaxis(w, (-1, -2), (-4, -3)))


def params_from_jax(params_np: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX package's stacked HWIO tree -> this package's OIHW tree
    (numpy). Weights are the keys ``w``, ``w1..w5`` and ``sw0..sw4``."""
    return {
        group: {
            k: _oihw(v) if k.startswith(("w", "sw")) else np.asarray(v, np.float32)
            for k, v in tree.items()
        }
        for group, tree in params_np.items()
    }


def init_rrdbnet_params(spec: RRDBNetSpec, seed: int = 0) -> Dict[str, Any]:
    """Random (deterministic) OIHW parameters: the same draws as the JAX
    package's ``init_rrdbnet_params``, so one seed gives the same weights."""
    rng = np.random.default_rng(seed)
    nf, gc = spec.nf, spec.gc

    def conv(cin, cout, *lead):
        w = rng.normal(0, 0.05, size=(*lead, 3, 3, cin, cout)).astype(np.float32)
        b = rng.normal(0, 0.01, size=(*lead, cout)).astype(np.float32)
        return w, b

    nb = (spec.num_rrdb, spec.num_rdb_per_rrdb)
    rdb = {}
    for i, cin in enumerate((nf, nf + gc, nf + 2 * gc, nf + 3 * gc, nf + 4 * gc), 1):
        rdb[f"w{i}"], rdb[f"b{i}"] = conv(cin, gc if i < 5 else nf, *nb)
    upw, upb = conv(nf, nf, spec.num_upsample)
    fw, fb = conv(spec.in_ch, nf)
    tw, tb = conv(nf, nf)
    hw, hb = conv(nf, nf)
    lw, lb = conv(nf, spec.out_ch)
    return params_from_jax({
        "conv_first": {"w": fw, "b": fb},
        "rdb": rdb,
        "trunk": {"w": tw, "b": tb},
        "up": {"w": upw, "b": upb},
        "hr": {"w": hw, "b": hb},
        "last": {"w": lw, "b": lb},
    })
