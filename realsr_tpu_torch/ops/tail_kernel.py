"""Fused packed-phase tail: the Python side of ``csrc/tail_kernel.cu``.

Counterpart of ``realsr_tpu/ops/tail_kernel.py``. One CUDA source stands in
for both forms of ``_tail_kernel``: :func:`up2_hr_last_packed` (K6: up2 +
HRconv + conv_last from the four 2x phases that up1 writes) and
:func:`hr_last_packed` (K7: HRconv + conv_last from the sixteen 4x phases).
Both return the 4x image ``[B, 4H, 4W, 3]`` in float32, interleaved.

The kernel is fixed at the graph's tail shape, nf = 64 and 3 outputs, and
has bfloat16 operands only (ROADMAP queue 2 holds float32 instances). Its
weights are packed once at load (:func:`pack_tail_params`): the JAX
package's matrices (:func:`pack_tail_weights`, :func:`up2_weights`) in
mma.sync B-fragment order.

A tensor on the CPU takes the plain PyTorch version (the packed tail's
matmul stages, :func:`up2_hr_last_reference`, :func:`hr_last_reference`);
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict

import numpy as np
import torch

from realsr_tpu_torch.models.rrdbnet import (
    LRELU_SLOPE,
    _hwio,
    conv_phases,
    interleave_phases,
    p1_phases,
    up2_matrices,
    up2_phases,
)

NF = 64  # the tail's channels (x4.param: HRconv 64 -> 64, conv_last 64 -> 3)
OUTC = 3
TC = 8  # conv_last's outputs padded to one n-block of mma.sync
NPH = 16  # 4x4 output phases

# kernel launches per wrapper since the last reset (set the values to 0)
LAUNCHES = {"up2_hr_last_packed": 0, "hr_last_packed": 0}
_COUNT_LOCK = threading.Lock()


def up2_weights(w_up2: np.ndarray, b_up2: np.ndarray):
    """OIHW up2 weights -> the JAX package's K6 up2 operands (numpy f32):
    ``w2`` ``[4, 64, 256]`` (entry ``2c + d``: rows cout, columns tap-major
    x cin) and ``b2`` ``[64, 1]``."""
    w = torch.from_numpy(np.asarray(w_up2, np.float32))
    w2 = up2_matrices(_hwio(w)).transpose(1, 2).contiguous().numpy()
    return w2, np.asarray(b_up2, np.float32).reshape(-1, 1)


def pack_tail_weights(w_hr, b_hr, w_last, b_last):
    """OIHW HRconv and conv_last weights -> the JAX package's
    ``pack_tail_weights`` layouts (numpy f32): ``w1`` ``[64, 576]`` (rows
    cout, columns tap-major x cin), ``b1`` ``[64, 1]``, ``w9`` ``[9 * TC,
    64]`` (rows tap-major x padded cout) and ``b3`` ``[TC, 1]``."""
    w_hr = np.asarray(w_hr, np.float32)
    w_last = np.asarray(w_last, np.float32)
    nf = w_hr.shape[0]
    w1 = np.transpose(w_hr, (0, 2, 3, 1)).reshape(nf, 9 * nf)
    w9t = np.transpose(w_last, (2, 3, 0, 1))  # [3, 3, cout, cin]
    w9 = np.pad(w9t, ((0, 0), (0, 0), (0, TC - w_last.shape[0]), (0, 0))).reshape(9 * TC, nf)
    b3 = np.pad(np.asarray(b_last, np.float32), (0, TC - w_last.shape[0])).reshape(TC, 1)
    return w1, np.asarray(b_hr, np.float32).reshape(nf, 1), w9, b3


@functools.lru_cache(maxsize=8)
def _frag_perm(k: int, n: int) -> np.ndarray:
    """Index map from a dense row-major ``[k, n]`` matrix (K x N) to the
    kernel's fragment order, ``packed = dense.ravel()[perm]``: k-steps of
    16 rows, each holding ``n / 8`` mma.sync B fragments of 32 lanes x 4
    values; lane ``4 g + t`` holds rows ``2t, 2t + 1, 2t + 8, 2t + 9`` of
    column ``g``."""
    ks, nb, g, t, h, e = np.meshgrid(
        *(np.arange(s) for s in (k // 16, n // 8, 8, 4, 2, 2)), indexing="ij"
    )
    return ((ks * 16 + h * 8 + t * 2 + e) * n + nb * 8 + g).ravel()


def _frag(dense: np.ndarray, op_dtype) -> torch.Tensor:
    perm = _frag_perm(*dense.shape)
    return torch.from_numpy(np.ascontiguousarray(dense.ravel()[perm])).to(op_dtype)


def _unfrag(packed: torch.Tensor, k: int, n: int) -> torch.Tensor:
    dense = torch.empty_like(packed)
    dense[torch.from_numpy(_frag_perm(k, n)).to(packed.device)] = packed
    return dense.reshape(k, n)


def pack_tail_params(params: Dict[str, np.ndarray], op_dtype=torch.bfloat16):
    """The graph's OIHW ``up``, ``hr`` and ``last`` groups -> the kernels'
    operands as CPU tensors: ``w2`` (the four up2 tap-sum matrices), ``w1``
    (HRconv) and ``w9`` (conv_last, outputs padded to 8), each K x N in
    fragment order at ``op_dtype``, with float32 biases ``b2`` ``[64]``,
    ``b1`` ``[64]`` and ``b3`` ``[8]``. The tap sums are taken in float32,
    then rounded, as the JAX package does."""
    w2, b2 = up2_weights(params["up"]["w"][1], params["up"]["b"][1])
    w1, b1, w9, b3 = pack_tail_weights(
        params["hr"]["w"], params["hr"]["b"], params["last"]["w"], params["last"]["b"]
    )
    w9_kn = w9.reshape(9, TC, NF).transpose(0, 2, 1).reshape(9 * NF, TC)
    return {
        "w2": torch.cat([_frag(np.ascontiguousarray(w.T), op_dtype) for w in w2]),
        "b2": torch.from_numpy(b2.ravel().copy()),
        "w1": _frag(np.ascontiguousarray(w1.T), op_dtype),
        "b1": torch.from_numpy(b1.ravel().copy()),
        "w9": _frag(w9_kn, op_dtype),
        "b3": torch.from_numpy(b3.ravel().copy()),
    }


def _dense(tp):
    """:func:`pack_tail_params` -> dense K x N matrices (the operand type)."""
    w2 = tp["w2"].reshape(4, -1)
    return (
        torch.stack([_unfrag(w, 4 * NF, NF) for w in w2]),
        _unfrag(tp["w1"], 9 * NF, NF),
        _unfrag(tp["w9"], 9 * NF, TC),
    )


def _hr_last_phases(P2, tp, w1, w9):
    od = w1.dtype
    z = conv_phases(P2, w1, tp["b1"], LRELU_SLOPE, od, od)
    return interleave_phases(conv_phases(z, w9, tp["b3"], None, od, None))[..., :OUTC]


def up2_hr_last_reference(p1: torch.Tensor, tp) -> torch.Tensor:
    """Plain PyTorch version of K6: ``p1`` as up1 writes it (``[B, H + 1,
    W + 1, 4 * 64]``, :func:`realsr_tpu_torch.models.rrdbnet.up1_phases`)
    -> ``[B, 4H, 4W, 3]`` float32. Operands are rounded to the weights'
    dtype, P2 and z too; sums are float32."""
    w2, w1, w9 = _dense(tp)
    P2 = up2_phases(p1_phases(p1, NF), w2, tp["b2"], w1.dtype, w1.dtype)
    return _hr_last_phases(P2, tp, w1, w9)


def hr_last_reference(p2: torch.Tensor, tp) -> torch.Tensor:
    """Plain PyTorch version of K7: ``p2`` ``[B, H, W, 16 * 64]``, phase
    (P, Q) in channels ``(4P + Q) * 64 ...`` -> ``[B, 4H, 4W, 3]``."""
    _, w1, w9 = _dense(tp)
    P2 = [[p2[..., (4 * p + q) * NF : (4 * p + q + 1) * NF] for q in range(4)] for p in range(4)]
    return _hr_last_phases(P2, tp, w1, w9)


def _library():
    from realsr_tpu_torch.ops.build import load_library

    lib = load_library("tail_kernel")
    if not getattr(lib, "_realsr_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.tail_launch.argtypes = [vp] * 8 + [ci] * 4 + [vp]
        lib.tail_launch.restype = ci
        lib.tail_error_string.argtypes = [ci]
        lib.tail_error_string.restype = ctypes.c_char_p
        lib._realsr_bound = True
    return lib


def _check(fn, name, t, device, dtype, numel):
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, the input on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{fn}: {name} is {t.dtype}, expected {dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{fn}: {name} must be contiguous and 16-byte aligned")
    if t.numel() != numel:
        raise ValueError(f"{fn}: {name} has {t.numel()} elements, expected {numel}")


def _launch(fn, x, tp, with_up2):
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"{fn}: the tail kernel has bfloat16 operands only, got {x.dtype} "
            "(ROADMAP queue 2: float32 instances of the tail and RDB kernels)"
        )
    cin = 4 * NF if with_up2 else NPH * NF
    if x.dim() != 4 or x.shape[-1] != cin:
        raise ValueError(f"{fn}: expected [B, H, W, {cin}], got {tuple(x.shape)}")
    B, H, W = x.shape[0], x.shape[1] - with_up2, x.shape[2] - with_up2
    if H < 1 or W < 1:
        raise ValueError(f"{fn}: empty tile {tuple(x.shape)}")
    _check(fn, "x", x, x.device, torch.bfloat16, x.numel())
    sizes = {"w1": 9 * NF * NF, "b1": NF, "w9": 9 * NF * TC, "b3": TC}
    if with_up2:
        sizes.update(w2=4 * 4 * NF * NF, b2=NF)
    for k, n in sizes.items():
        _check(fn, k, tp[k], x.device, torch.float32 if k[0] == "b" else torch.bfloat16, n)
    out = torch.empty((B, 4 * H, 4 * W, OUTC), dtype=torch.float32, device=x.device)
    lib = _library()
    ptr = lambda k: tp[k].data_ptr() if k in sizes else None  # noqa: E731
    with torch.cuda.device(x.device):
        err = lib.tail_launch(
            x.data_ptr(), ptr("w2"), ptr("b2"), ptr("w1"), ptr("b1"), ptr("w9"), ptr("b3"),
            out.data_ptr(), B, H, W, int(with_up2),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"tail_kernel launch failed: {lib.tail_error_string(err).decode()} "
            f"({fn}, B={B}, H={H}, W={W})"
        )
    with _COUNT_LOCK:
        LAUNCHES[fn] += 1
    return out


def up2_hr_last_packed(p1: torch.Tensor, tp: Dict[str, torch.Tensor]) -> torch.Tensor:
    """K6: up2 + HRconv + conv_last from ``p1`` ``[B, H + 1, W + 1, 256]``
    (up1's phase layout) -> ``[B, 4H, 4W, 3]`` float32. ``tp``:
    :func:`pack_tail_params` on ``p1``'s device."""
    if p1.device.type == "cpu":
        return up2_hr_last_reference(p1, tp)
    return _launch("up2_hr_last_packed", p1, tp, True)


def hr_last_packed(p2: torch.Tensor, tp: Dict[str, torch.Tensor]) -> torch.Tensor:
    """K7: HRconv + conv_last from ``p2`` ``[B, H, W, 1024]`` (16 phases
    of 64 channels) -> ``[B, 4H, 4W, 3]`` float32."""
    if p2.device.type == "cpu":
        return hr_last_reference(p2, tp)
    return _launch("hr_last_packed", p2, tp, False)
