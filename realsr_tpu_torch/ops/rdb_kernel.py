"""Fused residual dense block: the Python side of ``csrc/rdb_kernel.cu``.

Counterpart of ``realsr_tpu/ops/rdb_kernel.py``: one CUDA kernel stands in
for both ``_rdb_kernel`` (one RDB per call) and ``_rdb_resident_kernel`` (the
whole trunk with the RRDB residual folded in). :func:`rdb_apply` launches it
for one RDB, optionally with the RRDB residual ``0.2 * y + u`` in its
epilogue; :func:`rdb_trunk` drives the 69-RDB trunk as 69 launches.

Tensors are NHWC. The state dtype is ``x``'s dtype; the operand dtype is the
packed weights' dtype (:func:`pack_rdb_params`). Supported pairs: float32 /
float32 (CUDA cores, nf and gc multiples of 8), and float32 state with
bfloat16 operands (mixed) or bfloat16 / bfloat16 (tensor cores, nf, gc = 64,
32 or 32, 16).

A tensor on the CPU takes the plain PyTorch version (:func:`rdb_reference`);
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Optional

import numpy as np
import torch

from realsr_tpu_torch.models.rrdbnet import RESIDUAL_SCALE, _rdb

# kernel launches since the last reset (set to 0 to reset)
LAUNCHES = 0
_COUNT_LOCK = threading.Lock()

_DTYPE_PAIRS = {
    (torch.float32, torch.float32): (0, 0),
    (torch.float32, torch.bfloat16): (0, 1),
    (torch.bfloat16, torch.bfloat16): (1, 1),
}
# (nf, gc) the tensor-core kernel is instantiated for
_TC_SHAPES = ((64, 32), (32, 16))


@functools.lru_cache(maxsize=8)
def _mma_perm(nf: int, gc: int) -> np.ndarray:
    """Index map from the dense layout (each conv as ``[cin][3][3][cout]``)
    to the tensor-core kernel's fragment order: ``packed = dense[perm]``.

    Per conv, k-steps run over (source, tap, 16-channel block) in the order
    the kernel walks them; each k-step holds ``cout / 8`` mma.sync B
    fragments of 32 lanes x 4 values: lane ``4 * g + t`` holds rows
    ``2t, 2t + 1, 2t + 8, 2t + 9`` of column ``g``.
    """
    if nf % 16 or gc % 16:
        raise ValueError(f"bfloat16 operands need nf, gc multiples of 16 (got {nf}, {gc})")
    parts = []
    off, cin = 0, nf
    for i in range(1, 6):
        cout = gc if i < 5 else nf
        nb, g, t, h, e = np.meshgrid(
            *(np.arange(n) for n in (cout // 8, 8, 4, 2, 2)), indexing="ij"
        )
        co = (nb * 8 + g).ravel()
        k = (h * 8 + t * 2 + e).ravel()
        for j in range(i):
            kbase, cj = (0, nf) if j == 0 else (nf + (j - 1) * gc, gc)
            for tap in range(9):
                for kb in range(cj // 16):
                    parts.append(off + ((kbase + kb * 16 + k) * 9 + tap) * cout + co)
        off += cin * 9 * cout
        cin += gc
    return np.concatenate(parts)


@functools.lru_cache(maxsize=8)
def _mma_perm_on(nf: int, gc: int, device: torch.device) -> torch.Tensor:
    """:func:`_mma_perm` as an index tensor on ``device``."""
    return torch.from_numpy(_mma_perm(nf, gc)).to(device)


def pack_rdb_params(rdb: Dict[str, np.ndarray], op_dtype=torch.float32):
    """Dense OIHW RDB params -> the kernel's layout.

    ``rdb``: ``w1..w5`` ``[..., cout, cin, 3, 3]`` and ``b1..b5``
    ``[..., cout]`` (numpy; any leading dims, e.g. the trunk's
    ``[num_rrdb, 3]``). Returns ``{"w": [..., K] op_dtype, "b": [..., 4gc+nf]
    float32}`` as CPU tensors, where ``w`` holds the five convs back to back,
    each as ``[cin][3][3][cout]`` for float32 operands, and in the
    tensor-core fragment order (:func:`_mma_perm`) for bfloat16.
    """
    ws, bs = [], []
    for i in range(1, 6):
        w = np.moveaxis(np.asarray(rdb[f"w{i}"], np.float32), -4, -1)
        ws.append(w.reshape(*w.shape[:-4], -1))
        bs.append(np.asarray(rdb[f"b{i}"], np.float32))
    w = np.concatenate(ws, -1)
    if op_dtype == torch.bfloat16:
        gc, nf = np.shape(rdb["w1"])[-4:-2]
        w = w[..., _mma_perm(nf, gc)]
    return {
        "w": torch.from_numpy(np.ascontiguousarray(w)).to(op_dtype),
        "b": torch.from_numpy(np.concatenate(bs, -1)),
    }


def unpack_rdb_params(p: Dict[str, torch.Tensor], nf: int) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`pack_rdb_params` for one RDB: OIHW tensors."""
    w, b = p["w"], p["b"]
    gc = (b.shape[-1] - nf) // 4
    if w.dtype == torch.bfloat16:
        dense = torch.empty_like(w)
        dense[_mma_perm_on(nf, gc, w.device)] = w
        w = dense
    out = {}
    off, cin = 0, nf
    for i in range(1, 6):
        cout = gc if i < 5 else nf
        n = cin * 9 * cout
        out[f"w{i}"] = w[off : off + n].reshape(cin, 3, 3, cout).permute(3, 0, 1, 2)
        out[f"b{i}"] = b[(i - 1) * gc : (i - 1) * gc + cout]
        off += n
        cin += gc
    return out


def rdb_reference(x, p, storage_dtype, op_dtype, u=None):
    """Plain PyTorch version of the kernel: one RDB on NHWC ``x``.

    Operands are rounded to ``op_dtype`` and convolved in float32. With TF32
    off (:func:`~realsr_tpu_torch.models.rrdbnet.tf32`) on a GPU, it
    differs from the kernel on the same inputs only in the order of the sums.
    """
    w = unpack_rdb_params(p, x.shape[-1])
    y = _rdb(x.permute(0, 3, 1, 2), w, storage_dtype, op_dtype)
    if u is not None:
        y = (RESIDUAL_SCALE * y.float() + u.permute(0, 3, 1, 2).float()).to(
            storage_dtype
        )
    return y.permute(0, 2, 3, 1).contiguous()


def _library():
    from realsr_tpu_torch.ops.build import load_library

    lib = load_library("rdb_kernel")
    if not getattr(lib, "_realsr_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.rdb_launch.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp]
        lib.rdb_launch.restype = ci
        lib.rdb_error_string.argtypes = [ci]
        lib.rdb_error_string.restype = ctypes.c_char_p
        lib._realsr_bound = True
    return lib


def _check(name, t, device, dtype, numel=None, shape=None):
    if t.device != device:
        raise ValueError(f"rdb_apply: {name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise ValueError(f"rdb_apply: {name} is {t.dtype}, expected {dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"rdb_apply: {name} must be contiguous and 16-byte aligned")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"rdb_apply: {name} has {t.numel()} elements, expected {numel}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"rdb_apply: {name} has shape {tuple(t.shape)}, expected {shape}")


def rdb_apply(x: torch.Tensor, p: Dict[str, torch.Tensor], u: Optional[torch.Tensor] = None):
    """One RDB on NHWC ``x`` ``[B, H, W, nf]`` -> a new tensor like ``x``.

    ``p``: one RDB of :func:`pack_rdb_params`. ``u`` (same shape and dtype as
    ``x``): fold the RRDB residual ``0.2 * y + u`` into the output.
    """
    global LAUNCHES
    w, b = p["w"], p["b"]
    if x.device.type == "cpu":
        return rdb_reference(x, p, x.dtype, w.dtype, u)
    if x.device.type != "cuda":
        raise ValueError(f"rdb_apply: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"rdb_apply: x must be [B, H, W, nf], got {tuple(x.shape)}")
    B, H, W, nf = x.shape
    gc = (b.numel() - nf) // 4
    pair = _DTYPE_PAIRS.get((x.dtype, w.dtype))
    if pair is None:
        raise ValueError(f"rdb_apply: no kernel for state {x.dtype} / operands {w.dtype}")
    if nf % 8 or gc <= 0 or gc % 8 or b.numel() != nf + 4 * gc:
        raise ValueError(f"rdb_apply: nf={nf}, gc={gc} must be positive multiples of 8")
    if w.dtype == torch.bfloat16 and (nf, gc) not in _TC_SHAPES:
        raise ValueError(f"rdb_apply: no tensor-core kernel for nf={nf}, gc={gc}")
    k = 9 * sum((nf + i * gc) * (gc if i < 4 else nf) for i in range(5))
    _check("x", x, x.device, x.dtype)
    _check("w", w, x.device, w.dtype, numel=k)
    _check("b", b, x.device, torch.float32, numel=nf + 4 * gc)
    if u is not None:
        _check("u", u, x.device, x.dtype, shape=x.shape)
    out = torch.empty_like(x)
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.rdb_launch(
            x.data_ptr(), w.data_ptr(), b.data_ptr(),
            None if u is None else u.data_ptr(), out.data_ptr(),
            B, H, W, nf, gc, *pair,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"rdb_kernel launch failed: {lib.rdb_error_string(err).decode()} "
            f"(B={B}, H={H}, W={W}, nf={nf}, gc={gc}, {x.dtype} / {w.dtype})"
        )
    with _COUNT_LOCK:
        LAUNCHES += 1
    return out


def rdb_trunk(x: torch.Tensor, stacked: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The RRDB trunk: ``stacked["w"]`` / ``["b"]`` are ``[n_rdb, ...]``
    (:func:`pack_rdb_params` with the ``[num_rrdb, 3]`` lead dims merged).
    The RRDB residual ``0.2 * y + u`` folds into every third RDB, ``u`` being
    the state that entered its RRDB (x4.param's Eltwise coeffs [0.2, 1.0])."""
    t = x
    u = x
    for k in range(stacked["w"].shape[0]):
        if k % 3 == 0:
            u = t
        pk = {"w": stacked["w"][k], "b": stacked["b"][k]}
        t = rdb_apply(t, pk, u if k % 3 == 2 else None)
    return t
