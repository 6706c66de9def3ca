"""Image resize ops with ncnn ``Interp`` numerics (NHWC tensors).

Counterpart of ``realsr_tpu/ops/resize.py``: nearest x2 for the RRDBNet
upsampler, bicubic x4 for the alpha channel with ncnn's cubic
(``A = -0.75``, half-pixel mapping, replicate-clamped borders), and the
generic executor's Interp layer (nearest, bilinear, bicubic), each as two
matmuls with the same numpy interpolation matrices. ``F.interpolate``'s
bicubic differs at the borders, so it is not used.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic_coeffs(fx: np.ndarray, a: float = -0.75) -> np.ndarray:
    """4-tap cubic convolution coefficients, ncnn/OpenCV formulation."""
    fx1 = fx + 1.0
    c0 = ((a * fx1 - 5.0 * a) * fx1 + 8.0 * a) * fx1 - 4.0 * a
    c1 = ((a + 2.0) * fx - (a + 3.0)) * fx * fx + 1.0
    omfx = 1.0 - fx
    c2 = ((a + 2.0) * omfx - (a + 3.0)) * omfx * omfx + 1.0
    c3 = 1.0 - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], axis=-1)


@functools.lru_cache(maxsize=128)
def _resize_matrix(in_size: int, out_size: int, kind: str) -> np.ndarray:
    """Dense [out_size, in_size] interpolation matrix (f32): half-pixel
    mapping ``src = (dst + 0.5) * in/out - 0.5``, taps clamped to the valid
    range (replicate border); nearest takes ``floor(dst * in/out)``, as
    ncnn's resize_*_image do."""
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    m = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    if kind == "nearest":
        idx = np.clip(np.floor(dst * scale).astype(np.int64), 0, in_size - 1)
        m[rows, idx] = 1.0
    elif kind == "bilinear":
        sx = np.floor(src).astype(np.int64)
        fx = src - sx
        for tap, w in ((0, 1.0 - fx), (1, fx)):
            np.add.at(m, (rows, np.clip(sx + tap, 0, in_size - 1)), w)
    elif kind == "bicubic":
        sx = np.floor(src).astype(np.int64)
        coeffs = _cubic_coeffs(src - sx)
        for tap in range(4):
            np.add.at(m, (rows, np.clip(sx - 1 + tap, 0, in_size - 1)), coeffs[:, tap])
    else:
        raise ValueError(f"unknown resize kind {kind!r}")
    return m.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _resize_matrix_on(in_size: int, out_size: int, kind: str, device: torch.device) -> torch.Tensor:
    """:func:`_resize_matrix` on ``device``, uploaded once and never
    evicted: a captured CUDA graph reads it at a fixed address for as long
    as the graph lives, and an upload inside a capture would fail. One
    matrix per (tile side, output side, kind) and device, 1 MB at most for
    the engine's alpha tiles."""
    return torch.from_numpy(_resize_matrix(in_size, out_size, kind)).to(device)


def resize_nhwc(x: torch.Tensor, out_h: int, out_w: int, kind: str) -> torch.Tensor:
    """Separable resize of NHWC ``x`` to (out_h, out_w), computed in
    float32 and returned in ``x``'s dtype; an axis whose size does not
    change is left as it is."""
    n, h, w, c = x.shape
    xf = x.float()
    if out_h != h:
        my = _resize_matrix_on(h, out_h, kind, x.device)
        xf = torch.einsum("oh,nhwc->nowc", my, xf)
    if out_w != w:
        mx = _resize_matrix_on(w, out_w, kind, x.device)
        xf = torch.einsum("ow,nhwc->nhoc", mx, xf)
    return xf.to(x.dtype)


def resize_bicubic(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """ncnn-parity bicubic resize of NHWC ``x``, computed in float32 (the
    alpha channel's 4x, src/realsr.cpp:326-331)."""
    return resize_nhwc(x, out_h, out_w, "bicubic")


def nearest_x2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x of NHWC ``x`` (ncnn Interp 0=1 1=2.0 2=2.0):
    pixel replication."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
