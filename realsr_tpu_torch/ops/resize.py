"""Image resize ops with ncnn ``Interp`` numerics (NHWC tensors).

Counterpart of ``realsr_tpu/ops/resize.py``: nearest x2 for the RRDBNet
upsampler, and bicubic x4 for the alpha channel with ncnn's cubic
(``A = -0.75``, half-pixel mapping, replicate-clamped borders) as two
matmuls with the same numpy interpolation matrix. ``F.interpolate``'s
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
def _bicubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense [out_size, in_size] bicubic interpolation matrix (f32):
    ``src = (dst + 0.5) * in/out - 0.5``, taps clamped to the valid range."""
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    sx = np.floor(src).astype(np.int64)
    coeffs = _cubic_coeffs(src - sx)
    m = np.zeros((out_size, in_size), dtype=np.float64)
    for tap in range(4):
        idx = np.clip(sx - 1 + tap, 0, in_size - 1)
        np.add.at(m, (np.arange(out_size), idx), coeffs[:, tap])
    return m.astype(np.float32)


def resize_bicubic(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """ncnn-parity bicubic resize of NHWC ``x``, computed in float32 (the
    alpha channel's 4x, src/realsr.cpp:326-331)."""
    n, h, w, c = x.shape
    my = torch.from_numpy(_bicubic_matrix(h, out_h)).to(x.device)
    mx = torch.from_numpy(_bicubic_matrix(w, out_w)).to(x.device)
    xf = torch.einsum("oh,nhwc->nowc", my, x.float())
    return torch.einsum("ow,nhwc->nhoc", mx, xf).to(x.dtype)



def nearest_x2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x of NHWC ``x`` (ncnn Interp 0=1 1=2.0 2=2.0):
    pixel replication."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
