"""The reference's precision: plain float32 on the card (``no_tf32``), and
the rounding that a control one step below a configuration's precision
applies to every product's operands (``fp8``)."""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0  # largest finite float8 e4m3


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per tensor (its absolute
    maximum to the format's largest), back in float32."""
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


@contextlib.contextmanager
def no_tf32():
    """Plain float32 on the card inside the block: cuDNN and matmuls without
    TF32; the settings before it come back after it."""
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
