"""RRDBNet (ESRGAN, Wang et al. 2018; RealSR and Real-ESRGAN's generator)
as plain float32 PyTorch convs in NCHW.

conv_first; ``num_rrdb`` RRDBs of three dense blocks (five 3 x 3 convs,
LeakyReLU 0.2 after the first four, the block's output 0.2 x conv5 + its
input; the RRDB's output 0.2 x its last block's + its input); trunk_conv
added to conv_first's output; per upsampler nearest x2 then a conv with
LeakyReLU; HRconv with LeakyReLU; conv_last. Each conv zero-pads by 1.
The convs come in the .param's order, which is this order.

``quant`` rounds every conv's input and weights before the float32 product:
the lower precision that the control runs (``fp8``).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per tensor (its absolute
    maximum to the format's largest), back in float32."""
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def forward(x: torch.Tensor, layers: list, num_rrdb: int, num_upsample: int, quant=None) -> torch.Tensor:
    """``x`` [B, 3, H, W] float32 in 0..1 -> [B, 3, H * 2**num_upsample, ...];
    ``layers`` [(OIHW weight, bias)] float32 in .param order."""
    expected = 1 + 15 * num_rrdb + 1 + num_upsample + 2
    if len(layers) != expected:
        raise ValueError(f"{len(layers)} convs for {num_rrdb} RRDBs; expected {expected}")
    it = iter(layers)

    def conv(t, act):
        w, b = next(it)
        if quant is not None:
            t, w = quant(t), quant(w)
        y = F.conv2d(t, w, b, padding=1)
        return F.leaky_relu(y, 0.2) if act else y

    fea = conv(x, False)
    cur = fea
    for _ in range(num_rrdb):
        skip = cur
        for _ in range(3):
            feats = [cur]
            for _ in range(4):
                feats.append(conv(torch.cat(feats, 1), True))
            cur = conv(torch.cat(feats, 1), False) * 0.2 + cur
        cur = cur * 0.2 + skip
    cur = fea + conv(cur, False)
    for _ in range(num_upsample):
        cur = conv(F.interpolate(cur, scale_factor=2, mode="nearest"), True)
    return conv(conv(cur, True), False)


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
