"""Operations, bytes and peaks: the arithmetic of the benchmark's model and
kernel metrics.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
power limit): 989 TFLOP/s with bf16 operands, 3.35 TB/s of HBM3. A card
set below 700 W runs slower under load; :func:`power_limit` reads the limit
that every run prints beside its numbers.

A kernel's least time is max(operations / peak, bytes / bandwidth) for the
work the inputs need, whatever implements it: each input byte read once,
each output byte written once.
"""

from __future__ import annotations

import subprocess

PEAK_FLOPS = {"bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12


def rdb_macs_per_px(nf: int, gc: int) -> int:
    """One dense block (five 3 x 3 convs over nf + k * gc channels) per
    pixel it runs on: 239,616 at nf 64, gc 32."""
    cins = [nf + k * gc for k in range(5)]
    couts = [gc] * 4 + [nf]
    return sum(9 * ci * co for ci, co in zip(cins, couts))


def tail_macs_per_out_px(nf: int, out_ch: int) -> int:
    """The last upsampler's conv, HRconv and conv_last per pixel of the
    output they run on, at the least the inputs need: a 3 x 3 conv of a
    nearest-x2 map reads 2 x 2 distinct pixels at each output pixel, so it
    is 4 taps of summed weights (54,976 at nf 64, 3 outputs; 75,456 as the
    graph writes it)."""
    return 4 * nf * nf + 9 * nf * nf + 9 * nf * out_ch


def trunk_work(cfg: dict, padded_px: int, op_bytes: int = 2) -> tuple:
    """(operations, bytes) of the trunk's dense blocks over ``padded_px``
    network-input pixels: per block its products, its input read once as
    operands and once as the float32 residual, its float32 output written
    once."""
    blocks = cfg["num_rrdb"] * 3
    ops = 2 * blocks * rdb_macs_per_px(cfg["nf"], cfg["gc"]) * padded_px
    moved = blocks * padded_px * cfg["nf"] * (op_bytes + 4 + 4)
    return ops, moved


def tail_work(cfg: dict, padded_px: int, op_bytes: int = 2) -> tuple:
    """(operations, bytes) of up2 + HRconv + conv_last over ``padded_px``
    network-input pixels, at scale x scale their count: the first
    upsampler's output read once, the float32 result written once."""
    s = 2 ** cfg["num_upsample"]
    out_px = padded_px * s * s
    ops = 2 * tail_macs_per_out_px(cfg["nf"], cfg["out_ch"]) * out_px
    moved = padded_px * (s // 2) ** 2 * cfg["nf"] * op_bytes + out_px * cfg["out_ch"] * 4
    return ops, moved


def least_seconds(ops: float, moved: float, peak: float = PEAK_FLOPS["bfloat16"]) -> float:
    return max(ops / peak, moved / PEAK_BYTES_PER_S)


def power_limit() -> str:
    """``name, power.limit`` of each card, as nvidia-smi gives them, or the
    reason there is none."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as ex:
        return f"nvidia-smi: {ex}"
    return "; ".join(ln.strip() for ln in out.stdout.splitlines() if ln.strip()) or out.stderr.strip()
