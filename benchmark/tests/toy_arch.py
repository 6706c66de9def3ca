"""A second architecture for the harness's tests, dropped in as
``arch/toy.py``: an SRVGG-style net (SRVGGNetCompact's body cut to one conv
and its PReLU) as an ncnn graph that the program runs on its generic
executor.

    conv_first 3 x 3, in_ch -> nf; PReLU (one slope a channel);
    conv_up 3 x 3, nf -> out_ch * scale²; PixelShuffle by ``scale``.

A configuration gives ``nf``, ``in_ch``, ``out_ch`` and ``scale``. The
weights are drawn from the seed, conv_up's bias at mid-grey so that the
u8 check compares values that are not clipped.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from benchmark.ncnn import NCNN_MAGIC, macs_per_input_px, parse_convs
from benchmark.reference.precision import fp8
from benchmark.weights import STREAM_WEIGHTS, generator

QUANT = fp8  # the configuration's bf16 operands, one step down


def _param_text(cfg: dict) -> str:
    nf, cin, cup = cfg["nf"], cfg["in_ch"], cfg["out_ch"] * cfg["scale"] ** 2
    return "\n".join([
        str(NCNN_MAGIC), "5 5",
        "Input data 0 1 data",
        f"Convolution conv_first 1 1 data c1 0={nf} 1=3 4=1 5=1 6={nf * cin * 9}",
        f"PReLU prelu 1 1 c1 p1 0={nf}",
        f"Convolution conv_up 1 1 p1 c2 0={cup} 1=3 4=1 5=1 6={cup * nf * 9}",
        f"PixelShuffle shuffle 1 1 c2 out 0={cfg['scale']}",
    ]) + "\n"


def describe(cfg: dict, cfg_dir: str) -> dict:
    return {"scale": cfg["scale"], "macs_per_input_px": macs_per_input_px(parse_convs(_param_text(cfg)))}


def weights(cfg: dict, seed: int, device) -> dict:
    g = generator(seed, STREAM_WEIGHTS, device)
    nf, cin, cup = cfg["nf"], cfg["in_ch"], cfg["out_ch"] * cfg["scale"] ** 2
    return {
        "w1": torch.randn(nf, cin, 3, 3, generator=g, device=device) / (9 * cin) ** 0.5,
        "b1": torch.randn(nf, generator=g, device=device) * 0.05,
        "slope": 0.05 + 0.2 * torch.rand(nf, generator=g, device=device),
        "w2": torch.randn(cup, nf, 3, 3, generator=g, device=device) * 0.5 / (9 * nf) ** 0.5,
        "b2": torch.full((cup,), 0.5, device=device),
    }


def model_files(cfg: dict, weights: dict, workdir: str) -> tuple:
    """The graph's .param and a tag-0 float32 .bin: per conv a zero tag, its
    OIHW weights and bias; the PReLU's slopes raw."""
    param, bin_path = os.path.join(workdir, "toy.param"), os.path.join(workdir, "toy.bin")
    with open(param, "w") as f:
        f.write(_param_text(cfg))
    tag = torch.zeros(1)
    parts = [tag, weights["w1"], weights["b1"], weights["slope"], tag, weights["w2"], weights["b2"]]
    torch.cat([p.cpu().flatten() for p in parts]).numpy().astype("<f4").tofile(bin_path)
    return param, bin_path


def net(cfg: dict, weights: dict, quant=None):
    q = quant or (lambda t: t)

    def forward(x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(q(x), q(weights["w1"]), weights["b1"], padding=1)
        y = torch.where(y >= 0, y, y * weights["slope"][None, :, None, None])
        y = F.conv2d(q(y), q(weights["w2"]), weights["b2"], padding=1)
        return F.pixel_shuffle(y, cfg["scale"])

    return forward
