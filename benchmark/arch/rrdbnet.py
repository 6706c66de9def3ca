"""RRDBNet (ESRGAN's generator; RealSR and Real-ESRGAN): what the harness
needs of a configuration of this architecture.

A configuration names its ncnn graph (``param``, beside its file) and
``num_rrdb``, ``nf``, ``gc``, ``num_upsample``, ``out_ch``. The weights are
the seed's trained-statistics draw (``weights.trained_weights``), written as
a tag-0 float32 ``.bin`` for that graph; the plain forward is
``reference/rrdbnet.py`` on the same weights. The interface every
``arch/<name>.py`` gives:

- ``describe(cfg, cfg_dir)``: keys the harness and the readers need
  (``scale``, ``macs_per_input_px``) and the architecture's own;
- ``weights(cfg, seed, device)``: the weights, drawn from the seed;
- ``model_files(cfg, weights, workdir)``: the ``(param, bin)`` paths that
  the program's ``RealSR.load`` takes;
- ``net(cfg, weights, quant=None)``: the plain float32 NCHW forward of a
  batch of tiles, every product's operands rounded by ``quant`` where given;
- ``QUANT``: the rounding of the reference's control, one step below the
  configuration's precision;
- ``check_trace(records, cfg)``, optional: a look at a traced run's records.
"""

from __future__ import annotations

import os
import sys

from benchmark.ncnn import macs_per_input_px, parse_convs, write_bin
from benchmark.reference.precision import fp8
from benchmark.reference.rrdbnet import forward
from benchmark.weights import split, trained_weights

QUANT = fp8  # the configurations' bf16 operands, one step down


def describe(cfg: dict, cfg_dir: str) -> dict:
    """The .param's path, its conv list and MACs, and the scale."""
    param = os.path.join(cfg_dir, cfg["param"])
    with open(param) as f:
        convs = parse_convs(f.read())
    return {"param_path": param, "convs": convs, "macs_per_input_px": macs_per_input_px(convs),
            "scale": 2 ** cfg["num_upsample"]}


def weights(cfg: dict, seed: int, device) -> tuple:
    """(weights, biases): float32 device tensors, flat in .param order."""
    return trained_weights(cfg["convs"], seed, device, cfg["num_rrdb"])


def model_files(cfg: dict, weights: tuple, workdir: str) -> tuple:
    bin_path = os.path.join(workdir, "model.bin")
    write_bin(bin_path, cfg["convs"], weights[0].cpu().numpy(), weights[1].cpu().numpy())
    return cfg["param_path"], bin_path


def net(cfg: dict, weights: tuple, quant=None):
    layers = split(cfg["convs"], *weights)
    return lambda x: forward(x, layers, cfg["num_rrdb"], cfg["num_upsample"], quant)


def check_trace(records: dict, cfg: dict) -> None:
    """Say on stderr where the trace lacks rows: every chunk runs one tail
    kernel (K6) and one trunk kernel (K1) a dense block. torch.profiler has
    been seen to drop rows of a graph replay late in a process."""
    names = [n for _, n, _ in records["device"]["kernels"]]
    k1 = sum("rdb_kernel" in n for n in names)
    k6 = sum("tail_kernel" in n for n in names)
    blocks = 3 * cfg["num_rrdb"]
    if k1 != blocks * k6 or k6 < len(records["done"]):
        print(f"benchmark: the trace holds {k1} trunk and {k6} tail kernel rows for {len(records['done'])} "
              f"images: {blocks} trunk rows a tail row and a tail row an image at least were expected",
              file=sys.stderr)
