"""Why band streaming runs each band's buckets at the whole image's chunk batch.

``python3 tools/band_batch_probe.py`` on a machine with an NVIDIA GPU (the
DF2K graph at full width, synthetic weights, seed 0): for the mixed and the
float32 engine it runs ``RealSR.process_banded`` on a ragged 1000 x 700 RGBA
image with band-local chunk batches (each band's bucket at its own power of
two, the JAX engine's rule) and compares it with the whole-image run; then it
runs one 148 x 148 tile of a chunk of 8 alone and in chunks of 2 and 4 stage
by stage (conv_first, the K1 trunk, the trunk conv, up1 and the K6 tail) and
reports which stage's output depends on the batch. Prints one JSON line.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from realsr_tpu_torch.engine import EngineConfig, RealSR  # noqa: E402
from realsr_tpu_torch.models import rrdbnet as R  # noqa: E402
from realsr_tpu_torch.ncnn.bin import write_weights  # noqa: E402
from realsr_tpu_torch.ncnn.param import parse_param_file  # noqa: E402
from realsr_tpu_torch.ncnn.synth import synth_weights  # noqa: E402
from realsr_tpu_torch.ops import rdb_kernel as rk  # noqa: E402


def band_local(eng: RealSR, img: np.ndarray, btr: int) -> np.ndarray:
    """``process_banded`` with each band's buckets at their own batch."""
    inner = eng._dispatch_buckets

    def own_batches(padded, alpha, out, buckets, c, cb, done, total, batches=None):
        return inner(padded, alpha, out, buckets, c, cb, done, total)

    eng._dispatch_buckets = own_batches
    try:
        return eng.process_banded(img, band_tile_rows=btr)
    finally:
        del eng._dispatch_buckets


def stages(eng: RealSR, x8: torch.Tensor, b: int) -> dict:
    """Whether each stage's output for the first ``b`` tiles run as a chunk
    of ``b`` equals their rows of the chunk of 8 (same inputs per stage)."""
    p, sd, od = eng._params, eng.storage_dtype, eng.op_dtype
    conv = R.conv3x3
    f8 = conv(R._nchw(x8), p["conv_first"]["w"], p["conv_first"]["b"], None, od).to(sd)
    body8 = R._nchw(rk.rdb_trunk(R._nhwc(f8).contiguous(), p["rdb"]))
    fea8 = (f8.float() + conv(body8, p["trunk"]["w"], p["trunk"]["b"], None, od)).to(sd)
    y1_8 = R.up1_phases(R._nhwc(fea8), p["up"]["w"][0], p["up"]["b"][0], od, sd)
    out8 = R._tail(p, f8, body8, eng.bundle.spec, sd, od, eng.tail)
    f = conv(R._nchw(x8[:b]), p["conv_first"]["w"], p["conv_first"]["b"], None, od).to(sd)
    body = R._nchw(rk.rdb_trunk(R._nhwc(f8[:b]).contiguous(), p["rdb"]))
    tconv = conv(body8[:b], p["trunk"]["w"], p["trunk"]["b"], None, od)
    tconv8 = conv(body8, p["trunk"]["w"], p["trunk"]["b"], None, od)[:b]
    y1 = R.up1_phases(R._nhwc(fea8[:b]), p["up"]["w"][0], p["up"]["b"][0], od, sd)
    out = R._tail(p, f8[:b], body8[:b], eng.bundle.spec, sd, od, eng.tail)
    return {
        "conv_first (cuDNN)": torch.equal(f, f8[:b]),
        "trunk (K1)": torch.equal(body, body8[:b]),
        "trunk conv (cuDNN)": torch.equal(tconv, tconv8),
        "up1 (cuDNN)": torch.equal(y1, y1_8[:b]),
        "tail from the trunk (trunk conv, up1, K6)": torch.equal(out, out8[:b]),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    work = tempfile.mkdtemp(prefix="band_probe_")
    try:
        pp, bp = os.path.join(work, "x4.param"), os.path.join(work, "x4.bin")
        shutil.copyfile(os.path.join(ROOT, "models", "models-DF2K", "x4.param"), pp)
        graph = parse_param_file(pp)
        write_weights(graph, synth_weights(graph, seed=0, stats="trained"), bp)
        img = np.random.default_rng(7).integers(0, 256, (700, 1000, 4), np.uint8)
        x = torch.rand((8, 148, 148, 3), generator=torch.Generator().manual_seed(1))
        res: dict = {"card": smi}
        for storage in ("mixed", "float32"):
            eng = RealSR(gpuid=0, config=EngineConfig(storage=storage))
            eng.load(pp, bp)
            whole = eng.process(img)
            for btr in (1, 2, 3):
                d = np.abs(band_local(eng, img, btr).astype(int) - whole.astype(int))
                res[f"{storage}, band-local batches, {btr} tile rows a band"] = {
                    "bit_equal": bool((d == 0).all()), "equal_u8_share": float((d == 0).mean()),
                    "max_diff": int(d.max())}
            with torch.no_grad(), R.tf32(eng.op_dtype != torch.float32):
                x8 = x.to(eng.device.torch_device, eng.storage_dtype)
                for b in (1, 2, 4):
                    res[f"{storage}, one tile in a chunk of {b} vs of 8"] = stages(eng, x8, b)
        print(json.dumps(res), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
