"""Measure the tile pick's cost anchors (``planner._RATE_ANCHORS``) on the card.

Counterpart of ``tools/calibrate_planner.py``. Protocol: the default
engine's forward (``RealSR._forward``: mixed mode, the K1 trunk and the K6
tail unless the environment picks otherwise) on chunks of padded tiles at
each anchor side, each at the chunk batch the engine gives that tile
(``_auto_batch``: 8 x 148², 8 x 212², 6 x 276² in mixed mode), timed with
CUDA events in interleaved rounds, the median per side. Costs are per padded
pixel, relative to the first side. Prints them in ``REALSR_TPU_RATE_ANCHORS``
form beside the shipped table; ``--save`` writes the calibration file the
planner reads when the environment override is absent
(``planner._anchor_file``).

Run on the card: ``python -m realsr_tpu_torch.tiling.calibrate [-m
model-dir] [--save]`` (without ``-m``, the committed DF2K graph with
synthesized weights: the anchors time the work, not the weights' values).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

SIDES = (148, 212, 276)  # padded sides of tiles 128 / 192 / 256 at halo 10
ROUNDS, REPS = 5, 2  # interleaved rounds; forwards per timed group


def measure(engine) -> dict:
    """{side: (chunk batch, ms per chunk, us per padded pixel)} for ``engine``'s
    forward at each of SIDES, at the engine's chunk batch for that tile."""
    import torch

    dev = engine.device.torch_device
    gen = torch.Generator().manual_seed(0)
    xs = {}
    for side in SIDES:
        b = engine._auto_batch(side - 2 * engine.prepadding)
        xs[side] = torch.rand((b, side, side, 3), generator=gen).to(dev, engine.storage_dtype)
    times: dict = {side: [] for side in SIDES}
    with torch.no_grad():
        for side in SIDES:  # first calls (kernel builds, cuDNN's first plans) excluded
            engine._forward(xs[side])
        torch.cuda.synchronize(dev)
        for _ in range(ROUNDS):
            for side in SIDES:  # interleaved
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(REPS):
                    engine._forward(xs[side])
                end.record()
                end.synchronize()
                times[side].append(start.elapsed_time(end) / REPS)
    out = {}
    for side in SIDES:
        b = xs[side].shape[0]
        ms = float(np.median(times[side]))
        out[side] = (b, ms, 1e3 * ms / (b * side * side))
    return out


def anchors_spec(measured: dict) -> str:
    """The REALSR_TPU_RATE_ANCHORS value of a :func:`measure` result."""
    base = measured[SIDES[0]][2]
    return ",".join(f"{side}:{measured[side][2] / base:.3f}" for side in SIDES)


def _model_files(model_dir: str, work: str) -> tuple:
    if model_dir:
        return os.path.join(model_dir, "x4.param"), os.path.join(model_dir, "x4.bin")
    from realsr_tpu_torch.ncnn.bin import write_weights
    from realsr_tpu_torch.ncnn.param import parse_param_file
    from realsr_tpu_torch.ncnn.synth import synth_weights

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    param = os.path.join(root, "models", "models-DF2K", "x4.param")
    graph = parse_param_file(param)
    binpath = os.path.join(work, "x4.bin")
    write_weights(graph, synth_weights(graph, seed=0, stats="trained"), binpath)
    return param, binpath


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-m", "--model", default="", help="model dir with x4.param / x4.bin")
    ap.add_argument("-g", "--gpu", type=int, default=0)
    ap.add_argument("--save", action="store_true", help="write the planner's calibration file")
    args = ap.parse_args(argv)

    import torch

    from realsr_tpu_torch.engine import EngineConfig, RealSR
    from realsr_tpu_torch.tiling import planner

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device; the anchors are measured on the card", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as work:
        engine = RealSR(gpuid=args.gpu, config=EngineConfig())
        engine.load(*_model_files(args.model, work))
        measured = measure(engine)
    kind = torch.cuda.get_device_name(args.gpu)
    spec = anchors_spec(measured)
    for side, (b, ms, us) in measured.items():
        print(f"side {side}: {b} tiles a chunk, {ms:.3f} ms a chunk, {us:.4f} us per padded pixel")
    print(f"measured on {kind}: REALSR_TPU_RATE_ANCHORS=\"{spec}\"")
    print(f"shipped ({planner._ANCHOR_DEVICE}): " + ",".join(f"{s}:{r}" for s, r in planner._RATE_ANCHORS))
    if args.save:
        path = planner._anchor_file()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"anchors": spec, "us_per_px": {s: m[2] for s, m in measured.items()},
                       "device_kind": kind}, f)
        print(f"saved calibration to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
