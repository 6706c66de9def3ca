"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases (each prints its lines; any failure exits non-zero):

1. card: ``torch.cuda.get_device_name`` and nvidia-smi's name and power limit;
2. build: the fused RDB kernel from ``realsr_tpu_torch/csrc`` with nvcc;
3. kernel against its plain PyTorch version at the main path's shape (8 tiles
   of 148 x 148 = tile 128 + 2 x 10 halo, nf = 64, gc = 32): one RDB in mixed
   and float32 mode, and the 69-RDB trunk with the RRDB residual, with
   CUDA-event times of both;
4. the main path: ``realsr_tpu_torch.cli.main`` on three images with the
   committed DF2K graph (23 RRDB, nf = 64, gc = 32) and synthesized weights,
   checking the outputs and that the trunk ran on the kernel (69 launches
   per chunk);
5. numerics: mixed (kernel) against float32 (plain trunk) by PSNR, held to
   the plain mixed path's PSNR, on uniform noise and on an image with a
   natural 1/f spectrum; the float32 kernel against float32 plain by
   identical u8 pixels;
6. steady state: device-resident ``RealSR.process_device`` on one 1024 x 768
   image for each engine mode, and one profiled image's device time by
   kernel group.

Every conv of the run computes with TF32 off (the plain versions' float32
contract), except the one steady-state row that leaves cuDNN's default, as
a fresh CLI process in mixed mode does.

The last line is ``{"ok": true, "device": {...}}``. Imports no JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

B, SIDE, NF, GC = 8, 148, 64, 32
# max|kernel - plain| <= TOL * max(1, max|plain|). float32: only the order of
# the sums differs. mixed: c1..c4 are rounded to bfloat16, and where the two
# f32 sums straddle a rounding boundary they round one bf16 ulp (2^-8
# relative) apart, which reaches the output through the later convs and the
# 0.2 residual scale; 1e-3 covers that, as it covers 69 chained RDBs.
RDB_TOL = {"float32": 1e-4, "mixed": 1e-3}
TRUNK_TOL = 1e-3
# mixed vs float32 PSNR. The project's parity band (README) is reported; with
# the synthesized weights the JAX package's own mixed mode stays below it on
# both of phase 5's inputs (41.52 dB on the noise, 46.13 dB on the 1/f image,
# on the CPU). What is gated is that the kernel adds no error beyond the
# mixed formulation: its PSNR against float32 stays within PSNR_SLACK of the
# plain mixed path's.
PSNR_BAND = 50.0
PSNR_SLACK = 1.0
SAME_MIN = 0.999  # float32 kernel vs float32 plain: share of equal u8 values
STEADY_HW = (768, 1024)  # phase 6 image


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def cuda_ms(fn, warmup: int, reps: int, groups: int = 3) -> float:
    """Milliseconds per ``fn()`` call: CUDA events around ``reps`` calls in
    a row (so the device never waits for the host between them), median
    over ``groups`` such runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(max abs diff, max abs diff / max(1, max |want|))."""
    d = (got.float() - want.float()).abs().max().item()
    return d, d / max(1.0, want.float().abs().max().item())


def plain_trunk(rk, x, stacked):
    """The trunk through the plain RDB (rk.rdb_trunk's schedule)."""
    t = u = x
    for k in range(stacked["w"].shape[0]):
        if k % 3 == 0:
            u = t
        pk = {"w": stacked["w"][k], "b": stacked["b"][k]}
        t = rk.rdb_reference(t, pk, x.dtype, pk["w"].dtype, u if k % 3 == 2 else None)
    return t


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(255.0**2 / mse))


def natural_image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """u8 RGB with a natural image's 1/f amplitude spectrum and seeded
    random phases: a stand-in for a photo, whose energy sits at low
    frequencies, where uniform noise has none."""
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    amp = 1.0 / np.maximum(np.hypot(fy, fx), 1.0 / max(h, w))

    def field():
        f = np.fft.irfft2(amp * np.exp(2j * np.pi * rng.random(amp.shape)), (h, w))
        return (f - f.mean()) / f.std()

    base = field()
    img = np.stack([base + 0.3 * field() for _ in range(3)], -1)
    return np.clip(np.floor(127.5 + 45.0 * img + 0.5), 0, 255).astype(np.uint8)


def u8_same(a: np.ndarray, b: np.ndarray) -> tuple:
    """(share of equal values, max abs diff) of two u8 arrays."""
    d = np.abs(a.astype(int) - b.astype(int))
    return float(np.mean(d == 0)), int(d.max())


def steady_s(eng, img: np.ndarray) -> float:
    """Seconds per device-resident image: median of 3 after a warm-up."""
    times = []
    for k in range(4):
        t0 = time.perf_counter()
        eng.process_device(img)
        torch.cuda.synchronize()
        if k:
            times.append(time.perf_counter() - t0)
    return float(np.median(times))


def profile_image(eng, img: np.ndarray) -> tuple:
    """One profiled ``process_device``: (wall s, {kernel group: device ms},
    the 4 costliest kernels as (ms, name)) from torch.profiler's kernel rows
    (the rows of aten ops repeat their kernels' time, so only kernel rows
    are summed)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.process_device(img)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups: dict = {}
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        n = e.key.lower()
        ms = e.self_device_time_total / 1e3
        if "rdb_kernel" in n:
            g = "rdb_kernel"
        elif any(s in n for s in ("nchwtonhwc", "nhwctonchw", "transpose")):
            g = "layout transposes"
        elif any(s in n for s in ("conv", "gemm", "xmma", "fprop", "winograd", "fft")):
            g = "cuDNN convs"
        else:
            g = "elementwise and copies"
        groups[g] = groups.get(g, 0.0) + ms
        rows.append((ms, e.key))
    return wall, groups, sorted(rows, reverse=True)[:4]


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA GPU")
    from realsr_tpu_torch.engine import EngineConfig, RealSR
    from realsr_tpu_torch.loader import load_model
    from realsr_tpu_torch.models.rrdbnet import disable_tf32
    from realsr_tpu_torch.ops import build
    from realsr_tpu_torch.ops import rdb_kernel as rk

    disable_tf32()

    # -- 1. card ---------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"card: {name}; nvidia-smi: {smi}; torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)

    # -- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    build.load_library("rdb_kernel")
    print(f"build: rdb_kernel.cu -> {build.build_dir()} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {build.BUILD_SECONDS['rdb_kernel']:.2f} s) "
          f"{card}", flush=True)

    # -- 3. kernel against plain at the main path's shape ----------------
    dev = torch.device("cuda", 0)
    param = os.path.join(ROOT, "models", "models-DF2K", "x4.param")
    work = tempfile.mkdtemp(prefix="realsr_smoke_")
    try:
        model_dir = os.path.join(work, "models-DF2K")
        os.makedirs(model_dir)
        shutil.copyfile(param, os.path.join(model_dir, "x4.param"))
        from realsr_tpu.ncnn.bin import write_weights
        from realsr_tpu.ncnn.param import parse_param_file
        from realsr_tpu_torch.ncnn.synth import synth_weights

        graph = parse_param_file(param)
        write_weights(graph, synth_weights(graph, seed=0, stats="trained"),
                      os.path.join(model_dir, "x4.bin"))
        mparam = os.path.join(model_dir, "x4.param")
        mbin = os.path.join(model_dir, "x4.bin")

        rng = np.random.default_rng(0)
        x = torch.from_numpy(
            rng.normal(0.0, 0.5, (B, SIDE, SIDE, NF)).astype(np.float32)
        ).to(dev)
        results = {}
        for mode, op in (("mixed", torch.bfloat16), ("float32", torch.float32)):
            bundle = load_model(mparam, mbin, torch.float32, op, variant="cuda")
            check(bundle.spec.nf == NF and bundle.spec.gc == GC
                  and bundle.spec.num_rrdb == 23, f"unexpected spec {bundle.spec}")
            stacked = {k: v.to(dev) for k, v in bundle.params["rdb"].items()}
            p0 = {"w": stacked["w"][0], "b": stacked["b"][0]}
            got = rk.rdb_apply(x, p0)
            torch.cuda.synchronize()
            want = rk.rdb_reference(x, p0, torch.float32, op)
            err, rel = rel_err(got, want)
            check(bool(torch.isfinite(got).all()), f"{mode} RDB: non-finite output")
            check(rel <= RDB_TOL[mode],
                  f"{mode} RDB: max|kernel-plain| {err} > {RDB_TOL[mode]} x max(1, max|plain|)")
            ms = cuda_ms(lambda: rk.rdb_apply(x, p0), 2, 10)
            pms = cuda_ms(lambda: rk.rdb_reference(x, p0, torch.float32, op), 2, 10)
            print(f"rdb {mode}: B={B} {SIDE}x{SIDE} nf={NF} gc={GC}: max_abs_err {err:.3e} "
                  f"(rel {rel:.3e} <= {RDB_TOL[mode]}); kernel {ms:.3f} ms, plain {pms:.3f} ms {card}",
                  flush=True)
            results[("rdb", mode)] = (err, ms, pms)

            got = rk.rdb_trunk(x, stacked)
            torch.cuda.synchronize()
            want = plain_trunk(rk, x, stacked)
            err, rel = rel_err(got, want)
            check(bool(torch.isfinite(got).all()), f"{mode} trunk: non-finite output")
            check(rel <= TRUNK_TOL, f"{mode} trunk: relative max diff {rel} > {TRUNK_TOL}")
            check(torch.equal(got, rk.rdb_trunk(x, stacked)),
                  f"{mode} trunk: two runs on the same input differ")
            ms = cuda_ms(lambda: rk.rdb_trunk(x, stacked), 1, 1)
            pms = cuda_ms(lambda: plain_trunk(rk, x, stacked), 1, 1)
            print(f"trunk {mode}: 69 RDB, B={B} {SIDE}x{SIDE}: max_abs_err {err:.3e} "
                  f"(rel {rel:.3e} <= {TRUNK_TOL}), two runs bit-equal; kernel {ms:.3f} ms, plain {pms:.3f} ms "
                  f"{card}", flush=True)
            results[("trunk", mode)] = (err, ms, pms)
            del stacked, p0, got, want, bundle
        del x
        torch.cuda.empty_cache()

        # -- 4. the main path through the CLI ----------------------------
        from PIL import Image

        from realsr_tpu.tiling.planner import plan_tiles
        from realsr_tpu_torch import cli

        in_dir, out_dir = os.path.join(work, "in"), os.path.join(work, "out")
        os.makedirs(in_dir)
        os.makedirs(out_dir)
        noise = rng.integers(0, 256, (192, 256, 3), np.uint8)  # phase 5
        images = {
            "b.png": rng.integers(0, 256, (200, 300, 3), np.uint8),
            "c.png": rng.integers(0, 256, (96, 96, 4), np.uint8),
            "a.png": natural_image(rng, 192, 256),
        }
        for fn, img in images.items():
            Image.fromarray(img).save(os.path.join(in_dir, fn))

        rk.LAUNCHES = 0
        t0 = time.perf_counter()
        rc = cli.main(["-i", in_dir, "-o", out_dir, "-m", model_dir, "-g", "0"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = rk.LAUNCHES
        check(rc == 0, f"cli.main returned {rc}")

        # the CLI's engine: the same default config, so the same tile plan
        engine = RealSR(gpuid=0, config=EngineConfig())
        engine.load(mparam, mbin)
        chunks = 0
        out_mp = 0.0
        for fn, img in images.items():
            h, w, c = img.shape
            path = os.path.join(out_dir, fn)
            check(os.path.isfile(path), f"missing output {path}")
            with Image.open(path) as im:
                out = np.asarray(im)
            check(out.shape == (4 * h, 4 * w, c), f"{fn}: output {out.shape}, want {(4 * h, 4 * w, c)}")
            plan = plan_tiles(w, h, engine.tilesize, engine.prepadding)
            chunks += sum(engine._chunking(len(idx))[1] for idx in plan.buckets.values())
            out_mp += 16 * h * w / 1e6
        check(launches == 69 * chunks and chunks > 0,
              f"rdb_kernel launches {launches} != 69 x {chunks} chunks")
        print(f"main path: cli.main rc 0, 3 images -> 4x outputs (RGBA kept 4 channels), "
              f"tile {engine.tilesize}, {chunks} chunks, {launches} rdb_kernel launches; "
              f"{out_mp:.3f} output MP in {wall:.3f} s = {out_mp / wall:.3f} output MP/s "
              f"(model load and first calls included) {card}", flush=True)

        # -- 5. numerics of the slice ------------------------------------
        plain32 = RealSR(gpuid=0, config=EngineConfig(storage="float32", variant="dense"))
        plain32.load(mparam, mbin)
        plain_mixed = RealSR(gpuid=0, config=EngineConfig(variant="dense"))
        plain_mixed.load(mparam, mbin)
        kern32 = RealSR(gpuid=0, config=EngineConfig(storage="float32"))
        kern32.load(mparam, mbin)
        check(engine.variant == "cuda" and kern32.variant == "cuda", "engine did not pick the kernel")
        for label, img in (("1/f", images["a.png"]), ("noise", noise)):
            ref = plain32.process(img)
            db = psnr(engine.process(img), ref)
            db_plain = psnr(plain_mixed.process(img), ref)
            same, dmax = u8_same(kern32.process(img), ref)
            check(db >= db_plain - PSNR_SLACK,
                  f"{label}: mixed kernel vs float32 {db:.2f} dB, below the plain mixed "
                  f"path's {db_plain:.2f} dB by more than {PSNR_SLACK} dB")
            check(same >= SAME_MIN and dmax <= 1,
                  f"{label}: float32 kernel vs plain: {same:.6f} equal "
                  f"(want >= {SAME_MIN}), max diff {dmax}")
            band = "met" if db >= PSNR_BAND else "not met"
            print(f"numerics 256x192 {label}: vs float32 plain, mixed kernel {db:.2f} dB, "
                  f"mixed plain {db_plain:.2f} dB (kernel within {PSNR_SLACK} dB of plain; "
                  f"the {PSNR_BAND} dB band {band}); float32 kernel vs plain "
                  f"{same * 100:.4f}% equal u8, max diff {dmax} {card}", flush=True)

        # -- 6. steady state, device-resident ----------------------------
        big = natural_image(np.random.default_rng(1), *STEADY_HW)
        big_mp = 16 * STEADY_HW[0] * STEADY_HW[1] / 1e6
        torch.backends.cudnn.allow_tf32 = True  # torch's default
        rows = [("mixed, kernel, cuDNN TF32 allowed (a fresh CLI process)",
                 steady_s(engine, big))]
        wall, groups, top = profile_image(engine, big)
        tf32_out = engine.process(big)
        disable_tf32()
        for label, eng in (("mixed, kernel", engine), ("mixed, plain", plain_mixed),
                           ("float32, kernel", kern32), ("float32, plain", plain32)):
            rows.append((label, steady_s(eng, big)))
        for label, s in rows:
            print(f"steady {STEADY_HW[1]}x{STEADY_HW[0]} RGB, {label}: {s:.4f} s/image, "
                  f"{big_mp / s:.3f} output MP/s {card}", flush=True)
        # any change in the order of the sums moves mixed outputs through
        # the trunk's bf16 roundings; what must hold is the error vs float32
        ref = plain32.process(big)
        db_tf32, db_off = psnr(tf32_out, ref), psnr(engine.process(big), ref)
        same, dmax = u8_same(tf32_out, engine.process(big))
        check(db_tf32 >= db_off - PSNR_SLACK,
              f"mixed kernel with TF32 allowed {db_tf32:.2f} dB vs float32, below TF32 "
              f"off's {db_off:.2f} dB by more than {PSNR_SLACK} dB")
        print(f"steady numerics: mixed kernel vs float32 plain {db_tf32:.2f} dB with TF32 "
              f"allowed, {db_off:.2f} dB with TF32 off; the two agree on {same * 100:.4f}% "
              f"of u8 values, max diff {dmax}", flush=True)
        dev_ms = sum(groups.values())
        if dev_ms:
            parts = ", ".join(f"{g} {ms:.1f} ms ({100 * ms / dev_ms:.1f} %)"
                              for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]))
            print(f"profile of one mixed-kernel image (TF32 allowed): wall {1e3 * wall:.1f} ms "
                  f"under the profiler, kernels {dev_ms:.1f} ms (device idle "
                  f"{100 * (1 - dev_ms / (1e3 * wall)):.1f} %): {parts}; costliest: "
                  + "; ".join(f"{ms:.1f} ms {n[:90]}" for ms, n in top) + f" {card}", flush=True)
        else:
            print("profile: torch.profiler recorded no device time (not measured)", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    src = "realsr_tpu_torch/csrc/rdb_kernel.cu"
    kernels = []
    for what, replaces in (("rdb", "realsr_tpu/ops/rdb_kernel.py:263"),
                           ("trunk", "realsr_tpu/ops/rdb_kernel.py:758")):
        err, ms, pms = results[(what, "mixed")]
        kernels.append({
            "name": "rdb_kernel" if what == "rdb" else "rdb_kernel (69-RDB trunk)",
            "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": pms,
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
