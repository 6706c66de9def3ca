"""What each design point of the wgmma RDB kernel buys, on one NVIDIA GPU.

``python3 tools/rdb_wgmma_ablation.py`` builds variants of
``realsr_tpu_torch/csrc/rdb_wgmma.cu`` (the committed source with one design
point undone by a text substitution), prints each one's ptxas registers and
spills and its SASS counts of wgmma (HGMMA), waits for wgmma groups
(WARPGROUP.DEPBAR) and local-memory loads, then times one mixed-mode RDB at
the main path's chunk (8 tiles of 148 x 148, nf = 64, gc = 32) with CUDA
events, each variant in its own process:

- ``final``: the committed kernel, at each patch side it is built for (the
  geometry alone), without and with the RRDB residual and the bf16 shadow;
- ``chunk1`` / ``chunk2``: weight-ring chunks of 1 or 2 k16 slices of c5 (2
  or 4 of c1..c4; 6 or 3 slots) in place of 3 (6);
- ``no_setmaxnreg``: one producer warp (288 threads) and no register moves;
- ``no_prefetch``: no L2 prefetch of the epilogue's rows;
- ``no_pingpong``: the two consumer warpgroups issue their products without
  taking turns;

and, as the instruction mix the kernel replaced, K3 (the mma.sync form of
``csrc/rdb_kernel.cu``, T = 16) on the same input. Writes nothing outside
``realsr_tpu_torch/_build/ablation``.
"""

from __future__ import annotations

import concurrent.futures
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from realsr_tpu_torch.models.rrdbnet import tf32  # noqa: E402
from realsr_tpu_torch.ops import build  # noqa: E402
from realsr_tpu_torch.ops import rdb_kernel as rk  # noqa: E402

SRC = os.path.join(build.CSRC, "rdb_wgmma.cu")
OUT = os.path.join(build.build_dir(), "ablation")
B, SIDE, NF, GC = 8, 148, 64, 32
VARIANTS = {
    "final": [],
    "chunk1": [("constexpr int kChunk = 3;\nconstexpr int kSlots = 2;", "constexpr int kChunk = 1;\nconstexpr int kSlots = 6;")],
    "chunk2": [("constexpr int kChunk = 3;\nconstexpr int kSlots = 2;", "constexpr int kChunk = 2;\nconstexpr int kSlots = 3;")],
    "no_setmaxnreg": [
        ("constexpr int kThreads = (kConsumers + 1) * 128;", "constexpr int kThreads = kConsumers * 128 + 32;"),
        ("    setmaxnreg_producer();\n", ""),
        ("  setmaxnreg_consumer();\n", ""),
    ],
    "no_prefetch": [("    prefetch_l2(static_cast<const TS*>(p.x) + o, row_bytes);\n"
                     "    if (p.u != nullptr) prefetch_l2(static_cast<const TS*>(p.u) + o, row_bytes);\n", "")],
    "no_pingpong": [("    turn_wait(wg);\n", ""), ("    turn_pass(wg);\n", ""),
                    ("  if (wg == 1) turn_pass(wg);  // the first turn is warpgroup 0's\n", "")],
}


def inline_headers(src: str) -> str:
    """The source with each ``#include "x.cuh"`` replaced by csrc/x.cuh, so
    that a substitution may reach the shared helpers too."""
    return re.sub(r'#include "(\w+\.cuh)"', lambda m: open(os.path.join(build.CSRC, m.group(1))).read(), src)


def compile_variant(name: str) -> dict:
    src = inline_headers(open(SRC).read())
    for old, new in VARIANTS[name]:
        if old not in src:
            raise SystemExit(f"{name}: the source no longer holds {old[:60]!r}")
        src = src.replace(old, new)
    path = os.path.join(OUT, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    so = os.path.join(OUT, f"{name}.so")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", so, path], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode:
        return {"name": name, "error": log[-2000:]}
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        if re.search(r"rdb_kernelILi17EfLi64ELi32E", part.split("\n", 1)[0]):
            counts = {k: len(re.findall(k, part)) for k in ("HGMMA", "WARPGROUP.DEPBAR", "LDL")}
    regs = re.findall(r"Used (\d+) registers", log)
    spills = re.findall(r"(\d+) bytes spill stores", log)
    return {"name": name, "registers": max(map(int, regs)), "spill_bytes": max(map(int, spills)),
            "serialized": sum("C75" in ln for ln in log.splitlines()), "sass_T17_f32_64_32": counts}


def cuda_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def operands():
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    dense = {}
    for i in range(1, 6):
        cin, cout = NF + (i - 1) * GC, GC if i < 5 else NF
        dense[f"w{i}"] = rng.normal(0, 0.05, (cout, cin, 3, 3)).astype(np.float32)
        dense[f"b{i}"] = rng.normal(0, 0.05, (cout,)).astype(np.float32)
    p = {k: v.to(dev) for k, v in rk.pack_rdb_params(dense, torch.bfloat16).items()}
    x = torch.from_numpy(rng.normal(0, 0.5, (B, SIDE, SIDE, NF)).astype(np.float32)).to(dev)
    return p, x


def time_variant(name: str) -> None:
    """In a process of its own: load the variant's library in place of the
    built one and time it."""
    import ctypes

    lib = rk._bind(ctypes.CDLL(os.path.join(OUT, f"{name}.so")), {"rdb_wgmma_launch": (7, 7)})
    rk._wgmma_library = lambda: lib
    p, x = operands()
    xs = x.to(torch.bfloat16)
    tiles = rk.WGMMA_TILES if name == "final" else (rk.rdb_geometry(B, SIDE, SIDE, NF, GC).tile,)
    with tf32(False):
        want = rk.rdb_reference(x, p, torch.float32, torch.bfloat16)
        for tile in tiles:
            got = rk._rdb_wgmma(x, xs, p, None, False, tile)[0]
            err = (got - want).abs().max().item()
            ms = cuda_ms(lambda: rk._rdb_wgmma(x, xs, p, None, False, tile))
            ms_u = cuda_ms(lambda: rk._rdb_wgmma(x, xs, p, x, True, tile))
            print(f"{name} T={tile}: {ms:.4f} ms; with u and the shadow {ms_u:.4f} ms; "
                  f"max|kernel - plain| {err:.3e}", flush=True)
        if name == "final":
            ms = cuda_ms(lambda: rk.rdb_apply(x, p))
            print(f"final rdb_apply (casting x to bf16 in each call): {ms:.4f} ms", flush=True)
            xc = rk.to_chained(x)
            out = torch.zeros_like(xc)
            flag = torch.zeros(1, dtype=torch.int32, device=x.device)
            ms = cuda_ms(lambda: rk.rdb_apply_chained(xc, p, xc, flag, SIDE, SIDE, out))
            print(f"K3 mma.sync (rdb_kernel.cu, T=16) on the same input: {ms:.4f} ms", flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--time":
        time_variant(sys.argv[2])
        return 0
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA GPU", flush=True)
        return 1
    os.makedirs(OUT, exist_ok=True)
    build.load_library("rdb_kernel")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(compile_variant, VARIANTS))
    for info in built:
        print(info, flush=True)
    for info in built:
        if "error" not in info:
            proc = subprocess.run([sys.executable, __file__, "--time", info["name"]],
                                  capture_output=True, text=True, timeout=300)
            print(proc.stdout.strip() or f"{info['name']}: {proc.stderr[-500:]}", flush=True)
    print(f"card: {smi}", flush=True)
    shutil.rmtree(OUT, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
