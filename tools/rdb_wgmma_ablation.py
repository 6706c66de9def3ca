"""What each design point of the wgmma RDB kernels buys, on one NVIDIA GPU.

``python3 tools/rdb_wgmma_ablation.py`` builds variants of
``realsr_tpu_torch/csrc/rdb_wgmma.cu`` (K1), ``rdb_tf32.cu`` (K1's float32
instances) and ``rdb_modes_wgmma.cu`` (K3, K4, K5): the committed source
with one design point undone by a text substitution. It prints each one's ptxas registers and spills and, for one
instance, its SASS counts of wgmma (HGMMA), waits for wgmma groups
(WARPGROUP.DEPBAR) and local-memory loads, then times one mixed-mode RDB at
the main path's chunk (8 tiles of 148 x 148, nf = 64, gc = 32) with CUDA
events, each variant in its own process.

K1 (``rdb_wgmma.cu``):

- ``final``: the committed kernel, at each patch side it is built for (the
  geometry alone), without and with the RRDB residual and the bf16 shadow;
- ``chunk1`` / ``chunk2``: weight-ring chunks of 1 or 2 k16 slices of c5 (2
  or 4 of c1..c4; 6 or 3 slots) in place of 3 (6);
- ``no_setmaxnreg``: one producer warp (288 threads) and no register moves;
- ``no_prefetch``: no L2 prefetch of the epilogue's rows;
- ``no_pingpong``: the two consumer warpgroups issue their products without
  taking turns;

and K3 (the chained layout, on K1's stages) on the same input, as its
trunk runs it.

K1's float32 instances (``rdb_tf32.cu``, 3xTF32), a float32 RDB each:

- ``tf32_final``: the committed kernel at each patch side it is built for
  (10: 2 x 4 KB ring slots, chunks of 2 k8 steps of c1..c4 and 1 of c5; 9
  and 8: 2 x 12 KB, chunks of up to 6 and 3), beside the cuDNN route;
- ``tf32_slot4k``: every side with 4 KB ring slots (T = 10's chunks);
- ``tf32_rna``: the activations' hi and lo both rounded to nearest by
  cvt.rna.tf32.f32 (hi + lo within 2^-22 of v) in place of hi by
  truncation and lo as it is (2^-20);
- ``tf32_trunc_rna``: hi by truncation, lo rounded to nearest by integer
  operations (2^-21);
- ``tf32_2x``: two products (lo x hi dropped), which is no float32 mode:
  what the third product costs.

K4 and K5 (``rdb_modes_wgmma.cu``):

- ``modes_final``: the committed kernels, K5 at each patch side it is built
  for (12 and 8), K4 at each of K1's (17, 12, 8);
- ``c_chunk1`` / ``c_chunk2``: K5's rectangle C (N = 128) in chunks of 1 or
  2 k16 slices in place of 3 (the other rectangles keep theirs);
- ``k4_hi_global``: K4's epilogue reads hi at the centre from global memory
  (prefetched into L2 with lo) in place of the window in shared memory.

K5's partial sums live in shared memory; the alternative (m-tile groups
with the rectangle's slices replayed) was not built, since rectangle C's
accumulators fit the registers at T = 12. Writes nothing outside
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

OUT = os.path.join(build.build_dir(), "ablation")
B, SIDE, NF, GC = 8, 148, 64, 32
K1_SRC, TF32_SRC, MODES_SRC = "rdb_wgmma.cu", "rdb_tf32.cu", "rdb_modes_wgmma.cu"
# the activations' split in hopper.cuh::split_tf32
TF32_SPLIT = "  hi = v & 0xFFFFE000u;\n  lo = __float_as_uint(f - __uint_as_float(hi));\n"
# name: (source, [(text, replacement)], the instance whose SASS is counted)
VARIANTS = {
    "final": (K1_SRC, [], r"rdb_kernelILi17EfLi64ELi32E"),
    "chunk1": (K1_SRC, [("constexpr int kChunk = 3;\nconstexpr int kSlots = 2;",
                         "constexpr int kChunk = 1;\nconstexpr int kSlots = 6;")], r"rdb_kernelILi17EfLi64ELi32E"),
    "chunk2": (K1_SRC, [("constexpr int kChunk = 3;\nconstexpr int kSlots = 2;",
                         "constexpr int kChunk = 2;\nconstexpr int kSlots = 3;")], r"rdb_kernelILi17EfLi64ELi32E"),
    "no_setmaxnreg": (K1_SRC, [
        ("constexpr int kThreads = (kConsumers + 1) * 128;", "constexpr int kThreads = kConsumers * 128 + 32;"),
        ("    setmaxnreg_producer();\n", ""),
        ("  setmaxnreg_consumer();\n", ""),
    ], r"rdb_kernelILi17EfLi64ELi32E"),
    "no_prefetch": (K1_SRC, [("  prefetch_l2(static_cast<const TS*>(p.x) + o, n * NF * int(sizeof(TS)));\n"
                              "  if (p.u != nullptr) prefetch_l2(static_cast<const TS*>(p.u) + o, "
                              "n * NF * int(sizeof(TS)));\n", "")], r"rdb_kernelILi17EfLi64ELi32E"),
    "no_pingpong": (K1_SRC, [("    turn_wait(wg);\n", ""), ("    turn_pass(wg);\n", ""),
                             ("  if (wg == 1) turn_pass(wg);\n", "")], r"rdb_kernelILi17EfLi64ELi32E"),
    "tf32_final": (TF32_SRC, [], r"rdb_tf32_kernelILi10ELi64ELi32E"),
    "tf32_slot4k": (TF32_SRC, [("constexpr int kTf32Slot = 12288;", "constexpr int kTf32Slot = 4096;")],
                    r"rdb_tf32_kernelILi9ELi64ELi32E"),
    "tf32_rna": (TF32_SRC, [(TF32_SPLIT, "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(hi) : \"f\"(f));\n"
                                         "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(lo) : "
                                         "\"f\"(f - __uint_as_float(hi)));\n")],
                 r"rdb_tf32_kernelILi10ELi64ELi32E"),
    "tf32_trunc_rna": (TF32_SRC, [(TF32_SPLIT, "  hi = v & 0xFFFFE000u;\n"
                                               "  lo = (__float_as_uint(f - __uint_as_float(hi)) + 0x1000u) & 0xFFFFE000u;\n")],
                       r"rdb_tf32_kernelILi10ELi64ELi32E"),
    "tf32_2x": (TF32_SRC, [("        for (int p = 0; p < 3; ++p) {", "        for (int p = 1; p < 3; ++p) {")],
                r"rdb_tf32_kernelILi10ELi64ELi32E"),
    "modes_final": (MODES_SRC, [], r"packed_kernelILi12EfLi64ELi32E"),
    "c_chunk1": (MODES_SRC, [("    return cmin(PL::slot", "    return i == 3 ? 1 : cmin(PL::slot")],
                 r"packed_kernelILi12EfLi64ELi32E"),
    "c_chunk2": (MODES_SRC, [("    return cmin(PL::slot", "    return i == 3 ? 2 : cmin(PL::slot")],
                 r"packed_kernelILi12EfLi64ELi32E"),
    "k4_hi_global": (MODES_SRC, [
        ("struct PairedParams {\n", "struct PairedParams {\n  const __nv_bfloat16* hi;\n"),
        ("  const PairedParams p{static_cast<const bf*>(lo),",
         "  const PairedParams p{static_cast<const bf*>(hi), static_cast<const bf*>(lo),"),
        ("        const __nv_bfloat162 w2 = *reinterpret_cast<const __nv_bfloat162*>(\n"
         "            t.base + chunk_offset<NF>(pix, col0 / 8 + j) + t.tig * 4);\n"
         "        hv[j][0] = __low2float(w2);\n"
         "        hv[j][1] = __high2float(w2);\n", "        load2(p.hi + o + j * 8, hv[j]);\n"),
        ("          prefetch_l2(p.lo + o, n * NF * 2);\n",
         "          prefetch_l2(p.lo + o, n * NF * 2);\n          prefetch_l2(p.hi + o, n * NF * 2);\n"),
    ], r"paired_kernelILi17ELi64ELi32E"),
}


def inline_headers(src: str) -> str:
    """The source with each ``#include "x.cuh"`` replaced by csrc/x.cuh,
    recursively, so that a substitution may reach the shared machinery."""
    def one(m):
        with open(os.path.join(build.CSRC, m.group(1))) as f:
            return inline_headers(f.read())

    return re.sub(r'#include "(\w+\.cuh)"', one, src)


def compile_variant(name: str) -> dict:
    source, subs, instance = VARIANTS[name]
    with open(os.path.join(build.CSRC, source)) as f:
        src = inline_headers(f.read())
    for old, new in subs:
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
        if re.search(instance, part.split("\n", 1)[0]):
            counts = {k: len(re.findall(k, part)) for k in ("HGMMA", "WARPGROUP.DEPBAR", "LDL")}
    regs = re.findall(r"Used (\d+) registers", log)
    spills = re.findall(r"(\d+) bytes spill stores", log)
    return {"name": name, "registers": max(map(int, regs)), "spill_bytes": max(map(int, spills)),
            "serialized": sum("C75" in ln for ln in log.splitlines()), f"sass {instance}": counts}


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


def operands(sched: str = "scatter", op=torch.bfloat16):
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    dense = {}
    for i in range(1, 6):
        cin, cout = NF + (i - 1) * GC, GC if i < 5 else NF
        dense[f"w{i}"] = rng.normal(0, 0.05, (cout, cin, 3, 3)).astype(np.float32)
        dense[f"b{i}"] = rng.normal(0, 0.05, (cout,)).astype(np.float32)
    p = {k: v.to(dev) for k, v in rk.pack_rdb_params(dense, op, sched).items()}
    x = torch.from_numpy(rng.normal(0, 0.5, (B, SIDE, SIDE, NF)).astype(np.float32)).to(dev)
    return p, x


def time_k1(name: str, lib) -> None:
    rk._wgmma_library = lambda: lib
    p, x = operands()
    xs = x.to(torch.bfloat16)
    tiles = rk.WGMMA_TILES if name == "final" else (rk.rdb_geometry(B, SIDE, SIDE, NF, GC).tile,)
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
        xcs, out, sh = xc.to(torch.bfloat16), torch.zeros_like(xc), torch.zeros_like(xc, dtype=torch.bfloat16)
        flag = torch.zeros(1, dtype=torch.int32, device=x.device)
        ms = cuda_ms(lambda: rk.rdb_apply_chained(xc, p, xc, flag, SIDE, SIDE, out, xcs, sh))
        ms_ns = cuda_ms(lambda: rk.rdb_apply_chained(xc, p, xc, flag, SIDE, SIDE, out, xcs))
        print(f"K3 (rdb_modes_wgmma.cu, T={rk.rdb_geometry(B, SIDE, SIDE, NF, GC).tile}) on the same input: "
              f"{ms:.4f} ms; without the shadow {ms_ns:.4f} ms", flush=True)


def time_tf32(name: str, lib) -> None:
    rk._tf32_library = lambda: lib
    p, x = operands(op=torch.float32)
    want = rk.rdb_reference(x, p, torch.float32, torch.float32)
    tiles = rk.TF32_TILES if name in ("tf32_final", "tf32_slot4k") else (rk.tf32_geometry(B, SIDE, SIDE, NF, GC).tile,)
    for tile in tiles:
        got = rk._rdb_tf32(x, p, None, tile)
        err = (got - want).abs().max().item() / max(1.0, want.abs().max().item())
        ms = cuda_ms(lambda: rk._rdb_tf32(x, p, None, tile))
        print(f"{name} T={tile}: {ms:.4f} ms; max|kernel - plain| / max(1, max|plain|) {err:.3e}", flush=True)
    if name == "tf32_final":
        ms = cuda_ms(lambda: rk.rdb_reference(x, p, torch.float32, torch.float32))
        print(f"tf32_final: the cuDNN route (TF32 off) on the same input: {ms:.4f} ms", flush=True)


def time_modes(name: str, lib) -> None:
    rk._modes_library = lambda: lib
    q, x = operands("packed")
    p, _ = operands()
    xs = x.to(torch.bfloat16)
    hi, lo = rk._split(x)
    if name != "k4_hi_global":
        want = rk.rdb_packed_reference(x, q, torch.float32, torch.bfloat16)
        tiles = rk.PACKED_TILES if name == "modes_final" else (rk.packed_geometry(B, SIDE, SIDE, NF, GC).tile,)
        for tile in tiles:
            err = (rk._rdb_wgmma(x, xs, q, None, False, tile, packed=True)[0] - want).abs().max().item()
            ms = cuda_ms(lambda: rk._rdb_wgmma(x, xs, q, None, False, tile, packed=True))
            print(f"{name} K5 T={tile}: {ms:.4f} ms; max|kernel - plain| {err:.3e}", flush=True)
    if name in ("modes_final", "k4_hi_global"):
        wh, wl = rk.rdb_paired_reference(hi, lo, p)
        tiles = rk.WGMMA_TILES if name == "modes_final" else (rk.rdb_geometry(B, SIDE, SIDE, NF, GC).tile,)
        for tile in tiles:
            gh, gl = rk.rdb_apply_paired(hi, lo, p, tile=tile)
            err = (gh.float() + gl.float() - wh.float() - wl.float()).abs().max().item()
            ms = cuda_ms(lambda: rk.rdb_apply_paired(hi, lo, p, tile=tile))
            ms_u = cuda_ms(lambda: rk.rdb_apply_paired(hi, lo, p, (hi, lo), tile=tile))
            print(f"{name} K4 T={tile}: {ms:.4f} ms; with u {ms_u:.4f} ms; max|kernel - plain| {err:.3e}",
                  flush=True)


def time_variant(name: str) -> None:
    """In a process of its own: load the variant's library in place of the
    built one and time it."""
    import ctypes

    lib = ctypes.CDLL(os.path.join(OUT, f"{name}.so"))
    with tf32(False):
        if VARIANTS[name][0] == K1_SRC:
            time_k1(name, rk._bind(lib, {"rdb_wgmma_launch": (7, 7)}))
        elif VARIANTS[name][0] == TF32_SRC:
            time_tf32(name, rk._bind(lib, {"rdb_tf32_launch": (5, 6)}))
        else:
            time_modes(name, rk._bind(lib, {"rdb_paired_launch": (8, 6), "rdb_packed_launch": (7, 7)}))


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--time":
        time_variant(sys.argv[2])
        return 0
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA GPU", flush=True)
        return 1
    names = sys.argv[1:] or list(VARIANTS)
    os.makedirs(OUT, exist_ok=True)
    build.load_library("rdb_modes_wgmma")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(compile_variant, names))
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
