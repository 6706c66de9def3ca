"""What each design point of the wgmma tail kernel buys, on one NVIDIA GPU.

``python3 tools/tail_wgmma_ablation.py`` builds variants of
``realsr_tpu_torch/csrc/tail_kernel.cu`` (the committed source, with
its headers inlined, and one design point undone by a text
substitution), prints each one's ptxas registers and spills and the SASS
counts of wgmma (HGMMA), waits for wgmma groups (WARPGROUP.DEPBAR) and
local-memory loads of its 12 x 28 K6 instance, then times K6 and K7 at the
main path's chunk (8 tiles of 148 x 148) with CUDA events, each variant in
its own process:

- ``final``: the committed kernel, at each patch shape it is built for;
- ``not_persistent``: one block per patch (no walk over patches, so no
  window loaded during the previous patch);
- ``no_overlap``: persistent, but the next window is loaded only after the
  patch is done (K7 still alternates its two buffers);
- ``pingpong``: the two consumer warpgroups take turns to issue their
  products (named barriers), as in rdb_wgmma.cu;
- ``small_slots``: K6's ring as four 16 KB slots in place of two 32 KB ones,
  so that up2 takes 4 k16 slices a chunk in place of 8 (K7 unchanged);
- ``small_chunks``: HRconv takes the ring in chunks of 2 (16 x 16) or 1
  (12 x 28) k16 slices, each with a wait, fence and commit, in place of 8
  or 5.

Writes nothing outside ``realsr_tpu_torch/_build/tail_ablation``.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from realsr_tpu_torch.models.rrdbnet import RRDBNetSpec, init_rrdbnet_params, tf32  # noqa: E402
from realsr_tpu_torch.ops import build  # noqa: E402
from realsr_tpu_torch.ops import tail_kernel as tk  # noqa: E402

SRC = os.path.join(build.CSRC, "tail_kernel.cu")
OUT = os.path.join(build.build_dir(), "tail_ablation")
B, SIDE = 8, 148
VARIANTS = {
    "final": [],
    "not_persistent": [("const int grid = cmin(p.B * p.patches, sms);", "const int grid = p.B * p.patches;")],
    "no_overlap": [("    if (c.lane == 0) mbar_arrive(win_empty);\n    const int R0", "    const int R0"),
                   ("  if constexpr (FORM == kK7) {\n    if (c.lane == 0) mbar_arrive(win_empty);",
                    "  {\n    if (c.lane == 0) mbar_arrive(win_empty);")],
    "pingpong": [("    wg_fence();\n    const uint64_t desc", "    wg_fence();\n    turn_wait(c.wg);\n    const uint64_t desc"),
                 ("    wg_commit();\n", "    wg_commit();\n    turn_pass(c.wg);\n"),
                 ("  int k = 0;\n#pragma unroll 1", "  if (wg == 1) turn_pass(wg);\n  int k = 0;\n#pragma unroll 1")],
    "small_chunks": [("constexpr int kAccA = 192;", "constexpr int kAccA = 128;")],
    "small_slots": [("static constexpr int slots = 2; ", "static constexpr int slots = UP2 ? 4 : 2; "),
                    ("static constexpr int slot = UP2 ? 32768 : 16384;", "static constexpr int slot = 16384;")],
}


def inline_headers(src: str) -> str:
    """The source with each ``#include "x.cuh"`` replaced by csrc/x.cuh,
    recursively (tail_wgmma.cuh includes hopper.cuh)."""
    def one(m):
        with open(os.path.join(build.CSRC, m.group(1))) as f:
            return inline_headers(f.read())

    return re.sub(r'#include "(\w+\.cuh)"', one, src)


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
        if re.search(r"tail_kernelILi12ELi28ELi1E", part.split("\n", 1)[0]):
            counts = {k: len(re.findall(k, part)) for k in ("HGMMA", "WARPGROUP.DEPBAR", "LDL")}
    regs = re.findall(r"Used (\d+) registers", log)
    spills = re.findall(r"(\d+) bytes spill stores", log)
    return {"name": name, "registers": max(map(int, regs)), "spill_bytes": max(map(int, spills)),
            "serialized": sum("C75" in ln for ln in log.splitlines()), "sass_K6_12x28": counts}


def cuda_ms(fn, reps: int = 10) -> float:
    for _ in range(2):
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


def time_variant(name: str) -> None:
    """In a process of its own: load the variant's library in place of the
    built one, check it against the plain version and time it."""
    lib = ctypes.CDLL(os.path.join(OUT, f"{name}.so"))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.tail_launch.argtypes = [vp] * 10 + [ci] * 7 + [vp]
    lib.tail_launch.restype = ci
    lib.tail_error_string.argtypes = [ci]
    lib.tail_error_string.restype = ctypes.c_char_p
    tk._library = lambda group: lib
    dev = torch.device("cuda", 0)
    p = init_rrdbnet_params(RRDBNetSpec(num_rrdb=1, nf=64, gc=32), seed=4)
    tp = {k: v.to(dev) for k, v in tk.pack_tail_params(p, torch.bfloat16).items()}
    rng = np.random.default_rng(0)
    for form, label, shape in ((tk.K6, "K6", (B, SIDE, SIDE, 64)), (tk.K7, "K7", (B, SIDE, SIDE, 1024))):
        fn = tk.FORMS[form]
        x = rng.normal(0, 0.5, shape).astype(np.float32)
        x = torch.from_numpy(x if form == tk.K6 else np.abs(x)).to(dev, torch.bfloat16)
        with tf32(False):
            want = getattr(tk, fn.replace("_packed", "_reference"))(x, tp)
        tiles = tk.TAIL_TILES if name == "final" else (tk.tail_geometry(B, SIDE, SIDE, form).tile,)
        for tile in tiles:
            err = (tk._launch(form, x, tp, tile) - want).abs().max().item()
            ms = cuda_ms(lambda: tk._launch(form, x, tp, tile))
            print(f"{name} {label} patch {tile[0]}x{tile[1]}: {ms:.4f} ms; max|kernel - plain bf16| {err:.3e}",
                  flush=True)
        del x, want


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--time":
        time_variant(sys.argv[2])
        return 0
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA GPU", flush=True)
        return 1
    os.makedirs(OUT, exist_ok=True)
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
