"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases (each prints its lines; any failure exits non-zero):

1. card: ``torch.cuda.get_device_name`` and nvidia-smi's name and power limit;
2. build: the fused RDB and tail kernels from ``realsr_tpu_torch/csrc``, one
   nvcc for each build group of each source (``ops/build.py::GROUPS``: the
   RDB kernels' state type and nf/gc, the tail's form), all started
   together (``rdb_wgmma.cu``: K1/K2 for bf16
   operands; ``rdb_tf32.cu``: K1/K2 for float32 operands, 3xTF32 wgmma;
   ``rdb_modes_wgmma.cu``: K3, K4 and K5 on K1's wgmma machinery;
   ``rdb_modes_tf32.cu``: K3 and K5 for float32 operands; ``tail_kernel.cu``
   and ``tail_tf32.cu``: K6/K7 for bf16 and float32 operands), with each
   kernel's registers and spills from ``-Xptxas -v`` (no kernel may spill;
   each group's library holds the instances the group names and no other)
   and the count of wgmma (HGMMA), TMA and bulk-copy instructions in each
   source's SASS, summed over its groups;
3. the RDB kernel against its plain PyTorch version at the main path's shape
   (8 tiles of 148 x 148 = tile 128 + 2 x 10 halo, nf = 64, gc = 32): the
   patch geometry of K1 and of its float32 instances, one RDB in mixed and
   float32 mode, the 69-RDB trunk with the RRDB residual, with CUDA-event
   times of both (float32 beside its tf32 bound and the cuDNN route's
   time), and the RDB at each patch side the kernel is built for (float32
   also at a ragged 2 x 37 x 21); beside the mixed ones, cuDNN's bf16 convs
   (channels-last) for one RDB's work and for the trunk's, the library
   time of K1, K3-K5 and of K2;
3b. the tail kernels K6 (up2 + HRconv + conv_last) and K7 (HRconv +
   conv_last) against their plain versions at the same shape, at a ragged
   2 x 37 x 21 and at 9 x 37 x 37 (4x sides no multiple of the patch
   shape), with the tail's patch geometry and CUDA-event times, also at
   each patch shape the kernel is built for; then their float32 instances
   against the float32 plain versions at the same shapes and patch shapes,
   timed beside the interleaved tail's cuDNN convs for the same work;
3c. the trunk's alternative modes' kernels, mixed: K5 (the K-packed
   schedule), K4 (the paired bf16 carry) and K3 (the chained layout, with
   its bf16 operand plane and shadow as its trunk threads them) for one RDB
   against their plain versions at the phase-3 shape and at a ragged 2 x 37
   x 21, at the patch side their geometry picks and at each side they are
   built for, bit-equal over two runs, with K5's geometry; K3 also against
   K1; their 69-RDB trunks against the plain trunk of their mode (K3: the
   K1 trunk); CUDA-event times of each, of its plain version and of K1 at
   the same shape; then K3's and K5's float32 instances at both shapes and
   each side (K3 bit-equal to float32 K1) and their float32 trunks (the
   chained one bit-equal to the float32 K1 trunk) against the plain ones;
4. the main path: ``realsr_tpu_torch.cli.main`` on three images with the
   committed DF2K graph (23 RRDB, nf = 64, gc = 32) and synthesized weights,
   each at the tile the engine picks for it, checking the outputs and that
   the trunk and the tail ran on the kernels (69 RDB launches and one tail
   launch per chunk); then the CLI with the
   K7 tail (REALSR_TPU_PACKED_TAIL=2), with TTA (``-x``) and in float32
   (REALSR_TPU_STORAGE=float32: K1's and K6's float32 instances, also with
   the K7 tail, the chained trunk and the packed schedule) on one image;
   then once per trunk mode on one image (chained and paired through the
   module flags ``models.rrdbnet.CHAINED_TRUNK`` / ``PAIRED_CARRY``, packed
   through ``REALSR_TPU_SCHED=packed``), with 69 launches of the mode's
   kernel per chunk and none of K1's;
5. numerics: mixed engines (kernel trunk with the default and the K6 tail,
   TTA, and the chained, paired and packed trunks) against float32 plain by
   PSNR, held to the plain mixed path's PSNR, on uniform noise and on an
   image with a natural 1/f spectrum; the float32
   engines (kernel trunk and K6 tail, chained and packed trunks) against
   float32 plain by identical u8 pixels; a mixed engine's
   output bit-equal before and after a float32 engine ran in the process;
   a float16 engine on ``variant="auto"`` running plain convs;
6. steady state: device-resident ``RealSR.process_device`` on one 1024 x 768
   image for each tail form, trunk mode and engine mode (float32 too),
   TTA on a smaller one, and the device time of one profiled image by
   kernel group (mixed and float32);
7. slice 9, one JSON line per step: (a) ``RealSR.process_banded`` at 1, 2
   and 3 tile rows per band against ``process`` on a ragged 1000 x 700 RGBA
   image, mixed and float32, bit-equal, with K1 and K6 launches per band,
   and TTA banded against whole at 256 x 192; (b) a 6200 x 6000 RGB image
   above the default band budget through ``process`` (banded) and whole
   under a larger budget, bit-equal, output MP/s of both; (c) the CLI on a
   4096 x 3072 PNG with the budget just below its footprint, pixels equal
   to the unbanded CLI run's; (d) ``process_cpu`` on the card engine against the float32
   plain card engine, and the card engine's output unmoved after it; (e)
   the generic ncnn executor on the DF2K graph (``allow_fast_path=False``,
   float32) against the ``dense`` fast path at 8 x 148², both timed, and
   the CLI on a graph the RRDBNet matcher rejects (the DF2K graph with
   bilinear upsamplers); (f) ``variant="dense"`` and ``"scatter"`` resolve
   ``tail="auto"`` to the interleaved tail.
   Phases 5-7 pin tile 128 (``TILE128``), so their numbers stay comparable
   with PRs 8 and 9 (7c passes ``-t 128`` to the CLI);
8. slice 10, the per-image tile pick: (a) K1 and K6, mixed and float32,
   against their plain versions at the chunk shapes of tiles 192 and 256
   (8 x 212², 6 x 276²), timed beside their bounds; (b) the planner's rate
   anchors (``tiling/calibrate.py``: the default engine's forward per
   padded pixel at 148², 212², 276²), printed as a
   ``REALSR_TPU_RATE_ANCHORS`` spec; (c) the pick on 1024 x 768, 1000 x
   700 RGBA, 4096 x 3072 and 200 x 150; (d) each picked output against the
   tile-128 engine's, by PSNR against a float32 engine at each one's tile
   (within 1 dB), and on the three small images the float32 engine at its
   own pick against the float32 plain engine at that tile by phase 5's u8
   parity gate; (e) banded against whole under the pick, bit-equal; (f)
   device-resident output MP/s with the pick and at 128;
9. mesh mode: ``make_mesh([cuda:0, cuda:0])`` (two shards on the one card)
   against the single engine, bit-equal, mixed, float32 and TTA on a
   ragged RGBA image, and banded; K1/K6 launches on each shard, each
   chunk's charged to the shard whose private output it changed; the CLI
   with ``REALSR_TPU_MESH=all``;
10. the native bridge in process (``init`` on gpu 0, ``process_async`` /
   ``fetch`` against ``process``, a batch of 3 against singles, an
   over-budget image banded), then the port's C++ CLI
   (``realsr_tpu_torch/native``, cmake) on a directory against ``python -m
   realsr_tpu_torch``, PNG bytes equal; where the machine lacks cmake, a
   codec header or an embeddable Python, that one step prints what is
   missing and is left out;
11. the run-time dispatch, one JSON line a step: (a) each engine's output
   through its chunk program table (a CUDA graph per key) bit-equal to the
   same engine run eagerly (``config.cuda_graphs`` off): the default engine at
   its pick and at tile 128 on 1024 x 768, float32 ``auto``, TTA at 256 x
   192, the 1000 x 700 RGBA image banded, each trunk mode and the K7 tail,
   a mesh of two shards of cuda:0; (b) in a fresh process, the kernel rows
   of each program's replay alone (69 of the trunk's kernel and one of the
   tail's, as its recording counted; a program with no kernel row fails) for
   the default, TTA, float32, each trunk mode and K7 engine; (c)
   steady ``process_device`` MP/s and idle share, graphs against eager in
   turns, mixed and float32; (d) ``fetch`` of one image while the next
   image computes, against the copy alone, and the old ``.cpu()`` route's
   time; (e) each program's capture seconds and the pool's growth for it,
   the shared pool (and, from (b)'s fresh process, the pool after each
   engine's programs), the 6200 x 6000 banded image's peak reserved memory
   with graphs (7b) and eagerly; (f) ``precompile`` on a fresh engine and
   its first image; (g) the CLI on a directory of photos of mixed sizes,
   file to file, graphs against eager in turns, outputs bit-equal;
12. the cold start, one JSON line a step: (a) the default CLI on the 1024 x
   768 image in a fresh process and a fresh build root, fast start on
   (the default engine's two groups) and off (every group of its two
   sources), then warm: wall time to the output, each group's nvcc
   seconds, outputs bit-equal to the main engine's; (b) a seed of (a)'s
   root (``python -m realsr_tpu_torch.seed_cache``) installed into a new
   root, the CLI there with no nvcc, bit-equal with nothing built, and a
   seed of an altered fingerprint installed inert, the same run failing
   with a message that names the seed tool; (c) the build fingerprint and
   the groups each of the smoke's engines built;
13. the upload that does not wait for the card (``engine._upload``), one
   JSON line a step, each against the old pageable route swapped into the
   module (``by_route``): (a) ``process_device`` back to back from two
   threads, 8 x 1024 x 768 and 64 x 256 x 192, one fetch each at the end,
   in turns, median of 5: images/s, and from one profiled run of each the
   blocking CUDA runtime calls between the first and the last enqueue
   (none on the new route) and the idle share; outputs bit-equal; the
   caching host allocator holding a pinned block until its copy has run;
   a fresh engine capturing while another thread uploads; (b) image 2's
   ``process_device`` returning while image 1 computes; (c) the 6200 x
   6000 image banded (old, new) and whole, warm, with the pinned blocks
   each run made, beside 7b's first runs; (d) the default CLI file to file
   on 11g's photos and on 32 copies of the 1024 x 768 PNG, bit-equal, with
   the peak memory reserved; (e) ``REALSR_TPU_PROFILE`` on the CLI in a
   subprocess: one Chrome trace naming K1's and K6's kernels; (f) on a
   host with two cards, a mesh of both (``mesh_cards_main`` runs it
   alone), else a line saying it is left out.

Every card engine runs a key's first chunk eagerly, its second through the
capture of the key's graph (the warm-up computes the chunk; the kernel
wrappers count its launches, and again for the recording, which runs
nothing) and every later chunk as a replay (the wrappers count nothing);
``precompile`` captures ahead. The smoke's graph class (``counting``,
installed over the engine's) records each graph's launches and replays, so
phases 4, 7a, 7b and 9 count the launches run on the card per chunk, band
and shard (``executed``: the wrappers' counts less the recordings' plus the
replays'); phase 11b holds a replay's kernel rows to its recording's
count.

The engines set TF32 for each chunk from their operand type (off for
float32); the plain versions here run with TF32 off, except where a line
says that it times them as a mixed engine runs them.

The line before the card's line lists every kernel with its launches on
the main path (the wrapper's count in that run, and the launches its graph
replays ran), its error against its plain version, its time, its plain
version's and its bound on this card (``bound_ms``: the larger of the
operations over the data sheet's dense peak, bf16 or, for the float32
instances, tf32 with three products per MAC, and the bytes over its memory
rate); for the float32 instances ``library_ms`` is the cuDNN route's time
for the same work (the plain RDB's convs; the interleaved tail's convs),
for K6 and K7 that of the interleaved tail's convs with bf16 operands, for
K1, K3-K5 and K2 that of cuDNN's bf16 convs (phase 3).
The last line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX
or of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
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
# float16 engine vs float32 plain: float16 keeps 11 significant bits, more
# than mixed mode's bfloat16 operands (46 dB on the 1/f image), so a working
# route lands near or above that; 30 dB catches a broken one
F16_MIN_DB = 30.0
STEADY_HW = (768, 1024)  # phase 6 image
# phase 11g: photos of mixed sizes (h, w), each size met once
MIXED_HW = ((360, 480), (480, 640), (300, 533), (600, 800), (450, 600), (512, 683), (240, 320), (700, 933))
TILE128 = 128  # phases 5-7's tile: their numbers rest on it (PRs 8, 9)
BAND_HW = (700, 1000)  # phase 7a: a ragged grid at tile 128
BIG_HW = (6000, 6200)  # phase 7b: above the default band budget (37.2 MP)
# phase 7c: 12.6 MP, whose whole-image footprint (722 MB in mixed mode) is
# above a 700 MB budget that still allows chunks of 8 (90 MB a 148² tile)
CLI_BAND_HW, CLI_BAND_BUDGET = (3072, 4096), "700"
TAILS = ("interleaved", "packed", "kernel_hr", "kernel")  # models.rrdbnet.TAIL_MODES
# phase 3b: the main path's; ragged 16 x 16 patches; more 12 x 28 patches than
# SMs, none whole at the right and bottom edges
TAIL_SHAPES = ((B, SIDE, SIDE), (2, 37, 21), (9, 37, 37))
# phase 3c, K4 and K5: the main path's chunk and a ragged one
MODE_SHAPES = ((B, SIDE, SIDE), (2, 37, 21))
# the trunk's alternative modes: engine config, the rrdbnet module flag or
# REALSR_TPU_SCHED value that selects it through the CLI, its launch count
MODES = {
    "chained": (dict(trunk="chained"), "CHAINED_TRUNK", None, "rdb_apply_chained"),
    "paired": (dict(trunk="paired"), "PAIRED_CARRY", None, "rdb_apply_paired"),
    "packed": (dict(sched="packed"), None, "packed", "rdb_apply_packed"),
}
# NVIDIA's data sheet for the H100 SXM at 700 W: dense bf16 and tf32, HBM
PEAK_BF16_FLOPS, PEAK_TF32_FLOPS, PEAK_BYTES = 989e12, 495e12, 3.35e12
TF32_PRODUCTS = 3  # the float32 kernel's split product: lo x hi + hi x lo + hi x hi
RDB_MACS_PER_PX = 9 * sum((NF + i * GC) * (GC if i < 4 else NF) for i in range(5))


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(macs: float, moved: int, tf32: bool = False) -> tuple:
    """(ms, what bounds it): the least time the card could take for
    ``macs`` bf16 multiply-adds (``tf32``: float32 multiply-adds, each three
    tf32 products) moving ``moved`` bytes."""
    flops = TF32_PRODUCTS * 2 * macs / PEAK_TF32_FLOPS if tf32 else 2 * macs / PEAK_BF16_FLOPS
    t_ops, t_mem = flops, moved / PEAK_BYTES
    return 1e3 * max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


def ptxas_rows(log: str) -> list:
    """(kernel, registers, spill store bytes, spill load bytes) per entry
    function of an ``nvcc -Xptxas -v`` log of a kernel source."""
    import re

    rows = []
    for part in log.split("Compiling entry function '")[1:]:
        name = part.split("'", 1)[0]
        w = re.search(r"(rdb|packed|chained)_kernelILi(\d+)E(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E", name)
        k4 = re.search(r"(paired|rdb_tf32)_kernelILi(\d+)ELi(\d+)ELi(\d+)E", name)
        t = re.search(r"tail_kernelILi(\d+)ELi(\d+)ELb(\d)E(f|13__nv_bfloat16)", name)
        ops = "float32 3xTF32" if "LayoutF32" in name else "bf16"
        if t:
            label = (f"{'K6' if t.group(3) == '1' else 'K7'} {t.group(1)}x{t.group(2)} "
                     f"{'float32 3xTF32' if t.group(4) == 'f' else 'bf16'}")
        elif w:
            label = (f"{dict(rdb='K1', packed='K5', chained='K3')[w.group(1)]} wgmma T={w.group(2)} "
                     f"{'f32' if w.group(3) == 'f' else 'bf16'} state, {ops} operands {w.group(4)}/{w.group(5)}")
        elif k4:
            kind = "K4 wgmma" if k4.group(1) == "paired" else "K1 float32 3xTF32 wgmma"
            label = f"{kind} T={k4.group(2)} {k4.group(3)}/{k4.group(4)}"
        else:
            label = name[-40:]
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", part)
        rows.append((label, int(regs.group(1)) if regs else -1,
                     *(int(v) for v in (spill.groups() if spill else (-1, -1)))))
    return rows


def sass_counts(name: str) -> dict:
    """Counts of wgmma (HGMMA), TMA (UTMALDG), bulk-copy (UBLKCP) and
    ldmatrix (LDSM) instructions in the SASS of a source's built group
    libraries, summed over its groups, by cuobjdump."""
    import re

    from realsr_tpu_torch.ops import build

    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    counts = dict.fromkeys(("HGMMA", "UTMALDG", "UBLKCP", "LDSM"), 0)
    for group in build.GROUPS[name]:
        so = os.path.join(build.build_dir(), build.library_name(name, group))
        sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True, check=True).stdout
        for op in counts:
            counts[op] += len(re.findall(rf"\b{op}\b", sass))
    return counts


def cudnn_tail(fea, params, up2: bool, dtype=torch.float32):
    """The interleaved tail's cuDNN convs for the work of K6 (``up2``: from
    the 2x image, nearest-x2 + up2 conv + LeakyReLU, HRconv + LeakyReLU,
    conv_last) or K7 (from the 4x image after up2): NCHW ``fea``, ``params``
    the graph's OIHW groups as tensors on its device. ``dtype`` float32:
    float32 convs (TF32 as the caller's scope sets it); bfloat16: cuDNN's
    bf16 convs (bf16 operands and outputs, channels-last), K6's and K7's
    operand type."""
    from realsr_tpu_torch.models.rrdbnet import LRELU_SLOPE, conv3x3
    from realsr_tpu_torch.ops.resize import nearest_x2

    if dtype == torch.bfloat16:
        import torch.nn.functional as F

        def conv(x, g, k=None, slope=None):
            w, b = (params[g]["w"], params[g]["b"]) if k is None else (params[g]["w"][k], params[g]["b"][k])
            y = F.conv2d(x, w.to(dtype).contiguous(memory_format=torch.channels_last), b.to(dtype), padding=1)
            return y if slope is None else F.leaky_relu(y, slope)

        x = fea.to(dtype).contiguous(memory_format=torch.channels_last)
        if up2:
            x = conv(F.interpolate(x, scale_factor=2.0, mode="nearest"), "up", 1, LRELU_SLOPE)
        return conv(conv(x, "hr", None, LRELU_SLOPE), "last")
    f32 = torch.float32
    if up2:
        fea = nearest_x2(fea.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        fea = conv3x3(fea, params["up"]["w"][1], params["up"]["b"][1], LRELU_SLOPE, f32)
    fea = conv3x3(fea, params["hr"]["w"], params["hr"]["b"], LRELU_SLOPE, f32)
    return conv3x3(fea, params["last"]["w"], params["last"]["b"], None, f32)


def cudnn_rdb(x, w, u=None):
    """cuDNN's bf16 convs for one RDB's work (phase 3's library time for K1,
    K3, K4 and K5): NCHW channels-last bf16 ``x``, the five 3x3 convs over
    the dense concat (LeakyReLU 0.2 on c1..c4), ``0.2 c5 + x``, and the RRDB
    residual ``0.2 y + u`` where ``u`` is given; ``w``: one RDB's OIHW
    weights and biases (``unpack_rdb_params``) in bf16, channels-last. The
    state is bf16 here, where the mixed kernel carries float32."""
    import torch.nn.functional as F

    feats = [x]
    for i in range(1, 5):
        feats.append(F.leaky_relu(F.conv2d(torch.cat(feats, 1), w[f"w{i}"], w[f"b{i}"], padding=1), 0.2))
    y = 0.2 * F.conv2d(torch.cat(feats, 1), w["w5"], w["b5"], padding=1) + x
    return y if u is None else 0.2 * y + u


def cudnn_trunk(x, ws):
    """:func:`cudnn_rdb` over the 69 RDBs, the RRDB residual every third
    (K2's library time)."""
    t = u = x
    for k, w in enumerate(ws):
        if k % 3 == 0:
            u = t
        t = cudnn_rdb(t, w, u if k % 3 == 2 else None)
    return t


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


def tail_check(tk, name, x, tp_bf16, tp_f32, timed):
    """Phase 3b for one tail kernel on one input: (|kernel - plain bf16|,
    |kernel - plain f32|, |plain bf16 - plain f32|, kernel ms, plain ms)
    after the gates: error against the float32 plain tail at most max(2 x
    the plain bf16 version's, 1e-3) (the JAX suite's rule for its tail
    kernel), finite, bit-equal over two runs."""
    from realsr_tpu_torch.models.rrdbnet import tf32

    fn, ref = getattr(tk, name), getattr(tk, name.replace("_packed", "_reference"))
    got = fn(x, tp_bf16)
    torch.cuda.synchronize()
    plain = ref(x, tp_bf16)
    exact = ref(x.float(), tp_f32)
    e_k, e_p = rel_err(got, exact)[0], rel_err(plain, exact)[0]
    up = int(name.startswith("up2"))  # K6 reads up1's [B, H + 1, W + 1, 256]
    want_shape = (x.shape[0], 4 * (x.shape[1] - up), 4 * (x.shape[2] - up), 3)
    check(tuple(got.shape) == want_shape and bool(torch.isfinite(got).all()),
          f"{name}: output {tuple(got.shape)} not finite or not [B, 4H, 4W, 3]")
    check(e_k <= max(2 * e_p, 1e-3),
          f"{name}: max|kernel - f32 plain| {e_k} > max(2 x {e_p}, 1e-3)")
    check(torch.equal(got, fn(x, tp_bf16)), f"{name}: two runs on the same input differ")
    ms = pms = float("nan")
    if timed:
        # the plain version as a mixed engine runs it: TF32 allowed (exact
        # for bf16 operands, f32 sums)
        with tf32(True):
            ms = cuda_ms(lambda: fn(x, tp_bf16), 2, 10)
            pms = cuda_ms(lambda: ref(x, tp_bf16), 1, 2)
    return rel_err(got, plain)[0], e_k, e_p, ms, pms


def chunk_counts(engine, images: dict) -> tuple:
    """(chunks, forward batches) an engine's CLI run takes on ``images``, at
    the tile the engine picks for each: with TTA a chunk of non-square tiles
    runs two forwards."""
    from realsr_tpu_torch.tiling.planner import plan_tiles

    chunks = batches = 0
    for img in images.values():
        h, w = img.shape[:2]
        ts = engine._pick_tilesize(w, h)
        plan = plan_tiles(w, h, ts, engine.prepadding)
        for (ph, pw), idx in plan.buckets.items():
            n = engine._chunking(ts, len(idx))[1]
            chunks += n
            batches += n * (2 if engine.tta_mode and ph != pw else 1)
    return chunks, batches


# what the smoke's counted graphs (counting) recorded and their replays ran
# since zero_counts: {wrapper: launches} each; the captures, their seconds
# (warm-ups included) and the replays
GRAPH_COUNTS: dict = {"recorded": {}, "replayed": {}, "captures": 0, "replays": 0, "capture_s": 0.0}


_THREAD = threading.local()


class ThreadCounts(dict):
    """A kernel module's ``LAUNCHES``, which also adds each of a thread's
    increments (``LAUNCHES[w] += 1``: a read, then a write of one more) to
    that thread's own tally while it has one (``_THREAD.tally``): eager
    chunks of other threads run beside a capture, outside the device's
    lock, and must not count as its recording's."""

    def __getitem__(self, k):
        v = super().__getitem__(k)
        _THREAD.read = (k, v)
        return v

    def __setitem__(self, k, v):
        tally, read = getattr(_THREAD, "tally", None), getattr(_THREAD, "read", None)
        if tally is not None and read is not None and read[0] == k and v > read[1]:
            tally[k] = tally.get(k, 0) + v - read[1]
        _THREAD.read = None
        super().__setitem__(k, v)


def thread_counts(*modules) -> None:
    """Give each kernel module's ``LAUNCHES`` a :class:`ThreadCounts`."""
    for mod in modules:
        mod.LAUNCHES = ThreadCounts(mod.LAUNCHES)


def counting(base, rk, tk):
    """The engine's graph class ``base`` with what the smoke reads of each
    graph: ``launches`` ({wrapper: n}, the wrappers' counts during the
    recording, the second run of the chunk's work: what one replay runs),
    ``replays``, ``capture_s`` (the warm-up, which computes the key's first
    chunk, included) and ``pool_bytes`` (how far the device's reserved
    memory grew during the recording alone: the shared pool's growth for
    it), each also summed into GRAPH_COUNTS. The engine serializes a
    device's captures and replays under the device's lock, so the sums take
    no lock; the recording's launches are the capturing thread's own tally
    (:class:`ThreadCounts`, installed by :func:`thread_counts`)."""

    def add(into: dict, launches: dict) -> None:
        for k, n in launches.items():
            into[k] = into.get(k, 0) + n

    class Counting(base):
        launches: dict = {}
        replays = pool_bytes = 0
        capture_s = 0.0

        def capture(self, fn):
            runs = []

            def body():
                if runs:
                    self.pool_bytes = -torch.cuda.memory_reserved()
                    _THREAD.tally = {}
                    try:
                        fn()
                        self.launches = _THREAD.tally
                    finally:
                        _THREAD.tally = None
                else:
                    fn()
                runs.append(1)

            t0 = time.perf_counter()
            super().capture(body)
            self.capture_s = time.perf_counter() - t0
            self.pool_bytes += torch.cuda.memory_reserved()
            add(GRAPH_COUNTS["recorded"], self.launches)
            GRAPH_COUNTS["captures"] += 1
            GRAPH_COUNTS["capture_s"] += self.capture_s

        def replay(self):
            super().replay()
            self.replays += 1
            GRAPH_COUNTS["replays"] += 1
            add(GRAPH_COUNTS["replayed"], self.launches)

    return Counting


def executed(rk, tk) -> dict:
    """{wrapper: launches} run on the card since zero_counts: the wrappers'
    counts (eager chunks, and each capture's warm-up, which computes a
    chunk, and its recording) less the recordings' plus what the replays
    ran. Phase 11b holds one replay's kernel rows to its recording's count
    with torch.profiler."""
    rec, rep = GRAPH_COUNTS["recorded"], GRAPH_COUNTS["replayed"]
    return {k: n - rec.get(k, 0) + rep.get(k, 0) for k, n in {**rk.LAUNCHES, **tk.LAUNCHES}.items()}


def run_cli(cli, rk, tk, args, env=None, flag=None):
    """cli.main with the launch counts set to 0 just before it and read just
    after, with ``env`` set and the rrdbnet module flag ``flag`` True during
    the call: (wall s, {RDB wrapper: launches}, K6 launches, K7 launches,
    {wrapper: its own count}). The CLI's engines run chunks through captured
    graphs, so the launches per chunk are what ran on the card
    (:func:`executed`), not the wrappers' own counts."""
    from realsr_tpu_torch import engine as engine_mod
    from realsr_tpu_torch.models import rrdbnet

    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    if flag:
        setattr(rrdbnet, flag, True)
    made = []
    load = engine_mod.RealSR.load

    def recorded_load(self, *a, **kw):
        made.append(self)
        return load(self, *a, **kw)

    engine_mod.RealSR.load = recorded_load
    try:
        zero_counts(rk, tk)
        t0 = time.perf_counter()
        rc = cli.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        wrappers = {**rk.LAUNCHES, **tk.LAUNCHES}
    finally:
        engine_mod.RealSR.load = load
        if flag:
            setattr(rrdbnet, flag, False)
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(rc == 0, f"cli.main {args} returned {rc}")
    ran = executed(rk, tk)
    for e in made:
        check(e.graphs == (e.bundle.spec is not None), f"cli.main {args}: an engine with graphs {e.graphs}")
    return (wall, {k: ran[k] for k in rk.LAUNCHES}, ran["up2_hr_last_packed"], ran["hr_last_packed"], wrappers)


def plain_trunk(rk, x, stacked, ref=None):
    """The trunk through the plain RDB ``ref`` (rk.rdb_reference, or
    rk.rdb_packed_reference for the packed schedule; rk.rdb_trunk's order)."""
    ref = ref or rk.rdb_reference
    t = u = x
    for k in range(stacked["w"].shape[0]):
        if k % 3 == 0:
            u = t
        pk = {"w": stacked["w"][k], "b": stacked["b"][k]}
        t = ref(t, pk, x.dtype, pk["w"].dtype, u if k % 3 == 2 else None)
    return t


def plain_paired_trunk(rk, x, stacked):
    """The trunk through the plain paired RDB (rk.rdb_trunk_paired's
    schedule): hi + lo in float32."""
    hi, lo = rk._split(x)
    u = (hi, lo)
    for k in range(stacked["w"].shape[0]):
        if k % 3 == 0:
            u = (hi, lo)
        pk = {"w": stacked["w"][k], "b": stacked["b"][k]}
        hi, lo = rk.rdb_paired_reference(hi, lo, pk, u if k % 3 == 2 else None)
    return hi.float() + lo.float()


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
        if any(k in n for k in ("rdb_kernel", "rdb_tf32_kernel", "chained_kernel", "packed_kernel", "paired_kernel")):
            g = "rdb kernels"
        elif "tail_kernel" in n:
            g = "tail_kernel"
        elif any(s in n for s in ("nchwtonhwc", "nhwctonchw", "transpose")):
            g = "layout transposes"
        elif any(s in n for s in ("conv", "gemm", "xmma", "fprop", "winograd", "fft")):
            g = "cuDNN convs"
        else:
            g = "elementwise and copies"
        groups[g] = groups.get(g, 0.0) + ms
        rows.append((ms, e.key))
    return wall, groups, sorted(rows, reverse=True)[:4]




def zero_counts(rk, tk) -> None:
    for counts in (rk.LAUNCHES, tk.LAUNCHES):
        for k in counts:
            counts[k] = 0
    GRAPH_COUNTS.update(recorded={}, replayed={}, captures=0, replays=0, capture_s=0.0)


def k1_k6(rk, tk) -> tuple:
    """(K1, K6) launches run on the card since zero_counts (:func:`executed`)."""
    ran = executed(rk, tk)
    return ran["rdb_apply"], ran["up2_hr_last_packed"]


def band_runs(eng, rk, tk, fn):
    """``fn()`` with the launch counts set to 0 just before it, and the K1
    and K6 launches of each band (each ``_dispatch_buckets`` call) read as
    it returns (:func:`executed`): (result, [(K1, K6) per band])."""
    per = []
    inner = eng._dispatch_buckets

    def counted(*args, **kwargs):
        r0, t0 = k1_k6(rk, tk)
        done = inner(*args, **kwargs)
        r1, t1 = k1_k6(rk, tk)
        per.append((r1 - r0, t1 - t0))
        return done

    eng._dispatch_buckets = counted
    try:
        zero_counts(rk, tk)
        out = fn()
        torch.cuda.synchronize()
    finally:
        del eng._dispatch_buckets
    return out, per


def band_chunks(eng, shape, btr: int) -> list:
    """Chunks per band of ``process_banded(band_tile_rows=btr)``: each
    band's buckets at the whole image's chunk batch."""
    from realsr_tpu_torch.tiling.planner import plan_tiles

    h, w, _ = shape
    ts = eng._pick_tilesize(w, h)
    plan = plan_tiles(w, h, ts, eng.prepadding)
    btr = eng._equalized_band_rows(plan.ytiles, btr)
    batch = {sh: eng._chunking(ts, len(ix))[0] for sh, ix in plan.buckets.items()}
    chunks = []
    for r0 in range(0, plan.ytiles, btr):
        n: dict = {}
        for t in plan.tiles:
            if r0 <= t.yi < r0 + btr:
                sh = t.padded_shape(eng.prepadding)
                n[sh] = n.get(sh, 0) + 1
        chunks.append(sum(-(-k // batch[sh]) for sh, k in n.items()))
    return chunks


def with_env(env: dict, fn):
    """``fn()`` with ``env`` set (a value None unsets), restored after."""
    old = {k: os.environ.get(k) for k in env}
    try:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def timed(fn) -> tuple:
    """(fn(), wall seconds to a synchronized device)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def slice9(cli, rk, tk, mparam, mbin, work, card, engine, kern32, plain32, tta_engine, rng, big_band) -> None:
    """Phase 7: band streaming, process_cpu, the generic executor and the
    dense tail's resolution on the card; one JSON line per step. 7b's
    banded run leaves (peak reserved bytes, output digest, s) in
    ``big_band["graphs"]`` for phase 11e, and the whole image's s and the
    pinned blocks each run made (``big_band["whole_s"]``,
    ``["host_allocs"]``) for phase 13c."""
    from PIL import Image

    from realsr_tpu_torch.engine import EngineConfig, RealSR
    from realsr_tpu_torch.loader import load_model
    from realsr_tpu_torch.models.rrdbnet import tf32
    from realsr_tpu_torch.ncnn.bin import write_weights
    from realsr_tpu_torch.ncnn.param import parse_param
    from realsr_tpu_torch.ncnn.synth import synth_weights

    no_budget = {"REALSR_TPU_BAND_BUDGET_MB": None}
    no_budget_batch = with_env(no_budget, lambda: engine._chunking(TILE128, 64))
    dev = engine.device.torch_device
    gpu = dev.index if dev.type == "cuda" else -1

    # 7a: bands against the whole image, mixed and float32, then TTA
    img = np.random.default_rng(7).integers(0, 256, (*BAND_HW, 4), np.uint8)
    rows = {}
    for label, eng in (("mixed", engine), ("float32", kern32)):
        check((eng.variant, eng.tail) == ("cuda", "kernel"), f"7a {label}: {eng.variant}, {eng.tail}")
        whole = with_env(no_budget, lambda: eng.process(img))
        for btr in (1, 2, 3):
            banded, per = band_runs(eng, rk, tk, lambda: eng.process_banded(img, band_tile_rows=btr))
            want = band_chunks(eng, img.shape, btr)
            check(np.array_equal(banded, whole), f"7a {label}, {btr} tile rows a band: not bit-equal to whole")
            check(per == [(69 * n, n) for n in want],
                  f"7a {label}, {btr} rows: (K1, K6) launches per band {per}, want 69 x / 1 x {want} chunks")
            rows[f"{label} btr={btr}"] = {"bit_equal": True, "bands": len(per), "k1_k6_launches_per_band": per}
    small = np.random.default_rng(8).integers(0, 256, (192, 256, 3), np.uint8)
    banded, per = band_runs(tta_engine, rk, tk, lambda: tta_engine.process_banded(small, band_tile_rows=1))
    check(np.array_equal(banded, tta_engine.process(small)) and all(a > 0 and b > 0 for a, b in per),
          f"7a TTA: banded not bit-equal to whole, or a band without K1 / K6 launches {per}")
    rows["mixed TTA 256x192 btr=1"] = {"bit_equal": True, "bands": len(per), "k1_k6_launches_per_band": per}
    print(json.dumps({"phase": "7a", "what": f"process_banded vs process, ragged {BAND_HW[1]}x{BAND_HW[0]} RGBA, tile "
                      f"{engine.tilesize}", "runs": rows, "card": card}), flush=True)

    # 7b: an image above the default band budget, banded, then whole
    big = np.random.default_rng(9).integers(0, 256, (*BIG_HW, 3), np.uint8)
    out_mp = 16 * big.shape[0] * big.shape[1] / 1e6
    check(with_env(no_budget, lambda: engine.needs_banding(big.shape)), f"7b: {big.shape} does not need banding")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    h0 = host_allocs()
    (banded, per), s_band = timed(lambda: with_env(no_budget, lambda: band_runs(
        engine, rk, tk, lambda: engine.process(big))))
    h1 = host_allocs()
    big_band["graphs"] = (torch.cuda.max_memory_reserved(), hashlib.sha256(banded.tobytes()).hexdigest(), s_band)
    want = band_chunks(engine, big.shape, with_env(no_budget, lambda: engine._auto_band_tile_rows(
        big.shape[1], 3, engine.tilesize)))
    check(per == [(69 * n, n) for n in want], f"7b: launches per band {per}, want 69 x / 1 x {want}")
    whole_env = {"REALSR_TPU_BAND_BUDGET_MB": "8192"}
    check(not with_env(whole_env, lambda: engine.needs_banding(big.shape)), "7b: 8192 MB budget still bands")
    whole, s_whole = timed(lambda: with_env(whole_env, lambda: engine.process(big)))
    big_band["whole_s"] = s_whole  # phase 13c, with each run's new pinned blocks
    big_band["host_allocs"] = {"banded": host_alloc_delta(h0, h1), "whole": host_alloc_delta(h1, host_allocs())}
    check(banded.shape == (4 * BIG_HW[0], 4 * BIG_HW[1], 3) and np.array_equal(banded, whole),
          f"7b: banded {banded.shape} not bit-equal to the whole-image run")
    del whole
    print(json.dumps({"phase": "7b", "what": f"{BIG_HW[1]}x{BIG_HW[0]} RGB ({out_mp:.1f} MP out), mixed, process()",
                      "bands": len(per), "k1_k6_launches_per_band": per, "bit_equal": True,
                      "banded_s": s_band, "whole_s": s_whole,
                      "banded_out_mp_s": out_mp / s_band, "whole_out_mp_s": out_mp / s_whole,
                      "card": card}), flush=True)
    del banded, big

    # 7c: the CLI with the band budget just below the image's footprint. The
    # budget also caps the chunk batch (_auto_batch), and chunks of another
    # batch may round differently (cuDNN picks its algorithm by batch), so
    # the image is large enough that both budgets keep the batch at 8
    src = os.path.join(work, "band.png")
    Image.fromarray(np.random.default_rng(10).integers(0, 256, (*CLI_BAND_HW, 3), np.uint8)).save(src)
    Image.MAX_IMAGE_PIXELS = None  # its 4x PNGs (201 MP) are above PIL's decompression-bomb guard
    outs = {}
    for label, budget in (("whole", "2048"), ("banded", CLI_BAND_BUDGET)):
        env = {"REALSR_TPU_BAND_BUDGET_MB": budget}
        check(with_env(env, lambda: (engine.needs_banding((*CLI_BAND_HW, 3)), engine._chunking(TILE128, 64)))
              == (label == "banded", no_budget_batch),
              f"7c: at {budget} MB the {CLI_BAND_HW} image is not {label}, or its chunk batch moved")
        dst = os.path.join(work, f"band_{label}.png")
        _, counts, k6, _, _ = run_cli(cli, rk, tk, ["-i", src, "-o", dst, "-m", os.path.dirname(mparam), "-g", "0",
                                                  "-t", str(TILE128)], env)
        with Image.open(dst) as im:
            outs[label] = (np.asarray(im), counts["rdb_apply"], k6)
    check(np.array_equal(outs["banded"][0], outs["whole"][0])
          and outs["banded"][0].shape == (4 * CLI_BAND_HW[0], 4 * CLI_BAND_HW[1], 3),
          "7c: the banded CLI run's PNG pixels differ from the unbanded run's")
    check(outs["banded"][1] > 0 and outs["banded"][2] > 0, f"7c: banded CLI launches {outs['banded'][1:]}")
    print(json.dumps({"phase": "7c", "what": f"CLI on a {CLI_BAND_HW[1]}x{CLI_BAND_HW[0]} PNG, "
                      f"REALSR_TPU_BAND_BUDGET_MB={CLI_BAND_BUDGET} vs 2048",
                      "pixels_equal": True, "k1_k6_launches": {k: v[1:] for k, v in outs.items()},
                      "card": card}), flush=True)

    # 7d: process_cpu on the card engine
    tiny = np.random.default_rng(11).integers(0, 256, (48, 64, 3), np.uint8)
    before = engine.process(tiny)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    cpu_out, s_cpu = timed(lambda: engine.process_cpu(tiny))
    _, s_cpu2 = timed(lambda: engine.process_cpu(tiny))
    same, dmax = u8_same(cpu_out, plain32.process(tiny))
    after = engine.process(tiny)
    sib = engine._cpu_sibling
    check(sib is not None and sib.device.platform == "cpu" and sib.variant == "dense", "7d: no CPU sibling")
    check(same >= SAME_MIN and dmax <= 1, f"7d: process_cpu vs float32 plain card engine {same}, max diff {dmax}")
    check(np.array_equal(before, after), "7d: the card engine's output moved after process_cpu")
    check(flags == (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32), "7d: TF32 flags moved")
    print(json.dumps({"phase": "7d", "what": "process_cpu on the mixed card engine, 64x48 RGB, vs float32 plain card "
                      "engine", "equal_u8_share": same, "max_diff": dmax, "card_engine_bit_equal_after": True,
                      "sibling": {"tilesize": sib.tilesize, "variant": sib.variant, "storage": str(sib.storage_dtype)},
                      "first_call_s": s_cpu, "second_call_s": s_cpu2, "card": card}), flush=True)

    # 7e: the generic executor at full width against the dense fast path
    gen = load_model(mparam, mbin, allow_fast_path=False)
    fast = load_model(mparam, mbin, variant="dense")
    check(gen.spec is None and gen.scale == 4, "7e: the generic bundle kept the fast path")
    gp = {k: {kk: torch.as_tensor(v).to(dev) for kk, v in rec.items()} for k, rec in gen.params.items()}
    fp = {k: {kk: torch.as_tensor(v).to(dev) for kk, v in rec.items()} for k, rec in fast.params.items()}
    x = torch.rand((B, SIDE, SIDE, 3), generator=torch.Generator().manual_seed(12)).to(dev)
    with torch.no_grad(), tf32(False):
        y_gen = gen.forward(gp, x)
        y_fast = fast.forward(fp, x)
        torch.cuda.synchronize()
        err, rel = rel_err(y_gen, y_fast)
        check(tuple(y_gen.shape) == (B, 4 * SIDE, 4 * SIDE, 3) and bool(torch.isfinite(y_gen).all()) and rel <= 1e-4,
              f"7e: generic executor vs dense fast path: rel {rel} > 1e-4, or shape {tuple(y_gen.shape)}")
        ms_gen = cuda_ms(lambda: gen.forward(gp, x), 1, 2)
        ms_fast = cuda_ms(lambda: fast.forward(fp, x), 1, 2)
    del gp, fp, x, y_gen, y_fast
    torch.cuda.empty_cache()
    # a graph the RRDBNet matcher rejects: the DF2K graph, bilinear upsamplers
    with open(mparam) as f:
        text = f.read().replace("0=1 1=2.0 2=2.0", "0=2 1=2.0 2=2.0")
    check("0=2 1=2.0 2=2.0" in text, "7e: no upsampler Interp to switch to bilinear")
    rej_dir = os.path.join(work, "models-DF2K-bilinear")
    os.makedirs(rej_dir)
    with open(os.path.join(rej_dir, "x4.param"), "w") as f:
        f.write(text)
    write_weights(parse_param(text), synth_weights(parse_param(text), seed=0, stats="trained"),
                  os.path.join(rej_dir, "x4.bin"))
    rej = RealSR(gpuid=gpu, config=EngineConfig())
    rej.load(os.path.join(rej_dir, "x4.param"), os.path.join(rej_dir, "x4.bin"))
    check(rej.bundle.spec is None and rej.variant is None, "7e: the matcher accepted the bilinear graph")
    src = os.path.join(work, "rej.png")
    Image.fromarray(np.random.default_rng(13).integers(0, 256, (96, 128, 4), np.uint8)).save(src)
    dst = os.path.join(work, "rej_out.png")
    (_, counts, k6, _, _), s_rej = timed(lambda: run_cli(cli, rk, tk, ["-i", src, "-o", dst, "-m", rej_dir, "-g", "0"]))
    with Image.open(dst) as im:
        rej_out = np.asarray(im)
    check(rej_out.shape == (384, 512, 4) and sum(counts.values()) == 0 and k6 == 0,
          f"7e: rejected graph's CLI output {rej_out.shape}, kernel launches {counts}, K6 {k6}")
    print(json.dumps({"phase": "7e", "what": "generic executor, DF2K graph, float32 (TF32 off), "
                      f"{B}x{SIDE}x{SIDE} tiles, vs dense fast path", "max_abs_err": err, "rel_err": rel,
                      "executor_ms": ms_gen, "fast_path_ms": ms_fast,
                      "rejected_graph_cli": {"png": list(rej_out.shape), "kernel_launches": 0, "s": s_rej},
                      "card": card}), flush=True)

    # 7f: the dense and scatter variants keep the interleaved tail on "auto"
    tails = {}
    for variant in ("dense", "scatter"):
        for storage in ("mixed", "float32"):
            e = RealSR(gpuid=gpu, config=EngineConfig(variant=variant, storage=storage))
            with_env({"REALSR_TPU_PACKED_TAIL": None}, lambda: e.load(mparam, mbin))
            tails[f"{variant} {storage}"] = e.tail
    check(set(tails.values()) == {"interleaved"}, f"7f: auto tails {tails}")
    print(json.dumps({"phase": "7f", "what": 'tail="auto" on the card', "tails": tails,
                      "cuda (default engine)": engine.tail, "card": card}), flush=True)


def kernel_at(rk, tk, mparam, mbin, dev, b_, side) -> dict:
    """Phase 8a at one chunk shape: K1 and K6, mixed and float32, against
    their plain versions with phase 3's tolerances, each timed beside its
    plain version and its bound: {kernel: {max_abs_err, ms, plain_ms,
    bound_ms, bound_by}}."""
    from realsr_tpu_torch.loader import load_model
    from realsr_tpu_torch.models.rrdbnet import tf32

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(side)
    x = torch.from_numpy(rng.normal(0.0, 0.5, (b_, side, side, NF)).astype(np.float32)).to(dev)
    p1 = np.abs(rng.normal(0.0, 0.5, (b_, side + 1, side + 1, 4 * NF))).astype(np.float32)
    macs = RDB_MACS_PER_PX * b_ * side * side
    tail_macs = b_ * 16 * side * side * tk.tail_macs_per_pixel(True)
    rows = {}
    for mode, op in (("mixed", torch.bfloat16), ("float32", torch.float32)):
        key = "K1" if mode == "mixed" else "K1 float32"
        bundle = load_model(mparam, mbin, torch.float32, op, variant="cuda")
        p0 = rk._rdb_k({k: v.to(dev) for k, v in bundle.params["rdb"].items()}, 0)
        geo = (rk.rdb_geometry if mode == "mixed" else rk.tf32_geometry)(b_, side, side, NF, GC, sms)
        with tf32(False):
            got = rk.rdb_apply(x, p0)
            torch.cuda.synchronize()
            want = rk.rdb_reference(x, p0, torch.float32, op)
            err, rel = rel_err(got, want)
            check(bool(torch.isfinite(got).all()) and rel <= RDB_TOL[mode] and torch.equal(got, rk.rdb_apply(x, p0)),
                  f"8a {key} at {b_} x {side}²: rel {rel} > {RDB_TOL[mode]}, non-finite, or two runs differ")
            if mode == "mixed":
                xs = x.to(torch.bfloat16)  # as the trunk runs it, on the bf16 plane
                ms = cuda_ms(lambda: rk._rdb_wgmma(x, xs, p0, None, False), 2, 10)
                moved = nbytes(x, p0["wg"], p0["b"], x)
                del xs
            else:
                ms = cuda_ms(lambda: rk.rdb_apply(x, p0), 2, 10)
                moved = nbytes(x, p0["wt"], p0["b"], x)
            pms = cuda_ms(lambda: rk.rdb_reference(x, p0, torch.float32, op), 1, 3)
        b_ms, b_by = bound(macs, moved, tf32=mode == "float32")
        rows[key] = {"max_abs_err": err, "rel": rel, "ms": ms, "plain_ms": pms, "bound_ms": b_ms,
                     "bound_by": b_by, "patch_side": geo.tile}
        del p0, got, want, bundle
        # K6: up1's packed phases in, [B, 4H, 4W, 3] f32 out
        key = "K6" if mode == "mixed" else "K6 float32"
        bundle = load_model(mparam, mbin, torch.float32, torch.bfloat16, tail="kernel")
        tp16 = {k: v.to(dev) for k, v in bundle.params["tail"].items()}
        tp32 = {k: v.to(dev) for k, v in tk.pack_tail_params(bundle.params, torch.float32).items()}
        if mode == "mixed":
            xin = torch.from_numpy(p1).to(dev, torch.bfloat16)
            with tf32(False):
                err, e_k, e_p, ms, pms = tail_check(tk, "up2_hr_last_packed", xin, tp16, tp32, True)
            moved = nbytes(xin, *tp16.values()) + b_ * 16 * side * side * 3 * 4
            geo = tk.tail_geometry(b_, side, side, True, sms)
            extra = {"vs_float32_plain": e_k, "plain_bf16_vs_float32": e_p}
        else:
            xin = torch.from_numpy(p1).to(dev)
            with tf32(False):
                got = tk.up2_hr_last_packed(xin, tp32)
                torch.cuda.synchronize()
                want = tk.up2_hr_last_reference(xin, tp32)
                err, rel = rel_err(got, want)
                check(tuple(got.shape) == (b_, 4 * side, 4 * side, 3) and bool(torch.isfinite(got).all())
                      and rel <= RDB_TOL["float32"] and torch.equal(got, tk.up2_hr_last_packed(xin, tp32)),
                      f"8a K6 float32 at {b_} x {side}²: rel {rel} > {RDB_TOL['float32']}, bad shape or two runs differ")
                ms = cuda_ms(lambda: tk.up2_hr_last_packed(xin, tp32), 2, 10)
                pms = cuda_ms(lambda: tk.up2_hr_last_reference(xin, tp32), 1, 2)
                del got, want
            w_keys = ("w2t", "b2", "w1t", "b1", "w9t", "b3")
            moved = nbytes(xin, *(tp32[k] for k in w_keys)) + b_ * 16 * side * side * 12
            geo = tk.tail_tf32_geometry(b_, side, side, True, sms)
            extra = {"rel": rel}
        b_ms, b_by = bound(tail_macs, moved, tf32=mode == "float32")
        rows[key] = {"max_abs_err": err, **extra, "ms": ms, "plain_ms": pms, "bound_ms": b_ms, "bound_by": b_by,
                     "patch": list(geo.tile)}
        del xin, tp16, tp32, bundle
        torch.cuda.empty_cache()
    del x
    torch.cuda.empty_cache()
    return rows


def slice10_pick(rk, tk, mparam, mbin, card, auto_engine, engine, plain32, kern32, kern32_auto) -> dict:
    """Phase 8, the per-image tile pick: K1/K6 at the new chunk shapes, the
    rate anchors, the pick on four images, the picked engine against the
    tile-128 engine by PSNR against float32, the float32 engine at its pick
    against the float32 plain engine by phase 5's u8 parity, banded against
    whole under the pick, and output MP/s with the pick and at 128. Returns
    phase 8a's rows by shape ({"8x212": {kernel: row}, ...})."""
    from realsr_tpu_torch.engine import EngineConfig, RealSR
    from realsr_tpu_torch.tiling import calibrate, planner

    dev = engine.device.torch_device
    check(auto_engine.tilesize == 0 and auto_engine.variant == "cuda", "8: the default engine does not pick per image")
    # 8a: K1 and K6 at the chunk shapes of tiles 192 and 256
    shapes = {}
    for b_, tile in ((8, 192), (6, 256)):
        side = tile + 2 * auto_engine.prepadding
        check(auto_engine._auto_batch(tile) == b_, f"8a: tile {tile} runs chunks of {auto_engine._auto_batch(tile)}")
        rows = kernel_at(rk, tk, mparam, mbin, dev, b_, side)
        shapes[f"{b_}x{side}"] = rows
        print(json.dumps({"phase": "8a", "what": f"K1 / K6, mixed and float32, at {b_} x {side}² against plain "
                          "(phase 3's tolerances), two runs bit-equal", "rows": rows, "card": card}), flush=True)

    # 8b: the anchors, as python -m realsr_tpu_torch.tiling.calibrate measures them
    measured = calibrate.measure(auto_engine)
    spec = calibrate.anchors_spec(measured)
    print(json.dumps({"phase": "8b", "what": "rate anchors: the default engine's forward per padded pixel",
                      "chunks": {s: {"batch": b, "ms": ms, "us_per_padded_px": us} for s, (b, ms, us)
                                 in measured.items()},
                      "REALSR_TPU_RATE_ANCHORS": spec, "shipped": planner._RATE_ANCHORS, "card": card}), flush=True)

    # 8c/8d/8e: the pick on four images; each picked output against the
    # tile-128 engine's by PSNR against a float32 engine at the same tile
    images = {
        "1024x768 RGB 1/f": natural_image(np.random.default_rng(1), *STEADY_HW),
        "1000x700 RGBA": np.random.default_rng(7).integers(0, 256, (*BAND_HW, 4), np.uint8),
        "4096x3072 RGB": np.random.default_rng(10).integers(0, 256, (*CLI_BAND_HW, 3), np.uint8),
        "200x150 RGB": np.random.default_rng(14).integers(0, 256, (150, 200, 3), np.uint8),
    }
    refs: dict = {("plain", TILE128): plain32, ("kernel", TILE128): kern32}

    def ref_engine(kind: str, tile: int):
        # float32 plain (dense convs) for the small images; the float32
        # kernel engine, held to it by phase 5, for the 12.6 MP one
        if (kind, tile) not in refs:
            cfg = dict(storage="float32", tilesize=tile)
            if kind == "plain":
                cfg.update(variant="dense", tail="interleaved")
            refs[(kind, tile)] = RealSR(gpuid=0, config=EngineConfig(**cfg))
            refs[(kind, tile)].load(mparam, mbin)
        return refs[(kind, tile)]

    picks = {}
    for label, img in images.items():
        h, w, c = img.shape
        tile = auto_engine._pick_tilesize(w, h)
        work = {t: sum(len(ix) * ph * pw for (ph, pw), ix in planner.plan_tiles(w, h, t, 10).buckets.items())
                for t in (128, 192, 256)}
        got = auto_engine.process(img)
        check(auto_engine.last_tilesize == tile and got.shape == (4 * h, 4 * w, c), f"8c {label}: tile or shape")
        t128 = engine.process(img)
        kind = "kernel" if h * w > 4e6 else "plain"
        ref_pick = ref_engine(kind, tile).process(img)
        db_pick = psnr(got, ref_pick)
        db_128 = psnr(t128, ref_engine(kind, TILE128).process(img))
        check(db_pick >= db_128 - PSNR_SLACK,
              f"8d {label}: tile {tile} vs float32 {db_pick:.2f} dB, below tile 128's {db_128:.2f} dB by more "
              f"than {PSNR_SLACK} dB")
        row = {"tile": tile, "padded_px_by_tile": work, "psnr_vs_float32_at_its_tile": db_pick,
               "tile128_psnr_vs_float32": db_128, "float32_reference": f"{kind} float32 engine"}
        if kind == "plain":
            # the float32 kernel engine at its own pick against the float32
            # plain engine at that tile, by phase 5's u8 parity gate
            tile32 = kern32_auto._pick_tilesize(w, h)
            got32 = kern32_auto.process(img)
            want32 = ref_pick if tile32 == tile else ref_engine("plain", tile32).process(img)
            same, dmax = u8_same(got32, want32)
            check(kern32_auto.last_tilesize == tile32 and same >= SAME_MIN and dmax <= 1,
                  f"8d {label}: float32 engine at tile {kern32_auto.last_tilesize} (pick {tile32}) vs float32 "
                  f"plain: {same} of u8 values equal (want >= {SAME_MIN}), max diff {dmax}")
            row["float32_at_its_pick"] = {"tile": tile32, "equal_u8_share_vs_plain": same, "max_diff": dmax}
            del got32, want32
        if label == "200x150 RGB":
            # a small image stays small: the pick pads no more than tile 128
            check(work[tile] <= work[128], f"8c {label}: tile {tile} pads {work[tile]} px > tile 128's {work[128]}")
        if c == 4:
            # 8e: banded against whole under the pick
            banded = auto_engine.process_banded(img, band_tile_rows=1)
            check(auto_engine.last_tilesize == tile and np.array_equal(banded, got),
                  f"8e {label}: banded under the pick (tile {auto_engine.last_tilesize}) not bit-equal to whole")
            row["banded_bit_equal"] = True
        picks[label] = row
        del got, t128
    check(picks["200x150 RGB"]["tile"] <= 256 and picks["1024x768 RGB 1/f"]["tile"] in (128, 192, 256), "8c: picks")
    print(json.dumps({"phase": "8c-e", "what": "the pick per image (default engine) vs tile 128", "images": picks,
                      "card": card}), flush=True)
    del refs

    # 8f: device-resident output MP/s, the pick against tile 128, in turns
    big = images["1024x768 RGB 1/f"]
    big_mp = 16 * big.shape[0] * big.shape[1] / 1e6
    runs: dict = {"pick": [], "128": []}
    for order in (("pick", "128"), ("128", "pick")):
        for k in order:
            runs[k].append(steady_s(auto_engine if k == "pick" else engine, big))
    s_pick, s_128 = (float(np.median(runs[k])) for k in ("pick", "128"))
    print(json.dumps({"phase": "8f", "what": f"steady {STEADY_HW[1]}x{STEADY_HW[0]} RGB, mixed, device-resident",
                      "tile_picked": auto_engine._pick_tilesize(big.shape[1], big.shape[0]),
                      "pick_s": s_pick, "tile128_s": s_128, "pick_out_mp_s": big_mp / s_pick,
                      "tile128_out_mp_s": big_mp / s_128, "card": card}), flush=True)
    return shapes


def shard_launches(m, x: np.ndarray, rk, tk) -> tuple:
    """``m.process(x)`` on a mesh engine, and its K1 / K6 launches per
    shard ([[K1, K6], ...]), each chunk's charged to the one shard whose
    private output that chunk changed. The outputs are compared before and
    after every chunk, so this measures where the engine wrote, not its
    dealing rule: a chunk that changes no output or more than one fails."""
    per = [[0, 0] for _ in range(m.mesh.size)]
    st = {"shards": [], "snap": [], "pending": None}
    inner_shards, inner_chunk, inner_merge = m._shards, m._run_chunk, m._merge

    def settle():
        if st["pending"] is not None:
            changed = [k for k, (sh, old) in enumerate(zip(st["shards"], st["snap"])) if not torch.equal(sh[2], old)]
            check(len(changed) == 1, f"9: a chunk changed the outputs of shards {changed}, not of one")
            per[changed[0]][0] += st["pending"][0]
            per[changed[0]][1] += st["pending"][1]
            st["pending"] = None
        st["snap"] = [sh[2].clone() for sh in st["shards"]]

    def shards(*args, **kwargs):
        st["shards"], st["pending"] = inner_shards(*args, **kwargs), None
        settle()
        return st["shards"]

    def chunk(*args, **kwargs):
        settle()
        r0, t0 = k1_k6(rk, tk)
        out = inner_chunk(*args, **kwargs)
        r1, t1 = k1_k6(rk, tk)
        st["pending"] = (r1 - r0, t1 - t0)
        return out

    def merge(parts):
        settle()
        return inner_merge(parts)

    m._shards, m._run_chunk, m._merge = shards, chunk, merge
    try:
        got = m.process(x)
    finally:
        del m._shards, m._run_chunk, m._merge
    return got, per


def slice10_mesh(cli, rk, tk, mparam, mbin, work, card, auto_engine, auto_tta, single32, one_in, one_out) -> None:
    """Phase 9, mesh mode on one card: a mesh of two shards of cuda:0
    against the single engine (mixed, float32, TTA on a ragged RGBA image,
    banded), the CLI with REALSR_TPU_MESH=all, and K1/K6 launches per
    shard."""
    from PIL import Image

    from realsr_tpu_torch.engine import EngineConfig, RealSR
    from realsr_tpu_torch.parallel.mesh import make_mesh

    dev = auto_engine.device.torch_device
    mesh = make_mesh([dev, dev])
    img = natural_image(np.random.default_rng(1), *STEADY_HW)
    rgba = np.random.default_rng(7).integers(0, 256, (*BAND_HW, 4), np.uint8)
    ragged = np.random.default_rng(15).integers(0, 256, (250, 333, 4), np.uint8)
    rows = {}
    for label, single, cfg, tta in (("mixed", auto_engine, {}, False),
                                    ("float32", single32, {"storage": "float32"}, False),
                                    ("mixed TTA", auto_tta, {}, True)):
        m = RealSR(tta_mode=tta, config=EngineConfig(**cfg), mesh=mesh)
        m.load(mparam, mbin)
        x = ragged if tta else img
        zero_counts(rk, tk)
        got, per = shard_launches(m, x, rk, tk)
        want = single.process(x)
        check(np.array_equal(got, want), f"9 {label}: the 2-shard mesh is not bit-equal to the single engine")
        check(all(k6 > 0 and k1 == 69 * k6 for k1, k6 in per), f"9 {label}: K1 / K6 launches per shard {per}")
        row = {"bit_equal": True, "tile": m.last_tilesize, "k1_k6_launches_per_shard": per}
        if label == "mixed":
            banded = m.process_banded(rgba, band_tile_rows=1)
            check(np.array_equal(banded, auto_engine.process(rgba)),
                  "9: banded under the mesh not bit-equal to the single engine's whole image")
            row["banded_1000x700_rgba_bit_equal"] = True
        rows[label] = row
        del m, got, want
    torch.cuda.empty_cache()
    # the CLI, one mesh engine over every card (one here)
    out = os.path.join(work, "b_mesh.png")
    _, counts, k6, _, _ = run_cli(cli, rk, tk, ["-i", one_in, "-o", out, "-m", os.path.dirname(mparam), "-g", "0",
                                             "-v"], {"REALSR_TPU_MESH": "all"})
    with Image.open(out) as a, Image.open(one_out) as b:
        check(np.array_equal(np.asarray(a), np.asarray(b)), "9: REALSR_TPU_MESH=all CLI PNG differs from the single run")
    check(counts["rdb_apply"] > 0 and k6 > 0, f"9: mesh CLI launches {counts}, K6 {k6}")
    rows["CLI REALSR_TPU_MESH=all"] = {"pixels_equal_to_single_cli": True, "k1": counts["rdb_apply"], "k6": k6}
    print(json.dumps({"phase": "9", "what": f"make_mesh([{dev}, {dev}]) vs the single engine, "
                      f"{STEADY_HW[1]}x{STEADY_HW[0]} RGB (TTA: 333x250 RGBA)", "runs": rows, "card": card}),
          flush=True)


def eagerly(eng, fn):
    """``fn()`` with ``eng``'s chunks launched from Python (its config's
    ``cuda_graphs`` off), its config back after."""
    config = eng.config
    eng.config = dataclasses.replace(config, cuda_graphs=False)
    try:
        return fn()
    finally:
        eng.config = config


def kernel_of(name: str):
    """Which kernel (K1, K1 float32, K3-K7) a profiler row of that name is,
    demangled or not, or None."""
    for key, tag in (("K1 float32", "rdb_tf32_kernel"), ("K1", "rdb_kernel"), ("K3", "chained_kernel"),
                     ("K4", "paired_kernel"), ("K5", "packed_kernel")):
        if tag in name:
            return key
    if "tail_kernel" in name:
        return "K6" if "true" in name or "ELb1E" in name else "K7"
    return None


def profiled(fn) -> tuple:
    """One ``fn()`` under torch.profiler: ({K1..K7: device rows}, [(count,
    name)] of every device row, device ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the profiler keeps only device records inside its window on the
        # host's clock: idle margins keep a skew between the clocks from
        # cutting kernels off at either end
        time.sleep(0.05)
        fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    nodes: dict = {}
    rows = []
    dev_ms = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev_ms += e.self_device_time_total / 1e3
        rows.append((e.count, e.key[:80]))
        k = kernel_of(e.key)
        if k is not None:
            nodes[k] = nodes.get(k, 0) + e.count
    return nodes, sorted(rows, reverse=True), dev_ms


def replay_nodes(eng, img: np.ndarray) -> tuple:
    """One profiled ``process_device`` of an image whose programs are all
    captured: ({kernel: device rows}, chunks replayed, wall s, idle share of
    the wall time)."""
    before = GRAPH_COUNTS["replays"]
    n_prog = len(eng.programs())
    times = []

    def run():
        t0 = time.perf_counter()
        eng.process_device(img)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)

    nodes, _, dev_ms = profiled(run)
    check(len(eng.programs()) == n_prog, "11c: the profiled image captured a program")
    chunks = GRAPH_COUNTS["replays"] - before
    return nodes, chunks, times[0], (1 - dev_ms / (1e3 * times[0])) if dev_ms else None


# phase 11b: the kernel each wrapper launches, as kernel_of names it
WRAPPER_KERNEL = {"rdb_apply": "K1", "rdb_apply_chained": "K3", "rdb_apply_paired": "K4", "rdb_apply_packed": "K5",
                  "up2_hr_last_packed": "K6", "hr_last_packed": "K7"}


def program_nodes(eng, key) -> tuple:
    """One replay of the program of ``key`` alone under torch.profiler:
    (the kernels its recording counted, {kernel: device rows} of up to three
    profiles until one matches, every device row of the last)."""
    p = eng.programs()[key]
    want: dict = {}
    for w, n in p.graph.launches.items():
        k = WRAPPER_KERNEL[w]
        k = "K1 float32" if k == "K1" and eng.op_dtype == torch.float32 else k
        want[k] = want.get(k, 0) + n
    attempts = []
    for _ in range(3):
        nodes, rows, _ = profiled(p.graph.replay)
        attempts.append(nodes)
        if nodes == want:
            break
    return want, attempts, rows


# phases 11b and 11e in a fresh process: late in the smoke's own process the
# profiler dropped kernel records of a replay (57 of one program's 69 float32
# K1 nodes, alike in three profiles, while 11a held that replay's output
# bit-equal to eager and a fresh process counted all 69; the cause is not
# known). Each engine captures its programs for an image by precompile;
# then the shared pool's size (its segments in the allocator's snapshot)
# and, for each program, the kernel rows of one replay alone against its
# recording's launches.
FRESH = """
import json, sys
import torch
sys.path.insert(0, sys.argv[3])
import chip_smoke as cs
from realsr_tpu_torch import engine as em
from realsr_tpu_torch.ops import rdb_kernel as rk
from realsr_tpu_torch.ops import tail_kernel as tk
cs.thread_counts(rk, tk)
em._CudaGraph = cs.counting(em._CudaGraph, rk, tk)
m, b = sys.argv[1:3]
dev = torch.device("cuda", 0)
out = []
for label, tta, cfg, w, h in (("default", False, {}, 1024, 768), ("TTA", True, {}, 1024, 768),
                              ("float32", False, {"storage": "float32"}, 1024, 768),
                              ("float32", False, {"storage": "float32"}, 300, 200),
                              ("chained", False, {"tilesize": 128, "trunk": "chained"}, 300, 200),
                              ("paired", False, {"tilesize": 128, "trunk": "paired"}, 300, 200),
                              ("packed", False, {"tilesize": 128, "sched": "packed"}, 300, 200),
                              ("K7 tail", False, {"tilesize": 128, "tail": "kernel_hr"}, 300, 200)):
    e = em.RealSR(gpuid=0, tta_mode=tta, config=em.EngineConfig(**cfg))
    e.load(m, b)
    e.precompile(w, h)
    pool = tuple(em._device_state(dev).pool)
    seg = sum(s["total_size"] for s in torch.cuda.memory_snapshot() if tuple(s.get("segment_pool_id", ())) == pool)
    nodes = {}
    for key in sorted(e.program_keys(w, h), key=str):
        want, attempts, rows = cs.program_nodes(e, key)
        nodes[str(key[1:4])] = {"want": want, "profiles": attempts, "rows": rows[:6] if attempts[-1] != want else []}
    out.append({"engine": f"{label} {w}x{h}", "pool_growth": {str(k[1:4]): p.graph.pool_bytes
                                                               for k, p in e.programs().items()},
                "pool_bytes": seg, "reserved": torch.cuda.memory_reserved(dev), "nodes": nodes})
print(json.dumps(out))
"""


def slice11(rk, tk, mparam, mbin, card, auto_engine, engine, kern32_auto, auto_tta, modes, k7_engine,
            big_band) -> None:
    """Phase 11, the run-time dispatch: graph replay against the eager path
    of the same engine (bit-equal), one replay's kernel nodes by the
    profiler, steady MP/s and idle share graphs against eager, the download
    of one image overlapping the next image's compute, each program's
    capture cost and the pool, precompile on a fresh engine, and a directory
    of photos of mixed sizes file to file, graphs against eager."""
    from realsr_tpu_torch import engine as engine_mod
    from realsr_tpu_torch.engine import EngineConfig, RealSR
    from realsr_tpu_torch.ops import build
    from realsr_tpu_torch.parallel.mesh import make_mesh

    dev = auto_engine.device.torch_device
    big = natural_image(np.random.default_rng(1), *STEADY_HW)
    big_mp = 16 * big.shape[0] * big.shape[1] / 1e6
    small = np.random.default_rng(16).integers(0, 256, (200, 300, 3), np.uint8)
    tta_img = natural_image(np.random.default_rng(17), 192, 256)
    rgba = np.random.default_rng(7).integers(0, 256, (*BAND_HW, 4), np.uint8)
    check(all(e.graphs for e in (auto_engine, engine, kern32_auto, auto_tta, k7_engine, *modes.values())),
          "11: an engine of the card runs eagerly")

    # 11a: graph replay bit-equal to the eager path of the same engine
    m = RealSR(config=EngineConfig(), mesh=make_mesh([dev, dev]))
    m.load(mparam, mbin)
    cases = [
        ("default at its pick, 1024x768", auto_engine, big, lambda e: e.process(big)),
        ("default at tile 128, 1024x768", engine, big, lambda e: e.process(big)),
        ("float32 auto at its pick, 300x200", kern32_auto, small, lambda e: e.process(small)),
        ("TTA at its pick, 256x192", auto_tta, tta_img, lambda e: e.process(tta_img)),
        ("1000x700 RGBA banded, 1 tile row a band", auto_engine, rgba,
         lambda e: e.process_banded(rgba, band_tile_rows=1)),
        *((f"{mode} trunk ({e.trunk}, {e.sched}), tile 128, 300x200", e, small, lambda e: e.process(small))
          for mode, e in modes.items()),
        ("K7 tail (kernel_hr), tile 128, 300x200", k7_engine, small, lambda e: e.process(small)),
        (f"make_mesh([{dev}, {dev}]), 1024x768", m, big, lambda e: e.process(big)),
    ]
    rows = {}
    for label, eng, img, fn in cases:
        eng.precompile(img.shape[1], img.shape[0], img.shape[2])
        zero_counts(rk, tk)
        got = fn(eng)
        check(GRAPH_COUNTS["captures"] == 0 and GRAPH_COUNTS["replays"] > 0,
              f"11a {label}: after precompile {GRAPH_COUNTS['captures']} captures, {GRAPH_COUNTS['replays']} replays")
        replays = GRAPH_COUNTS["replays"]
        want = eagerly(eng, lambda: fn(eng))
        check(np.array_equal(got, want), f"11a {label}: the graph replay differs from the eager path")
        rows[label] = {"bit_equal": True, "replays": replays, "programs": len(eng.programs()),
                       "tile": eng.last_tilesize}
    check(np.array_equal(auto_engine.process(rgba), auto_engine.process_banded(rgba, band_tile_rows=1)),
          "11a: banded replay not bit-equal to the whole image's replay")
    print(json.dumps({"phase": "11a", "what": "process through the chunk program table after precompile (every chunk "
                      "a replay) vs the same engine eagerly (config.cuda_graphs off)", "runs": rows, "card": card}),
          flush=True)

    # 11b (and 11e's pool per key): a fresh process
    r = subprocess.run([sys.executable, "-c", FRESH, mparam, mbin, ROOT], capture_output=True, text=True,
                       timeout=300, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
    check(r.returncode == 0, f"11b/11e: the fresh process failed: {r.stderr[-2000:]}")
    fresh = json.loads(r.stdout.strip().splitlines()[-1])
    rows = {}
    for run in fresh:
        for key, n in run["nodes"].items():
            check(n["profiles"][-1] == n["want"] and sum(n["want"].values()) == 70,
                  f"11b {run['engine']} {key}: kernel rows {n['profiles']} of one replay, want {n['want']} (the "
                  f"capture's launches); device rows of the last profile: {n['rows']}")
            rows[f"{run['engine']} {key}"] = {"kernel_nodes": n["profiles"][-1], "profiles": len(n["profiles"])}
    print(json.dumps({"phase": "11b", "what": "kernel rows of each program's replay alone, in a fresh process (69 of "
                      "the trunk's kernel, 1 of the tail's, as its recording counted)", "programs": rows,
                      "card": card}), flush=True)

    # 11c: steady process_device MP/s, graphs against eager, in turns
    def one_s(eng, img) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.process_device(img)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    rows = {}
    for label, eng in (("mixed at its pick", auto_engine), ("float32 auto at its pick", kern32_auto)):
        runs: dict = {"graphs": [], "eager": []}
        eng.precompile(big.shape[1], big.shape[0])
        one_s(eng, big)
        eagerly(eng, lambda: one_s(eng, big))
        for order in (("graphs", "eager"), ("eager", "graphs")) * 3:
            for k in order:
                runs[k].append(one_s(eng, big) if k == "graphs" else eagerly(eng, lambda: one_s(eng, big)))
        s_g, s_e = (float(np.median(runs[k])) for k in ("graphs", "eager"))
        idle_g = replay_nodes(eng, big)[3]
        wall_e, groups_e, _ = eagerly(eng, lambda: profile_image(eng, big))
        dev_e = sum(groups_e.values())
        rows[label] = {"tile": eng.last_tilesize, "graphs_s": s_g, "eager_s": s_e, "graphs_out_mp_s": big_mp / s_g,
                       "eager_out_mp_s": big_mp / s_e, "graphs_idle_share": idle_g,
                       "eager_idle_share": (1 - dev_e / (1e3 * wall_e)) if dev_e else None}
    print(json.dumps({"phase": "11c", "what": f"steady process_device {STEADY_HW[1]}x{STEADY_HW[0]} RGB, graphs vs "
                      "eager in turns, median of 6; idle share of one profiled image", "runs": rows, "card": card}),
          flush=True)
    s_img = rows["mixed at its pick"]["graphs_s"]

    # 11d: image 1's download while image 2 computes
    img2 = natural_image(np.random.default_rng(18), *STEADY_HW)
    # two pinned blocks into the host allocator's cache, so no timed fetch
    # pays a cudaHostAlloc
    warm = [auto_engine.fetch(auto_engine.process_device(big)) for _ in range(2)]
    del warm
    b = auto_engine.process_device(big)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = auto_engine.fetch(b)
    copy_s = time.perf_counter() - t0  # the copy alone, nothing else on the card
    limit = 3 * copy_s + 0.002
    b1 = auto_engine.process_device(big)
    b2 = auto_engine.process_device(img2)
    done1, done2 = engine_mod.done_event(b1), engine_mod.done_event(b2)
    check(done1 is not None and done2 is not None, "11d: process_device left no done event")
    done1.synchronize()
    t0 = time.perf_counter()
    got = auto_engine.fetch(b1)
    fetch_s = time.perf_counter() - t0
    busy = not done2.query()
    done2.synchronize()
    rest_s = time.perf_counter() - t0
    check(np.array_equal(got, want), "11d: the overlapped download differs")
    check(busy and fetch_s <= limit and limit < 0.5 * s_img,
          f"11d: fetch of image 1 took {fetch_s:.4f} s (limit {limit:.4f} s = 3 x the copy alone {copy_s:.4f} s + "
          f"2 ms), image 2 still computing when it returned: {busy}")
    b1 = auto_engine.process_device(big)
    b2 = auto_engine.process_device(img2)
    engine_mod.done_event(b1).synchronize()
    t0 = time.perf_counter()
    b1.cpu().numpy()
    old_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    del b, b1, b2
    print(json.dumps({"phase": "11d", "what": "fetch(image 1) after image 1's done event, image 2 enqueued behind it",
                      "fetch_s": fetch_s, "copy_alone_s": copy_s, "limit_s": limit, "image2_running_at_return": busy,
                      "image2_left_after_fetch_start_s": rest_s, "steady_image_s": s_img,
                      "old_cpu_route_s": old_s, "bytes": int(want.nbytes), "card": card}), flush=True)

    # 11e: each program's capture, the pool, and the 6200x6000 banded peak
    keys = {}
    for label, eng in (("default", auto_engine), ("tile 128", engine), ("float32", kern32_auto)):
        for key, p in eng.programs().items():
            keys[f"{label} {key[1]}x{key[2]} b{key[3]}{' tta' if key[4] else ''}{' alpha' if key[5] else ''}"] = {
                "capture_s": p.graph.capture_s, "pool_growth_bytes": p.graph.pool_bytes}
    pool_bytes = None
    try:
        pool_id = tuple(engine_mod._device_state(dev).pool)
        pool_bytes = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                         if tuple(seg.get("segment_pool_id", ())) == pool_id)
    except (TypeError, KeyError, RuntimeError) as ex:
        print(f"11e: the pool's size from memory_snapshot: not measured ({ex!r})", flush=True)
    fresh_pool = [{k: run[k] for k in ("engine", "pool_growth", "pool_bytes", "reserved")} for run in fresh]
    big_img = np.random.default_rng(9).integers(0, 256, (*BIG_HW, 3), np.uint8)
    no_budget = {"REALSR_TPU_BAND_BUDGET_MB": None}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eager_out, s_eager = timed(lambda: with_env(no_budget, lambda: eagerly(engine, lambda: engine.process(big_img))))
    peak_eager = torch.cuda.max_memory_reserved()
    peak_g, digest, s_g = big_band["graphs"]
    check(hashlib.sha256(eager_out.tobytes()).hexdigest() == digest,
          "11e: the eager banded 6200x6000 run differs from 7b's graph run")
    check(max(peak_g, peak_eager) <= 80e9, "11e: peak reserved above the card")
    del eager_out, big_img
    print(json.dumps({"phase": "11e", "what": "per program: capture s (warm-up included) and the shared pool's "
                      "growth for it; the pool's segments; peak reserved of the 6200x6000 banded image",
                      "programs": keys, "pool_bytes": pool_bytes, "fresh_process": fresh_pool,
                      "banded_6200x6000": {"graphs_peak_reserved": peak_g, "eager_peak_reserved": peak_eager,
                                           "graphs_s": s_g, "eager_s": s_eager, "bit_equal": True},
                      "card": card}), flush=True)

    # 11f: precompile on a fresh engine
    fresh = RealSR(gpuid=0, config=EngineConfig())
    fresh.load(mparam, mbin)
    t0 = time.perf_counter()
    n = fresh.precompile(big.shape[1], big.shape[0])
    s_pre = time.perf_counter() - t0
    progs = fresh.programs()
    check(n == len(progs) > 0 and set(progs) == fresh.program_keys(big.shape[1], big.shape[0]),
          f"11f: precompile returned {n}, captured {len(progs)}")
    first = one_s(fresh, big)
    check(len(fresh.programs()) == n, "11f: the first image after precompile captured a program")
    steady = float(np.median([one_s(fresh, big) for _ in range(3)]))
    print(json.dumps({"phase": "11f", "what": "precompile(1024, 768) on a fresh default engine",
                      "programs": n, "precompile_s": s_pre, "capture_s": {str(k[1:4]): p.graph.capture_s
                                                                           for k, p in progs.items()},
                      "groups": {f"{s_}[{g}]": build.BUILD_SECONDS.get((s_, g)) for s_, g in fresh.kernel_groups()},
                      "groups_note": "built by phase 2's nvcc (seconds above); precompile found them loaded",
                      "first_image_s": first, "steady_image_s": steady, "card": card}), flush=True)
    del m, fresh
    torch.cuda.empty_cache()

    slice11_mixed(rk, tk, mparam, card)


def slice11_mixed(rk, tk, mparam, card) -> None:
    """Phase 11g: the CLI on a directory of photos of mixed sizes, file to
    file (model load included), graphs against eager in turns, median of 5,
    outputs bit-equal, and the chunks each way ran (eager, computed by a
    capture, replayed). Most of its keys are met once, and they outnumber
    an engine's table."""
    from PIL import Image

    from realsr_tpu_torch import cli
    from realsr_tpu_torch.engine import RealSR

    mixed_dir = tempfile.mkdtemp(prefix="realsr_mixed_")
    in_dir = os.path.join(mixed_dir, "in")
    os.makedirs(in_dir)
    rng = np.random.default_rng(19)
    for k, (h, w) in enumerate(MIXED_HW):
        Image.fromarray(natural_image(rng, h, w)).save(os.path.join(in_dir, f"{k}.png"))
    mixed_mp = sum(16 * h * w for h, w in MIXED_HW) / 1e6
    load = RealSR.load

    def eager_load(self, *a, **kw):
        rc = load(self, *a, **kw)
        self.config = dataclasses.replace(self.config, cuda_graphs=False)
        return rc

    def dir_run(mode: str, n: int) -> dict:
        out_dir = os.path.join(mixed_dir, f"{mode}{n}")
        os.makedirs(out_dir)
        if mode == "eager":
            RealSR.load = eager_load
        try:
            zero_counts(rk, tk)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = cli.main(["-i", in_dir, "-o", out_dir, "-m", os.path.dirname(mparam), "-g", "0"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            RealSR.load = load
        check(rc == 0, f"11g: cli.main ({mode}) returned {rc}")
        chunks = executed(rk, tk)["rdb_apply"] // 69
        return {"s": wall, "dir": out_dir, "chunks": chunks,
                "eager_chunks": chunks - GRAPH_COUNTS["captures"] - GRAPH_COUNTS["replays"],
                **{k: GRAPH_COUNTS[k] for k in ("captures", "replays", "capture_s")}}

    try:
        runs = {"graphs": [], "eager": []}
        for mode in ("graphs", "eager", "eager", "graphs") * 2 + ("graphs", "eager"):
            runs[mode].append(dir_run(mode, len(runs[mode])))
        for k in range(len(MIXED_HW)):
            a, b = (np.asarray(Image.open(os.path.join(runs[m_][0]["dir"], f"{k}.png")))
                    for m_ in ("graphs", "eager"))
            check(np.array_equal(a, b), f"11g: image {k} through graphs differs from eager")
        every = runs["graphs"] + runs["eager"]
        check(len({r["chunks"] for r in every}) == 1 and every[0]["chunks"] > 0
              and all(r["captures"] == r["replays"] == 0 for r in runs["eager"]),
              f"11g: chunks {[r['chunks'] for r in every]}, captures {[r['captures'] for r in every]}, replays "
              f"{[r['replays'] for r in every]} (graphs, then eager)")
        med = {m_: float(np.median([r["s"] for r in rs])) for m_, rs in runs.items()}
        print(json.dumps({"phase": "11g", "what": f"cli.main on a directory of {len(MIXED_HW)} photos of mixed sizes "
                          f"{MIXED_HW}, file to file (model load included), graphs vs eager in turns, median of 5",
                          "output_mp": mixed_mp, "graphs_s": med["graphs"], "eager_s": med["eager"],
                          "graphs_out_mp_s": mixed_mp / med["graphs"], "eager_out_mp_s": mixed_mp / med["eager"],
                          "runs": {m_: [{k: r[k] for k in ("s", "chunks", "eager_chunks", "captures", "replays",
                                                           "capture_s")} for r in rs] for m_, rs in runs.items()},
                          "bit_equal": True, "card": card}), flush=True)
    finally:
        shutil.rmtree(mixed_dir, ignore_errors=True)


COLD_LINE = r"realsr_tpu_torch: built (\d+) kernel groups with nvcc in ([\d.]+) s \((.*)\) into"


def cold_cli(label: str, work: str, src: str, mdir: str, root: str, env=None) -> dict:
    """``python -m realsr_tpu_torch -i src -o <label>.png -m mdir`` in a
    fresh process with the build root ``root``: its wall time (the first
    output of a process, model load and builds included), the engine's
    build line (the groups nvcc built and their seconds), its exit code, its
    output (None where it wrote none) and its stderr's tail."""
    import re

    out = os.path.join(work, f"{label}.png")
    e = {**os.environ, "REALSR_TPU_TORCH_BUILD": root, **(env or {})}
    e["PYTHONPATH"] = ROOT + os.pathsep + e.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "realsr_tpu_torch", "-i", src, "-o", out, "-m", mdir],
                       capture_output=True, text=True, env=e, cwd=ROOT, timeout=600)
    wall = time.perf_counter() - t0
    m = re.search(COLD_LINE, r.stderr)
    groups = {g.group(1): float(g.group(2)) for g in re.finditer(r"(\w+\[\w+\]) ([\d.]+) s", m.group(3))} if m else {}
    return {"rc": r.returncode, "wall_s": wall, "nvcc_wall_s": float(m.group(2)) if m else 0.0,
            "nvcc_s": groups, "out": out if os.path.isfile(out) else None, "stderr": r.stderr[-1500:]}


def seed_tool(*args, env=None) -> dict:
    """``python -m realsr_tpu_torch.seed_cache *args``: its last stdout line
    as JSON, its stderr."""
    e = {**os.environ, **(env or {})}
    e["PYTHONPATH"] = ROOT + os.pathsep + e.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-m", "realsr_tpu_torch.seed_cache", *args], capture_output=True,
                       text=True, env=e, cwd=ROOT, timeout=600)
    check(r.returncode == 0, f"seed_cache {args[0]}: exit {r.returncode}: {r.stderr[-1500:]}")
    return {"json": json.loads(r.stdout.strip().splitlines()[-1]), "stderr": r.stderr}


def altered_seed(seed: str, out: str) -> str:
    """``seed`` with another fingerprint: each member moved into the other
    fingerprint's dir, the manifest's fingerprint changed to match."""
    import io
    import tarfile

    with tarfile.open(seed, "r:gz") as tar, tarfile.open(out, "w:gz") as dst:
        for m in tar.getmembers():
            fp, rest = m.name.split("/", 1)
            data = tar.extractfile(m).read()
            if rest == "seed_manifest.json":
                manifest = json.loads(data)
                manifest["fingerprint"] = fp[::-1]
                data = json.dumps(manifest).encode()
            m.name, m.size = f"{fp[::-1]}/{rest}", len(data)
            dst.addfile(m, io.BytesIO(data))
    return out


def slice12(mparam, card, auto_engine, engines: dict) -> None:
    """Phase 12, the cold start: (a) the default CLI on the 1024 x 768 image
    in a fresh process and a fresh build root, fast start on, then off
    (``REALSR_TPU_FAST_START=0``) in another fresh root, then on again in
    the first root (warm): wall time to the output and each group's nvcc
    seconds, the outputs bit-equal to each other and to the main engine's;
    (b) a seed built from (a)'s fast-start root and installed into a new
    root, the CLI there with no nvcc (PATH without it, ``CUDA_HOME``
    nowhere): bit-equal, nothing built; a seed whose fingerprint is altered
    makes the same run fail, naming the seed tool; (c) the fingerprint and
    the groups each of the smoke's engines built."""
    from PIL import Image

    from realsr_tpu_torch.ops import build

    work = tempfile.mkdtemp(prefix="realsr_cold_")
    try:
        img = natural_image(np.random.default_rng(1), *STEADY_HW)
        src = os.path.join(work, "in.png")
        Image.fromarray(img).save(src)
        want = auto_engine.process(img)
        mdir = os.path.dirname(mparam)
        torch.cuda.empty_cache()

        def same(run: dict, what: str) -> None:
            check(run["out"] is not None and run["rc"] == 0,
                  f"12: {what}: exit {run['rc']}, no output: {run['stderr']}")
            check(np.array_equal(np.asarray(Image.open(run["out"])), want),
                  f"12: {what}: output differs from the main engine's")

        # 12a: cold, fast start on and off; warm
        roots = {k: os.path.join(work, f"root_{k}") for k in ("on", "off", "seeded", "altered")}
        runs = {"on": cold_cli("on", work, src, mdir, roots["on"]),
                "off": cold_cli("off", work, src, mdir, roots["off"], {"REALSR_TPU_FAST_START": "0"})}
        runs["warm"] = cold_cli("warm", work, src, mdir, roots["on"])
        for k, r in runs.items():
            same(r, f"the CLI, {k}")
        check(set(runs["on"]["nvcc_s"]) == {"rdb_wgmma[f32_nf64]", "tail_kernel[k6]"},
              f"12a: fast start built {sorted(runs['on']['nvcc_s'])}")
        check(set(runs["off"]["nvcc_s"]) == {f"{s_}[{g}]" for s_ in ("rdb_wgmma", "tail_kernel")
                                             for g in build.GROUPS[s_]},
              f"12a: fast start off built {sorted(runs['off']['nvcc_s'])}")
        check(not runs["warm"]["nvcc_s"], f"12a: a warm root built {runs['warm']['nvcc_s']}")
        on = runs["on"]["nvcc_s"]
        print(json.dumps({"phase": "12a", "what": f"python -m realsr_tpu_torch on a {STEADY_HW[1]}x{STEADY_HW[0]} "
                          "PNG in a fresh process: fresh build root with fast start on, another with it off, "
                          "then the first root again (warm); outputs bit-equal to the main engine's",
                          **{f"{k}_wall_s": r["wall_s"] for k, r in runs.items()},
                          **{f"{k}_nvcc_wall_s": r["nvcc_wall_s"] for k, r in runs.items()},
                          **{f"{k}_nvcc_s": r["nvcc_s"] for k, r in runs.items() if k != "warm"},
                          "tail_group_ends_first": on["tail_kernel[k6]"] <= on["rdb_wgmma[f32_nf64]"],
                          "bit_equal": True, "card": card}), flush=True)

        # 12b: a seed from the fast-start root, on a host without nvcc
        seed = os.path.join(work, "seed.tar.gz")
        made = seed_tool("build", seed, "-m", mdir, env={"REALSR_TPU_TORCH_BUILD": roots["on"]})["json"]
        check(made["fingerprint"] == build.fingerprint() and not any(made["nvcc_seconds"].values()),
              f"12b: the seed's fingerprint {made['fingerprint']} or nvcc seconds {made['nvcc_seconds']}")
        info = seed_tool("info", seed)["json"]
        inst = seed_tool("install", seed, "--build-root", roots["seeded"])
        check(inst["json"]["fingerprint_match"] and "WARNING" not in inst["stderr"], f"12b: install {inst}")
        path = os.pathsep.join(p_ for p_ in os.environ.get("PATH", "").split(os.pathsep)
                               if not os.path.isfile(os.path.join(p_, "nvcc")))
        no_nvcc = {"PATH": path, "CUDA_HOME": os.path.join(work, "no_cuda")}
        check(shutil.which("nvcc", path=path) is None, "12b: nvcc still on PATH")
        seeded = cold_cli("seeded", work, src, mdir, roots["seeded"], no_nvcc)
        same(seeded, "the CLI on the installed seed without nvcc")
        check(not seeded["nvcc_s"], f"12b: the seeded run built {seeded['nvcc_s']}")
        bad = seed_tool("install", altered_seed(seed, os.path.join(work, "altered.tar.gz")),
                        "--build-root", roots["altered"])
        check(not bad["json"]["fingerprint_match"] and "WARNING" in bad["stderr"],
              f"12b: the altered seed installed as a match: {bad}")
        refused = cold_cli("altered", work, src, mdir, roots["altered"], no_nvcc)
        check(refused["out"] is None and "nvcc not found" in refused["stderr"]
              and "realsr_tpu_torch.seed_cache install" in refused["stderr"],
              f"12b: the altered seed's run: exit {refused['rc']}, output {refused['out']}: {refused['stderr']}")
        print(json.dumps({"phase": "12b", "what": "seed_cache build from 12a's fast-start root, install into a "
                          "fresh root, the CLI there with no nvcc (bit-equal, nothing built); a seed whose "
                          "fingerprint is altered: installed inert, the same run fails naming the seed tool",
                          "seed": {k: info[k] for k in ("fingerprint", "nvcc", "groups", "files")},
                          "tarball_bytes": made["tarball_bytes"], "seeded_wall_s": seeded["wall_s"],
                          "altered_error": next(ln for ln in refused["stderr"].splitlines() if "nvcc not found" in ln),
                          "card": card}),
              flush=True)

        # 12c: what this process built, and each engine's groups
        print(json.dumps({"phase": "12c", "fingerprint": build.fingerprint(), "features": build.host_features(),
                          "nvcc": build.nvcc_release(build._nvcc()),
                          "loaded": [f"{s_}[{g}]" for s_, g in build._LIBS],
                          "engines": {k: [f"{s_}[{g}]" for s_, g in e.kernel_groups()] for k, e in engines.items()},
                          "card": card}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


# phase 13, back to back (13a): the default 1024 x 768 image, and small
# images, where the host's share of an image is largest; the CUDA runtime
# calls that block the host, counted between the first and the last enqueue
B2B = ((8, STEADY_HW), (64, (192, 256)))
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy")


def pageable_upload(array, device, rows=None):
    """The upload before ``engine._upload`` (phase 13's old route): a
    pageable copy on the current stream, which synchronizes that stream."""
    return torch.tensor(array if rows is None else array[rows], device=device)


def host_allocs():
    """(pinned blocks the caching host allocator has made with CUDA, seconds
    in those calls) so far, or None where this torch keeps no such
    counters."""
    try:
        st = torch.cuda.host_memory_stats()
        return st["num_host_alloc"], st["host_alloc_time.total"] / 1e6
    except (AttributeError, KeyError, RuntimeError):
        return None


def host_alloc_delta(a, b):
    """{"blocks", "s"} made between two :func:`host_allocs` readings."""
    return None if a is None or b is None else {"blocks": b[0] - a[0], "s": b[1] - a[1]}


def by_route(route: str, fn):
    """``fn()`` with the engine's upload ``route``: "new"
    (``engine._upload``) or "old" (:func:`pageable_upload`, swapped into
    the engine module), the module's own after."""
    from realsr_tpu_torch import engine as engine_mod

    new = engine_mod._upload
    if route == "old":
        engine_mod._upload = pageable_upload
    try:
        return fn()
    finally:
        engine_mod._upload = new


def back_to_back(eng, imgs: list, threads: int = 2, mark=None) -> tuple:
    """``process_device`` on every image of ``imgs`` with no synchronize
    between them, ``threads`` threads taking them in turn as the pipeline's
    proc threads do, then one ``fetch`` each: (outputs in order, wall s).
    ``mark(name)`` (torch.profiler's record_function when profiled) spans
    the main thread's wait from the start to the last enqueue ("13
    enqueue") and to the last download ("13 run")."""
    mark = mark or (lambda name: contextlib.nullcontext())
    outs = [None] * len(imgs)
    enqueued, fetch = threading.Barrier(threads + 1), threading.Event()
    errors = []

    def proc(k: int) -> None:
        bufs = []
        try:
            bufs = [(i, eng.process_device(imgs[i])) for i in range(k, len(imgs), threads)]
        except BaseException as ex:
            errors.append(ex)
        finally:
            enqueued.wait()
        fetch.wait()  # after the enqueue mark closes
        for i, b in bufs:
            outs[i] = eng.fetch(b)

    torch.cuda.synchronize()
    workers = [threading.Thread(target=proc, args=(k,)) for k in range(threads)]
    t0 = time.perf_counter()
    with mark("13 run"):
        with mark("13 enqueue"):
            for w in workers:
                w.start()
            enqueued.wait()
        fetch.set()
        for w in workers:
            w.join()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(not errors and all(o is not None for o in outs), f"13: back to back failed: {errors!r}")
    return outs, wall


def covered(spans) -> float:
    """The length of the union of ``spans`` [(start, end)]."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > max(a, end):
            total += b - max(a, end)
            end = b
    return total


def traced_back_to_back(eng, imgs: list, route: str, threads: int = 2) -> dict:
    """One :func:`back_to_back` run under torch.profiler: the blocking CUDA
    runtime calls (:data:`SYNC_CALLS`, any thread) between the first and
    the last enqueue, and the device's idle share of the run (the union of
    its kernel rows over the run's wall time; copies run beside kernels on
    their own streams and are not counted as busy)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        by_route(route, lambda: back_to_back(eng, imgs, threads, mark=record_function))
        time.sleep(0.05)
    events = prof.events()
    spans = {e.name: e.time_range for e in events if e.name in ("13 run", "13 enqueue")}
    check(len(spans) == 2, f"13: the profile lost its marks: {sorted(spans)}")
    enq, run = spans["13 enqueue"], spans["13 run"]
    calls: dict = {}  # every CUDA runtime call in the enqueue window
    kernels = []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith(("Memcpy", "Memset")):
                kernels.append((max(e.time_range.start, run.start), min(e.time_range.end, run.end)))
        elif e.name.startswith("cuda") and enq.start <= e.time_range.start <= enq.end:
            calls[e.name] = calls.get(e.name, 0) + 1
    run_us = run.end - run.start
    return {"syncs_in_enqueue": {k: calls.get(k, 0) for k in SYNC_CALLS}, "runtime_calls_in_enqueue": calls,
            "kernel_rows": len(kernels), "enqueue_ms": (enq.end - enq.start) / 1e3,
            "run_ms": run_us / 1e3, "idle_share": (1 - covered(kernels) / run_us) if kernels else None}


def pinned_block_held(dev) -> dict:
    """The caching host allocator's event for a ``non_blocking`` copy from
    pinned memory, on the upload stream as ``engine._upload`` makes it: a
    block freed while its copy waits behind ~0.5 s of spinning is not handed
    out again, and once the copy has run it is. 100 MB: a size class (128
    MB) no earlier phase pins, so no other free block answers."""
    from realsr_tpu_torch import engine as engine_mod

    n = 100 << 20
    stream = engine_mod._device_state(dev).upload_stream
    torch.cuda.synchronize()
    host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    ptr = host.data_ptr()
    with torch.cuda.stream(stream):
        torch.cuda._sleep(1_000_000_000)  # ~0.5 s
        buf = torch.empty(n, dtype=torch.uint8, device=dev)
        buf.copy_(host, non_blocking=True)
    del host
    during = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    held = during.data_ptr() != ptr
    torch.cuda.synchronize()
    after = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    reused = after.data_ptr() == ptr
    check(held and reused, f"13a: the pinned block handed out during its copy: {not held}, after it: {reused}")
    del buf, during, after
    return {"held_while_copying": held, "reused_after": reused, "bytes": n}


def uploads_during_captures(rk, tk, mparam, mbin, imgs: list) -> dict:
    """A fresh default engine captures its programs (graphs in
    ``thread_local`` mode) on one thread while another thread uploads
    through ``engine._upload`` without pause: the captures hold and the
    outputs are the ones the smoke's default engine gives."""
    from realsr_tpu_torch import engine as engine_mod
    from realsr_tpu_torch.engine import EngineConfig, RealSR

    dev = torch.device("cuda", 0)
    fresh = RealSR(gpuid=0, config=EngineConfig())
    fresh.load(mparam, mbin)
    cls = engine_mod._CudaGraph
    windows, stamps, stop = [], [], threading.Event()
    capture = cls.capture

    def timed_capture(self, fn):
        t0 = time.perf_counter()
        try:
            capture(self, fn)
        finally:
            windows.append((t0, time.perf_counter()))

    def uploader():
        a = np.random.default_rng(41).integers(0, 256, (*STEADY_HW, 3), np.uint8)
        while not stop.is_set():
            t0 = time.perf_counter()
            engine_mod._upload(a, dev)
            stamps.append((t0, time.perf_counter()))

    cls.capture = timed_capture
    side = threading.Thread(target=uploader)
    try:
        zero_counts(rk, tk)
        side.start()
        outs = [fresh.fetch(fresh.process_device(im)) for im in imgs]
        torch.cuda.synchronize()
    finally:
        stop.set()
        side.join()
        cls.capture = capture
    inside = sum(1 for a, b in stamps if any(a < w1 and b > w0 for w0, w1 in windows))
    check(GRAPH_COUNTS["captures"] > 0 and inside > 0,
          f"13a: {GRAPH_COUNTS['captures']} captures, {inside} uploads of {len(stamps)} during them")
    return {"captures": GRAPH_COUNTS["captures"], "uploads": len(stamps), "uploads_during_captures": inside,
            "outputs": outs}


def slice13(rk, tk, mparam, mbin, card, auto_engine, engine, big_band) -> None:
    """Phase 13, the upload that does not wait for the card: (a) back-to-back
    ``process_device`` from two threads, new upload against the old
    pageable route in turns, images/s, the blocking runtime calls in the
    enqueue window and the idle share, bit-equal; the caching host
    allocator's hold on a pinned block; uploads from another thread during
    captures; (b) ``process_device`` of image 2 returning while image 1
    computes; (c) the 6200 x 6000 image banded, old and new, then whole,
    with the pinned blocks each run made, beside 7b's first runs; (d) the default CLI file to file on 11g's photos and
    on 32 copies of the 1024 x 768 image, new against old, with the peak
    memory reserved; (e) ``REALSR_TPU_PROFILE`` in a CLI subprocess: one
    trace naming K1's and K6's kernels."""
    from PIL import Image

    from realsr_tpu_torch import cli
    from realsr_tpu_torch import engine as engine_mod

    dev = auto_engine.device.torch_device
    mdir = os.path.dirname(mparam)

    # 13a: back to back, new against old in turns, median of 5
    rows, big_imgs = {}, None
    for n, (h, w) in B2B:
        imgs = [natural_image(np.random.default_rng(40 + k), h, w) for k in range(n)]
        if (h, w) == STEADY_HW:
            big_imgs = imgs
        label = f"{n} x {w}x{h}, 2 threads"
        want = {r: by_route(r, lambda: back_to_back(auto_engine, imgs))[0] for r in ("new", "old")}  # warm
        check(all(np.array_equal(a, b) for a, b in zip(want["new"], want["old"])),
              f"13a {label}: the new upload's outputs differ from the old route's")
        secs: dict = {"new": [], "old": []}
        for order in (("new", "old"), ("old", "new")) * 2 + (("new", "old"),):
            for r in order:
                outs, s_ = by_route(r, lambda: back_to_back(auto_engine, imgs))
                check(all(np.array_equal(a, b) for a, b in zip(outs, want["new"])), f"13a {label} {r}: outputs moved")
                secs[r].append(s_)
        traced = {r: traced_back_to_back(auto_engine, imgs, r) for r in ("new", "old")}
        check(not any(traced["new"]["syncs_in_enqueue"].values()),
              f"13a {label}: blocking calls in the new route's enqueue window {traced['new']['syncs_in_enqueue']}")
        check(traced["old"]["syncs_in_enqueue"]["cudaStreamSynchronize"] > 0,
              f"13a {label}: the old route showed no cudaStreamSynchronize (the count sees nothing): "
              f"{traced['old']['runtime_calls_in_enqueue']}")
        med = {r: float(np.median(v)) for r, v in secs.items()}
        rows[label] = {"tile": auto_engine.last_tilesize, "images": n, "new_s": med["new"], "old_s": med["old"],
                       "new_images_s": n / med["new"], "old_images_s": n / med["old"],
                       "new_out_mp_s": 16 * h * w * n / 1e6 / med["new"],
                       "old_out_mp_s": 16 * h * w * n / 1e6 / med["old"], "runs_s": secs,
                       "new_traced": traced["new"], "old_traced": traced["old"], "bit_equal": True}
    pinned = pinned_block_held(dev)
    cap = uploads_during_captures(rk, tk, mparam, mbin, big_imgs[:3])
    check(all(np.array_equal(a, auto_engine.process(im)) for a, im in zip(cap.pop("outputs"), big_imgs)),
          "13a: outputs of the engine that captured beside the uploads differ")
    print(json.dumps({"phase": "13a", "what": "process_device back to back from two threads, one fetch each at the "
                      "end; new upload vs the old pageable route in turns, median of 5; blocking runtime calls "
                      "between the first and the last enqueue and the idle share from one profiled run each",
                      "runs": rows, "pinned_block": pinned, "captures_beside_uploads": {**cap, "bit_equal": True},
                      "card": card}), flush=True)

    # 13b: image 2's process_device returns while image 1 computes
    def run_ahead() -> tuple:
        torch.cuda.synchronize()
        b1 = auto_engine.process_device(big_imgs[0])
        t0 = time.perf_counter()
        auto_engine.process_device(big_imgs[1])
        ret_s = time.perf_counter() - t0
        running = not engine_mod.done_event(b1).query()
        torch.cuda.synchronize()
        return running, ret_s

    ahead = {r: by_route(r, run_ahead) for r in ("new", "old")}
    check(ahead["new"][0] and not ahead["old"][0],
          f"13b: image 1 still computing when image 2's process_device returned: new {ahead['new'][0]}, "
          f"old {ahead['old'][0]}")
    print(json.dumps({"phase": "13b", "what": "process_device(image 2) right after process_device(image 1), "
                      f"{STEADY_HW[1]}x{STEADY_HW[0]}: image 1 still computing at its return",
                      **{f"{r}_image1_running": v[0] for r, v in ahead.items()},
                      **{f"{r}_return_s": v[1] for r, v in ahead.items()}, "card": card}), flush=True)

    # 13c: the 6200 x 6000 image banded, new against old, beside 7b's whole
    big = np.random.default_rng(9).integers(0, 256, (*BIG_HW, 3), np.uint8)
    out_mp = 16 * big.shape[0] * big.shape[1] / 1e6
    no_budget = {"REALSR_TPU_BAND_BUDGET_MB": None}
    secs, allocs = {}, {}
    for r, env in (("old", no_budget), ("new", no_budget), ("whole", {"REALSR_TPU_BAND_BUDGET_MB": "8192"})):
        h0 = host_allocs()
        out, s_ = timed(lambda: by_route("new" if r == "whole" else r, lambda: with_env(env, lambda: engine.process(
            big))))
        allocs[r] = host_alloc_delta(h0, host_allocs())
        check(hashlib.sha256(out.tobytes()).hexdigest() == big_band["graphs"][1],
              f"13c: the {r} output differs from 7b's")
        secs[r] = s_
        del out
    del big
    s7b = {"banded": big_band["graphs"][2], "whole": big_band["whole_s"]}
    print(json.dumps({"phase": "13c", "what": f"{BIG_HW[1]}x{BIG_HW[0]} RGB banded, old route, new route, then whole, "
                      "each after 7b's first runs; gap = 1 - banded MP/s / whole MP/s; pinned blocks each run "
                      "made (the caching host allocator's counters)", "bit_equal": True, "s": secs,
                      "out_mp_s": {r: out_mp / s_ for r, s_ in secs.items()},
                      "gap": {r: 1 - secs["whole"] / secs[r] for r in ("old", "new")}, "host_allocs": allocs,
                      "7b_s": s7b, "7b_gap": 1 - s7b["whole"] / s7b["banded"],
                      "7b_host_allocs": big_band["host_allocs"], "card": card}), flush=True)

    # 13d: the default CLI file to file, new against old
    work = tempfile.mkdtemp(prefix="realsr_upload_")
    try:
        mixed_dir, copies_dir = os.path.join(work, "mixed"), os.path.join(work, "copies")
        os.makedirs(mixed_dir)
        os.makedirs(copies_dir)
        rng = np.random.default_rng(19)  # 11g's photos
        for k, (h, w) in enumerate(MIXED_HW):
            Image.fromarray(natural_image(rng, h, w)).save(os.path.join(mixed_dir, f"{k}.png"))
        Image.fromarray(big_imgs[0]).save(os.path.join(copies_dir, "0.png"))
        for k in range(1, 32):
            shutil.copyfile(os.path.join(copies_dir, "0.png"), os.path.join(copies_dir, f"{k}.png"))

        def dir_run(src: str, route: str, n: int) -> dict:
            out = os.path.join(work, f"{os.path.basename(src)}_{route}{n}")
            os.makedirs(out)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_reserved()
            t0 = time.perf_counter()
            rc = by_route(route, lambda: cli.main(["-i", src, "-o", out, "-m", mdir, "-g", "0"]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check(rc == 0, f"13d: cli.main on {src} ({route}) returned {rc}")
            digests = {f: hashlib.sha256(open(os.path.join(out, f), "rb").read()).hexdigest()
                       for f in sorted(os.listdir(out))}
            return {"s": wall, "digests": digests, "reserved_before": before,
                    "peak_reserved": torch.cuda.max_memory_reserved()}

        rows = {}
        dir_run(mixed_dir, "new", -1)  # warm-up: the photos' first pinned blocks and cuDNN plans
        for src, mp, turns in ((mixed_dir, sum(16 * h * w for h, w in MIXED_HW) / 1e6, ("new", "old", "old", "new")),
                               (copies_dir, 32 * 16 * STEADY_HW[0] * STEADY_HW[1] / 1e6, ("new", "old"))):
            runs: dict = {"new": [], "old": []}
            for r in turns:
                runs[r].append(dir_run(src, r, len(runs[r])))
            every = runs["new"] + runs["old"]
            check(all(x["digests"] == every[0]["digests"] for x in every) and len(every[0]["digests"]) == len(
                os.listdir(src)), f"13d {src}: PNG outputs differ between routes or runs")
            med = {r: float(np.median([x["s"] for x in v])) for r, v in runs.items()}
            rows[os.path.basename(src)] = {
                "files": len(os.listdir(src)), "output_mp": mp, "new_s": med["new"], "old_s": med["old"],
                "new_out_mp_s": mp / med["new"], "old_out_mp_s": mp / med["old"],
                "runs_s": {r: [x["s"] for x in v] for r, v in runs.items()},
                "peak_reserved": {r: max(x["peak_reserved"] for x in v) for r, v in runs.items()},
                "reserved_before": {r: min(x["reserved_before"] for x in v) for r, v in runs.items()},
                "bit_equal": True}
        print(json.dumps({"phase": "13d", "what": "python -m realsr_tpu_torch's main (two proc threads, graphs on) "
                          f"on 11g's {len(MIXED_HW)} photos (a warm-up, then new, old, old, new) and on 32 copies "
                          "of the "
                          f"{STEADY_HW[1]}x{STEADY_HW[0]} PNG (new, old); PNG bytes equal; peak reserved in the run",
                          "runs": rows, "card": card}), flush=True)

        # 13e: REALSR_TPU_PROFILE in a CLI subprocess
        prof_dir = os.path.join(work, "prof")
        out = os.path.join(work, "profiled.png")
        e = {**os.environ, "REALSR_TPU_PROFILE": prof_dir}
        e["PYTHONPATH"] = ROOT + os.pathsep + e.get("PYTHONPATH", "")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "realsr_tpu_torch", "-i", os.path.join(copies_dir, "0.png"),
                            "-o", out, "-m", mdir], capture_output=True, text=True, env=e, cwd=ROOT, timeout=600)
        wall = time.perf_counter() - t0
        check(r.returncode == 0 and os.path.isfile(out), f"13e: the profiled CLI: exit {r.returncode}: "
              f"{r.stderr[-2000:]}")
        check(np.array_equal(np.asarray(Image.open(out)), auto_engine.process(big_imgs[0])),
              "13e: the profiled CLI's output differs from the default engine's")
        files = os.listdir(prof_dir)
        check(len(files) == 1 and files[0].endswith(".pt.trace.json"), f"13e: the profile dir holds {files}")
        path = os.path.join(prof_dir, files[0])
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        kernels: dict = {}
        for ev in events:
            if ev.get("cat") == "kernel":
                k = kernel_of(str(ev.get("name")))
                kernels[k or "other"] = kernels.get(k or "other", 0) + 1
        check(kernels.get("K1", 0) > 0 and kernels.get("K6", 0) > 0, f"13e: kernel rows of the trace {kernels}")
        print(json.dumps({"phase": "13e", "what": "REALSR_TPU_PROFILE=<dir> python -m realsr_tpu_torch on the "
                          f"{STEADY_HW[1]}x{STEADY_HW[0]} PNG in a subprocess: one Chrome trace",
                          "file": files[0], "bytes": os.path.getsize(path), "events": len(events),
                          "kernel_rows": kernels, "python_rows": sum(1 for ev in events
                                                                     if ev.get("cat") == "python_function"),
                          "wall_s": wall, "bit_equal": True, "card": card}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    mesh_cards(mparam, mbin, card)


def mesh_cards(mparam, mbin, card, variant: str = "auto", devs=None) -> None:
    """Phase 13f, on a host with two cards or more (else it prints that it
    is left out): a mesh of cuda:0 and cuda:1 against the engine on cuda:0,
    bit-equal; image 2's ``process_device`` returning while image 1
    computes, and no blocking runtime call while the mesh enqueues, so the
    copies of ``_shards`` (the input to each card) and ``_merge`` (each
    card's output to the first) wait for no card."""
    from realsr_tpu_torch import engine as engine_mod
    from realsr_tpu_torch.engine import EngineConfig, RealSR
    from realsr_tpu_torch.parallel.mesh import make_mesh

    if devs is None and torch.cuda.device_count() < 2:
        print(json.dumps({"phase": "13f", "what": "a mesh of two cards: left out, one card here", "card": card}),
              flush=True)
        return
    devs = devs or [torch.device("cuda", 0), torch.device("cuda", 1)]
    one = RealSR(config=EngineConfig(variant=variant), mesh=make_mesh(devs[:1]))
    one.load(mparam, mbin)
    m = RealSR(config=EngineConfig(variant=variant), mesh=make_mesh(devs))
    m.load(mparam, mbin)
    imgs = [natural_image(np.random.default_rng(50 + k), *STEADY_HW) for k in range(4)]
    for im in imgs[:2]:
        check(np.array_equal(m.process(im), one.process(im)), "13f: the two-card mesh differs from one card")
    for d in devs:
        torch.cuda.synchronize(d)
    b1 = m.process_device(imgs[2])
    t0 = time.perf_counter()
    m.process_device(imgs[3])
    ret_s = time.perf_counter() - t0
    running = not engine_mod.done_event(b1).query()
    for d in devs:
        torch.cuda.synchronize(d)
    check(np.array_equal(m.fetch(b1), one.process(imgs[2])), "13f: the run-ahead image differs")
    traced = traced_back_to_back(m, imgs, "new")
    print(json.dumps({"phase": "13f", "what": f"make_mesh([{', '.join(map(str, devs))}]) ({m.variant}) vs one card: "
                      "bit-equal; image 2 enqueued while image 1 computes; 4 images back to back from two threads",
                      "image1_running": running, "return_s": ret_s, "traced": traced, "card": card}), flush=True)
    check(running and not any(traced["syncs_in_enqueue"].values()),
          f"13f: image 1 running at image 2's return {running}; blocking calls {traced['syncs_in_enqueue']}")


def mesh_cards_main() -> int:
    """Phase 13f alone: ``python3 -c 'import chip_smoke;
    chip_smoke.mesh_cards_main()'`` on a host with two cards or more (the
    default engine's kernel groups build first)."""
    from realsr_tpu_torch.ncnn.bin import write_weights
    from realsr_tpu_torch.ncnn.param import parse_param_file
    from realsr_tpu_torch.ncnn.synth import synth_weights

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    work = tempfile.mkdtemp(prefix="realsr_mesh_")
    try:
        mdir = os.path.join(work, "models-DF2K")
        os.makedirs(mdir)
        param = os.path.join(ROOT, "models", "models-DF2K", "x4.param")
        shutil.copyfile(param, os.path.join(mdir, "x4.param"))
        graph = parse_param_file(param)
        write_weights(graph, synth_weights(graph, seed=0, stats="trained"), os.path.join(mdir, "x4.bin"))
        mesh_cards(os.path.join(mdir, "x4.param"), os.path.join(mdir, "x4.bin"), f"[{smi[0]}] x {len(smi)}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


def _missing_native_deps() -> list:
    """What the native step needs and this machine lacks: cmake, a C++
    compiler, the libpng / libjpeg / libwebp headers and an embeddable
    Python (python3-config --embed)."""
    missing = [tool for tool in ("cmake", "c++") if shutil.which(tool) is None]
    roots = ("/usr/include", "/usr/local/include", os.path.join(sys.prefix, "include"))
    for header in ("png.h", "jpeglib.h", os.path.join("webp", "decode.h")):
        if not any(os.path.isfile(os.path.join(r, header)) for r in roots):
            missing.append(f"{header} (header)")
    cfg = shutil.which("python3-config")
    if cfg is None or subprocess.run([cfg, "--embed", "--ldflags"], capture_output=True).returncode != 0:
        missing.append("python3-config --embed")
    return missing


def slice10_bridge(mparam, mbin, work, card, auto_engine, kern32_auto) -> None:
    """Phase 10, the native bridge in process (init on gpu 0, async against
    sync, a batch of 3 against singles, an over-budget image banded), then
    the port's C++ CLI where this machine can build it."""
    from PIL import Image

    from realsr_tpu_torch import native_bridge as nb

    check(nb.device_count() == torch.cuda.device_count(), f"10: device_count {nb.device_count()}")
    scale = nb.init(json.dumps({"gpuid": [0], "tilesize": [0], "jobs_proc": [2], "prepadding": 10,
                                "tta_mode": False, "parampath": mparam, "modelpath": mbin}))
    check(scale == 4 and nb.num_engines() == 1, f"10: init scale {scale}, {nb.num_engines()} engines")
    rows = {}
    rng = np.random.default_rng(16)
    img = rng.integers(0, 256, (200, 300, 3), np.uint8)
    sync = nb.process(0, img.tobytes(), 300, 200, 3)
    handle = nb.process_async(0, img.tobytes(), 300, 200, 3)
    check(nb.fetch(handle) == sync and sync == auto_engine.process(img).tobytes(),
          "10: process_async + fetch not bit-equal to process, or to the engine's output")
    rows["async_vs_sync"] = {"bit_equal": True}
    # a batch of 3: its chunks hold the tiles of all three, so the batch
    # may differ from a single image's; held by PSNR against float32
    imgs = [natural_image(np.random.default_rng(20 + k), 200, 300) for k in range(3)]
    handles = nb.process_batch_async(0, [im.tobytes() for im in imgs], 300, 200, 3)
    outs = [np.frombuffer(nb.fetch(h), np.uint8).reshape(800, 1200, 3) for h in handles]
    ref_stack = kern32_auto.process_batch(imgs)
    dbs = []
    for k, im in enumerate(imgs):
        single = np.frombuffer(nb.process(0, im.tobytes(), 300, 200, 3), np.uint8).reshape(800, 1200, 3)
        db_b, db_s = psnr(outs[k], ref_stack[k]), psnr(single, kern32_auto.process(im))
        check(db_b >= db_s - PSNR_SLACK, f"10: batch image {k} {db_b:.2f} dB vs single {db_s:.2f} dB")
        dbs.append((db_b, db_s))
    rows["batch_of_3_vs_singles"] = {"psnr_vs_float32_batch_single": dbs,
                                     "tile_batch": auto_engine._pick_tilesize(300, 200, 3),
                                     "tile_single": auto_engine._pick_tilesize(300, 200)}
    # an image over the band budget goes through process_banded
    rgba = np.random.default_rng(7).integers(0, 256, (*BAND_HW, 4), np.uint8)
    env = {"REALSR_TPU_BAND_BUDGET_MB": "40"}
    check(with_env(env, lambda: auto_engine.needs_banding(rgba.shape)), "10: the RGBA image does not need banding")
    want = with_env(env, lambda: auto_engine.process_banded(rgba)).tobytes()
    got = with_env(env, lambda: nb.process(0, rgba.tobytes(), BAND_HW[1], BAND_HW[0], 4))
    handle = with_env(env, lambda: nb.process_async(0, rgba.tobytes(), BAND_HW[1], BAND_HW[0], 4))
    check(got == want and nb.fetch(handle) == want, "10: the over-budget image through the bridge is not banded")
    rows["over_budget_banded"] = {"bit_equal_to_process_banded": True, "budget_mb": 40}
    nb._engines = []
    torch.cuda.empty_cache()

    # the port's C++ CLI, built from realsr_tpu_torch/native
    missing = _missing_native_deps()
    if missing:
        print(f"10: the realsr-tpu-torch binary step is left out: this machine lacks {', '.join(missing)}",
              flush=True)
        rows["binary"] = {"left_out": missing}
    else:
        build = os.path.join(work, "native_build")
        src = os.path.join(ROOT, "realsr_tpu_torch", "native")
        for cmd in (["cmake", "-S", src, "-B", build, "-DCMAKE_BUILD_TYPE=Release"],
                    ["cmake", "--build", build, "-j", "4"]):
            r = subprocess.run(cmd, capture_output=True, text=True)
            check(r.returncode == 0, f"10: {' '.join(cmd)} failed:\n{r.stdout[-2000:]}{r.stderr[-2000:]}")
        in_dir, outs_dir = os.path.join(work, "bin_in"), {k: os.path.join(work, f"bin_{k}") for k in ("cpp", "py")}
        for d in (in_dir, *outs_dir.values()):
            os.makedirs(d)
        for k in range(3):
            Image.fromarray(np.random.default_rng(30 + k).integers(0, 256, (96 + 8 * k, 128, 3 + k % 2),
                                                                     np.uint8)).save(os.path.join(in_dir, f"{k}.png"))
        # the Python CLI encodes with the library just built, as the binary does
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
                   REALSR_IO_LIB=os.path.join(build, "librealsr_io_torch.so"))
        args = ["-i", in_dir, "-m", os.path.dirname(mparam), "-g", "0"]
        t0 = time.perf_counter()
        r = subprocess.run([os.path.join(build, "realsr-tpu-torch"), *args, "-o", outs_dir["cpp"]],
                           capture_output=True, text=True, env=env, timeout=300)
        s_cpp = time.perf_counter() - t0
        check(r.returncode == 0, f"10: realsr-tpu-torch exit {r.returncode}: {r.stderr[-2000:]}")
        r = subprocess.run([sys.executable, "-m", "realsr_tpu_torch", *args, "-o", outs_dir["py"]],
                           capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
        check(r.returncode == 0, f"10: python -m realsr_tpu_torch exit {r.returncode}: {r.stderr[-2000:]}")
        for k in range(3):
            with open(os.path.join(outs_dir["cpp"], f"{k}.png"), "rb") as a, \
                    open(os.path.join(outs_dir["py"], f"{k}.png"), "rb") as b:
                check(a.read() == b.read(), f"10: {k}.png from the binary differs from the Python CLI's")
        rows["binary"] = {"png_bytes_equal_to_python_cli": True, "files": 3, "s": s_cpp}
    print(json.dumps({"phase": "10", "what": "realsr_tpu_torch.native_bridge on gpu 0", "runs": rows, "card": card}),
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA GPU")
    from realsr_tpu_torch.engine import EngineConfig, RealSR
    from realsr_tpu_torch.loader import load_model
    from realsr_tpu_torch.models.rrdbnet import tf32
    from realsr_tpu_torch.ops import build
    from realsr_tpu_torch import engine as engine_mod
    from realsr_tpu_torch.ops import rdb_kernel as rk
    from realsr_tpu_torch.ops import tail_kernel as tk

    # every engine's graphs count their launches and replays for the smoke
    thread_counts(rk, tk)
    engine_mod._CudaGraph = counting(engine_mod._CudaGraph, rk, tk)
    # the default run: the engines' own choice of tail
    os.environ.pop("REALSR_TPU_PACKED_TAIL", None)

    # -- 1. card ---------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"card: {name}; nvidia-smi: {smi}; torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)

    # -- 2. build: one nvcc per group of each source, started together ------
    t0 = time.perf_counter()
    groups = [(s_, g) for s_ in build.SOURCES for g in build.GROUPS[s_]]
    build.load_groups(groups)
    print(f"build: {len(groups)} groups of {', '.join(f'{s_}.cu' for s_ in build.SOURCES)} -> {build.build_dir()} "
          f"in {time.perf_counter() - t0:.2f} s (nvcc "
          + ", ".join(f"{s_}[{g}] {build.BUILD_SECONDS[(s_, g)]:.2f} s" for s_, g in groups) + f") {card}",
          flush=True)
    for key in groups:
        log = build.BUILD_LOG[key]
        if log:
            label = f"{key[0]}.cu [{key[1]}]"
            rows = ptxas_rows(log)
            check(all(r[1] > 0 for r in rows), f"ptxas log without register counts: {rows}")
            # the group's library holds its instances and no other
            check(len(rows) == len(build.instances(*key)),
                  f"{label}: {len(rows)} kernels, the group names {len(build.instances(*key))}: {rows}")
            print(f"ptxas {label}: " + "; ".join(
                f"{lab} {regs} registers, spills {st}/{ld} B" for lab, regs, st, ld in rows), flush=True)
            serial = [ln.strip() for ln in log.splitlines() if "Performance Loss" in ln]
            if serial:
                print(f"ptxas {label}: {len(serial)} notes of wgmma serialization, e.g. {serial[0][:200]}",
                      flush=True)
            check(all(st == 0 and ld == 0 for _, _, st, ld in rows), f"{label}: a wgmma kernel spills: {rows}")
    for src in ("rdb_wgmma", "rdb_tf32", "rdb_modes_wgmma", "rdb_modes_tf32"):
        ops = sass_counts(src)
        check(ops["HGMMA"] > 0 and ops["UTMALDG"] > 0 and ops["UBLKCP"] > 0,
              f"{src}.cu: SASS without wgmma / TMA / bulk copies: {ops}")
        print(f"SASS {src}.cu (all instances): " + ", ".join(f"{k} {v}" for k, v in ops.items()), flush=True)
    for src in ("tail_kernel", "tail_tf32"):
        ops = sass_counts(src)
        check(ops["HGMMA"] > 0 and ops["UBLKCP"] > 0, f"{src}.cu: SASS without wgmma / bulk copies: {ops}")
        print(f"SASS {src}.cu (all instances): " + ", ".join(f"{k} {v}" for k, v in ops.items()), flush=True)

    dev = torch.device("cuda", 0)
    param = os.path.join(ROOT, "models", "models-DF2K", "x4.param")
    work = tempfile.mkdtemp(prefix="realsr_smoke_")
    try:
        model_dir = os.path.join(work, "models-DF2K")
        os.makedirs(model_dir)
        shutil.copyfile(param, os.path.join(model_dir, "x4.param"))
        from realsr_tpu_torch.ncnn.bin import write_weights
        from realsr_tpu_torch.ncnn.param import parse_param_file
        from realsr_tpu_torch.ncnn.synth import synth_weights

        graph = parse_param_file(param)
        write_weights(graph, synth_weights(graph, seed=0, stats="trained"),
                      os.path.join(model_dir, "x4.bin"))
        mparam = os.path.join(model_dir, "x4.param")
        mbin = os.path.join(model_dir, "x4.bin")

        # -- 3. RDB kernel against plain at the main path's shape --------
        rng = np.random.default_rng(0)
        x = torch.from_numpy(
            rng.normal(0.0, 0.5, (B, SIDE, SIDE, NF)).astype(np.float32)
        ).to(dev)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for label, geometry in (("K1", rk.rdb_geometry), ("K1 float32", rk.tf32_geometry)):
            geo = geometry(B, SIDE, SIDE, NF, GC, sms)
            print(f"geometry {label} B={B} {SIDE}x{SIDE}: patch side T={geo.tile}, {geo.patches[0]}x{geo.patches[1]} "
                  f"patches per tile, {geo.blocks} blocks = {geo.waves:.3f} waves (fill {100 * geo.fill:.1f} %), "
                  f"issued MACs {geo.mac_factor:.3f}x the RDB's", flush=True)
        rdb_macs = RDB_MACS_PER_PX * B * SIDE * SIDE
        results = {}
        library = {}  # the float32 instances' cuDNN route for the same work, ms
        for mode, op in (("mixed", torch.bfloat16), ("float32", torch.float32)):
            bundle = load_model(mparam, mbin, torch.float32, op, variant="cuda")
            check(bundle.spec.nf == NF and bundle.spec.gc == GC
                  and bundle.spec.num_rrdb == 23, f"unexpected spec {bundle.spec}")
            stacked = {k: v.to(dev) for k, v in bundle.params["rdb"].items()}
            p0 = rk._rdb_k(stacked, 0)
            with tf32(False):
                got = rk.rdb_apply(x, p0)
                torch.cuda.synchronize()
                want = rk.rdb_reference(x, p0, torch.float32, op)
                err, rel = rel_err(got, want)
                check(bool(torch.isfinite(got).all()), f"{mode} RDB: non-finite output")
                check(rel <= RDB_TOL[mode],
                      f"{mode} RDB: max|kernel-plain| {err} > {RDB_TOL[mode]} x max(1, max|plain|)")
                check(torch.equal(got, rk.rdb_apply(x, p0)), f"{mode} RDB: two runs differ")
                wrapper = ""
                if mode == "mixed":
                    # the kernel as the trunk runs it, on the bf16 operand
                    # plane the previous RDB wrote; rdb_apply alone casts x
                    xs = x.to(torch.bfloat16)
                    ms = cuda_ms(lambda: rk._rdb_wgmma(x, xs, p0, None, False), 2, 10)
                    wrapper = f" (rdb_apply with its bf16 cast of x {cuda_ms(lambda: rk.rdb_apply(x, p0), 2, 10):.3f} ms)"
                    results[("K1", "io")] = nbytes(x, p0["wg"], p0["b"], x)
                else:
                    ms = cuda_ms(lambda: rk.rdb_apply(x, p0), 2, 10)
                    results[("K1 float32", "io")] = nbytes(x, p0["wt"], p0["b"], x)
                    b_ms = bound(rdb_macs, results[("K1 float32", "io")], tf32=True)[0]
                    wrapper = f" (its tf32 bound {b_ms:.3f} ms; the plain version is the cuDNN route)"
                pms = cuda_ms(lambda: rk.rdb_reference(x, p0, torch.float32, op), 2, 10)
                if mode == "float32":
                    library["K1 float32"] = pms
            print(f"rdb {mode}: B={B} {SIDE}x{SIDE} nf={NF} gc={GC}: max_abs_err {err:.3e} "
                  f"(rel {rel:.3e} <= {RDB_TOL[mode]}), two runs bit-equal; kernel {ms:.3f} ms{wrapper}, "
                  f"plain {pms:.3f} ms (TF32 off) {card}", flush=True)
            results[("rdb", mode)] = (err, ms, pms)
            if mode == "mixed":
                # the patch side alone: the kernel at each side it is built for
                with tf32(False):
                    for tile in rk.WGMMA_TILES:
                        t_ms = cuda_ms(lambda: rk._rdb_wgmma(x, xs, p0, None, False, tile), 2, 10)
                        t_blocks = B * (-(-SIDE // tile)) ** 2
                        print(f"rdb mixed at patch side T={tile}: {t_blocks} blocks, issued MACs "
                              f"{t_blocks * rk.block_macs(tile, NF, GC) / (B * SIDE * SIDE * RDB_MACS_PER_PX):.3f}x "
                              f"the RDB's; kernel {t_ms:.3f} ms {card}", flush=True)
                del xs
            else:
                # the float32 instances at each patch side, at the main
                # path's chunk and at a ragged one, with the residual
                xr = torch.from_numpy(np.random.default_rng(20).normal(0.0, 0.5, (2, 37, 21, NF))
                                      .astype(np.float32)).to(dev)
                with tf32(False):
                    for tile in rk.TF32_TILES:
                        for xin in (x, xr):
                            want = rk.rdb_reference(xin, p0, torch.float32, op, xin)
                            got = rk._rdb_tf32(xin, p0, xin, tile)
                            e_t, rel_t = rel_err(got, want)
                            check(bool(torch.isfinite(got).all()) and rel_t <= RDB_TOL[mode]
                                  and torch.equal(got, rk._rdb_tf32(xin, p0, xin, tile)),
                                  f"float32 RDB at T={tile}, {tuple(xin.shape)}: rel {rel_t} > {RDB_TOL[mode]} "
                                  "or two runs differ")
                        t_ms = cuda_ms(lambda: rk._rdb_tf32(x, p0, None, tile), 2, 10)
                        t_blocks = B * (-(-SIDE // tile)) ** 2
                        print(f"rdb float32 at patch side T={tile}: {t_blocks} blocks, issued MACs "
                              f"{t_blocks * rk.block_macs(tile, NF, GC) / rdb_macs:.3f}x the RDB's; kernel "
                              f"{t_ms:.3f} ms; with the residual at B={B} {SIDE}x{SIDE} and 2 x 37 x 21 within "
                              f"rel {RDB_TOL[mode]}, bit-equal {card}", flush=True)
                del xr

            with tf32(False):
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
                  f"(rel {rel:.3e} <= {TRUNK_TOL}), two runs bit-equal; kernel {ms:.3f} ms, "
                  f"plain {pms:.3f} ms (TF32 off) {card}", flush=True)
            results[("trunk", mode)] = (err, ms, pms)
            if mode == "float32":
                library["K2 float32"] = pms
                k1_trunk32, k1_trunk32_ms = got, ms
            else:
                # the library call for the same work: cuDNN's bf16 convs,
                # channels-last, one RDB (K1, and K3-K5: the same function)
                # and the 69-RDB trunk (K2)
                cl = torch.channels_last
                ws = [{k: v.to(torch.bfloat16).contiguous(memory_format=cl) if v.dim() == 4 else v.to(torch.bfloat16)
                       for k, v in rk.unpack_rdb_params(rk._rdb_k(stacked, i), NF).items()}
                      for i in range(stacked["w"].shape[0])]
                xc = x.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(memory_format=cl)
                with tf32(True):
                    lib1 = cuda_ms(lambda: cudnn_rdb(xc, ws[0]), 2, 10)
                    lib2 = cuda_ms(lambda: cudnn_trunk(xc, ws), 1, 1)
                    e_lib = rel_err(cudnn_rdb(xc, ws[0]).permute(0, 2, 3, 1), rk.rdb_reference(x, p0, torch.float32, op))
                check(e_lib[1] <= 0.05, f"the cuDNN bf16 RDB disagrees with the plain RDB: rel {e_lib[1]}")
                library.update({"K1": lib1, "K2": lib2, "K3": lib1, "K4": lib1, "K5": lib1})
                k1_ms = results[("rdb", "mixed")][1]
                print(f"library: cuDNN bf16 convs, channels-last, one RDB {lib1:.3f} ms (K1 {k1_ms:.3f} ms: "
                      f"{lib1 / k1_ms:.2f}x faster than cuDNN), the 69-RDB trunk {lib2:.3f} ms (K1 trunk "
                      f"{ms:.3f} ms: {lib2 / ms:.2f}x); rel diff of cuDNN's RDB (bf16 state) vs plain {e_lib[1]:.2e} "
                      f"{card}", flush=True)
                del ws, xc
            wkey = "wg" if mode == "mixed" else "wt"
            results[("K2" if mode == "mixed" else "K2 float32", "io")] = nbytes(x, stacked[wkey], stacked["b"], x)
            del stacked, p0, want, bundle

        # -- 3b. tail kernels against plain ------------------------------
        bundle = load_model(mparam, mbin, torch.float32, torch.bfloat16, tail="kernel")
        tp16 = {k: v.to(dev) for k, v in bundle.params["tail"].items()}
        tp32 = {k: v.to(dev) for k, v in tk.pack_tail_params(bundle.params, torch.float32).items()}
        graph_p = {g: {k: torch.as_tensor(v, device=dev) for k, v in bundle.params[g].items()}
                   for g in ("up", "hr", "last")}
        for up, label in ((True, "K6"), (False, "K7")):
            for b_, h_, w_ in TAIL_SHAPES:
                g = tk.tail_geometry(b_, h_, w_, up, sms)
                print(f"tail geometry {label} B={b_} {h_}x{w_} -> {4 * h_}x{4 * w_}: patch {g.tile[0]}x{g.tile[1]}, "
                      f"{g.patches[0]}x{g.patches[1]} patches per tile, {g.blocks} patches on {g.grid} persistent "
                      f"blocks = {g.waves:.3f} waves (fill {100 * g.fill:.1f} %), issued MACs "
                      f"{g.mac_factor:.3f}x the tail's", flush=True)
        for n_shape, (b_, h_, w_) in enumerate(TAIL_SHAPES):
            # post-lrelu activations, as up1 and up2 leave them; shapes past
            # the first two draw from their own generator, so that the images
            # phases 4 and 5 draw from rng do not depend on the shapes here
            src = rng if n_shape < 2 else np.random.default_rng(n_shape)
            p1 = np.abs(src.normal(0.0, 0.5, (b_, h_ + 1, w_ + 1, 4 * NF)))
            p2 = np.abs(src.normal(0.0, 0.5, (b_, h_, w_, 16 * NF)))
            for label, fn, arr in (("K6", "up2_hr_last_packed", p1), ("K7", "hr_last_packed", p2)):
                xin = torch.from_numpy(arr.astype(np.float32)).to(dev, torch.bfloat16)
                timed = (b_, h_, w_) == TAIL_SHAPES[0]
                with tf32(False):
                    err, e_k, e_p, ms, pms = tail_check(tk, fn, xin, tp16, tp32, timed)
                times = f"; kernel {ms:.3f} ms, plain {pms:.3f} ms (TF32 allowed)" if timed else ""
                print(f"tail {label} {fn}: B={b_} {h_}x{w_} -> {4 * h_}x{4 * w_}x3: max_abs_err "
                      f"{err:.3e} vs plain bf16; vs float32 plain {e_k:.3e} <= max(2 x {e_p:.3e}, "
                      f"1e-3), two runs bit-equal{times} {card}", flush=True)
                if timed:
                    results[(label, "mixed")] = (err, ms, pms)
                    # library: cuDNN's bf16 convs of the interleaved tail for the same work
                    fea = torch.zeros((b_, NF, (2 if label == "K6" else 4) * h_, (2 if label == "K6" else 4) * w_),
                                      device=dev)
                    library[label] = cuda_ms(lambda: cudnn_tail(fea, graph_p, label == "K6", torch.bfloat16), 2, 10)
                    del fea
                    print(f"tail {label}: the interleaved tail's cuDNN bf16 convs for the same work "
                          f"{library[label]:.3f} ms (library) {card}", flush=True)
                    # the input, the packed tail weights, the [B, 4H, 4W, 3] f32 output
                    results[(label, "io")] = nbytes(xin, *tp16.values()) + b_ * 16 * h_ * w_ * 3 * 4
                    # the patch shape alone: the kernel at each shape it is built for
                    up = label == "K6"
                    with tf32(False):
                        exact = getattr(tk, fn.replace("_packed", "_reference"))(xin.float(), tp32)
                    for tile in tk.TAIL_TILES:
                        e_t = rel_err(tk._launch(fn, xin, tp16, up, tile), exact)[0]
                        check(e_t <= max(2 * e_p, 1e-3),
                              f"{label} at {tile}: max|kernel - f32 plain| {e_t} > max(2 x {e_p}, 1e-3)")
                        t_ms = cuda_ms(lambda: tk._launch(fn, xin, tp16, up, tile), 2, 10)
                        n_t = b_ * -(-4 * h_ // tile[0]) * -(-4 * w_ // tile[1])
                        f_t = n_t * tk.tail_block_macs(*tile, up) / (b_ * 16 * h_ * w_ * tk.tail_macs_per_pixel(up))
                        print(f"tail {label} at patch {tile[0]}x{tile[1]}: {n_t} patches, issued MACs "
                              f"{f_t:.3f}x the tail's; vs float32 plain {e_t:.3e}; kernel {t_ms:.3f} ms "
                              f"{card}", flush=True)
                    del exact
                del xin

        # the float32 instances (3xTF32) against the float32 plain versions
        # with TF32 off, as float32 K1; timed beside the interleaved tail's
        # cuDNN convs for the same work (the float32 engine's other tail)
        tol32 = RDB_TOL["float32"]
        for up, label in ((True, "K6"), (False, "K7")):
            for b_, h_, w_ in TAIL_SHAPES:
                g = tk.tail_tf32_geometry(b_, h_, w_, up, sms)
                print(f"tail geometry {label} float32 B={b_} {h_}x{w_} -> {4 * h_}x{4 * w_}: patch "
                      f"{g.tile[0]}x{g.tile[1]}, {g.blocks} patches on {g.grid} persistent blocks = {g.waves:.3f} "
                      f"waves (fill {100 * g.fill:.1f} %), issued MACs {g.mac_factor:.3f}x the tail's", flush=True)
        for n_shape, (b_, h_, w_) in enumerate(TAIL_SHAPES):
            src = np.random.default_rng(30 + n_shape)
            p1 = np.abs(src.normal(0.0, 0.5, (b_, h_ + 1, w_ + 1, 4 * NF)))
            p2 = np.abs(src.normal(0.0, 0.5, (b_, h_, w_, 16 * NF)))
            for label, fn, arr in (("K6", "up2_hr_last_packed", p1), ("K7", "hr_last_packed", p2)):
                up = label == "K6"
                xin = torch.from_numpy(arr.astype(np.float32)).to(dev)
                ref = getattr(tk, fn.replace("_packed", "_reference"))
                key = f"{label} float32"
                main_shape = (b_, h_, w_) == TAIL_SHAPES[0]
                with tf32(False):
                    want = ref(xin, tp32)
                    for tile in (None, *tk.TAIL_TF32_TILES):
                        got = getattr(tk, fn)(xin, tp32) if tile is None else tk._launch(fn, xin, tp32, up, tile)
                        torch.cuda.synchronize()
                        err, rel = rel_err(got, want)
                        shape_ok = tuple(got.shape) == (b_, 4 * h_, 4 * w_, 3) and bool(torch.isfinite(got).all())
                        again = getattr(tk, fn)(xin, tp32) if tile is None else tk._launch(fn, xin, tp32, up, tile)
                        side = "the geometry's patch" if tile is None else f"patch {tile[0]}x{tile[1]}"
                        check(shape_ok and rel <= tol32 and torch.equal(got, again),
                              f"{key} B={b_} {h_}x{w_} at {side}: rel {rel} > {tol32}, bad shape or two runs differ")
                        times = ""
                        if main_shape:
                            ms = cuda_ms(lambda: tk._launch(fn, xin, tp32, up, tile), 2, 10)
                            times = f"; kernel {ms:.3f} ms"
                            if tile is None:
                                pms = cuda_ms(lambda: ref(xin, tp32), 1, 2)
                                fea = torch.zeros((b_, NF, (2 if up else 4) * h_, (2 if up else 4) * w_), device=dev)
                                lms = cuda_ms(lambda: cudnn_tail(fea, graph_p, up), 2, 10)
                                del fea
                                results[(key, "f32")] = (err, ms, pms)
                                library[key] = lms
                                w_keys = ("w2t", "b2", "w1t", "b1", "w9t", "b3") if up else ("w1t", "b1", "w9t", "b3")
                                results[(key, "io")] = nbytes(xin, *(tp32[k] for k in w_keys)) + b_ * 16 * h_ * w_ * 12
                                times += (f", plain {pms:.3f} ms (TF32 off), the interleaved tail's cuDNN convs for the "
                                          f"same work {lms:.3f} ms")
                        print(f"tail {key} {fn}: B={b_} {h_}x{w_} -> {4 * h_}x{4 * w_}x3 at {side}: max_abs_err "
                              f"{err:.3e} (rel {rel:.3e} <= {tol32}) vs float32 plain, two runs bit-equal{times} "
                              f"{card}", flush=True)
                    del want, got, again
                del xin
        del bundle, tp16, tp32, graph_p
        torch.cuda.empty_cache()

        # -- 3c. the trunk modes' kernels against plain, mixed ---------------
        bundle = load_model(mparam, mbin, torch.float32, torch.bfloat16, variant="cuda")
        stacked = {k: v.to(dev) for k, v in bundle.params["rdb"].items()}
        bundle = load_model(mparam, mbin, torch.float32, torch.bfloat16, variant="cuda",
                            sched="packed")
        stacked_q = {k: v.to(dev) for k, v in bundle.params["rdb"].items()}
        p0 = rk._rdb_k(stacked, 0)
        q0 = rk._rdb_k(stacked_q, 0)
        hi, lo = rk._split(x)
        xs = x.to(torch.bfloat16)
        xc = rk.to_chained(x)
        flag0 = torch.zeros(1, dtype=torch.int32, device=dev)
        out_c = torch.zeros_like(xc)
        tol = RDB_TOL["mixed"]
        for b_, h_, w_ in MODE_SHAPES:
            g = rk.packed_geometry(b_, h_, w_, NF, GC, sms)
            print(f"packed geometry (K5) B={b_} {h_}x{w_}: patch side T={g.tile}, {g.patches[0]}x{g.patches[1]} "
                  f"patches per tile, {g.blocks} blocks = {g.waves:.3f} waves (fill {100 * g.fill:.1f} %), issued "
                  f"MACs {g.mac_factor:.3f}x the RDB's (K1/K4 at T={rk.rdb_geometry(b_, h_, w_, NF, GC, sms).tile}: "
                  f"{rk.rdb_geometry(b_, h_, w_, NF, GC, sms).mac_factor:.3f}x)", flush=True)
        with tf32(False):
            k1_ms = cuda_ms(lambda: rk._rdb_wgmma(x, xs, p0, None, False), 2, 10)
            k1_trunk = rk.rdb_trunk(x, stacked)
            k1_trunk_ms = cuda_ms(lambda: rk.rdb_trunk(x, stacked), 1, 1)

            # K5, K4 and K3 for one RDB: each shape, each patch side, against plain
            for n_shape, (b_, h_, w_) in enumerate(MODE_SHAPES):
                xm = x if n_shape == 0 else torch.from_numpy(
                    np.random.default_rng(10 + n_shape).normal(0.0, 0.5, (b_, h_, w_, NF)).astype(np.float32)).to(dev)
                xms, (hm, lm) = xm.to(torch.bfloat16), rk._split(xm)
                want_q = rk.rdb_packed_reference(xm, q0, torch.float32, torch.bfloat16)
                want_h, want_l = rk.rdb_paired_reference(hm, lm, p0)
                want_p = want_h.float() + want_l.float()
                # K3 with the residual folded (u = x), reading the bf16 operand
                # plane and writing the shadow as its trunk does
                xmc = rk.to_chained(xm)
                xmcs, out_m, sh_m = xmc.to(torch.bfloat16), torch.zeros_like(xmc), torch.zeros_like(xmc, dtype=torch.bfloat16)
                flag1 = torch.ones(1, dtype=torch.int32, device=dev)
                want_c = rk.from_chained(rk.rdb_chained_reference(
                    xmc, p0, xmc, flag1, h_, w_, torch.zeros_like(xmc), torch.float32, torch.bfloat16), h_, w_)

                def chained(t):
                    rk.rdb_apply_chained(xmc, p0, xmc, flag1, h_, w_, out_m, xmcs, sh_m, t)
                    return out_m

                def chained_state(out):
                    rest = out.clone()
                    rk.from_chained(rest, h_, w_).zero_()
                    check(not rest.any() and torch.equal(sh_m, out.to(torch.bfloat16)),
                          f"K3 B={b_} {h_}x{w_}: written outside the image, or the shadow is not bf16(out)")
                    return rk.from_chained(out, h_, w_).clone()

                # (the kernel's call at a patch side, its output as one f32 state)
                for key, tiles, call, state, want in (
                    ("K5", rk.PACKED_TILES, lambda t: rk._rdb_wgmma(xm, xms, q0, None, False, t, packed=True)[0],
                     lambda out: out, want_q),
                    ("K4", rk.WGMMA_TILES, lambda t: rk.rdb_apply_paired(hm, lm, p0, tile=t),
                     lambda out: out[0].float() + out[1].float(), want_p),
                    ("K3", rk.WGMMA_TILES, chained, chained_state, want_c),
                ):
                    for tile in (None, *tiles):
                        got = state(call(tile))
                        torch.cuda.synchronize()
                        err, rel = rel_err(got, want)
                        side = f"T={tile}" if tile else "the geometry's T"
                        check(bool(torch.isfinite(got).all()) and rel <= tol,
                              f"{key} B={b_} {h_}x{w_} at {side}: max|kernel-plain| {err} (rel {rel}) > {tol}")
                        check(torch.equal(got, state(call(tile))),
                              f"{key} B={b_} {h_}x{w_} at {side}: two runs differ")
                        if n_shape == 0:
                            t_ms = cuda_ms(lambda: call(tile), 2, 10)
                            print(f"{key} rdb mixed B={b_} {h_}x{w_} at {side}: max_abs_err {err:.3e} (rel {rel:.3e} "
                                  f"<= {tol}), two runs bit-equal; kernel {t_ms:.3f} ms {card}", flush=True)
                            if tile is None:
                                results[(key, "mixed")] = (err, t_ms, float("nan"))
                        else:
                            print(f"{key} rdb mixed B={b_} {h_}x{w_} at {side}: max_abs_err {err:.3e} "
                                  f"(rel {rel:.3e} <= {tol}), two runs bit-equal {card}", flush=True)
                del xm, xms, hm, lm, want_q, want_h, want_l, want_p, xmc, xmcs, out_m, sh_m, want_c

            # K5: the times at the main shape, and the 69-RDB packed trunk
            pms = cuda_ms(lambda: rk.rdb_packed_reference(x, q0, torch.float32, torch.bfloat16), 2, 10)
            err, ms, _ = results[("K5", "mixed")]
            results[("K5", "mixed")] = (err, ms, pms)
            results[("K5", "io")] = nbytes(x, xs, q0["wg"], q0["b"], x)
            print(f"K5 packed rdb mixed: B={B} {SIDE}x{SIDE}: kernel {ms:.3f} ms at "
                  f"T={rk.packed_geometry(B, SIDE, SIDE, NF, GC, sms).tile}, plain {pms:.3f} ms, K1 {k1_ms:.3f} ms "
                  f"(TF32 off) {card}", flush=True)
            got = rk.rdb_trunk(x, stacked_q, "packed")
            torch.cuda.synchronize()
            err, rel = rel_err(got, plain_trunk(rk, x, stacked_q, rk.rdb_packed_reference))
            e_k1, rel_k1 = rel_err(got, k1_trunk)
            check(bool(torch.isfinite(got).all()) and rel <= TRUNK_TOL and rel_k1 <= TRUNK_TOL,
                  f"K5 trunk: relative max diff to the plain packed trunk {rel}, to the K1 trunk {rel_k1} "
                  f"> {TRUNK_TOL}")
            check(torch.equal(got, rk.rdb_trunk(x, stacked_q, "packed")), "K5 trunk: two runs differ")
            ms = cuda_ms(lambda: rk.rdb_trunk(x, stacked_q, "packed"), 1, 1)
            print(f"K5 packed trunk: 69 RDB: max_abs_err {err:.3e} vs the plain packed trunk (rel {rel:.3e} <= "
                  f"{TRUNK_TOL}), {e_k1:.3e} vs the K1 trunk (rel {rel_k1:.3e} <= {TRUNK_TOL}), two runs bit-equal; "
                  f"kernel {ms:.3f} ms, K1 trunk {k1_trunk_ms:.3f} ms (TF32 off) {card}", flush=True)

            # K4: the times at the main shape, and the 69-RDB paired trunk
            gh, gl = rk.rdb_apply_paired(hi, lo, p0)
            pms = cuda_ms(lambda: rk.rdb_paired_reference(hi, lo, p0), 2, 10)
            err, ms, _ = results[("K4", "mixed")]
            results[("K4", "mixed")] = (err, ms, pms)
            results[("K4", "io")] = nbytes(hi, lo, p0["wg"], p0["b"], gh, gl)
            print(f"K4 paired rdb: B={B} {SIDE}x{SIDE}, hi + lo bf16: kernel {ms:.3f} ms, plain {pms:.3f} ms, "
                  f"K1 {k1_ms:.3f} ms (TF32 off) {card}", flush=True)
            got = rk.rdb_trunk_paired(x, stacked)
            torch.cuda.synchronize()
            err, rel = rel_err(got, plain_paired_trunk(rk, x, stacked))
            e_k1, rel_k1 = rel_err(got, k1_trunk)
            check(bool(torch.isfinite(got).all()) and rel <= TRUNK_TOL and rel_k1 <= TRUNK_TOL,
                  f"K4 trunk: relative max diff to the plain paired trunk {rel}, to the K1 trunk {rel_k1} "
                  f"> {TRUNK_TOL}")
            check(torch.equal(got, rk.rdb_trunk_paired(x, stacked)), "K4 trunk: two runs differ")
            ms = cuda_ms(lambda: rk.rdb_trunk_paired(x, stacked), 1, 1)
            pms = cuda_ms(lambda: plain_paired_trunk(rk, x, stacked), 1, 1)
            print(f"K4 paired trunk: 69 RDB: max_abs_err {err:.3e} vs the plain paired trunk (rel "
                  f"{rel:.3e} <= {TRUNK_TOL}), {e_k1:.3e} vs the K1 trunk (rel {rel_k1:.3e} <= {TRUNK_TOL}), "
                  f"two runs bit-equal; kernel {ms:.3f} ms, plain {pms:.3f} ms, K1 trunk {k1_trunk_ms:.3f} ms "
                  f"(TF32 off) {card}", flush=True)

            # K3: one RDB on the chained layout as its trunk runs it (the bf16
            # operand plane in, the shadow out), then the 69-RDB trunk; K1's
            # stages and arithmetic on another layout, so held to K1 within
            # the mixed tolerance
            xcs, sh_c = xc.to(torch.bfloat16), torch.zeros_like(xc, dtype=torch.bfloat16)
            rk.rdb_apply_chained(xc, p0, xc, flag0, SIDE, SIDE, out_c, xcs, sh_c)
            torch.cuda.synchronize()
            want = rk.rdb_chained_reference(xc, p0, xc, flag0, SIDE, SIDE, torch.zeros_like(xc),
                                            torch.float32, torch.bfloat16)
            err, rel = rel_err(out_c, want)
            check(rel <= tol, f"K3 chained RDB: max|kernel-plain| {err} (rel {rel}) > {tol}")
            e_k1, rel_k1 = rel_err(rk.from_chained(out_c, SIDE, SIDE), rk.rdb_apply(x, p0))
            check(rel_k1 <= tol, f"K3 chained RDB: max|K3 - K1| {e_k1} (rel {rel_k1}) > {tol}")
            ms = cuda_ms(lambda: rk.rdb_apply_chained(xc, p0, xc, flag0, SIDE, SIDE, out_c, xcs, sh_c), 2, 10)
            pms = cuda_ms(lambda: rk.rdb_chained_reference(
                xc, p0, xc, flag0, SIDE, SIDE, out_c, torch.float32, torch.bfloat16), 2, 10)
            results[("K3", "mixed")] = (err, ms, pms)
            # the image and its operand plane in, the image and its shadow out
            results[("K3", "io")] = nbytes(x, xs, p0["wg"], p0["b"], x, xs)
            del xcs, sh_c
            got = rk.rdb_trunk_chained(x, stacked)
            torch.cuda.synchronize()
            e_t, rel_t = rel_err(got, k1_trunk)
            check(rel_t <= TRUNK_TOL, f"K3 chained trunk: relative max diff to the K1 trunk {rel_t} > {TRUNK_TOL}")
            tms = cuda_ms(lambda: rk.rdb_trunk_chained(x, stacked), 1, 1)
            print(f"K3 chained rdb: B={B} {SIDE}x{SIDE} in a {tuple(xc.shape[1:3])} layout: "
                  f"max_abs_err {err:.3e} (rel {rel:.3e} <= {tol}), vs K1 {e_k1:.3e} (rel {rel_k1:.3e}); "
                  f"kernel {ms:.3f} ms, plain {pms:.3f} ms, K1 {k1_ms:.3f} ms; 69-RDB chained trunk "
                  f"vs the K1 trunk {e_t:.3e} (rel {rel_t:.3e} <= {TRUNK_TOL}), {tms:.3f} ms vs K1 trunk "
                  f"{k1_trunk_ms:.3f} ms (TF32 off) {card}", flush=True)
        n_rdb = stacked["w"].shape[0]
        del bundle, stacked, stacked_q, p0, q0, hi, lo, gh, gl, xs, xc, out_c, got, want, k1_trunk
        torch.cuda.empty_cache()

        # -- 3c, float32: K3's and K5's float32 instances (3xTF32) --------
        # K3 at float32 K1's sides, bit-equal to it; K5 at its own sides;
        # both within the float32 tolerance of their plain versions
        st32 = {k: v.to(dev) for k, v in load_model(mparam, mbin, torch.float32, torch.float32,
                                                    variant="cuda").params["rdb"].items()}
        st32q = {k: v.to(dev) for k, v in load_model(mparam, mbin, torch.float32, torch.float32, variant="cuda",
                                                     sched="packed").params["rdb"].items()}
        p32, q32 = rk._rdb_k(st32, 0), rk._rdb_k(st32q, 0)
        tol32 = RDB_TOL["float32"]
        for b_, h_, w_ in MODE_SHAPES:
            g = rk.packed_tf32_geometry(b_, h_, w_, NF, GC, sms)
            print(f"packed geometry float32 (K5) B={b_} {h_}x{w_}: patch side T={g.tile}, {g.blocks} blocks = "
                  f"{g.waves:.3f} waves (fill {100 * g.fill:.1f} %), issued MACs {g.mac_factor:.3f}x the RDB's "
                  f"(float32 K1/K3 at T={rk.tf32_geometry(b_, h_, w_, NF, GC, sms).tile}: "
                  f"{rk.tf32_geometry(b_, h_, w_, NF, GC, sms).mac_factor:.3f}x)", flush=True)
        with tf32(False):
            for n_shape, (b_, h_, w_) in enumerate(MODE_SHAPES):
                xm = x if n_shape == 0 else torch.from_numpy(
                    np.random.default_rng(40 + n_shape).normal(0.0, 0.5, (b_, h_, w_, NF)).astype(np.float32)).to(dev)
                xmc, flag1 = rk.to_chained(xm), torch.ones(1, dtype=torch.int32, device=dev)
                want_c = rk.rdb_reference(xm, p32, torch.float32, torch.float32, xm)
                want_q = rk.rdb_packed_reference(xm, q32, torch.float32, torch.float32, xm)
                for tile in (None, *rk.TF32_TILES):
                    outs = []
                    for _ in range(2):
                        out = torch.zeros_like(xmc)
                        rk.rdb_apply_chained(xmc, p32, xmc, flag1, h_, w_, out, tile=tile)
                        outs.append(out)
                    torch.cuda.synchronize()
                    img = rk.from_chained(outs[0], h_, w_)
                    rest = outs[0].clone()
                    rk.from_chained(rest, h_, w_).zero_()
                    err, rel = rel_err(img, want_c)
                    side = f"T={tile}" if tile else "the geometry's T"
                    check(torch.equal(img, rk._rdb_tf32(xm, p32, xm, tile)) and rel <= tol32 and not rest.any()
                          and torch.equal(outs[0], outs[1]),
                          f"K3 float32 B={b_} {h_}x{w_} at {side}: not bit-equal to float32 K1, rel {rel} > "
                          f"{tol32}, written outside the image, or two runs differ")
                    print(f"K3 float32 rdb B={b_} {h_}x{w_} at {side}, residual folded: bit-equal to float32 K1; "
                          f"max_abs_err {err:.3e} (rel {rel:.3e} <= {tol32}) vs plain; aprons zero; two runs "
                          f"bit-equal {card}", flush=True)
                for tile in (None, *rk.PACKED_TF32_TILES):
                    got = rk._rdb_tf32(xm, q32, xm, tile, packed=True)
                    torch.cuda.synchronize()
                    err, rel = rel_err(got, want_q)
                    side = f"T={tile}" if tile else "the geometry's T"
                    check(bool(torch.isfinite(got).all()) and rel <= tol32
                          and torch.equal(got, rk._rdb_tf32(xm, q32, xm, tile, packed=True)),
                          f"K5 float32 B={b_} {h_}x{w_} at {side}: rel {rel} > {tol32} or two runs differ")
                    t_ms = ""
                    if n_shape == 0:
                        t_ms = f"; kernel {cuda_ms(lambda: rk._rdb_tf32(x, q32, None, tile, packed=True), 2, 10):.3f} ms"
                    print(f"K5 float32 rdb B={b_} {h_}x{w_} at {side}, with the residual: max_abs_err {err:.3e} "
                          f"(rel {rel:.3e} <= {tol32}) vs the plain packed version, two runs bit-equal{t_ms} {card}",
                          flush=True)
                del xm, xmc, want_c, want_q, outs, img, rest, got

            # the times at the main shape, without the residual, as the trunk's first step
            xc32, out32 = rk.to_chained(x), torch.zeros_like(rk.to_chained(x))
            flag0 = torch.zeros(1, dtype=torch.int32, device=dev)
            rk.rdb_apply_chained(xc32, p32, xc32, flag0, SIDE, SIDE, out32)
            err = rel_err(rk.from_chained(out32, SIDE, SIDE), rk.rdb_reference(x, p32, torch.float32, torch.float32))[0]
            ms = cuda_ms(lambda: rk.rdb_apply_chained(xc32, p32, xc32, flag0, SIDE, SIDE, out32), 2, 10)
            pms = cuda_ms(lambda: rk.rdb_chained_reference(xc32, p32, xc32, flag0, SIDE, SIDE, out32, torch.float32,
                                                           torch.float32), 2, 10)
            k1_32 = cuda_ms(lambda: rk._rdb_tf32(x, p32, None), 2, 10)
            library["K3 float32"] = library["K5 float32"] = cuda_ms(
                lambda: rk.rdb_reference(x, p32, torch.float32, torch.float32), 2, 10)
            results[("K3 float32", "f32")] = (err, ms, pms)
            results[("K3 float32", "io")] = nbytes(x, p32["wt"], p32["b"], x)
            q_err = rel_err(rk.rdb_apply_packed(x, q32), rk.rdb_packed_reference(x, q32, torch.float32,
                                                                                   torch.float32))[0]
            q_ms = cuda_ms(lambda: rk.rdb_apply_packed(x, q32), 2, 10)
            q_pms = cuda_ms(lambda: rk.rdb_packed_reference(x, q32, torch.float32, torch.float32), 2, 10)
            results[("K5 float32", "f32")] = (q_err, q_ms, q_pms)
            results[("K5 float32", "io")] = nbytes(x, q32["wt"], q32["b"], x)
            print(f"K3 / K5 float32 rdb B={B} {SIDE}x{SIDE}: kernel {ms:.3f} / {q_ms:.3f} ms at T="
                  f"{rk.tf32_geometry(B, SIDE, SIDE, NF, GC, sms).tile} / "
                  f"{rk.packed_tf32_geometry(B, SIDE, SIDE, NF, GC, sms).tile}, plain {pms:.3f} / {q_pms:.3f} ms, "
                  f"float32 K1 {k1_32:.3f} ms, cuDNN route {library['K3 float32']:.3f} ms (TF32 off) {card}",
                  flush=True)
            del xc32, out32

            # their 69-RDB float32 trunks: chained bit-equal to the float32 K1
            # trunk, packed within the float32 tolerance of the plain packed trunk
            got = rk.rdb_trunk_chained(x, st32)
            torch.cuda.synchronize()
            check(torch.equal(got, k1_trunk32), "K3 float32 trunk: not bit-equal to the float32 K1 trunk")
            e_c = rel_err(got, plain_trunk(rk, x, st32))
            tms = cuda_ms(lambda: rk.rdb_trunk_chained(x, st32), 1, 1)
            got = rk.rdb_trunk(x, st32q, "packed")
            torch.cuda.synchronize()
            e_q = rel_err(got, plain_trunk(rk, x, st32q, rk.rdb_packed_reference))
            check(bool(torch.isfinite(got).all()) and e_c[1] <= tol32 and e_q[1] <= tol32
                  and torch.equal(got, rk.rdb_trunk(x, st32q, "packed")),
                  f"float32 trunks: chained rel {e_c[1]}, packed rel {e_q[1]} > {tol32}, or two packed runs differ")
            qtms = cuda_ms(lambda: rk.rdb_trunk(x, st32q, "packed"), 1, 1)
            print(f"float32 trunks, 69 RDB: K3 chained bit-equal to the float32 K1 trunk, {e_c[0]:.3e} (rel "
                  f"{e_c[1]:.3e} <= {tol32}) vs the plain trunk, {tms:.3f} ms; K5 packed {e_q[0]:.3e} (rel "
                  f"{e_q[1]:.3e}) vs the plain packed trunk, two runs bit-equal, {qtms:.3f} ms; float32 K1 trunk "
                  f"{k1_trunk32_ms:.3f} ms (TF32 off) {card}", flush=True)
        del st32, st32q, p32, q32, got, k1_trunk32
        del x
        torch.cuda.empty_cache()

        # -- 4. the main path through the CLI ----------------------------
        from PIL import Image

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

        # the CLI's engine: the same default config, so the same tile plan
        engine = RealSR(gpuid=0, config=EngineConfig())
        engine.load(mparam, mbin)
        wall, counts, k6_main, k7, wrappers_main = run_cli(
            cli, rk, tk, ["-i", in_dir, "-o", out_dir, "-m", model_dir, "-g", "0"])
        launches = counts["rdb_apply"]
        chunks, _ = chunk_counts(engine, images)
        out_mp = 0.0
        for fn, img in images.items():
            h, w, c = img.shape
            path = os.path.join(out_dir, fn)
            check(os.path.isfile(path), f"missing output {path}")
            with Image.open(path) as im:
                out = np.asarray(im)
            check(out.shape == (4 * h, 4 * w, c), f"{fn}: output {out.shape}, want {(4 * h, 4 * w, c)}")
            out_mp += 16 * h * w / 1e6
        picks = {fn: engine._pick_tilesize(img.shape[1], img.shape[0]) for fn, img in images.items()}
        want_k6 = chunks if engine.tail == "kernel" else 0
        check(launches == 69 * chunks and chunks > 0 and sum(counts.values()) == launches,
              f"rdb_kernel launches {counts} != 69 x {chunks} chunks of K1")
        check(k6_main == want_k6 and k7 == 0,
              f"tail launches K6 {k6_main}, K7 {k7}; want {want_k6} (tail {engine.tail}) and 0")
        print(f"main path: cli.main rc 0, 3 images -> 4x outputs (RGBA kept 4 channels), "
              f"tiles picked {picks}, tail {engine.tail}, {chunks} chunks ({GRAPH_COUNTS['captures']} computed "
              f"by a capture's warm-up, {GRAPH_COUNTS['replays']} graph replays, the rest eagerly: a key's first "
              f"chunk): {launches} rdb_kernel launches, {k6_main} K6 launches run on the card; the wrappers "
              f"counted {wrappers_main['rdb_apply']} K1 and {wrappers_main['up2_hr_last_packed']} K6 (eager "
              f"chunks, and each capture's warm-up and recording); "
              f"{out_mp:.3f} output MP in {wall:.3f} s = "
              f"{out_mp / wall:.3f} output MP/s (model load, first calls and captures included) {card}",
              flush=True)
        one = {"b.png": images["b.png"]}
        one_in = os.path.join(in_dir, "b.png")
        n1, _ = chunk_counts(engine, one)
        k6_cli, wrappers_k6 = k6_main, wrappers_main
        if engine.tail != "kernel":
            # auto kept the interleaved tail: drive K6 through the CLI too
            _, counts3, k6_cli, _, wrappers_k6 = run_cli(
                cli, rk, tk, ["-i", one_in, "-o", os.path.join(out_dir, "b_k6.png"),
                              "-m", model_dir, "-g", "0"], {"REALSR_TPU_PACKED_TAIL": "3"})
            check(k6_cli == n1 and counts3["rdb_apply"] == 69 * n1,
                  f"K6 CLI run: {k6_cli} K6 launches != {n1}")
        _, counts2, k6, k7, wrappers_k7 = run_cli(
            cli, rk, tk, ["-i", one_in, "-o", os.path.join(out_dir, "b_k7.png"), "-m", model_dir,
                          "-g", "0"], {"REALSR_TPU_PACKED_TAIL": "2"})
        launches2 = counts2["rdb_apply"]
        check(k7 == n1 and k6 == 0 and launches2 == 69 * n1,
              f"K7 CLI run: {k7} K7 / {k6} K6 / {launches2} RDB launches for {n1} chunks")
        print(f"main path, REALSR_TPU_PACKED_TAIL=2 (K7 tail): b.png, {n1} chunks, {launches2} "
              f"rdb_kernel launches, {k7} K7 launches {card}", flush=True)

        tta_engine = RealSR(gpuid=0, tta_mode=True, config=EngineConfig())
        tta_engine.load(mparam, mbin)
        tta_out = os.path.join(out_dir, "b_tta.png")
        wall, counts_x, k6_x, k7_x, _ = run_cli(
            cli, rk, tk, ["-i", one_in, "-o", tta_out, "-m", model_dir, "-g", "0", "-x"])
        launches_x = counts_x["rdb_apply"]
        chunks_x, batches_x = chunk_counts(tta_engine, one)
        with Image.open(tta_out) as im:
            check(np.asarray(im).shape == (800, 1200, 3), f"-x output {np.asarray(im).shape}")
        check(launches_x == 69 * batches_x and k6_x == (batches_x if tta_engine.tail == "kernel" else 0)
              and k7_x == 0, f"-x: {launches_x} RDB / {k6_x} K6 launches for {batches_x} forward batches")
        print(f"main path -x (TTA): b.png 200x300 -> 800x1200, tail {tta_engine.tail}, "
              f"{chunks_x} chunks, {batches_x} forward batches of 8 or 2 x 4 variants, "
              f"{launches_x} rdb_kernel launches, {k6_x} K6 launches, {wall:.3f} s {card}",
              flush=True)

        # the float32 path through the CLI: K1's and K6's float32 instances
        eng32 = RealSR(gpuid=0, config=EngineConfig(storage="float32"))
        eng32.load(mparam, mbin)
        n32, _ = chunk_counts(eng32, one)
        out32 = os.path.join(out_dir, "b_f32.png")
        wall, counts32, k6_32, k7_32, wrappers_32 = run_cli(
            cli, rk, tk, ["-i", one_in, "-o", out32, "-m", model_dir, "-g", "0"], {"REALSR_TPU_STORAGE": "float32"})
        f32_launches = counts32["rdb_apply"]
        with Image.open(out32) as im:
            check(np.asarray(im).shape == (800, 1200, 3), f"float32: output {np.asarray(im).shape}")
        check(f32_launches == 69 * n32 and sum(counts32.values()) == f32_launches and k6_32 == n32 and k7_32 == 0
              and eng32.tail == "kernel",
              f"float32 CLI run: launches {counts32}, K6 {k6_32}, K7 {k7_32}, tail {eng32.tail}; want 69 x {n32} "
              f"of rdb_apply only and {n32} of K6")
        print(f"main path, REALSR_TPU_STORAGE=float32: b.png, {n32} chunks, {f32_launches} rdb_apply launches "
              f"(K1's float32 instances), tail {eng32.tail}: {k6_32} K6 launches (its float32 instance), "
              f"{wall:.3f} s {card}", flush=True)
        del eng32
        # the float32 K7 tail, chained trunk and packed schedule through the CLI
        f32_env = {"REALSR_TPU_STORAGE": "float32"}
        _, c, k6_x32, k7_32, wrappers_k7_32 = run_cli(cli, rk, tk, ["-i", one_in, "-o", os.path.join(out_dir, "b_f32_k7.png"), "-m",
                                                    model_dir, "-g", "0"], {**f32_env, "REALSR_TPU_PACKED_TAIL": "2"})
        check(k7_32 == n32 and k6_x32 == 0 and c["rdb_apply"] == 69 * n32,
              f"float32 K7 CLI run: {k7_32} K7 / {k6_x32} K6 / {c} RDB launches for {n32} chunks")
        f32_modes, f32_modes_w = {}, {}
        for mode, flag, env, key in (("chained", "CHAINED_TRUNK", {}, "rdb_apply_chained"),
                                     ("packed", None, {"REALSR_TPU_SCHED": "packed"}, "rdb_apply_packed")):
            out_m = os.path.join(out_dir, f"b_f32_{mode}.png")
            wall, c, k6_m, _, w_m = run_cli(cli, rk, tk, ["-i", one_in, "-o", out_m, "-m", model_dir, "-g", "0"],
                                       {**f32_env, **env}, flag)
            with Image.open(out_m) as im:
                check(np.asarray(im).shape == (800, 1200, 3), f"float32 {mode}: output {np.asarray(im).shape}")
            check(c[key] == 69 * n32 and sum(c.values()) == c[key] and k6_m == n32,
                  f"float32 {mode} CLI run: launches {c}, K6 {k6_m}; want 69 x {n32} of {key} only")
            f32_modes[key] = c[key]
            f32_modes_w[key] = w_m[key]
            print(f"main path, REALSR_TPU_STORAGE=float32, trunk mode {mode}: b.png, {n32} chunks, {c[key]} {key} "
                  f"launches (float32 instances), 0 rdb_apply, {k6_m} K6, {wall:.3f} s {card}", flush=True)
        print(f"main path, REALSR_TPU_STORAGE=float32 REALSR_TPU_PACKED_TAIL=2: b.png, {n32} chunks, {k7_32} K7 "
              f"launches (its float32 instance) {card}", flush=True)

        # the trunk modes through the CLI, each on one image
        mode_launches, mode_w = {}, {}
        for mode, (_, flag, sched, key) in MODES.items():
            out_m = os.path.join(out_dir, f"b_{mode}.png")
            wall, counts_m, k6_m, _, w_m = run_cli(
                cli, rk, tk, ["-i", one_in, "-o", out_m, "-m", model_dir, "-g", "0"],
                {"REALSR_TPU_SCHED": sched} if sched else None, flag)
            with Image.open(out_m) as im:
                check(np.asarray(im).shape == (800, 1200, 3), f"{mode}: output {np.asarray(im).shape}")
            check(counts_m[key] == 69 * n1 and sum(counts_m.values()) == counts_m[key]
                  and k6_m == (n1 if engine.tail == "kernel" else 0),
                  f"{mode} CLI run: launches {counts_m}, K6 {k6_m}; want 69 x {n1} of {key} only")
            mode_launches[key] = counts_m[key]
            mode_w[key] = w_m[key]
            print(f"main path, trunk mode {mode} ({flag or f'REALSR_TPU_SCHED={sched}'}): b.png, {n1} "
                  f"chunks, {counts_m[key]} {key} launches, 0 rdb_apply, {k6_m} K6 launches, "
                  f"{wall:.3f} s {card}", flush=True)

        # -- 5. numerics of the slice ------------------------------------
        # phases 5-7 pin tile 128, so their engines share one tile plan and
        # their numbers stay comparable with PRs 8 and 9; the CLI runs of
        # phase 4 picked their tile per image (phase 8 holds the pick)
        auto_engine, auto_tta = engine, tta_engine
        engine = RealSR(gpuid=0, config=EngineConfig(tilesize=TILE128))
        engine.load(mparam, mbin)
        tta_engine = RealSR(gpuid=0, tta_mode=True, config=EngineConfig(tilesize=TILE128))
        tta_engine.load(mparam, mbin)
        # repair check: TF32 belongs to each engine's chunks, so a float32
        # engine leaves a mixed engine's pixels as they were (torch's
        # default flags before and after)
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
        before = engine.process(images["a.png"])
        # the float32 reference: plain convs for the trunk and the tail alike
        plain32 = RealSR(gpuid=0, config=EngineConfig(tilesize=TILE128, storage="float32", variant="dense", tail="interleaved"))
        plain32.load(mparam, mbin)
        ref_a = plain32.process(images["a.png"])
        after = engine.process(images["a.png"])
        flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        same, dmax = u8_same(before, after)
        check(same == 1.0 and flags == (True, False),
              f"mixed engine before/after a float32 engine: {same * 100:.4f}% equal u8, "
              f"max diff {dmax}; TF32 flags {flags}")
        print(f"TF32 scope: mixed engine output bit-equal before and after a float32 engine "
              f"loaded and ran; process flags unchanged {flags} {card}", flush=True)

        # float16 on "auto" takes plain convs, as the JAX engine's float16
        # takes its conv path; an explicit "cuda" raises (no kernel instance)
        f16 = RealSR(gpuid=0, config=EngineConfig(tilesize=TILE128, storage="float16"))
        f16.load(mparam, mbin)
        out16 = f16.process(images["a.png"])
        db16 = psnr(out16, ref_a)
        check(f16.variant == "dense" and out16.shape == ref_a.shape and db16 >= F16_MIN_DB,
              f"float16 engine: variant {f16.variant}, output {out16.shape}, {db16:.2f} dB vs float32")
        try:
            RealSR(gpuid=0, config=EngineConfig(tilesize=TILE128, storage="float16", variant="cuda")).load(mparam, mbin)
            fail("float16 with variant='cuda' loaded; it has no kernel instance")
        except NotImplementedError:
            pass
        print(f"float16 engine, variant auto -> {f16.variant}: 1/f image vs float32 plain {db16:.2f} dB "
              f"(>= {F16_MIN_DB}); variant='cuda' raises {card}", flush=True)

        plain_mixed = RealSR(gpuid=0, config=EngineConfig(tilesize=TILE128, variant="dense", tail="interleaved"))
        plain_mixed.load(mparam, mbin)
        k6_engine = engine
        if engine.tail != "kernel":
            k6_engine = RealSR(gpuid=0, config=EngineConfig(tilesize=TILE128, tail="kernel"))
            k6_engine.load(mparam, mbin)
        kern32 = RealSR(gpuid=0, config=EngineConfig(tilesize=TILE128, storage="float32"))
        kern32.load(mparam, mbin)
        # the float32 engines held to the float32 plain engine by u8 equality:
        # the default (K1 and K6's float32 instances), the chained and the
        # packed trunk (K3's, K5's)
        f32_engines = {"auto (K1, K6)": kern32}
        for mode, cfg in (("chained", dict(trunk="chained")), ("packed", dict(sched="packed"))):
            f32_engines[mode] = RealSR(gpuid=0, config=EngineConfig(tilesize=TILE128, storage="float32", **cfg))
            f32_engines[mode].load(mparam, mbin)
            check((f32_engines[mode].variant, f32_engines[mode].tail, f32_engines[mode].trunk,
                   f32_engines[mode].sched) == ("cuda", "kernel", cfg.get("trunk", "per_rdb"),
                                                cfg.get("sched", "scatter")),
                  f"float32 {mode} engine: variant {f32_engines[mode].variant}, tail {f32_engines[mode].tail}")
        tta32 = RealSR(gpuid=0, tta_mode=True,
                       config=EngineConfig(tilesize=TILE128, storage="float32", variant="dense", tail="interleaved"))
        tta32.load(mparam, mbin)
        tta_plain = RealSR(gpuid=0, tta_mode=True,
                           config=EngineConfig(tilesize=TILE128, variant="dense", tail="interleaved"))
        tta_plain.load(mparam, mbin)
        modes = {}
        for mode, (cfg, _, _, _) in MODES.items():
            modes[mode] = RealSR(gpuid=0, config=EngineConfig(tilesize=TILE128, **cfg))
            modes[mode].load(mparam, mbin)
            check((modes[mode].trunk, modes[mode].sched) == (cfg.get("trunk", "per_rdb"),
                                                              cfg.get("sched", "scatter")),
                  f"{mode} engine runs trunk {modes[mode].trunk}, sched {modes[mode].sched}")
        check(engine.variant == "cuda" and kern32.variant == "cuda", "engine did not pick the kernel")
        check(kern32.tail == "kernel", f"float32 engine tail {kern32.tail}: want its float32 K6")
        for label, img in (("1/f", images["a.png"]), ("noise", noise)):
            ref, ref_tta = plain32.process(img), tta32.process(img)
            db_plain = psnr(plain_mixed.process(img), ref)
            # TTA against float32 TTA, held to the plain mixed TTA path's
            # PSNR: TTA's averaging moves most pixels of these weights'
            # output to 0, which lifts every TTA PSNR alike
            db_tta_plain = psnr(tta_plain.process(img), ref_tta)
            dbs = {"default": (psnr(engine.process(img), ref), db_plain),
                   "K6 tail": (psnr(k6_engine.process(img), ref), db_plain),
                   "TTA": (psnr(tta_engine.process(img), ref_tta), db_tta_plain)}
            for mode, eng in modes.items():
                dbs[f"{mode} trunk"] = (psnr(eng.process(img), ref), db_plain)
            for what, (db, db_ref) in dbs.items():
                check(db >= db_ref - PSNR_SLACK,
                      f"{label}: mixed {what} vs float32 {db:.2f} dB, below the plain mixed "
                      f"path's {db_ref:.2f} dB by more than {PSNR_SLACK} dB")
            sames = {}
            for what, eng in f32_engines.items():
                sames[what] = u8_same(eng.process(img), ref)
                check(sames[what][0] >= SAME_MIN and sames[what][1] <= 1,
                      f"{label}: float32 {what} engine vs plain: {sames[what][0] * 100:.4f}% equal "
                      f"(want >= {SAME_MIN}), max diff {sames[what][1]}")
            band = "met" if dbs["default"][0] >= PSNR_BAND else "not met"
            print(f"numerics 256x192 {label}: vs float32 plain, mixed "
                  + ", ".join(f"{k} {v[0]:.2f} dB" for k, v in dbs.items())
                  + f"; mixed plain {db_plain:.2f} dB, mixed plain TTA {db_tta_plain:.2f} dB "
                  f"(each within {PSNR_SLACK} dB of its plain path; "
                  f"the {PSNR_BAND} dB band {band}); float32 engines vs float32 plain: "
                  + ", ".join(f"{w} {v[0] * 100:.4f}% equal u8, max diff {v[1]}" for w, v in sames.items())
                  + f" {card}", flush=True)

        # -- 6. steady state, device-resident ----------------------------
        big = natural_image(np.random.default_rng(1), *STEADY_HW)
        big_mp = 16 * STEADY_HW[0] * STEADY_HW[1] / 1e6
        tails = {}
        for t in TAILS:
            tails[t] = engine if t == engine.tail else RealSR(gpuid=0, config=EngineConfig(tilesize=TILE128, tail=t))
            if tails[t] is not engine:
                tails[t].load(mparam, mbin)
        # the tail forms and the trunk modes in turns, forward then
        # backward; median of all runs
        steady = {**tails, **{f"{m} trunk": e for m, e in modes.items()}}
        runs: dict = {t: [] for t in steady}
        for order in (list(steady), list(steady)[::-1]):
            for t in order:
                runs[t].append(steady_s(steady[t], big))
        rows = [(f"mixed, kernel trunk, {t} tail", float(np.median(runs[t]))) for t in TAILS]
        rows += [(f"mixed, {m} trunk mode ({modes[m].trunk}, {modes[m].sched}), "
                  f"{modes[m].tail} tail", float(np.median(runs[f"{m} trunk"]))) for m in modes]
        rows.append(("mixed, plain trunk and interleaved tail", steady_s(plain_mixed, big)))
        # the float32 engines in turns, as the mixed ones
        kern32_int = RealSR(gpuid=0, config=EngineConfig(tilesize=TILE128, storage="float32", tail="interleaved"))
        kern32_int.load(mparam, mbin)
        steady32 = {"float32, kernel trunk, K6 tail (auto)": kern32,
                    "float32, kernel trunk, interleaved (cuDNN) tail": kern32_int,
                    "float32, chained trunk (K3), K6 tail": f32_engines["chained"],
                    "float32, packed trunk (K5), K6 tail": f32_engines["packed"],
                    "float32, plain (dense)": plain32}
        runs32: dict = {t: [] for t in steady32}
        for order in (list(steady32), list(steady32)[::-1]):
            for t in order:
                runs32[t].append(steady_s(steady32[t], big))
        rows += [(t, float(np.median(v))) for t, v in runs32.items()]
        for label, s_img in rows:
            print(f"steady {STEADY_HW[1]}x{STEADY_HW[0]} RGB, {label}: {s_img:.4f} s/image, "
                  f"{big_mp / s_img:.3f} output MP/s {card}", flush=True)
        s_k32, s_i32, s_p32 = (float(np.median(runs32[t])) for t in list(steady32)[:2] + ["float32, plain (dense)"])
        print(f"float32 on variant auto (the kernel trunk, K6 tail) {big_mp / s_k32:.3f} vs the kernel trunk with the "
              f"interleaved tail {big_mp / s_i32:.3f} vs variant dense (cuDNN) {big_mp / s_p32:.3f} output MP/s "
              f"{card}", flush=True)
        tta_mp = 16 * 192 * 256 / 1e6
        s_tta = steady_s(tta_engine, images["a.png"])
        print(f"steady 256x192 RGB, mixed TTA (-x), {tta_engine.tail} tail: {s_tta:.4f} s/image, "
              f"{tta_mp / s_tta:.3f} output MP/s {card}", flush=True)
        s_k6, s_int = (float(np.median(runs[t])) for t in ("kernel", "interleaved"))
        print(f"auto tail on the card: {engine.tail}; K6 tail {big_mp / s_k6:.3f} vs interleaved "
              f"{big_mp / s_int:.3f} output MP/s, {'K6' if s_k6 < s_int else 'interleaved'} faster "
              f"{card}", flush=True)
        ref = plain32.process(big)
        dbs = {t: psnr(steady[t].process(big), ref) for t in steady}
        db_plain = psnr(plain_mixed.process(big), ref)
        for t, db in dbs.items():
            check(db >= db_plain - PSNR_SLACK,
                  f"steady image, {t}: {db:.2f} dB vs float32, plain mixed {db_plain:.2f} dB")
        print(f"steady numerics: vs float32 plain, mixed kernel trunk with tail (or trunk mode) "
              + ", ".join(f"{t} {db:.2f} dB" for t, db in dbs.items())
              + f"; mixed plain {db_plain:.2f} dB", flush=True)
        for what, eng in (("mixed image, kernel trunk, kernel tail", tails["kernel"]),
                          ("mixed image, kernel trunk, interleaved tail", tails["interleaved"]),
                          ("float32 image, kernel trunk, kernel tail", kern32)):
            wall, groups, top = profile_image(eng, big)
            dev_ms = sum(groups.values())
            if not dev_ms:
                print("profile: torch.profiler recorded no device time (not measured)", flush=True)
                continue
            parts = ", ".join(f"{g} {ms:.1f} ms ({100 * ms / dev_ms:.1f} %)"
                              for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]))
            print(f"profile of one {what}: wall {1e3 * wall:.1f} ms "
                  f"under the profiler, kernels {dev_ms:.1f} ms (device idle "
                  f"{100 * (1 - dev_ms / (1e3 * wall)):.1f} %): {parts}; costliest: "
                  + "; ".join(f"{ms:.1f} ms {n[:90]}" for ms, n in top) + f" {card}", flush=True)

        # -- 7. slice 9 --------------------------------------------------
        big_band: dict = {}
        slice9(cli, rk, tk, mparam, mbin, work, card, engine, kern32, plain32, tta_engine, rng, big_band)
        k7_engine = tails["kernel_hr"]  # phase 11, with the trunk modes' engines
        del tails, steady, steady32, f32_engines, kern32_int, tta32, tta_plain, plain_mixed, f16, k6_engine
        torch.cuda.empty_cache()

        # -- 8-10. slice 10: the tile pick, mesh mode, the native bridge ----
        kern32_auto = RealSR(gpuid=0, config=EngineConfig(storage="float32"))
        kern32_auto.load(mparam, mbin)
        new_shapes = slice10_pick(rk, tk, mparam, mbin, card, auto_engine, engine, plain32, kern32, kern32_auto)
        slice10_mesh(cli, rk, tk, mparam, mbin, work, card, auto_engine, auto_tta, kern32_auto, one_in,
                     os.path.join(out_dir, "b.png"))
        slice10_bridge(mparam, mbin, work, card, auto_engine, kern32_auto)

        # -- 11. slice 11: the chunk program table, the fences, precompile --
        t11 = time.perf_counter()
        slice11(rk, tk, mparam, mbin, card, auto_engine, engine, kern32_auto, auto_tta, modes, k7_engine, big_band)
        print(f"phase 11: {time.perf_counter() - t11:.1f} s {card}", flush=True)

        # -- 12. the cold start: group builds, fast start, the seed --------
        t12 = time.perf_counter()
        slice12(mparam, card, auto_engine, {"default": auto_engine, "tile 128": engine, "float32": kern32_auto,
                                            "TTA": auto_tta, "K7 tail": k7_engine,
                                            **{f"{k} trunk": e for k, e in modes.items()}})
        print(f"phase 12: {time.perf_counter() - t12:.1f} s {card}", flush=True)

        # -- 13. slice 13: the upload that does not wait, the profile --------
        t13 = time.perf_counter()
        slice13(rk, tk, mparam, mbin, card, auto_engine, engine, big_band)
        print(f"phase 13: {time.perf_counter() - t13:.1f} s {card}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # every kernel of the repo's TPU kernels' counterparts, with its launches
    # on the main path (K1/K2: the default CLI run, their float32 instances
    # and K6's the REALSR_TPU_STORAGE=float32 run; K6: K6's; K7: the
    # REALSR_TPU_PACKED_TAIL=2 run; K3-K5: their modes' runs; the float32 K3,
    # K5 and K7: the float32 runs of their modes) and its bound. "launches"
    # is what the wrapper counted in that run (eager chunks, and each
    # capture's warm-up, which computes a chunk, and its recording);
    # "launches_replayed" what ran on the card (executed: eager chunks,
    # warm-ups and replays)
    wrapped = {
        "K1": wrappers_main["rdb_apply"], "K2": wrappers_main["rdb_apply"],
        "K1 float32": wrappers_32["rdb_apply"], "K2 float32": wrappers_32["rdb_apply"],
        "K3": mode_w["rdb_apply_chained"], "K4": mode_w["rdb_apply_paired"], "K5": mode_w["rdb_apply_packed"],
        "K6": wrappers_k6["up2_hr_last_packed"], "K7": wrappers_k7["hr_last_packed"],
        "K3 float32": f32_modes_w["rdb_apply_chained"], "K5 float32": f32_modes_w["rdb_apply_packed"],
        "K6 float32": wrappers_32["up2_hr_last_packed"], "K7 float32": wrappers_k7_32["hr_last_packed"],
    }
    tail_px = B * 16 * SIDE * SIDE
    kernels = []
    for key, kname, src, replaces, n, macs, result in (
        ("K1", "rdb_wgmma (rdb_kernel<T, state, nf, gc>: wgmma, one RDB)", "rdb_wgmma.cu",
         "realsr_tpu/ops/rdb_kernel.py:263", launches, rdb_macs, ("rdb", "mixed")),
        ("K2", "rdb_wgmma (69-RDB trunk: rdb_trunk)", "rdb_wgmma.cu", "realsr_tpu/ops/rdb_kernel.py:758",
         launches, n_rdb * rdb_macs, ("trunk", "mixed")),
        ("K1 float32", "rdb_tf32 (rdb_tf32_kernel<T, nf, gc>: 3xTF32 wgmma, one RDB)", "rdb_tf32.cu",
         "realsr_tpu/ops/rdb_kernel.py:263", f32_launches, rdb_macs, ("rdb", "float32")),
        ("K2 float32", "rdb_tf32 (69-RDB float32 trunk: rdb_trunk)", "rdb_tf32.cu",
         "realsr_tpu/ops/rdb_kernel.py:758", f32_launches, n_rdb * rdb_macs, ("trunk", "float32")),
        ("K3", "rdb_modes_wgmma (chained_kernel<T, state, nf, gc>: wgmma, rdb_apply_chained)",
         "rdb_modes_wgmma.cu", "realsr_tpu/ops/rdb_kernel.py:675", mode_launches["rdb_apply_chained"], rdb_macs,
         ("K3", "mixed")),
        ("K4", "rdb_modes_wgmma (paired_kernel<T, nf, gc>: wgmma, rdb_apply_paired)", "rdb_modes_wgmma.cu",
         "realsr_tpu/ops/rdb_kernel.py:595", mode_launches["rdb_apply_paired"], rdb_macs, ("K4", "mixed")),
        ("K5", "rdb_modes_wgmma (packed_kernel<T, state, nf, gc>: wgmma, rdb_apply_packed)", "rdb_modes_wgmma.cu",
         "realsr_tpu/ops/rdb_kernel.py:216", mode_launches["rdb_apply_packed"], rdb_macs, ("K5", "mixed")),
        ("K6", "tail_kernel (tail_kernel<TH, TW, true>: wgmma, up2_hr_last_packed)", "tail_kernel.cu",
         "realsr_tpu/ops/tail_kernel.py:103", k6_cli, tail_px * tk.tail_macs_per_pixel(True), ("K6", "mixed")),
        ("K7", "tail_kernel (tail_kernel<TH, TW, false>: wgmma, hr_last_packed)", "tail_kernel.cu",
         "realsr_tpu/ops/tail_kernel.py:329", k7, tail_px * tk.tail_macs_per_pixel(False), ("K7", "mixed")),
        ("K3 float32", "rdb_modes_tf32 (chained_kernel<T, float, nf, gc, LayoutF32>: 3xTF32 wgmma, "
         "rdb_apply_chained)", "rdb_modes_tf32.cu", "realsr_tpu/ops/rdb_kernel.py:675",
         f32_modes["rdb_apply_chained"], rdb_macs, ("K3 float32", "f32")),
        ("K5 float32", "rdb_modes_tf32 (packed_kernel<T, float, nf, gc, LayoutF32>: 3xTF32 wgmma, "
         "rdb_apply_packed)", "rdb_modes_tf32.cu", "realsr_tpu/ops/rdb_kernel.py:216",
         f32_modes["rdb_apply_packed"], rdb_macs, ("K5 float32", "f32")),
        ("K6 float32", "tail_tf32 (tail_kernel<TH, TW, true, float>: 3xTF32 wgmma, up2_hr_last_packed)",
         "tail_tf32.cu", "realsr_tpu/ops/tail_kernel.py:103", k6_32, tail_px * tk.tail_macs_per_pixel(True),
         ("K6 float32", "f32")),
        ("K7 float32", "tail_tf32 (tail_kernel<TH, TW, false, float>: 3xTF32 wgmma, hr_last_packed)",
         "tail_tf32.cu", "realsr_tpu/ops/tail_kernel.py:329", k7_32, tail_px * tk.tail_macs_per_pixel(False),
         ("K7 float32", "f32")),
    ):
        err, ms, pms = results[result]
        b_ms, b_by = bound(macs, results[(key, "io")], tf32=key.endswith("float32"))
        kernels.append({
            "name": f"{key} {kname}", "route": "cuda", "source": f"realsr_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": wrapped[key], "launches_replayed": n, "max_abs_err": err, "ms": ms,
            "plain_ms": pms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library.get(key),
            "checked_against_plain": True,  # phases 3-3c fail on any disagreement
        })
        if key in ("K1", "K1 float32", "K6", "K6 float32"):
            # phase 8a: the chunk shapes of tiles 192 and 256
            kernels[-1]["at_new_shapes"] = {shape: rows[key] for shape, rows in new_shapes.items()}
        check(n > 0 and wrapped[key] > 0, f"{key}: no launch on the main path")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
