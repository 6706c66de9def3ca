"""Embedded-interpreter bridge for the port's C++ CLI
(realsr_tpu_torch/native/cli/main.cpp).

Counterpart of ``realsr_tpu/native_bridge.py``, with the same surface. The
C++ binary owns argument parsing, file listing, the bounded task queue and
the codec threads (the reference's native surface, src/main.cpp); it calls
into this module only for the device work:

    init(config_json) -> scale       build one engine per device id
    device_count() -> int            CUDA device count (gpu-id checks)
    process(engine_idx, pixels, w, h, c) -> bytes   uint8 HWC in/out
    process_async(engine_idx, pixels, w, h, c) -> handle
    process_batch_async(engine_idx, pixel_list, w, h, c) -> [handle]
    fetch(handle) -> bytes           the one download; frees the handle
    num_engines() -> int
    warmup(first_path) -> int        precompile the first image's programs

The async pair is how the C++ save threads overlap download and encode with
the proc threads' next image's compute — the proc/save split the
reference's pipeline exists for (src/main.cpp:305-416). torch launches are
asynchronous, so process_async returns once the image's chunks are enqueued;
fetch() performs the single download.

The engines read ``REALSR_TPU_FAST_START`` (and the other engine
variables) from the environment the binary was started with, as the
Python CLI's do.

Device ids are CUDA device indices; ``gpuid`` all -1 builds CPU engines,
and an id >= 0 needs CUDA and raises without it (no path carries on on the
CPU). Buffers cross the boundary as raw bytes (C contiguous HWC uint8).
"""

from __future__ import annotations

import itertools
import json
import os
import sys
from typing import Dict, List, Tuple

_engines: List = []
_handles: Dict[int, Tuple[object, object]] = {}  # handle -> (engine, device buf or host array)
_next_handle = itertools.count(1)


def init(config_json: str) -> int:
    """Build engines per the CLI's parsed config. Returns the model scale."""
    cfg = json.loads(config_json)
    gpuid = cfg["gpuid"]

    if all(g == -1 for g in gpuid):
        # map -j's proc count onto torch's CPU intra-op pool (same contract
        # as cli.py; reference main.cpp:734-746)
        from realsr_tpu_torch.utils.cputhreads import (
            configure_cpu_threads,
            notice_cpu_threads_ignored,
        )

        if not configure_cpu_threads(cfg["jobs_proc"][0]):
            notice_cpu_threads_ignored()

    from realsr_tpu_torch.engine import EngineConfig, RealSR

    global _engines
    _engines = []
    storage = os.environ.get("REALSR_TPU_STORAGE", "auto")

    # multi-GPU mesh mode (REALSR_TPU_MESH=all|i,j,...): one engine dealing
    # each image's tile chunks to the mesh's devices; every C++ proc thread
    # slot aliases it so engine_idx stays valid
    mesh_env = os.environ.get("REALSR_TPU_MESH", "")
    if mesh_env:
        # mesh_from_env raises ValueError('invalid REALSR_TPU_MESH ...')
        # on bad input; the C++ CLI surfaces it via PyErr_Print + its
        # 'engine init failed' diagnostic
        from realsr_tpu_torch.parallel.mesh import mesh_from_env, pool_for

        # gpuid all -1 draws the mesh from the CPU; an id >= 0 from the
        # CUDA devices, and raises without CUDA
        mesh = mesh_from_env(mesh_env, pool_for(gpuid))
        e = RealSR(
            tta_mode=cfg["tta_mode"],
            num_threads=cfg["jobs_proc"][0],
            config=EngineConfig(
                tilesize=cfg["tilesize"][0],
                prepadding=cfg["prepadding"],
                storage=storage,
            ),
            mesh=mesh,
        )
        e.load(cfg["parampath"], cfg["modelpath"])
        _engines = [e] * len(gpuid)
        return e.scale

    for i, g in enumerate(gpuid):
        ec = EngineConfig(
            tilesize=cfg["tilesize"][i],
            prepadding=cfg["prepadding"],
            storage=storage,
        )
        e = RealSR(
            gpuid=g,
            tta_mode=cfg["tta_mode"],
            num_threads=cfg["jobs_proc"][i],
            config=ec,
        )
        e.load(cfg["parampath"], cfg["modelpath"])
        _engines.append(e)
    return _engines[0].scale


def warmup(first_path: str) -> int:
    """CLI warm-up parity (REALSR_TPU_PRECOMPILE, cli.py's warm-up block):
    decode the first input with the pipeline's own codec path and call
    every engine's ``precompile`` for its shape (once per engine: mesh mode
    aliases one engine to every slot), and for the REALSR_TPU_IMAGE_BATCH
    stack. Returns the programs' total; never raises (warm-up must not
    break processing)."""
    try:
        from realsr_tpu_torch.io.codecs import decode_image

        img = decode_image(first_path)
        if img is None:
            raise ValueError(f"cannot decode {first_path}")
        h, w, c = img.shape
        ib = max(1, int(os.environ.get("REALSR_TPU_IMAGE_BATCH", "1") or 1))
        total = 0
        for e in dict.fromkeys(_engines):
            total += e.precompile(w, h, channels=c)
            nb = min(ib, e.max_batch_images((h, w, c)))
            if nb > 1:
                total += e.precompile(w, h, channels=c, n_img=nb)
        return total
    except Exception as ex:
        print(f"precompile skipped: {ex}", file=sys.stderr)
        return 0


def device_count() -> int:
    """Size of the CUDA device pool engine gpuids index into (the analog of
    ncnn::get_gpu_count, reference main.cpp:722-732): 0 without CUDA, so
    the C++ CLI answers ``-g 0`` there with "invalid gpu device", as the
    port's Python CLI does. Importable before init()."""
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _dispatch(engine_idx: int, pixels: bytes, w: int, h: int, c: int):
    import numpy as np

    img = np.frombuffer(pixels, dtype=np.uint8).reshape(h, w, c)
    return _dispatch_img(engine_idx, img)


def _dispatch_img(engine_idx: int, img):
    eng = _engines[engine_idx]

    def cb(frac):  # per-tile progress contract (realsr.cpp:481)
        print(f"{frac * 100.0:.2f}%", file=sys.stderr)

    if eng.needs_banding(img.shape):
        # over the device budget: band-stream (O(band) memory,
        # bit-identical) exactly like the Python CLI; the result is a HOST
        # array, which engine.fetch passes through unchanged
        return eng, eng.process_banded(img, progress_cb=cb)
    return eng, eng.process_device(img, progress_cb=cb)


def process(engine_idx: int, pixels: bytes, w: int, h: int, c: int) -> bytes:
    """Run one image through engine ``engine_idx``; returns scaled u8 HWC."""
    eng, buf = _dispatch(engine_idx, pixels, w, h, c)
    return eng.fetch(buf).tobytes()


def process_async(engine_idx: int, pixels: bytes, w: int, h: int, c: int) -> int:
    """Dispatch; the result stays ON DEVICE until fetch(handle)."""
    eng, buf = _dispatch(engine_idx, pixels, w, h, c)
    handle = next(_next_handle)
    _handles[handle] = (eng, buf)  # GIL-serialized; no lock needed
    return handle


def process_batch_async(engine_idx: int, pixel_list, w: int, h: int, c: int):
    """Same-shape image stack -> one device batch (tiles of all images
    share the conv chunks, engine._process_stack_device) -> one handle per
    image. The C++ CLI's cross-image batching path (REALSR_TPU_IMAGE_BATCH),
    mirroring pipeline.proc_worker."""
    import numpy as np

    eng = _engines[engine_idx]
    imgs = [np.frombuffer(p, dtype=np.uint8).reshape(h, w, c) for p in pixel_list]
    # stage into a local map and merge only after EVERY sub-stack
    # dispatched: if a later sub-stack raises (e.g. out of memory), the C++
    # caller gets no handle list, and handles registered globally before the
    # failure would leak their device buffers for the process lifetime
    staged: Dict[int, Tuple[object, object]] = {}
    handles = []
    cap = eng.max_batch_images((h, w, c))
    for k in range(0, len(imgs), max(1, cap)):
        sub = imgs[k : k + max(1, cap)]
        if len(sub) == 1 or cap < 2:
            # stack over budget (or single image): per-image path, which
            # band-streams oversized images like the Python pipeline
            for img in sub:
                handle = next(_next_handle)
                staged[handle] = _dispatch_img(engine_idx, img)
                handles.append(handle)
            continue
        buf = eng._process_stack_device(np.stack(sub))
        for i in range(len(sub)):
            handle = next(_next_handle)
            staged[handle] = (eng, buf[i])
            handles.append(handle)
    _handles.update(staged)
    return handles


def fetch(handle: int) -> bytes:
    """The one download per image; consumes the handle."""
    eng, buf = _handles.pop(handle)
    return eng.fetch(buf).tobytes()


def num_engines() -> int:
    return len(_engines)
