"""RealSR engine on one torch device: tiled, alpha-aware super-resolution.

Counterpart of ``realsr_tpu/engine.py`` (the reference's ``RealSR`` class,
src/realsr.h:13-42):

1. upload the uint8 image once; normalize (x 1/255) and reflect-101 pad it by
   ``prepadding`` on the device (src/realsr_preproc.comp semantics),
2. group the tiles of ``tiling.planner.plan_tiles`` into same-shape buckets
   and run each bucket as batched chunks through the forward,
3. crop the halo, round to uint8 with ``clamp(floor(v * 255 + 0.5))``
   (src/realsr_postproc.comp:66-83) and scatter into one full-resolution
   uint8 device buffer; one download per image.

Alpha never enters the net: it is bicubic-upscaled (A = -0.75) raw in 0..255
and merged back. With TTA (``-x``) each chunk runs the net on the 8 dihedral
variants of its tiles and averages the inverse-transformed outputs x 0.125
in float32 before the crop. An image whose whole-image run would exceed the
band budget (``REALSR_TPU_BAND_BUDGET_MB``) streams through the device in
bands of whole tile rows (:meth:`RealSR.process_banded`), bit-identical to
the whole-image run.

On a card the tile size is picked per image (``EngineConfig.tilesize`` 0:
``tiling.planner.pick_tilesize`` over 128 / 192 / 256, weighted by rates
measured on the H100); the CPU keeps the reference's fixed 200. With a
``mesh`` (``parallel.mesh``) one engine deals an image's whole chunks
round-robin to the mesh's devices: each writes its own tiles into a private
u8 output, and the outputs merge once per image.

On a card the upload does not wait for the card (the JAX engine's
``jax.device_put``): :func:`_upload` stages the image in pinned memory and
copies it on the device's upload stream, which the compute stream waits for
by an event, so a proc thread enqueues image k+1 while image k computes.

On a card the chunks of a program key ``(ph, pw, batch, tta, alpha)`` on a
device run through a CUDA graph of that key (the JAX engine's AOT table of
compiled chunk programs): the key's first chunk eagerly, so a size met once
pays no capture, its second by the capture, later ones as replays
(:meth:`RealSR.precompile` fills the table ahead of a request). The graph
holds the chunk's forward, halo crop, rounding and alpha bicubic between
static tile and u8 buffers; the dispatch loop copies each chunk's tiles in,
replays, and scatters out. An image's download runs on a copy stream that
waits only for that image's last scatter, so it overlaps the next image's
compute; the progress fence waits on events of its own chunks.

On a card the first chunk, or :meth:`RealSR.precompile`, waits for the
kernel libraries the forward launches: the build groups of those instances
alone (fast start; ``ops/build.py``), built at once where the host's build
cache, scoped by its fingerprint, lacks them (the JAX engine's fast start
and compilation cache, in nvcc's terms).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import sys
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from realsr_tpu_torch.tiling.planner import CPU_TILESIZE, _anchors, anchor_provenance_notice, pick_tilesize, plan_tiles
from realsr_tpu_torch.utils.trace import maybe_start_profiler, tracer
from realsr_tpu_torch.loader import ModelBundle, load_model
from realsr_tpu_torch.models import rrdbnet as R
from realsr_tpu_torch.models.rrdbnet import SCHEDS, TAIL_MODES, tf32
from realsr_tpu_torch.ops import build
from realsr_tpu_torch.ops.pad import reflect101_indices, reflect101_pad2d, reflect101_pad_w
from realsr_tpu_torch.ops.rdb_kernel import rdb_group
from realsr_tpu_torch.ops.resize import resize_bicubic
from realsr_tpu_torch.ops.tail_kernel import tail_group
from realsr_tpu_torch.ops.tta import NUM_TRANSFORMS, d4_inverse, d4_transform

# one-shot operator notices (the planner anchors' provenance): printed at
# most once per process however many engines load
_PRINTED_NOTICES: set = set()


@dataclasses.dataclass
class EngineConfig:
    # 0 = auto: picked per image on a card (planner.pick_tilesize), the
    # reference's fixed 200 on the CPU
    tilesize: int = 0
    prepadding: int = 10  # DF2K halo (src/main.cpp:661-667)
    # "auto" (mixed on CUDA, float32 on the CPU) | "float32" | "mixed" |
    # "bfloat16" | "float16"
    storage: str = "auto"
    # tiles per chunk at most: 0 = auto (_auto_batch: 8, fewer where the
    # band budget or TTA asks); chunks are min(max_batch, the bucket's tile
    # count rounded up to a power of two), as in the JAX engine
    max_batch: int = 0
    # RDB conv formulation: "auto" | "dense" | "scatter" | "cuda". "auto"
    # (_resolve_variant) is the fused CUDA kernel on a GPU and plain convs
    # on the CPU; float16, which the kernel has no instance for, takes plain
    # convs on a GPU too, as the JAX engine takes its conv path. An explicit
    # "cuda" with float16 raises.
    variant: str = "auto"
    # tail form (models.rrdbnet.TAIL_MODES): "auto" | "interleaved" |
    # "packed" | "kernel_hr" (K7) | "kernel" (K6). "auto" (_resolve_tail)
    # reads REALSR_TPU_PACKED_TAIL like the JAX engine; unset, it is the
    # fused tail kernel for the kernel variant ("cuda") on a GPU where the
    # kernel has an instance (bf16 or float32 operands, nf 64, 3 outputs),
    # as only JAX's kernel variant takes its packed tail, and "interleaved"
    # for "dense" and "scatter" and on the CPU.
    tail: str = "auto"
    # the kernel trunk's form (variant "cuda"): "auto" | "per_rdb" |
    # "chained" (K3) | "paired" (K4, mixed mode). "auto" reads the module
    # flags models.rrdbnet.CHAINED_TRUNK and PAIRED_CARRY at load, as the
    # JAX package does: chained if set, else paired if set and the precision
    # is mixed, else per_rdb.
    trunk: str = "auto"
    # the per-RDB kernel's schedule: "scatter" (K1) | "packed" (K5).
    # REALSR_TPU_SCHED overrides it on the kernel trunk (sched_env).
    sched: str = "scatter"
    # on a card, run each chunk as the replay of a CUDA graph captured once
    # per chunk program (RealSR.graphs); False launches every chunk's work
    # from Python. The CPU and the generic executor always run eagerly: the
    # executor's layers upload constants on each call, which a capture
    # cannot hold.
    cuda_graphs: bool = True
    # Fast start (the JAX engine's name; on a card): before its first launch
    # the engine builds, all at once, only the kernel groups
    # (ops/build.py::GROUPS) its resolved forms launch, a few instances of a
    # source each (RealSR.kernel_groups); off, every group of those
    # sources. Both launch the same instances, so the output is bit-equal
    # either way (JAX's fast tile moves pixels; nothing here does).
    # REALSR_TPU_FAST_START=0 turns it off, as in the JAX engine.
    fast_start: bool = True
    # keep built kernels in the build cache (ops/build.py: <root>/<host
    # fingerprint>/) for later processes; False builds into a directory of
    # this process, removed at exit
    compilation_cache: bool = True


@dataclasses.dataclass(frozen=True)
class Device:
    """Where an engine runs: ``platform`` is "gpu" or "cpu" (what
    ``realsr_tpu_torch.pipeline`` reads); ``torch_device`` is the real device."""

    platform: str
    torch_device: torch.device


_PRECISION = {
    "float32": (torch.float32, torch.float32),
    "mixed": (torch.float32, torch.bfloat16),
    "bfloat16": (torch.bfloat16, torch.bfloat16),
    "float16": (torch.float16, torch.float16),
}


def _resolve_precision(storage: str, device: Device) -> tuple:
    """storage mode -> (storage_dtype, op_dtype). ``auto`` is mixed (float32
    carried state, bfloat16 conv operands) on a GPU and float32 on the CPU,
    like the reference's all-f32 CPU path."""
    if storage == "auto":
        storage = "mixed" if device.platform == "gpu" else "float32"
    if storage not in _PRECISION:
        raise ValueError(f"unknown storage mode {storage!r}")
    return _PRECISION[storage]


def _resolve_variant(variant: str, platform: str, dtype) -> str:
    """``variant`` with "auto" resolved: "cuda" on a GPU, except for float16
    storage, which gets "dense" (the JAX engine's float16 runs on its conv
    path, realsr_tpu/engine.py:259-270); "dense" on the CPU."""
    if variant != "auto":
        return variant
    return "cuda" if platform == "gpu" and dtype != torch.float16 else "dense"


def _resolve_tail(tail: str, variant: str, platform: str) -> str:
    """``tail`` with "auto" resolved: ``REALSR_TPU_PACKED_TAIL`` where set;
    else "kernel" (K6) for the kernel variant on a GPU and "interleaved"
    for "dense" and "scatter" and on the CPU, as the JAX engine keeps the
    interleaved tail on its conv variants (realsr_tpu/engine.py:287-336)."""
    if tail != "auto":
        return tail
    return packed_tail_env() or ("kernel" if platform == "gpu" and variant == "cuda" else "interleaved")


def packed_tail_env() -> Optional[str]:
    """``REALSR_TPU_PACKED_TAIL`` parsed as the JAX engine parses it: unset
    or empty -> None; a non-digit -> level 0; else ``min(int, 3)``. Levels
    0-3 are interleaved, packed, kernel_hr (K7) and kernel (K6)."""
    raw = os.environ.get("REALSR_TPU_PACKED_TAIL", "")
    if not raw:
        return None
    return TAIL_MODES[min(int(raw), 3) if raw.isdigit() else 0]


def sched_env() -> Optional[str]:
    """``REALSR_TPU_SCHED`` parsed as the JAX engine parses it: only the
    exact strings "scatter" and "packed" count; anything else is None."""
    raw = os.environ.get("REALSR_TPU_SCHED", "")
    return raw if raw in SCHEDS else None


def _resolve_trunk(config: EngineConfig, variant: str, dtype, op_dtype) -> tuple:
    """(trunk, sched) for the forward. On the kernel trunk, "auto" reads
    the module flags and ``REALSR_TPU_SCHED`` overrides ``config.sched``; on
    plain convs, where the JAX package's flags and SCHED have no effect,
    "auto" is per_rdb and the environment is not read."""
    trunk, sched = config.trunk, config.sched
    if variant != "cuda":
        return ("per_rdb" if trunk == "auto" else trunk), sched
    if trunk == "auto":
        mixed = (dtype, op_dtype) == (torch.float32, torch.bfloat16)
        trunk = "chained" if R.CHAINED_TRUNK else "paired" if R.PAIRED_CARRY and mixed else "per_rdb"
    return trunk, sched_env() or sched


def _auto_batch(
    tilesize: int,
    tta: bool,
    budget_bytes: int = 2048 * 1024 * 1024,
    nf: int = 64,
    dsize: int = 2,
) -> int:
    """Tiles per chunk: at most 8, fewer when the tail's nf-channel
    activations at 16x the padded tile area would exceed the budget; TTA
    runs 8 variants of each tile, so it divides the batch by 8."""
    px = (tilesize + 20) ** 2
    per_tile = 16 * px * nf * dsize
    b = max(1, min(8, budget_bytes // per_tile))
    return max(1, b // 8) if tta else b


def _round_u8(v: torch.Tensor) -> torch.Tensor:
    """f32 -> uint8 with the reference's rounding (postproc.comp:66-83)."""
    return torch.floor(v * 255.0 + 0.5).clamp(0.0, 255.0).to(torch.uint8)


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return torch.from_numpy(np.ascontiguousarray(tree)).to(device)


def kernel_groups(variant, trunk, sched, tail, op_dtype, storage_dtype, nf: int = 64) -> tuple:
    """The (source, group) libraries (``ops/build.py::GROUPS``) whose
    kernels a forward of this resolved form launches: the trunk's (K1/K2,
    or the mode kernels K3-K5) at the state type and width, and the kernel
    tail's form (K6 or K7), in the operand type's instance (3xTF32 for
    float32)."""
    f32 = op_dtype == torch.float32
    out = []
    if variant == "cuda":
        group = rdb_group(torch.float32 if f32 else storage_dtype, nf)
        if trunk == "per_rdb" and sched == "scatter":
            out.append(("rdb_tf32" if f32 else "rdb_wgmma", group))
        else:
            out.append(("rdb_modes_tf32" if f32 else "rdb_modes_wgmma", group))
    if tail in ("kernel", "kernel_hr"):
        out.append(("tail_tf32" if f32 else "tail_kernel", tail_group(tail == "kernel")))
    return tuple(out)


def _on_card(device: torch.device) -> bool:
    """Whether the kernel wrappers launch their kernels for tensors on
    ``device`` (a CUDA device), rather than run their plain versions."""
    return device.type == "cuda"


def fast_start_env() -> bool:
    """False where ``REALSR_TPU_FAST_START`` is "0", as the JAX engine reads
    it."""
    return os.environ.get("REALSR_TPU_FAST_START", "1") != "0"


def _resolve_forms(config: EngineConfig, device: Device) -> tuple:
    """(storage dtype, operand dtype, variant, trunk, sched, the tail to ask
    the loader for) of an engine of ``config`` on ``device``."""
    dtype, op_dtype = _resolve_precision(config.storage, device)
    variant = _resolve_variant(config.variant, device.platform, dtype)
    if variant == "cuda" and dtype == torch.float16:
        raise NotImplementedError(
            "the fused RDB kernel has no float16 instance (the JAX package runs "
            "float16 on its conv path too); pass variant='dense' to run float16 on plain convs"
        )
    trunk, sched = _resolve_trunk(config, variant, dtype, op_dtype)
    tail = _resolve_tail(config.tail, variant, device.platform)
    if tail == "kernel" and config.tail == "auto" and packed_tail_env() is None:
        tail = "auto"  # the loader's auto: K6 where it has an instance for the graph
    return dtype, op_dtype, variant, trunk, sched, tail


def card_kernel_groups(config: EngineConfig, parampath: str, modelpath: str) -> tuple:
    """What :meth:`RealSR.kernel_groups` of an engine of ``config`` loaded
    with this model gives on a card, resolved on any host (the seed tool's
    build host may have no card)."""
    dtype, op_dtype, variant, trunk, sched, tail = _resolve_forms(config, Device("gpu", torch.device("cuda", 0)))
    bundle = load_model(parampath, modelpath, storage_dtype=dtype, op_dtype=op_dtype,
                        variant=variant, tail=tail, trunk=trunk, sched=sched)
    if bundle.spec is None:
        return ()
    return _build_set(kernel_groups(variant, trunk, sched, bundle.tail, op_dtype, dtype, bundle.spec.nf),
                      config.fast_start and fast_start_env())


def _build_set(launched: tuple, fast_start: bool) -> tuple:
    """The groups to build for the ``launched`` ones: those alone with fast
    start, else every group of their sources."""
    if fast_start:
        return launched
    return tuple((src, g) for src in dict.fromkeys(src for src, _ in launched) for g in build.GROUPS[src])


class _DeviceState:
    """What the engines of a process share on one device. ``lock``
    serializes the capture and the replay of every chunk program on the
    device, each with its copy-in and scatter-out; ``last`` orders those
    replays on the GPU when callers' threads use different streams. The
    graphs' scratch shares one ``pool``, which is safe only because no
    graph's pool memory outlives its replay (the static buffers live
    outside it) and no two replays on a device overlap. Captures run on
    ``capture_stream`` (one stream, so that later captures reuse the pool's
    freed blocks) and downloads on ``copy_stream``. The pool lives as long
    as the process: the allocator refuses a capture into a pool whose
    graphs have all been freed, as an engine's graphs are when it is, so a
    graph that is never replayed (``_keeper``) holds it. Uploads run on
    ``upload_stream`` (:func:`_upload`), not on ``copy_stream``, whose
    downloads wait for their images. On the CPU, where only the tests'
    stand-in graphs run, only ``lock`` is used."""

    def __init__(self, device: torch.device):
        self.lock = threading.Lock()
        self.pool = self.capture_stream = self.copy_stream = self.upload_stream = self.last = None
        if device.type != "cuda":
            return
        self.pool = torch.cuda.graph_pool_handle()
        self.capture_stream = torch.cuda.Stream(device)
        self.copy_stream = torch.cuda.Stream(device)
        self.upload_stream = torch.cuda.Stream(device)
        self.last = torch.cuda.Event()
        self._keeper = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self.capture_stream):
            self._keeper.capture_begin(pool=self.pool, capture_error_mode="thread_local")
            torch.zeros(1, device=device)
            self._keeper.capture_end()


_DEVICE_STATES: dict = {}
_DEVICE_STATES_LOCK = threading.Lock()


def _device_state(device: torch.device) -> _DeviceState:
    with _DEVICE_STATES_LOCK:
        if device not in _DEVICE_STATES:
            _DEVICE_STATES[device] = _DeviceState(device)
        return _DEVICE_STATES[device]


class _CudaGraph:
    """A chunk program as a CUDA graph. :meth:`capture` runs ``fn`` once
    eagerly on the device's capture stream, on the chunk the static buffers
    hold, so its output is that chunk's (the warm-up also loads the kernel
    libraries, fills the ops' device caches and lets cuDNN and cuBLAS set up,
    none of which a capture may do), then records it in
    ``capture_error_mode="thread_local"``, so that the other threads'
    allocations and syncs do not void the capture; a capture that fails
    raises. The recording runs nothing, so the static output keeps the
    warm-up's result. :meth:`replay` enqueues the graph on the current
    stream."""

    def __init__(self, state: _DeviceState):
        self._state = state
        self.graph = torch.cuda.CUDAGraph()

    @staticmethod
    def supports(device: torch.device) -> bool:
        return device.type == "cuda"

    def capture(self, fn: Callable[[], None]) -> None:
        side = self._state.capture_stream
        cur = torch.cuda.current_stream(side.device)
        side.wait_stream(cur)  # the static inputs were written on cur
        with torch.cuda.stream(side):
            fn()
            self.graph.capture_begin(pool=self._state.pool, capture_error_mode="thread_local")
            try:
                fn()
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    self.graph.capture_end()
                raise
            self.graph.capture_end()
        cur.wait_stream(side)  # the warm-up's output precedes cur's next use

    def replay(self) -> None:
        self.graph.replay()


# the counter of each way _run_chunk runs a chunk (tracing on)
CHUNK_COUNTERS = {"eager": "chunks.eager", "capture": "chunks.captured", "replay": "chunks.replayed"}

# keys an engine keeps per device (captured programs, and keys met once),
# least recently used evicted first: four image shapes' four buckets
# (interior, right, bottom, corner). A mixed 6 x 276^2 key's static buffers
# are 24.4 MB; its scratch is in the device's shared pool, which a freed
# graph's blocks return to.
MAX_PROGRAMS = 16


@dataclasses.dataclass
class _ChunkProgram:
    """One entry of the table: the static tiles ``[B, ph, pw, 3]`` (storage
    dtype), alpha ``[B, hn, wn, 1]`` f32 (RGBA) and u8 output the graph
    reads and writes, and the graph."""

    tiles: torch.Tensor
    alpha: Optional[torch.Tensor]
    out: torch.Tensor
    graph: object = None


def _riding(buf: torch.Tensor, name: str):
    """The attribute ``name`` of the output tensor ``buf`` or, for a view of
    one image of a stack, of its ``_base``; None where neither has it."""
    v = getattr(buf, name, None)
    if v is None and buf._base is not None:
        v = getattr(buf._base, name, None)
    return v


def done_event(buf: torch.Tensor):
    """The CUDA event recorded after the last scatter (and the merge) of the
    image ``buf`` belongs to, or None (a CPU buffer, or one this engine did
    not make). It rides on the output tensor, which a view of one image of
    a stack reaches as its ``_base``."""
    return _riding(buf, "_realsr_done")


def _upload(array: np.ndarray, device: torch.device, rows: Optional[np.ndarray] = None) -> torch.Tensor:
    """``array``, or its ``rows`` along the first axis, as a tensor on
    ``device``: the counterpart of the JAX engine's ``jax.device_put``. On a
    card it waits for nothing already queued: the bytes go into pinned
    memory from the caching host allocator (the rows gathered straight into
    it), are copied ``non_blocking`` on the device's upload stream into a
    tensor allocated on that stream, and the current (compute) stream waits
    for the copy by an event. ``record_stream`` keeps the allocator from
    handing the tensor's block out again before the compute stream's work
    on it is done; a block of the compute stream could still be read by its
    queued kernels. The host allocator records an event for the copy, so
    the pinned block is not reused before the copy has read it. A failed pin
    or copy raises. Elsewhere it is ``torch.tensor(array[rows], device=...)``."""
    if device.type != "cuda":
        return torch.tensor(array if rows is None else array[rows], device=device)
    shape = array.shape if rows is None else (len(rows), *array.shape[1:])
    host = torch.empty(shape, dtype=torch.from_numpy(np.empty(0, array.dtype)).dtype, pin_memory=True)
    if rows is None:
        np.copyto(host.numpy(), array)
    else:
        np.take(array, rows, axis=0, out=host.numpy())
    stream = _device_state(device).upload_stream
    with torch.cuda.stream(stream):
        buf = torch.empty(shape, dtype=host.dtype, device=device)
        buf.copy_(host, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(stream)
    cur = torch.cuda.current_stream(device)
    cur.wait_event(copied)
    buf.record_stream(cur)
    return buf


def _download(buf: torch.Tensor, done, host: Optional[torch.Tensor] = None) -> tuple:
    """Start ``buf``'s download on its device's copy stream, after ``done``
    and nothing else, into ``host`` (pinned) or a new pinned tensor: (host
    tensor, event recorded after the copy). ``record_stream`` keeps the
    allocator from handing ``buf``'s memory out again before the copy has
    read it."""
    stream = _device_state(buf.device).copy_stream
    if host is None:
        host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
    with torch.cuda.stream(stream):
        stream.wait_event(done)
        host.copy_(buf, non_blocking=True)
        buf.record_stream(stream)
        copied = torch.cuda.Event()
        copied.record(stream)
    return host, copied


def _fence(devices) -> None:
    """Wait for the work this thread enqueued so far on each CUDA device of
    ``devices``: an event recorded on the device's current stream, waited
    on, so other threads' work and copies in flight are not waited for (the
    JAX engine fences a chunk by fetching one element of its output)."""
    events = []
    for d in devices:
        if d.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(d))
            events.append(ev)
    for ev in events:
        ev.synchronize()


class RealSR:
    """Engine bound to one device; mirrors the reference's ctor/load/process
    (src/realsr.h:20-27). ``gpuid=-1`` runs on the CPU; ``gpuid >= 0``
    needs that CUDA device and raises without it. ``num_threads`` is
    accepted for the reference's signature; torch owns its threads (the
    CLI's ``-g -1 -j`` sets their count, ``utils/cputhreads.py``).

    ``mesh`` (``parallel.mesh.make_mesh``) replaces ``gpuid``: the engine
    then lives on the mesh's first device, holds the parameters on each of
    its devices, and deals every image's whole chunks round-robin to them.
    Every chunk keeps the shape the single engine gives it, so the output
    is bit-equal to the single engine's (a chunk split over devices would
    run the convs at another batch, where cuDNN may pick another algorithm).

    Each chunk's forward runs under :func:`~realsr_tpu_torch.models.rrdbnet.
    tf32`: TF32 off for float32 operands (the JAX package's
    ``Precision.HIGHEST``), on for bfloat16 and float16 ones, restored after.
    The flags are process-global while a chunk runs, so the scope is shared
    between threads: the CLI's proc threads on one engine (same setting) run
    their chunks concurrently, and a chunk of an engine of the other operand
    type waits until none of them holds the scope.

    With :attr:`graphs` each chunk of a key ``(device, ph, pw, batch, tta,
    alpha)`` met before runs as a replay of that key's graph, captured
    (:class:`_CudaGraph`) on the key's second chunk, whose output the
    capture's warm-up computes, or by :meth:`precompile`; a key's first
    chunk runs eagerly, so a size met once pays no capture. The capture
    holds the TF32 setting of the chunk's scope, so a replay needs no
    scope. An engine keeps :data:`MAX_PROGRAMS` keys per device, the least
    recently used evicted first.
    """

    def __init__(
        self,
        gpuid: int = 0,
        tta_mode: bool = False,
        num_threads: int = 1,
        config: Optional[EngineConfig] = None,
        mesh=None,
    ):
        self.tta_mode = tta_mode
        self.mesh = mesh
        if mesh is not None:
            kinds = {d.type for d in mesh.devices}
            if len(kinds) != 1 or not kinds <= {"cuda", "cpu"}:
                raise ValueError(f"a mesh needs devices of one kind, cuda or cpu: {mesh.devices}")
            first = mesh.devices[0]
            self.device = Device("gpu" if first.type == "cuda" else "cpu", first)
        elif gpuid == -1:
            self.device = Device("cpu", torch.device("cpu"))
        else:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"gpu {gpuid} requested but no CUDA device is available "
                    "(gpuid=-1 runs on the CPU)"
                )
            if not 0 <= gpuid < torch.cuda.device_count():
                raise ValueError(
                    f"device {gpuid} out of range "
                    f"({torch.cuda.device_count()} available)"
                )
            self.device = Device("gpu", torch.device("cuda", gpuid))
        self.config = config or EngineConfig()
        self.bundle: Optional[ModelBundle] = None
        self._model_paths: Optional[tuple] = None  # process_cpu's sibling loads them
        self._cpu_sibling: Optional["RealSR"] = None
        self._sibling_lock = threading.Lock()
        self.scale = 4
        self.prepadding = self.config.prepadding
        # 0 = auto: on a card the tile size is picked per image
        # (_pick_tilesize); on the CPU the reference's fixed 200 applies
        # (src/main.cpp:752)
        if self.config.tilesize:
            self.tilesize = self.config.tilesize
        elif self.device.platform == "cpu":
            self.tilesize = CPU_TILESIZE
        else:
            self.tilesize = 0
        self.last_tilesize = self.tilesize
        # the chunk program table: {device: OrderedDict((device, ph, pw,
        # batch, tta, alpha) -> _ChunkProgram)}, least recently used first
        self._programs: dict = {}
        # the kernel groups are loaded (_ensure_kernels), once per model
        self._kernels_ready = False
        self._kernels_lock = threading.Lock()

    def load(self, parampath: str, modelpath: str) -> int:
        """Parse and load the model files onto the device. Returns 0 like
        the reference (src/realsr.cpp:142). An explicit kernel tail that
        the graph or the operand type has no kernel for raises, as does a
        trunk form the variant or precision cannot run (``ValueError``). A
        graph the RRDBNet matcher rejects runs on the generic executor;
        ``variant``, ``tail``, ``trunk`` and ``sched`` are None then."""
        dtype, op_dtype, variant, trunk, sched, tail = _resolve_forms(self.config, self.device)
        self.storage_dtype, self.op_dtype = dtype, op_dtype
        self.bundle = load_model(
            parampath, modelpath, storage_dtype=dtype, op_dtype=op_dtype,
            variant=variant, tail=tail, trunk=trunk, sched=sched,
        )
        self._model_paths = (parampath, modelpath)
        if self.bundle.spec is None:
            variant = trunk = sched = None
        self.variant, self.tail, self.trunk, self.sched = variant, self.bundle.tail, trunk, sched
        self.scale = self.bundle.scale
        self._kernels_ready = False  # this model's groups build before its first launch
        self._programs = {}  # graphs of the previous model read its parameters
        # the planner's rate table, read once here, not once per image
        self._rate_anchors = _anchors()
        if variant == "cuda":
            # the planner's anchors were measured on one kind of card: say
            # once when this one is another
            note = anchor_provenance_notice(self._device_kind())
            if note and note not in _PRINTED_NOTICES:
                _PRINTED_NOTICES.add(note)
                print(note, file=sys.stderr)
        # the parameters on every device the chunks run on
        self._params_on = {}
        for d in self._devices():
            if d not in self._params_on:
                self._params_on[d] = _to_device(self.bundle.params, d)
        self._params = self._params_on[self.device.torch_device]
        return 0

    @property
    def graphs(self) -> bool:
        """Whether chunks run through the chunk program table: asked for by
        ``config.cuda_graphs``, on a device :class:`_CudaGraph` supports (a
        card), with the RRDBNet fast path loaded. The CPU and the generic
        executor always run eagerly: the executor's layers upload constants
        on each call, which a capture cannot hold."""
        return bool(
            self.config.cuda_graphs and self.bundle is not None and self.bundle.spec is not None
            and _CudaGraph.supports(self.device.torch_device)
        )

    def _device_kind(self) -> str:
        dev = self.device.torch_device
        return torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type

    def _devices(self) -> list:
        """The devices chunks are dealt to, in turn: the mesh's (a device
        may repeat), else the engine's one."""
        return list(self.mesh.devices) if self.mesh is not None else [self.device.torch_device]

    # -- inference -----------------------------------------------------

    def _auto_batch(self, tilesize: int) -> int:
        """The auto chunk granule at ``tilesize`` for this engine's model
        (nf 64 where the generic executor runs the graph, as in the JAX
        engine), storage and band budget."""
        nf = self.bundle.spec.nf if self.bundle.spec is not None else 64
        return _auto_batch(tilesize, self.tta_mode, self._band_budget_bytes(), nf, self.storage_dtype.itemsize)

    def _chunking(self, tilesize: int, n: int) -> tuple:
        """(chunk batch, chunk count) for ``n`` tiles at ``tilesize``: the
        tile count rounded up to a power of two, capped at
        ``config.max_batch`` or, at 0, at the auto granule; the tile list is
        padded to whole chunks. A mesh deals whole chunks to its devices, so
        the batch is the single engine's (no rounding to a device
        multiple)."""
        max_batch = self.config.max_batch or self._auto_batch(tilesize)
        bsz = min(max_batch, 1 << (n - 1).bit_length())
        return bsz, -(-n // bsz)

    def _pick_tilesize(self, w: int, h: int, n_img: int = 1) -> int:
        """The tile size for a ``w`` x ``h`` image (a stack of ``n_img``):
        the configured one, the CPU's 200, or on a card the candidate of
        least modelled work (planner.pick_tilesize) at each candidate's own
        chunk granule. The kernel variant takes 128 / 192 / 256, plain convs
        128 / 192, as the JAX engine's Pallas and conv paths. ``ndev`` is 1
        even under a mesh: whole chunks are dealt to its devices, so no
        chunk batch is rounded to a device multiple."""
        if self.tilesize:
            return self.tilesize

        def granule(t: int) -> int:
            return self.config.max_batch or self._auto_batch(t)

        cands = (128, 192, 256) if self.variant == "cuda" else (128, 192)
        return pick_tilesize(
            w, h, self.prepadding, granule=granule, candidates=cands, n_img=n_img, ndev=1,
            anchors=self._rate_anchors,
        )

    def _prep(self, img_u8: torch.Tensor):
        """u8 [N, H, W, C] -> (reflect-padded normalized storage
        [N, H+2p, W+2p, 3], raw-valued f32 alpha [N, H, W, 1|0])."""
        color = img_u8[..., :3].float() * (1.0 / 255.0)
        padded = reflect101_pad2d(color.to(self.storage_dtype), self.prepadding)
        return padded, img_u8[..., 3:].float()

    def _prep_band(self, band_u8: torch.Tensor):
        """u8 band [1, rows + 2p, W, C] that arrives with its 2p context
        rows -> (storage padded in W only [1, rows + 2p, W + 2p, 3], f32
        alpha of the band's own rows [1, rows, W, 1|0]): each tile's padded
        window is then byte-identical to the whole-image run's."""
        pad = self.prepadding
        color = band_u8[..., :3].float() * (1.0 / 255.0)
        padded = reflect101_pad_w(color.to(self.storage_dtype), pad)
        return padded, band_u8[:, pad : band_u8.shape[1] - pad, :, 3:].float()

    def _forward(self, tiles):
        """The net on [B, ph, pw, 3] tiles -> f32 [B, ph*s, pw*s, 3]; with TTA
        the mean of the 8 dihedral variants, run as one batch when the tiles
        are square and as two batches of 4 when not."""
        params = self._params_on[tiles.device]
        with tf32(self.op_dtype != torch.float32):
            if not self.tta_mode:
                return self.bundle.forward(params, tiles)
            groups = [range(8)] if tiles.shape[1] == tiles.shape[2] else [range(4), range(4, 8)]
            outs = []
            for ks in groups:
                batch = torch.cat([d4_transform(tiles, k) for k in ks])
                outs += self.bundle.forward(params, batch).chunk(len(ks))
        acc = d4_inverse(outs[0], 0).float()
        for k in range(1, NUM_TRANSFORMS):
            acc = acc + d4_inverse(outs[k], k).float()
        return acc * (1.0 / NUM_TRANSFORMS)

    def _compute_chunk(self, tiles, atiles, hn, wn):
        """[B, ph, pw, 3] storage tiles -> u8 [B, hn*s, wn*s, C]: forward
        (with TTA when on), halo crop, reference rounding, alpha bicubic."""
        s, pad = self.scale, self.prepadding
        out = self._forward(tiles)
        color = _round_u8(out[:, pad * s : (pad + hn) * s, pad * s : (pad + wn) * s])
        if atiles is None:
            return color
        up = atiles if s == 1 else resize_bicubic(atiles, hn * s, wn * s)
        a_u8 = torch.floor(up + 0.5).clamp(0.0, 255.0).to(torch.uint8)
        return torch.cat([color, a_u8], dim=-1)

    def _shards(self, padded, alpha, shape: tuple) -> list:
        """[(padded, alpha, out)] for each device of :meth:`_devices`: the
        prepared input on that device (the same tensor where the device is
        the input's) and a private zeroed u8 output of ``shape``."""
        return [
            (padded.to(d), alpha.to(d), torch.zeros(shape, dtype=torch.uint8, device=d))
            for d in self._devices()
        ]

    @staticmethod
    def _merge(shards: list) -> torch.Tensor:
        """The shards' outputs as one, on the first shard's device: their
        max, which is exact because each tile is written by one shard and
        unwritten pixels are 0 (as the JAX engine's merge over its device
        axis)."""
        out = shards[0][2]
        for _, _, part in shards[1:]:
            out = torch.maximum(out, part.to(out.device))
        return out

    def _merged(self, shards: list) -> torch.Tensor:
        """:meth:`_merge`; with tracing on and more than one shard, in a
        ``mesh.merge`` span with its device time (``merge.device``) on the
        first shard's card, which waits there for the others' copies."""
        if not tracer.enabled or len(shards) == 1:
            return self._merge(shards)
        dev = shards[0][2].device
        with tracer.span("mesh.merge", card=str(dev)), tracer.device_timed("merge.device", dev):
            return self._merge(shards)

    def _chunk_list(self, buckets: dict, tilesize: int, batches: Optional[dict] = None) -> list:
        """The chunks of ``buckets`` ({(ph, pw): [(image, x0, y0)]}) in
        dispatch order: [(ph, pw, the chunk's triples, its tiles that are
        not pad duplicates)]. ``batches`` gives a bucket's chunk batch
        ({(ph, pw): batch}); a bucket it lacks takes :meth:`_chunking`'s.
        Duplicated pad tiles rewrite identical bytes."""
        chunks = []
        for (ph, pw), triples in buckets.items():
            n = len(triples)
            bsz = (batches or {}).get((ph, pw)) or self._chunking(tilesize, n)[0]
            nc = -(-n // bsz)
            triples = triples + [triples[-1]] * (nc * bsz - n)
            chunks += [(ph, pw, triples[k * bsz : (k + 1) * bsz], min(bsz, n - k * bsz)) for k in range(nc)]
        return chunks

    def _dispatch_buckets(
        self, shards: list, buckets: dict, tilesize: int, c: int,
        progress_cb, done: int, total: int, batches: Optional[dict] = None,
    ) -> int:
        """Run every chunk of ``buckets`` (origins in the padded input's
        coordinates: band-local under band streaming; :meth:`_chunk_list`)
        and scatter the u8 tiles into the outputs. ``shards``
        (:meth:`_shards`) takes the chunks in turn, whole: chunk j runs on
        shard ``j % len(shards)``, reads its input and writes its output.
        Returns the tiles done."""
        self._ensure_kernels()
        chunks = self._chunk_list(buckets, tilesize, batches)
        for j, (ph, pw, chunk, real) in enumerate(chunks):
            padded, alpha, out = shards[j % len(shards)]
            if tracer.enabled:
                self._traced_chunk(padded, alpha, out, ph, pw, chunk, real, c)
            else:
                self._run_chunk(padded, alpha, out, ph, pw, chunk, c)
            done += real
            if progress_cb is not None and ((j + 1) % len(shards) == 0 or j + 1 == len(chunks)):
                # fence the round's chunks (one on each shard's device, so
                # the devices run concurrently) so the % reports completed
                # work, like the reference's per-tile counter (realsr.cpp:481)
                _fence({sh[2].device for sh in shards[: j % len(shards) + 1]})
                progress_cb(done / total)
        return done

    def _traced_chunk(self, padded, alpha, out, ph: int, pw: int, chunk: list, real: int, c: int) -> None:
        """:meth:`_run_chunk` with tracing on: in a ``dispatch`` span (its
        card, key, real tiles and mode), its tiles counted (``tiles.real``,
        ``tiles.run``) and its mode (``chunks.<mode>``), and its device time
        (``chunk.device``) taken on its card's stream from before the gather
        to after the scatter."""
        dev = padded.device
        tracer.count("tiles.real", real)
        tracer.count("tiles.run", len(chunk))
        with tracer.span("dispatch", card=str(dev), key=f"{ph}x{pw}x{len(chunk)}", real=real) as sp:
            with tracer.device_timed("chunk.device", dev):
                mode = self._run_chunk(padded, alpha, out, ph, pw, chunk, c)
            sp.attrs["mode"] = mode
        tracer.count(CHUNK_COUNTERS[mode])

    def _gather(self, padded, alpha, chunk, ph: int, pw: int, c: int, into: Optional[_ChunkProgram] = None):
        """The chunk's padded tiles [B, ph, pw, 3] and, for RGBA, its alpha
        tiles [B, hn, wn, 1]; written into ``into``'s static buffers when
        given."""
        pad = self.prepadding
        hn, wn = ph - 2 * pad, pw - 2 * pad
        kw = {} if into is None else {"out": into.tiles}
        tiles = torch.stack([padded[i, y : y + ph, x : x + pw] for i, x, y in chunk], **kw)
        atiles = None
        if c == 4:
            kw = {} if into is None else {"out": into.alpha}
            atiles = torch.stack([alpha[i, y : y + hn, x : x + wn] for i, x, y in chunk], **kw)
        return tiles, atiles

    def _scatter(self, out, chunk, tiles_u8, hn: int, wn: int) -> None:
        s = self.scale
        for (i, x, y), t in zip(chunk, tiles_u8):
            out[i, y * s : (y + hn) * s, x * s : (x + wn) * s] = t

    def _run_chunk(self, padded, alpha, out, ph: int, pw: int, chunk: list, c: int) -> str:
        """One chunk: gather its tiles from ``padded`` / ``alpha``, run them,
        scatter the u8 tiles into ``out``; returns how it ran ("eager",
        "capture" or "replay"). With ``graphs`` the first chunk of its key
        runs eagerly (a size met once pays no capture), the second by the
        capture of the key's program, whose warm-up computes it, and every
        later one as a replay of that program. Captures and replays run
        under the device's lock, so no two threads share a program's static
        buffers and no two replays on a device overlap; eager chunks run
        beside them, as with graphs off."""
        pad = self.prepadding
        hn, wn = ph - 2 * pad, pw - 2 * pad
        if self.graphs:
            mode = self._run_program(padded, alpha, out, ph, pw, chunk, c)
            if mode is not None:
                return mode
        tiles, atiles = self._gather(padded, alpha, chunk, ph, pw, c)
        self._scatter(out, chunk, self._compute_chunk(tiles, atiles, hn, wn), hn, wn)
        return "eager"

    def _run_program(self, padded, alpha, out, ph: int, pw: int, chunk: list, c: int) -> Optional[str]:
        """Run the chunk through the table's program of its key: a replay,
        or the capture on the key's second chunk ("replay", "capture").
        Returns None, having remembered the key, for its first chunk, which
        the caller runs eagerly."""
        pad = self.prepadding
        hn, wn = ph - 2 * pad, pw - 2 * pad
        dev = padded.device
        key = (dev, ph, pw, len(chunk), self.tta_mode, c == 4)
        state = _device_state(dev)
        with state.lock:
            table = self._programs.setdefault(dev, collections.OrderedDict())
            if key not in table:
                self._remember(table, key, None, state)
                return None
            cur = torch.cuda.current_stream(dev) if state.last is not None else None
            if cur is not None:
                cur.wait_event(state.last)
            prog = table[key]
            if prog is None:
                mode = "capture"
                prog = self._program(key, state, lambda into: self._gather(padded, alpha, chunk, ph, pw, c, into))
            else:
                mode = "replay"
                table.move_to_end(key)
                self._gather(padded, alpha, chunk, ph, pw, c, into=prog)
                prog.graph.replay()
            self._scatter(out, chunk, prog.out, hn, wn)
            if cur is not None:
                state.last.record(cur)
        return mode

    def _program(self, key: tuple, state: _DeviceState, fill=None) -> _ChunkProgram:
        """Capture the program of ``key`` into the table (call with
        ``state.lock`` held): static buffers allocated outside the capture,
        ``fill(program)`` writing a chunk into them (zeros without it), the
        chunk's work recorded between them; the static output then holds
        that chunk's result."""
        dev, ph, pw, bsz, _, with_alpha = key
        s, pad = self.scale, self.prepadding
        hn, wn = ph - 2 * pad, pw - 2 * pad
        prog = _ChunkProgram(
            tiles=torch.zeros((bsz, ph, pw, 3), dtype=self.storage_dtype, device=dev),
            alpha=torch.zeros((bsz, hn, wn, 1), device=dev) if with_alpha else None,
            out=torch.zeros((bsz, hn * s, wn * s, 4 if with_alpha else 3), dtype=torch.uint8, device=dev),
        )
        if fill is not None:
            fill(prog)
        prog.graph = _CudaGraph(state)
        with tracer.span("chunk.capture", card=str(dev), key=f"{ph}x{pw}x{bsz}"):
            prog.graph.capture(lambda: prog.out.copy_(self._compute_chunk(prog.tiles, prog.alpha, hn, wn)))
        self._remember(self._programs.setdefault(dev, collections.OrderedDict()), key, prog, state)
        return prog

    @staticmethod
    def _remember(table, key: tuple, prog: Optional[_ChunkProgram], state: _DeviceState) -> None:
        """Enter ``key`` into its device's ``table`` as the most recently
        used: its program, or None for a key met once. Past
        :data:`MAX_PROGRAMS` entries the least recently used goes, once the
        device's replays so far are done (a graph's scratch returns to the
        shared pool)."""
        table[key] = prog
        table.move_to_end(key)
        if len(table) > MAX_PROGRAMS:
            if state.last is not None:
                state.last.synchronize()
            table.popitem(last=False)

    def programs(self) -> dict:
        """The chunk program table's captured programs: {(device, ph, pw,
        batch, tta, alpha): program}, least recently used first on each
        device."""
        return {k: p for table in self._programs.values() for k, p in table.items() if p is not None}

    @torch.no_grad()
    def _process_stack_device(
        self,
        images: np.ndarray,  # [N, H, W, C] uint8
        progress_cb: Optional[Callable[[float], None]] = None,
    ) -> torch.Tensor:
        """uint8 NHWC -> DEVICE uint8 buffer [N, H*scale, W*scale, C] (on the
        mesh's first device under a mesh). Tiles of all images share the
        bucket chunks; the tile size is picked for the stack."""
        if self.bundle is None:
            raise RuntimeError("call load() first")
        n_img, h, w, c = images.shape
        s, pad = self.scale, self.prepadding
        tilesize = self._pick_tilesize(w, h, n_img)
        self.last_tilesize = tilesize
        plan = plan_tiles(w, h, tilesize, pad)
        maybe_start_profiler(self.device.torch_device)
        with tracer.request() as req:
            with tracer.span("h2d+prep"):
                img = _upload(images, self.device.torch_device)
                padded, alpha = self._prep(img)
            shards = self._shards(padded, alpha, (n_img, h * s, w * s, c))
            buckets = {
                shape: [(i, plan.tiles[t].x0, plan.tiles[t].y0) for i in range(n_img) for t in idxs]
                for shape, idxs in plan.buckets.items()
            }
            self._dispatch_buckets(shards, buckets, tilesize, c, progress_cb, 0, len(plan.tiles) * n_img)
            out = self._merged(shards)
            if out.device.type == "cuda":
                # "done": the image's last scatter and merge are enqueued; its
                # download waits for this and nothing else (fetch)
                out._realsr_done = torch.cuda.Event()
                out._realsr_done.record(torch.cuda.current_stream(out.device))
        if req is not None:
            # the request and its device timings ride on the output as its
            # "done" event does, so a fetch on another thread records under it
            out._realsr_request = req
        return out

    def process_device(
        self,
        image: np.ndarray,
        progress_cb: Optional[Callable[[float], None]] = None,
    ) -> torch.Tensor:
        """uint8 HWC (C = 3 | 4) -> DEVICE uint8 buffer [H*s, W*s, C]."""
        _check_image(image)
        return self._process_stack_device(image[None], progress_cb)[0]

    def fetch(self, out_buf) -> np.ndarray:
        """Device output buffer -> host numpy (the one download per image);
        a host array, such as a banded run's result, passes through. A card
        buffer of :meth:`process_device` (or one image of a stack) comes
        down on its device's copy stream into pinned memory once its image's
        "done" event has fired, waiting for that copy alone: the kernels
        enqueued after the image, such as the next image's, run on. A card
        tensor without the event comes down on the current stream."""
        if isinstance(out_buf, np.ndarray):
            return out_buf
        req = _riding(out_buf, "_realsr_request") if tracer.enabled else None
        with tracer.span("fetch(D2H)", request=req):
            done = done_event(out_buf) if out_buf.device.type == "cuda" else None
            if done is None:
                return out_buf.cpu().numpy()
            host, copied = _download(out_buf, done)
            copied.synchronize()
            if req is not None:
                tracer.resolve(req.take())
            return host.numpy()

    def process(
        self,
        image: np.ndarray,
        progress_cb: Optional[Callable[[float], None]] = None,
    ) -> np.ndarray:
        """uint8 HWC -> uint8 host array (process_device + fetch); an image
        above the band budget streams through :meth:`process_banded`."""
        if self.needs_banding(image.shape):
            return self.process_banded(image, progress_cb)
        return self.fetch(self.process_device(image, progress_cb))

    # -- band streaming: O(band) device memory for large images ----------

    @staticmethod
    def _equalized_band_rows(ytiles: int, btr: int) -> int:
        """Band height in tile rows: as many bands as ``btr`` rows give,
        made equal, so every band but a ragged bottom has one shape set."""
        btr = min(btr, ytiles)
        nbands = -(-ytiles // btr)
        return -(-ytiles // nbands)

    def _auto_band_tile_rows(self, w: int, c: int, tilesize: int) -> int:
        """Tile rows per band: half the band budget over one tile row's
        device bytes."""
        per_row = self._footprint_bytes(tilesize, w, c) - self._footprint_bytes(0, w, c)
        return max(1, self._band_budget_bytes() // max(1, 2 * per_row))

    @torch.no_grad()
    def process_banded(
        self,
        image: np.ndarray,
        progress_cb: Optional[Callable[[float], None]] = None,
        band_tile_rows: int = 0,
    ) -> np.ndarray:
        """uint8 HWC -> uint8 host array, streamed through the device in
        bands of ``band_tile_rows`` whole tile rows (0: from the band
        budget), bit-identical to the whole-image run.

        Each band goes up with its 2 x prepadding context rows (real
        neighbour rows; the whole image's reflect-101 at its edges), so every
        tile's padded window is the whole-image run's, and each of its
        buckets runs at the chunk batch the whole image's plan gives that
        bucket, so every chunk has a shape the whole-image run launches too.
        The tile size is the one picked for the whole image. Under a mesh
        each band's chunks are dealt to the devices and the band's outputs
        merge. On a card each band's rows go up through :func:`_upload`, so
        the host gathers and enqueues band k + 1 while band k computes. The
        host output is pinned, and each band's u8 output
        comes down into its rows on the copy stream (:func:`_download`) while
        the next band computes; once band k is enqueued the host waits for
        band k - 1's copy, so at most two band outputs are on the device."""
        _check_image(image)
        if self.bundle is None:
            raise RuntimeError("call load() first")
        h, w, c = image.shape
        s, pad = self.scale, self.prepadding
        ts = self._pick_tilesize(w, h)
        self.last_tilesize = ts
        dev = self.device.torch_device
        plan = plan_tiles(w, h, ts, pad)
        btr = self._equalized_band_rows(plan.ytiles, band_tile_rows or self._auto_band_tile_rows(w, c, ts))
        batches = {shape: self._chunking(ts, len(idxs))[0] for shape, idxs in plan.buckets.items()}
        rows_idx = reflect101_indices(h, pad, pad)
        maybe_start_profiler(dev)
        out = torch.empty((h * s, w * s, c), dtype=torch.uint8, pin_memory=dev.type == "cuda")
        done = 0
        # the previous band's download: the event after its copy, and its
        # device timings (None with tracing off)
        pending = None

        def land(copied, timings) -> None:
            with tracer.span("fetch(D2H)"):
                copied.synchronize()
                if timings:
                    tracer.resolve(timings)

        with tracer.request() as req:
            for y0, y1, buckets in self._band_buckets(plan, ts, btr, h):
                with tracer.span("h2d+prep(band)"):
                    band = _upload(image, dev, rows_idx[y0 : y1 + 2 * pad])[None]
                    padded, alpha = self._prep_band(band)
                shards = self._shards(padded, alpha, (1, (y1 - y0) * s, w * s, c))
                done = self._dispatch_buckets(
                    shards, buckets, ts, c, progress_cb, done, len(plan.tiles), batches,
                )
                merged = self._merged(shards)[0]
                if merged.device.type != "cuda":
                    out[y0 * s : y1 * s].copy_(merged)
                    continue
                band_done = torch.cuda.Event()
                band_done.record(torch.cuda.current_stream(merged.device))
                copied = _download(merged, band_done, out[y0 * s : y1 * s])[1]
                if pending is not None:
                    land(*pending)
                pending = copied, req.take() if req is not None else None
            if pending is not None:
                land(*pending)
        return out.numpy()

    @staticmethod
    def _band_buckets(plan, ts: int, btr: int, h: int):
        """Each band of ``btr`` tile rows of ``plan``: (y0, y1, its buckets
        {(ph, pw): [(0, x0, y0 - band y0)]}), origins band-local."""
        pad = plan.prepadding
        by_row: dict = {}
        for t in plan.tiles:
            by_row.setdefault(t.yi, []).append(t)
        for r0 in range(0, plan.ytiles, btr):
            r1 = min(r0 + btr, plan.ytiles)
            y0, y1 = r0 * ts, min(r1 * ts, h)
            buckets: dict = {}
            for yi in range(r0, r1):
                for t in by_row[yi]:
                    buckets.setdefault(t.padded_shape(pad), []).append((0, t.x0, t.y0 - y0))
            yield y0, y1, buckets

    def process_batch(self, images) -> list:
        """Batch of SAME-SHAPE uint8 HWC images -> list of host outputs; the
        tiles of all images share the chunks."""
        images = np.stack(list(images))
        if images.dtype != np.uint8 or images.ndim != 4 or images.shape[3] not in (3, 4):
            raise ValueError("expected same-shape uint8 HWC images, C in {3,4}")
        cap = self.max_batch_images(images.shape[1:])
        if len(images) > cap:
            out: list = []
            for k in range(0, len(images), cap):
                sub = images[k : k + cap]
                if len(sub) == 1 or cap == 1:
                    out.extend(self.process(img) for img in sub)
                else:
                    out.extend(self.process_batch(sub))
            return out
        out = self.fetch(self._process_stack_device(images))
        return [out[i] for i in range(out.shape[0])]

    def process_cpu(
        self,
        image: np.ndarray,
        progress_cb: Optional[Callable[[float], None]] = None,
    ) -> np.ndarray:
        """The reference's second entry point (src/realsr.h:31-33): the
        image processed on the CPU, also by an engine bound to a card. There
        it is answered by a CPU sibling built on first use from the same
        model files and config, with the tile size re-picked for the CPU
        and the kernel variant and its trunk forms re-resolved there (plain
        convs), as the JAX engine's sibling does. The sibling's chunks enter
        the TF32 scope like any engine's, so the card engine's chunks never
        run under its setting."""
        if self.device.platform == "cpu":
            return self.process(image, progress_cb)
        if self._model_paths is None:
            raise RuntimeError("call load() first")
        with self._sibling_lock:
            if self._cpu_sibling is None:
                cfg = dataclasses.replace(
                    self.config, tilesize=0, trunk="auto", sched="scatter",
                    variant="auto" if self.config.variant == "cuda" else self.config.variant,
                )
                sib = RealSR(gpuid=-1, tta_mode=self.tta_mode, config=cfg)
                sib.load(*self._model_paths)
                self._cpu_sibling = sib
        return self._cpu_sibling.process(image, progress_cb)

    # -- the chunk program table ahead of a request ------------------------

    @property
    def fast_start(self) -> bool:
        """``config.fast_start``, unless ``REALSR_TPU_FAST_START`` is "0"."""
        return self.config.fast_start and fast_start_env()

    def kernel_groups(self) -> tuple:
        """The (source, group) libraries this engine builds before its
        first launch on a card: with :attr:`fast_start` the groups its
        forward launches (:func:`kernel_groups` of its resolved variant,
        trunk, sched, tail and precision), else every group of those
        groups' sources."""
        if self.bundle is None:
            raise RuntimeError("call load() first")
        nf = self.bundle.spec.nf if self.bundle.spec is not None else 0
        launched = kernel_groups(self.variant, self.trunk, self.sched, self.tail, self.op_dtype,
                                 self.storage_dtype, nf)
        return _build_set(launched, self.fast_start)

    def _ensure_kernels(self) -> None:
        """On a CUDA device, load :meth:`kernel_groups` once per model, building
        the missing ones at once (one nvcc each; a failed build raises, with
        nothing in its place), into the build cache or, with
        ``config.compilation_cache`` off, this process's own directory. A
        build prints one line on stderr: the groups and their nvcc
        seconds."""
        if self._kernels_ready:
            return
        with self._kernels_lock:
            if self._kernels_ready:
                return
            groups = self.kernel_groups() if _on_card(self.device.torch_device) else ()
            if groups:
                t0 = time.time_ns()
                seconds = build.load_groups(groups, cache=self.config.compilation_cache)
                wall = tracer.ended("kernel build", t0)
                built = {k: v for k, v in seconds.items() if v > 0}
                if built:
                    print(
                        f"realsr_tpu_torch: built {len(built)} kernel groups with nvcc in "
                        f"{wall:.2f} s ("
                        + ", ".join(f"{src}[{g}] {v:.2f} s" for (src, g), v in built.items())
                        + f") into {build.build_dir(self.config.compilation_cache)}",
                        file=sys.stderr, flush=True,
                    )
            self._kernels_ready = True

    def program_keys(self, w: int, h: int, channels: int = 3, n_img: int = 1) -> set:
        """The chunk program keys ``(device, ph, pw, batch, tta, alpha)``
        that ``process`` of a ``w`` x ``h`` x ``channels`` image (a stack of
        ``n_img``) runs: the band walk's where :meth:`needs_banding` says
        the image streams in bands (each band's buckets at the whole plan's
        batch, on the devices its chunks are dealt to), else the whole
        plan's."""
        c, pad = channels, self.prepadding
        ts = self._pick_tilesize(w, h, n_img)
        plan = plan_tiles(w, h, ts, pad)
        if n_img == 1 and self.needs_banding((h, w, c)):
            btr = self._equalized_band_rows(plan.ytiles, self._auto_band_tile_rows(w, c, ts))
            batches = {shape: self._chunking(ts, len(idxs))[0] for shape, idxs in plan.buckets.items()}
            runs = [b for _, _, b in self._band_buckets(plan, ts, btr, h)]
        else:
            batches = None
            runs = [{
                shape: [(i, plan.tiles[t].x0, plan.tiles[t].y0) for i in range(n_img) for t in idxs]
                for shape, idxs in plan.buckets.items()
            }]
        devices = self._devices()
        return {
            (devices[j % len(devices)], ph, pw, len(chunk), self.tta_mode, c == 4)
            for buckets in runs
            for j, (ph, pw, chunk, _) in enumerate(self._chunk_list(buckets, ts, batches))
        }

    def precompile(self, w: int, h: int, channels: int = 3, n_img: int = 1) -> int:
        """Make ready every chunk program a ``w`` x ``h`` x ``channels``
        image (a stack of ``n_img``) will run, so that the first request
        pays no build and no capture (the JAX engine's ``precompile``; the
        port's fast start serves on the same tile, so there is no
        ``fast_start_ramp``). On a card it loads, building them at once if
        needed (one nvcc each), the kernel groups of
        :meth:`kernel_groups`, then captures the graph of each key of
        :meth:`program_keys` that the table lacks, banded where
        :meth:`needs_banding` says so. Returns the number of chunk programs
        such an image runs; on the CPU, where nothing is captured, that
        count too."""
        if self.bundle is None:
            raise RuntimeError("call load() first")
        if channels not in (3, 4):
            raise ValueError("channels must be 3 or 4")
        keys = self.program_keys(w, h, channels, n_img)
        self._ensure_kernels()
        if self.graphs:
            with torch.no_grad():
                for key in sorted(keys, key=str):
                    state = _device_state(key[0])
                    with state.lock:
                        if self._programs.get(key[0], {}).get(key) is None:
                            self._program(key, state)
        return len(keys)

    # -- device budget ---------------------------------------------------

    def _band_budget_bytes(self) -> int:
        return int(os.environ.get("REALSR_TPU_BAND_BUDGET_MB", "2048")) * 1024 * 1024

    def _footprint_bytes(self, h: int, w: int, c: int) -> int:
        """Device bytes of a whole-image run: the padded storage input plus
        the uint8 output (chunks add O(tile^2) on top)."""
        p, s = self.prepadding, self.scale
        dsize = self.storage_dtype.itemsize if self.bundle is not None else 4
        return (h + 2 * p) * (w + 2 * p) * 3 * dsize + h * s * w * s * c

    def needs_banding(self, shape) -> bool:
        """True when a whole-image run would exceed the band budget."""
        h, w, c = shape
        return self._footprint_bytes(h, w, c) > self._band_budget_bytes()

    def max_batch_images(self, shape) -> int:
        """How many images of ``shape`` one device stack may hold."""
        h, w, c = shape
        return max(1, self._band_budget_bytes() // max(1, self._footprint_bytes(h, w, c)))


def _check_image(image: np.ndarray) -> None:
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] not in (3, 4):
        raise ValueError("expected uint8 HWC image with 3 or 4 channels")
