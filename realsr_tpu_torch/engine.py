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
in float32 before the crop. Not ported yet: band streaming of images above
the device budget (ROADMAP queue 1); it raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from realsr_tpu_torch.tiling.planner import auto_tilesize, plan_tiles
from realsr_tpu_torch.utils.trace import tracer
from realsr_tpu_torch.loader import ModelBundle, load_model
from realsr_tpu_torch.models import rrdbnet as R
from realsr_tpu_torch.models.rrdbnet import SCHEDS, TAIL_MODES, tf32
from realsr_tpu_torch.ops.pad import reflect101_pad2d
from realsr_tpu_torch.ops.resize import resize_bicubic
from realsr_tpu_torch.ops.tta import NUM_TRANSFORMS, d4_inverse, d4_transform


@dataclasses.dataclass
class EngineConfig:
    tilesize: int = 0  # 0 = auto from the device's free memory (planner)
    prepadding: int = 10  # DF2K halo (src/main.cpp:661-667)
    # "auto" (mixed on CUDA, float32 on the CPU) | "float32" | "mixed" |
    # "bfloat16" | "float16"
    storage: str = "auto"
    # RDB conv formulation: "auto" | "dense" | "scatter" | "cuda". "auto"
    # (_resolve_variant) is the fused CUDA kernel on a GPU and plain convs
    # on the CPU; float16, which the kernel has no instance for, takes plain
    # convs on a GPU too, as the JAX engine takes its conv path. An explicit
    # "cuda" with float16 raises.
    variant: str = "auto"
    # tail form (models.rrdbnet.TAIL_MODES): "auto" | "interleaved" |
    # "packed" | "kernel_hr" (K7) | "kernel" (K6). "auto" reads
    # REALSR_TPU_PACKED_TAIL like the JAX engine; unset, it is the fused
    # tail kernel on a GPU where the kernel has an instance (bf16 operands,
    # nf 64, 3 outputs) and "interleaved" elsewhere.
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


class RealSR:
    """Engine bound to one device; mirrors the reference's ctor/load/process
    (src/realsr.h:20-27). ``gpuid=-1`` runs on the CPU; ``gpuid >= 0``
    needs that CUDA device and raises without it. ``num_threads`` is
    accepted for the reference's signature; torch owns its threads.

    Each chunk's forward runs under :func:`~realsr_tpu_torch.models.rrdbnet.
    tf32`: TF32 off for float32 operands (the JAX package's
    ``Precision.HIGHEST``), on for bfloat16 and float16 ones, restored after.
    The flags are process-global while a chunk runs, so the scope is shared
    between threads: the CLI's proc threads on one engine (same setting) run
    their chunks concurrently, and a chunk of an engine of the other operand
    type waits until none of them holds the scope.
    """

    def __init__(
        self,
        gpuid: int = 0,
        tta_mode: bool = False,
        num_threads: int = 1,
        config: Optional[EngineConfig] = None,
    ):
        self.tta_mode = tta_mode
        if gpuid == -1:
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
        self.scale = 4
        self.prepadding = self.config.prepadding
        self.tilesize = self.config.tilesize or self._auto_tilesize()

    def _auto_tilesize(self) -> int:
        """The reference's heap-budget tiers (planner.auto_tilesize) on the
        device's free memory; 200 on the CPU."""
        if self.device.platform == "cpu":
            return auto_tilesize(0, is_cpu=True)
        free, _ = torch.cuda.mem_get_info(self.device.torch_device)
        return auto_tilesize(free // (1024 * 1024))

    def load(self, parampath: str, modelpath: str) -> int:
        """Parse and load the model files onto the device. Returns 0 like
        the reference (src/realsr.cpp:142). An explicit kernel tail that
        the graph or the operand type has no kernel for raises, as does a
        trunk form the variant or precision cannot run (``ValueError``)."""
        dtype, op_dtype = _resolve_precision(self.config.storage, self.device)
        variant = _resolve_variant(self.config.variant, self.device.platform, dtype)
        if variant == "cuda" and dtype == torch.float16:
            raise NotImplementedError(
                "the fused RDB kernel has no float16 instance (the JAX package runs "
                "float16 on its conv path too); pass variant='dense' to run float16 on plain convs"
            )
        trunk, sched = _resolve_trunk(self.config, variant, dtype, op_dtype)
        tail = self.config.tail
        if tail == "auto":
            tail = packed_tail_env() or ("auto" if self.device.platform == "gpu" else "interleaved")
        self.storage_dtype, self.op_dtype, self.variant = dtype, op_dtype, variant
        self.bundle = load_model(
            parampath, modelpath, storage_dtype=dtype, op_dtype=op_dtype,
            variant=variant, tail=tail, trunk=trunk, sched=sched,
        )
        self.tail, self.trunk, self.sched = self.bundle.tail, trunk, sched
        self.scale = self.bundle.scale
        self._params = _to_device(self.bundle.params, self.device.torch_device)
        return 0

    # -- inference -----------------------------------------------------

    def _chunking(self, n: int) -> tuple:
        """(chunk batch, chunk count) for ``n`` tiles: a power of two up to
        the batch granule; the tile list is padded to whole chunks."""
        max_batch = _auto_batch(
            self.tilesize, self.tta_mode, self._band_budget_bytes(), self.bundle.spec.nf,
            self.storage_dtype.itemsize,
        )
        bsz = min(max_batch, 1 << (n - 1).bit_length())
        return bsz, -(-n // bsz)

    def _prep(self, img_u8: torch.Tensor):
        """u8 [N, H, W, C] -> (reflect-padded normalized storage
        [N, H+2p, W+2p, 3], raw-valued f32 alpha [N, H, W, 1|0])."""
        color = img_u8[..., :3].float() * (1.0 / 255.0)
        padded = reflect101_pad2d(color.to(self.storage_dtype), self.prepadding)
        return padded, img_u8[..., 3:].float()

    def _forward(self, tiles):
        """The net on [B, ph, pw, 3] tiles -> f32 [B, ph*s, pw*s, 3]; with TTA
        the mean of the 8 dihedral variants, run as one batch when the tiles
        are square and as two batches of 4 when not."""
        with tf32(self.op_dtype != torch.float32):
            if not self.tta_mode:
                return self.bundle.forward(self._params, tiles)
            groups = [range(8)] if tiles.shape[1] == tiles.shape[2] else [range(4), range(4, 8)]
            outs = []
            for ks in groups:
                batch = torch.cat([d4_transform(tiles, k) for k in ks])
                outs += self.bundle.forward(self._params, batch).chunk(len(ks))
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

    @torch.no_grad()
    def _process_stack_device(
        self,
        images: np.ndarray,  # [N, H, W, C] uint8
        progress_cb: Optional[Callable[[float], None]] = None,
    ) -> torch.Tensor:
        """uint8 NHWC -> DEVICE uint8 buffer [N, H*scale, W*scale, C]. Tiles
        of all images share the bucket chunks."""
        if self.bundle is None:
            raise RuntimeError("call load() first")
        n_img, h, w, c = images.shape
        s, pad = self.scale, self.prepadding
        dev = self.device.torch_device
        plan = plan_tiles(w, h, self.tilesize, pad)
        with tracer.span("h2d+prep"):
            img = torch.tensor(images, device=dev)
            padded, alpha = self._prep(img)
        out = torch.zeros((n_img, h * s, w * s, c), dtype=torch.uint8, device=dev)
        done, total = 0, len(plan.tiles) * n_img
        for (ph, pw), idxs in plan.buckets.items():
            # tile origins (unpadded coords) = halo starts in padded coords
            triples = [
                (i, plan.tiles[t].x0, plan.tiles[t].y0)
                for i in range(n_img)
                for t in idxs
            ]
            hn, wn = ph - 2 * pad, pw - 2 * pad
            n = len(triples)
            bsz, nc = self._chunking(n)
            # duplicated pad tiles rewrite identical bytes
            triples += [triples[-1]] * (nc * bsz - n)
            for k in range(nc):
                chunk = triples[k * bsz : (k + 1) * bsz]
                with tracer.span("dispatch"):
                    tiles = torch.stack(
                        [padded[i, y : y + ph, x : x + pw] for i, x, y in chunk]
                    )
                    atiles = None
                    if c == 4:
                        atiles = torch.stack(
                            [alpha[i, y : y + hn, x : x + wn] for i, x, y in chunk]
                        )
                    tiles_u8 = self._compute_chunk(tiles, atiles, hn, wn)
                    for (i, x, y), t in zip(chunk, tiles_u8):
                        out[i, y * s : (y + hn) * s, x * s : (x + wn) * s] = t
                done += min(bsz, n - k * bsz)  # pad duplicates excluded
                if progress_cb is not None:
                    # fence the chunk so the % reports completed work, like
                    # the reference's per-tile counter (realsr.cpp:481)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    progress_cb(done / total)
        return out

    def process_device(
        self,
        image: np.ndarray,
        progress_cb: Optional[Callable[[float], None]] = None,
    ) -> torch.Tensor:
        """uint8 HWC (C = 3 | 4) -> DEVICE uint8 buffer [H*s, W*s, C]."""
        if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] not in (3, 4):
            raise ValueError("expected uint8 HWC image with 3 or 4 channels")
        return self._process_stack_device(image[None], progress_cb)[0]

    def fetch(self, out_buf) -> np.ndarray:
        """Device output buffer -> host numpy (the one download per image)."""
        with tracer.span("fetch(D2H)"):
            return out_buf.cpu().numpy()

    def process(
        self,
        image: np.ndarray,
        progress_cb: Optional[Callable[[float], None]] = None,
    ) -> np.ndarray:
        """uint8 HWC -> uint8 host array (process_device + fetch)."""
        if self.needs_banding(image.shape):
            return self.process_banded(image, progress_cb)
        return self.fetch(self.process_device(image, progress_cb))

    def process_banded(self, image, progress_cb=None):
        raise NotImplementedError(
            "band streaming of images above the device budget is not ported "
            "to the PyTorch engine yet (ROADMAP queue 1: process_banded); "
            "raise REALSR_TPU_BAND_BUDGET_MB to run this image whole"
        )

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
