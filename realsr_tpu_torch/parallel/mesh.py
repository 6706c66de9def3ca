"""Device meshes for the engine's multi-GPU mode.

Counterpart of ``realsr_tpu/parallel/mesh.py``. The reference scales across
GPUs by running one independent engine per device and pulling whole images
from a shared queue (src/main.cpp:778-791); the pipeline keeps that mode
(one ``RealSR`` per id in ``-g``). A mesh is the other mode: ONE engine
whose image's tile chunks are dealt round-robin to the mesh's devices, with
no traffic between them until the per-device outputs merge once per image
(``engine.RealSR(mesh=...)``).

A :class:`Mesh` here is only its devices: torch needs no sharding
annotations, since the engine places each chunk itself. ``make_mesh``
accepts a list that repeats a device (several shards on one card, or on the
CPU); ``mesh_from_env`` rejects repeats, as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices an engine deals its chunks to, in turn."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def default_pool() -> list:
    """The device pool that ids index into: the CUDA devices, or the CPU on
    a host without one — one rule, shared by the engine, the CLIs and
    ``make_mesh``."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def pool_for(gpuid) -> list:
    """The pool a mesh is drawn from for the caller's device ids: the CPU
    when every id is -1 (the caller asked for the CPU), else the CUDA
    devices. An id >= 0 needs CUDA: without it this raises, as the engine
    does for one id, and no mesh quietly runs on the CPU."""
    if all(g == -1 for g in gpuid):
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"gpu {max(gpuid)} requested but no CUDA device is available "
            "(gpuid=-1 runs on the CPU)"
        )
    return default_pool()


def _canonical(d) -> torch.device:
    """``d`` as a torch.device with the index a tensor placed on it reports
    (``cuda`` alone means the current CUDA device)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """Mesh over the given devices (default: the whole pool). A device may
    repeat: each entry is one shard."""
    if devices is None:
        devices = default_pool()
    devices = tuple(_canonical(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devices)


def mesh_from_env(spec: str, pool: Optional[Sequence] = None) -> Mesh:
    """Build a mesh from a REALSR_TPU_MESH value: ``all`` or a comma list
    of indices into ``pool`` (default: :func:`default_pool`; the CLIs and
    the bridge pass :func:`pool_for` of their ids). Raises ValueError with
    a clean message on bad input (both CLIs surface it as the 'invalid
    REALSR_TPU_MESH' diagnostic)."""
    pool = list(default_pool() if pool is None else pool)
    if spec == "all":
        return make_mesh(pool)
    try:
        idxs = [int(s) for s in spec.split(",") if s.strip() != ""]
    except ValueError:
        raise ValueError(f"invalid REALSR_TPU_MESH {spec!r}") from None
    if (
        not idxs
        or any(i < 0 or i >= len(pool) for i in idxs)
        or len(set(idxs)) != len(idxs)  # each pool device once, as in JAX's Mesh
    ):
        raise ValueError(
            f"invalid REALSR_TPU_MESH {spec!r} (pool has {len(pool)} devices)"
        )
    return make_mesh([pool[i] for i in idxs])
