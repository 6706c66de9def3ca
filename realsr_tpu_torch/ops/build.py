"""Build the package's CUDA sources with ``nvcc`` and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``<build dir>/<name>-<hash>.so`` for ``sm_90a`` (Hopper) at first use;
the hash covers the source, every header in ``csrc/`` and the flags, so an
edited source or header rebuilds and an unchanged one loads in
milliseconds. A plain C interface keeps PyTorch's
headers out of the build (seconds, not minutes). The build directory is
``realsr_tpu_torch/_build`` unless ``REALSR_TPU_TORCH_BUILD`` names another.

Nothing here runs at import: the CPU-only test host has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, spills and shared memory per kernel, into BUILD_LOG
)

# every kernel source of csrc/, each built into its own library (one nvcc
# each, so a process can build them all at once): K1/K2 (bf16 and float32
# operands), K3-K5 (bf16; K3 and K5 float32), K6/K7 (bf16 and float32)
SOURCES = ("rdb_wgmma", "rdb_tf32", "rdb_modes_wgmma", "rdb_modes_tf32", "tail_kernel", "tail_tf32")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()  # guards _NAME_LOCKS
# one lock per library, so that two sources can build at once in two threads
_NAME_LOCKS: Dict[str, threading.Lock] = {}
# seconds the last nvcc run of each library took (0.0 when it was cached)
BUILD_SECONDS: Dict[str, float] = {}
# nvcc's output of that run (ptxas resource usage; "" when it was cached)
BUILD_LOG: Dict[str, str] = {}


def build_dir() -> str:
    return os.environ.get(
        "REALSR_TPU_TORCH_BUILD",
        os.path.join(os.path.dirname(CSRC), "_build"),
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels build on a machine with the CUDA toolkit"
    )


def source_digest(name: str) -> str:
    """The build hash of ``csrc/<name>.cu``: its bytes, those of every
    ``csrc/*.cuh`` it may include (by name), and the nvcc flags."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process.
    Thread-safe; calls for different names build concurrently."""
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        src = os.path.join(CSRC, f"{name}.cu")
        out_dir = build_dir()
        os.makedirs(out_dir, exist_ok=True)
        so = os.path.join(out_dir, f"{name}-{source_digest(name)}.so")
        BUILD_SECONDS[name], BUILD_LOG[name] = 0.0, ""
        if not os.path.isfile(so):
            # build under a private name, then rename: a concurrent process
            # never loads a half-written library
            tmp = f"{so}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {src} (exit {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, so)
            BUILD_SECONDS[name] = time.perf_counter() - t0
            BUILD_LOG[name] = proc.stdout + proc.stderr
        lib = ctypes.CDLL(so)
        _LIBS[name] = lib
        return lib
