"""Build the package's CUDA sources with ``nvcc`` and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers, so
a build takes seconds, not minutes) and builds for ``sm_90a`` (Hopper) in
groups of instances (:data:`GROUPS`, ``csrc/groups.cuh``): one nvcc per
group, at first use, into ``<build dir>/<name>-<group>-<hash>.so``. The
hash covers the source, every header in ``csrc/``, the flags and the
group's macros, so an edited source or header rebuilds and an unchanged one
loads in milliseconds.

The build dir is ``<root>/<fingerprint>/``: the root is
``realsr_tpu_torch/_build`` unless ``REALSR_TPU_TORCH_BUILD`` names another,
and :func:`fingerprint` hashes the host's machine, the card's compute
capability, the CUDA release PyTorch was built for and the nvcc flags (the
counterpart of the JAX engine's ``_host_features`` cache scope), so a
library built for another host is never loaded. ``manifest.json`` in the
dir records the nvcc release that built each library: where ``nvcc`` is
present and its release differs, the library is rebuilt. Where ``nvcc`` is
absent a library already in the dir loads (a seed from
``python -m realsr_tpu_torch.seed_cache``), and a missing one raises.

Nothing here runs at import: the CPU-only test host has no ``nvcc``.
"""

from __future__ import annotations

import atexit
import concurrent.futures
import contextlib
import ctypes
import fcntl
import hashlib
import json
import os
import platform
import re
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Iterable, Optional, Tuple

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, spills and shared memory per kernel, into BUILD_LOG
)

# every kernel source of csrc/: K1/K2 (bf16 and float32 operands), K3-K5
# (bf16; K3 and K5 float32), K6/K7 (bf16 and float32), K8/K9 (SwinIR's
# window attention and residual add + LayerNorm, bf16)
SOURCES = ("rdb_wgmma", "rdb_tf32", "rdb_modes_wgmma", "rdb_modes_tf32", "tail_kernel", "tail_tf32", "swin_kernel")

# a group's name is its parts joined by "_"; each part is one macro of
# csrc/groups.cuh: the state type and nf/gc of the RDB kernels (the float32
# operand sources have float32 state only), the tail's form; the Swin
# kernels are one group (its macro selects nothing)
GROUP_MACROS = {
    "f32": "GROUP_F32", "bf16": "GROUP_BF16", "nf64": "GROUP_NF64", "nf32": "GROUP_NF32",
    "k6": "GROUP_K6", "k7": "GROUP_K7", "swin": "GROUP_SWIN",
}
_RDB_GROUPS = ("f32_nf64", "f32_nf32", "bf16_nf64", "bf16_nf32")
_F32_GROUPS = ("f32_nf64", "f32_nf32")
_TAIL_GROUPS = ("k6", "k7")
# the build groups of each source: the tile pick moves the patch side from
# image to image, so a group holds every patch side of its instances and a
# new side never waits for nvcc
GROUPS = {
    "rdb_wgmma": _RDB_GROUPS, "rdb_tf32": _F32_GROUPS,
    "rdb_modes_wgmma": _RDB_GROUPS, "rdb_modes_tf32": _F32_GROUPS,
    "tail_kernel": _TAIL_GROUPS, "tail_tf32": _TAIL_GROUPS, "swin_kernel": ("swin",),
}
# each source's instances, as its dispatch functions launch them: the call
# with {T} the patch side ({TH}, {TW} the tail's patch shape) and {TS},
# {NF}, {GC}, {UP2} what the group names; the patch sides (None: the call
# as it stands); the states it exists for (the paired carry: a float32
# state as two bf16 planes)
_CALLS = {
    "rdb_wgmma": (("launch<{T}, {TS}, {NF}, {GC}>", (17, 12, 8), ("f32", "bf16")),),
    "rdb_tf32": (("launch<{T}, {NF}, {GC}>", (10, 9, 8), ("f32",)),),
    "rdb_modes_wgmma": (
        ("launch_chained<{T}, {TS}, {NF}, {GC}, Layout<{T}, {NF}, {GC}>>", (17, 12, 8), ("f32", "bf16")),
        ("launch_paired<{T}, {NF}, {GC}>", (17, 12, 8), ("f32",)),
        ("launch_packed<{T}, {TS}, {NF}, {GC}, Layout<{T}, {NF}, {GC}>>", (12, 8), ("f32", "bf16")),
    ),
    "rdb_modes_tf32": (
        ("launch_chained<{T}, float, {NF}, {GC}, LayoutF32<{T}, {NF}, {GC}>>", (10, 9, 8), ("f32",)),
        ("launch_packed<{T}, float, {NF}, {GC}, LayoutF32<{T}, {NF}, {GC}>>", (8, 7), ("f32",)),
    ),
    "tail_kernel": (("launch<{TH}, {TW}, {UP2}, __nv_bfloat16>", ((16, 16), (12, 28)), None),),
    "tail_tf32": (("launch<{TH}, {TW}, {UP2}, float>", ((10, 14), (8, 16)), None),),
    "swin_kernel": (("launch_window_attn<8, 30>", None, None), ("launch_swin_norm<240>", None, None)),
}
_WIDTHS = {"nf64": (64, 32), "nf32": (32, 16)}
_STATE_TYPES = {"f32": "float", "bf16": "__nv_bfloat16"}
MANIFEST = "manifest.json"

_LIBS: Dict[Tuple[str, str], ctypes.CDLL] = {}
_LOCK = threading.Lock()  # guards _KEY_LOCKS, _RELEASES and _PRIVATE
# one lock per library, so that two groups can build at once in two threads
_KEY_LOCKS: Dict[Tuple[str, str], threading.Lock] = {}
_RELEASES: Dict[str, str] = {}  # nvcc path -> its release
_PRIVATE: list = []  # the process's private build root, once made
# seconds the last nvcc run of each (source, group) took (0.0 when it was
# cached) and its output (ptxas resource usage; "" when it was cached)
BUILD_SECONDS: Dict[Tuple[str, str], float] = {}
BUILD_LOG: Dict[Tuple[str, str], str] = {}


def instances(name: str, group: str) -> tuple:
    """The instances the ``group`` library of ``csrc/<name>.cu`` holds, as
    its dispatch functions' calls (``launch<17, float, 64, 32>``)."""
    parts = group.split("_")
    out = []
    for call, tiles, states in _CALLS[name]:
        if tiles is None:
            out.append(call)
        elif states is not None:
            if parts[0] not in states:
                continue
            nf, gc = _WIDTHS[parts[1]]
            for t in tiles:
                out.append(call.format(T=t, TS=_STATE_TYPES[parts[0]], NF=nf, GC=gc))
        else:
            up2 = "true" if group == "k6" else "false"
            out += [call.format(TH=th, TW=tw, UP2=up2) for th, tw in tiles]
    return tuple(out)


def group_defines(group: str) -> tuple:
    """nvcc's ``-D`` flags for ``group``: one macro per part of its name."""
    return tuple(f"-D{GROUP_MACROS[part]}" for part in group.split("_"))


def build_root() -> str:
    return os.environ.get("REALSR_TPU_TORCH_BUILD", os.path.join(os.path.dirname(CSRC), "_build"))


def capability() -> str:
    """The current card's compute capability (``9.0`` on an H100), or
    ``none`` where PyTorch sees no CUDA device."""
    import torch

    if not torch.cuda.is_available():
        return "none"
    major, minor = torch.cuda.get_device_capability()
    return f"{major}.{minor}"


def host_features(cap: Optional[str] = None) -> str:
    """What a built library depends on beyond its source: the machine, the
    card's compute capability (``cap``, default :func:`capability`), the
    CUDA release PyTorch was built for and the nvcc flags. Needs no nvcc."""
    import torch

    return "|".join((platform.machine(), f"sm {cap or capability()}", f"cuda {torch.version.cuda}",
                     " ".join(NVCC_FLAGS)))


def fingerprint(cap: Optional[str] = None) -> str:
    """Short hash of :func:`host_features`: the build dir's name."""
    return hashlib.sha1(host_features(cap).encode()).hexdigest()[:10]


def private_root() -> str:
    """A build root of this process alone, removed at exit
    (``EngineConfig(compilation_cache=False)``)."""
    with _LOCK:
        if not _PRIVATE:
            path = tempfile.mkdtemp(prefix="realsr_tpu_torch_build_")
            atexit.register(shutil.rmtree, path, True)
            _PRIVATE.append(path)
        return _PRIVATE[0]


def build_dir(cache: bool = True, cap: Optional[str] = None) -> str:
    """``<root>/<fingerprint>``; the root is :func:`build_root`, or
    :func:`private_root` where ``cache`` is False."""
    return os.path.join(build_root() if cache else private_root(), fingerprint(cap))


def find_nvcc() -> Optional[str]:
    """nvcc on PATH, else under ``$CUDA_HOME/bin`` (``/usr/local/cuda``
    when unset), else None."""
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return path if os.path.isfile(path) else None


def _nvcc() -> str:
    found = find_nvcc()
    if found is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "CUDA kernels build on a machine with the CUDA toolkit"
        )
    return found


def nvcc_release(nvcc: str) -> str:
    """The release ``nvcc --version`` reports (``V12.8.93``); once per
    process and path."""
    with _LOCK:
        if nvcc in _RELEASES:
            return _RELEASES[nvcc]
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True, check=True).stdout
    m = re.search(r"\bV\d[\w.]*", out)
    release = m.group(0) if m else out.strip().splitlines()[-1]
    with _LOCK:
        _RELEASES[nvcc] = release
    return release


def source_digest(name: str, group: str = "") -> str:
    """The build hash of ``csrc/<name>.cu``'s ``group``: its bytes, those of
    every ``csrc/*.cuh`` it may include (by name), the nvcc flags and the
    group's macros."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    if group:
        h.update(b"\0" + " ".join(group_defines(group)).encode())
    return h.hexdigest()[:16]


def library_name(name: str, group: str) -> str:
    return f"{name}-{group}-{source_digest(name, group)}.so"


@contextlib.contextmanager
def _manifest_lock(directory: str):
    with open(os.path.join(directory, ".lock"), "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def read_manifest(directory: str) -> dict:
    """``<directory>/manifest.json``: {"fingerprint", "libraries": {file
    name: {"source", "group", "digest", "nvcc"}}}; empty where there is
    none."""
    try:
        with open(os.path.join(directory, MANIFEST)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def record_libraries(directory: str, libraries: dict) -> None:
    """Merge ``libraries`` ({file name: record}) into the dir's manifest,
    under a file lock (another process may build into the same dir)."""
    os.makedirs(directory, exist_ok=True)
    with _manifest_lock(directory):
        m = read_manifest(directory)
        m["fingerprint"] = os.path.basename(directory)
        m.setdefault("libraries", {}).update(libraries)
        tmp = os.path.join(directory, f"{MANIFEST}.{os.getpid()}.{threading.get_ident()}.tmp")
        with open(tmp, "w") as f:
            json.dump(m, f, indent=1, sort_keys=True)
        os.replace(tmp, os.path.join(directory, MANIFEST))


def ensure_built(name: str, group: str, directory: str, nvcc: Optional[str] = None) -> Tuple[str, float, str]:
    """The ``group`` library of ``csrc/<name>.cu`` in ``directory``, built
    unless it is there and (where nvcc is found) the manifest records the
    running nvcc's release for it: (path, nvcc seconds, nvcc's output; 0.0
    and "" when nothing was built). Without nvcc a library in the dir is
    taken as it is and a missing one raises, naming the seed tool."""
    if group not in GROUPS[name]:
        raise ValueError(f"{name}.cu has no build group {group!r}; it has {GROUPS[name]}")
    so_name = library_name(name, group)
    so = os.path.join(directory, so_name)
    nvcc = nvcc or find_nvcc()
    if nvcc is None:
        if os.path.isfile(so):
            return so, 0.0, ""
        raise RuntimeError(
            f"nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin) and {name}.cu's group {group} "
            f"is not built in {directory}: build the kernels on a machine with the CUDA toolkit, or "
            "install a seed built there: python -m realsr_tpu_torch.seed_cache install SEED.tar.gz"
        )
    release = nvcc_release(nvcc)
    recorded = read_manifest(directory).get("libraries", {}).get(so_name, {}).get("nvcc")
    if os.path.isfile(so) and recorded == release:
        return so, 0.0, ""
    os.makedirs(directory, exist_ok=True)
    # build under a private name, then rename: a concurrent process never
    # loads a half-written library
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    src = os.path.join(CSRC, f"{name}.cu")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, *group_defines(group), "-o", tmp, src], capture_output=True, text=True)
    if proc.returncode != 0:
        with contextlib.suppress(FileNotFoundError):
            os.remove(tmp)
        raise RuntimeError(
            f"nvcc failed to build {src}, group {group} (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, so)
    seconds = time.perf_counter() - t0
    record_libraries(directory, {so_name: {
        "source": name, "group": group, "digest": source_digest(name, group), "nvcc": release}})
    return so, seconds, proc.stdout + proc.stderr


def _load(name: str, group: str, cache: bool) -> Tuple[ctypes.CDLL, float]:
    key = (name, group)
    with _LOCK:
        lock = _KEY_LOCKS.setdefault(key, threading.Lock())
    with lock:
        lib = _LIBS.get(key)
        if lib is not None:
            return lib, 0.0
        so, BUILD_SECONDS[key], BUILD_LOG[key] = ensure_built(name, group, build_dir(cache))
        lib = ctypes.CDLL(so)
        _LIBS[key] = lib
        return lib, BUILD_SECONDS[key]


def load_library(name: str, group: str, cache: bool = True) -> ctypes.CDLL:
    """Build (if needed) and load the ``group`` library of
    ``csrc/<name>.cu``; cached per process. Thread-safe: calls for
    different libraries build concurrently. ``cache`` False builds into
    :func:`private_root` (a library already loaded in the process is used
    as it is)."""
    return _load(name, group, cache)[0]


def load_groups(keys: Iterable[Tuple[str, str]], cache: bool = True) -> Dict[Tuple[str, str], float]:
    """Load the (source, group) libraries ``keys`` at once, one thread (and
    one nvcc, where one is needed) each: {key: nvcc seconds of this call,
    0.0 for a library found built or already loaded}. A failed build
    raises."""
    keys = list(dict.fromkeys(keys))
    if not keys:
        return {}
    with concurrent.futures.ThreadPoolExecutor(len(keys)) as pool:
        seconds = list(pool.map(lambda k: _load(*k, cache)[1], keys))
    return dict(zip(keys, seconds))
