"""The port's kernel build cache (``realsr_tpu_torch/ops/build.py``): which
bytes a built library's name depends on, the build groups against the
sources' dispatch, the host fingerprint, the rules for rebuilding and for
hosts without nvcc, and the engine's group builds (fast start,
``compilation_cache``). Runs without nvcc: a recording stand-in for
``subprocess.run`` plays nvcc, and a stub library built with the host's cc
stands in where a library must load."""

import os
import platform
import re
import shutil
import subprocess
import sys
import threading
import time

import pytest
import torch

import realsr_tpu.engine as jax_engine
from realsr_tpu_torch import engine as engine_mod
from realsr_tpu_torch.engine import Device, EngineConfig, RealSR
from realsr_tpu_torch.ops import build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _copy_csrc(tmp_path, monkeypatch):
    d = tmp_path / "csrc"
    shutil.copytree(build.CSRC, d)
    monkeypatch.setattr(build, "CSRC", str(d))
    return d


def test_digest_covers_the_source_every_header_and_the_flags(tmp_path, monkeypatch):
    """An edit to the source, to any header of csrc/ (tail_kernel.cu,
    rdb_wgmma.cu and rdb_tf32.cu include hopper.cuh), or to the flags names
    another library; an edit to another source does not."""
    d = _copy_csrc(tmp_path, monkeypatch)
    assert (d / "hopper.cuh").is_file()
    first = {n: build.source_digest(n) for n in ("tail_kernel", "rdb_wgmma", "rdb_tf32")}
    assert build.source_digest("tail_kernel") == first["tail_kernel"]  # stable

    with open(d / "hopper.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: build.source_digest(n) for n in first}
    assert all(after[n] != first[n] for n in first)

    with open(d / "rdb_tf32.cu", "a") as f:
        f.write("\n// edited\n")
    assert build.source_digest("rdb_tf32") != after["rdb_tf32"]
    assert build.source_digest("tail_kernel") == after["tail_kernel"]

    (d / "new.cuh").write_text("#pragma once\n")
    assert build.source_digest("tail_kernel") != after["tail_kernel"]

    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.source_digest("rdb_tf32") != after["rdb_tf32"]


def test_library_name_uses_the_digest(tmp_path, monkeypatch):
    """load_library looks for <name>-<group>-<digest>.so in the build root's
    fingerprint directory and, on a host without nvcc, loads a library that
    is already there without building it."""
    _copy_csrc(tmp_path, monkeypatch)
    out = tmp_path / "build"
    monkeypatch.setenv("REALSR_TPU_TORCH_BUILD", str(out))
    d = out / build.fingerprint()
    d.mkdir(parents=True)
    so = d / f"tail_kernel-k6-{build.source_digest('tail_kernel', 'k6')}.so"
    so.write_bytes(b"")
    loaded = []
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: loaded.append(path) or path)
    monkeypatch.setattr(build, "_LIBS", {})
    assert build.load_library("tail_kernel", "k6") == str(so)
    assert loaded == [str(so)] and build.BUILD_SECONDS[("tail_kernel", "k6")] == 0.0


def test_sources_are_every_kernel_source_of_csrc(tmp_path, monkeypatch):
    """build.SOURCES (what chip_smoke.py builds, one nvcc per group) names
    every csrc/*.cu and nothing else, and each digest covers the float32
    instances' shared headers (rdb_modes.cuh, tail_wgmma.cuh)."""
    assert sorted(build.SOURCES) == sorted(f[:-3] for f in os.listdir(build.CSRC) if f.endswith(".cu"))
    d = _copy_csrc(tmp_path, monkeypatch)
    for header, users in (("rdb_modes.cuh", ("rdb_modes_wgmma", "rdb_modes_tf32")),
                          ("tail_wgmma.cuh", ("tail_kernel", "tail_tf32"))):
        before = {n: build.source_digest(n) for n in users}
        with open(d / header, "a") as f:
            f.write("\n// edited\n")
        assert all(build.source_digest(n) != before[n] for n in users)


# -- build groups, the host fingerprint, the cache's rules -------------------
RELEASE = "Cuda compilation tools, release 12.8, V12.8.93"
NVCC = "/fake/cuda/bin/nvcc"
# the dispatch functions of csrc/*.cu (the C entry points call them)
DISPATCH = {"launch_shape", "launch_tile", "chained_tile", "chained_shape", "paired_tile", "packed_tile", "packed_shape"}


@pytest.fixture(scope="session")
def stub_so(tmp_path_factory):
    """A shared library built with the host's cc, standing in for a kernel
    library wherever one must load."""
    cc = shutil.which("cc")
    if cc is None:
        pytest.skip("no cc on this host to build a stub shared library")
    d = tmp_path_factory.mktemp("stub")
    (d / "stub.c").write_text("int stub_entry(void) { return 0; }\n")
    subprocess.run([cc, "-shared", "-fPIC", "-o", str(d / "stub.so"), str(d / "stub.c")], check=True)
    return str(d / "stub.so")


class FakeNvcc:
    """subprocess.run with nvcc faked: ``--version`` reports ``release``; a
    build records its command line and its start and end, takes ``delay``
    seconds and writes the stub library to ``-o``. Other commands run."""

    def __init__(self, stub: str, delay: float = 0.0, release: str = RELEASE):
        self.stub, self.delay, self.release = stub, delay, release
        self.builds = []
        self.lock = threading.Lock()
        self.run = subprocess.run

    def __call__(self, cmd, **kw):
        if cmd[0] != NVCC:
            return self.run(cmd, **kw)
        if cmd[1:] == ["--version"]:
            return subprocess.CompletedProcess(cmd, 0, stdout=self.release + "\n", stderr="")
        t0 = time.perf_counter()
        time.sleep(self.delay)
        shutil.copyfile(self.stub, cmd[cmd.index("-o") + 1])
        with self.lock:
            self.builds.append((cmd, t0, time.perf_counter()))
        return subprocess.CompletedProcess(cmd, 0, stdout="ptxas info: fake\n", stderr="")


@pytest.fixture
def nvcc(stub_so, monkeypatch, tmp_path):
    """A host with a fake nvcc and an empty build root, with the process's
    caches of libraries and releases emptied."""
    fake = FakeNvcc(stub_so)
    monkeypatch.setattr(build, "find_nvcc", lambda: NVCC)
    monkeypatch.setattr(build.subprocess, "run", fake)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "_RELEASES", {})
    monkeypatch.setenv("REALSR_TPU_TORCH_BUILD", str(tmp_path / "root"))
    return fake


def test_fingerprint_stable_and_needs_no_nvcc(monkeypatch, tmp_path):
    """The fingerprint is a short hash, the same on each call, computed
    with no nvcc on PATH or under CUDA_HOME."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert build.find_nvcc() is None
    fp = build.fingerprint()
    assert re.fullmatch(r"[0-9a-f]{10}", fp) and build.fingerprint() == fp
    assert build.build_dir() == os.path.join(build.build_root(), fp)


@pytest.mark.parametrize("what", ["machine", "capability", "cuda", "flags"])
def test_fingerprint_changes_with_each_input(what, monkeypatch):
    """Each of the fingerprint's inputs names another build dir: the
    machine, the card's compute capability, the CUDA release PyTorch was
    built for, the nvcc flags (the JAX engine's _host_features scope)."""
    before = build.fingerprint("9.0")
    if what == "machine":
        other = "aarch64" if platform.machine() != "aarch64" else "x86_64"
        monkeypatch.setattr(build.platform, "machine", lambda: other)
    elif what == "capability":
        assert build.fingerprint("10.0") != before
        return
    elif what == "cuda":
        monkeypatch.setattr(torch.version, "cuda", "99.9")
    else:
        monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.fingerprint("9.0") != before


def test_each_group_builds_with_exactly_its_defines(nvcc, tmp_path):
    """One nvcc per group, whose command line is the flags, the group's
    macros and nothing else; every group's library name and hash differ
    from every other's."""
    names, digests = set(), set()
    for src in build.SOURCES:
        for g in build.GROUPS[src]:
            path, seconds, _ = build.ensure_built(src, g, str(tmp_path / "d"))
            cmd = nvcc.builds[-1][0]
            assert [a for a in cmd if a.startswith("-D")] == [f"-D{build.GROUP_MACROS[p]}" for p in g.split("_")]
            assert cmd[1:1 + len(build.NVCC_FLAGS)] == list(build.NVCC_FLAGS) and cmd[-1].endswith(f"{src}.cu")
            assert os.path.basename(path) == build.library_name(src, g) and seconds > 0
            names.add(os.path.basename(path))
            digests.add(build.source_digest(src, g))
    n = sum(len(gs) for gs in build.GROUPS.values())
    assert len(nvcc.builds) == len(names) == len(digests) == n == 17


def _active(text: str, defined: set) -> str:
    """The lines of a csrc source a C preprocessor keeps with ``defined``
    macros, csrc/groups.cuh inlined (the only header with group macros)."""
    out, stack = [], []

    def cond(expr: str) -> bool:
        expr = re.sub(r"defined\((\w+)\)", lambda m: str(m.group(1) in defined), expr)
        return bool(eval(expr.replace("&&", " and ").replace("||", " or ").replace("!", " not ")))

    for line in text.splitlines():
        st = line.strip()
        on = all(stack)
        if st.startswith("#ifdef "):
            stack.append(st.split()[1] in defined)
        elif st.startswith("#if "):
            stack.append(cond(st[4:]))
        elif st.startswith("#endif"):
            stack.pop()
        elif on and st.startswith("#define "):
            defined.add(st.split()[1])
        elif on and st == '#include "groups.cuh"':
            with open(os.path.join(build.CSRC, "groups.cuh")) as f:
                out.append(_active(f.read(), defined))
        elif on:
            out.append(line)
    assert not stack
    return "\n".join(out)


def _calls(body: str):
    """(name, [template arguments]) of each ``name<...>(`` call in body."""
    for m in re.finditer(r"\b(\w+)<", body):
        depth, i = 1, m.end()
        while depth:
            depth += {"<": 1, ">": -1}.get(body[i], 0)
            i += 1
        if body[i:i + 1] != "(":
            continue
        args, depth, cur = [], 0, ""
        for ch in body[m.end():i - 1]:
            if ch == "," and depth == 0:
                args.append(cur.strip())
                cur = ""
                continue
            depth += {"<": 1, ">": -1}.get(ch, 0)
            cur += ch
        yield m.group(1), args + [cur.strip()]


def _functions(text: str) -> dict:
    """{name: (template parameter names, body)} of every ``int name(...)``
    definition."""
    out = {}
    for m in re.finditer(r"(?:template <([^>]*)>\s*)?\bint (\w+)\([^)]*\)\s*\{", text):
        depth, i = 1, m.end()
        while depth:
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            i += 1
        params = [p.split()[-1] for p in m.group(1).split(",")] if m.group(1) else []
        out[m.group(2)] = (params, text[m.end():i])
    return out


def _instances(src: str, macros: set) -> set:
    """The leaf launches that the C entry points of csrc/<src>.cu reach
    through its dispatch functions, built with ``macros``."""
    with open(os.path.join(build.CSRC, f"{src}.cu")) as f:
        text = _active(f.read(), set(macros))
    funcs = _functions(text)
    found = set()

    def walk(name, binding):
        for callee, args in _calls(funcs[name][1]):
            args = [re.sub(r"\b\w+\b", lambda m: binding.get(m.group(0), m.group(0)), a) for a in args]
            if callee in DISPATCH:
                walk(callee, dict(zip(funcs[callee][0], args)))
            elif callee.startswith("launch"):
                found.add(f"{callee}<{', '.join(args)}>")

    roots = [n for n in funcs if n.endswith("_launch")]
    assert roots, src
    for r in roots:
        walk(r, {})
    return found


@pytest.mark.parametrize("src", build.SOURCES)
def test_group_table_names_the_dispatch_instances(src):
    """build.instances names exactly the launches each group's macros leave
    in the source's dispatch (parsed from csrc/<src>.cu); the groups
    partition the instances of the source built with no macro (the
    ablation tools' whole-source build); the patch sides are those the
    wrappers pick from."""
    from realsr_tpu_torch.ops import rdb_kernel as rk
    from realsr_tpu_torch.ops import tail_kernel as tk

    every = set()
    for g in build.GROUPS[src]:
        got = _instances(src, {build.GROUP_MACROS[p] for p in g.split("_")})
        assert got and got == set(build.instances(src, g)) and len(got) == len(build.instances(src, g)), (src, g)
        assert not every & got
        every |= got
    assert _instances(src, set()) == every
    sides = {"rdb_wgmma": rk.WGMMA_TILES, "rdb_tf32": rk.TF32_TILES, "tail_kernel": tk.TAIL_TILES,
             "tail_tf32": tk.TAIL_TF32_TILES}
    if src in sides:
        n = 1 if src.startswith("rdb") else 2  # a patch side; the tail's patch shape
        lead = {tuple(int(v) for v in re.findall(r"\d+", i)[:n]) for i in every}
        assert lead == {t if isinstance(t, tuple) else (t,) for t in sides[src]}


def test_a_different_nvcc_release_rebuilds(nvcc, tmp_path):
    """The manifest records the nvcc release that built each library: the
    same release loads it, another rebuilds it."""
    d = str(tmp_path / "d")
    assert build.ensure_built("tail_kernel", "k6", d)[1] > 0
    rec = build.read_manifest(d)["libraries"][build.library_name("tail_kernel", "k6")]
    assert rec == {"source": "tail_kernel", "group": "k6", "digest": build.source_digest("tail_kernel", "k6"),
                   "nvcc": "V12.8.93"}
    assert build.read_manifest(d)["fingerprint"] == "d"
    assert build.ensure_built("tail_kernel", "k6", d)[1] == 0.0 and len(nvcc.builds) == 1
    nvcc.release = "Cuda compilation tools, release 12.9, V12.9.41"
    build._RELEASES.clear()
    assert build.ensure_built("tail_kernel", "k6", d)[1] > 0 and len(nvcc.builds) == 2
    assert build.read_manifest(d)["libraries"][build.library_name("tail_kernel", "k6")]["nvcc"] == "V12.9.41"


def test_without_nvcc_a_built_library_loads_and_a_missing_one_raises(stub_so, monkeypatch, tmp_path):
    """With no nvcc, a library in the build dir loads whatever release
    built it; a missing one raises, naming the seed tool; nothing is built
    or taken in its place."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setenv("REALSR_TPU_TORCH_BUILD", str(tmp_path / "root"))
    monkeypatch.setattr(build, "_LIBS", {})
    d = build.build_dir()
    os.makedirs(d)
    shutil.copyfile(stub_so, os.path.join(d, build.library_name("rdb_wgmma", "f32_nf64")))
    lib = build.load_library("rdb_wgmma", "f32_nf64")
    assert lib.stub_entry() == 0 and build.BUILD_SECONDS[("rdb_wgmma", "f32_nf64")] == 0.0
    with pytest.raises(RuntimeError, match=r"nvcc not found.*realsr_tpu_torch\.seed_cache install"):
        build.load_library("rdb_wgmma", "bf16_nf64")
    with pytest.raises(ValueError, match="no build group"):
        build.load_library("rdb_tf32", "bf16_nf64")
    assert sorted(os.listdir(d)) == [build.library_name("rdb_wgmma", "f32_nf64")]


def test_private_build_root_is_removed_at_exit(tmp_path):
    """compilation_cache=False builds into a directory of the process
    alone, removed when the process exits."""
    code = ("import os, sys; sys.path.insert(0, sys.argv[1]); from realsr_tpu_torch.ops import build; "
            "d = build.build_dir(cache=False); os.makedirs(d); open(os.path.join(d, 'x.so'), 'w').close(); "
            "assert build.private_root() == build.private_root(); print(d)")
    env = {**os.environ, "TMPDIR": str(tmp_path)}
    r = subprocess.run([sys.executable, "-c", code, ROOT], capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    d = r.stdout.strip()
    assert d.startswith(str(tmp_path)) and d.endswith(build.fingerprint()) and not os.path.exists(os.path.dirname(d))


# -- the engine: which groups, built when, and how ---------------------------

@pytest.fixture(scope="module")
def df2k(tmp_path_factory):
    """The committed DF2K graph (23 RRDB, nf 64, gc 32) with synthesized
    weights."""
    from realsr_tpu_torch.ncnn.bin import write_weights
    from realsr_tpu_torch.ncnn.param import parse_param_file
    from realsr_tpu_torch.ncnn.synth import synth_weights

    d = tmp_path_factory.mktemp("df2k") / "models-DF2K"
    d.mkdir()
    shutil.copyfile(os.path.join(ROOT, "models", "models-DF2K", "x4.param"), d / "x4.param")
    graph = parse_param_file(str(d / "x4.param"))
    write_weights(graph, synth_weights(graph, seed=0), str(d / "x4.bin"))
    return str(d / "x4.param"), str(d / "x4.bin")


K1, K6 = ("rdb_wgmma", "f32_nf64"), ("tail_kernel", "k6")
CASES = {
    # config: the groups a card engine builds, the sources the engine's
    # build unit used to be (kernel_sources)
    "default mixed": (dict(), (K1, K6), ("rdb_wgmma", "tail_kernel")),
    "float32": (dict(storage="float32"), (("rdb_tf32", "f32_nf64"), ("tail_tf32", "k6")), ("rdb_tf32", "tail_tf32")),
    "bfloat16": (dict(storage="bfloat16"), (("rdb_wgmma", "bf16_nf64"), K6), ("rdb_wgmma", "tail_kernel")),
    "K3 chained": (dict(trunk="chained"), (("rdb_modes_wgmma", "f32_nf64"), K6), ("rdb_modes_wgmma", "tail_kernel")),
    "K4 paired": (dict(trunk="paired"), (("rdb_modes_wgmma", "f32_nf64"), K6), ("rdb_modes_wgmma", "tail_kernel")),
    "K5 packed": (dict(sched="packed"), (("rdb_modes_wgmma", "f32_nf64"), K6), ("rdb_modes_wgmma", "tail_kernel")),
    "K3 bfloat16": (dict(storage="bfloat16", trunk="chained"), (("rdb_modes_wgmma", "bf16_nf64"), K6),
                    ("rdb_modes_wgmma", "tail_kernel")),
    "K3 float32": (dict(storage="float32", trunk="chained"), (("rdb_modes_tf32", "f32_nf64"), ("tail_tf32", "k6")),
                   ("rdb_modes_tf32", "tail_tf32")),
    "K5 float32": (dict(storage="float32", sched="packed"), (("rdb_modes_tf32", "f32_nf64"), ("tail_tf32", "k6")),
                   ("rdb_modes_tf32", "tail_tf32")),
    "K7 tail": (dict(tail="kernel_hr"), (K1, ("tail_kernel", "k7")), ("rdb_wgmma", "tail_kernel")),
    "K7 float32": (dict(storage="float32", tail="kernel_hr"), (("rdb_tf32", "f32_nf64"), ("tail_tf32", "k7")),
                   ("rdb_tf32", "tail_tf32")),
    "interleaved tail": (dict(tail="interleaved"), (K1,), ("rdb_wgmma",)),
    "float16 (plain convs)": (dict(storage="float16"), (), ()),
    "fast start off": (dict(fast_start=False), tuple((s, g) for s in ("rdb_wgmma", "tail_kernel")
                                                     for g in build.GROUPS[s]), ("rdb_wgmma", "tail_kernel")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_groups_of_a_card_engine(case, df2k, monkeypatch):
    """The groups a card engine of each form builds (resolved without a
    card, as the seed tool does): its trunk's instances at its state type
    and nf 64, its tail's form; with fast start off every group of those
    sources. Their sources are the ones the whole-source build unit
    named."""
    monkeypatch.delenv("REALSR_TPU_FAST_START", raising=False)
    monkeypatch.delenv("REALSR_TPU_PACKED_TAIL", raising=False)
    monkeypatch.delenv("REALSR_TPU_SCHED", raising=False)
    cfg, want, sources = CASES[case]
    got = engine_mod.card_kernel_groups(EngineConfig(**cfg), *df2k)
    assert got == want
    assert tuple(dict.fromkeys(s for s, _ in got)) == sources
    assert all(g in build.GROUPS[s] for s, g in got)


def test_fast_start_env_turns_it_off(df2k, monkeypatch):
    """REALSR_TPU_FAST_START=0 builds every group of the sources, like
    fast_start=False."""
    monkeypatch.setenv("REALSR_TPU_FAST_START", "0")
    assert engine_mod.card_kernel_groups(EngineConfig(), *df2k) == CASES["fast start off"][1]


@pytest.mark.parametrize("value", [None, "0", "1", "", "false", "no"])
@pytest.mark.parametrize("flag", [True, False])
def test_fast_start_reads_as_the_jax_engine(value, flag, monkeypatch, tiny_model_dir):
    """EngineConfig(fast_start=..., compilation_cache=...) keep the JAX
    engine's names and defaults, and REALSR_TPU_FAST_START is read as the
    JAX engine reads it (only "0" turns fast start off)."""
    from types import SimpleNamespace

    if value is None:
        monkeypatch.delenv("REALSR_TPU_FAST_START", raising=False)
    else:
        monkeypatch.setenv("REALSR_TPU_FAST_START", value)
    for name in ("fast_start", "compilation_cache"):
        assert getattr(EngineConfig(), name) is getattr(jax_engine.EngineConfig(), name) is True
    jax_view = SimpleNamespace(config=jax_engine.EngineConfig(fast_start=flag), variant="pallas")
    e = RealSR(gpuid=-1, config=EngineConfig(fast_start=flag))
    assert e.fast_start == jax_engine.RealSR._fast_start_enabled(jax_view)


def _card_engine(tiny_model_dir, groups, monkeypatch, **cfg):
    """A CPU engine that takes itself for a card engine launching
    ``groups``: its first chunk then builds them (the chunks still run on
    the CPU's plain versions)."""
    e = RealSR(gpuid=-1, config=EngineConfig(tilesize=16, **cfg))
    e.load(os.path.join(tiny_model_dir, "x4.param"), os.path.join(tiny_model_dir, "x4.bin"))
    e.device = Device("gpu", torch.device("cpu"))
    e.kernel_groups = lambda: groups
    monkeypatch.setattr(engine_mod, "_on_card", lambda device: True)
    return e


def test_a_cpu_engine_faked_as_a_card_builds_nothing(nvcc, tiny_model_dir):
    """Kernels build for the engines whose tensors are on a CUDA device: a
    CPU engine with the card's platform (as the tile-pick tests make one)
    runs the plain versions and builds nothing."""
    import numpy as np

    e = RealSR(gpuid=-1, config=EngineConfig(tilesize=16, variant="cuda"))
    e.load(os.path.join(tiny_model_dir, "x4.param"), os.path.join(tiny_model_dir, "x4.bin"))
    e.device = Device("gpu", torch.device("cpu"))
    assert e.kernel_groups()
    e.process(np.zeros((20, 24, 3), np.uint8))
    assert nvcc.builds == []


def test_engine_builds_its_groups_at_once_before_the_first_chunk(nvcc, tiny_model_dir, capsys, monkeypatch):
    """The first chunk waits for the engine's groups, built concurrently
    (the fake builds overlap), with one stderr line naming each group and
    its nvcc seconds; later images build nothing; the output is the plain
    engine's."""
    import numpy as np

    nvcc.delay = 0.4
    e = _card_engine(tiny_model_dir, (K1, K6), monkeypatch)
    img = np.random.default_rng(0).integers(0, 256, (20, 24, 3), np.uint8)
    chunks = []
    run = e._run_chunk
    e._run_chunk = lambda *a: (chunks.append(len(nvcc.builds)), run(*a))[1]
    got = e.process(img)
    assert chunks and chunks[0] == 2
    (_, s0, e0), (_, s1, e1) = nvcc.builds
    assert max(s0, s1) < min(e0, e1), "the groups built one after the other"
    err = capsys.readouterr().err
    assert re.search(r"built 2 kernel groups with nvcc in [\d.]+ s \(rdb_wgmma\[f32_nf64\] [\d.]+ s, "
                     r"tail_kernel\[k6\] [\d.]+ s\) into " + re.escape(build.build_dir()), err)
    e.process(img)
    assert len(nvcc.builds) == 2 and "built" not in capsys.readouterr().err
    plain = RealSR(gpuid=-1, config=EngineConfig(tilesize=16))
    plain.load(os.path.join(tiny_model_dir, "x4.param"), os.path.join(tiny_model_dir, "x4.bin"))
    assert np.array_equal(got, plain.process(img))


def test_engine_build_failure_raises(nvcc, tiny_model_dir, monkeypatch):
    """A group that fails to build raises with nvcc's output, before any
    chunk runs: nothing takes its place."""
    import numpy as np

    def broken(cmd, **kw):
        if cmd[0] != NVCC:
            return nvcc.run(cmd, **kw)
        if cmd[1:] == ["--version"]:
            return subprocess.CompletedProcess(cmd, 0, stdout=RELEASE, stderr="")
        return subprocess.CompletedProcess(cmd, 2, stdout="", stderr="error: bad instance")

    monkeypatch.setattr(build.subprocess, "run", broken)
    e = _card_engine(tiny_model_dir, (K1,), monkeypatch)
    e._run_chunk = lambda *a: pytest.fail("a chunk ran without its kernels")
    with pytest.raises(RuntimeError, match="(?s)nvcc failed to build .*rdb_wgmma.cu, group f32_nf64.*bad instance"):
        e.process(np.zeros((20, 24, 3), np.uint8))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        e.precompile(24, 20)


def test_compilation_cache_off_builds_in_a_private_dir(nvcc, tiny_model_dir, tmp_path, monkeypatch):
    """EngineConfig(compilation_cache=False) builds into the process's
    private root, not the build root."""
    e = _card_engine(tiny_model_dir, (K6,), monkeypatch, compilation_cache=False)
    e.precompile(24, 20)
    (cmd, _, _), = nvcc.builds
    out = cmd[cmd.index("-o") + 1]
    assert out.startswith(os.path.join(build.private_root(), build.fingerprint()) + os.sep)
    assert not os.path.exists(tmp_path / "root")

