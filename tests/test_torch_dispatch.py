"""The engine's run-time dispatch on the CPU: the chunk program table (keys,
static buffers, copy-in / replay / scatter-out) through a stand-in graph
class whose replay runs the chunk's eager work, ``RealSR.precompile`` and
``program_keys``, ``fetch``, the progress fence's fractions, the CLI's
``REALSR_TPU_PRECOMPILE`` and the bridge's ``warmup``, with the slice held
against the JAX package's engine. CUDA graphs, events and the copy stream
run only on a card (``chip_smoke.py`` phase 11)."""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

import realsr_tpu
import realsr_tpu_torch
from realsr_tpu.engine import EngineConfig as JaxConfig
from realsr_tpu.engine import RealSR as JaxRealSR
from realsr_tpu_torch import cli
from realsr_tpu_torch import engine as engine_mod
from realsr_tpu_torch import loader
from realsr_tpu_torch import native_bridge as nb
from realsr_tpu_torch.engine import EngineConfig, RealSR
from realsr_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(2)
CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class EagerGraph:
    """Stand-in for the engine's CUDA graph, on any device: capture runs the
    chunk's work once (as the warm-up does, on the chunk in the static
    buffers) and keeps it; each replay runs it again, from the static tiles
    into the static output. ``captures`` and ``replays`` count them in the
    process."""

    captures = replays = 0

    def __init__(self, state):
        self.fn = None

    @staticmethod
    def supports(device):
        return True

    def capture(self, fn):
        fn()
        self.fn = fn
        type(self).captures += 1

    def replay(self):
        type(self).replays += 1
        self.fn()


@pytest.fixture
def stand_in(monkeypatch):
    """Engines capture EagerGraph programs, on the CPU too; returns a
    function giving (captures, replays) since the fixture began."""
    monkeypatch.setattr(engine_mod, "_CudaGraph", EagerGraph)
    c0, r0 = EagerGraph.captures, EagerGraph.replays
    return lambda: (EagerGraph.captures - c0, EagerGraph.replays - r0)


def _files(d):
    return os.path.join(d, "x4.param"), os.path.join(d, "x4.bin")


def _engine(d, k=0, tta=False, graphs=True, **cfg):
    """A float32 CPU engine at tile 16 (on a mesh of ``k`` CPU shards when
    ``k``); ``graphs`` asks for the chunk program table (``cuda_graphs``),
    which a CPU engine runs only under the ``stand_in`` fixture."""
    config = EngineConfig(**{"tilesize": 16, "storage": "float32", "cuda_graphs": graphs, **cfg})
    e = RealSR(gpuid=-1, tta_mode=tta, config=config, mesh=make_mesh([CPU] * k) if k else None)
    e.load(*_files(d))
    assert e.graphs == (graphs and issubclass(engine_mod._CudaGraph, EagerGraph))
    return e


def _recorded_keys(e, monkeypatch, every=None):
    """The set of keys of the chunks ``e`` runs, recorded at
    ``_run_chunk``; ``every`` (a list) also gets each chunk's key."""
    seen = set()
    run = e._run_chunk

    def record(padded, alpha, out, ph, pw, chunk, c):
        key = (padded.device, ph, pw, len(chunk), e.tta_mode, c == 4)
        seen.add(key)
        if every is not None:
            every.append(key)
        return run(padded, alpha, out, ph, pw, chunk, c)

    monkeypatch.setattr(e, "_run_chunk", record)
    return seen


def test_version():
    assert realsr_tpu_torch.__version__ == "0.1.0" == realsr_tpu.__version__
    with open(os.path.join(ROOT, "pyproject.toml")) as f:
        assert 'version = "0.1.0"' in f.read()
    assert "__version__" in realsr_tpu_torch.__all__


def test_facade_docstring_names_every_source():
    from realsr_tpu_torch.ops import build

    for src in build.SOURCES:
        assert f"csrc/{src}.cu" in realsr_tpu_torch.__doc__, src


def test_engines_resolve_graphs(tiny_model_dir):
    """Graphs belong to a card: a CPU engine runs eagerly whatever its
    config says, and the config's default asks for graphs."""
    assert EngineConfig().cuda_graphs is True
    for flag in (True, False):
        e = RealSR(gpuid=-1, config=EngineConfig(tilesize=16, cuda_graphs=flag))
        e.load(*_files(tiny_model_dir))
        assert e.graphs is False and e.programs() == {}


CASES = {
    "rgb": dict(shape=(40, 48, 3)),
    "ragged rgba": dict(shape=(33, 21, 4)),
    "tta": dict(shape=(20, 30, 3), tta=True),
    "banded": dict(shape=(52, 20, 4), btr=1),
    "mesh": dict(shape=(40, 48, 3), k=2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_graph_table_bit_equal_to_eager(tiny_model_dir, case, monkeypatch, stand_in):
    """The same engine through the table and eagerly, twice: bit-equal
    output. A key's first chunk runs eagerly, its second by the capture of
    its program (whose warm-up computes it), every later one as a replay."""
    cfg = CASES[case]
    k, tta, btr = cfg.get("k", 0), cfg.get("tta", False), cfg.get("btr")
    img = np.random.default_rng(len(case)).integers(0, 256, cfg["shape"], np.uint8)
    g = _engine(tiny_model_dir, k, tta)
    eager = _engine(tiny_model_dir, k, tta, graphs=False)
    chunks: list = []
    ran = _recorded_keys(eager, monkeypatch, chunks)
    run = (lambda e: e.process_banded(img, band_tile_rows=btr)) if btr else (lambda e: e.process(img))
    for _ in range(2):
        np.testing.assert_array_equal(run(g), run(eager))
    progs = g.programs()
    assert set(progs) == ran and progs
    per_key = [chunks.count(key) for key in ran]
    assert stand_in() == (len(ran), sum(n - 2 for n in per_key))
    for (dev, ph, pw, bsz, t, alpha), p in progs.items():
        assert p.tiles.shape == (bsz, ph, pw, 3) and p.tiles.dtype == torch.float32
        assert p.out.shape == (bsz, 4 * (ph - 20), 4 * (pw - 20), 4 if alpha else 3)
        assert (p.alpha is not None) == alpha and t == tta and dev == CPU


@pytest.mark.parametrize("what", ["whole rgb", "whole rgba", "banded rgb", "banded rgba", "stack of 3"])
def test_program_keys_match_a_recorded_process(tiny_model_dir, what, monkeypatch):
    """program_keys (what precompile captures) is the set of keys a
    process of the same shape runs, whole or banded; on the CPU
    precompile's count is that set's size."""
    c = 4 if what.endswith("rgba") else 3
    shape = (52, 34, c)
    e = _engine(tiny_model_dir, graphs=False)
    if what.startswith("banded"):
        monkeypatch.setenv("REALSR_TPU_BAND_BUDGET_MB", "0")
        assert e.needs_banding(shape)
    n_img = 3 if what == "stack of 3" else 1
    ran = _recorded_keys(e, monkeypatch)
    imgs = np.random.default_rng(5).integers(0, 256, (n_img, *shape), np.uint8)
    if n_img == 1:
        e.process(imgs[0])
    else:
        e.process_batch(list(imgs))
    assert e.program_keys(shape[1], shape[0], c, n_img) == ran
    assert e.precompile(shape[1], shape[0], c, n_img) == len(ran)
    assert e.programs() == {}  # the CPU captures nothing


def test_program_keys_under_a_mesh_per_device(tiny_model_dir, monkeypatch):
    """Under a mesh the keys carry the device each chunk is dealt to."""
    e = _engine(tiny_model_dir, 3, graphs=False, max_batch=2)
    ran = _recorded_keys(e, monkeypatch)
    e.process(np.zeros((40, 48, 3), np.uint8))
    assert e.program_keys(48, 40) == ran


def test_precompile_fills_the_table(tiny_model_dir, stand_in):
    """precompile captures every key the image runs; the process after it
    captures nothing and replays every chunk, and a second precompile
    captures nothing either."""
    e = _engine(tiny_model_dir)
    n = e.precompile(34, 52, channels=4)
    assert n == len(e.programs()) > 0 and stand_in() == (n, 0)
    e.process(np.random.default_rng(6).integers(0, 256, (52, 34, 4), np.uint8))
    captures, replays = stand_in()
    assert captures == n and replays >= n and len(e.programs()) == n
    assert e.precompile(34, 52, channels=4) == n and stand_in()[0] == n


def test_table_evicts_least_recently_used(tiny_model_dir, monkeypatch, stand_in):
    """A key met once runs eagerly and is remembered; met again, it is
    captured. Past MAX_PROGRAMS keys on a device the least recently used
    goes, program or key met once: a key used again stays, the output stays
    bit-equal to eager, and an evicted key starts over."""
    monkeypatch.setattr(engine_mod, "MAX_PROGRAMS", 2)
    e = _engine(tiny_model_dir)
    eager = _engine(tiny_model_dir, graphs=False)
    imgs = {name: np.random.default_rng(k).integers(0, 256, (*hw, 3), np.uint8)
            for k, (name, hw) in enumerate({"a": (16, 16), "b": (16, 12), "c": (12, 16)}.items())}
    keys = {}
    table = []
    for name, captures in (("a", 0), ("a", 1), ("b", 1), ("b", 2), ("a", 2), ("c", 2), ("b", 2), ("b", 3)):
        np.testing.assert_array_equal(e.process(imgs[name]), eager.process(imgs[name]))  # one tile: one key
        assert stand_in()[0] == captures
        keys.setdefault(name, next(reversed(e._programs[CPU])))
        table.append("".join(k for k, key in keys.items() if key in e.programs()))
    # a's replay made it the most recent, so c's entry evicted b's program;
    # b came back as a key met once (evicting a), then was captured again
    assert table == ["", "a", "a", "ab", "ab", "a", "", "b"]
    assert stand_in() == (3, 1)


def test_precompile_checks(tiny_model_dir):
    with pytest.raises(RuntimeError, match="load"):
        RealSR(gpuid=-1).precompile(8, 8)
    with pytest.raises(ValueError, match="channels"):
        _engine(tiny_model_dir).precompile(8, 8, channels=2)


def test_capture_failure_raises(tiny_model_dir, monkeypatch, stand_in):
    """A capture that fails raises, each time the key comes back; nothing
    falls back to eager, and the table keeps no program for the key."""

    class Failing(EagerGraph):
        def capture(self, fn):
            raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(engine_mod, "_CudaGraph", Failing)
    e = _engine(tiny_model_dir)
    img = np.zeros((20, 20, 3), np.uint8)
    e.process(img)  # every key met once: eager
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capturing"):
            e.process(img)
        assert e.programs() == {}


def test_threads_share_programs_safely(tiny_model_dir, monkeypatch, stand_in):
    """Proc threads on one engine share its programs' static buffers: the
    device lock keeps each chunk's copy-in, replay and scatter together. A
    replay that yields mid-way would mix two threads' tiles without it."""

    class Yielding(EagerGraph):
        def replay(self):
            time.sleep(0)  # let another thread run between copy-in and replay
            super().replay()

    monkeypatch.setattr(engine_mod, "_CudaGraph", Yielding)
    e = _engine(tiny_model_dir)
    eager = _engine(tiny_model_dir, graphs=False)
    imgs = [np.random.default_rng(20 + i).integers(0, 256, (24, 40, 3), np.uint8) for i in range(6)]
    want = [eager.process(im) for im in imgs]
    got, errors = {}, []

    def work(i):
        try:
            for j in range(i, len(imgs), 4):
                got[j] = e.process(imgs[j])
        except Exception as ex:  # recorded, asserted below
            errors.append(ex)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    for j, w in enumerate(want):
        np.testing.assert_array_equal(got[j], w)


def test_fetch(tiny_model_dir, stand_in):
    """fetch of a CPU engine's buffer is today's ``.cpu().numpy()``; a host
    array passes through; the done event rides on the stack's base."""
    e = _engine(tiny_model_dir)
    img = np.random.default_rng(7).integers(0, 256, (20, 24, 3), np.uint8)
    buf = e.process_device(img)
    np.testing.assert_array_equal(e.fetch(buf), buf.cpu().numpy())
    host = np.ones((4, 4, 3), np.uint8)
    assert e.fetch(host) is host
    stack = torch.zeros((2, 3))
    assert engine_mod.done_event(stack[1]) is None
    stack._realsr_done = "event"
    assert engine_mod.done_event(stack[1]) == engine_mod.done_event(stack) == "event"


@pytest.fixture(scope="module")
def jax_engine(tiny_model_dir):
    j = JaxRealSR(gpuid=-1, config=JaxConfig(tilesize=16, storage="float32", compilation_cache=False))
    j.load(*_files(tiny_model_dir))
    return j


def test_progress_fractions_unchanged(tiny_model_dir, jax_engine, stand_in):
    """The fence's fractions: the same through the table as eagerly, and
    the JAX engine's, one per chunk, ending at 1."""
    img = np.random.default_rng(8).integers(0, 256, (40, 44, 3), np.uint8)
    runs = {}
    for label, e in (("graphs", _engine(tiny_model_dir)), ("eager", _engine(tiny_model_dir, graphs=False)),
                     ("jax", jax_engine)):
        runs[label] = []
        e.process(img, progress_cb=runs[label].append)
    assert runs["graphs"] == runs["eager"] == pytest.approx(runs["jax"])
    assert len(runs["graphs"]) > 1 and runs["graphs"][-1] == pytest.approx(1.0)


@pytest.mark.parametrize("shape", [(37, 45, 3), (23, 19, 4)])
def test_graph_slice_matches_jax(tiny_model_dir, jax_engine, shape, stand_in):
    """The slice as a whole: the port through the table (precompiled, so
    every chunk replays) against the JAX package's process on the same
    input and weights (the engine tests' tolerance: u8 >= 99.9 % equal,
    max diff 1)."""
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, np.uint8)
    e = _engine(tiny_model_dir)
    n = e.precompile(shape[1], shape[0], shape[2])
    got = e.process(img)
    captures, replays = stand_in()
    assert captures == n and replays > 0  # every chunk a replay
    want = jax_engine.process(img)
    d = np.abs(got.astype(int) - want.astype(int))
    assert got.shape == want.shape == (4 * shape[0], 4 * shape[1], shape[2])
    assert np.mean(d == 0) >= 0.999 and d.max() <= 1


@pytest.mark.parametrize(
    "storage,trunk,sched,tail,want",
    [
        ("mixed", "per_rdb", "scatter", "kernel", ("rdb_wgmma", "tail_kernel")),
        ("float32", "per_rdb", "scatter", "kernel", ("rdb_tf32", "tail_tf32")),
        ("mixed", "chained", "scatter", "kernel_hr", ("rdb_modes_wgmma", "tail_kernel")),
        ("mixed", "paired", "scatter", "kernel", ("rdb_modes_wgmma", "tail_kernel")),
        ("mixed", "per_rdb", "packed", "interleaved", ("rdb_modes_wgmma",)),
        ("float32", "chained", "scatter", "kernel", ("rdb_modes_tf32", "tail_tf32")),
        ("float32", "per_rdb", "packed", "kernel_hr", ("rdb_modes_tf32", "tail_tf32")),
        ("bfloat16", "per_rdb", "scatter", "kernel", ("rdb_wgmma", "tail_kernel")),
    ],
)
def test_kernel_sources(storage, trunk, sched, tail, want):
    """precompile builds groups of the sources the resolved forward
    launches, not of all six: the default mixed engine needs rdb_wgmma and
    tail_kernel (``kernel_groups``, one group of each)."""
    dtype, op = loader.PRECISIONS[storage]
    groups = loader.kernel_groups("cuda", trunk, sched, tail, op, dtype)
    assert tuple(src for src, _ in groups) == want
    assert loader.kernel_groups("dense", "per_rdb", "scatter", "interleaved", op, dtype) == ()


@pytest.fixture(scope="module")
def cli_model_dir(tmp_path_factory):
    from realsr_tpu_torch.models.rrdbnet import RRDBNetSpec
    from realsr_tpu_torch.ncnn.synth import make_model_dir

    d = tmp_path_factory.mktemp("dispatchmodels") / "models-DF2K"
    make_model_dir(str(d), RRDBNetSpec(num_rrdb=1, nf=16, gc=8), seed=5)
    return str(d)


def _cli_png(cli_model_dir, tmp_path, name, extra=()):
    src = tmp_path / "in.png"
    if not src.exists():
        Image.fromarray(np.random.default_rng(9).integers(0, 256, (21, 27, 4), np.uint8)).save(src)
    out = tmp_path / name
    rc = cli.main(["-i", str(src), "-o", str(out), "-m", cli_model_dir, "-g", "-1", *extra])
    assert rc == 0
    return np.asarray(Image.open(out))


def test_cli_precompile(cli_model_dir, tmp_path, monkeypatch, capsys):
    """REALSR_TPU_PRECOMPILE=1 -v says how many programs the first image's
    shape needs and writes the PNG it writes without."""
    plain = _cli_png(cli_model_dir, tmp_path, "plain.png")
    capsys.readouterr()
    monkeypatch.setenv("REALSR_TPU_PRECOMPILE", "1")
    got = _cli_png(cli_model_dir, tmp_path, "pre.png", ["-v"])
    err = capsys.readouterr().err
    e = RealSR(gpuid=-1, config=EngineConfig(prepadding=10))
    e.load(os.path.join(cli_model_dir, "x4.param"), os.path.join(cli_model_dir, "x4.bin"))
    assert f"precompiled {len(e.program_keys(27, 21, 4))} programs for 27x21" in err
    np.testing.assert_array_equal(got, plain)


def test_cli_precompile_failure_is_skipped(cli_model_dir, tmp_path, monkeypatch, capsys):
    """A precompile that raises prints "precompile skipped:" and the run
    goes on to write the same PNG."""
    plain = _cli_png(cli_model_dir, tmp_path, "plain.png")

    def boom(self, *a, **kw):
        raise RuntimeError("no programs today")

    monkeypatch.setattr(RealSR, "precompile", boom)
    monkeypatch.setenv("REALSR_TPU_PRECOMPILE", "1")
    capsys.readouterr()
    got = _cli_png(cli_model_dir, tmp_path, "pre.png")
    assert "precompile skipped: no programs today" in capsys.readouterr().err
    np.testing.assert_array_equal(got, plain)


def test_bridge_warmup_returns_the_engines_total(tiny_model_dir, tmp_path, monkeypatch):
    """warmup calls each engine's precompile for the first image (and the
    image-batch stack) and returns their total; a mesh engine aliased to
    every slot counts once; a missing file returns 0 without raising."""
    import json

    saved = nb._engines
    src = tmp_path / "first.png"
    Image.fromarray(np.zeros((30, 26, 3), np.uint8)).save(src)
    cfg = {"gpuid": [-1, -1], "tilesize": [16, 16], "jobs_proc": [1, 1], "prepadding": 10,
           "tta_mode": False, "parampath": _files(tiny_model_dir)[0], "modelpath": _files(tiny_model_dir)[1]}
    try:
        nb.init(json.dumps(cfg))
        one = nb._engines[0].program_keys(26, 30)
        assert len(nb._engines) == 2 and nb.warmup(str(src)) == 2 * len(one)
        monkeypatch.setenv("REALSR_TPU_IMAGE_BATCH", "4")
        stack = nb._engines[0].program_keys(26, 30, 3, 4)
        assert nb.warmup(str(src)) == 2 * (len(one) + len(stack))
        monkeypatch.delenv("REALSR_TPU_IMAGE_BATCH")
        monkeypatch.setenv("REALSR_TPU_MESH", "all")
        nb.init(json.dumps(cfg))
        assert nb._engines[0] is nb._engines[1]
        assert nb.warmup(str(src)) == len(nb._engines[0].program_keys(26, 30))
        assert nb.warmup(str(tmp_path / "missing.png")) == 0
    finally:
        nb._engines = saved
