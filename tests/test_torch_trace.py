"""The port's tracing on the CPU (``utils/trace.py``).

``REALSR_TPU_PROFILE`` (``maybe_start_profiler``): the CLI writes a
torch.profiler trace that parses, nothing is made while the variable is
unset, two threads start one session, and a failed export leaves the run
alone (the counterpart of the JAX package's
``tests/test_trace.py::test_cli_profile_env_writes_trace``).

``REALSR_TPU_TRACE`` (``tracer``): a span's record (fields, parent,
request, thread), a span on the profiler's clock, the switch off, the
engine's tile and chunk counters and its spans, and the CLI's spans in the
profile's Chrome trace. Device times need a card (``tests/test_torch_gpu.py``).
"""

import io
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from realsr_tpu_torch import engine as engine_mod
from realsr_tpu_torch import pipeline
from realsr_tpu_torch.engine import EngineConfig, RealSR
from realsr_tpu_torch.ncnn.synth import make_model_dir
from realsr_tpu_torch.parallel.mesh import make_mesh
from realsr_tpu_torch.tiling.planner import plan_tiles
from realsr_tpu_torch.utils import trace
from tests.conftest import TINY_SPEC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace")
    mdir = d / "m-models-DF2K"
    make_model_dir(str(mdir), TINY_SPEC, seed=0)
    img = d / "in.png"
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (20, 24, 3), np.uint8)).save(img)
    return str(mdir), str(img)


def _run_cli(mdir, img, out, **env):
    e = {k: v for k, v in os.environ.items() if k != "REALSR_TPU_PROFILE"}
    e["PYTHONPATH"] = REPO + os.pathsep + e.get("PYTHONPATH", "")
    e.update(env)
    return subprocess.run([sys.executable, "-m", "realsr_tpu_torch", "-i", img, "-o", out, "-m", mdir, "-g", "-1"],
                          capture_output=True, text=True, timeout=600, env=e, cwd=REPO)


def test_cli_profile_env_writes_trace(cli_inputs, tmp_path):
    prof = tmp_path / "prof"
    r = _run_cli(*cli_inputs, str(tmp_path / "o.png"), REALSR_TPU_PROFILE=str(prof))
    assert r.returncode == 0, r.stderr
    assert os.path.isfile(tmp_path / "o.png")
    files = os.listdir(prof)
    assert len(files) == 1 and files[0].startswith("realsr_tpu_torch.") and files[0].endswith(".pt.trace.json")
    events = json.load(open(prof / files[0]))["traceEvents"]
    assert events
    # the engine's own calls, traced on the CLI's proc thread
    assert any("_process_stack_device" in str(e.get("name")) for e in events)


def test_unset_makes_nothing(cli_inputs, tmp_path, monkeypatch):
    r = _run_cli(*cli_inputs, str(tmp_path / "o.png"))
    assert r.returncode == 0, r.stderr
    assert sorted(os.listdir(tmp_path)) == ["o.png"]
    monkeypatch.setattr(trace, "_profile_dir", "")
    monkeypatch.setattr(trace, "_profiler", None)
    trace.maybe_start_profiler(torch.device("cpu"))
    assert trace._profiler is None
    assert not any(t.name == "realsr-tpu-profiler" for t in threading.enumerate())


@pytest.fixture
def session(tmp_path, monkeypatch):
    """A fresh session's state pointed at ``tmp_path/prof``: (the finishers
    ``atexit`` would run, the count of profilers made)."""
    finishers, made = [], []
    new, register = trace._new_profiler, trace.atexit.register

    def at_exit(fn, *args, **kwargs):  # the session's finisher kept, others registered
        if isinstance(getattr(fn, "__self__", None), trace._ProfilerThread):
            return finishers.append(fn)
        return register(fn, *args, **kwargs)

    monkeypatch.setattr(trace, "_profile_dir", str(tmp_path / "prof"))
    monkeypatch.setattr(trace, "_profiler", None)
    monkeypatch.setattr(trace.atexit, "register", at_exit)
    monkeypatch.setattr(trace, "_new_profiler", lambda device: made.append(device) or new(device))
    yield finishers, made
    for finish in finishers:
        finish()


def test_two_threads_start_one_session(session, tmp_path):
    finishers, made = session
    gate = threading.Barrier(2)

    def proc():
        gate.wait()
        trace.maybe_start_profiler(torch.device("cpu"))
        torch.ones(8).add_(1)

    threads = [threading.Thread(target=proc) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    trace.maybe_start_profiler(torch.device("cpu"))
    assert len(made) == 1 and len(finishers) == 1
    assert not (tmp_path / "prof").exists()  # made at exit, not at start
    finishers.pop()()
    (name,) = os.listdir(tmp_path / "prof")
    assert name == f"realsr_tpu_torch.{os.getpid()}.pt.trace.json"
    assert json.load(open(tmp_path / "prof" / name))["traceEvents"]


def test_failed_export_prints_one_line(session, tmp_path, monkeypatch, capsys):
    finishers, _ = session
    (tmp_path / "file").write_text("")
    monkeypatch.setattr(trace, "_profile_dir", str(tmp_path / "file" / "prof"))  # under a file: no dir
    trace.maybe_start_profiler(torch.device("cpu"))
    finishers.pop()()
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and err[0].startswith("realsr_tpu_torch: REALSR_TPU_PROFILE: no trace written")


def test_cli_failed_export_keeps_exit_code(cli_inputs, tmp_path):
    (tmp_path / "file").write_text("")
    r = _run_cli(*cli_inputs, str(tmp_path / "o.png"), REALSR_TPU_PROFILE=str(tmp_path / "file" / "prof"))
    assert r.returncode == 0 and os.path.isfile(tmp_path / "o.png")
    assert len([ln for ln in r.stderr.splitlines() if "REALSR_TPU_PROFILE" in ln]) == 1


@pytest.fixture
def traced(monkeypatch):
    """A fresh tracer, on, in place of the process's in the modules that
    record into it."""
    t = trace.StageTimer(enabled=True)
    for mod in (trace, engine_mod, pipeline):
        monkeypatch.setattr(mod, "tracer", t)
    return t


def _by_name(t):
    out = {}
    for r in t.records():
        out.setdefault(r.name, []).append(r)
    return out


def test_span_record_fields_parent_and_request(traced):
    """A span's record: name, epoch start and end, id, parent (innermost
    open span of its thread), request, thread, card and attributes; a span
    given the request on another thread records under it."""
    before = time.time_ns()
    with traced.request() as req:
        with traced.span("outer", card="cuda:1", key="8x276x276") as outer:
            with traced.span("inner") as inner:
                inner.attrs["mode"] = "replay"
    after = time.time_ns()
    seen = {}

    def other():
        with traced.span("fetch(D2H)", request=req):
            seen["thread"] = threading.get_native_id()

    th = threading.Thread(target=other)
    th.start()
    th.join(timeout=30)
    assert not th.is_alive()
    r = _by_name(traced)
    (rq,), (o,), (i,), (f,) = r["request"], r["outer"], r["inner"], r["fetch(D2H)"]
    assert before <= rq.start_ns <= o.start_ns <= i.start_ns <= i.end_ns <= o.end_ns <= rq.end_ns <= after
    assert len({rq.id, o.id, i.id, f.id}) == 4 and outer.id == o.id
    assert (rq.parent, o.parent, i.parent, f.parent) == (None, rq.id, o.id, None)
    assert rq.request == o.request == i.request == f.request == req.id
    assert rq.thread == o.thread == i.thread == threading.get_native_id() != f.thread == seen["thread"]
    assert (o.card, o.attrs, i.card, i.attrs) == ("cuda:1", {"key": "8x276x276"}, None, {"mode": "replay"})
    with traced.request() as req2:
        pass
    assert req2.id != req.id
    assert traced._count["outer"] == 1 and traced._total["outer"] == pytest.approx((o.end_ns - o.start_ns) / 1e9)


def test_span_is_on_the_profilers_clock(traced):
    """Under a CPU torch.profiler session on this thread, a span opens a
    record_function of its name, and its record's start and end enclose the
    profiler's own stamps of an op opened inside it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with traced.span("outer"):
            time.sleep(0.002)
            with record_function("inner op"):
                torch.ones(64).add_(1)
            time.sleep(0.002)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    (o,) = _by_name(traced)["outer"]
    op = events["inner op"]
    assert o.start_ns <= op.start_ns() and op.start_ns() + op.duration_ns() <= o.end_ns
    assert "outer" in events  # the span's own annotation


def test_switch_off_records_nothing(tiny_model_dir, monkeypatch):
    """Off: one shared null context for every span, request and device
    timing, no record_function under a profiler session, no CUDA event, and
    an engine's run leaves the log and the tables empty."""
    off = trace.StageTimer(enabled=False)
    for mod in (trace, engine_mod, pipeline):
        monkeypatch.setattr(mod, "tracer", off)
    made = []
    monkeypatch.setattr(trace, "_annotate", lambda name: made.append(name))
    monkeypatch.setattr(off, "_event", lambda device: made.append(device))
    assert off.span("a") is off.span("b", card="x") is off.request() is off.device_timed("c", torch.device("cuda", 0))
    with off.request() as req:
        assert req is None
    e = RealSR(gpuid=-1, config=EngineConfig(tilesize=16, storage="float32"), mesh=make_mesh(["cpu"] * 2))
    e.load(os.path.join(tiny_model_dir, "x4.param"), os.path.join(tiny_model_dir, "x4.bin"))
    img = np.random.default_rng(3).integers(0, 256, (20, 40, 3), np.uint8)
    buf = e.process_device(img)
    assert not hasattr(buf, "_realsr_request")
    e.fetch(buf)
    e.process_banded(img, band_tile_rows=1)
    assert off.ended("kernel build", time.time_ns()) >= 0
    assert not made and not off.records() and not off._total and not off._count


def _expected_chunks(e, w, h, n_img=1):
    ts = e._pick_tilesize(w, h, n_img)
    plan = plan_tiles(w, h, ts, e.prepadding)
    buckets = {shape: [(i, plan.tiles[t].x0, plan.tiles[t].y0) for i in range(n_img) for t in idxs]
               for shape, idxs in plan.buckets.items()}
    return e._chunk_list(buckets, ts)


@pytest.mark.parametrize("shards", [1, 2])
def test_engine_counts_tiles_and_chunks(tiny_model_dir, traced, shards):
    """A CPU engine on an image whose chunk batch pads: ``tiles.real`` and
    ``tiles.run`` are ``_chunk_list``'s sums, every chunk counts as eager
    (no graphs on the CPU), and its dispatch span holds its card, key, real
    tiles and mode under the image's request, with the fetch on another
    thread under the same request; a mesh's merge is a span."""
    e = RealSR(gpuid=-1, config=EngineConfig(tilesize=16, storage="float32", max_batch=4),
               mesh=make_mesh(["cpu"] * shards) if shards > 1 else None)
    e.load(os.path.join(tiny_model_dir, "x4.param"), os.path.join(tiny_model_dir, "x4.bin"))
    w, h = 88, 20  # 6 x 2 tiles of 16: buckets of 5, 1, 5 and 1 tiles, a 5 as 2 chunks of 3 (one pad tile)
    chunks = _expected_chunks(e, w, h)
    real, run = sum(c[3] for c in chunks), sum(len(c[2]) for c in chunks)
    assert (real, run) == (12, 14)
    buf = e.process_device(np.random.default_rng(5).integers(0, 256, (h, w, 3), np.uint8))
    th = threading.Thread(target=e.fetch, args=(buf,))
    th.start()
    th.join(timeout=60)
    assert not th.is_alive()
    assert (traced._count["tiles.real"], traced._count["tiles.run"]) == (real, run)
    assert traced._count["chunks.eager"] == len(chunks)
    assert "chunks.replayed" not in traced._count and "chunks.captured" not in traced._count
    assert traced._total["tiles.run"] == traced._total["chunks.eager"] == 0.0
    r = _by_name(traced)
    (req,), (prep,), (fetch,) = r["request"], r["h2d+prep"], r["fetch(D2H)"]
    assert prep.parent == req.id and fetch.request == req.request and fetch.thread != req.thread
    dispatch = r["dispatch"]
    assert len(dispatch) == len(chunks)
    for d, (ph, pw, chunk, n) in zip(dispatch, chunks):
        assert d.parent == req.id and d.request == req.request and d.card == "cpu"
        assert d.attrs == {"key": f"{ph}x{pw}x{len(chunk)}", "real": n, "mode": "eager"}
    assert len(r.get("mesh.merge", [])) == (shards > 1)
    assert "chunk.device" not in traced._count  # device times need a card


class _StandInGraph:
    """The engine's graph class on the CPU: capture runs the chunk, replay
    runs it again."""

    def __init__(self, state):
        self.fn = None

    @staticmethod
    def supports(device):
        return True

    def capture(self, fn):
        fn()
        self.fn = fn

    def replay(self):
        self.fn()


def test_engine_counts_captures_and_replays(tiny_model_dir, traced, monkeypatch):
    """With the chunk program table (a stand-in graph on the CPU), an
    image's chunks run eagerly, then captured (each a ``chunk.capture``
    span), then replayed; a banded run is one request whose bands' spans
    are its children."""
    monkeypatch.setattr(engine_mod, "_CudaGraph", _StandInGraph)
    e = RealSR(gpuid=-1, config=EngineConfig(tilesize=16, storage="float32", max_batch=4))
    e.load(os.path.join(tiny_model_dir, "x4.param"), os.path.join(tiny_model_dir, "x4.bin"))
    assert e.graphs
    img = np.random.default_rng(6).integers(0, 256, (36, 56, 3), np.uint8)
    chunks = _expected_chunks(e, 56, 36)  # 5 chunks of 4 keys
    n, keys = len(chunks), len({(ph, pw, len(c)) for ph, pw, c, _ in chunks})
    for _ in range(3):
        e.process(img)
    # each key's first chunk ran eagerly and its second was captured
    assert traced._count["chunks.eager"] == traced._count["chunks.captured"] == keys < n
    assert traced._count["chunks.replayed"] == 3 * n - 2 * keys
    assert traced._count["chunk.capture"] == keys
    modes = [d.attrs["mode"] for d in _by_name(traced)["dispatch"]]
    assert modes[-n:] == ["replay"] * n
    traced.log.clear()
    e.process_banded(img, band_tile_rows=1)
    r = _by_name(traced)
    (req,) = r["request"]
    assert len(r["h2d+prep(band)"]) == 3 and all(b.parent == req.id for b in r["h2d+prep(band)"])
    assert all(d.request == req.request and d.parent == req.id for d in r["dispatch"])


def test_cli_trace_and_profile_hold_the_threads_spans(cli_inputs, tmp_path):
    """``-g -1`` with both switches: the Chrome trace holds the load
    thread's ``decode``, the proc thread's ``dispatch`` and the save
    thread's ``encode`` on their own threads, the proc thread's
    ``dispatch`` encloses its own ``_run_chunk`` Python event, the save
    thread's fetch shares the proc thread's request, and the report at
    exit prints the spans and counters."""
    prof = tmp_path / "prof"
    r = _run_cli(*cli_inputs, str(tmp_path / "o.png"), REALSR_TPU_PROFILE=str(prof), REALSR_TPU_TRACE="1")
    assert r.returncode == 0, r.stderr
    (name,) = os.listdir(prof)
    events = json.load(open(prof / name))["traceEvents"]
    spans = [e for e in events if e.get("cat") == "realsr_span"]
    by = {}
    for e in spans:
        by.setdefault(e["name"], []).append(e)
    (dec,), (enc,), (req,), (fetch,) = by["decode"], by["encode"], by["request"], by["fetch(D2H)"]
    disp = by["dispatch"]
    pids = {e["pid"] for e in events if e.get("cat") == "python_function"}
    assert disp and len(pids) == 1 and all(e["ph"] == "X" and e["pid"] in pids for e in spans)
    assert len({dec["tid"], disp[0]["tid"], enc["tid"]}) == 3
    assert all(d["tid"] == req["tid"] and d["args"]["request"] == req["args"]["request"] for d in disp)
    assert fetch["tid"] == enc["tid"] and fetch["args"]["request"] == req["args"]["request"]
    runs = [e for e in events if e.get("cat") == "python_function" and "_run_chunk" in str(e.get("name"))]
    for d in disp:
        mine = [p for p in runs if p["tid"] == d["tid"] and d["ts"] <= p["ts"] <= d["ts"] + d["dur"]]
        assert len(mine) == 1 and mine[0]["ts"] + mine[0]["dur"] <= d["ts"] + d["dur"]
    assert "== realsr-tpu stage timing ==" in r.stderr and "tiles.real" in r.stderr and "chunks.eager" in r.stderr


class _FakeEvent:
    """A timing event's host stand-in: ``elapsed_time`` in ms to another."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_device_times_resolve_by_card_and_report(traced):
    """Device timings kept on a request resolve once: each a record under
    its request and parent span with its card and ``device_s``, added to
    the totals; its events return to the pool; the report prints the
    spans, the device times by card and the counters."""
    with traced.request() as req:
        with traced.span("dispatch", card="cuda:1") as sp:
            pass
    for card, a, b in (("cuda:0", 0.0, 80.0), ("cuda:1", 5.0, 130.0), ("cuda:1", 130.0, 250.0)):
        req.add(("chunk.device", card, sp.id, req.id, _FakeEvent(a), _FakeEvent(b)))
    traced.count("tiles.run", 8)
    timings = req.take()
    assert not req.take()
    traced.resolve(timings)
    recs = [r for r in traced.records() if r.name == "chunk.device"]
    assert [r.card for r in recs] == ["cuda:0", "cuda:1", "cuda:1"]
    assert all(r.parent == sp.id and r.request == req.id for r in recs)
    assert [r.attrs["device_s"] for r in recs] == pytest.approx([0.08, 0.125, 0.12])
    assert traced._count["chunk.device"] == 3 and traced._total["chunk.device"] == pytest.approx(0.325)
    assert len(traced._pool["cuda:1"]) == 4 and traced._pool["cuda:1"][0] is timings[1][4]
    assert trace.device_by_card(traced.records()) == pytest.approx(
        {("chunk.device", "cuda:0"): [0.08, 1], ("chunk.device", "cuda:1"): [0.245, 2]})
    out = io.StringIO()
    traced.report(file=out)
    lines = out.getvalue().splitlines()
    assert lines[0] == "== realsr-tpu stage timing ==" and any("cuda:1" in ln and "n=2" in ln for ln in lines)
    assert lines[-1].split() == ["tiles.run", "n=8"]
