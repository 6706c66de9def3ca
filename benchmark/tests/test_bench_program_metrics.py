"""The readers of the program's own counters and device times
(``engine.useful_tile_pct``, ``engine.graph_replay_pct``,
``engine.chunk_device_ms``, ``mesh.merge_ms``) on recorded window deltas,
None where the program recorded none of theirs, and a traced CPU run of a
tiny cell with the program's tracing on."""

from __future__ import annotations

import pytest

from benchmark import run
from conftest import BENCH, make_root

NEW = ("engine.useful_tile_pct", "engine.graph_replay_pct", "engine.chunk_device_ms", "mesh.merge_ms")


def _records(spans):
    return {"spans": spans, "device": None, "done": [], "window_s": 1.0}


def test_readers_on_window_deltas():
    spans = {
        "h2d+prep": [0.01, 10], "dispatch": [0.02, 20],
        "tiles.real": [0.0, 120], "tiles.run": [0.0, 160],
        "chunks.replayed": [0.0, 18], "chunks.captured": [0.0, 1], "chunks.eager": [0.0, 1],
        "chunk.device": [1.6, 20], "merge.device": [0.02, 10],
    }
    got = {name: run.read_metric(BENCH, name, _records(spans)) for name in NEW}
    assert got == pytest.approx({"engine.useful_tile_pct": 75.0, "engine.graph_replay_pct": 90.0,
                                 "engine.chunk_device_ms": 80.0, "mesh.merge_ms": 2.0})
    # a window with replays only reads 100; one with eager chunks only, 0
    assert run.read_metric(BENCH, "engine.graph_replay_pct", _records({"chunks.replayed": [0.0, 4]})) == 100.0
    assert run.read_metric(BENCH, "engine.graph_replay_pct", _records({"chunks.eager": [0.0, 4]})) == 0.0


@pytest.mark.parametrize("name", NEW)
def test_readers_find_nothing(name):
    """A program without the counters (the parent of the change that added
    them) or a window without the entries: None, not an error."""
    assert run.read_metric(BENCH, name, _records({})) is None
    assert run.read_metric(BENCH, name, _records({"h2d+prep": [0.01, 10], "dispatch": [0.02, 20]})) is None


def test_entries_name_their_cells():
    spec = run.load_spec(BENCH)
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert m["source"] == "program_span" and m["workloads"]
        for cell in m["workloads"]:
            assert name in {x["name"] for x in run.reported(spec, cell)[1]}
    assert entries["mesh.merge_ms"]["workloads"] == ["df2k-x4.mesh4-photo-2048x1024"]


def test_traced_cpu_run_reads_the_programs_counters(tmp_path, cpu_run, monkeypatch):
    """The tiny cell traced on the CPU, on a mesh of two shards, with the
    program's tracer on: its tiles fill their chunks (72 x 40 at tile 32:
    buckets of 2, 1, 2 and 1), every chunk runs eagerly (no graphs on the
    CPU), the merge is a span, and the device times, which need a card,
    read None."""
    from realsr_tpu_torch import engine as engine_mod
    from realsr_tpu_torch.utils import trace

    on = trace.StageTimer(enabled=True)
    monkeypatch.setattr(trace, "tracer", on)
    monkeypatch.setattr(engine_mod, "tracer", on)
    r = cpu_run(make_root(tmp_path, mesh=True), trace=True, cards=2)
    assert r["correct"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert m["engine.useful_tile_pct"] == 100.0 and m["engine.graph_replay_pct"] == 0.0
    assert "engine.chunk_device_ms" not in m and "mesh.merge_ms" not in m
    assert on._count["mesh.merge"] > 0
