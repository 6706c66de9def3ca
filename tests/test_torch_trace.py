"""``REALSR_TPU_PROFILE`` in the port (``utils/trace.py::maybe_start_profiler``)
on the CPU: the CLI writes a torch.profiler trace that parses, nothing is
made while the variable is unset, two threads start one session, and a
failed export leaves the run alone. The counterpart of the JAX package's
``tests/test_trace.py::test_cli_profile_env_writes_trace``."""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from realsr_tpu_torch.ncnn.synth import make_model_dir
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
