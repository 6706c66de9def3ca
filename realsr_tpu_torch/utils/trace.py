"""Optional tracing and profiling: the port's own copy of
``realsr_tpu/utils/trace.py``. Both are off unless the environment asks.

- ``REALSR_TPU_TRACE=1`` times the spans the pipeline and the engine open
  (decode, h2d+prep, dispatch, fetch(D2H), encode) and prints their totals
  to stderr at process exit.
- ``REALSR_TPU_PROFILE=<dir>`` runs one ``torch.profiler`` session from
  the first image an engine takes (:func:`maybe_start_profiler`) to the
  process's exit, and writes it into ``<dir>`` as a Chrome trace named with
  the pid (``realsr_tpu_torch.<pid>.pt.trace.json``; open it in Perfetto or
  ``chrome://tracing``). On a card it holds every kernel, copy and CUDA
  runtime call of every thread; on any device, the Python calls of the
  threads that exist when it starts (the CLI's load, proc and save
  threads).
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import os
import sys
import threading
import time


class StageTimer:
    """Thread-safe accumulated wall-clock per named stage."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._total = collections.defaultdict(float)
        self._count = collections.defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._total[name] += dt
                self._count[name] += 1

    def report(self, file=None) -> None:
        if not self.enabled or not self._total:
            return
        file = file or sys.stderr
        print("== realsr-tpu stage timing ==", file=file)
        for name in sorted(self._total, key=lambda n: -self._total[n]):
            t, c = self._total[name], self._count[name]
            print(
                f"  {name:<12} total {t * 1e3:9.1f}ms  n={c:<5d} "
                f"avg {t / c * 1e3:8.2f}ms",
                file=file,
            )


tracer = StageTimer(enabled=os.environ.get("REALSR_TPU_TRACE", "") not in ("", "0"))
if tracer.enabled:
    atexit.register(tracer.report)

_profile_dir = os.environ.get("REALSR_TPU_PROFILE", "")
_profiler = None  # the running session's owner thread, once started
_profiler_lock = threading.Lock()


def _new_profiler(device):
    """The session: CPU activity with the Python calls of every thread, and
    CUDA activity where ``device`` is a card."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities, with_stack=True)


class _ProfilerThread(threading.Thread):
    """Owns the session: torch.profiler records the CPU ops of the thread
    that starts it and must be stopped on that thread, so one thread of its
    own starts it, waits for :meth:`finish` and stops and exports it. The
    Python tracer (``with_stack``) follows every thread, and the CUDA
    activity every stream."""

    def __init__(self, device, path: str):
        super().__init__(name="realsr-tpu-profiler", daemon=True)
        self.device, self.path = device, path
        self.started = threading.Event()
        self._finish = threading.Event()
        self.error: BaseException | None = None

    def run(self) -> None:
        try:
            prof = _new_profiler(self.device)
            prof.start()
        except BaseException as ex:  # reported by maybe_start_profiler
            self.error = ex
            self.started.set()
            return
        self.started.set()
        self._finish.wait()
        try:
            prof.stop()
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            prof.export_chrome_trace(self.path)
        except Exception as ex:  # the run's exit code stays as it was
            print(f"realsr_tpu_torch: REALSR_TPU_PROFILE: no trace written to {self.path}: {ex!r}",
                  file=sys.stderr)

    def finish(self) -> None:
        self._finish.set()
        self.join()


def maybe_start_profiler(device=None) -> None:
    """Start the ``REALSR_TPU_PROFILE`` session if the variable is set:
    once, whichever thread comes first (idempotent and thread-safe), with
    CUDA activity where ``device`` is a card; it stops and is written at
    exit. Unset, nothing is made. A session that fails to start raises."""
    global _profiler
    if not _profile_dir or _profiler is not None:
        return
    with _profiler_lock:
        if _profiler is not None:
            return
        owner = _ProfilerThread(device, os.path.join(_profile_dir, f"realsr_tpu_torch.{os.getpid()}.pt.trace.json"))
        owner.start()
        owner.started.wait()
        if owner.error is not None:
            raise owner.error
        _profiler = owner
        atexit.register(owner.finish)
