"""Optional per-stage wall-clock spans: the port's own copy of
``realsr_tpu/utils/trace.py``.

``REALSR_TPU_TRACE=1`` times the spans the pipeline and the engine open
(decode, h2d+prep, dispatch, fetch(D2H), encode) and prints their totals to
stderr at process exit. The original's ``REALSR_TPU_PROFILE`` hook starts a
``jax.profiler`` trace and has no counterpart here: ``torch.profiler`` is
driven from ``chip_smoke.py`` phase 6 instead.
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
