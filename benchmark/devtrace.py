"""The traced run's device record: one ``torch.profiler`` profile of the
benchmark's own over the measured window (CPU and CUDA activity, no
stacks, no shapes), read into what the per-layer metrics and the result's
``device`` and ``breakdown`` need.

A device operation is a kernel, copy or memset on a card; a card is busy
where one runs, and the busy time is the union of their intervals inside
the window (marked by an annotation of the benchmark's own). An idle gap is
charged to what the host was doing at its start: the innermost host event
then open on any thread (an op of the thread that started the profile, or
a CUDA runtime call of any thread), else to ``host: none traced``.
"""

from __future__ import annotations

import collections
import contextlib
import heapq
import time

import torch

MARK = "benchmark.window"
CUDA = torch.autograd.DeviceType.CUDA


@contextlib.contextmanager
def traced(enabled: bool):
    """Yields the profile (None when not ``enabled``); the window is the
    body. Margins of 50 ms on both sides keep a skew between the host's
    and the cards' clocks from cutting device records off."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    time.sleep(0.05)
    try:
        with record_function(MARK):
            yield prof
    finally:
        time.sleep(0.05)
        prof.stop()


def _kind(e) -> str:
    return str(e.activity_type()) if hasattr(e, "activity_type") else ""


def _device_op(e) -> bool:
    """A kernel, copy or memset on a card (not an annotation's span)."""
    return (e.device_type() == CUDA and e.name() != MARK and not e.is_user_annotation()
            and "annotation" not in _kind(e))


def _union(intervals: list) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def read(prof, devices: list) -> dict:
    """{"window_s", "busy_s": {card: s}, "kernels": [(card, name, s)],
    "device_ops": [[name, s]], "idle_gaps": [[host activity, s]]} of a
    finished profile; the lists of the breakdown hold the ten largest,
    summed over the cards."""
    events = list(prof.profiler.kineto_results.events())
    marks = [e for e in events if e.name() == MARK and e.device_type() != CUDA]
    w0 = marks[0].start_ns()
    w1 = w0 + marks[0].duration_ns()
    cards = [d.index for d in devices]
    ops = {d: [] for d in cards}
    kernels, host = [], []
    by_name = collections.Counter()
    kinds = collections.Counter()
    for e in events:
        kinds[f"{e.device_type()}:{_kind(e)}"] += 1
        a = e.start_ns()
        b = a + e.duration_ns()
        if _device_op(e):
            a, b = max(a, w0), min(b, w1)
            if b <= a or e.device_index() not in ops:
                continue
            ops[e.device_index()].append((a, b))
            by_name[e.name()[:96]] += (b - a) / 1e9
            if "mem" not in _kind(e).lower() and not e.name().startswith("Memcpy") and not e.name().startswith("Memset"):
                kernels.append((e.device_index(), e.name(), (b - a) / 1e9))
        elif e.device_type() != CUDA and e.name() != MARK:
            host.append((a, b, e.name()[:96]))
    busy, gaps = {}, []
    for d in cards:
        merged = _union(ops[d])
        busy[d] = sum(b - a for a, b in merged) / 1e9
        edges = [w0] + [x for iv in merged for x in iv] + [w1]
        gaps += [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy,
        "kernels": kernels,
        "device_ops": [[n, s] for n, s in by_name.most_common(10)],
        "idle_gaps": [[n, s] for n, s in _charge(gaps, host).most_common(10)],
        "events": dict(kinds),
    }


def _charge(gaps: list, host: list) -> collections.Counter:
    """Seconds of idle gaps by the innermost host event open at each gap's
    start."""
    out = collections.Counter()
    host.sort()
    open_ = []  # heap of (-start, end, name)
    k = 0
    for a, b in sorted(gaps):
        while k < len(host) and host[k][0] <= a:
            heapq.heappush(open_, (-host[k][0], host[k][1], host[k][2]))
            k += 1
        while open_ and open_[0][1] <= a:
            heapq.heappop(open_)
        out[open_[0][2] if open_ else "host: none traced"] += (b - a) / 1e9
    return out
