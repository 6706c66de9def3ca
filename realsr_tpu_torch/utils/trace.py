"""The port's tracing and profiling, both off unless the environment asks.

``REALSR_TPU_TRACE=1`` turns on :data:`tracer`, which records three kinds
of entry, each under a name in one table of totals and counts:

- spans (:meth:`StageTimer.span`): the pipeline's ``decode`` and ``encode``
  and its queue waits (``queue.get(toproc)``, ``queue.get(tosave)``, and
  ``queue.put(...)`` where a put blocks on the full queue); the engine's
  ``request`` (the enqueue side of one stack or band run), ``h2d+prep``,
  ``h2d+prep(band)``, ``dispatch`` (one chunk: its card, key, real tiles and
  mode), ``chunk.capture``, ``mesh.merge``, ``fetch(D2H)`` and ``kernel
  build``. Each span is also one record of an in-memory log of at most
  :data:`SPAN_LOG_CAP` (the oldest go first): its name, start and end in
  Unix-epoch nanoseconds (the clock ``torch.profiler`` stamps), its id, its
  parent (the innermost span open on its thread), its request id, its
  thread's native id, its card where it has one, and its attributes.
- counters (:meth:`StageTimer.count`): ``tiles.real`` and ``tiles.run``
  (the chunks' tiles that are not pad duplicates, and all they run) and
  ``chunks.replayed``, ``chunks.captured`` and ``chunks.eager``: entries of
  0 seconds whose count is the value.
- device times (:meth:`StageTimer.device_timed`): ``chunk.device`` (one
  chunk, from before its gather to after its scatter, on its card's stream)
  and ``merge.device`` (a mesh's merge on its first card, with that card's
  wait for the others), from CUDA timing events that ride on the request's
  output and are read once its download has landed (``RealSR.fetch``, a
  band's landing): one count each, the card in the log.

At exit :meth:`StageTimer.report` prints the totals to stderr. While a
``torch.profiler`` session records on a span's thread, the span also opens
a ``record_function`` of its name, so the session's idle gaps can be
charged to it.

``REALSR_TPU_PROFILE=<dir>`` runs one ``torch.profiler`` session from the
first image an engine takes (:func:`maybe_start_profiler`) to the
process's exit, and writes it into ``<dir>`` as a Chrome trace named with
the pid (``realsr_tpu_torch.<pid>.pt.trace.json``; open it in Perfetto or
``chrome://tracing``). On a card it holds every kernel, copy and CUDA
runtime call of every thread; on any device, the Python calls of the
threads that exist when it starts (the CLI's load, proc and save threads).
With ``REALSR_TPU_TRACE=1`` too, the span log of every thread is added to
it as complete events on the spans' own threads.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import itertools
import json
import os
import sys
import threading
import time

SPAN_LOG_CAP = 1 << 16  # span records the log keeps
EVENT_POOL_CAP = 64  # free timing events kept per card

Record = collections.namedtuple("Record", "name start_ns end_ns id parent request thread card attrs")

_OFF = contextlib.nullcontext()


class Request:
    """One stack or band run: its id, and the device timings waiting for
    its output's download (:meth:`StageTimer.resolve`)."""

    __slots__ = ("id", "_pending", "_lock")

    def __init__(self, rid: int):
        self.id = rid
        self._pending: list = []
        self._lock = threading.Lock()

    def add(self, timing: tuple) -> None:
        with self._lock:
            self._pending.append(timing)

    def take(self) -> list:
        """The timings recorded so far, once: a second take of the same
        ones finds none."""
        with self._lock:
            out, self._pending = self._pending, []
        return out


class _Span:
    """An open span; ``attrs`` may be added to until it closes."""

    __slots__ = ("timer", "name", "attrs", "req", "card", "id", "parent", "start", "rf")

    def __init__(self, timer: "StageTimer", name: str, attrs: dict):
        self.timer, self.name, self.attrs = timer, name, attrs
        self.req = attrs.pop("request", None)
        self.card = attrs.pop("card", None)

    def __enter__(self) -> "_Span":
        stack = self.timer._stack()
        parent = stack[-1] if stack else None
        if self.req is None and parent is not None:
            self.req = parent.req
        self.parent = parent.id if parent is not None else None
        self.id = next(self.timer._ids)
        stack.append(self)
        self.start = time.time_ns()
        self.rf = _annotate(self.name)
        return self

    def __exit__(self, *exc) -> bool:
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        end = time.time_ns()
        self.timer._stack().pop()  # spans nest on their thread
        self.timer._add(self.name, self.start, end, self.id, self.parent, self.req.id if self.req else None,
                        self.card, self.attrs)
        return False


class _RequestSpan(_Span):
    """The ``request`` span: ``with`` binds its :class:`Request`."""

    __slots__ = ()

    def __enter__(self) -> Request:
        return super().__enter__().req


def _annotate(name: str):
    """An entered ``record_function(name)`` where a ``torch.profiler``
    session records on this thread, else None."""
    import torch

    if not torch._C._autograd._profiler_enabled():
        return None
    rf = torch.autograd.profiler.record_function(name)
    rf.__enter__()
    return rf


class _DeviceTimed:
    """A pair of timing events around a body on a card's current stream,
    handed to the request of the innermost open span at exit."""

    __slots__ = ("timer", "name", "device", "begin", "stream")

    def __init__(self, timer: "StageTimer", name: str, device):
        self.timer, self.name, self.device = timer, name, device

    def __enter__(self):
        import torch

        self.stream = torch.cuda.current_stream(self.device)
        self.begin = self.timer._event(self.device)
        self.begin.record(self.stream)
        return self

    def __exit__(self, *exc) -> bool:
        end = self.timer._event(self.device)
        end.record(self.stream)
        stack = self.timer._stack()
        span = stack[-1] if stack else None
        if exc[0] is None and span is not None and span.req is not None:
            span.req.add((self.name, str(self.device), span.id, span.req.id, self.begin, end))
        return False


class StageTimer:
    """Thread-safe spans, counters and device times by name (the module's
    docstring). Off (``enabled`` False), :meth:`span`, :meth:`request` and
    :meth:`device_timed` return one shared null context after one test and
    record nothing; call sites of :meth:`count` test ``enabled`` first."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._total = collections.defaultdict(float)
        self._count = collections.defaultdict(int)
        self._counters: set = set()
        self.log: collections.deque = collections.deque(maxlen=SPAN_LOG_CAP)
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._requests = itertools.count(1)
        self._pool: dict = collections.defaultdict(list)  # device -> free timing events

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _thread(self) -> int:
        """This thread's native id, read once a thread: the read is a system
        call, which took 7-125 us on a sandboxed H100 host."""
        try:
            return self._local.tid
        except AttributeError:
            self._local.tid = threading.get_native_id()
            return self._local.tid

    def span(self, name: str, **attrs):
        """A context that records ``name`` around its body. ``request`` (a
        :class:`Request`) and ``card`` are fields of the record, other
        keywords its attributes; a span without ``request`` takes its
        parent's."""
        if not self.enabled:
            return _OFF
        return _Span(self, name, attrs)

    def request(self):
        """The ``request`` span of one stack or band run, under a new
        request id; ``with`` binds its :class:`Request` (None when off)."""
        if not self.enabled:
            return _OFF
        return _RequestSpan(self, "request", {"request": Request(next(self._requests))})

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name`` (0 seconds, the count is its
        value)."""
        with self._lock:
            self._total[name] += 0.0
            self._count[name] += n
            self._counters.add(name)

    def ended(self, name: str, start_ns: int) -> float:
        """Seconds since ``start_ns`` (``time.time_ns()``), recorded as the
        span ``name`` when on: for a span whose length the caller prints
        either way."""
        end = time.time_ns()
        if self.enabled:
            stack = self._stack()
            parent = stack[-1] if stack else None
            self._add(name, start_ns, end, next(self._ids), parent.id if parent else None,
                      parent.req.id if parent and parent.req else None, None, {})
        return (end - start_ns) / 1e9

    def device_timed(self, name: str, device):
        """A context that times its body on ``device``'s current stream with
        CUDA events, kept on the innermost open span's request (parent: that
        span) until :meth:`resolve`; a null context off a card or off."""
        if not self.enabled or device.type != "cuda":
            return _OFF
        return _DeviceTimed(self, name, device)

    def resolve(self, timings: list) -> None:
        """Record device timings (:meth:`Request.take`) whose events have
        completed: the caller has seen its request's output land, which
        waited for them (an event not yet reached raises here). Each adds
        its seconds under its name, and a record at this time whose
        attribute ``device_s`` is its length; its events return to the
        pool."""
        for name, card, parent, rid, begin, end in timings:
            sec = begin.elapsed_time(end) / 1e3
            now = time.time_ns()
            self._add(name, now, now, next(self._ids), parent, rid, card, {"device_s": sec}, seconds=sec)
            with self._lock:
                for ev in (begin, end):
                    free = self._pool[card]
                    if len(free) < EVENT_POOL_CAP:
                        free.append(ev)

    def _event(self, device):
        import torch

        with self._lock:
            free = self._pool[str(device)]
            if free:
                return free.pop()
        return torch.cuda.Event(enable_timing=True)

    def _add(self, name, start, end, sid, parent, rid, card, attrs, seconds=None) -> None:
        """Log one record and add it to the totals: its length, or
        ``seconds`` for a device time."""
        rec = Record(name, start, end, sid, parent, rid, self._thread(), card, attrs)
        with self._lock:
            self._total[name] += (end - start) / 1e9 if seconds is None else seconds
            self._count[name] += 1
            self.log.append(rec)

    def records(self) -> list:
        """The span log as it stands."""
        with self._lock:
            return list(self.log)

    def report(self, file=None) -> None:
        if not self.enabled or not self._total:
            return
        file = file or sys.stderr
        print("== realsr-tpu stage timing ==", file=file)
        spans = [n for n in self._total if n not in self._counters]
        for name in sorted(spans, key=lambda n: -self._total[n]):
            t, c = self._total[name], self._count[name]
            print(
                f"  {name:<12} total {t * 1e3:9.1f}ms  n={c:<5d} "
                f"avg {t / c * 1e3:8.2f}ms",
                file=file,
            )
        for (name, card), (t, c) in sorted(device_by_card(self.records()).items()):
            print(f"  {name:<12} {card:<8} total {t * 1e3:9.1f}ms  n={c:<5d} avg {t / c * 1e3:8.2f}ms", file=file)
        for name in sorted(n for n in self._counters if n in self._total):
            print(f"  {name:<12} n={self._count[name]}", file=file)


def device_by_card(records: list) -> dict:
    """{(name, card): [seconds, count]} of the device times among
    ``records``."""
    out = collections.defaultdict(lambda: [0.0, 0])
    for r in records:
        if "device_s" in r.attrs:
            out[(r.name, r.card)][0] += r.attrs["device_s"]
            out[(r.name, r.card)][1] += 1
    return dict(out)


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


def _append_spans(path: str, records: list) -> None:
    """Append ``records`` (:meth:`StageTimer.records`) to the exported
    Chrome trace at ``path`` as complete (``"ph": "X"``) events on the
    spans' own threads of this process, on the trace's time base, with each
    span's id, parent, request, card and attributes in ``args``."""
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    for r in records:
        args = {"span id": r.id, "parent": r.parent, "request": r.request, **r.attrs}
        if r.card is not None:
            args["card"] = r.card
        trace["traceEvents"].append({
            "ph": "X", "cat": "realsr_span", "name": r.name, "pid": pid, "tid": r.thread,
            "ts": (r.start_ns - base) / 1e3, "dur": (r.end_ns - r.start_ns) / 1e3, "args": args,
        })
    with open(path, "w") as f:
        json.dump(trace, f, default=str)


class _ProfilerThread(threading.Thread):
    """Owns the session: torch.profiler records the CPU ops of the thread
    that starts it and must be stopped on that thread, so one thread of its
    own starts it, waits for :meth:`finish` and stops and exports it, with
    the span log where tracing is on. The Python tracer (``with_stack``)
    follows every thread, and the CUDA activity every stream."""

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
            if tracer.enabled:
                _append_spans(self.path, tracer.records())
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
