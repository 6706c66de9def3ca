"""Async host pipeline: load -> proc -> save with bounded queues.

The port's own copy of ``realsr_tpu/pipeline.py``, on the port's ``io``,
``utils/fsutils`` and ``utils/trace``. A faithful host re-implementation of the reference's 3-stage pipeline
(src/main.cpp:117-416, 793-867):

- two bounded MPMC queues of capacity 8 (backpressure bounds decoded-image
  RAM, main.cpp:141),
- ``jobs_load`` decode workers, per-device proc threads (``jobs_proc[i]``
  per accelerator, 1 for a CPU device), ``jobs_save`` encode workers,
- poison-pill shutdown with ``id == -233`` broadcast once per consumer
  (main.cpp:843-866),
- decode/encode failures print-and-continue (main.cpp:293-299, 405-412);
  alpha images destined for jpg are redirected to ``<out>.png``
  (main.cpp:279-288).

Python threads work here for the same reason the reference's do: the hot
work (codecs, kernel launches and device compute) releases the GIL. When the native C++
runtime is built, decode/encode run fully native (io.native).
"""

from __future__ import annotations

import dataclasses
import queue as _queue
import sys
import threading
from typing import List, Optional, Sequence

import numpy as np

from realsr_tpu_torch.io.codecs import decode_image, encode_image
from realsr_tpu_torch.utils.fsutils import get_file_extension
from realsr_tpu_torch.utils.trace import tracer

QUEUE_CAPACITY = 8  # main.cpp:141
POISON_ID = -233  # main.cpp:322


@dataclasses.dataclass
class Task:
    id: int
    inpath: str = ""
    outpath: str = ""
    inimage: Optional[np.ndarray] = None
    outimage: Optional[np.ndarray] = None


class TaskQueue:
    """Bounded blocking MPMC queue (main.cpp:130-174 semantics). With
    tracing on, a put that blocks on the full queue and every blocking get
    are spans named after the queue (``queue.put(<name>)``,
    ``queue.get(<name>)``) that carry the task's id: how long images
    waited between the pipeline's threads."""

    def __init__(self, capacity: int = QUEUE_CAPACITY, name: str = "queue"):
        self._q: _queue.Queue = _queue.Queue(maxsize=capacity)
        self._put_span, self._get_span = f"queue.put({name})", f"queue.get({name})"

    def put(self, task: Task) -> None:
        try:
            self._q.put_nowait(task)
        except _queue.Full:
            with tracer.span(self._put_span, task=task.id):
                self._q.put(task)

    def get(self) -> Task:
        if not tracer.enabled:
            return self._q.get()
        with tracer.span(self._get_span) as sp:
            t = self._q.get()
            sp.attrs["task"] = t.id
        return t

    def get_nowait(self) -> Optional[Task]:
        try:
            return self._q.get_nowait()
        except _queue.Empty:
            return None


def load_worker(
    files: Sequence[tuple],
    toproc: TaskQueue,
    scale: int,
) -> None:
    """Decode a slice of the file list and enqueue tasks (main.cpp:190-303)."""
    for i, inpath, outpath in files:
        with tracer.span("decode"):
            img = decode_image(inpath)
        if img is None:
            print(f"decode image {inpath} failed", file=sys.stderr)
            continue
        t = Task(id=i, inpath=inpath, outpath=outpath, inimage=img)
        ext = get_file_extension(outpath).lower()
        if img.shape[2] == 4 and ext in ("jpg", "jpeg"):
            t.outpath = outpath + ".png"
            print(
                f"image {inpath} has alpha channel ! {inpath} will output "
                f"{t.outpath}",
                file=sys.stderr,
            )
        toproc.put(t)


def proc_worker(
    engine,
    toproc: TaskQueue,
    tosave: TaskQueue,
    progress: bool,
    image_batch: int = 1,
) -> None:
    """Pop task(s), run the engine, push to save (main.cpp:311-331).

    ``image_batch > 1``: opportunistically drain up to that many ALREADY
    QUEUED same-shape images and run them as one device batch — tiles from
    all of them share the conv batches (engine.process_batch), which fills
    the device's batch granule even when each image is a single tile. Never
    waits for more input (no added latency). A drained task that cannot
    join the batch (different shape, or a poison pill) is HELD locally as
    the seed of the next iteration — never re-queued: with the bounded
    queue (cap 8) a load worker can refill the slot freed by get_nowait()
    before we put back, deadlocking producer and consumer on put().
    """
    pending: Optional[Task] = None
    while True:
        if pending is not None:
            t, pending = pending, None
        else:
            t = toproc.get()
        if t.id == POISON_ID:
            break
        batch = [t]
        # never drain more images than fit the device budget as one stack
        limit = min(
            image_batch,
            getattr(engine, "max_batch_images", lambda _s: image_batch)(
                t.inimage.shape
            ),
        )
        while limit > 1 and len(batch) < limit:
            t2 = toproc.get_nowait()
            if t2 is None:
                break
            if t2.id == POISON_ID or t2.inimage.shape != t.inimage.shape:
                pending = t2  # not ours to batch; hold for next iteration
                break
            batch.append(t2)
        oversized = getattr(engine, "needs_banding", lambda _s: False)(
            t.inimage.shape
        )
        cb = None
        if progress and (oversized or len(batch) == 1):
            # per-tile % like realsr.cpp:481; banded batches process
            # sequentially (one image per banded run), so the per-image
            # stream is accurate there too — 0..100 per image, like the
            # reference processing the same files one by one
            def cb(frac):
                print(f"{frac * 100.0:.2f}%", file=sys.stderr)
        elif progress:
            # one batched dispatch over the whole stack: a single % stream
            # cannot be attributed to one image; label the stack instead
            # of misreporting per-image progress
            def cb(frac, _n=len(batch)):
                print(f"batch of {_n}: {frac * 100.0:.2f}%", file=sys.stderr)
        # keep the result ON DEVICE: the save stage's fetch (D2H) runs on
        # the device's copy stream after this image's own "done" event, so
        # it overlaps this thread's next image's compute — the device's
        # answer to the reference's download/compute pipelining opportunity
        # its per-tile submit_and_wait forfeits (realsr.cpp:475-495).
        # Per-task failure contract: print-and-continue like the reference
        # (main.cpp:405-412) — a raising dispatch (device OOM, corrupt
        # state) must not kill this worker and strand everything queued
        # behind it, so failed tasks are dropped with a diagnostic and the
        # rest of the batch/queue keeps flowing.
        try:
            if oversized:
                # too big for a resident device buffer: band-stream each
                # image (O(band) device memory, bit-identical output);
                # results land on host — engine.fetch passes host arrays
                # through on save
                for b in batch:
                    b.outimage = (
                        engine, engine.process_banded(b.inimage, progress_cb=cb)
                    )
            elif len(batch) == 1:
                t.outimage = (engine, engine.process_device(t.inimage, progress_cb=cb))
            else:
                import numpy as _np

                stack = _np.stack([b.inimage for b in batch])
                buf = engine._process_stack_device(stack, progress_cb=cb)
                for i, b in enumerate(batch):
                    b.outimage = (engine, buf[i])
        except Exception as ex:
            for b in batch:
                if b.outimage is None:
                    print(f"process image {b.inpath} failed: {ex}", file=sys.stderr)
        for b in batch:
            b.inimage = None  # free decoded input (save frees in reference)
            if b.outimage is not None:
                tosave.put(b)


def save_worker(tosave: TaskQueue, verbose: bool) -> None:
    """Pop result, encode by extension (main.cpp:339-416).

    Failures (a raising fetch/encode as much as an encoder returning
    False) print-and-continue per image like the reference
    (main.cpp:405-412) — an exception must not kill this worker, which
    would strand every result queued behind it while the poison-pill
    accounting still lets the CLI exit silently."""
    while True:
        t = tosave.get()
        if t.id == POISON_ID:
            break
        try:
            engine, buf = t.outimage
            out = engine.fetch(buf)
            with tracer.span("encode"):
                ok = encode_image(t.outpath, out)
        except Exception as ex:
            print(f"encode image {t.outpath} failed: {ex}", file=sys.stderr)
            continue
        if ok:
            if verbose:
                print(f"{t.inpath} -> {t.outpath} done", file=sys.stderr)
        else:
            print(f"encode image {t.outpath} failed", file=sys.stderr)


def run_pipeline(
    input_files: Sequence[str],
    output_files: Sequence[str],
    engines: Sequence,  # one per device, like one RealSR per GPU (main.cpp:778)
    jobs_proc: Sequence[int],
    jobs_load: int = 1,
    jobs_save: int = 2,
    verbose: bool = False,
    progress: bool = True,
    image_batch: int = 1,
) -> None:
    toproc = TaskQueue(name="toproc")
    tosave = TaskQueue(name="tosave")

    # load: jobs_load workers over a static partition (OpenMP schedule(static,1)
    # round-robin, main.cpp:196)
    items = list(zip(range(len(input_files)), input_files, output_files))
    load_threads = []
    n_load = max(1, min(jobs_load, len(items))) if items else 0
    for k in range(n_load):
        chunk = items[k::n_load]
        th = threading.Thread(
            target=load_worker, args=(chunk, toproc, engines[0].scale)
        )
        th.start()
        load_threads.append(th)

    # proc: jobs_proc[i] threads for accelerator devices, 1 for CPU
    # (main.cpp:814-827)
    proc_threads = []
    for engine, n in zip(engines, jobs_proc):
        count = 1 if engine.device.platform == "cpu" else n
        for _ in range(count):
            th = threading.Thread(
                target=proc_worker,
                args=(engine, toproc, tosave, progress, image_batch),
            )
            th.start()
            proc_threads.append(th)

    save_threads = []
    for _ in range(max(1, jobs_save)):
        th = threading.Thread(target=save_worker, args=(tosave, verbose))
        th.start()
        save_threads.append(th)

    for th in load_threads:
        th.join()
    for _ in proc_threads:
        toproc.put(Task(id=POISON_ID))
    for th in proc_threads:
        th.join()
    for _ in save_threads:
        tosave.put(Task(id=POISON_ID))
    for th in save_threads:
        th.join()
