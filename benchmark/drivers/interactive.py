"""One client in a closed loop: ``RealSR.process`` on the mix's images in
turn, each call from the u8 host array to the u8 host array in hand; the
next call starts when the last returns.

The images that the check compares are drawn from the seed before set-up
(``check_samples`` of them), and only their outputs are kept: each
sampled image's last one, so the window's host memory is steady. Set-up
runs the sampled images once, and then one of them again while the others
are held: enough for every chunk key of a shape that at least two sampled
images share to be met thrice (eager, captured, replayed) and for the
pinned host blocks that the window's outputs take to exist.
"""

from __future__ import annotations

import sys
import time


def setup(ctx) -> dict:
    t = time.perf_counter()
    engine = ctx.make_engine()
    t = ctx.phase("load", t)
    n = min(ctx.mix["check_samples"], len(ctx.images))
    picks = sorted(ctx.sample_rng.choice(len(ctx.images), n, replace=False).tolist())
    last = {i: engine.process(ctx.images[i]) for i in picks}
    last[picks[0]] = engine.process(ctx.images[picks[0]])
    ctx.phase("warm", t)
    return {"engine": engine, "last": last}


def window(ctx, state) -> dict:
    engine, last, images = state["engine"], state["last"], ctx.images
    lat, done = [], []
    out_px = failed = 0
    t_start = now = time.perf_counter()
    k = 0
    while now - t_start < ctx.seconds:
        i = k % len(images)
        img = images[i]
        t0 = time.perf_counter()
        try:
            out = engine.process(img)
        except Exception as ex:  # counted; a run with a failed request is not correct
            failed += 1
            out = None
            print(f"benchmark: request {k} failed: {ex!r}", file=sys.stderr, flush=True)
        else:
            h, w = img.shape[:2]
            out_px += h * w * 4 ** ctx.cfg["num_upsample"]
            done.append((w, h))
        if i in last:
            last[i] = out
        del out
        now = time.perf_counter()
        lat.append((now - t0) * 1e3)
        k += 1
    return {"window_s": now - t_start, "attempted": k, "failed": failed, "output_mp": out_px / 1e6,
            "latencies_ms": lat, "done": done,
            "info": {"banded_images": sum(engine.needs_banding(img.shape) for img in images)}}


def sample(ctx, state, res) -> list:
    """[(input, the program's output)] of the sampled images: the last
    request of each."""
    return [(ctx.images[i], out) for i, out in state["last"].items()]
