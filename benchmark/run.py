"""Run one cell of the benchmark of realsr_tpu_torch and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository's root. A cell (``BENCHMARK.json`` ``workloads``) is a
configuration (``configs/<config>.json`` and its ``.param``) under a traffic
mix (``traffic/<mix>.json``, run by ``drivers/<driver>.py``). A run makes
its weights and images from the seed, loads the model through the
program's ``RealSR.load``, warms the cell's own shapes, measures for
``--seconds``, checks the outputs against the plain reference
(``reference/``; limits in ``limits/<workload>.json``) and prints, as the
last line of standard output, one JSON object: the end-to-end metrics, or
with ``--trace 1`` the per-layer ones (``metrics/<metric>.py``) read from a
``torch.profiler`` profile over the window and the program's spans.

A run needs as many CUDA cards as its cell names; without them it exits 3
and prints no result. It never falls back to the CPU. Kernels build into
``benchmark/_build`` (a fixed directory of the checkout, so a warm run
loads them); the model file goes to a directory of ``TMPDIR``, removed at
exit.
"""

from __future__ import annotations

import os
import sys
import time


def _process_age() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()
BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import tempfile  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "realsr_tpu")


class NoCard(RuntimeError):
    pass


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def load_spec(root: str = BENCH) -> dict:
    with open(os.path.join(os.path.dirname(root), "BENCHMARK.json")) as f:
        return json.load(f)


def cell_of(spec: dict, workload: str) -> tuple:
    """(workload entry, config entry) of a cell by name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    config = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    return cell, config


def load_config(root: str, entry: dict) -> dict:
    """The configuration file, with its .param's text and conv list."""
    from benchmark.ncnn import macs_per_input_px, parse_convs

    path = os.path.join(os.path.dirname(root), entry["file"])
    with open(path) as f:
        cfg = json.load(f)
    param = os.path.join(os.path.dirname(path), cfg["param"])
    with open(param) as f:
        text = f.read()
    cfg["param_path"] = param
    cfg["convs"] = parse_convs(text)
    cfg["macs_per_input_px"] = macs_per_input_px(cfg["convs"])
    return cfg


def reported(spec: dict, workload: str) -> tuple:
    """(end-to-end metric entries, per-layer metric entries) this cell
    reports."""
    e2e = [m for m in spec["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [
        m for m in spec["per_layer"]
        if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)
    ]
    return e2e, layer


def _module(root: str, folder: str, name: str):
    """``<root>/<folder>/<name>.py`` as a module (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"benchmark_{folder}_{name}", os.path.join(root, folder, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metric(root: str, name: str, records: dict):
    """``metrics/<name>.py``'s ``read(records)``: a number, or None where
    it finds nothing to read."""
    return _module(root, "metrics", name).read(records)


class Context:
    """What a driver gets: the cell's configuration and mix, the run's
    window and cards, a work directory, the model files, the images, the
    seed's generator for drawing the check's samples, and where to note its
    set-up phases."""

    def __init__(self, cfg, mix, seconds, devices, workdir, phases, sample_rng):
        self.cfg, self.mix, self.seconds, self.devices, self.workdir = cfg, mix, seconds, devices, workdir
        self.phases, self.sample_rng = phases, sample_rng
        self.param_path = self.bin_path = None
        self.images = []

    def phase(self, name: str, t0: float) -> float:
        now = time.perf_counter()
        self.phases[name] = self.phases.get(name, 0.0) + now - t0
        return now

    def make_engine(self, storage: str = None):
        """The program's engine as its CLI makes one: the configuration's
        tile, halo and precision (``storage`` puts another of the program's
        storage modes in its place); a mesh over the cell's cards where the
        mix asks for one."""
        from realsr_tpu_torch.engine import EngineConfig, RealSR
        from realsr_tpu_torch.parallel.mesh import make_mesh

        cfg = EngineConfig(tilesize=self.cfg["tilesize"], prepadding=self.cfg["prepadding"],
                           storage=storage or self.cfg["storage"])
        mesh = make_mesh(self.devices) if self.mix.get("mesh") else None
        dev = self.devices[0]
        engine = RealSR(gpuid=dev.index if dev.type == "cuda" else -1, config=cfg, mesh=mesh)
        engine.load(self.param_path, self.bin_path)
        return engine


def cards(chips: int) -> list:
    """The cell's cards; raises :class:`NoCard` where there are fewer."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise NoCard(f"the cell needs {chips} CUDA card(s); this host has {n}")
    return [torch.device("cuda", i) for i in range(chips)]


def _span_totals() -> dict:
    from realsr_tpu_torch.utils.trace import tracer

    return {k: (tracer._total[k], tracer._count[k]) for k in list(tracer._total)}


def _check_rows(records: dict, cfg: dict) -> None:
    """Say on stderr where the trace lacks rows: every chunk runs one tail
    kernel (K6) and one trunk kernel (K1) a dense block. torch.profiler has
    been seen to drop rows of a graph replay late in a process."""
    names = [n for _, n, _ in records["device"]["kernels"]]
    k1 = sum("rdb_kernel" in n for n in names)
    k6 = sum("tail_kernel" in n for n in names)
    blocks = 3 * cfg["num_rrdb"]
    if k1 != blocks * k6 or k6 < len(records["done"]):
        print(f"benchmark: the trace holds {k1} trunk and {k6} tail kernel rows for {len(records['done'])} "
              f"images: {blocks} trunk rows a tail row and a tail row an image at least were expected",
              file=sys.stderr)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, root: str = BENCH, devices=None,
             control: bool = False) -> dict:
    """One run of a cell; returns the result object. ``devices`` None takes
    the cell's cards (and raises :class:`NoCard` without them); a test
    passes CPU devices to drive the rest of a run. ``control`` also runs,
    on the same samples and after the program's state is freed, each
    control in the program's place (:data:`CONTROLS`): its numbers go under
    ``"control"``, by the control's name."""
    import numpy as np
    import torch

    from benchmark import compare, devtrace
    from benchmark.ncnn import write_bin
    from benchmark.roofline import power_limit
    from benchmark.reference.rrdbnet import no_tf32
    from benchmark.reference.tiling import upscale
    from benchmark.traffic import load_mix, make_images
    from benchmark.weights import numpy_rng, split, trained_weights, STREAM_SAMPLE

    spec = load_spec(root)
    cell, centry = cell_of(spec, workload)
    phases: dict = {}
    t = time.perf_counter()
    phases["import"] = t - T_START
    if devices is None:
        devices = cards(cell["chips"])
    for d in devices:
        torch.empty(1, device=d)
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    t = time.perf_counter()
    phases["cuda_init"] = t - T_START - phases["import"]
    cfg = load_config(root, centry)
    mix = load_mix(root, cell["traffic"])
    limits = compare.load_limits(root, workload)
    workdir = tempfile.mkdtemp(prefix="realsr-bench-", dir=os.environ.get("TMPDIR") or None)
    ctx = Context(cfg, mix, seconds, devices, workdir, phases, numpy_rng(seed, STREAM_SAMPLE))
    try:
        weights, biases = trained_weights(cfg["convs"], seed, devices[0], cfg["num_rrdb"])
        ctx.param_path = cfg["param_path"]
        ctx.bin_path = os.path.join(workdir, "model.bin")
        write_bin(ctx.bin_path, cfg["convs"], weights.cpu().numpy(), biases.cpu().numpy())
        t = ctx.phase("weights", t)
        ctx.images = make_images(mix, seed, devices[0])
        t = ctx.phase("inputs", t)
        driver = _module(root, "drivers", mix["driver"])
        state = driver.setup(ctx)
        spans0 = _span_totals()
        setup_s = time.perf_counter() - T_START
        with devtrace.traced(trace) as prof:
            res = driver.window(ctx, state)
        spans1 = _span_totals()
        peak = max((torch.cuda.max_memory_allocated(d) for d in devices if d.type == "cuda"), default=0)
        pairs = driver.sample(ctx, state, res)
        del state
        gc.collect()
        if devices[0].type == "cuda":
            torch.cuda.empty_cache()
        records = {
            "config": cfg, "workload": workload, "chips": len(devices), "window_s": res["window_s"],
            "done": res["done"], "latencies_ms": res.get("latencies_ms"),
            "spans": {k: [v[0] - spans0.get(k, (0, 0))[0], v[1] - spans0.get(k, (0, 0))[1]]
                      for k, v in spans1.items() if v[1] > spans0.get(k, (0, 0))[1]},
            "device": devtrace.read(prof, devices) if prof is not None else None,
        }
        if prof is not None:
            from realsr_tpu_torch.utils.trace import tracer

            _check_rows(records, cfg)
            tracer._total.clear()  # its report at exit would come after the check's lines
        t_ref = time.perf_counter()
        layers = split(cfg["convs"], weights, biases)
        with no_tf32():
            want = [upscale(img, layers, cfg["num_rrdb"], cfg["num_upsample"], cfg["tilesize"], cfg["prepadding"],
                            devices[0]) for img, _ in pairs]
        numbers = compare.gaps([(got, w) for (_, got), w in zip(pairs, want)])
        ref_s = time.perf_counter() - t_ref
        if control:
            control_numbers = {name: compare.gaps(list(zip(fn(ctx, layers, [img for img, _ in pairs]), want)))
                               for name, fn in CONTROLS.items()}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    correct, check = compare.judge(numbers, limits, res["failed"])
    e2e, layer = reported(spec, workload)
    metrics = {}
    if trace:
        for m in layer:
            v = read_metric(root, m["name"], records)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s, "output_mp_per_s": res["output_mp"] / res["window_s"]}
        if res.get("latencies_ms"):
            lat = res["latencies_ms"]
            values["image_ms_p50"] = statistics.median(lat)
            values["image_ms_p95"] = float(np.percentile(lat, 95))
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev0 = devices[0]
    result = {
        "correct": correct, "attempted": res["attempted"], "failed": res["failed"], "metrics": metrics,
        "device": {"platform": "gpu" if dev0.type == "cuda" else dev0.type,
                   "kind": torch.cuda.get_device_name(dev0) if dev0.type == "cuda" else dev0.type,
                   "count": len(devices), "memory_peak_bytes": peak},
    }
    if records["device"] is not None:
        dv = records["device"]
        result["device"]["busy_s"] = sum(dv["busy_s"].values()) / len(dv["busy_s"])
        result["device"]["window_s"] = dv["window_s"]
        result["breakdown"] = {"device_ops": dv["device_ops"], "idle_gaps": dv["idle_gaps"]}
    result["setup_split"] = dict(phases)
    result["info"] = {"window_s": res["window_s"], "requests": res["attempted"], "reference_s": ref_s,
                      "samples": len(pairs), "gaps": numbers, **res.get("info", {})}
    if dev0.type == "cuda":
        result["info"]["cards"] = power_limit()
    if records["device"] is not None:
        dv = records["device"]
        kernel_s = {d: 0.0 for d in dv["busy_s"]}
        for d, _, sec in dv["kernels"]:
            kernel_s[d] += sec
        result["info"].update(trace_events=dv["events"], busy_s_by_card=dv["busy_s"], kernel_s_by_card=kernel_s)
    if control:
        result["control"] = control_numbers
    result["check"] = check
    return result


def _program_bf16(ctx, layers, images) -> list:
    """The program's own path one step below the configuration's float32
    carried state: its ``bfloat16`` storage mode (bf16 state and operands)."""
    import torch

    engine = ctx.make_engine(storage="bfloat16")
    out = [engine.process(img) for img in images]
    del engine
    if ctx.devices[0].type == "cuda":
        torch.cuda.empty_cache()
    return out


def _reference_fp8(ctx, layers, images) -> list:
    """The reference with every conv's input and weights in float8 e4m3, the
    step below the configuration's bf16 operands."""
    from benchmark.reference.rrdbnet import fp8, no_tf32
    from benchmark.reference.tiling import upscale

    cfg = ctx.cfg
    with no_tf32():
        return [upscale(img, layers, cfg["num_rrdb"], cfg["num_upsample"], cfg["tilesize"], cfg["prepadding"],
                        ctx.devices[0], quant=fp8) for img in images]


CONTROLS = {"program_bf16": _program_bf16, "reference_fp8": _reference_fp8}
# the control whose readings set the upper ends of the limits; the
# program's bf16 storage reads like the program itself by every number
# (PERF.md, the limits' readings)
CONTROL = "reference_fp8"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for k in [k for k in os.environ if k.startswith("REALSR_TPU")]:
        del os.environ[k]  # the program's switches: the cell states its settings
    os.environ["REALSR_TPU_TORCH_BUILD"] = os.path.join(BENCH, "_build")
    if args.trace:
        os.environ["REALSR_TPU_TRACE"] = "1"
    import realsr_tpu_torch.engine  # noqa: F401  (the program; its import counts as set-up)

    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except NoCard as ex:
        print(f"benchmark: {ex}", file=sys.stderr)
        return 3
    found = forbidden_modules()
    if found:
        print(f"benchmark: modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 4
    print(f"benchmark: set-up {json.dumps(result['setup_split'])}; {json.dumps(result['info'])}", file=sys.stderr)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(f"check correct {str(result['correct']).lower()}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
