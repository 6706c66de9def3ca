"""The port's engine and CLI on the CPU, against the JAX package's."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from PIL import Image

from realsr_tpu.engine import EngineConfig as JaxConfig
from realsr_tpu.engine import RealSR as JaxRealSR
from realsr_tpu_torch import cli
from realsr_tpu_torch.engine import EngineConfig, RealSR

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def engines(tiny_model_dir):
    files = (os.path.join(tiny_model_dir, "x4.param"), os.path.join(tiny_model_dir, "x4.bin"))
    jax_e = JaxRealSR(
        gpuid=-1,
        config=JaxConfig(tilesize=32, storage="float32", compilation_cache=False),
    )
    jax_e.load(*files)
    port = RealSR(gpuid=-1, config=EngineConfig(tilesize=32, storage="float32"))
    port.load(*files)
    return jax_e, port


@pytest.mark.parametrize("shape", [(37, 45, 3), (23, 19, 4)])
def test_cpu_engine_matches_jax(engines, shape):
    jax_e, port = engines
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, np.uint8)
    want = jax_e.process(img)
    got = port.process(img)
    assert got.shape == want.shape == (4 * shape[0], 4 * shape[1], shape[2])
    diff = np.abs(got.astype(int) - want.astype(int))
    assert np.mean(diff == 0) >= 0.999 and diff.max() <= 1
    assert port.device.platform == "cpu" and port.variant == "dense"


def test_process_batch_matches_single_images(engines):
    _, port = engines
    imgs = np.random.default_rng(3).integers(0, 256, (3, 9, 14, 3), np.uint8)
    batch = port.process_batch(list(imgs))
    for img, out in zip(imgs, batch):
        np.testing.assert_array_equal(out, port.process(img))


@pytest.fixture(scope="module")
def cli_model_dir(tmp_path_factory):
    from realsr_tpu_torch.models.rrdbnet import RRDBNetSpec
    from realsr_tpu_torch.ncnn.synth import make_model_dir

    d = tmp_path_factory.mktemp("torchmodels") / "models-DF2K"
    make_model_dir(str(d), RRDBNetSpec(num_rrdb=1, nf=16, gc=8), seed=5)
    return str(d)


def test_cli_cpu_writes_4x_png(cli_model_dir, tmp_path):
    src, out = tmp_path / "in.png", tmp_path / "out.png"
    Image.fromarray(
        np.random.default_rng(9).integers(0, 256, (11, 13, 3), np.uint8)
    ).save(src)
    rc = cli.main(["-i", str(src), "-o", str(out), "-m", cli_model_dir, "-g", "-1"])
    assert rc == 0
    assert np.asarray(Image.open(out)).shape == (44, 52, 3)


def test_gpu_without_cuda_fails(cli_model_dir, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RealSR(gpuid=0)
    src = tmp_path / "in.png"
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(src)
    args = ["-i", str(src), "-o", str(tmp_path / "o.png"), "-m", cli_model_dir]
    assert cli.main(args) == -1
    assert "pass -g -1" in capsys.readouterr().err
    assert cli.main(args + ["-g", "0"]) == -1
    assert not (tmp_path / "o.png").exists()


def test_tf32_scoped_to_each_engines_chunks(tiny_model_dir):
    """A float32 engine's chunks run with TF32 off, a mixed engine's with it
    on, and neither loading nor running an engine changes the process's
    flags (JAX's precision is per op: one engine never moves another's
    pixels)."""
    files = (os.path.join(tiny_model_dir, "x4.param"), os.path.join(tiny_model_dir, "x4.bin"))
    flags = lambda: (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)  # noqa: E731
    saved = flags()
    seen = {}
    try:
        for start in ((True, False), (False, True)):
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = start
            for storage in ("float32", "mixed"):
                e = RealSR(gpuid=-1, config=EngineConfig(tilesize=32, storage=storage))
                e.load(*files)
                assert flags() == start
                fwd = e.bundle.forward
                e.bundle.forward = lambda p, x, fwd=fwd, s=storage: (
                    seen.setdefault(s, set()).add(flags()) or fwd(p, x)
                )
                e.process(np.zeros((9, 11, 3), np.uint8))
                assert flags() == start
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert seen == {"float32": {(False, False)}, "mixed": {(True, True)}}


def test_float16_with_kernel_variant_raises(tiny_model_dir):
    """The fused kernel has no float16 instance; asking for it raises
    rather than running plain convs in its place."""
    e = RealSR(gpuid=-1, config=EngineConfig(tilesize=32, storage="float16", variant="cuda"))
    with pytest.raises(NotImplementedError, match="no float16 instance"):
        e.load(os.path.join(tiny_model_dir, "x4.param"), os.path.join(tiny_model_dir, "x4.bin"))


def test_port_never_imports_jax(tmp_path):
    """An engine run and a CLI run on a directory (``-g -1``) import neither
    jax nor any module of the JAX package."""
    in_dir, out_dir = tmp_path / "in", tmp_path / "out"
    in_dir.mkdir()
    out_dir.mkdir()
    for name, shape in (("a.png", (9, 7, 3)), ("b.png", (6, 10, 4))):
        Image.fromarray(np.zeros(shape, np.uint8)).save(in_dir / name)
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        import realsr_tpu_torch
        from realsr_tpu_torch import cli, native_bridge
        from realsr_tpu_torch.parallel import mesh
        from realsr_tpu_torch.tiling import calibrate
        from realsr_tpu_torch.models.rrdbnet import RRDBNetSpec
        from realsr_tpu_torch.ncnn.synth import make_model_dir
        m = {str(tmp_path / "models-DF2K")!r}
        p, b = make_model_dir(m, RRDBNetSpec(num_rrdb=1, nf=16, gc=8))
        e = realsr_tpu_torch.RealSR(gpuid=-1, config=realsr_tpu_torch.EngineConfig(tilesize=32))
        e.load(p, b)
        out = e.process(np.zeros((9, 7, 4), np.uint8))
        assert out.shape == (36, 28, 4), out.shape
        rc = cli.main(["-i", {str(in_dir)!r}, "-o", {str(out_dir)!r}, "-m", m, "-g", "-1"])
        assert rc == 0, rc
        assert "jax" not in sys.modules, "the port imported jax"
        bad = sorted(n for n in sys.modules if n == "realsr_tpu" or n.startswith("realsr_tpu."))
        assert not bad, f"the port imported the JAX package: {{bad}}"
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
    assert sorted(os.listdir(out_dir)) == ["a.png", "b.png"]


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "realsr_tpu_torch")):
        files += [os.path.join(d, n) for n in sorted(names) if n.endswith(".py")]
    return sorted(os.path.relpath(f, ROOT) for f in files)


@pytest.mark.parametrize("rel", _port_sources())
def test_port_source_imports_no_jax_package(rel):
    """No statement of the port (nor of chip_smoke.py) imports jax or a
    realsr_tpu module, even one that is imported lazily inside a function."""
    import ast

    with open(os.path.join(ROOT, rel), encoding="utf-8") as f:
        tree = ast.parse(f.read(), rel)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            if top in ("jax", "jaxlib", "realsr_tpu"):
                found.append(f"{rel}:{node.lineno} imports {n}")
    assert not found, found


def test_port_native_sources_name_only_the_port():
    """The port's C++ CLI embeds Python modules of the port only, and sets
    no JAX platform; its codec library is the port's own."""
    import re

    native = os.path.join(ROOT, "realsr_tpu_torch", "native")
    with open(os.path.join(native, "cli", "main.cpp"), encoding="utf-8") as f:
        main = f.read()
    mods = re.findall(r'PyImport_ImportModule\("([^"]+)"\)', main)
    assert sorted(set(mods)) == ["realsr_tpu_torch.modelzoo", "realsr_tpu_torch.native_bridge"], mods
    assert "JAX_PLATFORMS" not in main
    with open(os.path.join(native, "CMakeLists.txt"), encoding="utf-8") as f:
        cmake = f.read()
    assert "add_library(realsr_io_torch SHARED" in cmake and "add_executable(realsr-tpu-torch" in cmake
    with open(os.path.join(native, "realsr_io.cpp"), encoding="utf-8") as f:
        assert "zs.avail_in == 0" in f.read()


@pytest.mark.parametrize("storage", ["float32", "mixed", "bfloat16", "float16"])
@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_resolve_variant(platform, storage):
    """"auto" is the kernel on a GPU except for float16, which takes plain
    convs there as the JAX engine's float16 takes its conv path; plain convs
    on the CPU; an explicit variant is kept as it is, but for the kernel
    with float16, which raises."""
    from realsr_tpu_torch.loader import resolve_forms
    from realsr_tpu_torch.models.rrdbnet import RRDBNetSpec

    spec = RRDBNetSpec(num_rrdb=1)
    want = "cuda" if platform == "gpu" and storage != "float16" else "dense"
    assert resolve_forms(spec, platform, storage).variant == want
    for explicit in ("dense", "scatter", "cuda"):
        if explicit == "cuda" and storage == "float16":
            with pytest.raises(NotImplementedError, match="no float16 instance"):
                resolve_forms(spec, platform, storage, explicit, tail="interleaved")
        else:
            assert resolve_forms(spec, platform, storage, explicit, tail="interleaved").variant == explicit


def _tf32_thread(target):
    """Run ``target`` in a daemon thread; (thread, errors it raised)."""
    import threading

    errors = []

    def run():
        try:
            target()
        except BaseException as e:  # noqa: BLE001 - reported by the test
            errors.append(e)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th, errors


@pytest.fixture
def tf32_flags():
    """The TF32 flags as (cudnn, matmul); restored after the test."""
    flags = lambda: (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)  # noqa: E731
    saved = flags()
    yield flags
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_tf32_scope_opposite_settings_wait(tf32_flags):
    """A thread that wants the other setting waits until the holder leaves,
    and each reads its own setting inside its scope (the race of two proc
    threads restoring each other's flags is gone)."""
    import threading

    from realsr_tpu_torch.models.rrdbnet import tf32

    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    a_in, a_go, b_in = threading.Event(), threading.Event(), threading.Event()
    seen = {}

    def a():
        with tf32(False):
            a_in.set()
            assert a_go.wait(10)
            seen["a"] = tf32_flags()

    def b():
        assert a_in.wait(10)
        with tf32(True):
            b_in.set()
            seen["b"] = tf32_flags()

    ta, ea = _tf32_thread(a)
    tb, eb = _tf32_thread(b)
    assert a_in.wait(10)
    assert not b_in.wait(0.3), "the second thread entered while the first held the other setting"
    a_go.set()
    ta.join(10)
    tb.join(10)
    assert not ta.is_alive() and not tb.is_alive() and not ea and not eb, (ea, eb)
    assert seen == {"a": (False, False), "b": (True, True)}
    assert tf32_flags() == (True, False)


def test_tf32_scope_same_setting_concurrent(tf32_flags):
    """Two threads with the same setting hold the scope at once: both reach
    a barrier inside their scopes, which would time out if one waited."""
    import threading

    from realsr_tpu_torch.models.rrdbnet import tf32

    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = False, True
    both = threading.Barrier(2, timeout=10)
    seen = []

    def worker():
        with tf32(True):
            both.wait()
            seen.append(tf32_flags())
            both.wait()

    threads = [_tf32_thread(worker) for _ in range(2)]
    for th, _ in threads:
        th.join(15)
    assert all(not th.is_alive() and not err for th, err in threads), [err for _, err in threads]
    assert seen == [(True, True)] * 2
    assert tf32_flags() == (False, True)


def test_tf32_scope_nests_in_one_thread(tf32_flags):
    """A thread alone nests the other setting without deadlock (chip_smoke
    holds tf32(False) around a check that enters tf32(True)), and each exit
    restores the enclosing setting, the last one the saved flags."""
    from realsr_tpu_torch.models.rrdbnet import tf32

    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    seen = []

    def nest():
        with tf32(False):
            seen.append(tf32_flags())
            with tf32(True):
                seen.append(tf32_flags())
                with tf32(True):
                    seen.append(tf32_flags())
                seen.append(tf32_flags())
            seen.append(tf32_flags())
        seen.append(tf32_flags())

    th, err = _tf32_thread(nest)
    th.join(10)
    assert not th.is_alive(), "nested tf32 scopes deadlocked"
    assert not err, err
    off, on = (False, False), (True, True)
    assert seen == [off, on, on, on, off, (True, False)]


def test_tf32_scope_stress(tf32_flags):
    """Many more threads than cores, each entering and leaving scopes of a
    random setting (some nested, with the same setting: a thread nests the
    other one only while it is the sole holder) with the interpreter
    switching threads every microsecond: inside every scope the flags are
    that scope's setting, and after the last exit the saved flags are
    back."""
    import sys
    import time

    from realsr_tpu_torch.models.rrdbnet import tf32

    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    wrong = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        for _ in range(100):
            setting = bool(rng.integers(2))
            with tf32(setting):
                if tf32_flags() != (setting, setting):
                    wrong.append((setting, tf32_flags()))
                if rng.integers(4) == 0:
                    with tf32(setting):
                        if tf32_flags() != (setting, setting):
                            wrong.append((setting, tf32_flags()))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [_tf32_thread(lambda s=s: worker(s)) for s in range(4 * (os.cpu_count() or 4))]
        deadline = time.monotonic() + 60
        for th, _ in threads:
            th.join(max(0.0, deadline - time.monotonic()))
    finally:
        sys.setswitchinterval(interval)
    assert all(not th.is_alive() and not err for th, err in threads), [err for _, err in threads if err]
    assert not wrong, wrong[:5]
    assert tf32_flags() == (True, False)


# -- how an engine's forms resolve -------------------------------------------

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
K1, K1B, K1F = ("rdb_wgmma", "f32_nf64"), ("rdb_wgmma", "bf16_nf64"), ("rdb_tf32", "f32_nf64")
KM, KMB, KMF = ("rdb_modes_wgmma", "f32_nf64"), ("rdb_modes_wgmma", "bf16_nf64"), ("rdb_modes_tf32", "f32_nf64")
K6, K7, K6F, K7F = ("tail_kernel", "k6"), ("tail_kernel", "k7"), ("tail_tf32", "k6"), ("tail_tf32", "k7")
SWIN = ("swin_kernel", "swin")


def _mixed_card(variant="cuda", tail="kernel", trunk="per_rdb", sched="scatter", groups=(K1, K6)):
    return (F32, BF16, variant, tail, trunk, sched, groups)


# (model, platform, config, environment, module flags (CHAINED_TRUNK,
# PAIRED_CARRY)) -> (storage dtype, operand dtype, variant, tail, trunk,
# sched, kernel_groups()), or (exception type, message fragment). Models:
# "rrdb" an nf 64 RRDBNet (the tail kernel's width), "rrdb16" an nf 16 one,
# "rrdb_x2" an nf 64 RRDBNet with one upsampler, "swin" Real-SwinIR-L's
# widths, "swin_tiny" a SwinIR the kernels have no instance for, "generic"
# a graph the RRDBNet matcher rejects (bilinear upsamplers).
FORM_CASES = {
    # precision and variant
    "rrdb gpu default": ("rrdb", "gpu", {}, {}, (0, 0), _mixed_card()),
    "rrdb cpu default": ("rrdb", "cpu", {}, {}, (0, 0), (F32, F32, "dense", "interleaved", "per_rdb", "scatter", ())),
    "rrdb gpu float32": ("rrdb", "gpu", dict(storage="float32"), {}, (0, 0),
                         (F32, F32, "cuda", "kernel", "per_rdb", "scatter", (K1F, K6F))),
    "rrdb gpu bfloat16": ("rrdb", "gpu", dict(storage="bfloat16"), {}, (0, 0),
                          (BF16, BF16, "cuda", "kernel", "per_rdb", "scatter", (K1B, K6))),
    "rrdb gpu float16": ("rrdb", "gpu", dict(storage="float16"), {}, (0, 0),
                         (F16, F16, "dense", "interleaved", "per_rdb", "scatter", ())),
    "rrdb gpu float16 cuda": ("rrdb", "gpu", dict(storage="float16", variant="cuda"), {}, (0, 0),
                              (NotImplementedError, "float16")),
    "rrdb cpu float16 cuda": ("rrdb", "cpu", dict(storage="float16", variant="cuda"), {}, (0, 0),
                              (NotImplementedError, "float16")),
    "rrdb gpu unknown storage": ("rrdb", "gpu", dict(storage="int8"), {}, (0, 0), (ValueError, "unknown storage")),
    "rrdb cpu mixed": ("rrdb", "cpu", dict(storage="mixed"), {}, (0, 0),
                       (F32, BF16, "dense", "interleaved", "per_rdb", "scatter", ())),
    "rrdb cpu mixed cuda": ("rrdb", "cpu", dict(storage="mixed", variant="cuda"), {}, (0, 0),
                            _mixed_card(tail="interleaved", groups=(K1,))),
    "rrdb cpu float32 auto": ("rrdb", "cpu", dict(storage="float32", variant="auto"), {}, (0, 0),
                              (F32, F32, "dense", "interleaved", "per_rdb", "scatter", ())),
    "rrdb gpu dense": ("rrdb", "gpu", dict(variant="dense"), {}, (0, 0),
                       _mixed_card("dense", "interleaved", groups=())),
    "rrdb gpu scatter": ("rrdb", "gpu", dict(variant="scatter"), {}, (0, 0),
                         _mixed_card("scatter", "interleaved", groups=())),
    "rrdb gpu unknown variant": ("rrdb", "gpu", dict(variant="xla"), {}, (0, 0), (ValueError, "unknown variant")),
    # tail
    "rrdb gpu packed tail": ("rrdb", "gpu", dict(tail="packed"), {}, (0, 0), _mixed_card(tail="packed", groups=(K1,))),
    "rrdb gpu K7 tail": ("rrdb", "gpu", dict(tail="kernel_hr"), {}, (0, 0),
                         _mixed_card(tail="kernel_hr", groups=(K1, K7))),
    "rrdb gpu interleaved tail": ("rrdb", "gpu", dict(tail="interleaved"), {}, (0, 0),
                                  _mixed_card(tail="interleaved", groups=(K1,))),
    "rrdb gpu float32 K7 tail": ("rrdb", "gpu", dict(storage="float32", tail="kernel_hr"), {}, (0, 0),
                                 (F32, F32, "cuda", "kernel_hr", "per_rdb", "scatter", (K1F, K7F))),
    "rrdb gpu unknown tail": ("rrdb", "gpu", dict(tail="fused"), {}, (0, 0), (ValueError, "unknown tail")),
    "rrdb gpu dense K6 tail": ("rrdb", "gpu", dict(variant="dense", tail="kernel"), {}, (0, 0),
                               _mixed_card("dense", "kernel", groups=(K6,))),
    "rrdb gpu float16 K6 tail": ("rrdb", "gpu", dict(storage="float16", tail="kernel"), {}, (0, 0),
                                 (NotImplementedError, "float16")),
    "rrdb16 gpu dense": ("rrdb16", "gpu", dict(variant="dense"), {}, (0, 0),
                         _mixed_card("dense", "interleaved", groups=())),
    "rrdb16 cpu K6 tail": ("rrdb16", "cpu", dict(tail="kernel"), {}, (0, 0), (ValueError, "nf=64")),
    "rrdb16 cpu K7 tail": ("rrdb16", "cpu", dict(tail="kernel_hr"), {}, (0, 0), (ValueError, "nf=64")),
    "rrdb_x2 gpu auto tail": ("rrdb_x2", "gpu", {}, {}, (0, 0), _mixed_card(tail="interleaved", groups=(K1,))),
    "rrdb_x2 cpu packed tail": ("rrdb_x2", "cpu", dict(tail="packed"), {}, (0, 0), (ValueError, "two upsamplers")),
    "rrdb_x2 cpu K6 tail": ("rrdb_x2", "cpu", dict(tail="kernel"), {}, (0, 0), (ValueError, "two upsamplers")),
    # REALSR_TPU_PACKED_TAIL
    "rrdb gpu PACKED_TAIL 0": ("rrdb", "gpu", {}, dict(REALSR_TPU_PACKED_TAIL="0"), (0, 0),
                               _mixed_card(tail="interleaved", groups=(K1,))),
    "rrdb gpu PACKED_TAIL 2": ("rrdb", "gpu", {}, dict(REALSR_TPU_PACKED_TAIL="2"), (0, 0),
                               _mixed_card(tail="kernel_hr", groups=(K1, K7))),
    "rrdb gpu PACKED_TAIL 3": ("rrdb", "gpu", {}, dict(REALSR_TPU_PACKED_TAIL="3"), (0, 0), _mixed_card()),
    "rrdb gpu PACKED_TAIL x": ("rrdb", "gpu", {}, dict(REALSR_TPU_PACKED_TAIL="x"), (0, 0),
                               _mixed_card(tail="interleaved", groups=(K1,))),
    "rrdb gpu PACKED_TAIL empty": ("rrdb", "gpu", {}, dict(REALSR_TPU_PACKED_TAIL=""), (0, 0), _mixed_card()),
    "rrdb gpu PACKED_TAIL 2 explicit tail": ("rrdb", "gpu", dict(tail="interleaved"), dict(REALSR_TPU_PACKED_TAIL="2"),
                                             (0, 0), _mixed_card(tail="interleaved", groups=(K1,))),
    "rrdb gpu dense PACKED_TAIL 3": ("rrdb", "gpu", dict(variant="dense"), dict(REALSR_TPU_PACKED_TAIL="3"), (0, 0),
                                     _mixed_card("dense", "kernel", groups=(K6,))),
    "rrdb cpu PACKED_TAIL 1": ("rrdb", "cpu", {}, dict(REALSR_TPU_PACKED_TAIL="1"), (0, 0),
                               (F32, F32, "dense", "packed", "per_rdb", "scatter", ())),
    "rrdb16 cpu PACKED_TAIL 3": ("rrdb16", "cpu", {}, dict(REALSR_TPU_PACKED_TAIL="3"), (0, 0), (ValueError, "nf=64")),
    # trunk and schedule
    "rrdb gpu chained": ("rrdb", "gpu", dict(trunk="chained"), {}, (0, 0),
                         _mixed_card(trunk="chained", groups=(KM, K6))),
    "rrdb gpu paired": ("rrdb", "gpu", dict(trunk="paired"), {}, (0, 0), _mixed_card(trunk="paired", groups=(KM, K6))),
    "rrdb gpu packed sched": ("rrdb", "gpu", dict(sched="packed"), {}, (0, 0),
                              _mixed_card(sched="packed", groups=(KM, K6))),
    "rrdb gpu float32 chained": ("rrdb", "gpu", dict(storage="float32", trunk="chained"), {}, (0, 0),
                                 (F32, F32, "cuda", "kernel", "chained", "scatter", (KMF, K6F))),
    "rrdb gpu float32 packed sched": ("rrdb", "gpu", dict(storage="float32", sched="packed"), {}, (0, 0),
                                      (F32, F32, "cuda", "kernel", "per_rdb", "packed", (KMF, K6F))),
    "rrdb gpu bfloat16 chained": ("rrdb", "gpu", dict(storage="bfloat16", trunk="chained"), {}, (0, 0),
                                  (BF16, BF16, "cuda", "kernel", "chained", "scatter", (KMB, K6))),
    "rrdb gpu chained packed": ("rrdb", "gpu", dict(trunk="chained", sched="packed"), {}, (0, 0),
                                (ValueError, "per-RDB trunk only")),
    "rrdb gpu paired float32": ("rrdb", "gpu", dict(trunk="paired", storage="float32"), {}, (0, 0),
                                (ValueError, "mixed mode only")),
    "rrdb gpu chained dense": ("rrdb", "gpu", dict(trunk="chained", variant="dense"), {}, (0, 0),
                               (ValueError, "variant 'cuda'")),
    "rrdb cpu chained": ("rrdb", "cpu", dict(trunk="chained"), {}, (0, 0), (ValueError, "variant 'cuda'")),
    "rrdb gpu unknown trunk": ("rrdb", "gpu", dict(trunk="resident"), {}, (0, 0), (ValueError, "unknown trunk")),
    "rrdb gpu unknown sched": ("rrdb", "gpu", dict(sched="k-packed"), {}, (0, 0), (ValueError, "unknown sched")),
    # REALSR_TPU_SCHED
    "rrdb gpu SCHED packed": ("rrdb", "gpu", {}, dict(REALSR_TPU_SCHED="packed"), (0, 0),
                              _mixed_card(sched="packed", groups=(KM, K6))),
    "rrdb gpu SCHED other": ("rrdb", "gpu", dict(sched="packed"), dict(REALSR_TPU_SCHED="K"), (0, 0),
                             _mixed_card(sched="packed", groups=(KM, K6))),
    "rrdb gpu dense SCHED packed": ("rrdb", "gpu", dict(variant="dense"), dict(REALSR_TPU_SCHED="packed"), (0, 0),
                                    _mixed_card("dense", "interleaved", groups=())),
    "rrdb cpu SCHED packed": ("rrdb", "cpu", {}, dict(REALSR_TPU_SCHED="packed"), (0, 0),
                              (F32, F32, "dense", "interleaved", "per_rdb", "scatter", ())),
    "rrdb gpu chained SCHED packed": ("rrdb", "gpu", dict(trunk="chained"), dict(REALSR_TPU_SCHED="packed"), (0, 0),
                                      (ValueError, "per-RDB trunk only")),
    # the module flags
    "rrdb gpu CHAINED_TRUNK": ("rrdb", "gpu", {}, {}, (1, 0), _mixed_card(trunk="chained", groups=(KM, K6))),
    "rrdb gpu PAIRED_CARRY": ("rrdb", "gpu", {}, {}, (0, 1), _mixed_card(trunk="paired", groups=(KM, K6))),
    "rrdb gpu both flags": ("rrdb", "gpu", {}, {}, (1, 1), _mixed_card(trunk="chained", groups=(KM, K6))),
    "rrdb gpu float32 PAIRED_CARRY": ("rrdb", "gpu", dict(storage="float32"), {}, (0, 1),
                                      (F32, F32, "cuda", "kernel", "per_rdb", "scatter", (K1F, K6F))),
    "rrdb gpu explicit trunk CHAINED_TRUNK": ("rrdb", "gpu", dict(trunk="per_rdb"), {}, (1, 0), _mixed_card()),
    "rrdb cpu CHAINED_TRUNK": ("rrdb", "cpu", {}, {}, (1, 0),
                               (F32, F32, "dense", "interleaved", "per_rdb", "scatter", ())),
    "rrdb gpu CHAINED_TRUNK SCHED packed": ("rrdb", "gpu", {}, dict(REALSR_TPU_SCHED="packed"), (1, 0),
                                            (ValueError, "per-RDB trunk only")),
    # SwinIR
    "swin gpu default": ("swin", "gpu", {}, {}, (0, 0), (F32, BF16, "cuda", "kernel", None, None, (SWIN, K6))),
    "swin cpu default": ("swin", "cpu", {}, {}, (0, 0), (F32, F32, "dense", "interleaved", None, None, ())),
    "swin gpu float32": ("swin", "gpu", dict(storage="float32"), {}, (0, 0), (ValueError, "mixed precision")),
    "swin gpu bfloat16": ("swin", "gpu", dict(storage="bfloat16"), {}, (0, 0), (ValueError, "mixed precision")),
    "swin gpu float16": ("swin", "gpu", dict(storage="float16"), {}, (0, 0), (ValueError, "on its kernels only")),
    "swin gpu float16 cuda": ("swin", "gpu", dict(storage="float16", variant="cuda"), {}, (0, 0),
                              (NotImplementedError, "float16")),
    "swin gpu dense": ("swin", "gpu", dict(variant="dense"), {}, (0, 0), (ValueError, "on its kernels only")),
    "swin gpu interleaved tail": ("swin", "gpu", dict(tail="interleaved"), {}, (0, 0),
                                  (F32, BF16, "cuda", "interleaved", None, None, (SWIN,))),
    "swin gpu packed tail": ("swin", "gpu", dict(tail="packed"), {}, (0, 0), (ValueError, "SwinIR runs the tails")),
    "swin gpu PACKED_TAIL 0": ("swin", "gpu", {}, dict(REALSR_TPU_PACKED_TAIL="0"), (0, 0),
                               (F32, BF16, "cuda", "interleaved", None, None, (SWIN,))),
    "swin gpu PACKED_TAIL 2": ("swin", "gpu", {}, dict(REALSR_TPU_PACKED_TAIL="2"), (0, 0),
                               (ValueError, "SwinIR runs the tails")),
    "swin gpu trunk and flags": ("swin", "gpu", dict(trunk="chained"), dict(REALSR_TPU_SCHED="packed"), (1, 1),
                                 (F32, BF16, "cuda", "kernel", None, None, (SWIN, K6))),
    "swin cpu mixed K6 tail": ("swin", "cpu", dict(storage="mixed", tail="kernel"), {}, (0, 0),
                               (F32, BF16, "dense", "kernel", None, None, (K6,))),
    "swin cpu float16 K6 tail": ("swin", "cpu", dict(storage="float16", tail="kernel"), {}, (0, 0),
                                 (NotImplementedError, "float16")),
    "swin_tiny gpu default": ("swin_tiny", "gpu", {}, {}, (0, 0), (ValueError, "is built for")),
    "swin_tiny cpu mixed cuda": ("swin_tiny", "cpu", dict(storage="mixed", variant="cuda"), {}, (0, 0),
                                 (ValueError, "is built for")),
    # the generic executor
    "generic gpu default": ("generic", "gpu", {}, {}, (0, 0), (F32, BF16, None, None, None, None, ())),
    "generic cpu default": ("generic", "cpu", {}, {}, (0, 0), (F32, F32, None, None, None, None, ())),
    "generic gpu float16": ("generic", "gpu", dict(storage="float16"), {}, (0, 0),
                            (F16, F16, None, None, None, None, ())),
    "generic gpu float16 cuda": ("generic", "gpu", dict(storage="float16", variant="cuda"), {}, (0, 0),
                                 (NotImplementedError, "float16")),
    "generic gpu forms and environment": ("generic", "gpu", dict(trunk="chained", tail="kernel"),
                                          dict(REALSR_TPU_PACKED_TAIL="2", REALSR_TPU_SCHED="packed"), (1, 0),
                                          (F32, BF16, None, None, None, None, ())),
    "generic gpu unknown storage": ("generic", "gpu", dict(storage="half"), {}, (0, 0),
                                    (ValueError, "unknown storage")),
}


@pytest.fixture(scope="module")
def form_models(tmp_path_factory, tiny_model_dir):
    """The files of each model of :data:`FORM_CASES`."""
    from realsr_tpu_torch.models import swinir as S
    from realsr_tpu_torch.models.rrdbnet import RRDBNetSpec
    from realsr_tpu_torch.ncnn.bin import write_weights
    from realsr_tpu_torch.ncnn.param import parse_param_file
    from realsr_tpu_torch.ncnn.synth import make_model_dir, make_rrdbnet_param_text, synth_weights

    root = tmp_path_factory.mktemp("forms")
    tiny = os.path.join(tiny_model_dir, "x4.param"), os.path.join(tiny_model_dir, "x4.bin")
    text = make_rrdbnet_param_text(RRDBNetSpec(num_rrdb=1, nf=16, gc=8)).replace("0=1 1=2.0 2=2.0", "0=2 1=2.0 2=2.0")
    generic = str(root / "x4.param"), str(root / "x4.bin")
    with open(generic[0], "w") as f:
        f.write(text)
    graph = parse_param_file(generic[0])
    write_weights(graph, synth_weights(graph, seed=3), generic[1])
    big = S.SwinIRSpec()
    return {
        "rrdb": make_model_dir(str(root / "nf64"), RRDBNetSpec(num_rrdb=1, nf=64, gc=32), seed=2),
        "rrdb16": tiny,
        "rrdb_x2": make_model_dir(str(root / "x2"), RRDBNetSpec(num_rrdb=1, nf=64, gc=32, num_upsample=1), seed=2),
        "swin": S.save_model(str(root / "swin"), big, {k: torch.zeros(s) for k, s in S.state_keys(big)}),
        "swin_tiny": S.save_model(str(root / "swin_tiny"), S.SwinIRSpec(depths=(2,), embed_dim=32, num_heads=(2,)),
                                  S.init_state(S.SwinIRSpec(depths=(2,), embed_dim=32, num_heads=(2,)), seed=3)),
        "generic": generic,
    }


def _form_engine(form_models, monkeypatch, model, platform, cfg, env, flags):
    """An engine of ``cfg`` on the CPU, told it runs on ``platform`` (the
    seed tool resolves a card engine's forms so on a host without a card),
    with ``env`` set over an environment without the form variables and
    the trunk flags set, and the model's files."""
    from realsr_tpu_torch.engine import Device
    from realsr_tpu_torch.models import rrdbnet as TR

    for name in ("REALSR_TPU_PACKED_TAIL", "REALSR_TPU_SCHED", "REALSR_TPU_FAST_START"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(TR, "CHAINED_TRUNK", bool(flags[0]))
    monkeypatch.setattr(TR, "PAIRED_CARRY", bool(flags[1]))
    e = RealSR(gpuid=-1, config=EngineConfig(**{"tilesize": 16, **cfg}))
    e.device = Device(platform, torch.device("cpu"))
    return e, form_models[model]


@pytest.mark.parametrize("case", list(FORM_CASES))
def test_engine_forms_resolve(case, form_models, monkeypatch):
    """The forms an engine resolves at load from its config, platform,
    environment, the trunk flags and the model's architecture: precision,
    variant, tail, trunk, schedule and the kernel groups it builds; or what
    an impossible request raises, at load or, at the latest, on the first
    image."""
    model, platform, cfg, env, flags, want = FORM_CASES[case]
    e, files = _form_engine(form_models, monkeypatch, model, platform, cfg, env, flags)
    if isinstance(want[0], type) and issubclass(want[0], Exception):
        with pytest.raises(want[0], match=want[1]):
            e.load(*files)
            e.process(np.zeros((8, 8, 3), np.uint8))
        return
    e.load(*files)
    got = (e.storage_dtype, e.op_dtype, e.variant, e.tail, e.trunk, e.sched, e.kernel_groups())
    assert got == want


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
@pytest.mark.parametrize("model", ["rrdb", "swin", "generic"])
def test_bundle_carries_the_engines_forms(model, platform, form_models, monkeypatch):
    """The forms an engine runs are its bundle's, resolved once by the
    loader: an RRDBNet has them all, SwinIR no trunk or schedule, the
    generic executor only its precision."""
    from realsr_tpu_torch.loader import Forms

    e, files = _form_engine(form_models, monkeypatch, model, platform, {}, {}, (0, 0))
    e.load(*files)
    f = e.bundle.forms
    assert f == Forms(e.storage_dtype, e.op_dtype, e.variant, e.trunk, e.sched, e.tail) and e.bundle.tail == f.tail
    want = FORM_CASES[f"{model} {platform} default"][5]
    assert (f.storage_dtype, f.op_dtype, f.variant, f.tail, f.trunk, f.sched) == want[:6]


@pytest.mark.parametrize("model,forms", [
    ("rrdb", (F32, BF16, "cuda", "kernel_hr", "chained", "scatter")),
    ("rrdb", (F32, F32, "scatter", "packed", "per_rdb", "scatter")),
    ("swin", (F32, F32, "dense", "kernel", "per_rdb", "scatter")),
    ("generic", (BF16, BF16, "cuda", "kernel", "chained", "packed")),
])
def test_load_model_takes_forms_as_given(model, forms, form_models, monkeypatch):
    """``load_model`` takes explicit forms as they are and reads neither the
    environment nor the trunk flags; a form the model has not is None."""
    from realsr_tpu_torch.loader import load_model
    from realsr_tpu_torch.models import rrdbnet as TR

    monkeypatch.setenv("REALSR_TPU_PACKED_TAIL", "1")
    monkeypatch.setenv("REALSR_TPU_SCHED", "packed")
    monkeypatch.setattr(TR, "CHAINED_TRUNK", True)
    dtype, op, variant, tail, trunk, sched = forms
    b = load_model(*form_models[model], dtype, op, variant=variant, tail=tail, trunk=trunk, sched=sched)
    f = b.forms
    got = (f.storage_dtype, f.op_dtype, f.variant, f.tail, f.trunk, f.sched)
    if model == "rrdb":
        assert got == forms
    elif model == "swin":
        assert got == (F32, F32, "dense", "kernel", None, None)
    else:
        assert got == (BF16, BF16, None, None, None, None)
