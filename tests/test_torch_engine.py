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
    on the CPU; an explicit variant is kept as it is."""
    from realsr_tpu_torch.engine import _PRECISION, _resolve_variant

    dtype = _PRECISION[storage][0]
    want = "cuda" if platform == "gpu" and storage != "float16" else "dense"
    assert _resolve_variant("auto", platform, dtype) == want
    for explicit in ("dense", "scatter", "cuda"):
        assert _resolve_variant(explicit, platform, dtype) == explicit


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
