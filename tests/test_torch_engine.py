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


def test_unported_modes_raise(engines):
    _, port = engines
    with pytest.raises(NotImplementedError, match="process_banded"):
        port.process_banded(np.zeros((8, 8, 3), np.uint8))


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
        from realsr_tpu_torch import cli
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
