"""The port's native runtime (``realsr_tpu_torch/native/``): its codec library
``librealsr_io_torch.so`` and its C++ CLI ``realsr-tpu-torch``, built once
per session with cmake into a temporary directory, then run the way
``tests/test_native_io.py`` and ``tests/test_native_cli.py`` run the JAX
package's. Skipped only where cmake, a C++ compiler, a codec header or an
embeddable Python is missing."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from realsr_tpu_torch.io import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "realsr_tpu_torch", "native")


def _missing() -> list:
    missing = [t for t in ("cmake", "c++") if shutil.which(t) is None]
    for header in ("png.h", "jpeglib.h", os.path.join("webp", "decode.h")):
        if not any(os.path.isfile(os.path.join(r, header)) for r in ("/usr/include", "/usr/local/include")):
            missing.append(header)
    cfg = shutil.which("python3-config")
    if cfg is None or subprocess.run([cfg, "--embed", "--ldflags"], capture_output=True).returncode != 0:
        missing.append("python3-config --embed")
    return missing


pytestmark = pytest.mark.skipif(bool(_missing()), reason=f"cannot build the native runtime: {_missing()}")


@pytest.fixture(scope="session")
def build(tmp_path_factory):
    """The build directory, holding librealsr_io_torch.so and realsr-tpu-torch."""
    d = str(tmp_path_factory.mktemp("native_torch_build"))
    for cmd in (["cmake", "-S", SRC, "-B", d, "-DCMAKE_BUILD_TYPE=Release"], ["cmake", "--build", d, "-j", "4"]):
        r = subprocess.run(cmd, capture_output=True, text=True)
        assert r.returncode == 0, r.stdout + r.stderr
    assert os.path.isfile(os.path.join(d, "librealsr_io_torch.so"))
    assert os.path.isfile(os.path.join(d, "realsr-tpu-torch"))
    return d


@pytest.fixture
def lib(build, monkeypatch):
    """io/native.py bound to the built library for one test, its load state
    restored after (other tests of the worker keep their codec path)."""
    saved = (native._LIB, native._TRIED)
    monkeypatch.setenv("REALSR_IO_LIB", os.path.join(build, "librealsr_io_torch.so"))
    native._LIB, native._TRIED = None, False
    assert native.available()
    yield native
    native._LIB, native._TRIED = saved


def run_binary(build, args, cwd=None, extra_env=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    env.pop("REALSR_TPU_MESH", None)
    env.update(extra_env or {})
    return subprocess.run(
        [os.path.join(build, "realsr-tpu-torch")] + args, capture_output=True, text=True, env=env,
        cwd=cwd, timeout=300,
    )


def run_python_cli(args, extra_env=None):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    env.update(extra_env or {})
    return subprocess.run([sys.executable, "-m", "realsr_tpu_torch"] + args, capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=300)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A tiny model in a DF2K-named dir (the CLI keys prepadding on it)."""
    from realsr_tpu_torch.models.rrdbnet import RRDBNetSpec
    from realsr_tpu_torch.ncnn.synth import make_model_dir

    d = tmp_path_factory.mktemp("native_torch_models") / "models-DF2K"
    make_model_dir(str(d), RRDBNetSpec(num_rrdb=1, nf=16, gc=8), seed=7)
    return str(d)


def _png(path, shape, seed):
    Image.fromarray(np.random.default_rng(seed).integers(0, 256, shape, np.uint8)).save(path)


# -- the codec library (tests/test_native_io.py's cases) -----------------


def test_lib_path_is_the_ports(monkeypatch):
    """The port loads its own library, never the JAX package's."""
    assert native._lib_path().endswith(os.path.join("realsr_tpu_torch", "native", "build", "librealsr_io_torch.so"))


def test_png_roundtrip_lossless(lib, tmp_path):
    rng = np.random.default_rng(0)
    for shape, name in (((21, 17, 3), "a.png"), ((14, 19, 4), "b.png")):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        p = str(tmp_path / name)
        assert lib.encode(p, img, "png")
        np.testing.assert_array_equal(lib.decode(p), img)


def test_webp_roundtrip_lossless(lib, tmp_path):
    """webp is encoded LOSSLESS (the reference's webp_image.h:66-76); RGB
    under fully transparent pixels may be rewritten, so compare where alpha
    > 0."""
    rgba = np.random.default_rng(1).integers(0, 256, (14, 19, 4), dtype=np.uint8)
    p = str(tmp_path / "a.webp")
    assert lib.encode(p, rgba, "webp")
    back = lib.decode(p)
    np.testing.assert_array_equal(back[..., 3], rgba[..., 3])
    vis = rgba[..., 3] > 0
    np.testing.assert_array_equal(back[vis], rgba[vis])


def test_jpg_roundtrip_close(lib, tmp_path):
    yy, xx = np.mgrid[0:32, 0:32]
    rgb = np.stack([yy * 8, xx * 8, (yy + xx) * 4], axis=-1).astype(np.uint8)
    p = str(tmp_path / "a.jpg")
    assert lib.encode(p, rgb, "jpg")
    back = lib.decode(p)
    assert back.shape == rgb.shape
    assert np.abs(back.astype(int) - rgb.astype(int)).mean() < 3


def test_gray_promotion(lib, tmp_path):
    g = np.arange(64, dtype=np.uint8).reshape(8, 8)
    p = str(tmp_path / "g.png")
    Image.fromarray(g, mode="L").save(p)
    back = lib.decode(p)
    assert back.shape == (8, 8, 3)
    for ch in range(3):
        np.testing.assert_array_equal(back[..., ch], g)


def test_decode_failure_returns_none(lib, tmp_path):
    p = str(tmp_path / "junk.png")
    open(p, "wb").write(b"not an image")
    assert lib.decode(p) is None


@pytest.mark.parametrize("level", [None, "0", "6", "9"])
def test_every_png_written_decodes(lib, tmp_path, monkeypatch, level):
    """The repaired png_deflate_strip: a strip is written only when deflate
    consumed all of it, so every PNG the encoder reports as written decodes,
    by PIL and by the library, to the pixels it was given — one strip or
    many, each channel count, noise and flat images, each compression
    level."""
    if level is None:
        monkeypatch.delenv("REALSR_TPU_PNG_LEVEL", raising=False)
    else:
        monkeypatch.setenv("REALSR_TPU_PNG_LEVEL", level)
    rng = np.random.default_rng(2)
    shapes = [(1, 1, 3), (3, 700, 4), (257, 33, 1), (600, 420, 3), (1100, 300, 4)]
    for k, shape in enumerate(shapes):
        for kind in ("noise", "flat"):
            img = rng.integers(0, 256, shape, np.uint8) if kind == "noise" else np.full(shape, k * 40, np.uint8)
            p = str(tmp_path / f"{k}_{kind}.png")
            assert lib.encode(p, img, "png")
            want = np.repeat(img, 3, axis=2) if shape[2] == 1 else img
            with Image.open(p) as im:
                im.load()
                got = np.asarray(im.convert("RGBA" if shape[2] == 4 else ("L" if shape[2] == 1 else "RGB")))
            np.testing.assert_array_equal(got.reshape(img.shape), img)
            np.testing.assert_array_equal(lib.decode(p), want)


def test_png_bytes_match_the_ports_encoder(lib, tmp_path):
    """The library and the port's Python encoder (io/pngz.py) write the same
    PNG bytes: one design in two languages."""
    from realsr_tpu_torch.io import pngz

    img = np.random.default_rng(3).integers(0, 256, (150, 97, 3), np.uint8)
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    assert lib.encode(a, img, "png")
    assert pngz.encode_png(b, img)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


# -- the C++ CLI (tests/test_native_cli.py's cases) ----------------------


def test_binary_e2e_matches_python_cli(build, tmp_path, model_dir):
    """The same pixels as ``python -m realsr_tpu_torch`` on -g -1; with both
    encoding through the library, the same PNG bytes."""
    inp = tmp_path / "in.png"
    _png(inp, (20, 18, 3), 4)
    out_native, out_py = tmp_path / "native.png", tmp_path / "py.png"
    r = run_binary(build, ["-i", str(inp), "-o", str(out_native), "-m", model_dir, "-g", "-1"])
    assert r.returncode == 0, r.stderr
    rp = run_python_cli(["-i", str(inp), "-o", str(out_py), "-m", model_dir, "-g", "-1"],
                        {"REALSR_IO_LIB": os.path.join(build, "librealsr_io_torch.so")})
    assert rp.returncode == 0, rp.stderr
    a, b = np.asarray(Image.open(out_native)), np.asarray(Image.open(out_py))
    assert a.shape == (80, 72, 3)
    np.testing.assert_array_equal(a, b)
    assert out_native.read_bytes() == out_py.read_bytes()


def test_binary_invalid_gpu_id(build, tmp_path, model_dir):
    """-g 99, and on a host without CUDA -g 0 and no -g at all: "invalid
    gpu device" (the bridge's device_count is CUDA's)."""
    (tmp_path / "in.png").write_bytes(b"")
    for g in (["-g", "99"], ["-g", "0"], []):
        r = run_binary(build, ["-i", str(tmp_path / "in.png"), "-o", str(tmp_path / "o.png"), "-m", model_dir, *g])
        assert r.returncode != 0
        assert "invalid gpu device" in r.stderr, (g, r.stderr)


def test_binary_exe_relative_model_fallback(build, tmp_path, model_dir):
    """-m with a relative dir that only exists next to the binary resolves
    exe-relative (filesystem_utils.h:167-173)."""
    shutil.copytree(model_dir, os.path.join(build, "models-DF2K-testfallback"), dirs_exist_ok=True)
    inp, out = tmp_path / "in.png", tmp_path / "out.png"
    _png(inp, (12, 12, 3), 5)
    r = run_binary(build, ["-i", str(inp), "-o", str(out), "-m", "models-DF2K-testfallback", "-g", "-1"],
                   cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert out.exists()


def test_binary_image_batching_matches_singles(build, tmp_path, model_dir):
    """REALSR_TPU_IMAGE_BATCH drains same-shape queued tasks into one device
    batch (bridge process_batch_async); outputs equal the unbatched run's."""
    ind, out1, out2 = tmp_path / "in", tmp_path / "o1", tmp_path / "o2"
    for d in (ind, out1, out2):
        d.mkdir()
    for i in range(5):
        _png(ind / f"{i}.png", (14, 12, 3), 10 + i)
    base = ["-i", str(ind), "-m", model_dir, "-g", "-1"]
    r = run_binary(build, base + ["-o", str(out1)])
    assert r.returncode == 0, r.stderr
    r = run_binary(build, base + ["-o", str(out2), "-j", "1:1:1"], extra_env={"REALSR_TPU_IMAGE_BATCH": "4"})
    assert r.returncode == 0, r.stderr
    for i in range(5):
        a, b = np.asarray(Image.open(out1 / f"{i}.png")), np.asarray(Image.open(out2 / f"{i}.png"))
        d = np.abs(a.astype(int) - b.astype(int))
        assert a.shape == (56, 48, 3)
        assert d.max() <= 1 and (d > 0).mean() < 0.01


def test_binary_mesh_mode_matches_single(build, tmp_path, model_dir):
    """REALSR_TPU_MESH=all through the binary (the bridge's mesh engine; on
    -g -1 the CPU pool): the single run's pixels; a bad value fails init."""
    inp = tmp_path / "in.png"
    _png(inp, (20, 18, 3), 6)
    out1, out2 = tmp_path / "single.png", tmp_path / "mesh.png"
    r = run_binary(build, ["-i", str(inp), "-o", str(out1), "-m", model_dir, "-g", "-1"])
    assert r.returncode == 0, r.stderr
    r = run_binary(build, ["-i", str(inp), "-o", str(out2), "-m", model_dir, "-g", "-1"],
                   extra_env={"REALSR_TPU_MESH": "all"})
    assert r.returncode == 0, r.stderr
    assert out1.exists() and out2.exists(), r.stderr
    np.testing.assert_array_equal(np.asarray(Image.open(out1)), np.asarray(Image.open(out2)))
    r = run_binary(build, ["-i", str(inp), "-o", str(out2), "-m", model_dir, "-g", "-1"],
                   extra_env={"REALSR_TPU_MESH": "0,0"})
    assert r.returncode != 0 and "invalid REALSR_TPU_MESH" in r.stderr and "engine init failed" in r.stderr


def test_binary_precompile_warmup(build, tmp_path, model_dir):
    """REALSR_TPU_PRECOMPILE=1 calls the bridge's warm-up, which counts the
    chunk programs the first image runs (a CPU engine captures none);
    outputs identical to the run without it."""
    from realsr_tpu_torch.engine import EngineConfig, RealSR

    eng = RealSR(gpuid=-1, config=EngineConfig())
    eng.load(os.path.join(model_dir, "x4.param"), os.path.join(model_dir, "x4.bin"))
    n = len(eng.program_keys(12, 14, 3))
    inp = tmp_path / "in.png"
    _png(inp, (14, 12, 3), 7)
    out1, out2 = tmp_path / "lazy.png", tmp_path / "warm.png"
    r = run_binary(build, ["-i", str(inp), "-o", str(out1), "-m", model_dir, "-g", "-1"])
    assert r.returncode == 0, r.stderr
    r = run_binary(build, ["-i", str(inp), "-o", str(out2), "-m", model_dir, "-g", "-1", "-v"],
                   extra_env={"REALSR_TPU_PRECOMPILE": "1"})
    assert r.returncode == 0, r.stderr
    assert n > 0 and f"precompiled {n} programs" in r.stderr
    np.testing.assert_array_equal(np.asarray(Image.open(out1)), np.asarray(Image.open(out2)))


def test_binary_tta_flag(build, tmp_path, model_dir):
    """-x reaches the engine through the bridge config: the library's TTA
    engine's output."""
    from realsr_tpu_torch.engine import EngineConfig, RealSR

    img = np.random.default_rng(8).integers(0, 256, (10, 9, 3), dtype=np.uint8)
    inp, out = tmp_path / "in.png", tmp_path / "tta.png"
    Image.fromarray(img).save(inp)
    r = run_binary(build, ["-i", str(inp), "-o", str(out), "-m", model_dir, "-g", "-1", "-x"])
    assert r.returncode == 0, r.stderr
    eng = RealSR(gpuid=-1, tta_mode=True, config=EngineConfig())
    eng.load(model_dir + "/x4.param", model_dir + "/x4.bin")
    got = np.asarray(Image.open(out))
    assert got.shape == (40, 36, 3)
    np.testing.assert_array_equal(got, eng.process(img))


def test_binary_usage_error(build):
    r = run_binary(build, [])
    assert r.returncode != 0
    assert "Usage: realsr-tpu -i infile -o outfile" in r.stderr


def test_binary_synthesizes_missing_weights(build, tmp_path):
    """A DF2K dir with the graph but no x4.bin gets placeholder weights
    synthesized through realsr_tpu_torch.modelzoo, as in the Python CLI."""
    from realsr_tpu_torch.models.rrdbnet import RRDBNetSpec
    from realsr_tpu_torch.ncnn.synth import make_model_dir

    d = tmp_path / "models-DF2K"
    make_model_dir(str(d), RRDBNetSpec(num_rrdb=1, nf=16, gc=8), seed=7)
    os.remove(d / "x4.bin")
    inp, out = tmp_path / "in.png", tmp_path / "out.png"
    _png(inp, (12, 12, 3), 9)
    r = run_binary(build, ["-i", str(inp), "-o", str(out), "-m", str(d), "-g", "-1"])
    assert r.returncode == 0, r.stderr
    assert "placeholder weights" in r.stderr
    assert out.exists() and os.path.getsize(d / "x4.bin") > 0


def test_binary_imports_only_the_port(build, tmp_path, model_dir):
    """The binary's bridge and model lookup are realsr_tpu_torch's: a run
    with the JAX package unimportable still works."""
    shadow = tmp_path / "shadow" / "realsr_tpu"
    shadow.mkdir(parents=True)
    (shadow / "__init__.py").write_text("raise ImportError('the JAX package was imported')\n")
    inp, out = tmp_path / "in.png", tmp_path / "out.png"
    _png(inp, (8, 8, 3), 11)
    r = run_binary(build, ["-i", str(inp), "-o", str(out), "-m", model_dir, "-g", "-1"],
                   extra_env={"PYTHONPATH": os.pathsep.join([str(tmp_path / "shadow"), REPO])})
    assert r.returncode == 0, r.stderr
    assert out.exists()
