"""The port's own host modules against the JAX package's originals, on the CPU.

``realsr_tpu_torch`` keeps its own copies of the host-side modules it used
to import from ``realsr_tpu`` (ncnn parsing, tile planning, PNG and image
codecs, the pipeline, filesystem helpers, stage timing, the CLI's flag
helpers). Each copy must give what the original gives on the same input.
"""

import io
import os
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from realsr_tpu import cli as jax_cli
from realsr_tpu import pipeline as jax_pipeline
from realsr_tpu.io import codecs as jax_codecs
from realsr_tpu.io import pngz as jax_pngz
from realsr_tpu.ncnn import bin as jax_bin
from realsr_tpu.ncnn import param as jax_param
from realsr_tpu.tiling import planner as jax_planner
from realsr_tpu.utils import fsutils as jax_fsutils
from realsr_tpu_torch import cli
from realsr_tpu_torch import pipeline
from realsr_tpu_torch.io import codecs, pngz
from realsr_tpu_torch.ncnn import bin as nbin
from realsr_tpu_torch.ncnn import param
from realsr_tpu_torch.tiling import planner
from realsr_tpu_torch.utils import fsutils, trace

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DF2K_PARAM = os.path.join(ROOT, "models", "models-DF2K", "x4.param")


def _layers(graph):
    return [
        (l.type, l.name, list(l.inputs), list(l.outputs), dict(l.params))
        for l in graph.layers
    ]


@pytest.mark.parametrize("which", ["df2k", "tiny"])
def test_param_parse_equal(which, tiny_model_dir):
    path = DF2K_PARAM if which == "df2k" else os.path.join(tiny_model_dir, "x4.param")
    got, want = param.parse_param_file(path), jax_param.parse_param_file(path)
    assert _layers(got) == _layers(want)
    assert (got.blob_count, got.producer, got.consumers) == (
        want.blob_count, want.producer, want.consumers
    )
    assert len(got.layers) > 0


def test_bin_load_and_write_equal(tiny_model_dir, tmp_path):
    p = os.path.join(tiny_model_dir, "x4.param")
    b = os.path.join(tiny_model_dir, "x4.bin")
    got = nbin.load_weights(param.parse_param_file(p), b)
    want = jax_bin.load_weights(jax_param.parse_param_file(p), b)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].keys() == want[name].keys()
        for k in want[name]:
            np.testing.assert_array_equal(got[name][k], want[name][k])
    # and the writers emit the same bytes
    nbin.write_weights(param.parse_param_file(p), got, str(tmp_path / "a.bin"))
    jax_bin.write_weights(jax_param.parse_param_file(p), want, str(tmp_path / "b.bin"))
    assert (tmp_path / "a.bin").read_bytes() == (tmp_path / "b.bin").read_bytes()


@pytest.mark.parametrize("tilesize", [32, 64, 100, 128, 200])
def test_plan_tiles_equal(tilesize):
    for w in (1, 31, 64, 97, 300, 1024):
        for h in (1, 17, 128, 129, 768):
            for pad in (0, 10):
                got = planner.plan_tiles(w, h, tilesize, pad)
                want = jax_planner.plan_tiles(w, h, tilesize, pad)
                assert [tuple(vars(t).values()) for t in got.tiles] == [
                    tuple(vars(t).values()) for t in want.tiles
                ]
                assert got.buckets == want.buckets
                assert (got.xtiles, got.ytiles) == (want.xtiles, want.ytiles)


def test_auto_tilesize_equal():
    for mb in (0, 100, 190, 191, 550, 551, 1900, 1901, 80000):
        for cpu in (False, True):
            assert planner.auto_tilesize(mb, cpu) == jax_planner.auto_tilesize(mb, cpu)


@pytest.mark.parametrize("shape", [(1, 1, 3), (37, 45, 3), (64, 33, 4), (19, 23)])
def test_png_bytes_equal_and_roundtrip(shape, rng):
    img = rng.integers(0, 256, shape, np.uint8)
    data = pngz.encode_png_bytes(img)
    assert data == jax_pngz.encode_png_bytes(img)
    back = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(back.reshape(img.shape), img)


def test_encode_png_returns_false_on_zlib_error(tmp_path, monkeypatch):
    """A zlib failure is the image's failure, not the save worker's: the
    port's encode_png returns False, and the save stage prints it and goes
    on with the next image."""

    def boom(*_a, **_k):
        raise zlib.error("Error -2 while compressing data")

    monkeypatch.setattr(pngz, "encode_png_bytes", boom)
    img = np.zeros((4, 4, 3), np.uint8)
    assert pngz.encode_png(str(tmp_path / "x.png"), img) is False
    monkeypatch.setattr(pngz, "encode_png_bytes", lambda *_a, **_k: (_ for _ in ()).throw(MemoryError()))
    assert pngz.encode_png(str(tmp_path / "y.png"), img) is False


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_decode_image_equal(mode, tmp_path, rng):
    arr = rng.integers(0, 256, (9, 7, {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "P": 1}[mode]), np.uint8)
    im = Image.fromarray(arr[..., 0] if arr.shape[2] == 1 else arr, "L" if mode == "P" else mode)
    if mode == "P":
        im = im.convert("P")
    path = str(tmp_path / "in.png")
    im.save(path)
    got, want = codecs.decode_image(path), jax_codecs.decode_image(path)
    np.testing.assert_array_equal(got, want)
    assert got.shape[2] in (3, 4)


def test_fsutils_equal(tmp_path):
    for name in ("b.png", "a.jpg", "c", ".hidden.webp"):
        (tmp_path / name).write_bytes(b"")
    (tmp_path / "sub").mkdir()
    d = str(tmp_path)
    assert fsutils.list_directory(d) == jax_fsutils.list_directory(d)
    for p in ("x/y.tar.gz", "noext", ".rc", "dir/a.PNG"):
        assert fsutils.get_file_extension(p) == jax_fsutils.get_file_extension(p)
        assert fsutils.get_file_name_without_extension(
            p
        ) == jax_fsutils.get_file_name_without_extension(p)
    # the install root's parent is the repo root for both, so models/ resolves
    assert os.path.dirname(fsutils.install_root()) == ROOT
    assert os.path.dirname(jax_fsutils.install_root()) == ROOT
    assert fsutils.sanitize_filepath("models") == jax_fsutils.sanitize_filepath("models")


def test_cli_helpers_equal(capsys):
    for s in ("12", " -3x", "+7", "abc", "", "0,4", "2:3,4:5"):
        assert cli._atoi(s) == jax_cli._atoi(s)
        assert cli.parse_int_array(s) == jax_cli.parse_int_array(s)
        assert cli.parse_jobs(s) == jax_cli.parse_jobs(s)
    cli.print_usage()
    mine = capsys.readouterr().err
    jax_cli.print_usage()
    assert mine == capsys.readouterr().err and "-x" in mine


def test_stage_timer_reports_spans():
    t = trace.StageTimer(enabled=True)
    with t.span("decode"):
        pass
    with t.span("decode"):
        pass
    out = io.StringIO()
    t.report(file=out)
    assert "decode" in out.getvalue() and "n=2" in out.getvalue()
    off = trace.StageTimer(enabled=False)
    with off.span("x"):
        pass
    out = io.StringIO()
    off.report(file=out)
    assert out.getvalue() == ""


def test_run_pipeline_equal_files(tiny_model_dir, tmp_path, rng):
    """The same directory through the port's and the JAX package's
    pipeline, both with the port's engine: byte-equal output files."""
    from realsr_tpu_torch.engine import EngineConfig, RealSR

    src = tmp_path / "in"
    src.mkdir()
    names = []
    for i, shape in enumerate(((11, 13, 3), (9, 7, 4), (16, 16, 3))):
        Image.fromarray(rng.integers(0, 256, shape, np.uint8)).save(src / f"{i}.png")
        names.append(f"{i}.png")
    (src / "broken.png").write_bytes(b"not a png")
    engine = RealSR(gpuid=-1, config=EngineConfig(tilesize=32, storage="float32"))
    engine.load(os.path.join(tiny_model_dir, "x4.param"), os.path.join(tiny_model_dir, "x4.bin"))
    outs = {}
    for label, run in (("port", pipeline.run_pipeline), ("jax", jax_pipeline.run_pipeline)):
        d = tmp_path / label
        d.mkdir()
        files = [str(src / n) for n in names + ["broken.png"]]
        run(files, [str(d / os.path.basename(f)) for f in files], [engine], [1],
            jobs_load=2, jobs_save=2, progress=False)
        outs[label] = {n: (d / n).read_bytes() for n in names}
        assert not (d / "broken.png").exists()
    assert outs["port"] == outs["jax"]
    assert np.asarray(Image.open(io.BytesIO(outs["port"]["1.png"]))).shape == (36, 28, 4)
