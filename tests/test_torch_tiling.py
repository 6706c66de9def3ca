"""The port's per-image tile pick (``tiling/planner.py``, ``engine._pick_tilesize``)
against the JAX package's, on the CPU: the cost model's choices over a grid,
its anchors' overrides and provenance notice, a CPU engine faked as a card
engine, and forced tiles 192 / 256 against JAX's engine."""

import json
import os

import numpy as np
import pytest
import torch

from realsr_tpu.engine import EngineConfig as JaxConfig
from realsr_tpu.engine import RealSR as JaxRealSR
from realsr_tpu.tiling import planner as jax_planner
from realsr_tpu_torch.engine import Device, EngineConfig, RealSR
from realsr_tpu_torch.tiling import calibrate, planner

torch.set_num_threads(2)

# one anchor table for both packages: the port's shipped H100 table
ANCHORS = ",".join(f"{s}:{r}" for s, r in planner._RATE_ANCHORS)


def _files(d):
    return os.path.join(d, "x4.param"), os.path.join(d, "x4.bin")


def _card_engine(d, tta=False, **cfg):
    """A CPU engine faked as a card engine: platform "gpu", so the tile is
    picked per image and the kernel variant (its plain versions) runs."""
    e = RealSR(gpuid=-1, tta_mode=tta, config=EngineConfig(**cfg))
    e.device = Device("gpu", torch.device("cpu"))
    e.tilesize = e.last_tilesize = e.config.tilesize
    e.load(*_files(d))
    return e


def _jax_engine(d, tta=False, **cfg):
    e = JaxRealSR(gpuid=-1, tta_mode=tta, config=JaxConfig(compilation_cache=False, **cfg))
    e.load(*_files(d))
    return e


def _close(got, want):
    d = np.abs(got.astype(int) - want.astype(int))
    assert got.shape == want.shape
    assert np.mean(d == 0) >= 0.999 and d.max() <= 1, (np.mean(d == 0), d.max())


@pytest.fixture
def anchors(monkeypatch, tmp_path):
    monkeypatch.setenv("REALSR_TPU_CACHE", str(tmp_path))
    monkeypatch.setenv("REALSR_TPU_RATE_ANCHORS", ANCHORS)


SIZES = [(1, 1), (33, 17), (140, 140), (200, 150), (300, 220), (500, 400), (640, 480),
         (1000, 700), (1024, 768), (1920, 1080), (4096, 3072)]


@pytest.mark.parametrize("w,h", SIZES)
@pytest.mark.parametrize("n_img", [1, 3])
@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_pick_tilesize_matches_jax(anchors, w, h, n_img, ndev):
    """The same choice as JAX's planner at the same anchors, for a fixed
    granule, a per-candidate granule and both candidate sets."""
    for granule in (1, 6, 8, (lambda t: 8 if t < 256 else 6)):
        for cands in ((128, 192, 256), (128, 192)):
            kw = dict(granule=granule, candidates=cands, n_img=n_img, ndev=ndev)
            assert planner.pick_tilesize(w, h, 10, **kw) == jax_planner.pick_tilesize(w, h, 10, **kw)


@pytest.mark.parametrize("spec", ["148:1.0,212:0.855,276:0.78", "148:1.0,276:1.3", ANCHORS])
def test_px_rate_matches_jax(monkeypatch, tmp_path, spec):
    monkeypatch.setenv("REALSR_TPU_CACHE", str(tmp_path))
    monkeypatch.setenv("REALSR_TPU_RATE_ANCHORS", spec)
    for ph in (10, 100, 148, 170, 212, 240, 276, 400, 4000):
        for pw in (ph, 64):
            assert planner._px_rate(ph, pw) == jax_planner._px_rate(ph, pw)


def test_shipped_anchors_are_the_cards():
    """The shipped table is the H100's, relative to side 148; its
    provenance names the card; the candidates are JAX's."""
    assert planner._RATE_ANCHORS[0] == (148, 1.0)
    assert [s for s, _ in planner._RATE_ANCHORS] == [148, 212, 276] == list(calibrate.SIDES)
    assert planner._ANCHOR_DEVICE.startswith("NVIDIA H100")
    assert planner._TILE_CANDIDATES == jax_planner._TILE_CANDIDATES


def test_rate_anchor_env_override(monkeypatch, tmp_path):
    """REALSR_TPU_RATE_ANCHORS applies a re-measurement without code edits;
    malformed values fall back to the shipped table."""
    monkeypatch.setenv("REALSR_TPU_CACHE", str(tmp_path))
    monkeypatch.delenv("REALSR_TPU_RATE_ANCHORS", raising=False)
    base = planner._px_rate(276, 276)
    monkeypatch.setenv("REALSR_TPU_RATE_ANCHORS", "148:1.0,276:0.5")
    assert planner._px_rate(276, 276) == 0.5
    monkeypatch.setenv("REALSR_TPU_RATE_ANCHORS", "garbage")
    assert planner._px_rate(276, 276) == base
    monkeypatch.delenv("REALSR_TPU_RATE_ANCHORS")
    assert planner._px_rate(276, 276) == base


def test_rate_anchor_calibration_file(monkeypatch, tmp_path):
    """calibrate --save persists anchors install-locally; the planner reads
    the file when the env override is absent, env wins when both are set,
    and a corrupt file falls back to the shipped table."""
    monkeypatch.setenv("REALSR_TPU_CACHE", str(tmp_path))
    monkeypatch.delenv("REALSR_TPU_RATE_ANCHORS", raising=False)
    base = planner._px_rate(276, 276)
    with open(planner._anchor_file(), "w") as f:
        json.dump({"anchors": "148:1.0,276:0.6"}, f)
    assert planner._px_rate(276, 276) == 0.6
    monkeypatch.setenv("REALSR_TPU_RATE_ANCHORS", "148:1.0,276:0.4")
    assert planner._px_rate(276, 276) == 0.4
    monkeypatch.delenv("REALSR_TPU_RATE_ANCHORS")
    with open(planner._anchor_file(), "w") as f:
        f.write("not json")
    assert planner._px_rate(276, 276) == base


def test_anchor_file_lives_in_the_ports_cache(monkeypatch, tmp_path):
    monkeypatch.delenv("REALSR_TPU_CACHE", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert planner._anchor_file() == str(tmp_path / "realsr_tpu_torch" / "planner_anchors.json")
    assert "realsr_tpu_xla" not in planner._anchor_file()


def test_anchor_provenance_notice(monkeypatch, tmp_path):
    """Silent on the card the table was measured on and on a matching saved
    calibration; fires on another card and on a calibration recorded
    elsewhere; the env override silences it everywhere."""
    monkeypatch.setenv("REALSR_TPU_CACHE", str(tmp_path))
    monkeypatch.delenv("REALSR_TPU_RATE_ANCHORS", raising=False)
    assert planner.anchor_provenance_notice("NVIDIA H100 80GB HBM3") == ""
    note = planner.anchor_provenance_notice("NVIDIA A100-SXM4-80GB")
    assert "calibrate" in note and "NVIDIA A100-SXM4-80GB" in note
    with open(planner._anchor_file(), "w") as f:
        json.dump({"anchors": "148:1.0,276:0.6", "device_kind": "NVIDIA L40S"}, f)
    assert planner.anchor_provenance_notice("NVIDIA L40S") == ""
    note = planner.anchor_provenance_notice("NVIDIA H100 80GB HBM3")
    assert "NVIDIA L40S" in note and "NVIDIA H100 80GB HBM3" in note
    monkeypatch.setenv("REALSR_TPU_RATE_ANCHORS", "148:1.0,276:0.4")
    assert planner.anchor_provenance_notice("NVIDIA A100-SXM4-80GB") == ""


def test_anchors_spec_from_measurement():
    measured = {148: (8, 40.0, 0.2), 212: (8, 76.0, 0.19), 276: (6, 85.0, 0.18)}
    assert calibrate.anchors_spec(measured) == "148:1.000,212:0.950,276:0.900"
    assert planner._parse_anchor_spec(calibrate.anchors_spec(measured)) == ((148, 1.0), (212, 0.95), (276, 0.9))


def test_notice_printed_once_per_process(tiny_model_dir, monkeypatch, tmp_path, capsys):
    """A kernel-variant engine on a card other than the table's says so
    once, however many engines load."""
    from realsr_tpu_torch import engine as E

    monkeypatch.setenv("REALSR_TPU_CACHE", str(tmp_path))
    monkeypatch.delenv("REALSR_TPU_RATE_ANCHORS", raising=False)
    monkeypatch.setattr(E, "_PRINTED_NOTICES", set())
    for _ in range(2):
        _card_engine(tiny_model_dir)
    err = capsys.readouterr().err
    assert err.count("tile-size cost anchors") == 1
    _card_engine(tiny_model_dir, variant="dense")
    assert "anchors" not in capsys.readouterr().err


@pytest.mark.parametrize("tta", [False, True])
@pytest.mark.parametrize("variant", ["cuda", "dense"])
def test_card_engine_picks_as_jax(tiny_model_dir, anchors, variant, tta):
    """A card engine picks what JAX's engine picks (its Pallas variant for
    the port's kernel variant, its conv path for plain convs), for single
    images and stacks; the CPU keeps 200 and an explicit tile wins."""
    port = _card_engine(tiny_model_dir, tta=tta, variant=variant)
    jax_e = _jax_engine(tiny_model_dir, tta=tta)
    jax_e.tilesize, jax_e.variant = 0, "pallas" if variant == "cuda" else "dense"
    assert port.tilesize == 0
    for w, h in SIZES:
        for n_img in (1, 2, 5):
            assert port._pick_tilesize(w, h, n_img) == jax_e._pick_tilesize(w, h, n_img), (w, h, n_img)
    cpu = RealSR(gpuid=-1, config=EngineConfig())
    assert cpu.tilesize == 200 and cpu._pick_tilesize(1024, 768) == 200
    fixed = RealSR(gpuid=-1, config=EngineConfig(tilesize=64))
    assert fixed._pick_tilesize(1024, 768) == 64


def test_pick_follows_the_granule(tiny_model_dir, anchors, monkeypatch):
    """The chunk granule is max_batch or _auto_batch per candidate, as in
    JAX's engine: a tight band budget shrinks a large tile's granule."""
    for mb in (0, 1, 3):
        port = _card_engine(tiny_model_dir, max_batch=mb)
        jax_e = _jax_engine(tiny_model_dir, max_batch=mb)
        jax_e.tilesize, jax_e.variant = 0, "pallas"
        for budget in ("2", "64", "2048"):
            monkeypatch.setenv("REALSR_TPU_BAND_BUDGET_MB", budget)
            for w, h in SIZES:
                assert port._pick_tilesize(w, h) == jax_e._pick_tilesize(w, h), (mb, budget, w, h)


def test_picked_engine_runs_the_pick_and_bands_bit_equal(tiny_model_dir, anchors):
    """process, process_batch and process_banded run at the picked tile
    (``last_tilesize``); a banded run picks for the whole image, so it is
    bit-equal to the whole-image run."""
    port = _card_engine(tiny_model_dir)
    img = np.random.default_rng(3).integers(0, 256, (300, 420, 4), np.uint8)
    want_tile = port._pick_tilesize(420, 300)
    whole = port.process(img)
    assert port.last_tilesize == want_tile
    seen = []
    fwd = port.bundle.forward
    port.bundle.forward = lambda p, x: seen.append(tuple(x.shape[1:3])) or fwd(p, x)
    for btr in (1, 2):
        np.testing.assert_array_equal(port.process_banded(img, band_tile_rows=btr), whole)
        assert port.last_tilesize == want_tile
    assert max(max(s) for s in seen) == min(want_tile, 300) + 20


@pytest.mark.parametrize("tile", [192, 256])
def test_forced_tile_matches_jax(tiny_model_dir, tile):
    """At a forced 192 / 256 the port's engine matches JAX's at the same
    tile (u8 >= 99.9 % equal), and its banded run is bit-equal to whole."""
    port = _card_engine(tiny_model_dir, tilesize=tile, storage="float32")
    jax_e = _jax_engine(tiny_model_dir, tilesize=tile, storage="float32")
    img = np.random.default_rng(tile).integers(0, 256, (300, 290, 3), np.uint8)
    got = port.process(img)
    assert port.last_tilesize == tile
    _close(got, jax_e.process(img))
    np.testing.assert_array_equal(port.process_banded(img, band_tile_rows=1), got)


def test_chunking_takes_the_tile(tiny_model_dir):
    """_chunking's batch is the granule of the tile it is given, as JAX's
    _chunking(tilesize, n) without a mesh."""
    port = _card_engine(tiny_model_dir)
    jax_e = _jax_engine(tiny_model_dir)
    for tile in (16, 128, 192, 256, 1000):
        for n in (1, 3, 7, 9, 40):
            assert port._chunking(tile, n) == jax_e._chunking(tile, n)
