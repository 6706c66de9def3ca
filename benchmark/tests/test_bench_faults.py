"""A run with the timed path broken underneath comes out not correct: the
rest of a run (set-up, window, sample, reference, check) on the CPU at a
tiny size, once for each fault the cells can have; unbroken, it comes out
correct; and the control (the reference in float8 operands in the
program's place) fails the same check."""

from __future__ import annotations

import pytest

from conftest import make_root


def _rdb_unchanged(monkeypatch):
    """Every dense block of the trunk returns its input unchanged."""
    from realsr_tpu_torch.models import rrdbnet

    monkeypatch.setattr(rrdbnet, "_rdb", lambda x, p, storage_dtype, op_dtype=None: x)


def _half_the_batch(monkeypatch):
    """Each chunk scatters only the first half of its tiles."""
    from realsr_tpu_torch.engine import RealSR

    real = RealSR._scatter

    def scatter(self, out, chunk, tiles_u8, hn, wn):
        keep = max(1, len(chunk) // 2)
        real(self, out, chunk[:keep], tiles_u8[:keep], hn, wn)

    monkeypatch.setattr(RealSR, "_scatter", scatter)


def _answer_altered(monkeypatch):
    """One block of each chunk's first tile altered where it is made."""
    from realsr_tpu_torch.engine import RealSR

    real = RealSR._compute_chunk

    def compute(self, tiles, atiles, hn, wn):
        out = real(self, tiles, atiles, hn, wn)
        out[0, :8, :8] ^= 128
        return out

    monkeypatch.setattr(RealSR, "_compute_chunk", compute)


def _no_exchange(monkeypatch):
    """The cards' outputs are not merged: the first card's alone."""
    from realsr_tpu_torch.engine import RealSR

    monkeypatch.setattr(RealSR, "_merge", staticmethod(lambda shards: shards[0][2]))


def test_an_unbroken_run_is_correct(tmp_path, cpu_run):
    r = cpu_run(make_root(tmp_path))
    assert r["correct"], r["check"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert r["metrics"]["output_mp_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", [_rdb_unchanged, _half_the_batch, _answer_altered])
def test_a_broken_path_is_not_correct(tmp_path, cpu_run, monkeypatch, fault):
    root = make_root(tmp_path)
    fault(monkeypatch)
    r = cpu_run(root)
    assert not r["correct"], r["check"]


def test_a_mesh_without_its_exchange_is_not_correct(tmp_path, cpu_run, monkeypatch):
    root = make_root(tmp_path, mesh=True)
    assert cpu_run(root, cards=4)["correct"]
    _no_exchange(monkeypatch)
    assert not cpu_run(root, cards=4)["correct"]


def test_a_failed_request_is_not_correct(tmp_path, cpu_run, monkeypatch):
    from realsr_tpu_torch.engine import RealSR

    root = make_root(tmp_path)
    real, calls = RealSR.process, []

    def process(self, image, progress_cb=None):
        calls.append(1)
        if len(calls) == 4:  # the window's first: set-up runs the 2 sampled images and one again
            raise RuntimeError("lost")
        return real(self, image, progress_cb)

    monkeypatch.setattr(RealSR, "process", process)
    r = cpu_run(root)
    assert r["failed"] == 1 and not r["correct"]


def test_the_controls_run_in_the_programs_place(tmp_path, cpu_run):
    from benchmark import compare, run

    root = make_root(tmp_path)
    r = cpu_run(root, control=True)
    assert r["correct"]
    assert set(r["control"]) == set(run.CONTROLS)
    assert all(set(numbers) == set(compare.NAMES) for numbers in r["control"].values())
    limits = compare.load_limits(root, "tiny.tiny")
    assert not compare.judge(r["control"][run.CONTROL], limits, 0)[0], r["control"]


def test_the_reference_leaves_the_tf32_settings_as_it_found_them():
    import torch

    from benchmark.reference.rrdbnet import no_tf32

    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with no_tf32():
            assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
