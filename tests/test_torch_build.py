"""The port's kernel build cache (``realsr_tpu_torch/ops/build.py``): which
bytes a built library's name depends on. Runs without nvcc."""

import shutil

from realsr_tpu_torch.ops import build


def _copy_csrc(tmp_path, monkeypatch):
    d = tmp_path / "csrc"
    shutil.copytree(build.CSRC, d)
    monkeypatch.setattr(build, "CSRC", str(d))
    return d


def test_digest_covers_the_source_every_header_and_the_flags(tmp_path, monkeypatch):
    """An edit to the source, to any header of csrc/ (tail_kernel.cu,
    rdb_wgmma.cu and rdb_tf32.cu include hopper.cuh), or to the flags names
    another library; an edit to another source does not."""
    d = _copy_csrc(tmp_path, monkeypatch)
    assert (d / "hopper.cuh").is_file()
    first = {n: build.source_digest(n) for n in ("tail_kernel", "rdb_wgmma", "rdb_tf32")}
    assert build.source_digest("tail_kernel") == first["tail_kernel"]  # stable

    with open(d / "hopper.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: build.source_digest(n) for n in first}
    assert all(after[n] != first[n] for n in first)

    with open(d / "rdb_tf32.cu", "a") as f:
        f.write("\n// edited\n")
    assert build.source_digest("rdb_tf32") != after["rdb_tf32"]
    assert build.source_digest("tail_kernel") == after["tail_kernel"]

    (d / "new.cuh").write_text("#pragma once\n")
    assert build.source_digest("tail_kernel") != after["tail_kernel"]

    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.source_digest("rdb_tf32") != after["rdb_tf32"]


def test_library_name_uses_the_digest(tmp_path, monkeypatch):
    """load_library looks for <name>-<digest>.so in the build directory and
    loads a library that is already there without building it."""
    _copy_csrc(tmp_path, monkeypatch)
    out = tmp_path / "build"
    out.mkdir()
    monkeypatch.setenv("REALSR_TPU_TORCH_BUILD", str(out))
    so = out / f"tail_kernel-{build.source_digest('tail_kernel')}.so"
    so.write_bytes(b"")
    loaded = []
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: loaded.append(path) or path)
    monkeypatch.setattr(build, "_LIBS", {})
    assert build.load_library("tail_kernel") == str(so)
    assert loaded == [str(so)] and build.BUILD_SECONDS["tail_kernel"] == 0.0


def test_sources_are_every_kernel_source_of_csrc(tmp_path, monkeypatch):
    """build.SOURCES (what chip_smoke.py builds, one nvcc each) names every
    csrc/*.cu and nothing else, and each digest covers the float32
    instances' shared headers (rdb_modes.cuh, tail_wgmma.cuh)."""
    import os

    assert sorted(build.SOURCES) == sorted(f[:-3] for f in os.listdir(build.CSRC) if f.endswith(".cu"))
    d = _copy_csrc(tmp_path, monkeypatch)
    for header, users in (("rdb_modes.cuh", ("rdb_modes_wgmma", "rdb_modes_tf32")),
                          ("tail_wgmma.cuh", ("tail_kernel", "tail_tf32"))):
        before = {n: build.source_digest(n) for n in users}
        with open(d / header, "a") as f:
            f.write("\n// edited\n")
        assert all(build.source_digest(n) != before[n] for n in users)
