"""``python -m realsr_tpu_torch.seed_cache``: build / info / install of a
seed of built kernels on the CPU, as ``tests/test_seed_cache.py`` holds the
JAX package's seed tool: the round trip, a host without nvcc that loads the
seed, a mismatched host where the seed stays inert, and the refusal of
unsafe tarball members. A recording stand-in for ``subprocess.run`` plays
nvcc and writes a stub library built with the host's cc."""

import io
import json
import os
import shutil
import subprocess
import sys
import tarfile

import pytest

from realsr_tpu_torch import seed_cache
from realsr_tpu_torch.ops import build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RELEASE = "Cuda compilation tools, release 12.8, V12.8.93"
DEFAULT = [("rdb_wgmma", "f32_nf64"), ("tail_kernel", "k6")]
NVCC = "/fake/cuda/bin/nvcc"


@pytest.fixture(scope="module")
def stub_so(tmp_path_factory):
    cc = shutil.which("cc")
    if cc is None:
        pytest.skip("no cc on this host to build a stub shared library")
    d = tmp_path_factory.mktemp("stub")
    (d / "stub.c").write_text("int stub_entry(void) { return 0; }\n")
    subprocess.run([cc, "-shared", "-fPIC", "-o", str(d / "stub.so"), str(d / "stub.c")], check=True)
    return str(d / "stub.so")


@pytest.fixture(scope="module")
def df2k(tmp_path_factory):
    """The committed DF2K graph with synthesized weights, as a model dir."""
    from realsr_tpu_torch.ncnn.bin import write_weights
    from realsr_tpu_torch.ncnn.param import parse_param_file
    from realsr_tpu_torch.ncnn.synth import synth_weights

    d = tmp_path_factory.mktemp("seedmodel") / "models-DF2K"
    d.mkdir()
    shutil.copyfile(os.path.join(ROOT, "models", "models-DF2K", "x4.param"), d / "x4.param")
    graph = parse_param_file(str(d / "x4.param"))
    write_weights(graph, synth_weights(graph, seed=0), str(d / "x4.bin"))
    return str(d)


class FakeNvcc:
    """subprocess.run with nvcc faked: ``--version`` reports RELEASE; a
    build writes the stub library to ``-o``. Other commands run."""

    def __init__(self, stub):
        self.stub, self.builds, self.run = stub, [], subprocess.run

    def __call__(self, cmd, **kw):
        if cmd[0] != NVCC:
            return self.run(cmd, **kw)
        if cmd[1:] == ["--version"]:
            return subprocess.CompletedProcess(cmd, 0, stdout=RELEASE + "\n", stderr="")
        shutil.copyfile(self.stub, cmd[cmd.index("-o") + 1])
        self.builds.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout="", stderr="")


@pytest.fixture
def host(stub_so, monkeypatch, tmp_path):
    """A build host with a fake nvcc, its own build root and emptied
    process caches; ``host.card`` sets the compute capability this host
    reports."""
    fake = FakeNvcc(stub_so)
    monkeypatch.setattr(build, "find_nvcc", lambda: NVCC)
    monkeypatch.setattr(build.subprocess, "run", fake)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "_RELEASES", {})
    monkeypatch.setenv("REALSR_TPU_TORCH_BUILD", str(tmp_path / "build_root"))
    monkeypatch.delenv("REALSR_TPU_FAST_START", raising=False)
    monkeypatch.delenv("REALSR_TPU_PACKED_TAIL", raising=False)
    fake.card = lambda cap: monkeypatch.setattr(build, "capability", lambda: cap)
    fake.no_nvcc = lambda: monkeypatch.setattr(build, "find_nvcc", lambda: None)
    fake.root = lambda path: monkeypatch.setenv("REALSR_TPU_TORCH_BUILD", str(path))
    return fake


def _main(capsys, *argv) -> tuple:
    rc = seed_cache.main(list(argv))
    out = capsys.readouterr()
    return rc, json.loads(out.out.strip().splitlines()[-1]), out.err


@pytest.fixture
def seed(host, df2k, tmp_path, capsys):
    """A seed of the default engine's groups, built on a host that reports
    an H100's compute capability (9.0)."""
    host.card("9.0")
    out = str(tmp_path / "seed.tar.gz")
    rc, manifest, _ = _main(capsys, "build", out, "-m", df2k)
    assert rc == 0
    return out, manifest


def test_build_holds_the_default_engines_groups(seed, host):
    """The seed holds the libraries of the groups the default card engine
    launches, in the build host's fingerprint dir, with a manifest of the
    fingerprint, the nvcc release, the groups and their digests."""
    out, manifest = seed
    fp = build.fingerprint("9.0")
    assert manifest["fingerprint"] == fp and manifest["nvcc"] == "V12.8.93"
    assert [tuple(g) for g in manifest["groups"]] == DEFAULT and len(host.builds) == 2
    assert manifest["digests"] == {build.library_name(*k): build.source_digest(*k) for k in DEFAULT}
    assert manifest["features"] == build.host_features("9.0") and all(manifest["nvcc_seconds"].values())
    with tarfile.open(out) as tar:
        names = sorted(m.name for m in tar.getmembers())
    assert names == sorted([f"{fp}/{build.library_name(*k)}" for k in DEFAULT] + [f"{fp}/seed_manifest.json"])


def test_build_from_a_warm_root_runs_no_nvcc(seed, host, df2k, tmp_path, capsys):
    """A build root that holds the groups already (the machine's own cache)
    becomes a seed without nvcc running again."""
    again = str(tmp_path / "again.tar.gz")
    rc, manifest, _ = _main(capsys, "build", again, "-m", df2k)
    assert rc == 0 and len(host.builds) == 2 and not any(manifest["nvcc_seconds"].values())


@pytest.mark.parametrize("argv,want", [
    (["--storage", "auto,float32"], DEFAULT + [("rdb_tf32", "f32_nf64"), ("tail_tf32", "k6")]),
    (["--all"], [(s, g) for s in build.SOURCES for g in build.GROUPS[s]]),
])
def test_build_names_engines_or_all(argv, want, host, df2k, tmp_path, capsys):
    """``--storage`` names several engines (their groups' union); ``--all``
    every group of every source."""
    host.card("9.0")
    rc, manifest, _ = _main(capsys, "build", str(tmp_path / "s.tar.gz"), "-m", df2k, *argv)
    assert rc == 0 and [tuple(g) for g in manifest["groups"]] == want and len(host.builds) == len(want)


def test_build_needs_the_card(host, df2k, tmp_path):
    """A seed's fingerprint is its build host's card's: no card, no seed."""
    host.card("none")
    with pytest.raises(SystemExit, match="no CUDA device"):
        seed_cache.main(["build", str(tmp_path / "s.tar.gz"), "-m", df2k])


def test_info(seed):
    """``info`` as a module, in its own process: the manifest on one line."""
    out, manifest = seed
    r = subprocess.run([sys.executable, "-m", "realsr_tpu_torch.seed_cache", "info", out], capture_output=True,
                       text=True, cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr
    assert len(r.stdout.strip().splitlines()) == 1
    info = json.loads(r.stdout)
    assert info["fingerprint"] == manifest["fingerprint"] and info["files"] == 3


def test_install_matching_host_loads_without_nvcc(seed, host, tmp_path, capsys):
    """The payoff: on a host with the seed's fingerprint and no nvcc, the
    installed libraries load and nothing is built."""
    out, manifest = seed
    root = tmp_path / "seeded"
    rc, res, err = _main(capsys, "install", out, "--build-root", str(root))
    assert rc == 0 and res["fingerprint_match"] is True and "WARNING" not in err
    assert res["installed_to"] == str(root / manifest["fingerprint"])
    recorded = build.read_manifest(str(root / manifest["fingerprint"]))["libraries"]
    assert {r["nvcc"] for r in recorded.values()} == {"V12.8.93"} and set(recorded) == set(manifest["digests"])
    host.no_nvcc()
    host.root(root)
    n = len(host.builds)
    for key in DEFAULT:
        assert build.load_library(*key).stub_entry() == 0 and build.BUILD_SECONDS[key] == 0.0
    assert len(host.builds) == n


def test_install_on_a_mismatched_host_is_inert(seed, host, tmp_path, capsys):
    """Another fingerprint (here a host without a card): the install says so
    on stderr, the libraries land in the seed's fingerprint dir, and this
    host's engines, which read their own dir, find nothing there."""
    out, manifest = seed
    host.card("none")
    root = tmp_path / "other"
    rc, res, err = _main(capsys, "install", out, "--build-root", str(root))
    assert rc == 0 and res["fingerprint_match"] is False and "WARNING" in err
    assert os.path.isdir(root / manifest["fingerprint"]) and not os.path.exists(root / build.fingerprint())
    host.no_nvcc()
    host.root(root)
    with pytest.raises(RuntimeError, match="seed_cache install"):
        build.load_library(*DEFAULT[0])


def _evil(path, member: tarfile.TarInfo, data: bytes = b""):
    with tarfile.open(path, "w:gz") as tar:
        mdata = json.dumps({"fingerprint": "aaaaaaaaaa", "groups": [], "digests": {}}).encode()
        mi = tarfile.TarInfo("aaaaaaaaaa/seed_manifest.json")
        mi.size = len(mdata)
        tar.addfile(mi, io.BytesIO(mdata))
        member.size = len(data)
        tar.addfile(member, io.BytesIO(data) if data else None)
    return str(path)


@pytest.mark.parametrize("name", ["../outside", "aaaaaaaaaa/../../outside"])
def test_install_refuses_path_traversal(name, tmp_path):
    evil = _evil(tmp_path / "evil.tar.gz", tarfile.TarInfo(name), b"x")
    with pytest.raises(SystemExit, match="unsafe member path"):
        seed_cache.main(["install", evil, "--build-root", str(tmp_path / "b")])
    assert not (tmp_path / "outside").exists() and not (tmp_path / "b").exists()


def test_install_refuses_absolute_paths(tmp_path):
    target = tmp_path / "abs_target"
    evil = _evil(tmp_path / "evil.tar.gz", tarfile.TarInfo(str(target)), b"x")
    with pytest.raises(SystemExit, match="unsafe member path"):
        seed_cache.main(["install", evil, "--build-root", str(tmp_path / "b")])
    assert not target.exists()


@pytest.mark.parametrize("kind", [tarfile.SYMTYPE, tarfile.LNKTYPE])
def test_install_refuses_link_members(kind, tmp_path):
    """A link member passes a path check while its target does not exist
    yet, and would redirect a later member's write: refused outright."""
    outside = tmp_path / "outside_dir"
    outside.mkdir()
    li = tarfile.TarInfo("aaaaaaaaaa/x")
    li.type = kind
    li.linkname = str(outside)
    evil = _evil(tmp_path / "evil_link.tar.gz", li)
    with pytest.raises(SystemExit, match="refusing non-file member"):
        seed_cache.main(["install", evil, "--build-root", str(tmp_path / "b")])
    assert list(outside.iterdir()) == [] and not (tmp_path / "b").exists()


def test_info_refuses_a_tarball_that_is_no_seed(tmp_path):
    path = tmp_path / "other.tar.gz"
    with tarfile.open(path, "w:gz") as tar:
        ti = tarfile.TarInfo("x")
        tar.addfile(ti, io.BytesIO(b""))
    with pytest.raises(SystemExit, match="not a seed"):
        seed_cache.main(["info", str(path)])
