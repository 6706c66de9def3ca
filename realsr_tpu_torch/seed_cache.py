"""Build and install a seed of built kernels, for hosts without ``nvcc``.

Counterpart of the JAX package's ``tools/seed_cache.py``. The port builds
its kernels with nvcc at first use (``ops/build.py``); a host without the
CUDA toolkit cannot. A seed moves that build to a host that has nvcc: it
holds the libraries of the kernel groups the named engines launch (every
group with ``--all``) in the build dir of their host fingerprint
(``ops/build.py::fingerprint``), and a host with the same fingerprint that
installs it loads them without nvcc.

Usage::

    python -m realsr_tpu_torch.seed_cache build out.tar.gz [-m MODELDIR]
           [--storage auto,float32] [--all]
    python -m realsr_tpu_torch.seed_cache install out.tar.gz [--build-root DIR]
    python -m realsr_tpu_torch.seed_cache info out.tar.gz

``build`` runs on a host with nvcc and the target's card. It builds, in
this host's build dir (``ops/build.py::build_dir``; a library already
built there is taken as it is), the groups that an engine of each
``--storage`` mode (the default engine otherwise: fast start, the tail and
trunk it resolves on a card) launches for the model of ``-m`` (the repo's
``models/models-DF2K`` by default), or every group of every source with
``--all`` (an engine with fast start off builds every group of its
sources). The tarball holds those libraries in their fingerprint dir and
``seed_manifest.json``: the fingerprint, the host features, the nvcc
release, the groups and each library's source digest.

``install`` refuses absolute paths, ``..`` members and any member that is
not a regular file or a directory, extracts the seed under the build root
(``REALSR_TPU_TORCH_BUILD`` or ``realsr_tpu_torch/_build``), and records its
libraries in that dir's manifest. On a host whose fingerprint differs it
says so on stderr: the libraries land in the seed's fingerprint dir, which
this host's engines never read. ``info`` prints the manifest as one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tarfile
import tempfile
import time

SEED_MANIFEST = "seed_manifest.json"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _groups(args) -> list:
    from realsr_tpu_torch.engine import EngineConfig, card_kernel_groups
    from realsr_tpu_torch.modelzoo import resolve_model_files
    from realsr_tpu_torch.ops import build

    if args.all:
        return [(src, g) for src in build.SOURCES for g in build.GROUPS[src]]
    mdir = args.model or os.path.join(ROOT, "models", "models-DF2K")
    files = resolve_model_files(mdir)  # the CLI's resolution, weights synthesized where missing
    if files is None:
        raise SystemExit(f"seed_cache: no model files under {mdir}")
    param, weights = files
    out: dict = {}
    for storage in args.storage.split(","):
        for key in card_kernel_groups(EngineConfig(storage=storage), param, weights):
            out[key] = None
    return list(out)


def cmd_build(args) -> int:
    import concurrent.futures

    from realsr_tpu_torch.ops import build

    if build.capability() == "none":
        raise SystemExit("seed_cache: no CUDA device here: a seed is built on a host with the target's card")
    nvcc = build._nvcc()
    groups = _groups(args)
    if not groups:
        print("seed_cache: the named engines launch no kernel", file=sys.stderr)
        return 1
    d = build.build_dir()
    fp = os.path.basename(d)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(groups)) as pool:
        built = list(pool.map(lambda k: build.ensure_built(*k, d, nvcc), groups))
    manifest = {
        "fingerprint": fp,
        "features": build.host_features(),
        "nvcc": build.nvcc_release(nvcc),
        "groups": [list(k) for k in groups],
        "digests": {build.library_name(*k): build.source_digest(*k) for k in groups},
        "nvcc_seconds": {f"{src}[{g}]": sec for (src, g), (_, sec, _) in zip(groups, built)},
        "build_wall_s": time.perf_counter() - t0,
    }
    with tempfile.TemporaryDirectory(prefix="realsr_seed_") as tmp:
        mpath = os.path.join(tmp, SEED_MANIFEST)
        with open(mpath, "w") as f:
            json.dump(manifest, f, indent=1)
        with tarfile.open(args.out, "w:gz") as tar:
            for so, _, _ in built:
                tar.add(so, arcname=f"{fp}/{os.path.basename(so)}")
            tar.add(mpath, arcname=f"{fp}/{SEED_MANIFEST}")
    print(json.dumps({**manifest, "tarball": args.out, "tarball_bytes": os.path.getsize(args.out)}))
    return 0


def _read_manifest(path: str) -> tuple:
    with tarfile.open(path, "r:gz") as tar:
        members = tar.getmembers()
        for m in members:
            if os.path.basename(m.name) == SEED_MANIFEST and m.isreg():
                return json.load(tar.extractfile(m)), members
    raise SystemExit(f"{path}: no {SEED_MANIFEST} inside: not a seed of built kernels")


def cmd_info(args) -> int:
    manifest, members = _read_manifest(args.tarball)
    manifest["files"] = sum(1 for m in members if m.isreg())
    print(json.dumps(manifest))
    return 0


def cmd_install(args) -> int:
    from realsr_tpu_torch.ops import build

    manifest, members = _read_manifest(args.tarball)
    root = os.path.realpath(args.build_root or build.build_root())
    for m in members:
        # a link would pass the path check below (its target need not exist
        # yet) and redirect a later member's write: a seed has none
        if not (m.isreg() or m.isdir()):
            raise SystemExit(f"refusing non-file member: {m.name} ({m.type!r})")
        if os.path.isabs(m.name) or ".." in m.name.replace("\\", "/").split("/"):
            raise SystemExit(f"refusing unsafe member path: {m.name}")
        dest = os.path.realpath(os.path.join(root, m.name))
        if not dest.startswith(root + os.sep):
            raise SystemExit(f"refusing unsafe member path: {m.name}")
    os.makedirs(root, exist_ok=True)
    with tarfile.open(args.tarball, "r:gz") as tar:
        tar.extractall(root, filter="data")
    seed_fp = manifest.get("fingerprint", "")
    build.record_libraries(os.path.join(root, seed_fp), {
        name: {"source": src, "group": g, "digest": manifest["digests"][name], "nvcc": manifest.get("nvcc")}
        for name, (src, g) in zip(manifest["digests"], manifest["groups"])
    })
    here = build.fingerprint()
    print(json.dumps({"installed_to": os.path.join(root, seed_fp), "fingerprint_match": here == seed_fp,
                      "this_host": here, "seed_host": seed_fp}))
    if here != seed_fp:
        print(
            f"seed_cache: WARNING: this host's fingerprint {here} ({build.host_features()}) differs from "
            f"the seed's {seed_fp} ({manifest.get('features')}): the installed libraries are inert (this "
            "host's engines read another dir); build a seed on a host that matches this one",
            file=sys.stderr,
        )
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m realsr_tpu_torch.seed_cache", description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("build", help="build the kernel groups and tar them")
    b.add_argument("out", help="output .tar.gz path")
    b.add_argument("-m", "--model", default=None, help="model dir (default: the repo's models/models-DF2K)")
    b.add_argument("--storage", default="auto", help="comma list of EngineConfig.storage modes (default auto)")
    b.add_argument("--all", action="store_true", help="every group of every source")
    b.set_defaults(fn=cmd_build)
    i = sub.add_parser("install", help="extract a seed under the build root")
    i.add_argument("tarball")
    i.add_argument("--build-root", default=None,
                   help="build root (default: $REALSR_TPU_TORCH_BUILD or realsr_tpu_torch/_build)")
    i.set_defaults(fn=cmd_install)
    n = sub.add_parser("info", help="print a seed's manifest")
    n.add_argument("tarball")
    n.set_defaults(fn=cmd_info)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
