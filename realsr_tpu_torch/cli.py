"""Command-line interface of the PyTorch port, with the reference's flags.

Counterpart of ``realsr_tpu/cli.py`` (src/main.cpp:101-115 usage, 441-525
getopt loop, 527-672 validation and file lists), ending in the port's
``pipeline.run_pipeline``. Flags:

    -i input-path   -o output-path   -s scale (4)
    -t tile-size    -m model-path    -g gpu-id (-1=cpu, comma list)
    -j load:proc:save  -x (tta)  -f format  -v  -h

Exit codes follow the reference: usage and validation errors return -1
(the shell sees 255). One deviation from the JAX CLI: without ``-g`` it
takes CUDA device 0 and fails when there is none; the CPU runs only on an
explicit ``-g -1``. ``-x`` runs TTA (8 dihedral variants per tile, averaged).
The environment picks the precision (``REALSR_TPU_STORAGE``) and the tail
form (``REALSR_TPU_PACKED_TAIL``: 0 interleaved, 1 packed, 2 the K7 tail
kernel, 3 the K6 tail kernel; unset, the engine's own choice).
``REALSR_TPU_SHARD`` / ``REALSR_TPU_NUM_SHARDS`` give this process the
``[shard::num_shards]`` slice of the file list, as the JAX CLI's env vars
do; with ``REALSR_TPU_NUM_SHARDS`` unset, an initialized
``torch.distributed`` process group gives them (rank, world size), as an
initialized ``jax.distributed`` runtime does for the JAX CLI. No launcher
variable (``RANK``, ``WORLD_SIZE``) is read. On ``-g -1``, ``-j``'s proc
count sets torch's CPU thread count (default 2). ``REALSR_TPU_MESH`` (``all``
or a comma list of device ids) runs one engine that deals each image's tile
chunks to those devices (``parallel/mesh.py``) in place of one engine per
``-g`` id. ``REALSR_TPU_PRECOMPILE=1`` makes every engine's chunk programs
for the first input's shape (and the ``REALSR_TPU_IMAGE_BATCH`` stack)
ready before the pipeline starts (``RealSR.precompile``). The engines read
``REALSR_TPU_FAST_START`` themselves (``EngineConfig.fast_start``): unset,
one builds only the kernel groups it launches before its first image; ``0``
builds every group of their sources. A run that builds prints one stderr
line with the groups and their nvcc seconds.
"""

from __future__ import annotations

import getopt
import os
import sys
from typing import List, Optional, Tuple

from realsr_tpu_torch.utils.fsutils import (
    get_file_extension,
    get_file_name_without_extension,
    list_directory,
    path_is_directory,
)


def _distributed_shard(shard: int, num_shards: int) -> Tuple[int, int]:
    """(rank, world size) of an initialized ``torch.distributed`` process
    group, else ``(shard, num_shards)`` as given. Reading the group does not
    initialize CUDA, so ``-g -1`` is still free to keep the run on the
    CPU."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return shard, num_shards


def print_usage(file=None) -> None:
    # flag-for-flag the reference usage text (main.cpp:101-115), with the
    # binary name of this framework.
    file = file or sys.stderr
    print("Usage: realsr-tpu -i infile -o outfile [options]...\n", file=file)
    print("  -h                   show this help", file=file)
    print("  -v                   verbose output", file=file)
    print("  -i input-path        input image path (jpg/png/webp) or directory", file=file)
    print("  -o output-path       output image path (jpg/png/webp) or directory", file=file)
    print("  -s scale             upscale ratio (4, default=4)", file=file)
    print("  -t tile-size         tile size (>=32/0=auto, default=0) can be 0,0,0 for multi-gpu", file=file)
    print("  -m model-path        realsr model path (default=models-DF2K_JPEG)", file=file)
    print("  -g gpu-id            gpu device to use (-1=cpu, default=auto) can be 0,1,2 for multi-gpu", file=file)
    print("  -j load:proc:save    thread count for load/proc/save (default=1:2:2) can be 1:2,2,2:2 for multi-gpu", file=file)
    print("  -x                   enable tta mode", file=file)
    print("  -f format            output image format (jpg/png/webp, default=ext/png)", file=file)


def _atoi(s: str) -> int:
    """C atoi: parse a leading integer, 0 if none."""
    s = s.strip()
    i = 0
    if i < len(s) and s[i] in "+-":
        i += 1
    j = i
    while j < len(s) and s[j].isdigit():
        j += 1
    if j == i:
        return 0
    return int(s[: j])


def parse_int_array(s: str) -> List[int]:
    """Reference parse_optarg_int_array (main.cpp:75-89): atoi per comma."""
    return [_atoi(tok) for tok in s.split(",")]


def parse_jobs(s: str) -> Tuple[int, List[int], int]:
    """Parse ``load:proc[,proc...]:save`` (main.cpp:507-508 sscanf)."""
    parts = s.split(":")
    jobs_load = _atoi(parts[0]) if parts else 1
    jobs_save = _atoi(parts[-1]) if len(parts) >= 3 else 2
    jobs_proc = parse_int_array(parts[1]) if len(parts) >= 2 else []
    return jobs_load, jobs_proc, jobs_save


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)

    inputpath = ""
    outputpath = ""
    scale = 4
    tilesize: List[int] = []
    model = "models-DF2K_JPEG"  # main.cpp:429 default
    gpuid: List[int] = []
    jobs_load, jobs_proc, jobs_save = 1, [], 2
    verbose = False
    tta_mode = False
    fmt = "png"

    try:
        opts, _ = getopt.getopt(argv, "i:o:s:t:m:g:j:f:vxh")
    except getopt.GetoptError:
        print_usage()
        return -1
    for opt, val in opts:
        if opt == "-i":
            inputpath = val
        elif opt == "-o":
            outputpath = val
        elif opt == "-s":
            scale = _atoi(val)
        elif opt == "-t":
            tilesize = parse_int_array(val)
        elif opt == "-m":
            model = val
        elif opt == "-g":
            gpuid = parse_int_array(val)
        elif opt == "-j":
            jobs_load, jobs_proc, jobs_save = parse_jobs(val)
        elif opt == "-f":
            fmt = val
        elif opt == "-v":
            verbose = True
        elif opt == "-x":
            tta_mode = True
        else:  # -h
            print_usage()
            return -1

    if not inputpath or not outputpath:
        print_usage()
        return -1

    if scale != 4:  # main.cpp:533-537
        print("invalid scale argument", file=sys.stderr)
        return -1

    n_dev = len(gpuid) if gpuid else 1
    if tilesize and len(tilesize) != n_dev:
        print("invalid tilesize argument", file=sys.stderr)
        return -1
    for t in tilesize:
        if t != 0 and t < 32:  # main.cpp:545-552
            print("invalid tilesize argument", file=sys.stderr)
            return -1

    if jobs_load < 1 or jobs_save < 1:
        print("invalid thread count argument", file=sys.stderr)
        return -1
    if jobs_proc and len(jobs_proc) != n_dev:
        print("invalid jobs_proc thread count argument", file=sys.stderr)
        return -1
    for j in jobs_proc:
        if j < 1:
            print("invalid jobs_proc thread count argument", file=sys.stderr)
            return -1

    # format inference from output extension (main.cpp:575-603)
    if not path_is_directory(outputpath):
        ext = get_file_extension(outputpath).lower()
        if ext == "png":
            fmt = "png"
        elif ext == "webp":
            fmt = "webp"
        elif ext in ("jpg", "jpeg"):
            fmt = "jpg"
        else:
            print("invalid outputpath extension type", file=sys.stderr)
            return -1
    if fmt not in ("png", "webp", "jpg"):
        print("invalid format argument", file=sys.stderr)
        return -1

    # input/output file lists (main.cpp:605-659)
    input_files: List[str] = []
    output_files: List[str] = []
    if path_is_directory(inputpath) and path_is_directory(outputpath):
        last_filename = ""
        last_filename_noext = ""
        for fn in list_directory(inputpath):
            noext = get_file_name_without_extension(fn)
            out_fn = noext + "." + fmt
            if noext == last_filename_noext:  # collision rename :628-643
                out_fn2 = fn + "." + fmt
                print(
                    f"both {fn} and {last_filename} output {out_fn} ! "
                    f"{fn} will output {out_fn2}",
                    file=sys.stderr,
                )
                out_fn = out_fn2
            else:
                last_filename = fn
                last_filename_noext = noext
            input_files.append(os.path.join(inputpath, fn))
            output_files.append(os.path.join(outputpath, out_fn))
    elif not path_is_directory(inputpath) and not path_is_directory(outputpath):
        input_files = [inputpath]
        output_files = [outputpath]
    else:
        print(
            "inputpath and outputpath must be either file or directory at the same time",
            file=sys.stderr,
        )
        return -1

    # file sharding across processes: each takes every num_shards-th file;
    # the identity from the env vars, else from an initialized process group
    shard = _atoi(os.environ.get("REALSR_TPU_SHARD", "-1"))
    num_shards = _atoi(os.environ.get("REALSR_TPU_NUM_SHARDS", "0"))
    if not num_shards:
        shard, num_shards = _distributed_shard(shard, num_shards)
    if num_shards > 1:
        if not 0 <= shard < num_shards:
            print("invalid REALSR_TPU_SHARD / REALSR_TPU_NUM_SHARDS", file=sys.stderr)
            return -1
        input_files = input_files[shard::num_shards]
        output_files = output_files[shard::num_shards]

    # prepadding from model dir name (main.cpp:661-672)
    if "models-DF2K" in model:
        prepadding = 10
    else:
        print("unknown model dir type", file=sys.stderr)
        return -1

    from realsr_tpu_torch.modelzoo import resolve_model_files

    resolved = resolve_model_files(model, scale)
    if resolved is None:
        print(
            f"model files not found under -m {model} "
            f"(x{scale}.param / x{scale}.bin)",
            file=sys.stderr,
        )
        return -1
    parampath, modelpath = resolved

    import torch

    from realsr_tpu_torch.pipeline import run_pipeline
    from realsr_tpu_torch.engine import EngineConfig, RealSR

    n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not gpuid:
        if not n_cuda:
            print(
                "no CUDA device found; pass -g -1 to run on the CPU",
                file=sys.stderr,
            )
            return -1
        gpuid = [0]
    for g in gpuid:
        if g < -1 or g >= n_cuda:
            print("invalid gpu device", file=sys.stderr)
            return -1
    if all(g == -1 for g in gpuid):
        # the reference gives the CPU engine -j's proc count of threads
        # (main.cpp:734-746)
        from realsr_tpu_torch.utils.cputhreads import (
            configure_cpu_threads,
            notice_cpu_threads_ignored,
        )

        if not configure_cpu_threads(jobs_proc[0] if jobs_proc else 2, verbose=verbose):
            notice_cpu_threads_ignored()

    n_dev = len(gpuid)
    if not jobs_proc:
        jobs_proc = [2] * n_dev  # main.cpp:708-711
    if not tilesize:
        tilesize = [0] * n_dev

    cpu_count = os.cpu_count() or 1
    jobs_load = min(jobs_load, cpu_count)
    jobs_save = min(jobs_save, cpu_count)

    storage = os.environ.get("REALSR_TPU_STORAGE", "auto")

    # multi-GPU mesh mode (REALSR_TPU_MESH=all|i,j,...): ONE engine dealing
    # each image's tile chunks to the selected devices, instead of the
    # reference's independent per-device engines stealing whole images (-g)
    mesh_env = os.environ.get("REALSR_TPU_MESH", "")
    mesh = None
    if mesh_env:
        from realsr_tpu_torch.parallel.mesh import mesh_from_env, pool_for

        try:
            # -g -1 draws the mesh from the CPU, else from the CUDA devices
            mesh = mesh_from_env(mesh_env, pool_for(gpuid))
        except ValueError as ex:
            print(str(ex), file=sys.stderr)
            return -1
        gpuid = gpuid[:1]  # one mesh engine replaces the per-device pool

    engines = []
    for i, g in enumerate(gpuid):
        cfg = EngineConfig(tilesize=tilesize[i], prepadding=prepadding, storage=storage)
        try:
            e = RealSR(gpuid=g, tta_mode=tta_mode, num_threads=jobs_proc[i], config=cfg, mesh=mesh)
            e.load(parampath, modelpath)
        except (ValueError, OSError, NotImplementedError) as ex:
            # corrupt or unsupported model files, or a mode the port lacks:
            # a clean diagnostic and an error exit, like ncnn's load failure
            print(f"load model failed: {ex}", file=sys.stderr)
            return -1
        engines.append(e)
        if mesh is not None and verbose:
            print(
                f"mesh mode: {mesh.size} devices, whole tile chunks dealt in turn to "
                + ", ".join(str(d) for d in mesh.devices),
                file=sys.stderr,
            )

    # Optional warm-up (REALSR_TPU_PRECOMPILE=1): build the kernels the
    # engines launch and capture the first image's chunk programs before
    # the pipeline starts, as the JAX CLI compiles its programs
    image_batch = max(1, _atoi(os.environ.get("REALSR_TPU_IMAGE_BATCH", "1")))
    if os.environ.get("REALSR_TPU_PRECOMPILE", "0") not in ("0", "") and input_files:
        try:
            # decode with the pipeline's own codec path, so the channel
            # count cannot differ from what proc_worker will see
            from realsr_tpu_torch.io.codecs import decode_image

            img0 = decode_image(input_files[0])
            if img0 is None:
                raise ValueError(f"cannot decode {input_files[0]}")
            h0, w0, ch = img0.shape
            for e in engines:
                n = e.precompile(w0, h0, channels=ch)
                # the stack a proc thread drains is another program set
                nb = min(image_batch, e.max_batch_images((h0, w0, ch)))
                if nb > 1:
                    n += e.precompile(w0, h0, channels=ch, n_img=nb)
                if verbose:
                    print(f"precompiled {n} programs for {w0}x{h0}", file=sys.stderr)
        except Exception as ex:  # warm-up must never break processing
            print(f"precompile skipped: {ex}", file=sys.stderr)

    run_pipeline(
        input_files,
        output_files,
        engines,
        jobs_proc,
        jobs_load=jobs_load,
        jobs_save=jobs_save,
        verbose=verbose,
        image_batch=image_batch,
    )
    return 0
