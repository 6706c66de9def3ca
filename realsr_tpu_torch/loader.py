"""Model loading: model files -> a forward-callable bundle.

Counterpart of ``realsr_tpu/loader.py``: parse the .param, read the .bin,
match the RRDBNet structure and stack (and, for the CUDA kernels, pack) the
weights. Graphs the matcher rejects, and every graph with
``allow_fast_path=False``, run on the generic ncnn executor
(``graph/executor.py``) at the operand type, as in the JAX package.

A second format names its architecture: a ``.json`` of a SwinIR model's
constructor settings with a ``.pth`` state dict in SwinIR's published key
layout (``models/swinir.py``), in the place of the .param and .bin.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import torch

from realsr_tpu_torch.graph.executor import build_forward, convert_weights_oihw
from realsr_tpu_torch.ncnn.bin import load_weights
from realsr_tpu_torch.ncnn.param import ParamGraph, parse_param_file
from realsr_tpu_torch.graph.rrdb_match import extract_stacked_params, match_rrdbnet
from realsr_tpu_torch.models import swinir as S
from realsr_tpu_torch.models.rrdbnet import (
    TAIL_MODES,
    RRDBNetSpec,
    repack_scatter,
    rrdbnet_forward,
    trunk_mode_error,
)
from realsr_tpu_torch.ops.rdb_kernel import rdb_group
from realsr_tpu_torch.ops.swin_kernel import BUILD as SWIN_BUILD
from realsr_tpu_torch.ops.tail_kernel import K6, K7, TAIL_GROUPS, pack_tail_params
from realsr_tpu_torch.utils.trace import tracer

# the tail forms that run on the fused tail kernel (ops/tail_kernel.py)
KERNEL_TAILS = ("kernel_hr", "kernel")


def kernel_tail_error(spec: RRDBNetSpec, op_dtype) -> Optional[Exception]:
    """Why the tail kernel has no instance for ``spec`` and ``op_dtype``,
    or None: it takes nf = 64, 3 outputs, two upsamplers, bfloat16 or
    float32 operands."""
    from realsr_tpu_torch.ops.tail_kernel import NF, OUTC

    if (spec.nf, spec.out_ch, spec.num_upsample) != (NF, OUTC, 2):
        return ValueError(
            f"the tail kernel is fixed at nf={NF}, out_ch={OUTC}, two upsamplers; "
            f"the graph has nf={spec.nf}, out_ch={spec.out_ch}, "
            f"{spec.num_upsample} upsamplers"
        )
    if op_dtype not in (torch.bfloat16, torch.float32):
        return NotImplementedError(
            f"the tail kernel has bfloat16 and float32 instances, none for {op_dtype}"
        )
    return None


def kernel_groups(variant, trunk, sched, tail, op_dtype, storage_dtype, nf: int = 64) -> tuple:
    """The (source, group) libraries (``ops/build.py::GROUPS``) whose
    kernels an RRDBNet forward of this resolved form launches: the trunk's
    (K1/K2, or the mode kernels K3-K5) at the state type and width, and the
    kernel tail's form (K6 or K7), in the operand type's instance (3xTF32
    for float32)."""
    f32 = op_dtype == torch.float32
    out = []
    if variant == "cuda":
        group = rdb_group(torch.float32 if f32 else storage_dtype, nf)
        if trunk == "per_rdb" and sched == "scatter":
            out.append(("rdb_tf32" if f32 else "rdb_wgmma", group))
        else:
            out.append(("rdb_modes_tf32" if f32 else "rdb_modes_wgmma", group))
    return tuple(out) + tail_groups(tail, op_dtype)


def tail_groups(tail, op_dtype) -> tuple:
    """The kernel tail's library (K6 or K7) at the operand type, or none."""
    if tail not in KERNEL_TAILS:
        return ()
    src = "tail_tf32" if op_dtype == torch.float32 else "tail_kernel"
    return ((src, TAIL_GROUPS[K6 if tail == "kernel" else K7]),)


def rrdb_tile_bytes(nf: int, side: int, dsize: int) -> int:
    """RRDBNet's chunk bytes per padded tile of ``side``: the tail's
    nf-channel activations at 16x the tile's area."""
    return 16 * side * side * nf * dsize


@dataclasses.dataclass
class ModelBundle:
    forward: Callable[[Any, torch.Tensor], torch.Tensor]
    params: Any  # numpy arrays, or CPU tensors for the packed kernel weights
    scale: int
    spec: Union[RRDBNetSpec, S.SwinIRSpec, None]  # None: the generic executor runs the graph
    graph: Optional[ParamGraph]  # None for a SwinIR model
    # the forward's tail form (models.rrdbnet.TAIL_MODES); None on the
    # generic executor, where tail forms do not apply
    tail: Optional[str] = "interleaved"
    # the (source, group) kernel libraries the forward launches on a card
    groups: tuple = ()
    # whether a chunk's forward may be captured in a CUDA graph: the fast
    # paths; the generic executor's layers upload constants on each call
    graphs: bool = True
    # device bytes a chunk holds per tile of a padded side at a storage
    # itemsize (the engine's chunk granule, engine._auto_batch)
    tile_bytes: Callable[[int, int], int] = lambda side, dsize: rrdb_tile_bytes(64, side, dsize)
    # the model's tracer counters of one chunk (ph, pw, batch, real tiles,
    # halo) -> {name: count}, counted at dispatch
    chunk_counts: Optional[Callable[[int, int, int, int, int], dict]] = None


def _infer_scale(forward, params, in_ch: int = 3) -> int:
    """Output / input side of one 1 x 8 x 8 forward on the CPU."""
    y = forward(params, torch.zeros((1, 8, 8, in_ch)))
    scale_h, rem_h = divmod(y.shape[1], 8)
    scale_w, rem_w = divmod(y.shape[2], 8)
    if rem_h or rem_w or scale_h != scale_w:
        raise ValueError(f"non-uniform model scale: 8x8 -> {y.shape[1]}x{y.shape[2]}")
    return scale_h


def load_model(
    param_path: str,
    bin_path: str,
    storage_dtype=torch.float32,
    op_dtype=None,
    variant: str = "dense",
    tail: str = "interleaved",
    trunk: str = "per_rdb",
    sched: str = "scatter",
    allow_fast_path: bool = True,
) -> ModelBundle:
    """``variant``: 'dense' (the graph's concat-input convs), 'scatter'
    (weights regrouped by source, the same math) or 'cuda' (the trunk on the
    fused RDB kernel; weights packed for it at ``op_dtype``). ``op_dtype``
    defaults to ``storage_dtype``; float32 storage with bfloat16 operands is
    the mixed mode. ``tail``: one of ``models.rrdbnet.TAIL_MODES``, or
    'auto' for the fused tail kernel (K6, 'kernel') where it has an
    instance for the graph and ``op_dtype`` and 'interleaved' elsewhere.
    For the kernel tails the tail weights are packed here, once, into
    ``params["tail"]``; an explicit kernel tail that the graph or operand
    type has no instance for raises. ``trunk`` and ``sched``: the kernel
    trunk's form (``models.rrdbnet.TRUNK_MODES``, ``SCHEDS``); the weights
    are packed for ``sched``, and a combination the JAX package cannot run
    raises ``ValueError``. A graph the matcher rejects, or any graph with
    ``allow_fast_path=False``, runs on the generic executor at ``op_dtype``
    (``spec`` None; variant, tail, trunk and sched do not apply)."""
    op_dtype = op_dtype if op_dtype is not None else storage_dtype
    if param_path.endswith(".json"):
        return load_swinir(param_path, bin_path, storage_dtype, op_dtype, variant, tail)
    graph = parse_param_file(param_path)
    match = match_rrdbnet(graph) if allow_fast_path else None
    if match is None:
        generic = build_forward(graph, storage_dtype=op_dtype)

        def forward(p, x):
            return generic(p, x).float()

        params = convert_weights_oihw(load_weights(graph, bin_path))
        return ModelBundle(forward, params, _infer_scale(forward, params), None, graph, None, graphs=False)
    err = trunk_mode_error(variant, trunk, sched, storage_dtype, op_dtype)
    if err:
        raise ValueError(err)
    spec = match.spec
    err = kernel_tail_error(spec, op_dtype)
    if tail == "auto":
        tail = "kernel" if err is None else "interleaved"
    elif tail not in TAIL_MODES:
        raise ValueError(f"unknown tail {tail!r}; expected 'auto' or one of {TAIL_MODES}")
    elif tail in KERNEL_TAILS and err is not None:
        raise err
    params = extract_stacked_params(match, load_weights(graph, bin_path))
    if variant == "scatter":
        params = repack_scatter(params)
    elif variant == "cuda":
        from realsr_tpu_torch.ops.rdb_kernel import pack_rdb_params

        packed = pack_rdb_params(params["rdb"], op_dtype, sched)
        n_rdb = spec.num_rrdb * spec.num_rdb_per_rrdb
        params = dict(params)
        params["rdb"] = {k: v.reshape(n_rdb, -1) for k, v in packed.items()}
    elif variant != "dense":
        raise ValueError(f"unknown variant {variant!r}")
    if tail in KERNEL_TAILS:
        from realsr_tpu_torch.ops.tail_kernel import pack_tail_params

        params = dict(params)
        params["tail"] = pack_tail_params(params, op_dtype)

    def forward(p, x):
        return rrdbnet_forward(
            p, x, spec, storage_dtype=storage_dtype, variant=variant,
            op_dtype=op_dtype, tail=tail, trunk=trunk, sched=sched,
        )

    return ModelBundle(forward, params, spec.scale, spec, graph, tail,
                       groups=kernel_groups(variant, trunk, sched, tail, op_dtype, storage_dtype, spec.nf),
                       tile_bytes=lambda side, dsize: rrdb_tile_bytes(spec.nf, side, dsize))


def load_swinir(json_path: str, pth_path: str, storage_dtype, op_dtype, variant: str = "dense",
                tail: str = "interleaved") -> ModelBundle:
    """A SwinIR model (``models/swinir.py``): the settings from the
    ``.json``, the weights from the ``.pth``. ``variant`` "cuda" runs the
    attention on K8 and the residual adds and LayerNorms on K9, which have
    instances for mixed precision (float32 storage, bfloat16 operands) at
    width 240 in 8 heads of 30 and window 8 alone: another precision or
    width raises ``ValueError`` naming what is missing. The other variants
    run the plain forms (the CPU's). ``tail`` "auto" is K6 for bfloat16 and
    float32 operands, else the interleaved convs; "kernel" or "interleaved"
    as given; the other tail forms raise ``ValueError``. The preparation
    (stacking, q's scale, bias tables and packings) is the ``swin.prepare``
    span."""
    spec = S.read_spec(json_path)
    kernels = variant == "cuda"
    if kernels and S.kernel_error(spec, storage_dtype, op_dtype):
        raise ValueError(f"{json_path}: {S.kernel_error(spec, storage_dtype, op_dtype)}")
    err = kernel_tail_error(RRDBNetSpec(nf=S.NUM_FEAT), op_dtype)  # RRDBNet's tail after conv_before_upsample
    if tail == "auto":
        tail = "kernel" if err is None else "interleaved"
    elif tail not in S.TAIL_FORMS:
        raise ValueError(f"SwinIR runs the tails {S.TAIL_FORMS} (or 'auto'), not {tail!r}")
    elif tail == "kernel" and err is not None:
        raise err
    with tracer.span("swin.prepare"):
        params = S.params_from_state(S.load_state(pth_path), spec, op_dtype, kernels)
        if tail == "kernel":
            params["tail"] = pack_tail_params({k: {n: t.numpy() for n, t in params[k].items()}
                                               for k in ("up", "hr", "last")}, op_dtype)

    def forward(p, x):
        return S.swinir_forward(p, x, spec, storage_dtype, op_dtype, kernels, tail)

    groups = ((SWIN_BUILD,) if kernels else ()) + tail_groups(tail, op_dtype)
    return ModelBundle(forward, params, spec.scale, spec, None, tail, groups=groups,
                       tile_bytes=lambda side, dsize: S.tile_bytes(spec, side, side),
                       chunk_counts=lambda *a: S.chunk_counts(spec, *a))
