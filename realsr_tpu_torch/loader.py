"""Model loading: model files -> a forward-callable bundle.

Counterpart of ``realsr_tpu/loader.py``: parse the .param, read the .bin,
match the RRDBNet structure and stack (and, for the CUDA kernels, pack) the
weights. Graphs the matcher rejects, and every graph with
``allow_fast_path=False``, run on the generic ncnn executor
(``graph/executor.py``) at the operand type, as in the JAX package.

A second format names its architecture: a ``.json`` of a SwinIR model's
constructor settings with a ``.pth`` state dict in SwinIR's published key
layout (``models/swinir.py``), in the place of the .param and .bin.

The forms a model runs in (precision, variant, trunk, schedule, tail) are
decided here, once a load, by :func:`resolve_forms`; the bundle carries
them (:class:`Forms`), and the engine and the forwards take them as given.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Optional, Union

import torch

from realsr_tpu_torch.graph.executor import build_forward, convert_weights_oihw
from realsr_tpu_torch.ncnn.bin import load_weights
from realsr_tpu_torch.ncnn.param import ParamGraph, parse_param_file
from realsr_tpu_torch.graph.rrdb_match import extract_stacked_params, match_rrdbnet
from realsr_tpu_torch.models import rrdbnet as R
from realsr_tpu_torch.models import swinir as S
from realsr_tpu_torch.models.rrdbnet import (
    SCHEDS,
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
# storage mode -> (storage dtype, operand dtype); mixed: float32 carried
# state, bfloat16 conv operands
PRECISIONS = {
    "float32": (torch.float32, torch.float32),
    "mixed": (torch.float32, torch.bfloat16),
    "bfloat16": (torch.bfloat16, torch.bfloat16),
    "float16": (torch.float16, torch.float16),
}


@dataclasses.dataclass(frozen=True)
class Forms:
    """The forms a model runs in, as :func:`resolve_forms` resolved them. A
    field that does not apply is None: the generic executor has no variant,
    trunk, schedule or tail; SwinIR has no trunk or schedule."""

    storage_dtype: torch.dtype
    op_dtype: torch.dtype
    variant: Optional[str] = None  # models.rrdbnet's "dense" | "scatter" | "cuda"
    trunk: Optional[str] = None  # models.rrdbnet.TRUNK_MODES
    sched: Optional[str] = None  # models.rrdbnet.SCHEDS
    tail: Optional[str] = None  # models.rrdbnet.TAIL_MODES, SwinIR's TAIL_FORMS


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


def resolve_forms(spec, platform: Optional[str], storage="auto", variant: str = "auto", tail: str = "auto",
                  trunk: str = "auto", sched: str = "scatter") -> Forms:
    """The forms a model of architecture ``spec`` (``RRDBNetSpec``,
    ``SwinIRSpec``, or None for the generic executor) runs in, for a
    request spelled as ``EngineConfig`` spells it. What cannot run raises
    ``ValueError`` (``NotImplementedError`` where a kernel lacks the
    operand type): a trunk form the variant or precision cannot run
    (``models.rrdbnet.trunk_mode_error``), a kernel tail without an
    instance (:func:`kernel_tail_error`), a packed tail on other than two
    upsamplers, and a SwinIR model on the kernel variant without K8 / K9 / K10
    instances (``models.swinir.kernel_error``) or on a card on another.

    ``platform`` "gpu" or "cpu" resolves an engine's request as the JAX
    engine does: storage "auto" is mixed on a card, float32 on the CPU;
    variant "auto" is "cuda" on a card but for float16, which takes its
    conv path, "dense" (realsr_tpu/engine.py:259-270), as on the CPU; tail
    "auto" takes ``REALSR_TPU_PACKED_TAIL``'s level where it is set (a
    non-digit is 0, else ``min(int, 3)``), stays "auto" on a card's kernel
    variant and is "interleaved" elsewhere (:287-336); on the kernel
    variant trunk "auto" follows ``models.rrdbnet``'s flags
    ``CHAINED_TRUNK`` and, in mixed mode, ``PAIRED_CARRY``, and
    ``REALSR_TPU_SCHED`` ("scatter" or "packed" exactly) overrides
    ``sched``. ``platform`` None takes the forms as given (``load_model``;
    ``storage`` a (storage, operand) dtype pair; no environment, no flags).
    Tail "auto" is then K6 where the tail kernel has an instance for the
    architecture and the operand type, else "interleaved"."""
    engine = platform is not None
    if isinstance(storage, str):
        mode = ("mixed" if platform == "gpu" else "float32") if storage == "auto" else storage
        if mode not in PRECISIONS:
            raise ValueError(f"unknown storage mode {storage!r}")
        dtype, op_dtype = PRECISIONS[mode]
    else:
        dtype, op_dtype = storage
    if variant == "auto":
        variant = "cuda" if platform == "gpu" and dtype != torch.float16 else "dense"
    if engine and variant == "cuda" and dtype == torch.float16:
        raise NotImplementedError(
            "the fused RDB kernel has no float16 instance (the JAX package runs "
            "float16 on its conv path too); pass variant='dense' to run float16 on plain convs"
        )
    if spec is None:
        return Forms(dtype, op_dtype)
    if engine and tail == "auto":
        raw = os.environ.get("REALSR_TPU_PACKED_TAIL", "")
        if raw:
            tail = TAIL_MODES[min(int(raw), 3) if raw.isdigit() else 0]
        elif platform != "gpu" or variant != "cuda":
            tail = "interleaved"
    swin = isinstance(spec, S.SwinIRSpec)
    if swin:
        err = variant == "cuda" and S.kernel_error(spec, dtype, op_dtype)
        trunk = sched = None
    else:
        if engine and variant == "cuda":
            if trunk == "auto":
                mixed = (dtype, op_dtype) == (torch.float32, torch.bfloat16)
                trunk = "chained" if R.CHAINED_TRUNK else "paired" if R.PAIRED_CARRY and mixed else "per_rdb"
            raw = os.environ.get("REALSR_TPU_SCHED", "")
            sched = raw if raw in SCHEDS else sched
        elif engine and trunk == "auto":
            trunk = "per_rdb"
        err = trunk_mode_error(variant, trunk, sched, dtype, op_dtype)
    if err:
        raise ValueError(err)
    # SwinIR ends on RRDBNet's tail after conv_before_upsample
    tail_err = kernel_tail_error(RRDBNetSpec(nf=S.NUM_FEAT) if swin else spec, op_dtype)
    tails = S.TAIL_FORMS if swin else TAIL_MODES
    if tail == "auto":
        tail = "kernel" if tail_err is None else "interleaved"
    elif tail not in tails:
        raise ValueError(f"unknown tail {tail!r}: {'SwinIR' if swin else 'RRDBNet'} runs the tails {tails} or 'auto'")
    elif tail in KERNEL_TAILS and tail_err is not None:
        raise tail_err
    if swin and platform == "gpu" and variant != "cuda":
        raise ValueError(f"a SwinIR model runs on a card on its kernels only (variant 'cuda', mixed precision), "
                         f"not on variant {variant!r} with {dtype} storage; run it on the CPU (gpuid -1)")
    if not swin and variant not in ("dense", "scatter", "cuda"):
        raise ValueError(f"unknown variant {variant!r}")
    if not swin and tail != "interleaved" and spec.num_upsample != 2:
        raise ValueError(f"the packed tail needs two upsamplers, the graph has {spec.num_upsample}")
    return Forms(dtype, op_dtype, variant, trunk, sched, tail)


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
    forms: Forms  # the forms the forward runs in
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

    @property
    def tail(self) -> Optional[str]:
        return self.forms.tail


def _infer_scale(forward, params, in_ch: int = 3) -> int:
    """Output / input side of one 1 x 8 x 8 forward on the CPU."""
    y = forward(params, torch.zeros((1, 8, 8, in_ch)))
    scale_h, rem_h = divmod(y.shape[1], 8)
    scale_w, rem_w = divmod(y.shape[2], 8)
    if rem_h or rem_w or scale_h != scale_w:
        raise ValueError(f"non-uniform model scale: 8x8 -> {y.shape[1]}x{y.shape[2]}")
    return scale_h


def _read(param_path: str, allow_fast_path: bool = True) -> tuple:
    """(architecture, graph, RRDBNet match) of a model's first file: a
    SwinIR ``.json``'s settings (no graph); else the parsed ``.param`` and
    its match, whose spec is the architecture (both None where the generic
    executor runs the graph)."""
    if param_path.endswith(".json"):
        return S.read_spec(param_path), None, None
    graph = parse_param_file(param_path)
    match = match_rrdbnet(graph) if allow_fast_path else None
    return (match.spec if match is not None else None), graph, match


def load_for(platform: str, param_path: str, bin_path: str, storage: str = "auto", variant: str = "auto",
             tail: str = "auto", trunk: str = "auto", sched: str = "scatter") -> ModelBundle:
    """The model in the forms an engine on ``platform`` ("gpu" or "cpu")
    runs it in, for a request spelled as ``EngineConfig`` spells it
    (:func:`resolve_forms`)."""
    spec, graph, match = _read(param_path)
    return _bundle(resolve_forms(spec, platform, storage, variant, tail, trunk, sched), spec, graph, match, bin_path)


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
    """The model in the forms given: ``variant`` 'dense' (the graph's
    concat-input convs), 'scatter' (weights regrouped by source, the same
    math) or 'cuda' (the trunk on the fused RDB kernel; weights packed for
    it at ``op_dtype``). ``op_dtype`` defaults to ``storage_dtype``;
    float32 storage with bfloat16 operands is the mixed mode. ``tail``: one
    of ``models.rrdbnet.TAIL_MODES``, or 'auto' for the fused tail kernel
    (K6, 'kernel') where it has an instance for the graph and ``op_dtype``
    and 'interleaved' elsewhere. For the kernel tails the tail weights are
    packed here, once, into ``params["tail"]``. ``trunk`` and ``sched``:
    the kernel trunk's form (``models.rrdbnet.TRUNK_MODES``, ``SCHEDS``);
    the weights are packed for ``sched``. What cannot run raises
    (:func:`resolve_forms` at no platform). A graph the matcher rejects, or
    any graph with ``allow_fast_path=False``, runs on the generic executor
    at ``op_dtype`` (``spec`` None; variant, tail, trunk and sched do not
    apply)."""
    op_dtype = op_dtype if op_dtype is not None else storage_dtype
    spec, graph, match = _read(param_path, allow_fast_path)
    forms = resolve_forms(spec, None, (storage_dtype, op_dtype), variant, tail, trunk, sched)
    return _bundle(forms, spec, graph, match, bin_path)


def _bundle(forms: Forms, spec, graph, match, bin_path: str) -> ModelBundle:
    """The bundle of a model read by :func:`_read`, its weights loaded from
    ``bin_path`` and prepared for ``forms``."""
    if isinstance(spec, S.SwinIRSpec):
        return _swinir_bundle(forms, spec, bin_path)
    if spec is None:
        generic = build_forward(graph, storage_dtype=forms.op_dtype)

        def forward(p, x):
            return generic(p, x).float()

        params = convert_weights_oihw(load_weights(graph, bin_path))
        return ModelBundle(forward, params, _infer_scale(forward, params), None, graph, forms, graphs=False)
    params = extract_stacked_params(match, load_weights(graph, bin_path))
    if forms.variant == "scatter":
        params = repack_scatter(params)
    elif forms.variant == "cuda":
        from realsr_tpu_torch.ops.rdb_kernel import pack_rdb_params

        packed = pack_rdb_params(params["rdb"], forms.op_dtype, forms.sched)
        n_rdb = spec.num_rrdb * spec.num_rdb_per_rrdb
        params = dict(params)
        params["rdb"] = {k: v.reshape(n_rdb, -1) for k, v in packed.items()}
    if forms.tail in KERNEL_TAILS:
        params = dict(params)
        params["tail"] = pack_tail_params(params, forms.op_dtype)

    def forward(p, x):
        return rrdbnet_forward(
            p, x, spec, storage_dtype=forms.storage_dtype, variant=forms.variant,
            op_dtype=forms.op_dtype, tail=forms.tail, trunk=forms.trunk, sched=forms.sched,
        )

    return ModelBundle(forward, params, spec.scale, spec, graph, forms,
                       groups=kernel_groups(forms.variant, forms.trunk, forms.sched, forms.tail, forms.op_dtype,
                                            forms.storage_dtype, spec.nf),
                       tile_bytes=lambda side, dsize: rrdb_tile_bytes(spec.nf, side, dsize))


def _swinir_bundle(forms: Forms, spec: S.SwinIRSpec, pth_path: str) -> ModelBundle:
    """A SwinIR model (``models/swinir.py``) with the weights of the
    ``.pth``. ``variant`` "cuda" runs the attention on K8 and the residual
    adds and LayerNorms on K9; the other variants run the plain forms (the
    CPU's). The preparation (stacking, q's scale, bias tables and packings)
    is the ``swin.prepare`` span."""
    kernels = forms.variant == "cuda"
    with tracer.span("swin.prepare"):
        params = S.params_from_state(S.load_state(pth_path), spec, forms.op_dtype, kernels)
        if forms.tail == "kernel":
            params["tail"] = pack_tail_params({k: {n: t.numpy() for n, t in params[k].items()}
                                               for k in ("up", "hr", "last")}, forms.op_dtype)

    def forward(p, x):
        return S.swinir_forward(p, x, spec, forms.storage_dtype, forms.op_dtype, kernels, forms.tail)

    groups = ((SWIN_BUILD,) if kernels else ()) + tail_groups(forms.tail, forms.op_dtype)
    return ModelBundle(forward, params, spec.scale, spec, None, forms, groups=groups,
                       tile_bytes=lambda side, dsize: S.tile_bytes(spec, side, side),
                       chunk_counts=lambda *a: S.chunk_counts(spec, *a))
