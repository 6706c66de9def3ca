"""Model loading: ncnn files -> a forward-callable bundle.

Counterpart of ``realsr_tpu/loader.py``: parse the .param, read the .bin,
match the RRDBNet structure and stack (and, for the CUDA kernels, pack) the
weights. Graphs the matcher rejects, and every graph with
``allow_fast_path=False``, run on the generic ncnn executor
(``graph/executor.py``) at the operand type, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from realsr_tpu_torch.graph.executor import build_forward, convert_weights_oihw
from realsr_tpu_torch.ncnn.bin import load_weights
from realsr_tpu_torch.ncnn.param import ParamGraph, parse_param_file
from realsr_tpu_torch.graph.rrdb_match import extract_stacked_params, match_rrdbnet
from realsr_tpu_torch.models.rrdbnet import (
    TAIL_MODES,
    RRDBNetSpec,
    repack_scatter,
    rrdbnet_forward,
    trunk_mode_error,
)

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


@dataclasses.dataclass
class ModelBundle:
    forward: Callable[[Any, torch.Tensor], torch.Tensor]
    params: Any  # numpy arrays, or CPU tensors for the packed kernel weights
    scale: int
    spec: Optional[RRDBNetSpec]  # None: the generic executor runs the graph
    graph: ParamGraph
    # the forward's tail form (models.rrdbnet.TAIL_MODES); None on the
    # generic executor, where tail forms do not apply
    tail: Optional[str] = "interleaved"


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
    graph = parse_param_file(param_path)
    op_dtype = op_dtype if op_dtype is not None else storage_dtype
    match = match_rrdbnet(graph) if allow_fast_path else None
    if match is None:
        generic = build_forward(graph, storage_dtype=op_dtype)

        def forward(p, x):
            return generic(p, x).float()

        params = convert_weights_oihw(load_weights(graph, bin_path))
        return ModelBundle(forward, params, _infer_scale(forward, params), None, graph, None)
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

    return ModelBundle(forward, params, spec.scale, spec, graph, tail)
