"""Model loading: ncnn files -> a forward-callable bundle.

Counterpart of ``realsr_tpu/loader.py``: parse the .param, read the .bin,
match the RRDBNet structure and stack (and, for the CUDA kernels, pack) the
weights. Graphs the matcher rejects need the generic ncnn executor, which is
not ported yet: they raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

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
    spec: RRDBNetSpec
    graph: ParamGraph
    tail: str = "interleaved"  # the forward's tail form (models.rrdbnet.TAIL_MODES)


def load_model(
    param_path: str,
    bin_path: str,
    storage_dtype=torch.float32,
    op_dtype=None,
    variant: str = "dense",
    tail: str = "interleaved",
    trunk: str = "per_rdb",
    sched: str = "scatter",
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
    raises ``ValueError``."""
    graph = parse_param_file(param_path)
    match = match_rrdbnet(graph)
    if match is None:
        raise NotImplementedError(
            f"{param_path} is not an RRDBNet graph; other ncnn graphs need the "
            "generic executor (realsr_tpu/graph/executor.py), which the PyTorch "
            "port does not have yet (ROADMAP queue 1)"
        )
    op_dtype = op_dtype if op_dtype is not None else storage_dtype
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
