"""Model loading: ncnn files -> a forward-callable bundle.

Counterpart of ``realsr_tpu/loader.py``: parse the .param, read the .bin,
match the RRDBNet structure and stack (and, for the CUDA kernel, pack) the
weights. Graphs the matcher rejects need the generic ncnn executor, which is
not ported yet: they raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from realsr_tpu.ncnn.bin import load_weights
from realsr_tpu.ncnn.param import ParamGraph, parse_param_file
from realsr_tpu_torch.graph.rrdb_match import extract_stacked_params, match_rrdbnet
from realsr_tpu_torch.models.rrdbnet import RRDBNetSpec, repack_scatter, rrdbnet_forward


@dataclasses.dataclass
class ModelBundle:
    forward: Callable[[Any, torch.Tensor], torch.Tensor]
    params: Any  # numpy arrays, or CPU tensors for the packed RDB weights
    scale: int
    spec: RRDBNetSpec
    graph: ParamGraph


def load_model(
    param_path: str,
    bin_path: str,
    storage_dtype=torch.float32,
    op_dtype=None,
    variant: str = "dense",
) -> ModelBundle:
    """``variant``: 'dense' (the graph's concat-input convs), 'scatter'
    (weights regrouped by source, the same math) or 'cuda' (the trunk on the
    fused RDB kernel; weights packed for it at ``op_dtype``). ``op_dtype``
    defaults to ``storage_dtype``; float32 storage with bfloat16 operands is
    the mixed mode."""
    graph = parse_param_file(param_path)
    match = match_rrdbnet(graph)
    if match is None:
        raise NotImplementedError(
            f"{param_path} is not an RRDBNet graph; other ncnn graphs need the "
            "generic executor (realsr_tpu/graph/executor.py), which the PyTorch "
            "port does not have yet (ROADMAP queue 1)"
        )
    op_dtype = op_dtype if op_dtype is not None else storage_dtype
    spec = match.spec
    params = extract_stacked_params(match, load_weights(graph, bin_path))
    if variant == "scatter":
        params = repack_scatter(params)
    elif variant == "cuda":
        from realsr_tpu_torch.ops.rdb_kernel import pack_rdb_params

        packed = pack_rdb_params(params["rdb"], op_dtype)
        n_rdb = spec.num_rrdb * spec.num_rdb_per_rrdb
        params = dict(params)
        params["rdb"] = {k: v.reshape(n_rdb, -1) for k, v in packed.items()}
    elif variant != "dense":
        raise ValueError(f"unknown variant {variant!r}")

    def forward(p, x):
        return rrdbnet_forward(
            p, x, spec, storage_dtype=storage_dtype, variant=variant,
            op_dtype=op_dtype,
        )

    return ModelBundle(forward, params, spec.scale, spec, graph)
