"""The port's CUDA kernel on the card, against its plain PyTorch version.

Imports no JAX, so it also runs where JAX is absent (the machine with the
card): ``python -m pytest --noconftest tests/test_torch_gpu.py -q``
(tests/conftest.py imports JAX). Without a CUDA device every test skips.
"""

import numpy as np
import pytest
import torch

from realsr_tpu_torch.models.rrdbnet import disable_tf32
from realsr_tpu_torch.ops import rdb_kernel as TK

torch.set_num_threads(2)


def _packed(nf, gc, op_dtype, seed=8, wstd=0.05):
    """One RDB's random OIHW weights, packed for the kernel."""
    rng = np.random.default_rng(seed)
    p = {}
    for i in range(1, 6):
        cin, cout = nf + (i - 1) * gc, gc if i < 5 else nf
        p[f"w{i}"] = rng.normal(0, wstd, (cout, cin, 3, 3)).astype(np.float32)
        p[f"b{i}"] = rng.normal(0, 0.05, (cout,)).astype(np.float32)
    return TK.pack_rdb_params(p, op_dtype)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    disable_tf32()  # the plain version's float32 convs compute in float32
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "state,op,nf,gc,tol",
    [
        (torch.float32, torch.float32, 16, 8, 1e-4),  # CUDA cores
        (torch.float32, torch.bfloat16, 32, 16, 1e-3),  # tensor cores, mixed
        (torch.bfloat16, torch.bfloat16, 32, 16, 1e-2),  # bf16 state: 1 ulp
    ],
)
def test_kernel_matches_plain(cuda, state, op, nf, gc, tol):
    """Odd tile sizes (partial patches), with and without the RRDB
    residual; the kernel's launch count moves by one per call."""
    x = torch.from_numpy(
        np.random.default_rng(7).random((2, 23, 17, nf)).astype(np.float32)
    ).to(cuda, state)
    p = {k: v.to(cuda) for k, v in _packed(nf, gc, op).items()}
    for u in (None, x * 0.5):
        launches = TK.LAUNCHES
        got = TK.rdb_apply(x, p, u)
        torch.cuda.synchronize()
        assert TK.LAUNCHES == launches + 1
        want = TK.rdb_reference(x, p, state, op, u)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol * max(1.0, want.float().abs().max().item())


@pytest.mark.gpu
def test_kernel_rejects_shapes_it_has_no_instance_for(cuda):
    x = torch.zeros((1, 8, 8, 16), device=cuda)
    p = {k: v.to(cuda) for k, v in _packed(16, 16, torch.bfloat16).items()}
    with pytest.raises(ValueError, match="no tensor-core kernel"):
        TK.rdb_apply(x, p)
