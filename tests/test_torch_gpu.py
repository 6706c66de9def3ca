"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Imports no JAX, so it also runs where JAX is absent (the machine with the
card): ``python -m pytest --noconftest tests/test_torch_gpu.py -q``
(tests/conftest.py imports JAX). Without a CUDA device every test skips.
"""

import numpy as np
import pytest
import torch

from realsr_tpu_torch.models.rrdbnet import RRDBNetSpec, init_rrdbnet_params, tf32
from realsr_tpu_torch.ops import rdb_kernel as TK
from realsr_tpu_torch.ops import tail_kernel as TLK

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
    with tf32(False):  # the plain versions' float32 convs compute in float32
        yield torch.device("cuda", 0)


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


def _tail_operands(cuda, op_dtype):
    p = init_rrdbnet_params(RRDBNetSpec(num_rrdb=1, nf=64, gc=32), seed=4)
    return {k: v.to(cuda) for k, v in TLK.pack_tail_params(p, op_dtype).items()}


@pytest.mark.gpu
@pytest.mark.parametrize("with_up2", [True, False])
@pytest.mark.parametrize("B,H,W", [(1, 5, 7), (2, 37, 21)])
def test_tail_kernel_matches_plain(cuda, with_up2, B, H, W):
    """K6 (with_up2) and K7 on odd, non-square tiles (ragged 16 x 16
    patches): the kernel's error against the float32 plain tail is at most
    max(2 x the plain bf16 version's, 1e-3), the JAX suite's rule for its
    tail kernel; two runs are bit-equal; one launch is counted per call."""
    fn, ref = (
        (TLK.up2_hr_last_packed, TLK.up2_hr_last_reference)
        if with_up2
        else (TLK.hr_last_packed, TLK.hr_last_reference)
    )
    shape = (B, H + 1, W + 1, 256) if with_up2 else (B, H, W, 1024)
    x = torch.from_numpy(
        np.abs(np.random.default_rng(5).normal(0, 0.5, shape)).astype(np.float32)
    ).to(cuda, torch.bfloat16)
    tp = _tail_operands(cuda, torch.bfloat16)
    launches = TLK.LAUNCHES[fn.__name__]
    got = fn(x, tp)
    torch.cuda.synchronize()
    assert TLK.LAUNCHES[fn.__name__] == launches + 1
    assert got.shape == (B, 4 * H, 4 * W, 3) and got.dtype == torch.float32
    exact = ref(x.float(), _tail_operands(cuda, torch.float32))
    e_plain = (ref(x, tp) - exact).abs().max().item()
    e_kernel = (got - exact).abs().max().item()
    assert e_kernel <= max(2 * e_plain, 1e-3), (e_kernel, e_plain)
    assert torch.equal(got, fn(x, tp))


@pytest.mark.gpu
def test_tail_kernel_has_no_float32_instance(cuda):
    tp = _tail_operands(cuda, torch.float32)
    x = torch.zeros((1, 6, 6, 256), device=cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
        TLK.up2_hr_last_packed(x, tp)
