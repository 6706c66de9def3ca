"""RRDBNet (ESRGAN-style) forward in PyTorch.

Counterpart of ``realsr_tpu/models/rrdbnet.py``. The DF2K graph
(models/models-DF2K/x4.param) is: conv_first (3 -> nf) -> num_rrdb x RRDB ->
trunk conv + long skip -> num_upsample x (nearest-x2 + conv + lrelu) ->
HRconv + lrelu -> conv_last (nf -> 3). An RRDB is three residual dense
blocks (RDB) and the residual ``0.2 * chain + x``; an RDB is five densely
concatenated 3x3 convs with LeakyReLU(0.2) on the first four and the
residual ``0.2 * c5 + x``.

Precision follows the JAX package: convs read ``op_dtype`` operands and sum
in float32; carried activations are rounded to ``storage_dtype``. Storage
float32 with bfloat16 operands is the mixed mode. Every conv rounds its
operands to ``op_dtype`` and runs in float32, which is the JAX package's
``preferred_element_type=float32``. For float32 operands on a GPU, TF32
must be off (:func:`tf32` with ``allowed=False``, which the engine enters
around each chunk) to match the JAX package's ``Precision.HIGHEST``;
bfloat16 and float16 values are exact in TF32, so for them TF32 changes
only the order of the sums.

The tail after the trunk comes in two forms: the interleaved one (nearest-x2
and 3x3 convs at 2x and 4x resolution, as the graph reads) and the
packed-phase one (:func:`packed_tail`), which computes every stage at base
resolution with the 2x and 4x output phases as channel groups, as the JAX
package's ``_packed_tail`` does, and can hand its deep stages to the fused
tail kernels (``ops/tail_kernel.py``).

Parameters are numpy or torch trees of OIHW convs (:func:`params_from_jax`
converts the JAX package's HWIO trees). Public functions take and return
NHWC like the JAX package; internally the convs run on NCHW views.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from realsr_tpu_torch.ops.resize import nearest_x2

LRELU_SLOPE = 0.2
RESIDUAL_SCALE = 0.2

# The kernel trunk's alternative modes, off by default as in the JAX package
# (its models/rrdbnet.py:54 and :68); EngineConfig(trunk="auto") reads them
# at load. CHAINED_TRUNK runs the trunk on K3, the chained layout;
# PAIRED_CARRY (mixed mode only) carries the state as bf16 hi + lo planes
# on K4. Chained beats paired when both are set.
CHAINED_TRUNK = False
PAIRED_CARRY = False

# rrdbnet_forward's trunk modes for variant 'cuda' ('per_rdb': K1 per RDB
# with the RRDB residual in every third launch) and RDB schedules ('packed':
# K5, for the per-RDB trunk only)
TRUNK_MODES = ("per_rdb", "chained", "paired")
SCHEDS = ("scatter", "packed")


def trunk_mode_error(variant, trunk, sched, storage_dtype, op_dtype) -> Optional[str]:
    """Why ``trunk`` / ``sched`` cannot run with this variant and precision
    (a combination the JAX package cannot run either), or None. The modes
    belong to the kernel trunk (variant 'cuda'); the packed schedule only to
    its per-RDB form (JAX's chained, paired and resident kernels never take
    it); the paired carry only to mixed mode (float32 state, bfloat16
    operands)."""
    if trunk not in TRUNK_MODES:
        return f"unknown trunk {trunk!r}; expected one of {TRUNK_MODES}"
    if sched not in SCHEDS:
        return f"unknown sched {sched!r}; expected one of {SCHEDS}"
    if (trunk, sched) == ("per_rdb", "scatter"):
        return None
    if variant != "cuda":
        return f"trunk={trunk!r}, sched={sched!r} run on the RDB kernels (variant 'cuda'), not {variant!r}"
    if sched == "packed" and trunk != "per_rdb":
        return f"the packed schedule runs on the per-RDB trunk only, not trunk={trunk!r}"
    if trunk == "paired" and (storage_dtype, op_dtype) != (torch.float32, torch.bfloat16):
        return (
            "the paired carry runs in mixed mode only (float32 state, bfloat16 operands), "
            f"not {storage_dtype} / {op_dtype}"
        )
    return None


@dataclasses.dataclass(frozen=True)
class RRDBNetSpec:
    """Static architecture hyperparameters recovered from the .param graph."""

    num_rrdb: int = 23
    num_rdb_per_rrdb: int = 3
    nf: int = 64
    gc: int = 32
    in_ch: int = 3
    out_ch: int = 3
    num_upsample: int = 2  # nearest-x2 stages => scale = 2**num_upsample

    @property
    def scale(self) -> int:
        return 2**self.num_upsample


def _set_tf32(allowed: bool) -> None:
    torch.backends.cudnn.allow_tf32 = allowed
    torch.backends.cuda.matmul.allow_tf32 = allowed


# tf32's shared state, under one condition variable: each holding thread's
# stack of settings (innermost last), and the flags saved when the first
# holder entered. Whenever two threads hold scopes, every scope held has the
# same setting, so the flags in force are that setting.
_TF32_COND = threading.Condition()
_TF32_HELD: Dict[int, List[bool]] = {}
_TF32_SAVED: List[tuple] = []


def _tf32_may_enter(me: int, allowed: bool) -> bool:
    if all(t == me for t in _TF32_HELD):
        return True  # no other holder: any setting, nested or not
    return all(s == allowed for stack in _TF32_HELD.values() for s in stack)


@contextlib.contextmanager
def tf32(allowed: bool):
    """Set whether cuDNN convs and CUDA matmuls may use TF32 inside the
    block. torch has no per-call switch, so the flags are process-global
    while a block runs, and the scope is shared between threads: a thread
    enters when no other thread holds a scope, or when every scope held has
    the setting it wants (two proc threads of one engine run concurrently);
    otherwise it waits. A thread alone may nest the other setting; two
    threads that each hold a scope and each wait to nest the other setting
    wait for each other for ever, so nest the other setting in one thread
    only (the engine nests none). On exit the flags return to the enclosing
    scope's setting, and to the flags saved on the first entry when the
    last holder leaves."""
    me = threading.get_ident()
    with _TF32_COND:
        _TF32_COND.wait_for(lambda: _tf32_may_enter(me, allowed))
        if not _TF32_HELD:
            _TF32_SAVED[:] = [(torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)]
        _TF32_HELD.setdefault(me, []).append(allowed)
        _set_tf32(allowed)
    try:
        yield
    finally:
        with _TF32_COND:
            stack = _TF32_HELD[me]
            stack.pop()
            if stack:
                _set_tf32(stack[-1])
            else:
                del _TF32_HELD[me]
                if not _TF32_HELD:
                    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = _TF32_SAVED.pop()
            _TF32_COND.notify_all()


def operand(t: torch.Tensor, op_dtype) -> torch.Tensor:
    """``t`` rounded to ``op_dtype``, as float32."""
    return t.float() if op_dtype == torch.float32 else t.to(op_dtype).float()


def conv3x3(x, w, b, slope=None, op_dtype=None):
    """3x3 stride-1 pad-1 conv on NCHW ``x`` with OIHW ``w``; float32 sums,
    optional LeakyReLU. Returns float32; the caller rounds to storage."""
    od = op_dtype if op_dtype is not None else x.dtype
    y = F.conv2d(
        operand(x, od), operand(torch.as_tensor(w, device=x.device), od),
        None if b is None else torch.as_tensor(b, device=x.device).float(),
        padding=1,
    )
    return y if slope is None else _lrelu(y, slope)


def _lrelu(v, slope=LRELU_SLOPE):
    return torch.where(v >= 0, v, v * slope)


def _bias(b, ref):
    return torch.as_tensor(b, device=ref.device).float()[:, None, None]


def _rdb_c5(x, p, storage_dtype, op_dtype=None):
    """The last conv of a residual dense block on NCHW ``x``: float32 c5,
    with c1..c4 rounded to ``storage_dtype``."""
    feats = [x]
    for i in range(1, 5):
        c = conv3x3(torch.cat(feats, 1), p[f"w{i}"], p[f"b{i}"], LRELU_SLOPE, op_dtype)
        feats.append(c.to(storage_dtype))
    return conv3x3(torch.cat(feats, 1), p["w5"], p["b5"], None, op_dtype)


def _rdb(x, p, storage_dtype, op_dtype=None):
    """Residual dense block on NCHW ``x`` (storage dtype); returns the same."""
    c5 = _rdb_c5(x, p, storage_dtype, op_dtype)
    return (RESIDUAL_SCALE * c5 + x.float()).to(storage_dtype)


def _rdb_scatter(x, p, storage_dtype, op_dtype=None):
    """The RDB with its weights regrouped by source (see repack_scatter):
    the same math as :func:`_rdb` with the convs' output channels as
    ``(4gc+nf, 3gc+nf, 2gc+nf, gc+nf, nf)``."""
    od = op_dtype
    gc = p["b1"].shape[-1]
    px = conv3x3(x, p["sw0"], None, None, od)
    c1 = _lrelu(px[:, :gc] + _bias(p["b1"], px)).to(storage_dtype)
    p1 = conv3x3(c1, p["sw1"], None, None, od)
    c2 = _lrelu(px[:, gc : 2 * gc] + p1[:, :gc] + _bias(p["b2"], px)).to(storage_dtype)
    p2 = conv3x3(c2, p["sw2"], None, None, od)
    c3 = _lrelu(
        px[:, 2 * gc : 3 * gc] + p1[:, gc : 2 * gc] + p2[:, :gc] + _bias(p["b3"], px)
    ).to(storage_dtype)
    p3 = conv3x3(c3, p["sw3"], None, None, od)
    c4 = _lrelu(
        px[:, 3 * gc : 4 * gc]
        + p1[:, 2 * gc : 3 * gc]
        + p2[:, gc : 2 * gc]
        + p3[:, :gc]
        + _bias(p["b4"], px)
    ).to(storage_dtype)
    p4 = conv3x3(c4, p["sw4"], None, None, od)
    c5 = (
        px[:, 4 * gc :]
        + p1[:, 3 * gc :]
        + p2[:, 2 * gc :]
        + p3[:, gc:]
        + p4
        + _bias(p["b5"], px)
    )
    return (RESIDUAL_SCALE * c5 + x.float()).to(storage_dtype)


def repack_scatter(params):
    """Stacked dense params -> scatter params (numpy, OIHW).

    For source s (0 = the block input x with nf channels, 1..4 = c1..c4 with
    gc channels), concatenate along output channels the input-channel slices
    of w_i (i > s) that multiply source s.
    """
    rdb = params["rdb"]
    gc, nf = rdb["w1"].shape[-4], rdb["w1"].shape[-3]

    def src_slice(i, s):
        lo = s * gc + (nf - gc if s > 0 else 0)
        hi = lo + (nf if s == 0 else gc)
        return rdb[f"w{i}"][..., lo:hi, :, :]

    out = {f"b{i}": rdb[f"b{i}"] for i in range(1, 6)}
    for s in range(5):
        out[f"sw{s}"] = np.concatenate([src_slice(i, s) for i in range(s + 1, 6)], axis=-4)
    new = dict(params)
    new["rdb"] = out
    return new


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _hwio(w: torch.Tensor) -> torch.Tensor:
    """OIHW ``[cout, cin, kh, kw]`` -> HWIO ``[kh, kw, cin, cout]``."""
    return w.permute(2, 3, 1, 0)


def _shift0(x, sy, sx):
    """NHWC ``x`` shifted by (sy, sx) in {-1, 0, 1} with zero fill:
    ``result[:, i, j] = x[:, i + sy, j + sx]``, zero outside: the packed
    tail's stand-in for the interleaved convs' zero padding."""
    if sy == 0 and sx == 0:
        return x
    H, W = x.shape[1], x.shape[2]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return xp[:, 1 + sy : 1 + sy + H, 1 + sx : 1 + sx + W, :]


def _phase_split(w):
    """Tap-sum kernels of nearest-x2 + conv3x3 for an HWIO ``w``
    ``[3, 3, cin, cout]`` (torch or numpy): ``k[a][b][s, t]`` is the
    ``[cin, cout]`` weight that 2x-output phase (a, b) applies to the input
    at ``[i + a - 1 + s, j + b - 1 + t]``, s, t in {0, 1}. The sums are
    taken in float32 from the stored weights; callers round them after."""
    if isinstance(w, torch.Tensor):
        stack, w = torch.stack, w.float()
    else:
        stack, w = np.stack, np.asarray(w, np.float32)
    r0 = stack([w[0], w[1] + w[2]])  # a = 0: rows (i - 1, i)
    r1 = stack([w[0] + w[1], w[2]])  # a = 1: rows (i, i + 1)

    def cols(rw):
        return (
            stack([rw[:, 0], rw[:, 1] + rw[:, 2]], 1),
            stack([rw[:, 0] + rw[:, 1], rw[:, 2]], 1),
        )

    k00, k01 = cols(r0)
    k10, k11 = cols(r1)
    return [[k00, k01], [k10, k11]]


def up2_matrices(w):
    """The up2 tap sums of an HWIO ``w`` as matrices ``[4, 4 cin, cout]``:
    entry ``2c + d`` serves output sub-phase (c, d); its rows are tap-major,
    tap ``2s + t``, then input channel."""
    k = _phase_split(w)
    cat = torch.cat if isinstance(w, torch.Tensor) else np.concatenate
    stack = torch.stack if isinstance(w, torch.Tensor) else np.stack
    return stack([
        cat([k[c][d][s, t] for s in (0, 1) for t in (0, 1)], 0)
        for c in (0, 1)
        for d in (0, 1)
    ])


def _mm(srcs, wd, b, slope, od, out_dt):
    """``concat(srcs) @ wd + b`` with optional LeakyReLU: operands rounded
    to ``od``, float32 sums; ``out_dt`` None keeps float32."""
    x = operand(torch.cat(srcs, -1), od)
    y = torch.matmul(x, operand(wd, od)) + b.float()
    if slope is not None:
        y = _lrelu(y, slope)
    return y if out_dt is None else y.to(out_dt)


def up1_phases(fea, w, b, od, tail_dt):
    """up1 (nearest-x2 + conv3x3 + lrelu) of NHWC ``fea`` ``[B, H, W, nf]``
    as ONE valid 2x2 conv with the four 2x phases as output-channel groups:
    returns ``y1`` ``[B, H + 1, W + 1, 4 nf]`` in ``tail_dt``, where phase
    (a, b) of base pixel (i, j) is ``y1[:, i + a, j + b, (2a + b) nf :
    (2a + b + 1) nf]``. ``w`` is OIHW."""
    k = _phase_split(_hwio(w))
    k1c = torch.cat([k[0][0], k[0][1], k[1][0], k[1][1]], -1)  # [2, 2, cin, 4 cout]
    xp = F.pad(fea, (0, 0, 1, 1, 1, 1))
    y = F.conv2d(operand(_nchw(xp), od), operand(k1c.permute(3, 2, 0, 1), od))
    y = _nhwc(y) + b.float().repeat(4)
    return _lrelu(y).to(tail_dt)


def p1_phases(y1, nf):
    """The four 2x phases ``P1[a][b]`` ``[B, H, W, nf]`` as views of y1."""
    H, W = y1.shape[1] - 1, y1.shape[2] - 1
    return [
        [y1[:, a : a + H, b : b + W, (2 * a + b) * nf : (2 * a + b + 1) * nf] for b in (0, 1)]
        for a in (0, 1)
    ]


def up2_phases(P1, w2, b2, od, out_dt):
    """up2 on the packed 2x phases: 4x phase (2a + c, 2b + d) at base (i,
    j) taps the 2x image at row 2i + a + c - 1 + s, i.e. P1 phase m % 2 at
    base shift m // 2 (m = a + c - 1 + s), and columns alike. ``w2``:
    :func:`up2_matrices`. Returns the 4 x 4 list of P2 phases."""
    P2 = [[None] * 4 for _ in range(4)]
    for a in (0, 1):
        for c in (0, 1):
            for bb in (0, 1):
                for d in (0, 1):
                    srcs = []
                    for s in (0, 1):
                        m = a + c - 1 + s
                        for t in (0, 1):
                            n = bb + d - 1 + t
                            srcs.append(_shift0(P1[m % 2][n % 2], m // 2, n // 2))
                    P2[2 * a + c][2 * bb + d] = _mm(srcs, w2[2 * c + d], b2, LRELU_SLOPE, od, out_dt)
    return P2


def conv_phases(P, wd, b, slope, od, out_dt):
    """A 3x3 conv at 4x resolution on its 16 base-resolution phases: tap
    (dy, dx) of output phase (P, Q) reads source phase ((P + dy) % 4,
    (Q + dx) % 4) at base shift ((P + dy) // 4, (Q + dx) // 4). ``wd``:
    ``[9 cin, cout]``, the HWIO weight with its taps as rows."""
    out = [[None] * 4 for _ in range(4)]
    for pr in range(4):
        for qc in range(4):
            srcs = [
                _shift0(P[(pr + dy) % 4][(qc + dx) % 4], (pr + dy) // 4, (qc + dx) // 4)
                for dy in (-1, 0, 1)
                for dx in (-1, 0, 1)
            ]
            out[pr][qc] = _mm(srcs, wd, b, slope, od, out_dt)
    return out


def interleave_phases(P):
    """4 x 4 phases ``[B, H, W, C]`` -> the 4x image ``[B, 4H, 4W, C]``."""
    grid = torch.stack([torch.stack([P[p][q] for q in range(4)], 3) for p in range(4)], 2)
    B, H, _, W, _, C = grid.shape
    return grid.reshape(B, 4 * H, 4 * W, C)


# the tail forms of rrdbnet_forward; the packed ones are the JAX package's
# PACKED_TAIL with PACKED_TAIL_KERNEL 0, 1 and 2
TAIL_MODES = ("interleaved", "packed", "kernel_hr", "kernel")


def packed_tail(params, fea, spec, od, tail_dt, mode=0):
    """The tail after the long skip in packed-phase form: NHWC ``fea``
    ``[B, H, W, nf]`` (``tail_dt``) -> NHWC float32 ``[B, 4H, 4W, out_ch]``.

    Every stage runs at base resolution with the output phases as channel
    groups and one 3-channel interleave at the end; the taps and zero
    borders are those of the interleaved tail. ``mode`` 0: every stage as
    matmuls over concatenated shifted slices; 1: up2 so, then HRconv +
    conv_last on the fused kernel K7 (``ops.tail_kernel.hr_last_packed``);
    2: up2 + HRconv + conv_last on the fused kernel K6
    (``up2_hr_last_packed``) straight from up1's output. The kernel modes
    read ``params["tail"]`` (``ops.tail_kernel.pack_tail_params``) and hand
    the kernel its input at the operand type ``od``: bfloat16 in mixed mode
    (y1 and P2 are float32 there and cast once), float32 as it is in float32
    mode, where the kernels' float32 instances take it.
    """
    dev, nf = fea.device, fea.shape[-1]
    up_w = torch.as_tensor(params["up"]["w"], device=dev)
    up_b = torch.as_tensor(params["up"]["b"], device=dev)
    y1 = up1_phases(fea, up_w[0], up_b[0], od, tail_dt)
    if mode == 2:
        from realsr_tpu_torch.ops.tail_kernel import up2_hr_last_packed

        return up2_hr_last_packed(y1.to(od).contiguous(), params["tail"])
    P2 = up2_phases(p1_phases(y1, nf), up2_matrices(_hwio(up_w[1])), up_b[1], od, tail_dt)
    if mode == 1:
        from realsr_tpu_torch.ops.tail_kernel import hr_last_packed

        p2 = torch.cat([P2[p][q] for p in range(4) for q in range(4)], -1)
        return hr_last_packed(p2.to(od).contiguous(), params["tail"])

    def dense(group):
        w = _hwio(torch.as_tensor(params[group]["w"], device=dev))
        return w.reshape(-1, w.shape[-1]), torch.as_tensor(params[group]["b"], device=dev)

    P3 = conv_phases(P2, *dense("hr"), LRELU_SLOPE, od, tail_dt)
    P4 = conv_phases(P3, *dense("last"), None, od, None)
    return interleave_phases(P4)


def _tail(params, fea, body, spec, storage_dtype, od, tail):
    """Trunk conv + long skip + upsampler + HRconv + conv_last: NCHW in,
    NHWC float32 out."""
    trunk = conv3x3(body, params["trunk"]["w"], params["trunk"]["b"], None, od)
    fea = (fea.float() + trunk).to(storage_dtype)
    if tail != "interleaved":
        mode = TAIL_MODES.index(tail) - 1
        return packed_tail(params, _nhwc(fea), spec, od, storage_dtype, mode)
    for s in range(spec.num_upsample):
        fea = _nchw(nearest_x2(_nhwc(fea)))
        fea = conv3x3(
            fea, params["up"]["w"][s], params["up"]["b"][s], LRELU_SLOPE, od
        ).to(storage_dtype)
    fea = conv3x3(fea, params["hr"]["w"], params["hr"]["b"], LRELU_SLOPE, od)
    fea = fea.to(storage_dtype)
    return _nhwc(conv3x3(fea, params["last"]["w"], params["last"]["b"], None, od))


def rrdbnet_forward(
    params: Dict[str, Any],
    x: torch.Tensor,
    spec: RRDBNetSpec,
    storage_dtype=torch.float32,
    variant: str = "dense",
    op_dtype=None,
    tail: str = "interleaved",
    trunk: str = "per_rdb",
    sched: str = "scatter",
) -> torch.Tensor:
    """Normalized NHWC input in [0, 1] -> NHWC float32 (before denorm).

    ``params`` (OIHW convs): ``conv_first``, ``trunk``, ``hr``, ``last``:
    ``{w, b}``; ``up``: ``{w, b}`` stacked ``[num_upsample, ...]``; ``rdb``:
    ``{w1..w5, b1..b5}`` stacked ``[num_rrdb, num_rdb, ...]`` for 'dense',
    ``{sw0..sw4, b1..b5}`` (repack_scatter) for 'scatter', and
    ``{w, b}`` stacked ``[num_rrdb * 3, ...]`` (ops.rdb_kernel.
    pack_rdb_params) for 'cuda', which runs the trunk on the fused RDB
    kernels (the counterpart of the JAX package's 'pallas'); ``tail``: the
    kernel tails' packed weights (ops.tail_kernel.pack_tail_params) for
    the ``tail`` modes 'kernel_hr' and 'kernel'.

    ``tail`` (:data:`TAIL_MODES`): 'interleaved' (the graph's nearest-x2 +
    conv form) or a packed-phase form (:func:`packed_tail` modes 0, 1, 2).
    The packed forms need two upsamplers (scale 4).

    ``trunk`` (:data:`TRUNK_MODES`) and ``sched`` (:data:`SCHEDS`) pick the
    kernel trunk's form for variant 'cuda': 'chained' (K3), 'paired' (K4,
    mixed mode), or 'per_rdb' with ``sched`` 'scatter' (K1) or 'packed' (K5,
    ``params["rdb"]`` packed with ``sched="packed"``). Combinations the JAX
    package cannot run raise ``ValueError`` (:func:`trunk_mode_error`).
    """
    od = op_dtype if op_dtype is not None else storage_dtype
    err = trunk_mode_error(variant, trunk, sched, storage_dtype, od)
    if err:
        raise ValueError(err)
    if tail not in TAIL_MODES:
        raise ValueError(f"unknown tail {tail!r}; expected one of {TAIL_MODES}")
    if tail != "interleaved" and spec.num_upsample != 2:
        raise ValueError(f"the packed tail needs two upsamplers, the graph has {spec.num_upsample}")
    x = _nchw(x.to(storage_dtype))
    fea = conv3x3(x, params["conv_first"]["w"], params["conv_first"]["b"], None, od)
    fea = fea.to(storage_dtype)

    if variant == "cuda":
        from realsr_tpu_torch.ops import rdb_kernel as rk

        t0 = _nhwc(fea).contiguous()
        if trunk == "chained":
            body = rk.rdb_trunk_chained(t0, params["rdb"])
        elif trunk == "paired":
            body = rk.rdb_trunk_paired(t0, params["rdb"]).to(storage_dtype)
        else:
            body = rk.rdb_trunk(t0, params["rdb"], sched)
        body = _nchw(body)
    elif variant in ("dense", "scatter"):
        rdb_fn = _rdb_scatter if variant == "scatter" else _rdb
        t = fea
        for g in range(spec.num_rrdb):
            u = t
            for j in range(spec.num_rdb_per_rrdb):
                pj = {k: v[g, j] for k, v in params["rdb"].items()}
                t = rdb_fn(t, pj, storage_dtype, od)
            t = (RESIDUAL_SCALE * t.float() + u.float()).to(storage_dtype)
        body = t
    else:
        raise ValueError(f"unknown variant {variant!r}")
    return _tail(params, fea, body, spec, storage_dtype, od, tail)


def _oihw(w) -> np.ndarray:
    """HWIO ``[..., kh, kw, cin, cout]`` -> OIHW ``[..., cout, cin, kh, kw]``."""
    w = np.asarray(w, np.float32)
    return np.ascontiguousarray(np.moveaxis(w, (-1, -2), (-4, -3)))


def params_from_jax(params_np: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX package's stacked HWIO tree -> this package's OIHW tree
    (numpy). Weights are the keys ``w``, ``w1..w5`` and ``sw0..sw4``."""
    return {
        group: {
            k: _oihw(v) if k.startswith(("w", "sw")) else np.asarray(v, np.float32)
            for k, v in tree.items()
        }
        for group, tree in params_np.items()
    }


def init_rrdbnet_params(spec: RRDBNetSpec, seed: int = 0) -> Dict[str, Any]:
    """Random (deterministic) OIHW parameters: the same draws as the JAX
    package's ``init_rrdbnet_params``, so one seed gives the same weights."""
    rng = np.random.default_rng(seed)
    nf, gc = spec.nf, spec.gc

    def conv(cin, cout, *lead):
        w = rng.normal(0, 0.05, size=(*lead, 3, 3, cin, cout)).astype(np.float32)
        b = rng.normal(0, 0.01, size=(*lead, cout)).astype(np.float32)
        return w, b

    nb = (spec.num_rrdb, spec.num_rdb_per_rrdb)
    rdb = {}
    for i, cin in enumerate((nf, nf + gc, nf + 2 * gc, nf + 3 * gc, nf + 4 * gc), 1):
        rdb[f"w{i}"], rdb[f"b{i}"] = conv(cin, gc if i < 5 else nf, *nb)
    upw, upb = conv(nf, nf, spec.num_upsample)
    fw, fb = conv(spec.in_ch, nf)
    tw, tb = conv(nf, nf)
    hw, hb = conv(nf, nf)
    lw, lb = conv(nf, spec.out_ch)
    return params_from_jax({
        "conv_first": {"w": fw, "b": fb},
        "rdb": rdb,
        "trunk": {"w": tw, "b": tb},
        "up": {"w": upw, "b": upb},
        "hr": {"w": hw, "b": hb},
        "last": {"w": lw, "b": lb},
    })
