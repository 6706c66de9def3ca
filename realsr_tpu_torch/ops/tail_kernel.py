"""Fused packed-phase tail: the Python side of ``csrc/tail_kernel.cu``
(bfloat16 operands) and ``csrc/tail_tf32.cu`` (float32 operands), both on
``csrc/tail_wgmma.cuh``.

Counterpart of ``realsr_tpu/ops/tail_kernel.py``. One kernel stands in for
both forms of ``_tail_kernel``: :func:`up2_hr_last_packed` (K6: up2 +
HRconv + conv_last from the four 2x phases that up1 writes) and
:func:`hr_last_packed` (K7: HRconv + conv_last from the sixteen 4x phases).
Both return the 4x image ``[B, 4H, 4W, 3]`` in float32, interleaved.

The kernel is fixed at the graph's tail shape, nf = 64 and 3 outputs. Its
operand type is the input's: bfloat16, or float32 with the split 3xTF32
product of the JAX kernel's ``Precision.HIGHEST`` (no float16 instance).
Its weights are packed once at load (:func:`pack_tail_params`): the JAX
package's matrices (:func:`pack_tail_weights`, :func:`up2_weights`) as
wgmma's k16 slices and, for float32, as tf32 hi/lo k8 slices, conv_last in
the JAX kernel's W9-packed form. The kernel walks patches of the 4x output
whose shape :func:`tail_geometry` (bfloat16) or :func:`tail_tf32_geometry`
(float32) picks per call.

A tensor on the CPU takes the plain PyTorch version (the packed tail's
matmul stages, :func:`up2_hr_last_reference`, :func:`hr_last_reference`);
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from realsr_tpu_torch.models.rrdbnet import (
    LRELU_SLOPE,
    _hwio,
    conv_phases,
    interleave_phases,
    p1_phases,
    up2_matrices,
    up2_phases,
)
from realsr_tpu_torch.ops.rdb_kernel import _sm_count, _step_order, tf32_split

NF = 64  # the tail's channels (x4.param: HRconv 64 -> 64, conv_last 64 -> 3)
OUTC = 3
TC = 8  # conv_last's outputs padded to 8 (the JAX package's w9 and b3)
W9N = 32  # the kernel's W9-packed conv_last columns: 9 taps x 3 outputs, padded
NPH = 16  # 4x4 output phases
# (TH, TW) 4x patch shapes the kernel is built for (tail_kernel.cu::launch_tile)
TAIL_TILES = ((16, 16), (12, 28))
# the float32 instances' (tail_tf32.cu::launch_tile): float32 planes take
# twice the bytes (tail_tf32_smem_bytes)
TAIL_TF32_TILES = ((10, 14), (8, 16))
SMEM_LIMIT = 232_448  # shared memory of one block on the H100

# kernel launches per wrapper since the last reset (set the values to 0)
LAUNCHES = {"up2_hr_last_packed": 0, "hr_last_packed": 0}
_COUNT_LOCK = threading.Lock()


def up2_weights(w_up2: np.ndarray, b_up2: np.ndarray):
    """OIHW up2 weights -> the JAX package's K6 up2 operands (numpy f32):
    ``w2`` ``[4, 64, 256]`` (entry ``2c + d``: rows cout, columns tap-major
    x cin) and ``b2`` ``[64, 1]``."""
    w = torch.from_numpy(np.asarray(w_up2, np.float32))
    w2 = up2_matrices(_hwio(w)).transpose(1, 2).contiguous().numpy()
    return w2, np.asarray(b_up2, np.float32).reshape(-1, 1)


def pack_tail_weights(w_hr, b_hr, w_last, b_last):
    """OIHW HRconv and conv_last weights -> the JAX package's
    ``pack_tail_weights`` layouts (numpy f32): ``w1`` ``[64, 576]`` (rows
    cout, columns tap-major x cin), ``b1`` ``[64, 1]``, ``w9`` ``[9 * TC,
    64]`` (rows tap-major x padded cout) and ``b3`` ``[TC, 1]``."""
    w_hr = np.asarray(w_hr, np.float32)
    w_last = np.asarray(w_last, np.float32)
    nf = w_hr.shape[0]
    w1 = np.transpose(w_hr, (0, 2, 3, 1)).reshape(nf, 9 * nf)
    w9t = np.transpose(w_last, (2, 3, 0, 1))  # [3, 3, cout, cin]
    w9 = np.pad(w9t, ((0, 0), (0, 0), (0, TC - w_last.shape[0]), (0, 0))).reshape(9 * TC, nf)
    b3 = np.pad(np.asarray(b_last, np.float32), (0, TC - w_last.shape[0])).reshape(TC, 1)
    return w1, np.asarray(b_hr, np.float32).reshape(nf, 1), w9, b3


def _wg_pack(dense: np.ndarray) -> np.ndarray:
    """A dense ``[K, N]`` matrix (K a multiple of 16) -> its ``K / 16`` k16
    slices in wgmma's K-major layout without swizzle, back to back, as the
    kernel's B descriptor reads them (``rdb_kernel._step_order("wgmma")``):
    8 x 8 core matrices (8 columns, 8 consecutive k), the two k halves of an
    8-column group next to each other, the groups 256 bytes apart."""
    k, n = dense.shape
    cols, rows = _step_order("wgmma", n)
    return dense.reshape(k // 16, 16, n)[:, rows, cols].ravel()


def _wg_unpack(packed: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """Inverse of :func:`_wg_pack`: ``[k, n]``."""
    cols, rows = (torch.from_numpy(a).to(packed.device) for a in _step_order("wgmma", n))
    dense = torch.empty((k // 16, 16, n), dtype=packed.dtype, device=packed.device)
    dense[:, rows, cols] = packed.reshape(k // 16, 16 * n)
    return dense.reshape(k, n)


def _tf32_pack(dense: np.ndarray) -> np.ndarray:
    """A dense float32 ``[K, N]`` matrix (K a multiple of 8) -> its ``K / 8``
    k8 steps in the float32 kernel's order, back to back: each step's tf32 hi
    slice, then its lo slice (:func:`~realsr_tpu_torch.ops.rdb_kernel.
    tf32_split`: both rounded to nearest), each slice in the k8 layout of
    ``rdb_kernel._step_order("tf32")`` (the bytes of a bf16 k16 slice)."""
    k, n = dense.shape
    cols, rows = _step_order("tf32", n)
    hi, lo = tf32_split(np.ascontiguousarray(dense, np.float32))
    return np.stack([t.reshape(k // 8, 8, n)[:, rows, cols] for t in (hi, lo)], 1).ravel()


def _w9_columns(w9: np.ndarray) -> np.ndarray:
    """The JAX package's conv_last ``w9`` ``[9 * TC, 64]`` -> the W9-packed
    product's ``[64, W9N]``: column ``tap * 3 + o`` holds output ``o``'s
    weights of tap ``tap``; columns from 27 on are zero."""
    t = w9.reshape(9, TC, NF)[:, :OUTC].transpose(2, 0, 1).reshape(NF, 9 * OUTC)
    return np.pad(t, ((0, 0), (0, W9N - 9 * OUTC)))


def pack_tail_params(params: Dict[str, np.ndarray], op_dtype=torch.bfloat16):
    """The graph's OIHW ``up``, ``hr`` and ``last`` groups -> the kernels'
    operands as CPU tensors at ``op_dtype``, each in :func:`_wg_pack`'s
    layout: ``w2`` the up2 tap sums as two passes ``c`` of ``[256, 128]``
    (sub-phases ``(c, 0) | (c, 1)`` side by side, 64 columns each); ``w1``
    HRconv ``[576, 64]``; ``w9`` conv_last in W9-packed form ``[64, 32]``
    (:func:`_w9_columns`). Float32 biases ``b2`` ``[64]``, ``b1`` ``[64]``
    and ``b3`` ``[8]``. The tap sums are taken in float32, then rounded, as
    the JAX package does. For float32 operands also ``w2t``, ``w1t`` and
    ``w9t``: the same matrices as the float32 kernel's tf32 hi/lo k8 slices
    (:func:`_tf32_pack`, twice the values), in the same order."""
    w2, b2 = up2_weights(params["up"]["w"][1], params["up"]["b"][1])
    w1, b1, w9, b3 = pack_tail_weights(
        params["hr"]["w"], params["hr"]["b"], params["last"]["w"], params["last"]["b"]
    )
    passes = [np.concatenate([w2[2 * c].T, w2[2 * c + 1].T], 1) for c in (0, 1)]
    dense = {"w2": passes, "w1": [np.ascontiguousarray(w1.T)], "w9": [_w9_columns(w9)]}
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(op_dtype)  # noqa: E731
    out = {k: t(np.concatenate([_wg_pack(w) for w in ws])) for k, ws in dense.items()}
    if op_dtype == torch.float32:
        out.update({f"{k}t": t(np.concatenate([_tf32_pack(w) for w in ws])) for k, ws in dense.items()})
    for k, b in (("b2", b2), ("b1", b1), ("b3", b3)):
        out[k] = torch.from_numpy(b.ravel().copy())
    return out


def _dense(tp):
    """:func:`pack_tail_params` -> the dense K x N matrices of the plain
    versions (the operand type): ``w2`` ``[4, 256, 64]`` (entry ``2c + d``),
    ``w1`` ``[576, 64]`` and ``w9`` ``[576, TC]`` (rows tap-major x cin)."""
    w2 = [_wg_unpack(w, 4 * NF, 2 * NF) for w in tp["w2"].reshape(2, -1)]
    w9 = _wg_unpack(tp["w9"], NF, W9N)[:, : 9 * OUTC].reshape(NF, 9, OUTC).permute(1, 0, 2)
    return (
        torch.stack([w2[c][:, d * NF : (d + 1) * NF] for c in (0, 1) for d in (0, 1)]),
        _wg_unpack(tp["w1"], 9 * NF, NF),
        torch.nn.functional.pad(w9, (0, TC - OUTC)).reshape(9 * NF, TC),
    )


def conv_last_w9(z: torch.Tensor, w9: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel's conv_last in the JAX kernel's
    W9-packed form: ``z`` ``[B, h, w, 64]`` (NHWC, zero padded by one pixel
    outside) and ``w9`` ``[64, W9N]`` (:func:`_w9_columns`) -> ``[B, h, w,
    3]`` float32. One K = 64 product per z pixel, ``T = z . w9``, then each
    output pixel sums its nine shifted T values of the three outputs, in tap
    order, onto ``b3``."""
    T = torch.matmul(z.float(), w9.float())
    Tp = torch.nn.functional.pad(T, (0, 0, 1, 1, 1, 1))
    h, w = z.shape[1], z.shape[2]
    out = b3.float()[:OUTC].expand(*T.shape[:-1], OUTC)
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        out = out + Tp[:, dy : dy + h, dx : dx + w, tap * OUTC : (tap + 1) * OUTC]
    return out


@dataclasses.dataclass(frozen=True)
class TailGeometry:
    """The tail kernel's grid for one call (:func:`tail_geometry`)."""

    tile: Tuple[int, int]  # the 4x patch shape (TH, TW)
    patches: Tuple[int, int]  # patch rows and columns of one tile's 4x output
    blocks: int  # patches x tiles
    grid: int  # persistent blocks: min(blocks, SMs), one per SM
    waves: float  # blocks / SMs: patches per SM
    fill: float  # blocks / (whole waves x SMs)
    mac_factor: float  # MACs the patches issue / the tail's MACs


def _regions(th: int, tw: int) -> Dict[str, int]:
    """Pixels of a patch's regions (tail_kernel.cu::Geo): z with conv_last's
    halo, P2 with HRconv's on top, one up2 sub-phase, the 2x window."""
    q = (th + 4) // 2 * ((tw + 4) // 2)
    return {"z": (th + 2) * (tw + 2), "p2": (th + 4) * (tw + 4), "sub": q,
            "win": ((th + 4) // 2 + 2) * ((tw + 4) // 2 + 2)}


def tail_smem_bytes(th: int, tw: int, with_up2: bool = True, plane=lambda p: 128 * p) -> int:
    """Shared memory of one block (tail_wgmma.cuh::Layout), ``plane(p)``
    bytes for a plane of p pixels (bfloat16: 128-byte pixels): K6 the
    window, z, P2 and two 32 KB weight slots; K7 z, two P2 buffers and two
    16 KB slots; 8 bytes per barrier."""
    r = _regions(th, tw)
    if with_up2:
        return plane(r["win"]) + plane(r["z"]) + plane(r["p2"]) + 2 * 32_768 + 8 * (2 * 2 + 2)
    return plane(r["z"]) + 2 * plane(r["p2"]) + 2 * 16_384 + 8 * (2 * 2 + 2 * 2)


def tail_tf32_smem_bytes(th: int, tw: int, with_up2: bool = True) -> int:
    """:func:`tail_smem_bytes` of the float32 instances: each plane two
    32-channel sub-planes of 128-byte pixels, each padded to 1,024 bytes
    (hopper.cuh::sub_plane_bytes)."""
    return tail_smem_bytes(th, tw, with_up2, lambda p: 2 * (-(-p * 128 // 1024) * 1024))


def tail_block_macs(th: int, tw: int, with_up2: bool = True) -> int:
    """MACs one patch issues: each stage's rows in 64-row tiles times its
    K and N (up2: 4 sub-phases x 256 x 64; HRconv 576 x 64; conv_last's W9
    product 64 x 32)."""
    r = _regions(th, tw)
    rows = lambda n: -(-n // 64) * 64  # noqa: E731
    up2 = 4 * rows(r["sub"]) * 4 * NF * NF if with_up2 else 0
    return up2 + rows(r["z"]) * (9 * NF * NF + NF * W9N)


def tail_macs_per_pixel(with_up2: bool = True) -> int:
    """The tail's MACs per 4x output pixel."""
    return (4 * NF * NF if with_up2 else 0) + 9 * NF * NF + 9 * NF * OUTC


def tail_geometry(B: int, H: int, W: int, with_up2: bool = True, sms: int = 132) -> TailGeometry:
    """The patch shape of :data:`TAIL_TILES` that finishes ``B`` tiles of
    ``H x W`` base pixels (``4H x 4W`` output) soonest on ``sms`` SMs, one
    persistent block per SM: the fewest rounds of patches per SM times the
    MACs a patch issues (the first listed on a tie), among the shapes whose
    block fits in :data:`SMEM_LIMIT`. The kernel's times at both shapes on
    8 x 148^2 (chip_smoke.py phase 3b) fit time per round ~ MACs per patch
    with no fixed cost per patch. At 8 x 148^2 on 132 SMs: 12 x 28, 8,800
    patches."""
    return _tail_geometry(TAIL_TILES, tail_smem_bytes, B, H, W, with_up2, sms)


def tail_tf32_geometry(B: int, H: int, W: int, with_up2: bool = True, sms: int = 132) -> TailGeometry:
    """:func:`tail_geometry`'s rule over the float32 instances' shapes
    (:data:`TAIL_TF32_TILES`, :func:`tail_tf32_smem_bytes`). At 8 x 148^2
    on 132 SMs: 10 x 14, 20,640 patches, 1.562x the tail's MACs issued (K7
    1.425x; the bfloat16 instances' 12 x 28: 1.474x, 1.418x)."""
    return _tail_geometry(TAIL_TF32_TILES, tail_tf32_smem_bytes, B, H, W, with_up2, sms)


def _tail_geometry(tiles, smem, B: int, H: int, W: int, with_up2: bool, sms: int) -> TailGeometry:
    best = None
    for th, tw in tiles:
        if smem(th, tw, with_up2) > SMEM_LIMIT:
            continue
        py, px = -(-4 * H // th), -(-4 * W // tw)
        blocks = B * py * px
        cost = -(-blocks // sms) * tail_block_macs(th, tw, with_up2)
        if best is None or cost < best[0]:
            best = (cost, (th, tw), (py, px), blocks)
    _, tile, patches, blocks = best
    rounds = -(-blocks // sms)
    return TailGeometry(
        tile=tile, patches=patches, blocks=blocks, grid=min(blocks, sms), waves=blocks / sms,
        fill=blocks / (rounds * sms),
        mac_factor=blocks * tail_block_macs(*tile, with_up2)
        / (B * 16 * H * W * tail_macs_per_pixel(with_up2)),
    )


def _hr_last_phases(P2, tp, w1, w9):
    od = w1.dtype
    z = conv_phases(P2, w1, tp["b1"], LRELU_SLOPE, od, od)
    return interleave_phases(conv_phases(z, w9, tp["b3"], None, od, None))[..., :OUTC]


def up2_hr_last_reference(p1: torch.Tensor, tp) -> torch.Tensor:
    """Plain PyTorch version of K6: ``p1`` as up1 writes it (``[B, H + 1,
    W + 1, 4 * 64]``, :func:`realsr_tpu_torch.models.rrdbnet.up1_phases`)
    -> ``[B, 4H, 4W, 3]`` float32. Operands are rounded to the weights'
    dtype, P2 and z too; sums are float32."""
    w2, w1, w9 = _dense(tp)
    P2 = up2_phases(p1_phases(p1, NF), w2, tp["b2"], w1.dtype, w1.dtype)
    return _hr_last_phases(P2, tp, w1, w9)


def hr_last_reference(p2: torch.Tensor, tp) -> torch.Tensor:
    """Plain PyTorch version of K7: ``p2`` ``[B, H, W, 16 * 64]``, phase
    (P, Q) in channels ``(4P + Q) * 64 ...`` -> ``[B, 4H, 4W, 3]``."""
    _, w1, w9 = _dense(tp)
    P2 = [[p2[..., (4 * p + q) * NF : (4 * p + q + 1) * NF] for q in range(4)] for p in range(4)]
    return _hr_last_phases(P2, tp, w1, w9)


def _bind(name: str, group: str, fn: str):
    from realsr_tpu_torch.ops.build import load_library

    lib = load_library(name, group)
    if not getattr(lib, "_realsr_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        getattr(lib, fn).argtypes = [vp] * 8 + [ci] * 7 + [vp]
        getattr(lib, fn).restype = ci
        lib.tail_error_string.argtypes = [ci]
        lib.tail_error_string.restype = ctypes.c_char_p
        lib._realsr_bound = True
    return lib


def tail_group(with_up2: bool) -> str:
    """The build group (``ops/build.py::GROUPS``) of a tail form: ``k6``
    with up2, ``k7`` without."""
    return "k6" if with_up2 else "k7"


def _library(group: str):
    """tail_kernel.cu's ``group``: K6 or K7 for bfloat16 operands."""
    return _bind("tail_kernel", group, "tail_launch")


def _tf32_library(group: str):
    """tail_tf32.cu's ``group``: K6 or K7 for float32 operands (3xTF32)."""
    return _bind("tail_tf32", group, "tail_tf32_launch")


def _check(fn, name, t, device, dtype, numel):
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, the input on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{fn}: {name} is {t.dtype}, expected {dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{fn}: {name} must be contiguous and 16-byte aligned")
    if t.numel() != numel:
        raise ValueError(f"{fn}: {name} has {t.numel()} elements, expected {numel}")


def _launch(fn, x, tp, with_up2, tile=None):
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if x.dtype == torch.bfloat16:
        wkey, scale, tiles, geometry, library = "", 1, TAIL_TILES, tail_geometry, _library
    elif x.dtype == torch.float32:
        wkey, scale, tiles, geometry, library = "t", 2, TAIL_TF32_TILES, tail_tf32_geometry, _tf32_library
    else:
        raise NotImplementedError(
            f"{fn}: the tail kernel has bfloat16 and float32 instances, not {x.dtype}"
        )
    cin = 4 * NF if with_up2 else NPH * NF
    if x.dim() != 4 or x.shape[-1] != cin:
        raise ValueError(f"{fn}: expected [B, H, W, {cin}], got {tuple(x.shape)}")
    B, H, W = x.shape[0], x.shape[1] - with_up2, x.shape[2] - with_up2
    if H < 1 or W < 1:
        raise ValueError(f"{fn}: empty tile {tuple(x.shape)}")
    _check(fn, "x", x, x.device, x.dtype, x.numel())
    # the kernel's weights (float32: "w2t", ... twice the values) and biases
    sizes = {"w1": 9 * NF * NF, "b1": NF, "w9": NF * W9N, "b3": TC}
    if with_up2:
        sizes.update(w2=4 * 4 * NF * NF, b2=NF)
    keys = {k: k if k[0] == "b" else k + wkey for k in sizes}
    for k, n in sizes.items():
        if keys[k] not in tp:
            raise ValueError(f"{fn}: tp has no {keys[k]!r} (pack_tail_params at {x.dtype})")
        _check(fn, keys[k], tp[keys[k]], x.device, torch.float32 if k[0] == "b" else x.dtype,
               n if k[0] == "b" else scale * n)
    sms = _sm_count(x.device)
    if tile is None:
        tile = geometry(B, H, W, with_up2, sms).tile
    elif tile not in tiles:
        raise ValueError(f"{fn}: no {x.dtype} kernel for patch shape {tile}; built for {tiles}")
    out = torch.empty((B, 4 * H, 4 * W, OUTC), dtype=torch.float32, device=x.device)
    lib = library(tail_group(with_up2))
    launch = lib.tail_launch if x.dtype == torch.bfloat16 else lib.tail_tf32_launch
    ptr = lambda k: tp[keys[k]].data_ptr() if k in sizes else None  # noqa: E731
    with torch.cuda.device(x.device):
        err = launch(
            x.data_ptr(), ptr("w2"), ptr("b2"), ptr("w1"), ptr("b1"), ptr("w9"), ptr("b3"),
            out.data_ptr(), B, H, W, int(with_up2), *tile, sms,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"tail_kernel launch failed: {lib.tail_error_string(err).decode()} "
            f"({fn}, B={B}, H={H}, W={W}, patch {tile[0]}x{tile[1]}, {x.dtype})"
        )
    with _COUNT_LOCK:
        LAUNCHES[fn] += 1
    return out


def up2_hr_last_packed(p1: torch.Tensor, tp: Dict[str, torch.Tensor]) -> torch.Tensor:
    """K6: up2 + HRconv + conv_last from ``p1`` ``[B, H + 1, W + 1, 256]``
    (up1's phase layout) -> ``[B, 4H, 4W, 3]`` float32. ``tp``:
    :func:`pack_tail_params` on ``p1``'s device, at ``p1``'s dtype (the
    operand type: bfloat16 or float32)."""
    if p1.device.type == "cpu":
        return up2_hr_last_reference(p1, tp)
    return _launch("up2_hr_last_packed", p1, tp, True)


def hr_last_packed(p2: torch.Tensor, tp: Dict[str, torch.Tensor]) -> torch.Tensor:
    """K7: HRconv + conv_last from ``p2`` ``[B, H, W, 1024]`` (16 phases
    of 64 channels) -> ``[B, 4H, 4W, 3]`` float32."""
    if p2.device.type == "cpu":
        return hr_last_reference(p2, tp)
    return _launch("hr_last_packed", p2, tp, False)
