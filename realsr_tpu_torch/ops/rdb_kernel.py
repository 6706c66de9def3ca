"""Fused residual dense block: the Python side of ``csrc/rdb_wgmma.cu``,
``csrc/rdb_tf32.cu``, ``csrc/rdb_modes_wgmma.cu`` and
``csrc/rdb_modes_tf32.cu``.

Counterpart of ``realsr_tpu/ops/rdb_kernel.py``. The five TPU kernels'
counterparts (see the sources' headers), each with a wrapper here:

- :func:`rdb_apply` (K1 ``_rdb_kernel``, and K2 ``_rdb_resident_kernel``
  through :func:`rdb_trunk`): one RDB, optionally with the RRDB residual
  ``0.2 * y + u`` in its epilogue; the 69-RDB trunk is 69 launches. bfloat16
  operands run on ``rdb_wgmma.cu`` (wgmma, its patch side from
  :func:`rdb_geometry`), which reads its window from a bfloat16 operand
  plane: :func:`rdb_trunk` threads the one each launch writes beside its
  float32 output (the "shadow") into the next. float32 operands run on
  ``rdb_tf32.cu`` (the same machinery with float32 planes and a split tf32
  product, 3xTF32, on the weights' ``"wt"`` copy; its patch side from
  :func:`tf32_geometry`), whose window is the float32 state itself;
- :func:`rdb_apply_packed` (K5, the ``sched="packed"`` branch of
  ``_make_rdb_compute``): one RDB in the K-packed schedule's five GEMM
  rectangles, on weights re-cut by ``pack_rdb_params(sched="packed")``, on
  ``rdb_modes_wgmma.cu`` (K1's wgmma machinery, its patch side from
  :func:`packed_geometry`); ``rdb_trunk(sched="packed")`` threads the
  operand plane as for K1. float32 operands run on ``rdb_modes_tf32.cu``
  (float32 K1's machinery, the rectangles' ``"wt"`` slices, its patch side
  from :func:`packed_tf32_geometry`);
- :func:`rdb_apply_chained` (K3, ``_rdb_kernel(chained=True)``): one RDB
  that reads and writes the zero-aproned layout of :func:`to_chained`,
  folding the residual where a device flag is 1, on ``rdb_modes_wgmma.cu``
  (K1's stages, its window read from a bfloat16 operand plane in the same
  layout, K1's patch side); :func:`rdb_trunk_chained` rotates three such
  buffers and, in mixed mode, their three operand planes. float32 operands
  run on ``rdb_modes_tf32.cu`` (float32 K1's stages and patch side, the
  window read from the float32 layout itself);
- :func:`rdb_apply_paired` (K4, ``_rdb_kernel(paired=True)``): one RDB on a
  state carried as bf16 ``hi + lo`` planes, on ``rdb_modes_wgmma.cu`` (K1's
  stages, its window read from ``hi``, K1's patch side);
  :func:`rdb_trunk_paired`.

Tensors are NHWC. The state dtype is ``x``'s dtype; the operand dtype is the
packed weights' dtype (:func:`pack_rdb_params`). Every kernel runs on the
tensor cores at nf, gc = 64, 32 or 32, 16. K1, K3 and K5 have float32 state
and operands, or bfloat16 operands with float32 (mixed) or bfloat16 state;
K4 is mixed mode only (float32 state as hi + lo, bfloat16 operands), as the
JAX package's paired carry (:data:`_OPERANDS`).

A tensor on the CPU takes the plain PyTorch version (``*_reference``); a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from realsr_tpu_torch.models.rrdbnet import (
    RESIDUAL_SCALE,
    _lrelu,
    _rdb,
    _rdb_c5,
    operand,
)

# kernel launches per wrapper since the last reset (set the values to 0)
LAUNCHES = {"rdb_apply": 0, "rdb_apply_packed": 0, "rdb_apply_chained": 0, "rdb_apply_paired": 0}
_COUNT_LOCK = threading.Lock()

_DTYPE_PAIRS = {
    (torch.float32, torch.float32): (0, 0),
    (torch.float32, torch.bfloat16): (0, 1),
    (torch.bfloat16, torch.bfloat16): (1, 1),
}
# the operand types each wrapper's kernels have instances for: K4 is the
# JAX package's paired carry, mixed mode only, so it has no float32 form
_OPERANDS = {
    "rdb_apply": (torch.bfloat16, torch.float32),
    "rdb_apply_packed": (torch.bfloat16, torch.float32),
    "rdb_apply_chained": (torch.bfloat16, torch.float32),
    "rdb_apply_paired": (torch.bfloat16,),
}
# (nf, gc) the tensor-core kernels are instantiated for
_TC_SHAPES = ((64, 32), (32, 16))
# patch sides the wgmma RDB kernel is instantiated for (rdb_wgmma.cu::launch_tile;
# K3 and K4 too, rdb_modes_wgmma.cu::chained_tile, paired_tile)
WGMMA_TILES = (17, 12, 8)
# K1's float32 patch sides (rdb_tf32.cu::launch_tile): its float32 planes
# cap the side at 10 (tf32_smem_bytes)
TF32_TILES = (10, 9, 8)
# LayoutF32 (rdb_wgmma.cuh): the largest ring slot, and the shared memory
# one block may use on the card
TF32_SLOT_MAX, SMEM_BLOCK = 12288, 232_448
# K5's patch sides (rdb_modes_wgmma.cu::packed_tile): its f32 partial sums
# cap the side at 12 (packed_smem_bytes); with float32 planes at 8
# (rdb_modes_tf32.cu::packed_tile, packed_tf32_smem_bytes)
PACKED_TILES = (12, 8)
PACKED_TF32_TILES = (8, 7)
# K5's shared memory (rdb_modes_wgmma.cu::PackedLayout): floats of padding
# per pixel row of the partial sums, and k16 slices of rectangle C per ring slot
PACKED_PAD_F, PACKED_SLICES = 4, 3
# rdb_geometry's price of one block beyond its MACs (the window's load, each
# stage's pipeline fill, barrier and epilogue), in MACs: fitted to the
# kernel's times at T = 17, 12 and 8 on 8 x 148^2 (chip_smoke.py phase 3).
# tf32_geometry's is the same time in float32 MACs, each of which costs six
# bf16 MACs (three tf32 products at half the bf16 rate).
BLOCK_OVERHEAD_MACS = 20_000_000
TF32_BLOCK_OVERHEAD_MACS = BLOCK_OVERHEAD_MACS // 6
HALO = 5  # receptive field of an RDB's five 3x3 convs
SCHEDS = ("scatter", "packed")
# the chained layout: the side its image is rounded up to (the JAX
# package's), and the apron (the halo of five 3x3 convs) around the image
CHAIN_TILE, CHAIN_APRON = 16, 5


def _rects(sched: str):
    """The weights' five GEMM rectangles as (sources, convs): sources are 0
    (the block input x) and j (c_j), convs the outputs' convs 1..5.
    'scatter': conv i over all its inputs. 'packed': the JAX package's
    K-packed rectangles A {x} -> {c1, c2}, B {c1} -> {c2}, C {x, c1, c2} ->
    {c3, c4, c5}, D {c3} -> {c4, c5}, E {c4} -> {c5}."""
    if sched == "scatter":
        return [(tuple(range(i)), (i,)) for i in range(1, 6)]
    if sched == "packed":
        return [((0,), (1, 2)), ((1,), (2,)), ((0, 1, 2), (3, 4, 5)), ((3,), (4, 5)), ((4,), (5,))]
    raise ValueError(f"unknown sched {sched!r}; expected one of {SCHEDS}")


def _step_order(order: str, n_out: int) -> Tuple[np.ndarray, np.ndarray]:
    """(n, k) of each element of one k-step (16 rows k, 8 for 'tf32', x
    ``n_out`` columns n of a rectangle) in the order the kernel reads them.

    'wgmma': wgmma's canonical K-major layout without swizzle, as
    rdb_wgmma.cuh's matrix descriptor reads it: 8 x 8 core matrices (8 n, 8
    consecutive k: 128 bytes), the two k halves of an 8-column group next to
    each other (leading offset 128 bytes), the groups 256 bytes apart.
    'tf32': the same bytes for a k8 slice of 4-byte values, each core matrix
    8 n x 4 consecutive k.
    """
    if order == "wgmma":
        i = np.arange(16 * n_out)
        return (i // 128) * 8 + (i // 8) % 8, ((i // 64) % 2) * 8 + i % 8
    if order == "tf32":
        i = np.arange(8 * n_out)
        return (i // 64) * 8 + (i // 4) % 8, ((i // 32) % 2) * 4 + i % 4
    raise ValueError(f"unknown k-step order {order!r}")


def _kstep(order: str) -> int:
    """Input channels of one k-step in ``order`` (:func:`_step_order`)."""
    return 8 if order == "tf32" else 16


@functools.lru_cache(maxsize=16)
def _perm(nf: int, gc: int, sched: str, frag: bool, order: str = "wgmma") -> np.ndarray:
    """Index map from the dense layout (each conv as ``[cin][3][3][cout]``,
    back to back) to the kernel's: ``packed = dense[perm]``.

    The rectangles (:func:`_rects`) follow each other. ``frag`` False: each
    rectangle as ``[K][N]`` with K over (source, channel, tap), which for
    'scatter' is the dense layout itself (the plain versions' layout).
    ``frag`` True (tensor cores): k-steps over (source, tap, channel block)
    in the order the kernels walk them, each k-step in :func:`_step_order`
    ``order`` ('wgmma' for the bf16 kernels K1, K3, K4 and K5, 'tf32' for
    K1's float32 instances).
    """
    kstep = _kstep(order)
    if frag and (nf % kstep or gc % kstep):
        raise ValueError(f"the {order} order needs nf, gc multiples of {kstep} (got {nf}, {gc})")

    def cout(i):
        return gc if i < 5 else nf

    def cin(j):
        return nf if j == 0 else gc

    def kbase(j):
        return 0 if j == 0 else nf + (j - 1) * gc

    off, o = {}, 0
    for i in range(1, 6):
        off[i] = o
        o += (nf + (i - 1) * gc) * 9 * cout(i)
    parts = []
    for sources, convs in _rects(sched):
        # output column n of the rectangle -> (its conv's offset, cout, co)
        base = np.concatenate([np.full(cout(i), off[i]) for i in convs])
        width = np.concatenate([np.full(cout(i), cout(i)) for i in convs])
        co = np.concatenate([np.arange(cout(i)) for i in convs])
        if frag:
            n, k = _step_order(order, co.size)
            for j in sources:
                for tap in range(9):
                    for kb in range(cin(j) // kstep):
                        parts.append(base[n] + ((kbase(j) + kb * kstep + k) * 9 + tap) * width[n] + co[n])
        else:
            for j in sources:
                ci, tap, n = np.meshgrid(
                    np.arange(cin(j)), np.arange(9), np.arange(co.size), indexing="ij"
                )
                parts.append((base[n] + ((kbase(j) + ci) * 9 + tap) * width[n] + co[n]).ravel())
    return np.concatenate(parts)


def tf32_split(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """float32 ``v`` -> (hi, lo): hi = ``v`` rounded to tf32 (10 mantissa
    bits, to nearest, ties away from zero: ``cvt.rna.tf32.f32``), lo = the
    remainder ``v - hi`` (exact in float32) rounded the same way, so that
    ``hi + lo`` is within 2^-22 of ``v``, relative: the 3xTF32 kernel's
    weights. (Its activations split on the card by truncation, cheaper:
    hopper.cuh::split_tf32.)"""

    def rna(a):
        bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
        return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)

    hi = rna(v)
    return hi, rna(np.asarray(v, np.float32) - hi)


def _rect_sizes(nf: int, gc: int, sched: str):
    """(weights, N) of each GEMM rectangle of ``sched`` (:func:`_rects`)."""
    out = []
    for sources, convs in _rects(sched):
        n = sum(gc if i < 5 else nf for i in convs)
        out.append((9 * sum(nf if j == 0 else gc for j in sources) * n, n))
    return out


def _tf32_slices(w: np.ndarray, nf: int, gc: int, sched: str = "scatter") -> np.ndarray:
    """Dense float32 weights ``[..., K]`` (the scatter schedule) -> the
    3xTF32 kernels' ``"wt"`` ``[..., 2K]``: the k8 steps of ``sched``'s
    rectangles in 'tf32' order (:func:`_perm`; 'scatter' K1's and K3's,
    'packed' K5's), each as its tf32 hi slice followed by its lo slice
    (:func:`tf32_split`)."""
    hi, lo = tf32_split(w[..., _perm(nf, gc, sched, True, "tf32")])
    lead, parts, o = w.shape[:-1], [], 0
    for size, n in _rect_sizes(nf, gc, sched):
        pair = np.stack([t[..., o : o + size].reshape(*lead, -1, 8 * n) for t in (hi, lo)], -2)
        parts.append(pair.reshape(*lead, 2 * size))
        o += size
    return np.ascontiguousarray(np.concatenate(parts, -1))


def _tf32_unslice(wt: torch.Tensor, nf: int, gc: int, sched: str = "scatter") -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`_tf32_slices`' interleave for one RDB: (hi, lo) in
    'tf32' order."""
    his, los, o = [], [], 0
    for size, n in _rect_sizes(nf, gc, sched):
        pair = wt[2 * o : 2 * (o + size)].reshape(-1, 2, 8 * n)
        his.append(pair[:, 0].reshape(-1))
        los.append(pair[:, 1].reshape(-1))
        o += size
    return torch.cat(his), torch.cat(los)


def _frag(dtype, nf: int, gc: int) -> bool:
    """Whether weights of ``dtype`` get the bf16 kernels' copy ``"wg"``:
    bfloat16 at channel counts a tensor-core kernel can take (multiples of
    16; every instance is)."""
    return dtype == torch.bfloat16 and nf % 16 == 0 and gc % 16 == 0


@functools.lru_cache(maxsize=16)
def _perm_on(nf: int, gc: int, sched: str, frag: bool, order: str, device: torch.device) -> torch.Tensor:
    """:func:`_perm` as an index tensor on ``device``."""
    return torch.from_numpy(_perm(nf, gc, sched, frag, order)).to(device)


def pack_rdb_params(rdb: Dict[str, np.ndarray], op_dtype=torch.float32, sched: str = "scatter"):
    """Dense OIHW RDB params -> the kernel's layout.

    ``rdb``: ``w1..w5`` ``[..., cout, cin, 3, 3]`` and ``b1..b5``
    ``[..., cout]`` (numpy; any leading dims, e.g. the trunk's
    ``[num_rrdb, 3]``). Returns ``{"w": [..., K] op_dtype, "b": [..., 4gc+nf]
    float32}`` as CPU tensors, where ``w`` holds the schedule's five
    rectangles (:func:`_rects`) back to back, each as ``[K][N]``: the plain
    versions read it. ``sched="packed"`` re-cuts the same weight values into
    the K-packed schedule's rectangles, for :func:`rdb_apply_packed`. The
    kernels read copies in their own order (:func:`_perm`): bfloat16
    operands get ``"wg"`` (:func:`_frag`; the wgmma order, read by K1, K3,
    K4 and, with ``sched="packed"``, K5), float32 operands ``"wt"``
    (float32, twice ``w``'s length: each k8 step's tf32 hi and lo slices,
    :func:`_tf32_slices`, read by the float32 instances of K1 and K3 and,
    with ``sched="packed"``, K5).
    """
    _rects(sched)
    ws, bs = [], []
    for i in range(1, 6):
        w = np.moveaxis(np.asarray(rdb[f"w{i}"], np.float32), -4, -1)
        ws.append(w.reshape(*w.shape[:-4], -1))
        bs.append(np.asarray(rdb[f"b{i}"], np.float32))
    w = np.concatenate(ws, -1)
    gc, nf = np.shape(rdb["w1"])[-4:-2]
    out = {}
    if _frag(op_dtype, nf, gc):
        wg = w[..., _perm(nf, gc, sched, True, "wgmma")]
        out["wg"] = torch.from_numpy(np.ascontiguousarray(wg)).to(op_dtype)
    if op_dtype == torch.float32 and nf % 8 == 0 and gc % 8 == 0:
        out["wt"] = torch.from_numpy(_tf32_slices(w, nf, gc, sched))
    if sched != "scatter":
        w = w[..., _perm(nf, gc, sched, False)]
    out["w"] = torch.from_numpy(np.ascontiguousarray(w)).to(op_dtype)
    out["b"] = torch.from_numpy(np.concatenate(bs, -1))
    return out


def unpack_rdb_params(
    p: Dict[str, torch.Tensor], nf: int, sched: str = "scatter", key: str = "w"
) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`pack_rdb_params` for one RDB: OIHW tensors, from
    ``p[key]`` (``"wg"``: the bf16 wgmma kernels' copy; ``"wt"``: the
    float32 kernel's, as its hi + lo)."""
    w, b = p[key], p["b"]
    gc = (b.shape[-1] - nf) // 4
    if key == "wt":
        hi, lo = _tf32_unslice(w, nf, gc, sched)
        w = torch.empty_like(hi)
        w[_perm_on(nf, gc, sched, True, "tf32", hi.device)] = hi + lo
    elif key == "wg" or sched != "scatter":
        dense = torch.empty_like(w)
        dense[_perm_on(nf, gc, sched, key == "wg", "wgmma", w.device)] = w
        w = dense
    out = {}
    off, cin = 0, nf
    for i in range(1, 6):
        cout = gc if i < 5 else nf
        n = cin * 9 * cout
        out[f"w{i}"] = w[off : off + n].reshape(cin, 3, 3, cout).permute(3, 0, 1, 2)
        out[f"b{i}"] = b[(i - 1) * gc : (i - 1) * gc + cout]
        off += n
        cin += gc
    return out


def rdb_reference(x, p, storage_dtype, op_dtype, u=None, xs=None):
    """Plain PyTorch version of K1: one RDB on NHWC ``x``.

    Operands are rounded to ``op_dtype`` and convolved in float32. With TF32
    off (:func:`~realsr_tpu_torch.models.rrdbnet.tf32`) on a GPU, it
    differs from the kernel on the same inputs only in the order of the sums.
    ``xs``: ``x`` already rounded to ``op_dtype`` (the operand plane
    :func:`rdb_trunk` threads); the convs read it, the residual reads ``x``.
    """
    w = unpack_rdb_params(p, x.shape[-1])
    if xs is None:
        y = _rdb(x.permute(0, 3, 1, 2), w, storage_dtype, op_dtype)
    else:
        c5 = _rdb_c5(xs.permute(0, 3, 1, 2).float(), w, storage_dtype, op_dtype)
        y = (RESIDUAL_SCALE * c5 + x.permute(0, 3, 1, 2).float()).to(storage_dtype)
    return _nhwc_out(_residual(y, u, storage_dtype))


def _residual(y, u, storage_dtype):
    """The RRDB residual ``0.2 * y + u`` (NCHW ``y``, NHWC ``u``)."""
    if u is None:
        return y
    return (RESIDUAL_SCALE * y.float() + u.permute(0, 3, 1, 2).float()).to(storage_dtype)


def _nhwc_out(y):
    return y.permute(0, 2, 3, 1).contiguous()


def rdb_packed_reference(x, p, storage_dtype, op_dtype, u=None, xs=None):
    """Plain PyTorch version of K5: one RDB on NHWC ``x`` in the K-packed
    schedule, with the kernel's (and the JAX package's) grouping of the
    sums: each rectangle is one conv over its concatenated sources, and its
    bias or partial sum is added after. Rectangle C convolves
    ``concat(x, c1, c2)`` with its K = 9 (nf + 2gc) weights. ``xs``: ``x``
    already rounded to ``op_dtype`` (the operand plane :func:`rdb_trunk`
    threads); the convs read it, the residual reads ``x``."""
    nf = x.shape[-1]
    w = unpack_rdb_params(p, nf, "packed")
    gc = w["b1"].shape[0]
    b = p["b"].float()

    def rect(srcs, sources, convs):
        lo = [0 if j == 0 else nf + (j - 1) * gc for j in sources]
        n = [nf if j == 0 else gc for j in sources]
        wr = torch.cat(
            [torch.cat([w[f"w{i}"][:, a : a + k] for a, k in zip(lo, n)], 1) for i in convs], 0
        )
        return F.conv2d(operand(torch.cat(srcs, 1), op_dtype), operand(wr, op_dtype), padding=1)

    def bias(lo, hi):
        return b[lo:hi][:, None, None]

    xn = x.permute(0, 3, 1, 2)
    xs = xn if xs is None else xs.permute(0, 3, 1, 2)
    pa = rect([xs], (0,), (1, 2))
    c1 = _lrelu(pa[:, :gc] + bias(0, gc)).to(storage_dtype)
    a2 = pa[:, gc:] + bias(gc, 2 * gc)
    c2 = _lrelu(a2 + rect([c1], (1,), (2,))).to(storage_dtype)
    pc = rect([xs, c1, c2], (0, 1, 2), (3, 4, 5))
    c3 = _lrelu(pc[:, :gc] + bias(2 * gc, 3 * gc)).to(storage_dtype)
    a4 = pc[:, gc : 2 * gc] + bias(3 * gc, 4 * gc)
    a5 = pc[:, 2 * gc :] + bias(4 * gc, 4 * gc + nf)
    pd = rect([c3], (3,), (4, 5))
    c4 = _lrelu(a4 + pd[:, :gc]).to(storage_dtype)
    a5 = a5 + pd[:, gc:]
    c5 = a5 + rect([c4], (4,), (5,))
    y = (RESIDUAL_SCALE * c5 + xn.float()).to(storage_dtype)
    return _nhwc_out(_residual(y, u, storage_dtype))


def to_chained(x: torch.Tensor) -> torch.Tensor:
    """NHWC ``[B, H, W, nf]`` -> the chained layout ``[B, Hp + 10, Wp + 10,
    nf]`` (Hp, Wp: H, W rounded up to :data:`CHAIN_TILE`) with the image at
    row and column :data:`CHAIN_APRON` and zeros elsewhere."""
    B, H, W, C = x.shape
    A, T = CHAIN_APRON, CHAIN_TILE
    out = x.new_zeros((B, -(-H // T) * T + 2 * A, -(-W // T) * T + 2 * A, C))
    out[:, A : A + H, A : A + W] = x
    return out


def from_chained(t: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """The image ``[B, H, W, nf]`` of a chained layout (a view)."""
    A = CHAIN_APRON
    return t[:, A : A + H, A : A + W]


def rdb_chained_reference(x, p, u, flag, H, W, out, storage_dtype, op_dtype, shadow=None):
    """Plain PyTorch version of K3: the RDB of chained ``x``'s image,
    folding ``0.2 * y + u`` (``u`` chained too) where ``flag[0] == 1``,
    written into ``out``'s image (and, rounded, into ``shadow``'s when
    given); the aprons are not touched."""
    u_img = from_chained(u, H, W) if int(flag[0]) == 1 else None
    y = rdb_reference(from_chained(x, H, W), p, storage_dtype, op_dtype, u_img)
    from_chained(out, H, W).copy_(y)
    if shadow is not None:
        from_chained(shadow, H, W).copy_(y)
    return out


def _split(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 ``v`` -> (hi, lo) bf16 planes: hi = bf16(v), lo = bf16(v - hi)."""
    hi = v.to(torch.bfloat16)
    return hi, (v - hi.float()).to(torch.bfloat16)


def rdb_paired_reference(hi, lo, p, u=None):
    """Plain PyTorch version of K4: one RDB on the state ``hi + lo`` (NHWC
    bf16 planes) -> (hi', lo'). The convs read ``hi`` (mixed mode's operand,
    c1..c4 in bf16); ``center = (0.2 * c5 + hi) + lo`` in float32 is split
    again; ``u`` = (u_hi, u_lo) folds the RRDB residual ``0.2 * (hi' + lo')
    + (u_hi + u_lo)`` before the split, as the JAX trunk sums it."""
    w = unpack_rdb_params(p, hi.shape[-1])
    h = hi.permute(0, 3, 1, 2)
    c5 = _rdb_c5(h, w, torch.bfloat16, torch.bfloat16)
    nchw = lambda t: t.permute(0, 3, 1, 2).float()  # noqa: E731
    hi2, lo2 = _split((RESIDUAL_SCALE * c5 + h.float()) + nchw(lo))
    if u is not None:
        hi2, lo2 = _split(
            RESIDUAL_SCALE * (hi2.float() + lo2.float()) + (nchw(u[0]) + nchw(u[1]))
        )
    return _nhwc_out(hi2), _nhwc_out(lo2)


@dataclasses.dataclass(frozen=True)
class RdbGeometry:
    """A wgmma RDB kernel's grid for one chunk (:func:`rdb_geometry`,
    :func:`packed_geometry`)."""

    tile: int  # output patch side T
    patches: Tuple[int, int]  # patch rows and columns of one image
    blocks: int  # patches x images: one block each, one block per SM
    waves: float  # blocks / SMs
    fill: float  # blocks / (whole waves x SMs)
    mac_factor: float  # MACs the blocks issue / the RDB's MACs


def _region_rows(tile: int, r: int) -> int:
    """Rows of region r (1..5) of a patch, in whole 64-row m-tiles."""
    side = tile + 2 * HALO - 2 * r
    return -(-side * side // 64) * 64


def block_macs(tile: int, nf: int, gc: int) -> int:
    """MACs one block of K1 (and K4) issues: each stage's region in 64-row
    tiles, times its K (9 taps x its input channels) and N (gc or nf)."""
    return sum(
        _region_rows(tile, r) * 9 * (nf + (r - 1) * gc) * (gc if r < 5 else nf) for r in range(1, 6)
    )


def packed_block_macs(tile: int, nf: int, gc: int) -> int:
    """MACs one block of K5 issues: each rectangle (:func:`_rects`
    'packed') over its first output's region in 64-row tiles, times its K
    and N (68.42 M at T = 12, nf = 64, gc = 32)."""
    total = 0
    for sources, convs in _rects("packed"):
        k = 9 * sum(nf if j == 0 else gc for j in sources)
        n = sum(gc if i < 5 else nf for i in convs)
        total += _region_rows(tile, convs[0]) * k * n
    return total


def _partial_bytes(tile: int, nf: int, gc: int) -> int:
    """K5's f32 partial sums (rdb_modes.cuh::PackedLayout): a2 on c2's
    region; a4 and a5 on c4's and the output's, in the same bytes."""
    side = [tile + 2 * HALO - 2 * j for j in range(6)]
    a2 = 4 * side[2] ** 2 * (gc + PACKED_PAD_F)
    a45 = 4 * (side[4] ** 2 * (gc + PACKED_PAD_F) + side[5] ** 2 * (nf + PACKED_PAD_F))
    return max(a2, a45)


def packed_smem_bytes(tile: int, nf: int, gc: int) -> int:
    """Shared memory of one K5 block (rdb_modes.cuh::PackedLayout): K1's
    bf16 planes (the window, c1..c4), the f32 partial sums, two ring slots
    of :data:`PACKED_SLICES` k16 slices of rectangle C, five barriers and
    the base's alignment to 1024 bytes."""
    side = [tile + 2 * HALO - 2 * j for j in range(6)]
    planes = 2 * nf * side[0] ** 2 + sum(2 * gc * s * s for s in side[1:5])
    return planes + _partial_bytes(tile, nf, gc) + 2 * PACKED_SLICES * (2 * gc + nf) * 32 + 8 * 5 + 1024


def packed_tf32_smem_bytes(tile: int, nf: int, gc: int) -> int:
    """Shared memory of one float32 K5 block (PackedLayout on LayoutF32):
    float32 K1's planes (:func:`_tf32_planes`), the f32 partial sums, two
    ring slots of what the rest leaves in 2 KB units, at most
    :data:`TF32_SLOT_MAX` (and at least one k8 step of rectangle C, its hi
    and lo slices), five barriers and the base's alignment to 1,024 bytes."""
    fixed = _tf32_planes(tile, nf, gc) + _partial_bytes(tile, nf, gc)
    slot = max(2 * (2 * gc + nf) * 32, min(TF32_SLOT_MAX, (SMEM_BLOCK - 1024 - 40 - fixed) // 2 // 2048 * 2048))
    return fixed + 2 * slot + 40 + 1024


def rdb_macs_per_pixel(nf: int, gc: int) -> int:
    return 9 * sum((nf + i * gc) * (gc if i < 4 else nf) for i in range(5))


def _geometry(tiles, macs, B: int, H: int, W: int, nf: int, gc: int, sms: int,
              overhead: int = BLOCK_OVERHEAD_MACS) -> RdbGeometry:
    """The patch side of ``tiles`` that finishes ``B`` tiles of ``H x W``
    soonest on ``sms`` SMs, one block per SM: the fewest whole waves times a
    block's price (``macs(tile, nf, gc)`` plus ``overhead``; the larger side
    on a tie)."""
    best = None
    for tile in sorted(tiles, reverse=True):
        py, px = -(-H // tile), -(-W // tile)
        blocks = B * py * px
        waves = -(-blocks // sms)
        cost = waves * (macs(tile, nf, gc) + overhead)
        if best is None or cost < best[0]:
            best = (cost, tile, (py, px), blocks, waves)
    _, tile, patches, blocks, waves = best
    return RdbGeometry(
        tile=tile, patches=patches, blocks=blocks, waves=blocks / sms,
        fill=blocks / (waves * sms),
        mac_factor=blocks * macs(tile, nf, gc) / (B * H * W * rdb_macs_per_pixel(nf, gc)),
    )


def _tf32_planes(tile: int, nf: int, gc: int) -> int:
    """Bytes of LayoutF32's planes: the float32 window (for nf > 32,
    32-channel sub-planes each padded to 1,024 bytes) and c1..c4."""
    side = [tile + 2 * HALO - 2 * j for j in range(6)]
    p0 = side[0] ** 2
    window = 4 * nf * p0 if nf <= 32 else nf // 32 * (-(-p0 * 128 // 1024) * 1024)
    return window + sum(4 * gc * s * s for s in side[1:5])


def tf32_smem_bytes(tile: int, nf: int, gc: int) -> int:
    """Shared memory of one block of K1's float32 kernel
    (rdb_wgmma.cuh::LayoutF32): the float32 window (for nf > 32, 32-channel
    sub-planes each padded to 1,024 bytes) and c1..c4, two ring slots as
    large as the rest allows in whole k8 steps of c5 (its hi and lo slices,
    2 x nf x 32 bytes), at least one and at most :data:`TF32_SLOT_MAX`
    bytes, five barriers and the base's alignment to 1,024 bytes."""
    planes = _tf32_planes(tile, nf, gc)
    step5 = 2 * nf * 32
    slot = max(step5, min(TF32_SLOT_MAX, (SMEM_BLOCK - 1024 - 40 - planes) // 2 // step5 * step5))
    return planes + 2 * slot + 40 + 1024


def rdb_geometry(B: int, H: int, W: int, nf: int = 64, gc: int = 32, sms: int = 132) -> RdbGeometry:
    """K1's (and K4's) patch side of :data:`WGMMA_TILES` for ``B`` tiles of
    ``H x W`` (:func:`_geometry`, :func:`block_macs`). At 8 x 148^2 on 132
    SMs: T = 17, 648 blocks in 4.91 waves."""
    return _geometry(WGMMA_TILES, block_macs, B, H, W, nf, gc, sms)


def tf32_geometry(B: int, H: int, W: int, nf: int = 64, gc: int = 32, sms: int = 132) -> RdbGeometry:
    """K1's float32 patch side of :data:`TF32_TILES` (:func:`_geometry`,
    :func:`block_macs`, :data:`TF32_BLOCK_OVERHEAD_MACS`). At 8 x 148^2 on
    132 SMs: T = 10, 1,800 blocks in 13.64 waves, 2.00x the RDB's MACs
    issued."""
    return _geometry(TF32_TILES, block_macs, B, H, W, nf, gc, sms, TF32_BLOCK_OVERHEAD_MACS)


def packed_geometry(B: int, H: int, W: int, nf: int = 64, gc: int = 32, sms: int = 132) -> RdbGeometry:
    """K5's patch side of :data:`PACKED_TILES` (:func:`_geometry`,
    :func:`packed_block_macs`). At 8 x 148^2 on 132 SMs: T = 12, 1,352
    blocks in 10.24 waves, 2.203x the RDB's MACs issued."""
    return _geometry(PACKED_TILES, packed_block_macs, B, H, W, nf, gc, sms)


def packed_tf32_geometry(B: int, H: int, W: int, nf: int = 64, gc: int = 32, sms: int = 132) -> RdbGeometry:
    """K5's float32 patch side of :data:`PACKED_TF32_TILES`, the sides whose
    float32 planes and partial sums fit (:func:`packed_tf32_smem_bytes`;
    :func:`_geometry` with :data:`TF32_BLOCK_OVERHEAD_MACS`). At 8 x 148^2
    on 132 SMs: T = 8, 2,888 blocks in 21.88 waves, 3.083x the RDB's MACs
    issued (float32 K1: 1.998x)."""
    return _geometry(PACKED_TF32_TILES, packed_block_macs, B, H, W, nf, gc, sms, TF32_BLOCK_OVERHEAD_MACS)


@functools.lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _bind(lib, fns):
    if not getattr(lib, "_realsr_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for name, (n_ptr, n_int) in fns.items():
            f = getattr(lib, name)
            f.argtypes = [vp] * n_ptr + [ci] * n_int + [vp]
            f.restype = ci
        lib.rdb_error_string.argtypes = [ci]
        lib.rdb_error_string.restype = ctypes.c_char_p
        lib._realsr_bound = True
    return lib


def rdb_group(state_dtype, nf: int) -> str:
    """The build group (``ops/build.py::GROUPS``) of the RDB instances for a
    state type and width: ``f32_nf64``, ``bf16_nf32``, ... (the paired
    carry's bf16 planes hold a float32 state: ``f32``)."""
    return f"{'bf16' if state_dtype == torch.bfloat16 else 'f32'}_nf{nf}"


def _wgmma_library(group: str):
    """rdb_wgmma.cu's ``group``: K1/K2 for bfloat16 operands."""
    from realsr_tpu_torch.ops.build import load_library

    return _bind(load_library("rdb_wgmma", group), {"rdb_wgmma_launch": (7, 7)})


def _tf32_library(group: str):
    """rdb_tf32.cu's ``group``: K1/K2 for float32 operands."""
    from realsr_tpu_torch.ops.build import load_library

    return _bind(load_library("rdb_tf32", group), {"rdb_tf32_launch": (5, 6)})


def _modes_library(group: str):
    """rdb_modes_wgmma.cu's ``group``: K3, K4 and K5 for bfloat16 operands."""
    from realsr_tpu_torch.ops.build import load_library

    return _bind(load_library("rdb_modes_wgmma", group), {
        "rdb_chained_launch": (8, 9), "rdb_paired_launch": (8, 6), "rdb_packed_launch": (7, 7)})


def _modes_tf32_library(group: str):
    """rdb_modes_tf32.cu's ``group``: K3 and K5 for float32 operands."""
    from realsr_tpu_torch.ops.build import load_library

    return _bind(load_library("rdb_modes_tf32", group), {
        "rdb_chained_tf32_launch": (6, 8), "rdb_packed_tf32_launch": (5, 6)})


def _check(name, t, device, dtype, numel=None, shape=None):
    if t.device != device:
        raise ValueError(f"rdb_apply: {name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise ValueError(f"rdb_apply: {name} is {t.dtype}, expected {dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"rdb_apply: {name} must be contiguous and 16-byte aligned")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"rdb_apply: {name} has {t.numel()} elements, expected {numel}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"rdb_apply: {name} has shape {tuple(t.shape)}, expected {shape}")


def _cuda_operands(fn: str, x, w, b):
    """Checks shared by the wrappers on a CUDA ``x`` ``[B, rows, cols, nf]``:
    (nf, gc, (state_bf16, op_bf16)). The operand type must be one that
    ``fn``'s kernels have instances for (:data:`_OPERANDS`)."""
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"{fn}: x must be [B, H, W, nf], got {tuple(x.shape)}")
    nf = x.shape[-1]
    gc = (b.numel() - nf) // 4
    if w.dtype not in _OPERANDS[fn]:
        what = " (the paired carry runs in mixed mode only)" if fn == "rdb_apply_paired" else ""
        raise ValueError(f"{fn}: no kernel for {w.dtype} operands{what}")
    pair = _DTYPE_PAIRS.get((x.dtype, w.dtype))
    if pair is None:
        raise ValueError(f"{fn}: no kernel for state {x.dtype} / operands {w.dtype}")
    if nf % 8 or gc <= 0 or gc % 8 or b.numel() != nf + 4 * gc:
        raise ValueError(f"{fn}: nf={nf}, gc={gc} must be positive multiples of 8")
    if (nf, gc) not in _TC_SHAPES:
        raise ValueError(f"{fn}: no tensor-core kernel for nf={nf}, gc={gc}")
    k = rdb_macs_per_pixel(nf, gc)
    _check("x", x, x.device, x.dtype)
    _check("w", w, x.device, w.dtype, numel=k)
    _check("b", b, x.device, torch.float32, numel=nf + 4 * gc)
    return nf, gc, pair


def _launched(fn: str, lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{fn} launch failed: {lib.rdb_error_string(err).decode()} ({what})")
    with _COUNT_LOCK:
        LAUNCHES[fn] += 1


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def rdb_apply(x: torch.Tensor, p: Dict[str, torch.Tensor], u: Optional[torch.Tensor] = None):
    """K1: one RDB on NHWC ``x`` ``[B, H, W, nf]`` -> a new tensor like ``x``.

    ``p``: one RDB of :func:`pack_rdb_params`. ``u`` (same shape and dtype as
    ``x``): fold the RRDB residual ``0.2 * y + u`` into the output.
    """
    w = p["w"]
    if x.device.type == "cpu":
        return rdb_reference(x, p, x.dtype, w.dtype, u)
    if w.dtype == torch.bfloat16:
        return _rdb_wgmma(x, _operand_plane(x, w.dtype), p, u, shadow=False)[0]
    return _rdb_tf32(x, p, u)


def _rdb_tf32(x, p, u, tile: Optional[int] = None, packed: bool = False):
    """K1 (or K5 when ``packed``) on the card with float32 state and
    operands (3xTF32 wgmma, the window read from ``x`` itself): the new
    state. ``tile``: a patch side of :data:`TF32_TILES` (K5:
    :data:`PACKED_TF32_TILES`) in place of :func:`tf32_geometry`'s
    (:func:`packed_tf32_geometry`'s) choice."""
    fn = "rdb_apply_packed" if packed else "rdb_apply"
    w, b = p["w"], p["b"]
    nf, gc, _ = _cuda_operands(fn, x, w, b)
    wt = _tf32_weights(fn, p, x, w.numel())
    if u is not None:
        _check("u", u, x.device, x.dtype, shape=x.shape)
    B, H, W, _ = x.shape
    if packed:
        tile = _patch_side(fn, tile, PACKED_TF32_TILES, packed_tf32_geometry, x, B, H, W, nf, gc)
        lib = _modes_tf32_library(rdb_group(x.dtype, nf))
        launch = lib.rdb_packed_tf32_launch
    else:
        tile = _patch_side(fn, tile, TF32_TILES, tf32_geometry, x, B, H, W, nf, gc)
        lib = _tf32_library(rdb_group(x.dtype, nf))
        launch = lib.rdb_tf32_launch
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = launch(
            x.data_ptr(), wt.data_ptr(), b.data_ptr(), None if u is None else u.data_ptr(),
            out.data_ptr(), B, H, W, nf, gc, tile, _stream(x),
        )
    _launched(fn, lib, err, f"B={B}, H={H}, W={W}, nf={nf}, gc={gc}, T={tile}, {x.dtype}")
    return out


def _tf32_weights(fn: str, p, x, numel: int) -> torch.Tensor:
    """``p["wt"]``, checked: the float32 kernels' copy of the weights (tf32
    hi and lo slices, twice ``numel``)."""
    if "wt" not in p:
        raise ValueError(f"{fn}: p has no 'wt' weights (pack_rdb_params with float32 operands)")
    _check("wt", p["wt"], x.device, torch.float32, numel=2 * numel)
    return p["wt"]


def _operand_plane(x: torch.Tensor, op_dtype) -> Optional[torch.Tensor]:
    """The bfloat16 operand plane of the state ``x`` that the wgmma kernel
    reads its window from: ``x`` itself in bfloat16 mode, else ``x``
    rounded to bfloat16 (as the plain version rounds it); None for other
    operand types."""
    if op_dtype != torch.bfloat16:
        return None
    return x if x.dtype == torch.bfloat16 else x.to(torch.bfloat16)


def _wg_weights(fn: str, p, x, numel: int) -> torch.Tensor:
    """``p["wg"]``, checked: the wgmma kernels' copy of the weights."""
    if "wg" not in p:
        raise ValueError(f"{fn}: p has no 'wg' weights (pack_rdb_params with bfloat16 operands)")
    _check("wg", p["wg"], x.device, torch.bfloat16, numel=numel)
    return p["wg"]


def _patch_side(fn: str, tile: Optional[int], tiles, geometry, x, B: int, H: int, W: int, nf: int, gc: int) -> int:
    """``tile`` checked against the patch sides a kernel is built for, or
    ``geometry``'s choice for ``B`` images of ``H x W`` on ``x``'s card."""
    if tile is None:
        return geometry(B, H, W, nf, gc, _sm_count(x.device)).tile
    if tile not in tiles:
        raise ValueError(f"{fn}: no kernel for patch side {tile}; built for {tiles}")
    return tile


def _rdb_wgmma(x, xs, p, u, shadow: bool, tile: Optional[int] = None, packed: bool = False):
    """K1 (or K5 when ``packed``) on the card with bfloat16 operands: (the
    new state, its bfloat16 operand plane or None). ``xs``: ``x``'s operand
    plane; ``shadow``: write bf16(out) beside a float32 ``out``; ``tile``: a
    patch side of :data:`WGMMA_TILES` (K5: :data:`PACKED_TILES`) in place
    of :func:`rdb_geometry`'s (:func:`packed_geometry`'s) choice."""
    fn = "rdb_apply_packed" if packed else "rdb_apply"
    w, b = p["w"], p["b"]
    nf, gc, pair = _cuda_operands(fn, x, w, b)
    wg = _wg_weights(fn, p, x, w.numel())
    _check("xs", xs, x.device, torch.bfloat16, shape=x.shape)
    if u is not None:
        _check("u", u, x.device, x.dtype, shape=x.shape)
    B, H, W, _ = x.shape
    if packed:
        tile = _patch_side(fn, tile, PACKED_TILES, packed_geometry, x, B, H, W, nf, gc)
        lib = _modes_library(rdb_group(x.dtype, nf))
        launch = lib.rdb_packed_launch
    else:
        tile = _patch_side(fn, tile, WGMMA_TILES, rdb_geometry, x, B, H, W, nf, gc)
        lib = _wgmma_library(rdb_group(x.dtype, nf))
        launch = lib.rdb_wgmma_launch
    out = torch.empty_like(x)
    sh = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device) if shadow else None
    with torch.cuda.device(x.device):
        err = launch(
            xs.data_ptr(), x.data_ptr(), wg.data_ptr(), b.data_ptr(),
            None if u is None else u.data_ptr(), out.data_ptr(), None if sh is None else sh.data_ptr(),
            B, H, W, nf, gc, pair[0], tile, _stream(x),
        )
    _launched(fn, lib, err, f"B={B}, H={H}, W={W}, nf={nf}, gc={gc}, T={tile}, {x.dtype}")
    return out, sh


def rdb_apply_packed(x: torch.Tensor, p: Dict[str, torch.Tensor], u: Optional[torch.Tensor] = None):
    """K5: :func:`rdb_apply` in the K-packed schedule; ``p``: one RDB of
    ``pack_rdb_params(..., sched="packed")``."""
    w = p["w"]
    if x.device.type == "cpu":
        return rdb_packed_reference(x, p, x.dtype, w.dtype, u)
    if w.dtype == torch.bfloat16:
        return _rdb_wgmma(x, _operand_plane(x, w.dtype), p, u, shadow=False, packed=True)[0]
    return _rdb_tf32(x, p, u, packed=True)


def rdb_apply_chained(
    x: torch.Tensor, p: Dict[str, torch.Tensor], u: torch.Tensor, flag: torch.Tensor,
    H: int, W: int, out: torch.Tensor, xs: Optional[torch.Tensor] = None,
    shadow: Optional[torch.Tensor] = None, tile: Optional[int] = None,
) -> torch.Tensor:
    """K3: one RDB on the chained layout (:func:`to_chained`) of an ``H x
    W`` image: ``out``'s image becomes the RDB of ``x``'s, with the RRDB
    residual ``0.2 * y + u`` where the int32 device scalar ``flag[0]`` is 1;
    ``out``'s aprons are not written (zero stays zero). ``u`` may be ``out``
    itself: each pixel reads its own ``u`` before it writes. ``xs``: ``x``'s
    bfloat16 operand plane in the same layout, which the kernel reads its
    window from (``x`` itself in bfloat16 mode; cast from ``x`` when None);
    ``shadow``: a bfloat16 layout whose image gets bf16(out), the next
    step's ``xs`` (its aprons must be zero), or None; ``tile``: a patch side
    of :data:`WGMMA_TILES` in place of :func:`rdb_geometry`'s choice. With
    float32 operands the window is read from ``x`` itself (``xs`` and
    ``shadow`` stay None) and ``tile`` is one of :data:`TF32_TILES`
    (:func:`tf32_geometry`, float32 K1's, to which it is bit-equal).
    Returns ``out``."""
    w, b = p["w"], p["b"]
    if x.device.type == "cpu":
        return rdb_chained_reference(x, p, u, flag, H, W, out, x.dtype, w.dtype, shadow)
    fn = "rdb_apply_chained"
    nf, gc, pair = _cuda_operands(fn, x, w, b)
    B, rows, cols, _ = x.shape
    if rows < H + 2 * CHAIN_APRON or cols < W + 2 * CHAIN_APRON:
        raise ValueError(f"{fn}: layout {tuple(x.shape)} too small for {H} x {W}")
    if flag.device != x.device or flag.dtype != torch.int32 or flag.numel() < 1:
        raise ValueError(f"{fn}: flag must be an int32 tensor on {x.device}")
    if w.dtype == torch.float32:
        return _chained_tf32(x, p, u, flag, H, W, out, xs, shadow, tile, nf, gc)
    wg = _wg_weights(fn, p, x, w.numel())
    xs = _operand_plane(x, w.dtype) if xs is None else xs
    for name, t, dtype in (("u", u, x.dtype), ("out", out, x.dtype), ("xs", xs, torch.bfloat16)) + (
        () if shadow is None else (("shadow", shadow, torch.bfloat16),)
    ):
        _check(name, t, x.device, dtype, shape=x.shape)
    if out.data_ptr() in (x.data_ptr(), xs.data_ptr()) or (shadow is not None and shadow.data_ptr() == xs.data_ptr()):
        raise ValueError(f"{fn}: out and shadow must not be x or xs (other blocks read its halo)")
    tile = _patch_side(fn, tile, WGMMA_TILES, rdb_geometry, x, B, H, W, nf, gc)
    lib = _modes_library(rdb_group(x.dtype, nf))
    with torch.cuda.device(x.device):
        err = lib.rdb_chained_launch(
            xs.data_ptr(), x.data_ptr(), wg.data_ptr(), b.data_ptr(), u.data_ptr(), flag.data_ptr(),
            out.data_ptr(), None if shadow is None else shadow.data_ptr(),
            B, H, W, rows, cols, nf, gc, pair[0], tile, _stream(x),
        )
    _launched(fn, lib, err, f"B={B}, {H}x{W} in {rows}x{cols}, nf={nf}, T={tile}, {x.dtype}")
    return out


def _chained_tf32(x, p, u, flag, H, W, out, xs, shadow, tile, nf, gc):
    """K3 with float32 state and operands (rdb_apply_chained's checks done):
    the window is read from ``x``, so there is no operand plane and no
    shadow."""
    fn = "rdb_apply_chained"
    if xs is not None or shadow is not None:
        raise ValueError(f"{fn}: float32 operands read their window from x; xs and shadow must be None")
    wt = _tf32_weights(fn, p, x, p["w"].numel())
    for name, t in (("u", u), ("out", out)):
        _check(name, t, x.device, x.dtype, shape=x.shape)
    if out.data_ptr() == x.data_ptr():
        raise ValueError(f"{fn}: out must not be x (other blocks read its halo)")
    B, rows, cols, _ = x.shape
    tile = _patch_side(fn, tile, TF32_TILES, tf32_geometry, x, B, H, W, nf, gc)
    lib = _modes_tf32_library(rdb_group(x.dtype, nf))
    with torch.cuda.device(x.device):
        err = lib.rdb_chained_tf32_launch(
            x.data_ptr(), wt.data_ptr(), p["b"].data_ptr(), u.data_ptr(), flag.data_ptr(), out.data_ptr(),
            B, H, W, rows, cols, nf, gc, tile, _stream(x),
        )
    _launched(fn, lib, err, f"B={B}, {H}x{W} in {rows}x{cols}, nf={nf}, T={tile}, {x.dtype}")
    return out


def rdb_apply_paired(
    hi: torch.Tensor, lo: torch.Tensor, p: Dict[str, torch.Tensor],
    u: Optional[Tuple[torch.Tensor, torch.Tensor]] = None, tile: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: one RDB on the state ``hi + lo`` (NHWC bf16 planes) -> (hi',
    lo'); ``u`` = (u_hi, u_lo): fold the RRDB residual (see
    :func:`rdb_paired_reference`). The kernel reads its window from ``hi``
    itself; ``tile``: a patch side of :data:`WGMMA_TILES` in place of
    :func:`rdb_geometry`'s choice."""
    w, b = p["w"], p["b"]
    if hi.device.type == "cpu":
        return rdb_paired_reference(hi, lo, p, u)
    if hi.dtype != torch.bfloat16:
        raise ValueError(f"rdb_apply_paired: hi is {hi.dtype}, expected bfloat16")
    nf, gc, _ = _cuda_operands("rdb_apply_paired", hi, w, b)
    wg = _wg_weights("rdb_apply_paired", p, hi, w.numel())
    for name, t in (("lo", lo),) + (() if u is None else (("u_hi", u[0]), ("u_lo", u[1]))):
        _check(name, t, hi.device, torch.bfloat16, shape=hi.shape)
    B, H, W, _ = hi.shape
    tile = _patch_side("rdb_apply_paired", tile, WGMMA_TILES, rdb_geometry, hi, B, H, W, nf, gc)
    hi2, lo2 = torch.empty_like(hi), torch.empty_like(lo)
    lib = _modes_library(rdb_group(torch.float32, nf))
    with torch.cuda.device(hi.device):
        err = lib.rdb_paired_launch(
            hi.data_ptr(), lo.data_ptr(), wg.data_ptr(), b.data_ptr(),
            None if u is None else u[0].data_ptr(), None if u is None else u[1].data_ptr(),
            hi2.data_ptr(), lo2.data_ptr(), B, H, W, nf, gc, tile, _stream(hi),
        )
    _launched("rdb_apply_paired", lib, err, f"B={B}, H={H}, W={W}, nf={nf}, gc={gc}, T={tile}")
    return hi2, lo2


def _rdb_k(stacked, k):
    return {name: v[k] for name, v in stacked.items()}


def _rdb_step(x, xs, p, u, keep: bool, sched: str):
    """One RDB of :func:`rdb_trunk` on ``x`` and its operand plane ``xs``:
    (the new state, its operand plane if ``keep``, else None)."""
    w = p["w"]
    packed = sched == "packed"
    if x.device.type == "cpu":
        ref = rdb_packed_reference if packed else rdb_reference
        y = ref(x, p, x.dtype, w.dtype, u, xs)
        return y, (_operand_plane(y, w.dtype) if keep else None)
    if w.dtype != torch.bfloat16:
        return (rdb_apply_packed if packed else rdb_apply)(x, p, u), None
    out, sh = _rdb_wgmma(x, xs, p, u, shadow=keep and x.dtype != torch.bfloat16, packed=packed)
    return out, (out if x.dtype == torch.bfloat16 else sh)


def rdb_trunk(x: torch.Tensor, stacked: Dict[str, torch.Tensor], sched: str = "scatter") -> torch.Tensor:
    """The RRDB trunk: ``stacked["w"]`` / ``["b"]`` (and ``["wg"]``) are
    ``[n_rdb, ...]`` (:func:`pack_rdb_params` with the ``[num_rrdb, 3]`` lead
    dims merged). The RRDB residual ``0.2 * y + u`` folds into every third
    RDB, ``u`` being the state that entered its RRDB (x4.param's Eltwise
    coeffs [0.2, 1.0]). With bfloat16 operands the state's bfloat16 operand
    plane is cast once from ``x`` and then written by each RDB beside its
    output for the next. ``sched="packed"`` runs each RDB on K5
    (:func:`rdb_apply_packed`), ``stacked`` packed with that schedule."""
    _rects(sched)
    n = stacked["w"].shape[0]
    t = u = x
    xs = _operand_plane(x, stacked["w"].dtype)
    for k in range(n):
        if k % 3 == 0:
            u = t
        t, xs = _rdb_step(t, xs, _rdb_k(stacked, k), u if k % 3 == 2 else None, k + 1 < n, sched)
    return t


@functools.lru_cache(maxsize=None)
def _chain_flags(n: int, device: torch.device) -> torch.Tensor:
    """int32 [n]: 1 where step k closes an RRDB (k % 3 == 2). Made once per
    (n, device) and never evicted: a captured CUDA graph of the chained
    trunk reads it at a fixed address."""
    return torch.tensor([int(k % 3 == 2) for k in range(n)], dtype=torch.int32, device=device)


def rdb_trunk_chained(x: torch.Tensor, stacked: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The trunk on K3: three chained buffers rotate as the JAX resident
    kernel rotates its planes. Buffer 0 holds the RRDB entry state ``u``;
    step k reads buffer ``k % 3`` and writes ``(k + 1) % 3``, so each
    RRDB-closing step writes ``0.2 * y + u`` back into buffer 0 in place.
    The flags are one int32 device tensor. In mixed mode on the card three
    bfloat16 operand planes (zero aprons) rotate with the buffers: each
    step reads its window from buffer ``k % 3``'s and writes bf16 of its
    output into buffer ``(k + 1) % 3``'s, so the trunk casts once; float32
    operands read the float32 buffers themselves. Returns the image of
    buffer 0, as ``[B, H, W, nf]``."""
    B, H, W, _ = x.shape
    n = stacked["w"].shape[0]
    if n % 3:
        raise ValueError(f"the chained trunk needs whole RRDBs of 3 RDBs, got {n} RDBs")
    bufs = [to_chained(x)]
    bufs += [torch.zeros_like(bufs[0]) for _ in range(2)]
    planes = [None] * 3
    if x.device.type == "cuda" and x.dtype != torch.bfloat16 and stacked["w"].dtype == torch.bfloat16:
        planes = [bufs[0].to(torch.bfloat16)]
        planes += [torch.zeros_like(planes[0]) for _ in range(2)]
    flags = _chain_flags(n, x.device)
    for k in range(n):
        i, o = k % 3, (k + 1) % 3
        rdb_apply_chained(
            bufs[i], _rdb_k(stacked, k), bufs[0], flags[k : k + 1], H, W, bufs[o], planes[i], planes[o]
        )
    return from_chained(bufs[0], H, W).contiguous()


def rdb_trunk_paired(x: torch.Tensor, stacked: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The trunk on K4: the float32 state ``x`` carried as bf16 ``hi + lo``
    through every RDB, with the residual folded into each third; returns
    ``hi + lo`` in float32."""
    hi, lo = _split(x.float())
    u = (hi, lo)
    for k in range(stacked["w"].shape[0]):
        if k % 3 == 0:
            u = (hi, lo)
        hi, lo = rdb_apply_paired(hi, lo, _rdb_k(stacked, k), u if k % 3 == 2 else None)
    return hi.float() + lo.float()
