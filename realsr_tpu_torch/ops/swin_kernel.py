"""Swin kernels: the Python side of ``csrc/swin_kernel.cu``.

- K8 :func:`window_attn`: (shifted-)window multi-head attention of a Swin
  layer, straight from the qkv product's output ``[B, Hp, Wp, 3C]`` to
  ``[B, Hp, Wp, C]``, both at the map's own (un-rolled) coordinates.
- K9 :func:`swin_norm`: the residual add and the LayerNorm that follows it,
  in one pass over the tokens: ``s = x + branch`` (float32), optionally
  ``s = LN_pre(s)``, ``s`` written back as the next residual, and
  ``LN(s)`` (or ``s`` itself) in bfloat16 for the next product.

Both replace no TPU kernel: the JAX package has no transformer. They were
added for Real-SwinIR (``models/swinir.py``), where 54 Swin layers of width
240 and head dim 30 run per tile; both are bound by memory, not by
operations (PERF.md, the kernels table).

Each has a plain PyTorch version here (:func:`window_attn_plain`,
:func:`swin_norm_plain`) that repeats the kernel's arithmetic: operands in
the input's type, float32 sums, softmax in float32 with its probabilities
rounded to the operand type before ``. v`` and the row sums taken before
that rounding, LayerNorm statistics in float32. A tensor on the CPU takes
the plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

LN_EPS = 1e-5  # nn.LayerNorm's default, SwinIR's every norm
MASK_FILL = -100.0  # SwinIR's calculate_mask: scores between different regions
# the kernel's instances (swin_kernel.cu::window_attn_launch, swin_norm_launch)
ATTN_INSTANCES = ((8, 30),)  # (heads, head dim) at window 8
NORM_WIDTHS = (240,)
WINDOW = 8  # the kernel's window side: 64 tokens, four m16 row tiles
BUILD = ("swin_kernel", "swin")  # the build group (ops/build.py::GROUPS)

# kernel launches per wrapper since the last reset (set the values to 0)
LAUNCHES = {"window_attn": 0, "swin_norm": 0}
_COUNT_LOCK = threading.Lock()


def relative_position_index(window: int) -> torch.Tensor:
    """SwinIR's ``relative_position_index``: ``[N * N]`` indices into the
    ``[(2w - 1)^2, heads]`` bias table, N = window^2, row-major pairs
    (query, key)."""
    coords = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window), indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (window - 1)
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).reshape(-1)


def attention_bias(table: torch.Tensor, window: int) -> torch.Tensor:
    """The relative-position bias table ``[(2w - 1)^2, heads]`` gathered
    into ``[heads, N, N]`` float32, once at load."""
    n = window * window
    return table.float()[relative_position_index(window)].view(n, n, -1).permute(2, 0, 1).contiguous()


def region_labels(n: int, window: int, shift: int, device=None) -> torch.Tensor:
    """Region of each row (or column) of a shifted map of side ``n``, as
    SwinIR's ``calculate_mask`` slices it: 0 before ``n - window``, 1 before
    ``n - shift``, 2 after."""
    i = torch.arange(n, device=device)
    return (i >= n - window).long() + (i >= n - shift).long()


def shift_mask(hp: int, wp: int, window: int, shift: int, device=None) -> torch.Tensor:
    """SwinIR's ``calculate_mask`` for an ``hp`` x ``wp`` map: ``[nW, N,
    N]`` float32, 0 between tokens of one region of the shifted map and
    :data:`MASK_FILL` between two regions; windows row-major."""
    lab = 3 * region_labels(hp, window, shift, device)[:, None] + region_labels(wp, window, shift, device)[None, :]
    win = lab.view(hp // window, window, wp // window, window).permute(0, 2, 1, 3).reshape(-1, window * window)
    diff = win[:, None, :] != win[:, :, None]
    return torch.zeros(diff.shape, device=device).masked_fill_(diff, MASK_FILL)


def window_attn_plain(qkv: torch.Tensor, bias: torch.Tensor, heads: int, window: int, shift: int) -> torch.Tensor:
    """Plain version of K8. ``qkv`` ``[B, Hp, Wp, 3C]`` (q | k | v, each
    head's ``C / heads`` channels in turn; q already scaled by
    ``head_dim ** -0.5``), ``bias`` ``[heads, N, N]`` float32, ``shift`` 0
    or the roll of a shifted layer -> ``[B, Hp, Wp, C]`` in ``qkv``'s type:
    roll by ``-shift``, window partition, ``softmax(q k^T + bias + mask) v``
    per window and head, window reverse, roll back."""
    B, H, W, c3 = qkv.shape
    c = c3 // 3
    hd, ny, nx, n = c // heads, H // window, W // window, window * window
    x = torch.roll(qkv, (-shift, -shift), (1, 2)) if shift else qkv
    x = x.reshape(B, ny, window, nx, window, 3, heads, hd).permute(5, 0, 1, 3, 6, 2, 4, 7)
    q, k, v = x.reshape(3, B, ny * nx, heads, n, hd).float().unbind(0)
    s = torch.matmul(q, k.transpose(-1, -2)) + bias.float()
    if shift:
        s = s + shift_mask(H, W, window, shift, qkv.device)[:, None]
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.matmul(p.to(qkv.dtype).float(), v) / p.sum(-1, keepdim=True)
    o = o.to(qkv.dtype).view(B, ny, nx, heads, window, window, hd).permute(0, 1, 4, 2, 5, 3, 6).reshape(B, H, W, c)
    return torch.roll(o, (shift, shift), (1, 2)) if shift else o


def pack_bias(bias: torch.Tensor) -> torch.Tensor:
    """``[..., heads, 64, 64]`` float32 -> K8's bias operand in bfloat16,
    ``[..., heads * 4 * 32 * 32]``: per head and 16-row tile, each lane's 32
    values of the mma.sync accumulator layout in the order the kernel adds
    them (n-tile by n-tile: rows g, g + 8 at columns 2c, 2c + 1), so that a
    lane reads its 64 bytes as four 16-byte loads."""
    lead = bias.shape[:-3]
    heads = bias.shape[-3]
    lane = torch.arange(32)
    g, c = lane // 4, lane % 4
    nt = torch.arange(8)
    # per lane: for each n-tile (row g, 2c), (g, 2c + 1), (g + 8, 2c), (g + 8, 2c + 1)
    rows = torch.stack([g, g, g + 8, g + 8], 1)[:, None, :].expand(32, 8, 4)
    cols = (nt[None, :, None] * 8 + torch.stack([2 * c, 2 * c + 1, 2 * c, 2 * c + 1], 1)[:, None, :])
    mt = torch.arange(4)
    r = mt[:, None, None, None] * 16 + rows[None]  # [4, 32, 8, 4]
    cc = cols[None].expand_as(r)
    out = bias.float()[..., r, cc]  # [..., heads, 4, 32, 8, 4]
    return out.to(torch.bfloat16).reshape(*lead, heads * 4 * 32 * 32).contiguous()


def swin_norm_plain(x: torch.Tensor, branch: Optional[torch.Tensor], weight: Optional[torch.Tensor],
                    bias: Optional[torch.Tensor], pre: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    write_res: bool = True, out_dtype=torch.bfloat16) -> tuple:
    """Plain version of K9 over tokens ``[N, C]``: ``s = x + branch``
    (float32; ``x`` alone without a branch), ``s = LayerNorm_pre(s)`` where
    ``pre`` gives its (weight, bias), then ``(s`` in ``x``'s type where
    ``write_res`` else None, ``LayerNorm(s)`` or, without ``weight``, ``s``
    in ``out_dtype)``."""
    c = x.shape[-1]
    s = x.float() if branch is None else x.float() + branch.float()
    if pre is not None:
        s = F.layer_norm(s, (c,), pre[0].float(), pre[1].float(), LN_EPS)
    y = s if weight is None else F.layer_norm(s, (c,), weight.float(), bias.float(), LN_EPS)
    return (s.to(x.dtype) if write_res else None), y.to(out_dtype)


# -- the kernels ---------------------------------------------------------


def attn_error(heads: int, head_dim: int, window: int) -> Optional[str]:
    """Why K8 has no instance for these widths, or None."""
    if window != WINDOW or (heads, head_dim) not in ATTN_INSTANCES:
        return (f"window_attn is built for window {WINDOW}, (heads, head dim) in {ATTN_INSTANCES}; "
                f"the model has window {window}, {heads} heads of {head_dim}")
    return None


def _library():
    from realsr_tpu_torch.ops.build import load_library

    lib = load_library(*BUILD)
    if not getattr(lib, "_realsr_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.window_attn_launch.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
        lib.window_attn_launch.restype = ci
        lib.swin_norm_launch.argtypes = [vp] * 8 + [ci, ci, ctypes.c_float, vp]
        lib.swin_norm_launch.restype = ci
        lib.swin_error_string.argtypes = [ci]
        lib.swin_error_string.restype = ctypes.c_char_p
        lib._realsr_bound = True
    return lib


def _check(fn, name, t, device, dtype, shape=None):
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, the input on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{fn}: {name} is {t.dtype}, expected {dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{fn}: {name} must be contiguous and 16-byte aligned")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _raise(lib, err, what):
    if err:
        raise RuntimeError(f"swin_kernel launch failed: {lib.swin_error_string(err).decode()} ({what})")


def _counted(fn):
    with _COUNT_LOCK:
        LAUNCHES[fn] += 1


def window_attn(qkv: torch.Tensor, bias: torch.Tensor, packed: Optional[torch.Tensor], heads: int,
                window: int, shift: int) -> torch.Tensor:
    """K8: :func:`window_attn_plain`'s function. On the CPU the plain
    version (on ``bias``); on a card the kernel, on ``packed``
    (:func:`pack_bias` of ``bias``), with bfloat16 ``qkv`` of a window 8
    map of width 240 in 8 heads. The kernel reads each window's q, k and v
    of four heads at the rolled coordinates, adds the bias and finds the
    shift mask from the region labels itself, and writes the output at the
    pixels it read."""
    if qkv.device.type == "cpu":
        return window_attn_plain(qkv, bias, heads, window, shift)
    fn = "window_attn"
    if qkv.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {qkv.device}")
    if qkv.dim() != 4 or qkv.shape[-1] % 3:
        raise ValueError(f"{fn}: expected [B, Hp, Wp, 3C], got {tuple(qkv.shape)}")
    B, H, W, c3 = qkv.shape
    c = c3 // 3
    err = attn_error(heads, c // heads, window)
    if err or c % heads:
        raise ValueError(f"{fn}: {err or f'width {c} is not a multiple of {heads} heads'}")
    if H % window or W % window or not 0 <= shift < window:
        raise ValueError(f"{fn}: map {H} x {W} is not in whole windows of {window}, or shift {shift}")
    _check(fn, "qkv", qkv, qkv.device, torch.bfloat16)
    _check(fn, "packed bias", packed, qkv.device, torch.bfloat16, (heads * 4 * 32 * 32,))
    out = torch.empty((B, H, W, c), dtype=torch.bfloat16, device=qkv.device)
    lib = _library()
    with torch.cuda.device(qkv.device):
        err = lib.window_attn_launch(qkv.data_ptr(), packed.data_ptr(), out.data_ptr(), B, H, W, c, heads, shift,
                                     torch.cuda.current_stream(qkv.device).cuda_stream)
    _raise(lib, err, f"{fn}, B={B}, {H} x {W}, C={c}, heads={heads}, shift={shift}")
    _counted(fn)
    return out


def swin_norm(x: torch.Tensor, branch: Optional[torch.Tensor], weight: Optional[torch.Tensor],
              bias: Optional[torch.Tensor], pre: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              write_res: bool = True) -> tuple:
    """K9: :func:`swin_norm_plain`'s function with a bfloat16 output. On
    the CPU the plain version; on a card the kernel, on a float32 ``x``
    ``[N, 240]``, a bfloat16 ``branch`` of its shape or None, float32
    LayerNorm weights: one warp a token, 8 channels a lane, one read of
    ``x`` and ``branch`` and one write of each output."""
    if x.device.type == "cpu":
        return swin_norm_plain(x, branch, weight, bias, pre, write_res)
    fn = "swin_norm"
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if x.dim() != 2 or x.shape[1] not in NORM_WIDTHS:
        raise ValueError(f"{fn}: expected [N, C] with C in {NORM_WIDTHS}, got {tuple(x.shape)}")
    n, c = x.shape
    _check(fn, "x", x, x.device, torch.float32)
    if branch is not None:
        _check(fn, "branch", branch, x.device, torch.bfloat16, x.shape)
    params = [pre[0], pre[1]] if pre is not None else [None, None]
    params += [weight, bias]
    for name, t in zip(("pre weight", "pre bias", "weight", "bias"), params):
        if t is not None:
            _check(fn, name, t, x.device, torch.float32, (c,))
    res = torch.empty_like(x) if write_res else None
    out = torch.empty((n, c), dtype=torch.bfloat16, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.swin_norm_launch(ptr(x), ptr(branch), *(ptr(t) for t in params), ptr(res), ptr(out), n, c,
                                   LN_EPS, torch.cuda.current_stream(x.device).cuda_stream)
    _raise(lib, err, f"{fn}, N={n}, C={c}")
    _counted(fn)
    return res, out

