"""The reference's image path around the network, after realsr-ncnn-vulkan
(src/realsr.cpp): the u8 image x (1/255); reflect-101 padding by the halo
(OpenCV BORDER_REFLECT_101: mirrored without repeating the edge); a grid of
``tilesize`` tiles, each run with its halo on all sides; the halo cropped
from each output; ``clamp(floor(v * 255 + 0.5))``; the alpha channel of each
tile resized x scale by ncnn's bicubic (A = -0.75, half-pixel centres,
border taps clamped) and rounded by ``floor(v + 0.5)``.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.rrdbnet import forward


def reflect101(n: int, lo: int, hi: int) -> np.ndarray:
    """Source index of each position of an axis of ``n`` padded by lo / hi."""
    idx = np.arange(-lo, n + hi)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.abs(idx) % period
    return np.where(idx > n - 1, period - idx, idx)


def tiles(w: int, h: int, tilesize: int) -> list:
    """The grid's tiles as (x0, y0, w, h), row by row; the last row and
    column take what is left."""
    return [
        (x0, y0, min(tilesize, w - x0), min(tilesize, h - y0))
        for y0 in range(0, h, tilesize)
        for x0 in range(0, w, tilesize)
    ]


def padded_px(w: int, h: int, tilesize: int, pad: int) -> int:
    """Pixels the network runs on for one image: each tile with its halo."""
    return sum((tw + 2 * pad) * (th + 2 * pad) for _, _, tw, th in tiles(w, h, tilesize))


def cubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] float32 weights of ncnn's bicubic resize of one axis."""
    a = -0.75
    src = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    base = np.floor(src)
    m = np.zeros((n_out, n_in))
    for tap in range(-1, 3):
        d = np.abs(src - (base + tap))
        wgt = np.where(d <= 1, ((a + 2) * d - (a + 3)) * d * d + 1, ((a * d - 5 * a) * d + 8 * a) * d - 4 * a)
        np.add.at(m, (np.arange(n_out), np.clip(base + tap, 0, n_in - 1).astype(np.int64)), wgt)
    return m.astype(np.float32)


def upscale(img: np.ndarray, layers: list, num_rrdb: int, num_upsample: int, tilesize: int, pad: int,
            device, quant=None, block: int = 8) -> np.ndarray:
    """u8 [h, w, 3 | 4] -> u8 [h * s, w * s, same], tiles run ``block`` at a
    time."""
    s = 2**num_upsample
    h, w, c = img.shape
    color = torch.from_numpy(np.array(img[..., :3])).to(device).float() * (1.0 / 255.0)
    yi = torch.from_numpy(reflect101(h, pad, pad)).to(device)
    xi = torch.from_numpy(reflect101(w, pad, pad)).to(device)
    padded = color[yi][:, xi]
    out = np.zeros((h * s, w * s, c), dtype=np.uint8)
    groups: dict = {}
    for t in tiles(w, h, tilesize):
        groups.setdefault(t[2:], []).append(t)
    with torch.no_grad():
        for (tw, th), ts in groups.items():
            for k in range(0, len(ts), block):
                blk = ts[k : k + block]
                x = torch.stack([padded[y0 : y0 + th + 2 * pad, x0 : x0 + tw + 2 * pad] for x0, y0, _, _ in blk])
                y = forward(x.permute(0, 3, 1, 2).contiguous(), layers, num_rrdb, num_upsample, quant)
                y = y[:, :, pad * s : (pad + th) * s, pad * s : (pad + tw) * s]
                u8 = torch.floor(y * 255.0 + 0.5).clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()
                for (x0, y0, _, _), t in zip(blk, u8):
                    out[y0 * s : (y0 + th) * s, x0 * s : (x0 + tw) * s, :3] = t
    if c == 4:
        for x0, y0, tw, th in tiles(w, h, tilesize):
            a = img[y0 : y0 + th, x0 : x0 + tw, 3].astype(np.float32)
            up = cubic_matrix(th, th * s) @ a @ cubic_matrix(tw, tw * s).T
            out[y0 * s : (y0 + th) * s, x0 * s : (x0 + tw) * s, 3] = np.clip(np.floor(up + 0.5), 0, 255)
    return out
