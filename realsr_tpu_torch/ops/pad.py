"""Reflect-101 padding with the reference's semantics.

Counterpart of ``realsr_tpu/ops/pad.py``: out-of-range coordinates mirror
without edge duplication (``x = abs(x); x = (w-1) - abs(x - (w-1))``,
OpenCV BORDER_REFLECT_101). Always an index gather: ``F.pad(mode="reflect")``
rejects pad >= dim, which tiny images and edge tiles reach.
"""

from __future__ import annotations

import numpy as np
import torch


def reflect101_indices(n: int, pad_lo: int, pad_hi: int) -> np.ndarray:
    """Source index for each position of a padded axis (host-side, static)."""
    idx = np.arange(-pad_lo, n + pad_hi)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.abs(idx) % period
    return np.where(idx > n - 1, period - idx, idx)


def _index_tensor(n: int, pad: int, device: torch.device) -> torch.Tensor:
    """:func:`reflect101_indices` ``(n, pad, pad)`` as an int64 tensor
    computed on ``device``: the same integers, with no upload, so on a card
    the host does not wait for the kernels already queued (a pageable copy
    synchronizes its stream)."""
    idx = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    idx = idx.abs() % period
    return torch.where(idx > n - 1, period - idx, idx)


def reflect101_pad_w(img: torch.Tensor, pad: int) -> torch.Tensor:
    """Pad only W of ``[..., H, W, C]`` by ``pad`` with reflect-101: a band
    of the image arrives with its vertical context rows already attached
    (real neighbour rows, or the whole image's reflection at its edges), so
    only the horizontal halo is padded here."""
    return img.index_select(img.dim() - 2, _index_tensor(img.shape[-2], pad, img.device))


def reflect101_pad2d(img: torch.Tensor, pad: int) -> torch.Tensor:
    """Pad H and W of ``[..., H, W, C]`` by ``pad`` with reflect-101."""
    yi = _index_tensor(img.shape[-3], pad, img.device)
    xi = _index_tensor(img.shape[-2], pad, img.device)
    return img.index_select(img.dim() - 3, yi).index_select(img.dim() - 2, xi)
