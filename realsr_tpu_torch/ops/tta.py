"""8-way dihedral (D4) test-time-augmentation transforms on NHWC tensors.

Counterpart of ``realsr_tpu/ops/tta.py``. The reference's TTA mode runs the
net on all 8 symmetries of each tile and averages the inverse-transformed
outputs x 0.125 (src/realsr_preproc_tta.comp, src/realsr_postproc_tta.comp).

Transform table ((i, j) = (row, col) of the input):
  0: identity          4: transpose          out[j, i]
  1: vertical flip     5: transpose + vflip  out[w-1-j, i]
  2: horizontal flip   6: transpose + hflip  out[j, h-1-i]
  3: rotate 180        7: anti-transpose     out[w-1-j, h-1-i]

Transforms 0-3 keep (h, w); 4-7 swap them.
"""

from __future__ import annotations

import torch

NUM_TRANSFORMS = 8


def d4_transform(x: torch.Tensor, k: int) -> torch.Tensor:
    """D4 transform ``k`` of an NHWC batch (spatial dims 1, 2)."""
    if not 0 <= k < NUM_TRANSFORMS:
        raise ValueError(f"bad D4 index {k}")
    if k >= 4:
        x = x.transpose(1, 2)
    dims = [(), (1,), (2,), (1, 2)][k % 4]
    return torch.flip(x, dims) if dims else x


# Each element's inverse: flips are involutions; 5 and 6 are the two
# rotations of order 4, each the other's inverse.
_INVERSE = [0, 1, 2, 3, 4, 6, 5, 7]


def d4_inverse(y: torch.Tensor, k: int) -> torch.Tensor:
    """Undo ``d4_transform(_, k)`` on an NHWC batch."""
    return d4_transform(y, _INVERSE[k])
