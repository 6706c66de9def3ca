"""Image codecs with the reference's channel/format semantics.

Decode (reference load stage, src/main.cpp:232-260): try webp first, then
the general decoder; promote grayscale -> RGB and gray+alpha -> RGBA so the
engine only ever sees 3- or 4-channel uint8.

Encode (reference save stage, src/main.cpp:374-393): webp is LOSSLESS
(webp_image.h:66-76), jpg is quality 100, png default settings.

The port's own copy of ``realsr_tpu/io/codecs.py``. Backends: the native
C++ module (``io/native.py``, libpng/libjpeg/libwebp) when built — matching the reference's native codec layer — with a
PIL fallback so the framework is usable before `make native`.
"""

from __future__ import annotations

import io as _io
from typing import Optional, Tuple

import numpy as np


def _native():
    try:
        from realsr_tpu_torch.io import native

        return native if native.available() else None
    except Exception:
        return None


def decode_image(path: str) -> Optional[np.ndarray]:
    """Decode to uint8 HWC with C in {3, 4}; None on failure (the pipeline
    prints 'decode image ... failed' and continues, src/main.cpp:293-299)."""
    nat = _native()
    if nat is not None:
        img = nat.decode(path)
        if img is not None:
            return img
    try:
        from PIL import Image

        with Image.open(path) as im:
            return pil_to_array(im)
    except Exception:
        return None


def pil_to_array(im) -> np.ndarray:
    from PIL import Image

    if im.mode in ("RGB", "RGBA"):
        pass
    elif im.mode in ("LA", "PA") or (
        im.mode == "P" and "transparency" in im.info
    ):
        im = im.convert("RGBA")
    else:
        im = im.convert("RGB")
    arr = np.asarray(im, dtype=np.uint8)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return arr


def encode_image(path: str, image: np.ndarray, fmt: Optional[str] = None) -> bool:
    """Encode uint8 HWC by extension (or explicit fmt). Returns success."""
    ext = (fmt or path.rsplit(".", 1)[-1]).lower()
    nat = _native()
    if nat is not None and nat.encode(path, image, ext):
        return True
    if ext == "png":
        # strip-parallel SUB/RLE encoder (io.pngz): measured 9.4x the
        # reference's stb encode at 13% smaller files, and it scales the
        # encode of ONE image across cores — PIL (serial zlib level 6)
        # would bind the save stage an order of magnitude below the
        # device rate (BASELINE.md round-5 save-stage table)
        from realsr_tpu_torch.io.pngz import encode_png

        if encode_png(path, image):
            return True
    try:
        from PIL import Image

        im = Image.fromarray(image)
        if ext in ("jpg", "jpeg"):
            if image.shape[2] == 4:  # encoders reject RGBA jpg; load stage
                return False  # should have redirected (main.cpp:279-288)
            im.save(path, format="JPEG", quality=100)
        elif ext == "webp":
            im.save(path, format="WEBP", lossless=True)
        elif ext == "png":
            im.save(path, format="PNG")
        else:
            return False
        return True
    except Exception:
        return False
