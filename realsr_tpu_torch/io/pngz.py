"""Strip-parallel PNG encoder tuned for the save stage.

The port's own copy of ``realsr_tpu/io/pngz.py``; :func:`encode_png` also
returns False on a ``zlib.error`` or ``MemoryError``, which the original
lets escape.

The reference's save stage encodes with stb_image_write
(src/main.cpp:381-393), a serial fixed-strategy zlib measured at 1.8 MP/s
and 32.1 MB for a 16.8 MP 4x output on SR-like content (same-content
A/B 2026-08-19, BASELINE.md round-5 save-stage table) — an order of
magnitude below the device's ~24 MP/s steady state, so at the
reference's encoder the SAVE stage, not the model, binds a directory
run. This encoder closes that gap three ways:

1. **Measured filter/strategy point.** All rows are SUB-filtered
   (vectorized u8 wraparound subtract), then deflated with Z_RLE at
   level 1: 16.9 MP/s and 27.9 MB on the same content — 9.4x faster
   than stb AND 13% smaller, i.e. it dominates the reference's
   size/speed point on both axes. ``REALSR_TPU_PNG_LEVEL=0..9`` opts
   into the default zlib strategy at that level for smaller files
   (level 1: 9.8 MP/s, 23.2 MB; libpng's own default — level 6,
   adaptive filters — measures 1.5 MP/s, slower than stb).

2. **Strip parallelism.** PNG's zlib stream is sequential, but a
   Z_FULL_FLUSH at a strip boundary byte-aligns the stream and resets
   the deflate window, so strips compressed INDEPENDENTLY (each its own
   compressor, non-final strips flushed with Z_FULL_FLUSH, the last
   with Z_FINISH) concatenate into one valid zlib stream — the pigz
   technique. Strips run on a thread pool (Python's zlib releases the
   GIL), scaling the encode of ONE image with cores — something neither
   stb nor libpng offers at any setting.

3. **Zero copies.** Filtering writes one contiguous scanline buffer;
   compressors and the adler32 read numpy row slices through the buffer
   protocol directly.

The output is a plain, universally readable PNG (single IDAT, standard
zlib stream); round-trip tests decode it with PIL and compare
bit-exactly.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
# zlib CMF/FLG header for a 32K window; FCHECK makes (CMF*256+FLG) % 31
# == 0. FLEVEL is advisory only — 0x7801 (fastest) matches the defaults.
_ZHDR = b"\x78\x01"

_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> PNG color type

# ~4 MB of filtered scanlines per strip: large enough that per-strip
# compressor setup and the ~5-byte Z_FULL_FLUSH marker are noise (<0.01%
# size overhead), small enough that a 16.8 MP output splits into enough
# strips to feed a many-core save host.
_STRIP_BYTES = 4 << 20


def _codec_params() -> tuple:
    """(zlib level, zlib strategy) from REALSR_TPU_PNG_LEVEL; default is
    the measured speed point (level 1, Z_RLE)."""
    raw = os.environ.get("REALSR_TPU_PNG_LEVEL", "")
    if raw.isdigit() and 0 <= int(raw) <= 9:
        return int(raw), zlib.Z_DEFAULT_STRATEGY
    return 1, zlib.Z_RLE


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(data, zlib.crc32(tag)) & 0xFFFFFFFF)
    )


def _filter_sub(image: np.ndarray) -> np.ndarray:
    """[H, W, C] uint8 -> filtered scanline stream [H, 1 + W*C] uint8
    (filter byte 1 = SUB per row; uint8 subtraction wraps mod 256 as the
    PNG spec requires)."""
    h, w, c = image.shape
    flat = image.reshape(h, w * c)
    out = np.empty((h, 1 + w * c), np.uint8)
    out[:, 0] = 1  # SUB
    out[:, 1 : 1 + c] = flat[:, :c]
    # write the wrapped difference straight into the output slice — the
    # temp-array form (`a - b` then copy) doubles the memory traffic of
    # the encoder's second-hottest stage
    np.subtract(flat[:, c:], flat[:, :-c], out=out[:, 1 + c :])
    return out


def encode_png_bytes(
    image: np.ndarray, level: Optional[int] = None, threads: int = 0
) -> bytes:
    """uint8 [H, W] or [H, W, C] (C in 1..4) -> PNG file bytes.

    ``level``: explicit zlib level 0-9 with the default strategy; None =
    the env-configurable default (see _codec_params)."""
    if image.dtype != np.uint8:
        raise ValueError("pngz encodes uint8 images")
    if image.ndim == 2:
        image = image[:, :, None]
    if image.ndim != 3 or image.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"unsupported image shape {image.shape}")
    h, w, c = image.shape
    if h == 0 or w == 0:
        raise ValueError(f"unsupported image shape {image.shape}")
    if level is None:
        level, strategy = _codec_params()
    else:
        strategy = zlib.Z_DEFAULT_STRATEGY

    filtered = _filter_sub(np.ascontiguousarray(image))
    row_bytes = filtered.shape[1]
    rows_per_strip = max(1, _STRIP_BYTES // row_bytes)
    bounds = list(range(0, h, rows_per_strip)) + [h]
    n = len(bounds) - 1

    def deflate(idx: int) -> bytes:
        co = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy)
        body = co.compress(filtered[bounds[idx] : bounds[idx + 1]])
        last = idx == n - 1
        return body + co.flush(zlib.Z_FINISH if last else zlib.Z_FULL_FLUSH)

    threads = threads or min(n, os.cpu_count() or 1)
    if threads > 1 and n > 1:
        import concurrent.futures as cf

        with cf.ThreadPoolExecutor(max_workers=threads) as ex:
            parts = list(ex.map(deflate, range(n)))
    else:
        parts = [deflate(i) for i in range(n)]

    # zlib.adler32 runs at memory speed in C over the buffer protocol —
    # sequential over the full filtered buffer is ~ms
    adler = zlib.adler32(filtered) & 0xFFFFFFFF
    idat = _ZHDR + b"".join(parts) + struct.pack(">I", adler)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (
        _SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", idat)
        + _chunk(b"IEND", b"")
    )


def encode_png(
    path: str, image: np.ndarray, level: Optional[int] = None,
    threads: int = 0,
) -> bool:
    """Encode to ``path``; returns success (the save stage's contract —
    failures print-and-continue, src/main.cpp:405-412)."""
    try:
        data = encode_png_bytes(image, level=level, threads=threads)
        with open(path, "wb") as f:
            f.write(data)
        return True
    except (OSError, ValueError, zlib.error, MemoryError):
        # a zlib or memory failure is one image's failure too: the save
        # worker prints it and goes on with the next image
        return False
