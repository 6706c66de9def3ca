"""ctypes bindings for the port's native C++ I/O runtime
(``librealsr_io_torch.so``).

The port's own copy of ``realsr_tpu/io/native.py``. It loads the port's own
codec library, built from ``realsr_tpu_torch/native/`` into
``realsr_tpu_torch/native/build/`` (``cmake -S realsr_tpu_torch/native -B
realsr_tpu_torch/native/build && cmake --build realsr_tpu_torch/native/build``);
``REALSR_IO_LIB`` names another file.

The reference's codec layer is native C (stb_image, libwebp, WIC — SURVEY.md
§2.4); this module binds our C++ equivalent (libpng + libjpeg + libwebp). See
``realsr_tpu_torch/native/realsr_io.cpp`` for the exported C ABI.

If the library isn't built, ``available()`` is False and callers use the PIL
backend in codecs.py: the codec layer's documented behaviour, not a device
fallback.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB = None
_TRIED = False


def _lib_path() -> str:
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(pkg, "native", "build", "librealsr_io_torch.so")


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.environ.get("REALSR_IO_LIB", _lib_path())
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.rsio_decode.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.rsio_decode.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.rsio_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.rsio_encode.restype = ctypes.c_int
        lib.rsio_encode.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_char_p,
        ]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def decode(path: str) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    c = ctypes.c_int()
    ptr = lib.rsio_decode(
        path.encode(), ctypes.byref(w), ctypes.byref(h), ctypes.byref(c)
    )
    if not ptr:
        return None
    try:
        n = h.value * w.value * c.value
        arr = np.ctypeslib.as_array(ptr, shape=(n,)).reshape(
            h.value, w.value, c.value
        )
        return arr.copy()
    finally:
        lib.rsio_free(ptr)


def encode(path: str, image: np.ndarray, ext: str) -> bool:
    lib = _load()
    if lib is None:
        return False
    img = np.ascontiguousarray(image, dtype=np.uint8)
    h, w, c = img.shape
    ok = lib.rsio_encode(
        path.encode(),
        w,
        h,
        c,
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ext.encode(),
    )
    return bool(ok)
