"""Filesystem helpers mirroring the reference's filesystem_utils.h.

The port's own copy of ``realsr_tpu/utils/fsutils.py``. Only the POSIX
halves are needed (the hosts are Linux): sorted directory
listing (filesystem_utils.h:72-96), extension helpers (:99-115), and model
path sanitization with an install-root fallback (:167-173, where the
reference falls back to the executable's directory).
"""

from __future__ import annotations

import os
from typing import List


def path_is_directory(path: str) -> bool:
    return os.path.isdir(path)


def list_directory(path: str) -> List[str]:
    """Sorted regular-file names (filesystem_utils.h:72-96 sorts too)."""
    names = [
        n
        for n in os.listdir(path)
        if os.path.isfile(os.path.join(path, n))
    ]
    return sorted(names)


def get_file_extension(path: str) -> str:
    base = os.path.basename(path)
    dot = base.rfind(".")
    return base[dot + 1 :] if dot >= 0 else ""


def get_file_name_without_extension(path: str) -> str:
    base = os.path.basename(path)
    dot = base.rfind(".")
    return base[:dot] if dot >= 0 else base


def install_root() -> str:
    """The framework's install root (analog of the exe dir)."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sanitize_filepath(path: str) -> str:
    """Return ``path`` if it exists, else try it relative to the install
    root (filesystem_utils.h:167-173 semantics)."""
    if os.path.exists(path):
        return path
    alt = os.path.join(os.path.dirname(install_root()), path)
    if os.path.exists(alt):
        return alt
    return path
