"""The CLI's ``-j`` proc thread count as torch's CPU intra-op thread count.

Counterpart of ``realsr_tpu/utils/cputhreads.py``: the reference gives its
CPU engine ``jobs_proc`` OpenMP threads (src/main.cpp:734-746,
src/realsr.cpp:17). torch has the knob itself (``torch.set_num_threads``),
so no affinity mask is needed; the count is read back to tell whether it
took.
"""

from __future__ import annotations

import sys

import torch


def configure_cpu_threads(n: int, verbose: bool = False) -> bool:
    """Set torch's intra-op pool to ``n`` threads. Returns False where the
    setting did not take (callers then print the notice, so ``-j`` is never
    ignored silently)."""
    if n < 1:
        return False
    torch.set_num_threads(n)
    if torch.get_num_threads() != n:
        return False
    if verbose:
        print(f"cpu intra-op threads: {n}", file=sys.stderr)
    return True


def notice_cpu_threads_ignored() -> None:
    """The user-visible message for a ``-j`` that could not take."""
    print(
        "warning: -j proc thread count does not tune CPU inference in this "
        "session (torch's intra-op pool was already started)",
        file=sys.stderr,
    )
