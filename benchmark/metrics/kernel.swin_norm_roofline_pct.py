"""K9's share of its roofline: the least time of the residual adds and
LayerNorms (``arch/swinir.py::describe``: per token the bytes of every
residual, branch and output read or written once over the forward; their
operations, about 10 a value, are not counted) over the Swin tokens of the
images completed in the window (each tile with its halo, padded to whole
windows), over the device time of the kernels that run them, named by
``PATTERNS``. None where the trace has no such kernel."""

from benchmark.arch.swinir import tokens
from benchmark.roofline import least_seconds

PATTERNS = ("swin_norm",)


def read(records):
    dev = records["device"]
    if dev is None:
        return None
    busy = sum(s for _, name, s in dev["kernels"] if any(p in name for p in PATTERNS))
    if not busy:
        return None
    cfg = records["config"]
    n = sum(tokens(cfg, w, h) for w, h in records["done"])
    return 100 * least_seconds(0, n * cfg["swin_norm_bytes_per_token"]) / busy
