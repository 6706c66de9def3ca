"""K8's share of its roofline: the least time of the window attention
(``arch/swinir.py::describe``: per token q k^T and . v of every Swin layer,
q, k and v read and the output written once) over the Swin tokens of the
images completed in the window (each tile with its halo, padded to whole
windows), over the device time of the kernels that run it, named by
``PATTERNS``. None where the trace has no such kernel."""

from benchmark.arch.swinir import tokens
from benchmark.roofline import PEAK_FLOPS, least_seconds

PATTERNS = ("window_attn",)


def read(records):
    dev = records["device"]
    if dev is None:
        return None
    busy = sum(s for _, name, s in dev["kernels"] if any(p in name for p in PATTERNS))
    if not busy:
        return None
    cfg = records["config"]
    n = sum(tokens(cfg, w, h) for w, h in records["done"])
    least = least_seconds(n * cfg["window_attn_flops_per_token"], n * cfg["window_attn_bytes_per_token"],
                          PEAK_FLOPS[cfg["peak"]])
    return 100 * least / busy
