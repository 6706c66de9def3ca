"""K10's share of its roofline: the least time of the Swin layers' MLPs
over the Swin tokens of the images completed in the window (each tile with
its halo, padded to whole windows), over the device time of the kernels
that run them, named by ``PATTERNS``. Per token, from the configuration's
own fields: ``sum(depths)`` layers of fc1 and fc2, ``2 x embed_dim x
embed_dim x mlp_ratio`` MACs each, two operations a MAC; bytes: each
layer's input read and output written once in bfloat16 (the hidden stays
on the SM). None where the trace has no such kernel."""

from benchmark.arch.swinir import tokens
from benchmark.roofline import PEAK_FLOPS, least_seconds

PATTERNS = ("swin_mlp",)


def read(records):
    dev = records["device"]
    if dev is None:
        return None
    busy = sum(s for _, name, s in dev["kernels"] if any(p in name for p in PATTERNS))
    if not busy:
        return None
    cfg = records["config"]
    c, layers = cfg["embed_dim"], sum(cfg["depths"])
    n = sum(tokens(cfg, w, h) for w, h in records["done"])
    ops = n * layers * 2 * 2 * c * c * cfg["mlp_ratio"]
    moved = n * layers * 2 * c * 2
    return 100 * least_seconds(ops, moved, PEAK_FLOPS[cfg["peak"]]) / busy
