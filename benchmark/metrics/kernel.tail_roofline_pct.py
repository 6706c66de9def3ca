"""The tail's share of its roofline: the least time of the last
upsampler's conv, HRconv and conv_last over every tile (with its halo) of
the images completed in the window, at the output's scale, over the device
time of the kernels that run them, named by ``PATTERNS``. None where the
trace has no such kernel."""

from benchmark.reference.tiling import padded_px
from benchmark.roofline import PEAK_FLOPS, least_seconds, tail_work

PATTERNS = ("tail_kernel",)


def read(records):
    dev = records["device"]
    if dev is None:
        return None
    busy = sum(s for _, name, s in dev["kernels"] if any(p in name for p in PATTERNS))
    if not busy:
        return None
    cfg = records["config"]
    px = sum(padded_px(w, h, cfg["tilesize"], cfg["prepadding"]) for w, h in records["done"])
    return 100 * least_seconds(*tail_work(cfg, px), PEAK_FLOPS[cfg["peak"]]) / busy
