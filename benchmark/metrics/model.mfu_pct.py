"""The whole step's share of the cards' peak: 2 x the configuration's MACs
per input pixel (summed from its .param) x the input pixels of the images
completed in the window, over the window's seconds x the cards x the peak
of the configuration's operand type (``roofline.PEAK_FLOPS``)."""

from benchmark.roofline import PEAK_FLOPS


def read(records):
    px = sum(w * h for w, h in records["done"])
    if not px:
        return None
    cfg = records["config"]
    flops = 2 * cfg["macs_per_input_px"] * px
    return 100 * flops / (records["window_s"] * records["chips"] * PEAK_FLOPS[cfg["peak"]])
