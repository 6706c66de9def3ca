"""The whole step's share of the cards' peak in a SwinIR cell: the reader
of ``model.mfu_pct`` itself, run on the SwinIR configuration, whose
``describe`` (``arch/swinir.py::macs_per_input_px``: every Swin layer, the
bodies' and the tail's convs) gives the MACs per input pixel it reads.
Reported under a name of its own because the accepted ``model.mfu_pct``
lists the cells it is read in."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "benchmark_metrics_model.mfu_pct", os.path.join(os.path.dirname(os.path.abspath(__file__)), "model.mfu_pct.py"))
_mfu = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mfu)
read = _mfu.read
