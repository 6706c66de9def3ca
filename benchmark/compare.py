"""What decides ``correct``: the program's u8 outputs against the plain
reference's, by the numbers a cell's ``limits/<workload>.json`` holds to a
limit each (set from the readings ``PERF.md`` gives; a number whose
readings set no limit is left out of the file and not compared):

- ``rmse_u8``: root mean square of the difference over every value of the
  sampled outputs (all channels), in u8 steps;
- ``max_abs_u8``: the widest difference of any value;
- ``off2_ppm``: values that differ by 2 or more, per million values.

An output missing, or of another shape than the reference's, and any
request that failed, make the run not correct.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

NAMES = ("rmse_u8", "max_abs_u8", "off2_ppm")


def load_limits(root: str, workload: str) -> dict:
    with open(os.path.join(root, "limits", f"{workload}.json")) as f:
        return {name: float(v["limit"]) for name, v in json.load(f).items() if name in NAMES}


def gaps(pairs: list) -> dict:
    """{name: number} over [(program's u8, reference's u8)]; None where a
    shape differs or nothing was compared."""
    sq, n, widest, off2 = 0, 0, 0, 0
    for got, want in pairs:
        if got is None or got.shape != want.shape or got.dtype != np.uint8:
            return None
        d = (got.astype(np.int16) - want.astype(np.int16)).ravel()
        sq += int(np.dot(d.astype(np.int64), d))
        n += d.size
        a = np.abs(d)
        widest = max(widest, int(a.max()))
        off2 += int(np.count_nonzero(a >= 2))
    if not n:
        return None
    return {"rmse_u8": math.sqrt(sq / n), "max_abs_u8": float(widest), "off2_ppm": 1e6 * off2 / n}


def judge(numbers, limits: dict, failed: int) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number ``limits`` holds
    within its limit and no request failed."""
    check = {"failed": {"value": failed, "limit": 0}}
    ok = failed == 0 and numbers is not None and bool(limits)
    for name in limits:
        value = None if numbers is None else numbers[name]
        check[name] = {"value": value, "limit": limits[name]}
        ok = ok and value is not None and value <= limits[name]
    return ok, check
