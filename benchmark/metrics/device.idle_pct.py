"""Share of the traced window in which no kernel, copy or memset runs on a
card, the mean over the cell's cards (``devtrace.py``)."""


def read(records):
    dev = records["device"]
    if dev is None or not dev["window_s"]:
        return None
    busy = dev["busy_s"]
    return 100 * (1 - sum(busy.values()) / len(busy) / dev["window_s"])
