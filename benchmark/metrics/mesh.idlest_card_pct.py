"""The largest idle share among the cell's cards over the traced window:
whole chunks are dealt to the cards in turn and merged on the first, so a
card that waits shows here."""


def read(records):
    dev = records["device"]
    if dev is None or not dev["window_s"] or len(dev["busy_s"]) < 2:
        return None
    return 100 * (1 - min(dev["busy_s"].values()) / dev["window_s"])
