"""Host milliseconds to enqueue one image: the program's ``h2d+prep`` span
(upload and padding) and its ``dispatch`` spans (every chunk's gather,
launch or replay, and scatter) summed over the window, over the images. The
card runs behind the host, so this is the host's time, not the card's."""


def read(records):
    spans = records["spans"]
    if "h2d+prep" not in spans or not spans["h2d+prep"][1]:
        return None
    return (spans["h2d+prep"][0] + spans.get("dispatch", [0.0, 0])[0]) / spans["h2d+prep"][1] * 1e3
