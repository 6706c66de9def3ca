"""Share of the tiles the chunks ran that are the images' own: the
program's ``tiles.real`` counter (tiles that are not pad duplicates) over
its ``tiles.run`` (every tile of every chunk batch), counted as each chunk
is dispatched (``REALSR_TPU_TRACE=1``). A chunk batch is a power of two, so
a bucket of 6 tiles runs 8."""


def read(records):
    spans = records["spans"]
    if "tiles.run" not in spans or not spans["tiles.run"][1]:
        return None
    return 100 * spans.get("tiles.real", [0.0, 0])[1] / spans["tiles.run"][1]
