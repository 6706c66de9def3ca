"""Share of the tiles the chunks ran that are the images' own: the
program's ``tiles.real`` counter (tiles that are not pad duplicates) over
its ``tiles.run`` (every tile of every chunk batch), counted as each chunk
is dispatched (``REALSR_TPU_TRACE=1``). A bucket of tiles runs as the
program's ``tiling/planner.py::chunk_plan`` splits it: the fewest equal
chunks under the batch cap, in whole rounds of the mesh's cards, padded by
fewer tiles than there are chunks (a bucket of 15 at a cap of 6: 3 chunks
of 5, none padded)."""


def read(records):
    spans = records["spans"]
    if "tiles.run" not in spans or not spans["tiles.run"][1]:
        return None
    return 100 * spans.get("tiles.real", [0.0, 0])[1] / spans["tiles.run"][1]
