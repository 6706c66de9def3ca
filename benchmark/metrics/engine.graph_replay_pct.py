"""Share of the chunks that ran as a replay of their key's captured CUDA
graph: the program's ``chunks.replayed`` counter over all its chunk
counters (``chunks.replayed``, ``chunks.captured``, ``chunks.eager``),
counted as each chunk runs (``REALSR_TPU_TRACE=1``). A key's first chunk
runs eagerly and its second is captured."""

COUNTERS = ("chunks.replayed", "chunks.captured", "chunks.eager")


def read(records):
    spans = records["spans"]
    chunks = sum(spans[k][1] for k in COUNTERS if k in spans)
    if not chunks:
        return None
    return 100 * spans.get("chunks.replayed", [0.0, 0])[1] / chunks
