"""Card milliseconds a chunk: the program's ``chunk.device`` entries (CUDA
timing events on the chunk's card stream, from before its gather to after
its scatter, read once its image has come down; ``REALSR_TPU_TRACE=1``)
summed over the window, over their count. On a busy card this is the
chunk's own device time; where the card waited for the host inside the
chunk, that wait is in it."""


def read(records):
    spans = records["spans"]
    if "chunk.device" not in spans or not spans["chunk.device"][1]:
        return None
    return spans["chunk.device"][0] / spans["chunk.device"][1] * 1e3
