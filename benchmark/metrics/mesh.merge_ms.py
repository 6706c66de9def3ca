"""Card milliseconds of a mesh's merge: the program's ``merge.device``
entries (CUDA timing events on the first card's stream around the merge of
the cards' outputs, read once the image has come down;
``REALSR_TPU_TRACE=1``) over their count. The merge's copies wait for each
card's last chunk, so this holds the first card's wait for the slowest
card as well as the copies and maxima."""


def read(records):
    spans = records["spans"]
    if "merge.device" not in spans or not spans["merge.device"][1]:
        return None
    return spans["merge.device"][0] / spans["merge.device"][1] * 1e3
