"""Share of the Swin tokens the chunks ran that are the images' own pixels:
the program's ``swin.tokens.own`` counter (the real tiles' own pixels) over
its ``swin.tokens.run`` (every tile of every chunk batch with its halo,
padded to whole windows), both counted as each chunk is dispatched
(``REALSR_TPU_TRACE=1``). At tile 256 and halo 10, a 276 x 276 tile padded
to 280 x 280: 65,536 / 78,400 = 83.6 %."""


def read(records):
    spans = records["spans"]
    if "swin.tokens.run" not in spans or not spans["swin.tokens.run"][1]:
        return None
    return 100 * spans.get("swin.tokens.own", [0.0, 0])[1] / spans["swin.tokens.run"][1]
