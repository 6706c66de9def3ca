"""The benchmark's own reading of an ncnn ``.param`` graph and writer of its
``.bin``, independent of the program under test.

Only what the benchmark needs: each Convolution layer in file order (its
name, output and input channels, kernel, bias flag, and how many input
pixels' worth of positions it runs on, from the nearest-x2 ``Interp``
layers before it), and a tag-0 float32 ``.bin`` in ncnn's layout (per
Convolution in .param order: a 4-byte zero tag, the OIHW weights, the
bias).
"""

from __future__ import annotations

import dataclasses

import numpy as np

NCNN_MAGIC = 7767517


@dataclasses.dataclass(frozen=True)
class Conv:
    name: str
    cout: int
    cin: int
    kh: int
    kw: int
    bias: bool
    # output positions per input pixel of the graph (4 ** upsamplers before it)
    area: int

    @property
    def weights(self) -> int:
        return self.cout * self.cin * self.kh * self.kw

    @property
    def macs_per_input_px(self) -> int:
        return self.weights * self.area


def _params(tokens: list) -> dict:
    out = {}
    for tok in tokens:
        key, _, val = tok.partition("=")
        out[int(key)] = val
    return out


def parse_convs(text: str) -> list:
    """The Convolution layers of a .param text, in file order."""
    lines = [ln.split() for ln in text.splitlines() if ln.strip()]
    if int(lines[0][0]) != NCNN_MAGIC:
        raise ValueError("not an ncnn .param (bad magic)")
    area: dict = {}
    convs = []
    for toks in lines[2:]:
        kind, name, nin, nout = toks[0], toks[1], int(toks[2]), int(toks[3])
        ins, outs = toks[4 : 4 + nin], toks[4 + nin : 4 + nin + nout]
        p = _params(toks[4 + nin + nout :])
        a = max((area.get(b, 1) for b in ins), default=1)
        if kind == "Interp":
            if (p.get(1), p.get(2)) != ("2.0", "2.0"):
                raise ValueError(f"{name}: only x2 Interp layers are counted")
            a *= 4
        elif kind == "Convolution":
            cout, kw = int(p[0]), int(p[1])
            kh = int(p.get(11, kw))
            wsize = int(p[6])
            cin = wsize // (cout * kh * kw)
            convs.append(Conv(name, cout, cin, kh, kw, bool(int(p.get(5, 0))), a))
        for b in outs:
            area[b] = a
    return convs


def macs_per_input_px(convs: list) -> int:
    """Multiply-accumulates of one forward per input pixel of the graph."""
    return sum(c.macs_per_input_px for c in convs)


def write_bin(path: str, convs: list, weights: np.ndarray, biases: np.ndarray) -> None:
    """``weights``: every conv's OIHW weights flat, in order; ``biases``:
    one per output channel of every conv, in order (the file leaves out
    those of a conv without a bias term)."""
    size = sum(1 + c.weights + (c.cout if c.bias else 0) for c in convs)
    out = np.zeros(size, dtype="<f4")  # the zero tag is four zero bytes
    pos = wpos = bpos = 0
    for c in convs:
        pos += 1
        out[pos : pos + c.weights] = weights[wpos : wpos + c.weights]
        pos += c.weights
        wpos += c.weights
        if c.bias:
            out[pos : pos + c.cout] = biases[bpos : bpos + c.cout]
            pos += c.cout
        bpos += c.cout
    out.tofile(path)
