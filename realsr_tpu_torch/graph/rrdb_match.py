"""Structural matcher: recognize the RRDBNet idiom in a parsed ncnn graph.

Counterpart of ``realsr_tpu/graph/rrdb_match.py`` with this package's spec
and OIHW weights (what ``realsr_tpu_torch.ncnn.bin.load_weights`` returns, and
torch's own layout), so it imports no JAX.

ncnn serializes the network as 999 layers (models/models-DF2K/x4.param:2)
because every fan-out is an explicit ``Split`` and every dense connection an
explicit ``Concat``. This module de-aliases the Splits and walks the layer
stream with a small state machine, verifying the exact RRDB structure
(documented in SURVEY.md §2.8) and collecting which Convolution plays which
role. On success the weights are stacked for
:mod:`realsr_tpu_torch.models.rrdbnet`; on a mismatch the loader raises,
because the generic executor is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from realsr_tpu_torch.models.rrdbnet import LRELU_SLOPE, RESIDUAL_SCALE, RRDBNetSpec
from realsr_tpu_torch.ncnn.param import Layer, ParamGraph


@dataclasses.dataclass
class RRDBNetMatch:
    spec: RRDBNetSpec
    conv_first: str
    # rdb_convs[block][rdb][conv_idx] -> layer name
    rdb_convs: List[List[List[str]]]
    trunk: str
    up_convs: List[str]
    hr: str
    last: str


def _dealias(graph: ParamGraph) -> Dict[str, str]:
    """Map every blob to its Split-transparent canonical producer blob."""
    alias: Dict[str, str] = {}

    def resolve(b: str) -> str:
        while b in alias:
            b = alias[b]
        return b

    for layer in graph.layers:
        if layer.type == "Split":
            src = resolve(layer.inputs[0])
            for out in layer.outputs:
                alias[out] = src
    return {b: _resolve(alias, b) for b in list(alias)}


def _resolve(alias: Dict[str, str], b: str) -> str:
    while b in alias:
        b = alias[b]
    return b


class _Stream:
    """Cursor over non-Split layers with blob de-aliasing."""

    def __init__(self, graph: ParamGraph):
        self.alias = _dealias(graph)
        self.layers = [l for l in graph.layers if l.type != "Split"]
        self.pos = 0

    def r(self, blob: str) -> str:
        return self.alias.get(blob, blob)

    def peek(self, off: int = 0) -> Optional[Layer]:
        i = self.pos + off
        return self.layers[i] if i < len(self.layers) else None

    def next(self) -> Layer:
        l = self.layers[self.pos]
        self.pos += 1
        return l


def _is_conv3x3(l: Layer, act: int) -> bool:
    return (
        l.type == "Convolution"
        and l.pi(1) == 3
        and l.pi(11, 3) == 3
        and l.pi(3, 1) == 1
        and l.pi(4) == 1
        and l.pi(2, 1) == 1
        and l.pi(5) == 1
        and l.pi(9) == act
        and (act != 2 or abs(l.pa(10, [0.0])[0] - LRELU_SLOPE) < 1e-6)
    )


def _is_scaled_residual(l: Layer) -> bool:
    """Eltwise SUM with coeffs [0.2, 1.0] (x4.param e.g. line ``Add_16``)."""
    if l.type != "Eltwise" or l.pi(0) != 1 or len(l.inputs) != 2:
        return False
    coeffs = l.pa(1, [])
    return (
        len(coeffs) == 2
        and abs(coeffs[0] - RESIDUAL_SCALE) < 1e-6
        and abs(coeffs[1] - 1.0) < 1e-6
    )


def _match_rdb(s: _Stream, t_blob: str, nf: int, gc: int) -> Optional[tuple]:
    """Match one residual dense block starting at the cursor.

    Returns (conv names [5], out_blob) or None (cursor restored).
    """
    start = s.pos
    names: List[str] = []
    produced: List[str] = [s.r(t_blob)]  # t, c1, c2, c3, c4

    def fail():
        s.pos = start
        return None

    for ci in range(5):
        if ci == 0:
            conv = s.peek()
            if conv is None or not _is_conv3x3(conv, act=2) or conv.pi(0) != gc:
                return fail()
            if s.r(conv.inputs[0]) != produced[0]:
                return fail()
            s.next()
        else:
            cat = s.peek()
            conv = s.peek(1)
            if cat is None or conv is None or cat.type != "Concat" or cat.pi(0) != 0:
                return fail()
            if [s.r(b) for b in cat.inputs] != produced:
                return fail()
            want_act = 2 if ci < 4 else 0
            want_out = gc if ci < 4 else nf
            if not _is_conv3x3(conv, act=want_act) or conv.pi(0) != want_out:
                return fail()
            if s.r(conv.inputs[0]) != s.r(cat.outputs[0]):
                return fail()
            s.next()
            s.next()
        names.append(conv.name)
        produced.append(s.r(conv.outputs[0]))

    res = s.peek()
    if res is None or not _is_scaled_residual(res):
        return fail()
    ins = [s.r(b) for b in res.inputs]
    if ins != [produced[5], produced[0]]:  # [c5, t]
        return fail()
    s.next()
    return names, s.r(res.outputs[0])


def match_rrdbnet(graph: ParamGraph) -> Optional[RRDBNetMatch]:
    """Try to recognize the whole graph as an RRDBNet. None on mismatch."""
    try:
        return _match_rrdbnet(graph)
    except (IndexError, KeyError):
        return None


def _match_rrdbnet(graph: ParamGraph) -> Optional[RRDBNetMatch]:
    s = _Stream(graph)

    inp = s.peek()
    if inp is None or inp.type != "Input":
        return None
    s.next()
    data_blob = s.r(inp.outputs[0])

    first = s.peek()
    if first is None or not _is_conv3x3(first, act=0):
        return None
    if s.r(first.inputs[0]) != data_blob:
        return None
    nf = first.pi(0)
    s.next()
    fea_blob = s.r(first.outputs[0])

    # Infer gc from the first RDB conv.
    nxt = s.peek()
    if nxt is None or nxt.type != "Convolution":
        return None
    gc = nxt.pi(0)
    if gc <= 0 or gc >= nf:
        return None

    rdb_convs: List[List[List[str]]] = []
    t_blob = fea_blob
    while True:
        # Try to match one RRDB: 3 RDBs + scaled residual against its input.
        start = s.pos
        u_blob = t_blob
        block: List[List[str]] = []
        cur = t_blob
        ok = True
        for _ in range(3):
            m = _match_rdb(s, cur, nf, gc)
            if m is None:
                ok = False
                break
            names, cur = m
            block.append(names)
        if ok:
            res = s.peek()
            if (
                res is not None
                and _is_scaled_residual(res)
                and [s.r(b) for b in res.inputs] == [cur, u_blob]
            ):
                s.next()
                rdb_convs.append(block)
                t_blob = s.r(res.outputs[0])
                continue
        s.pos = start
        break

    if not rdb_convs:
        return None
    num_rrdb = len(rdb_convs)

    trunk = s.peek()
    if trunk is None or not _is_conv3x3(trunk, act=0) or trunk.pi(0) != nf:
        return None
    if s.r(trunk.inputs[0]) != t_blob:
        return None
    s.next()

    skip = s.peek()
    if skip is None or skip.type != "BinaryOp" or skip.pi(0) != 0:
        return None
    if set(s.r(b) for b in skip.inputs) != {fea_blob, s.r(trunk.outputs[0])}:
        return None
    s.next()
    cur = s.r(skip.outputs[0])

    up_convs: List[str] = []
    while True:
        interp = s.peek()
        if interp is None or interp.type != "Interp":
            break
        if interp.pi(0) != 1 or interp.pf(1) != 2.0 or interp.pf(2) != 2.0:
            return None
        conv = s.peek(1)
        if conv is None or not _is_conv3x3(conv, act=2) or conv.pi(0) != nf:
            return None
        if s.r(interp.inputs[0]) != cur or s.r(conv.inputs[0]) != s.r(
            interp.outputs[0]
        ):
            return None
        s.next()
        s.next()
        up_convs.append(conv.name)
        cur = s.r(conv.outputs[0])
    if not up_convs:
        return None

    hr = s.peek()
    if hr is None or not _is_conv3x3(hr, act=2) or hr.pi(0) != nf:
        return None
    if s.r(hr.inputs[0]) != cur:
        return None
    s.next()

    last = s.peek()
    if last is None or not _is_conv3x3(last, act=0):
        return None
    if s.r(last.inputs[0]) != s.r(hr.outputs[0]):
        return None
    out_ch = last.pi(0)
    s.next()

    if s.peek() is not None:  # trailing unmatched layers -> not pure RRDBNet
        return None

    # Graph output must be the last conv's blob.
    outs = graph.output_blobs()
    if len(outs) != 1 or s.r(outs[0]) != s.r(last.outputs[0]):
        return None

    # in_ch from conv_first weight size: wsize = out*in*9
    in_ch = first.pi(6) // (nf * 9)

    spec = RRDBNetSpec(
        num_rrdb=num_rrdb,
        num_rdb_per_rrdb=3,
        nf=nf,
        gc=gc,
        in_ch=in_ch,
        out_ch=out_ch,
        num_upsample=len(up_convs),
    )
    return RRDBNetMatch(
        spec=spec,
        conv_first=first.name,
        rdb_convs=rdb_convs,
        trunk=trunk.name,
        up_convs=up_convs,
        hr=hr.name,
        last=last.name,
    )


def extract_stacked_params(
    match: RRDBNetMatch, weights: Dict[str, Dict[str, np.ndarray]]
) -> Dict[str, Any]:
    """Assemble the stacked OIHW parameter tree for rrdbnet_forward.

    ``weights`` is :func:`realsr_tpu_torch.ncnn.bin.load_weights`' OIHW dict.
    """

    def wb(name: str):
        rec = weights[name]
        return rec["weight"], rec["bias"]

    rdb: Dict[str, np.ndarray] = {}
    for ci in range(5):
        ws = np.stack(
            [
                np.stack([wb(blk[r][ci])[0] for r in range(3)])
                for blk in match.rdb_convs
            ]
        )
        bs = np.stack(
            [
                np.stack([wb(blk[r][ci])[1] for r in range(3)])
                for blk in match.rdb_convs
            ]
        )
        rdb[f"w{ci + 1}"] = ws
        rdb[f"b{ci + 1}"] = bs

    upw = np.stack([wb(n)[0] for n in match.up_convs])
    upb = np.stack([wb(n)[1] for n in match.up_convs])

    fw, fb = wb(match.conv_first)
    tw, tb = wb(match.trunk)
    hw, hb = wb(match.hr)
    lw, lb = wb(match.last)
    return {
        "conv_first": {"w": fw, "b": fb},
        "rdb": rdb,
        "trunk": {"w": tw, "b": tb},
        "up": {"w": upw, "b": upb},
        "hr": {"w": hw, "b": hb},
        "last": {"w": lw, "b": lb},
    }
