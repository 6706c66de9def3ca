"""Parser for the ncnn plaintext ``.param`` graph format.

Grammar (observed in /root/reference/models/models-DF2K/x4.param, and the
format consumed by ncnn ``Net::load_param`` — reference: src/realsr.cpp:75):

- line 1: magic ``7767517``
- line 2: ``<layer_count> <blob_count>``
- each following line::

    <Type> <name> <in_count> <out_count> <in blobs...> <out blobs...> <k=v ...>

  Scalar params use small non-negative integer keys (``0=64``). Array params
  use key ``-23300 - k`` (so ``-23310=1,2.0e-01`` is array param ``10`` with
  one element, ``[0.2]``). A value token is a float if it contains ``.`` or
  ``e``/``E``, otherwise an int.

The port's own copy of ``realsr_tpu/ncnn/param.py``: pure parsing. The
output is a :class:`ParamGraph` of :class:`Layer` records plus blob
producer/consumer indices, which ``graph/rrdb_match.py`` matches.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Union

NCNN_MAGIC = 7767517

ParamValue = Union[int, float, List[int], List[float]]


@dataclasses.dataclass
class Layer:
    """One graph node: ncnn layer line (type, name, blob wiring, params)."""

    type: str
    name: str
    inputs: List[str]
    outputs: List[str]
    params: Dict[int, ParamValue]

    def pi(self, key: int, default: int = 0) -> int:
        """Scalar int param with ncnn default-0 semantics.

        An array where a scalar is declared is a malformed model file, so
        it raises ValueError — the class the engine/CLI load path turns
        into its clean ``load model failed`` diagnostic."""
        v = self.params.get(key, default)
        if isinstance(v, list):
            raise ValueError(f"{self.name}: param {key} is an array")
        return int(v)

    def pf(self, key: int, default: float = 0.0) -> float:
        v = self.params.get(key, default)
        if isinstance(v, list):
            raise ValueError(f"{self.name}: param {key} is an array")
        return float(v)

    def pa(self, key: int, default: Sequence[float] = ()) -> List[float]:
        """Array param (ncnn id ``-23300 - key``), as floats."""
        v = self.params.get(key, list(default))
        if not isinstance(v, list):
            return [float(v)]
        return [float(x) for x in v]


@dataclasses.dataclass
class ParamGraph:
    """A parsed .param file: ordered layers + blob wiring indices."""

    layers: List[Layer]
    blob_count: int
    # blob name -> (layer index that produces it)
    producer: Dict[str, int]
    # blob name -> layer indices that consume it
    consumers: Dict[str, List[int]]

    @property
    def layer_count(self) -> int:
        return len(self.layers)

    def input_blobs(self) -> List[str]:
        return [b for l in self.layers if l.type == "Input" for b in l.outputs]

    def output_blobs(self) -> List[str]:
        """Blobs produced but never consumed (graph outputs)."""
        return [
            b
            for l in self.layers
            for b in l.outputs
            if not self.consumers.get(b)
        ]


def _parse_value(tok: str) -> Union[int, float]:
    if "." in tok or "e" in tok or "E" in tok:
        return float(tok)
    return int(tok)


def _parse_kv(tok: str) -> tuple[int, ParamValue]:
    key_s, _, val_s = tok.partition("=")
    key = int(key_s)
    if key <= -23300:
        # array param: id = -23300 - key; value = "count,v0,v1,..."
        arr_key = -23300 - key
        parts = val_s.split(",")
        count = int(parts[0])
        vals = [_parse_value(p) for p in parts[1 : 1 + count]]
        if len(vals) != count:
            raise ValueError(f"array param {tok!r}: expected {count} values")
        return arr_key, vals  # type: ignore[return-value]
    return key, _parse_value(val_s)


def parse_param(text: str) -> ParamGraph:
    lines = [ln.strip() for ln in text.splitlines()]
    lines = [ln for ln in lines if ln and not ln.startswith("#")]
    if not lines:
        raise ValueError("empty .param file")
    try:
        magic = int(lines[0])
    except ValueError:
        raise ValueError(
            f"not an ncnn .param file: first line {lines[0]!r} is not the "
            f"magic number {NCNN_MAGIC}"
        ) from None
    if magic != NCNN_MAGIC:
        raise ValueError(f"bad ncnn magic {magic} (expected {NCNN_MAGIC})")
    if len(lines) < 2:
        raise ValueError(".param file ends after the magic line")
    counts = lines[1].split()
    if len(counts) != 2:
        raise ValueError(f"bad .param count line {lines[1]!r}")
    try:
        layer_count, blob_count = int(counts[0]), int(counts[1])
    except ValueError:
        raise ValueError(f"bad .param count line {lines[1]!r}") from None

    layers: List[Layer] = []
    producer: Dict[str, int] = {}
    consumers: Dict[str, List[int]] = {}
    for ln in lines[2:]:
        # malformed layer lines (truncated files, stray tokens) must
        # surface as ValueError: the engine/CLI load path catches
        # ValueError for its clean "load model failed" diagnostic
        # (cli.py), matching ncnn's error-return on a bad param file
        toks = ln.split()
        if len(toks) < 4:
            raise ValueError(f"bad .param layer line {ln!r}")
        ltype, name = toks[0], toks[1]
        try:
            nin, nout = int(toks[2]), int(toks[3])
        except ValueError:
            raise ValueError(f"bad .param layer line {ln!r}") from None
        pos = 4
        if nin < 0 or nout < 0 or pos + nin + nout > len(toks):
            raise ValueError(f"bad .param layer line {ln!r}")
        inputs = toks[pos : pos + nin]
        pos += nin
        outputs = toks[pos : pos + nout]
        pos += nout
        params: Dict[int, ParamValue] = {}
        for tok in toks[pos:]:
            try:
                k, v = _parse_kv(tok)
            except (ValueError, IndexError):
                raise ValueError(
                    f"bad .param value {tok!r} in layer line {ln!r}"
                ) from None
            params[k] = v
        idx = len(layers)
        layers.append(Layer(ltype, name, inputs, outputs, params))
        for b in outputs:
            producer[b] = idx
        for b in inputs:
            consumers.setdefault(b, []).append(idx)

    if len(layers) != layer_count:
        raise ValueError(
            f".param declares {layer_count} layers, found {len(layers)}"
        )
    return ParamGraph(layers, blob_count, producer, consumers)


def parse_param_file(path: str) -> ParamGraph:
    with open(path, "r", encoding="utf-8") as f:
        return parse_param(f.read())
