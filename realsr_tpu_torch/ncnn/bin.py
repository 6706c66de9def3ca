"""Reader/writer for ncnn ``.bin`` weight files (the port's own copy of
``realsr_tpu/ncnn/bin.py``).

Layout (the format consumed by ncnn ``Net::load_model`` — reference:
src/realsr.cpp:76): weights appear in .param layer order, one record per
weight-bearing layer. For ``Convolution`` (the only weighted type in the
RealSR graphs, models/models-DF2K/x4.param):

- ``weight_data``: a 4-byte type tag, then the payload:
    * tag ``0``          -> raw float32, ``weight_data_size`` elements
    * tag ``0x0002C056`` -> raw float32 (explicit-fp32 tag)
    * tag ``0x01306B47`` -> float16, padded to 4-byte alignment
    * any other non-zero -> 8-bit quantized: 256 float32 dequant table,
      then ``weight_data_size`` uint8 indices padded to 4-byte alignment
- ``bias_data``: raw float32, ``num_output`` elements, no tag.

Weight element order is OIHW: ``[num_output][num_input][kh][kw]``.

The writer emits tag-0 fp32 records; it exists because this snapshot of the
reference ships no ``x4.bin`` (/root/reference/.MISSING_LARGE_BLOBS), so
tests and benchmarks synthesize weight files in the real format.
"""

from __future__ import annotations

import struct
from typing import Dict, List

import numpy as np

from realsr_tpu_torch.ncnn.param import ParamGraph

TAG_FP32 = 0x0002C056
TAG_FP16 = 0x01306B47
TAG_INT8 = 0x000D4B38


class _Cursor:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(
                f".bin truncated: need {n} bytes at offset {self.pos}, "
                f"have {len(self.data) - self.pos}"
            )
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def align(self, n: int) -> None:
        rem = self.pos % n
        if rem:
            self.pos += n - rem


def _read_tagged(cur: _Cursor, count: int) -> np.ndarray:
    (tag,) = struct.unpack("<I", cur.take(4))
    if tag == 0 or tag == TAG_FP32:
        return np.frombuffer(cur.take(4 * count), dtype="<f4").astype(np.float32)
    if tag == TAG_FP16:
        raw = np.frombuffer(cur.take(2 * count), dtype="<f2").astype(np.float32)
        cur.align(4)
        return raw
    if tag == TAG_INT8:
        raise NotImplementedError("int8 ncnn weights are not supported")
    # 8-bit quantized with a 256-entry dequantization table
    table = np.frombuffer(cur.take(4 * 256), dtype="<f4")
    idx = np.frombuffer(cur.take(count), dtype=np.uint8)
    cur.align(4)
    return table[idx].astype(np.float32)


def _read_raw_f32(cur: _Cursor, count: int) -> np.ndarray:
    return np.frombuffer(cur.take(4 * count), dtype="<f4").astype(np.float32)


def load_weights(graph: ParamGraph, path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Read a .bin against its parsed graph.

    Returns ``{layer_name: {"weight": OIHW f32 array, "bias": [O] f32}}``
    for every Convolution layer (and ConvolutionDepthWise, same record
    shape), in file order.
    """
    with open(path, "rb") as f:
        cur = _Cursor(f.read())

    out: Dict[str, Dict[str, np.ndarray]] = {}
    for layer in graph.layers:
        if layer.type == "InnerProduct":
            # params: 0=num_output, 1=bias_term, 2=weight_data_size;
            # record layout identical to Convolution (tagged weights, raw
            # f32 bias)
            num_output = layer.pi(0)
            wsize = layer.pi(2)
            if num_output < 1 or wsize < 1 or wsize % num_output:
                raise ValueError(
                    f"{layer.name}: bad InnerProduct dims "
                    f"(num_output={num_output}, weight_data_size={wsize})"
                )
            w = _read_tagged(cur, wsize).reshape(num_output, wsize // num_output)
            rec = {"weight": w}
            if layer.pi(1):
                rec["bias"] = _read_raw_f32(cur, num_output)
            out[layer.name] = rec
            continue
        if layer.type == "PReLU":
            # params: 0=num_slope, ncnn load_param DEFAULT 0 (reads no
            # data); record = raw f32 slopes, no tag (ncnn loads
            # slope_data with load(num_slope, 1))
            n = layer.pi(0, 0)
            if n < 1:
                raise ValueError(
                    f"{layer.name}: PReLU num_slope={n}; a loadable graph "
                    "must declare 0=<num_slope> >= 1"
                )
            out[layer.name] = {"slope": _read_raw_f32(cur, n)}
            continue
        if layer.type not in ("Convolution", "ConvolutionDepthWise"):
            continue
        num_output = layer.pi(0)
        kw = layer.pi(1)
        kh = layer.pi(11, kw)
        bias_term = layer.pi(5)
        wsize = layer.pi(6)
        # a graph that parses can still declare impossible conv dims (zero
        # channels, sizes that don't factor); that is a malformed model
        # file, not a programming error — report it as ValueError so the
        # load path's clean diagnostic fires instead of ZeroDivisionError
        if (
            num_output < 1
            or kw < 1
            or kh < 1
            or wsize < 1
            or wsize % (num_output * kh * kw)
        ):
            raise ValueError(
                f"{layer.name}: bad Convolution dims (num_output="
                f"{num_output}, kernel={kw}x{kh}, weight_data_size={wsize})"
            )
        w = _read_tagged(cur, wsize)
        cin = wsize // (num_output * kh * kw)
        if layer.type == "ConvolutionDepthWise":
            group = layer.pi(7, 1)
            if group < 1 or num_output % group:
                raise ValueError(
                    f"{layer.name}: bad group={group} for "
                    f"num_output={num_output}"
                )
            w = w.reshape(group, num_output // group, cin, kh, kw)
        else:
            w = w.reshape(num_output, cin, kh, kw)
        rec = {"weight": w}
        if bias_term:
            rec["bias"] = _read_raw_f32(cur, num_output)
        out[layer.name] = rec
    return out


def write_weights(
    graph: ParamGraph, weights: Dict[str, Dict[str, np.ndarray]], path: str
) -> None:
    """Write a tag-0 fp32 .bin matching the given graph's layer order."""
    chunks: List[bytes] = []
    for layer in graph.layers:
        if layer.type == "InnerProduct":
            rec = weights[layer.name]
            w = np.asarray(rec["weight"], dtype="<f4")
            if int(w.size) != layer.pi(2):
                raise ValueError(
                    f"{layer.name}: weight has {w.size} elements, "
                    f".param declares {layer.pi(2)}"
                )
            chunks.append(struct.pack("<I", 0))
            chunks.append(w.tobytes())
            if layer.pi(1):
                chunks.append(np.asarray(rec["bias"], dtype="<f4").tobytes())
            continue
        if layer.type == "PReLU":
            s = np.asarray(weights[layer.name]["slope"], dtype="<f4")
            if int(s.size) != layer.pi(0, 0) or not s.size:
                raise ValueError(f"{layer.name}: slope size mismatch")
            chunks.append(s.tobytes())
            continue
        if layer.type not in ("Convolution", "ConvolutionDepthWise"):
            continue
        rec = weights[layer.name]
        w = np.asarray(rec["weight"], dtype="<f4")
        if int(w.size) != layer.pi(6):
            raise ValueError(
                f"{layer.name}: weight has {w.size} elements, "
                f".param declares {layer.pi(6)}"
            )
        chunks.append(struct.pack("<I", 0))
        chunks.append(w.tobytes())
        if layer.pi(5):
            b = np.asarray(rec["bias"], dtype="<f4")
            if int(b.size) != layer.pi(0):
                raise ValueError(f"{layer.name}: bias size mismatch")
            chunks.append(b.tobytes())
    with open(path, "wb") as f:
        f.write(b"".join(chunks))
