"""Synthesize ncnn .param/.bin files for RRDBNet graphs, without JAX.

Counterpart of ``realsr_tpu/ncnn/synth.py`` (which imports the JAX model for
its spec): the same .param text and the same numpy draws, so one seed writes
the same bytes from either package. The DF2K graphs ship without weights, so
tests, the chip smoke run and first use synthesize deterministic ones.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from realsr_tpu_torch.models.rrdbnet import RRDBNetSpec
from realsr_tpu_torch.ncnn.param import NCNN_MAGIC, ParamGraph, parse_param


def make_rrdbnet_param_text(spec: RRDBNetSpec) -> str:
    """Generate ncnn .param text for an RRDBNet with the given spec."""
    # Build layers with direct blob references first; insert Splits after.
    layers: List[Tuple[str, str, List[str], List[str], str]] = []
    counter = [0]

    def blob() -> str:
        counter[0] += 1
        return f"b{counter[0]}"

    def conv(name: str, src: str, cin: int, cout: int, act: int) -> str:
        out = blob()
        extra = f"0={cout} 1=3 4=1 5=1 6={cout * cin * 9}"
        if act == 2:
            extra += " 9=2 -23310=1,2.000000e-01"
        layers.append(("Convolution", name, [src], [out], extra))
        return out

    def concat(name: str, srcs: List[str]) -> str:
        out = blob()
        layers.append(("Concat", name, list(srcs), [out], ""))
        return out

    def residual(name: str, a: str, b: str) -> str:
        """0.2*a + b (ncnn Eltwise SUM coeffs, x4.param Add_16 style)."""
        out = blob()
        layers.append(
            (
                "Eltwise",
                name,
                [a, b],
                [out],
                "0=1 -23301=2,2.000000e-01,1.000000e+00",
            )
        )
        return out

    nf, gc = spec.nf, spec.gc
    layers.append(("Input", "input.1", [], ["data"], ""))
    fea = conv("conv_first", "data", spec.in_ch, nf, 0)

    cur = fea
    ci = 0
    for bi in range(spec.num_rrdb):
        u = cur
        for ri in range(spec.num_rdb_per_rrdb):
            t = cur
            c1 = conv(f"Conv_{bi}_{ri}_1", t, nf, gc, 2)
            c2 = conv(f"Conv_{bi}_{ri}_2", concat(f"Cat_{ci}", [t, c1]), nf + gc, gc, 2)
            ci += 1
            c3 = conv(
                f"Conv_{bi}_{ri}_3",
                concat(f"Cat_{ci}", [t, c1, c2]),
                nf + 2 * gc,
                gc,
                2,
            )
            ci += 1
            c4 = conv(
                f"Conv_{bi}_{ri}_4",
                concat(f"Cat_{ci}", [t, c1, c2, c3]),
                nf + 3 * gc,
                gc,
                2,
            )
            ci += 1
            c5 = conv(
                f"Conv_{bi}_{ri}_5",
                concat(f"Cat_{ci}", [t, c1, c2, c3, c4]),
                nf + 4 * gc,
                nf,
                0,
            )
            ci += 1
            cur = residual(f"Add_{bi}_{ri}", c5, t)
        cur = residual(f"AddB_{bi}", cur, u)

    trunk = conv("trunk_conv", cur, nf, nf, 0)
    body = blob()
    layers.append(("BinaryOp", "long_skip", [fea, trunk], [body], ""))
    cur = body
    for s in range(spec.num_upsample):
        up_in = blob()
        layers.append(("Interp", f"Resize_{s}", [cur], [up_in], "0=1 1=2.0 2=2.0"))
        cur = conv(f"upconv{s + 1}", up_in, nf, nf, 2)
    cur = conv("HRconv", cur, nf, nf, 2)
    conv("conv_last", cur, nf, spec.out_ch, 0)
    # rename final blob to "output" like x4.param (realsr.cpp:310-312)
    final = layers[-1][3][0]

    # Insert Split layers for blobs consumed more than once (ncnn-faithful).
    consumers: Dict[str, int] = {}
    for _, _, ins, _, _ in layers:
        for b in ins:
            consumers[b] = consumers.get(b, 0) + 1

    out_lines: List[str] = []
    taken: Dict[str, int] = {}
    split_i = [0]

    def rename(b: str) -> str:
        if b == final:
            return "output"
        return b

    expanded: List[Tuple[str, str, List[str], List[str], str]] = []
    for ltype, name, ins, outs, extra in layers:
        new_ins = []
        for b in ins:
            if consumers.get(b, 0) > 1:
                k = taken.get(b, 0)
                taken[b] = k + 1
                new_ins.append(f"{b}_split_{k}")
            else:
                new_ins.append(b)
        expanded.append((ltype, name, new_ins, outs, extra))
        for b in outs:
            n = consumers.get(b, 0)
            if n > 1:
                split_outs = [f"{b}_split_{k}" for k in range(n)]
                expanded.append(
                    ("Split", f"splitncnn_{split_i[0]}", [b], split_outs, "")
                )
                split_i[0] += 1

    blob_names = set()
    for _, _, ins, outs, _ in expanded:
        blob_names.update(rename(b) for b in ins)
        blob_names.update(rename(b) for b in outs)

    out_lines.append(str(NCNN_MAGIC))
    out_lines.append(f"{len(expanded)} {len(blob_names)}")
    for ltype, name, ins, outs, extra in expanded:
        toks = [f"{ltype:<24} {name:<24} {len(ins)} {len(outs)}"]
        toks += [rename(b) for b in ins]
        toks += [rename(b) for b in outs]
        if extra:
            toks.append(extra)
        out_lines.append(" ".join(toks))
    return "\n".join(out_lines) + "\n"


def synth_weights(
    graph: ParamGraph, seed: int = 0, scale: float = 0.05, stats: str = "iid"
) -> Dict[str, Dict[str, np.ndarray]]:
    """Deterministic random OIHW weights for every Convolution in the graph.

    ``stats``:
    - ``"iid"`` — N(0, scale) for every conv (historical default; with
      scale=0.05 each 9*cin-fan-in conv has output gain 9*cin*scale^2 >> 1,
      so activations AMPLIFY through the 23-block chain and storage-
      precision noise with them — a worst case for numerics measurements).
    - ``"trained"`` — surrogate of trained ESRGAN/RealSR statistics: He
      fan-in scaling sigma = 1/sqrt(9*cin) (upstream RRDBNet initializes
      MSRA x0.1 and training keeps interior conv std well below the
      amplifying regime) with heavy-tailed per-output-filter norms
      (lognormal, matching the filter-norm spread of trained conv nets)
      renormalized to preserve expected power, and small biases. Output
      gain per conv is ~<=1, so the chain is non-amplifying like the real
      checkpoints; used to bound the PSNR a given storage mode would show
      on real weights (goldens/README.md table).
    """
    if stats not in ("iid", "trained"):
        raise ValueError(f"unknown stats mode {stats!r}")
    rng = np.random.default_rng(seed)
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for layer in graph.layers:
        if layer.type == "PReLU":
            n = layer.pi(0, 0)  # ncnn default 0 = no slope data (unloadable)
            if n >= 1:
                out[layer.name] = {
                    "slope": rng.uniform(0.05, 0.3, size=(n,)).astype(
                        np.float32
                    )
                }
            continue
        if layer.type != "Convolution":
            continue
        cout = layer.pi(0)
        kw = layer.pi(1)
        kh = layer.pi(11, kw)
        wsize = layer.pi(6)
        cin = wsize // (cout * kh * kw)
        if stats == "trained":
            sigma = 1.0 / np.sqrt(kh * kw * cin)
            w = rng.normal(0, sigma, size=(cout, cin, kh, kw))
            fnorm = rng.lognormal(0.0, 0.4, size=(cout, 1, 1, 1))
            w = w * (fnorm / np.sqrt(np.mean(fnorm**2)))
            rec = {"weight": w.astype(np.float32)}
            bias_scale = 0.005
        else:
            rec = {
                "weight": rng.normal(
                    0, scale, size=(cout, cin, kh, kw)
                ).astype(np.float32)
            }
            bias_scale = 0.01
        if layer.pi(5):
            rec["bias"] = rng.normal(0, bias_scale, size=(cout,)).astype(
                np.float32
            )
        out[layer.name] = rec
    return out


def make_model_dir(
    path: str, spec: RRDBNetSpec, seed: int = 0, name: str = "x4"
) -> Tuple[str, str]:
    """Write <path>/<name>.param and .bin; returns their paths."""
    import os

    from realsr_tpu_torch.ncnn.bin import write_weights

    os.makedirs(path, exist_ok=True)
    param_path = os.path.join(path, f"{name}.param")
    bin_path = os.path.join(path, f"{name}.bin")
    text = make_rrdbnet_param_text(spec)
    with open(param_path, "w", encoding="utf-8") as f:
        f.write(text)
    graph = parse_param(text)
    write_weights(graph, synth_weights(graph, seed), bin_path)
    return param_path, bin_path
