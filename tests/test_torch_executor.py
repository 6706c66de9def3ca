"""The port's generic ncnn executor against the JAX package's, layer by layer
and on whole graphs, and the loader's and engine's generic path."""

import os

import jax
import numpy as np
import pytest
import torch

from realsr_tpu.engine import EngineConfig as JaxConfig
from realsr_tpu.engine import RealSR as JaxRealSR
from realsr_tpu.graph import executor as JE
from realsr_tpu.loader import load_model as jax_load_model
from realsr_tpu.ncnn.bin import load_weights as jax_load_weights
from realsr_tpu.ncnn.bin import write_weights
from realsr_tpu.ncnn.param import parse_param as jax_parse
from realsr_tpu.ncnn.synth import make_rrdbnet_param_text, synth_weights
from realsr_tpu.ops import resize as JR
from realsr_tpu_torch.engine import EngineConfig, RealSR
from realsr_tpu_torch.graph import executor as TE
from realsr_tpu_torch.loader import load_model
from realsr_tpu_torch.ncnn.bin import load_weights
from realsr_tpu_torch.ncnn.param import parse_param
from realsr_tpu_torch.ops import resize as TR
from tests.conftest import TINY_SPEC

torch.set_num_threads(2)


def _param(lines):
    blobs = set()
    for ln in lines:
        toks = ln.split()
        nin, nout = int(toks[2]), int(toks[3])
        blobs.update(toks[4 : 4 + nin + nout])
    return "7767517\n{} {}\n{}\n".format(len(lines), len(blobs), "\n".join(lines))


def _random_bin(text, path, seed=0):
    """A .bin with seeded random records for every weighted layer."""
    graph = jax_parse(text)
    rng = np.random.default_rng(seed)
    recs = {}
    for layer in graph.layers:
        if layer.type in ("Convolution", "ConvolutionDepthWise"):
            recs[layer.name] = {"weight": rng.normal(0, 0.3, layer.pi(6)), "bias": rng.normal(0, 0.1, layer.pi(0))}
        elif layer.type == "InnerProduct":
            recs[layer.name] = {"weight": rng.normal(0, 0.1, layer.pi(2)), "bias": rng.normal(0, 0.1, layer.pi(0))}
        elif layer.type == "PReLU":
            recs[layer.name] = {"slope": rng.uniform(0.05, 0.5, layer.pi(0))}
    write_weights(graph, recs, path)
    return path


def _run_both(text, x, path):
    """(JAX output or exception class, port output or exception class)."""
    results = []
    for parse, load, convert, build, call in (
        (jax_parse, jax_load_weights, JE.convert_weights_nhwc, JE.build_forward,
         lambda f, p: np.asarray(jax.jit(f)(p, x))),
        (parse_param, load_weights, TE.convert_weights_oihw, TE.build_forward,
         lambda f, p: f(p, torch.from_numpy(x)).numpy()),
    ):
        try:
            graph = parse(text)
            fwd = build(graph)
            results.append(call(fwd, convert(load(graph, path))))
        except (ValueError, NotImplementedError) as ex:
            results.append(type(ex))
    return results


CONV = "Convolution c 1 1 data out 0=5 1=3 4=1 5=1 6=135"
LAYER_CASES = {
    # the JAX package's tests/test_executor_layers.py graphs
    "padding_crop": (["Input in 0 1 data", "Padding pad 1 1 data p 0=2 1=2 2=3 3=3 4=2",
                      "Crop crp 1 1 p out 0=3 1=2 2=0"], (1, 6, 5, 4)),
    "flatten_innerproduct": (["Input in 0 1 data", "Flatten fl 1 1 data flat",
                              "InnerProduct fc 1 1 flat out 0=7 1=1 2=420 9=1"], (2, 4, 5, 3)),
    "activation_layers": (["Input in 0 1 data", "ReLU r 1 1 data a 0=0.1", "Clip c 1 1 a b 0=-0.2 1=0.5",
                           "Sigmoid s 1 1 b c", "TanH t 1 1 c d", "AbsVal v 1 1 d out"], (1, 3, 3, 2)),
    "prelu": (["Input in 0 1 data", "PReLU pr 1 1 data out 0=3"], (2, 4, 5, 3)),
    "pool_max": (["Input in 0 1 data", "Pooling p 1 1 data out 0=0 1=2 2=2"], (1, 6, 8, 3)),
    "pool_avg": (["Input in 0 1 data", "Pooling p 1 1 data out 0=1 1=2 2=2"], (1, 6, 8, 3)),
    "pool_global_avg": (["Input in 0 1 data", "Pooling p 1 1 data out 0=1 4=1"], (1, 6, 8, 3)),
    "pool_global_max": (["Input in 0 1 data", "Pooling p 1 1 data out 0=0 4=1"], (1, 6, 8, 3)),
    "pool_valid_floor": (["Input in 0 1 data", "Pooling p 1 1 data out 0=0 1=3 2=2 5=1"], (1, 6, 8, 3)),
    "pool_padded_rejected": (["Input in 0 1 data", "Pooling p 1 1 data out 0=0 1=2 2=2 3=1"], (1, 6, 8, 3)),
    "pool_ceil_rejected": (["Input in 0 1 data", "Pooling p 1 1 data out 0=0 1=3 2=2"], (1, 6, 8, 3)),
    "cast_packing": (["Input in 0 1 data", "Cast c 1 1 data a 0=1 1=2", "Packing p 1 1 a out 0=4"], (1, 3, 4, 2)),
    "unknown_layer": (["Input in 0 1 data", "FancyNewLayer f 1 1 data out"], (1, 2, 2, 3)),
    # convolutions: each fused activation, strides, dilation, asymmetric
    # padding, depthwise groups
    "conv_act0": (["Input in 0 1 data", CONV], (1, 7, 6, 3)),
    "conv_relu": (["Input in 0 1 data", CONV + " 9=1"], (1, 7, 6, 3)),
    "conv_leaky": (["Input in 0 1 data", CONV + " 9=2 -23310=1,1.000000e-01"], (1, 7, 6, 3)),
    "conv_clip": (["Input in 0 1 data", CONV + " 9=3 -23310=2,-5.000000e-01,5.000000e-01"], (1, 7, 6, 3)),
    "conv_sigmoid": (["Input in 0 1 data", CONV + " 9=4"], (1, 7, 6, 3)),
    "conv_mish": (["Input in 0 1 data", CONV + " 9=5"], (1, 7, 6, 3)),
    "conv_hardswish": (["Input in 0 1 data", CONV + " 9=6 -23310=2,2.000000e-01,5.000000e-01"], (1, 7, 6, 3)),
    "conv_bad_activation": (["Input in 0 1 data", CONV + " 9=7"], (1, 7, 6, 3)),
    "conv_stride_dilation_asym_pad": (
        ["Input in 0 1 data", "Convolution c 1 1 data out 0=4 1=3 11=5 2=2 12=1 3=2 13=1 4=1 15=2 14=0 "
         "16=3 5=1 6=180"], (1, 9, 11, 3)),
    "conv_no_bias_1x1": (["Input in 0 1 data", "Convolution c 1 1 data out 0=6 1=1 5=0 6=18"], (2, 5, 4, 3)),
    "conv_depthwise": (["Input in 0 1 data", "ConvolutionDepthWise dw 1 1 data out 0=6 1=3 4=1 5=1 6=54 7=3"],
                       (1, 6, 7, 3)),
    # elementwise layers over two blobs
    "eltwise_prod": (["Input in 0 1 data", "Split sp 1 2 data a b0", "Sigmoid s 1 1 b0 b",
                      "Eltwise e 2 1 a b out 0=0"], (1, 4, 5, 3)),
    "eltwise_sum_coeffs": (["Input in 0 1 data", "Split sp 1 2 data a b0", "Sigmoid s 1 1 b0 b",
                            "Eltwise e 2 1 a b out 0=1 -23301=2,2.000000e-01,1.000000e+00"], (1, 4, 5, 3)),
    "eltwise_sum": (["Input in 0 1 data", "Split sp 1 2 data a b0", "Sigmoid s 1 1 b0 b",
                     "Eltwise e 2 1 a b out 0=1"], (1, 4, 5, 3)),
    "eltwise_max": (["Input in 0 1 data", "Split sp 1 2 data a b0", "Sigmoid s 1 1 b0 b",
                     "Eltwise e 2 1 a b out 0=2"], (1, 4, 5, 3)),
    "eltwise_bad_op": (["Input in 0 1 data", "Split sp 1 2 data a b", "Eltwise e 2 1 a b out 0=3"], (1, 4, 5, 3)),
    "binary_bad_op": (["Input in 0 1 data", "BinaryOp op 1 1 data out 0=9 1=1 2=0.5"], (1, 4, 5, 3)),
    # resizes: nearest x2 (replication), and the matrix forms
    "interp_nearest_x2": (["Input in 0 1 data", "Interp up 1 1 data out 0=1 1=2.0 2=2.0"], (1, 4, 5, 3)),
    "interp_nearest_x3": (["Input in 0 1 data", "Interp up 1 1 data out 0=1 1=3.0 2=3.0"], (1, 4, 5, 3)),
    "interp_bilinear_x2": (["Input in 0 1 data", "Interp up 1 1 data out 0=2 1=2.0 2=2.0"], (1, 4, 5, 3)),
    "interp_bicubic_x1.5": (["Input in 0 1 data", "Interp up 1 1 data out 0=3 1=1.5 2=1.5"], (1, 6, 4, 2)),
    "interp_bilinear_size": (["Input in 0 1 data", "Interp up 1 1 data out 0=2 3=7 4=9"], (1, 4, 5, 3)),
    "interp_bad_type": (["Input in 0 1 data", "Interp up 1 1 data out 0=4 1=2.0 2=2.0"], (1, 4, 5, 3)),
    "pixelshuffle_mode0": (["Input in 0 1 data", "PixelShuffle s 1 1 data out 0=2"], (1, 3, 4, 8)),
    "pixelshuffle_mode1": (["Input in 0 1 data", "PixelShuffle s 1 1 data out 0=2 1=1"], (1, 3, 4, 8)),
    "padding_constant": (["Input in 0 1 data", "Padding pad 1 1 data out 0=1 1=2 2=3 3=0 4=0 5=0.5"],
                         (1, 4, 5, 3)),
    "padding_edge": (["Input in 0 1 data", "Padding pad 1 1 data out 0=3 1=1 2=2 3=4 4=1"], (1, 4, 5, 3)),
    "padding_reflect_wide": (["Input in 0 1 data", "Padding pad 1 1 data out 0=5 1=6 2=7 3=4 4=2"],
                             (1, 3, 4, 2)),
    "padding_bad_type": (["Input in 0 1 data", "Padding pad 1 1 data out 0=1 1=1 2=1 3=1 4=3"], (1, 4, 5, 3)),
    "concat_channels": (["Input in 0 1 data", "Split sp 1 2 data a b0", "Sigmoid s 1 1 b0 b",
                         "Concat c 2 1 a b out 0=0"], (1, 4, 5, 3)),
    "concat_h": (["Input in 0 1 data", "Split sp 1 2 data a b", "Concat c 2 1 a b out 0=1"], (1, 4, 5, 3)),
    "concat_w": (["Input in 0 1 data", "Split sp 1 2 data a b", "Concat c 2 1 a b out 0=2"], (1, 4, 5, 3)),
    "dropout_noop": (["Input in 0 1 data", "Dropout d 1 1 data a 0=0.5", "Noop n 1 1 a out"], (1, 4, 5, 3)),
    "crop_sizes": (["Input in 0 1 data", "Crop c 1 1 data out 0=1 1=2 2=1 3=3 4=2 5=2"], (1, 6, 5, 4)),
    "miswired": (["Input in 0 1 data", "ReLU r 1 1 later out", "ReLU q 1 1 data later"], (1, 2, 2, 3)),
    "two_outputs": (["Input in 0 1 data", "Split sp 1 2 data a b"], (1, 2, 2, 3)),
}
# every BinaryOp, on two blobs and with a scalar
for _k in range(9):
    LAYER_CASES[f"binary_{_k}"] = (["Input in 0 1 data", "Split sp 1 2 data a b0", "Sigmoid s 1 1 b0 b",
                                    f"BinaryOp op 2 1 a b out 0={_k}"], (1, 4, 5, 3))
    LAYER_CASES[f"binary_{_k}_scalar"] = (["Input in 0 1 data", f"BinaryOp op 1 1 data out 0={_k} 1=1 2=0.7"],
                                          (1, 4, 5, 3))

RAISES = {
    "pool_padded_rejected": NotImplementedError, "pool_ceil_rejected": NotImplementedError,
    "unknown_layer": NotImplementedError, "conv_bad_activation": NotImplementedError,
    "eltwise_bad_op": NotImplementedError, "binary_bad_op": NotImplementedError,
    "interp_bad_type": NotImplementedError, "padding_bad_type": NotImplementedError,
    "miswired": ValueError, "two_outputs": ValueError,
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_matches_jax_executor(case, tmp_path):
    """The same graph text and .bin through both executors: float32 within
    rtol 1e-5, or the same error class."""
    lines, shape = LAYER_CASES[case]
    text = _param(lines)
    path = _random_bin(text, str(tmp_path / "m.bin"))
    # positive inputs keep BinaryOp's pow and divisions real
    x = np.random.default_rng(len(case)).uniform(0.1, 1.1, shape).astype(np.float32)
    if case.startswith(("activation", "conv", "prelu")):
        x = x - 0.6
    want, got = _run_both(text, x, path)
    if case in RAISES:
        assert want is got is RAISES[case]
        return
    assert isinstance(want, np.ndarray) and isinstance(got, np.ndarray), (want, got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_weights_carry_across_from_jax(tmp_path):
    """The JAX executor's HWIO weights map onto the port's OIHW ones."""
    text = _param(["Input in 0 1 data", "Convolution c 1 1 data a 0=4 1=3 11=5 5=1 6=180",
                   "ConvolutionDepthWise dw 1 1 a b 0=8 1=3 4=1 5=1 6=144 7=2",
                   "Flatten fl 1 1 b flat", "InnerProduct fc 1 1 flat out 0=3 1=1 2=24 9=1"])
    path = _random_bin(text, str(tmp_path / "m.bin"))
    jw = JE.convert_weights_nhwc(jax_load_weights(jax_parse(text), path))
    tw = TE.convert_weights_oihw(load_weights(parse_param(text), path))
    carried = TE.weights_from_jax(jw)
    assert carried.keys() == tw.keys()
    for name in tw:
        assert carried[name].keys() == tw[name].keys()
        for k in tw[name]:
            np.testing.assert_array_equal(carried[name][k], tw[name][k])


@pytest.mark.parametrize("kind", ["nearest", "bilinear", "bicubic"])
@pytest.mark.parametrize("sizes", [(5, 13), (12, 7), (9, 9)])
def test_resize_matches_jax(kind, sizes):
    """resize_nhwc and its interpolation matrices against the JAX package's."""
    n_in, n_out = sizes
    np.testing.assert_array_equal(TR._resize_matrix(n_in, n_out, kind), JR._resize_matrix(n_in, n_out, kind))
    x = np.random.default_rng(n_in).random((2, n_in, n_in + 2, 3), dtype=np.float32)
    want = np.asarray(JR.resize_nhwc(x, n_out, n_out + 1, kind))
    got = TR.resize_nhwc(torch.from_numpy(x), n_out, n_out + 1, kind).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def tiny_files(tiny_model_dir):
    return os.path.join(tiny_model_dir, "x4.param"), os.path.join(tiny_model_dir, "x4.bin")


def test_tiny_rrdbnet_generic_matches_jax(tiny_files):
    """The tiny RRDBNet graph through the port's executor (fast path
    refused) against JAX's fast path and JAX's executor."""
    bundle = load_model(*tiny_files, allow_fast_path=False)
    assert bundle.spec is None and bundle.tail is None and bundle.scale == 4
    jfast = jax_load_model(*tiny_files)
    jgen = jax_load_model(*tiny_files, allow_fast_path=False)
    x = np.random.default_rng(5).random((2, 14, 11, 3), dtype=np.float32)
    with torch.no_grad():
        got = bundle.forward(bundle.params, torch.from_numpy(x)).numpy()
    for ref in (jfast, jgen):
        want = np.asarray(jax.jit(ref.forward)(ref.params, x))
        assert got.shape == want.shape == (2, 56, 44, 3)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_generic_bfloat16_storage_runs(tiny_files):
    """At bfloat16 operands the executor holds every blob in bfloat16 (no
    float32 carry, as in JAX) and stays near the float32 run."""
    b16 = load_model(*tiny_files, storage_dtype=torch.float32, op_dtype=torch.bfloat16, allow_fast_path=False)
    b32 = load_model(*tiny_files, allow_fast_path=False)
    x = torch.from_numpy(np.random.default_rng(6).random((1, 12, 12, 3), dtype=np.float32))
    with torch.no_grad():
        y16, y32 = b16.forward(b16.params, x), b32.forward(b32.params, x)
    assert y16.dtype == torch.float32 and bool(torch.isfinite(y16).all())
    assert (y16 - y32).abs().max().item() <= 0.05 * max(1.0, y32.abs().max().item())


def _rejected_model_dir(path, seed=3):
    """The tiny RRDBNet text with its upsamplers' nearest Interp switched to
    bilinear, which the RRDBNet matcher rejects."""
    text = make_rrdbnet_param_text(TINY_SPEC).replace("0=1 1=2.0 2=2.0", "0=2 1=2.0 2=2.0")
    assert "0=2 1=2.0 2=2.0" in text
    os.makedirs(path, exist_ok=True)
    pp, bp = os.path.join(path, "x4.param"), os.path.join(path, "x4.bin")
    with open(pp, "w") as f:
        f.write(text)
    write_weights(jax_parse(text), synth_weights(jax_parse(text), seed=seed), bp)
    return pp, bp


@pytest.mark.parametrize("shape", [(37, 29, 3), (23, 19, 4)])
def test_rejected_graph_engine_matches_jax(shape, tmp_path):
    """A matcher-rejected graph through the port's engine against the JAX
    engine: u8 >= 99.9 % equal, max diff <= 1."""
    files = _rejected_model_dir(str(tmp_path / "m"))
    jax_e = JaxRealSR(gpuid=-1, config=JaxConfig(tilesize=16, storage="float32", compilation_cache=False))
    jax_e.load(*files)
    port = RealSR(gpuid=-1, config=EngineConfig(tilesize=16, storage="float32"))
    port.load(*files)
    assert jax_e.bundle.spec is None and port.bundle.spec is None
    assert (port.variant, port.tail, port.trunk, port.scale) == (None, None, None, 4)
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, np.uint8)
    want, got = jax_e.process(img), port.process(img)
    assert got.shape == want.shape == (4 * shape[0], 4 * shape[1], shape[2])
    d = np.abs(got.astype(int) - want.astype(int))
    assert np.mean(d == 0) >= 0.999 and d.max() <= 1


def test_non_uniform_scale_rejected_like_jax(tmp_path):
    """A graph whose H and W scales differ fails to load in both packages
    with ValueError."""
    text = _param(["Input in 0 1 data", "Interp up 1 1 data out 0=1 1=2.0 2=3.0"])
    pp = tmp_path / "x4.param"
    pp.write_text(text)
    bp = tmp_path / "x4.bin"
    bp.write_bytes(b"")
    for load in (jax_load_model, load_model):
        with pytest.raises(ValueError, match="non-uniform"):
            load(str(pp), str(bp))


def test_scalar_binary_op_uploads_once_and_is_bit_equal(tmp_path, monkeypatch):
    """A BinaryOp's scalar is made once per value and device (no upload per
    call), and the executor's output is bit-equal to the route that made a
    fresh float32 tensor on every call: pow, subtractions and divisions by
    scalars, -0.0 kept apart from 0.0."""
    lines = ["Input in 0 1 data", "BinaryOp p 1 1 data a 0=6 1=1 2=0.7", "BinaryOp s 1 1 a b 0=1 1=1 2=-0.0",
             "BinaryOp r 1 1 b c 0=7 1=1 2=2.5", "BinaryOp d 1 1 c e 0=8 1=1 2=0.3",
             "BinaryOp z 1 1 e out 0=1 1=1 2=0.0"]
    text = _param(lines)
    graph = parse_param(text)
    fwd = TE.build_forward(graph)
    params = TE.convert_weights_oihw(load_weights(graph, _random_bin(text, str(tmp_path / "m.bin"))))
    x = torch.from_numpy(np.random.default_rng(1).uniform(0.1, 1.1, (1, 4, 5, 3)).astype(np.float32))
    x[0, 0, 0, 0] = -0.0
    TE._scalar_on.cache_clear()
    got = [fwd(params, x), fwd(params, x)]
    info = TE._scalar_on.cache_info()
    assert (info.misses, info.hits) == (5, 5)  # each of the five values made once; -0.0 apart from 0.0
    monkeypatch.setattr(TE, "_scalar_on", lambda bits, device: torch.tensor(
        float(np.frombuffer(bits, np.float32)[0]), dtype=torch.float32, device=device))
    want = fwd(params, x)
    for g in got:
        assert g.dtype == want.dtype and torch.equal(g.view(torch.int32), want.view(torch.int32))
