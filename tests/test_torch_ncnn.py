"""The port's ncnn synth and RRDBNet matcher against the JAX package's."""

import os

import numpy as np
import pytest

from realsr_tpu.graph import rrdb_match as JM
from realsr_tpu.graph.executor import convert_weights_nhwc
from realsr_tpu.ncnn import synth as JS
from realsr_tpu.ncnn.bin import load_weights
from realsr_tpu.ncnn.param import parse_param, parse_param_file
from realsr_tpu_torch.graph import rrdb_match as TM
from realsr_tpu_torch.models.rrdbnet import RRDBNetSpec, params_from_jax
from realsr_tpu_torch.ncnn import synth as TS
from tests.conftest import TINY_SPEC

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DF2K_PARAM = os.path.join(ROOT, "models", "models-DF2K", "x4.param")
PORT_TINY = RRDBNetSpec(num_rrdb=2, num_rdb_per_rrdb=3, nf=16, gc=8, num_upsample=2)


def test_model_dir_same_bytes_as_jax(tmp_path):
    jp, jb = JS.make_model_dir(str(tmp_path / "jax"), TINY_SPEC, seed=3)
    tp, tb = TS.make_model_dir(str(tmp_path / "torch"), PORT_TINY, seed=3)
    for a, b in ((jp, tp), (jb, tb)):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


def test_param_text_and_trained_weights_match_jax():
    from realsr_tpu.models.rrdbnet import RRDBNetSpec as JaxSpec

    text = TS.make_rrdbnet_param_text(RRDBNetSpec())
    assert text == JS.make_rrdbnet_param_text(JaxSpec())
    graph = parse_param(TS.make_rrdbnet_param_text(PORT_TINY))
    want = JS.synth_weights(graph, seed=1, stats="trained")
    got = TS.synth_weights(graph, seed=1, stats="trained")
    assert got.keys() == want.keys()
    for name in want:
        for k in want[name]:
            np.testing.assert_array_equal(got[name][k], want[name][k])


@pytest.mark.parametrize("which", ["df2k", "tiny"])
def test_matcher_matches_jax(which):
    if which == "df2k":
        graph = parse_param_file(DF2K_PARAM)
    else:
        graph = parse_param(TS.make_rrdbnet_param_text(PORT_TINY))
    jm, tm = JM.match_rrdbnet(graph), TM.match_rrdbnet(graph)
    assert jm is not None and tm is not None
    assert tm.spec.__dict__ == jm.spec.__dict__
    for role in ("conv_first", "rdb_convs", "trunk", "up_convs", "hr", "last"):
        assert getattr(tm, role) == getattr(jm, role)
    if which == "df2k":
        assert (tm.spec.num_rrdb, tm.spec.nf, tm.spec.gc) == (23, 64, 32)


def test_matcher_rejects_a_non_rrdbnet_graph():
    # an RDB residual scaled by 0.5 instead of the RRDBNet's 0.2
    text = TS.make_rrdbnet_param_text(PORT_TINY).replace(
        "-23301=2,2.000000e-01", "-23301=2,5.000000e-01", 1
    )
    graph = parse_param(text)
    assert TM.match_rrdbnet(graph) is None
    assert JM.match_rrdbnet(graph) is None


def test_stacked_params_match_jax(tiny_model_dir):
    graph = parse_param_file(os.path.join(tiny_model_dir, "x4.param"))
    weights = load_weights(graph, os.path.join(tiny_model_dir, "x4.bin"))
    jax_tree = JM.extract_stacked_params(
        JM.match_rrdbnet(graph), convert_weights_nhwc(weights)
    )
    got = TM.extract_stacked_params(TM.match_rrdbnet(graph), weights)
    want = params_from_jax(jax_tree)
    for group in want:
        for k in want[group]:
            np.testing.assert_array_equal(got[group][k], want[group][k])
