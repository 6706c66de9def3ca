"""Weights from the seed: a frozen surrogate of trained ESRGAN / RealSR
statistics, drawn on the device in three calls.

Per conv of fan-in ``9 * cin``: weights N(0, 1 / sqrt(fan-in)) with a
heavy-tailed per-filter norm (lognormal, sigma 0.4), renormalised per conv
to keep the expected power, so each conv's gain is about 1; biases
N(0, 0.005). These are the statistics of the program's ``ncnn/synth.py``
``"trained"`` mode, drawn by the benchmark's own code (not the same
numbers), with two settings a trained checkpoint learns and random weights
lack, so that the output is an image and not a saturated one:

- each RRDB's skip (0.2 x its last block's output + its input, where that
  output is itself about its input) multiplies the trunk by about 1.2, so
  23 of them by about 66; trunk_conv is scaled by 1.2 ** -num_rrdb, and the
  trunk's sum lands at conv_first's scale;
- conv_last is scaled by 0.5 with biases 0.5: an output centred on
  mid-grey, nearly none of it clipped, so the u8 check compares every value
  and not the few that escape clipping.
"""

from __future__ import annotations

import numpy as np
import torch

STREAM_WEIGHTS, STREAM_IMAGES, STREAM_SAMPLE = 1, 2, 3


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A torch generator on ``device`` for one stream of a run's seed (any
    whole number, negative or past 64 bits too)."""
    entropy = [int(seed) & ((1 << 128) - 1), stream]
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    g = torch.Generator(device=device)
    g.manual_seed(int(state))
    return g


def numpy_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) & ((1 << 128) - 1), stream]))


TRUNK_GROWTH = 1.2  # per RRDB
LAST_GAIN, LAST_BIAS = 0.5, 0.5


def trained_weights(convs: list, seed: int, device, num_rrdb: int) -> tuple:
    """(weights, biases): float32 device tensors, every conv's OIHW weights
    flat in order and one bias per output channel of every conv of an
    RRDBNet of ``num_rrdb`` RRDBs (conv_first, 15 a RRDB, trunk_conv, the
    upsamplers', HRconv, conv_last)."""
    g = generator(seed, STREAM_WEIGHTS, device)
    n_w = sum(c.weights for c in convs)
    n_f = sum(c.cout for c in convs)
    z = torch.randn(n_w, generator=g, device=device)
    fnorm = torch.randn(n_f, generator=g, device=device).mul_(0.4).exp_()
    biases = torch.randn(n_f, generator=g, device=device).mul_(0.005)
    couts = torch.tensor([c.cout for c in convs], device=device)
    layer = torch.repeat_interleave(torch.arange(len(convs), device=device), couts)
    # each conv's sum of squared filter norms, added filter by filter in
    # order on any device: index_add_ on a card adds with atomics, in an
    # order (and so to last bits) that changes from run to run
    position = torch.arange(n_f, device=device) - torch.repeat_interleave(torch.cumsum(couts, 0) - couts, couts)
    sq = torch.zeros(len(convs), int(couts.max()), device=device)
    sq[layer, position] = fnorm * fnorm
    total = torch.zeros(len(convs), device=device)
    for column in sq.unbind(1):
        total += column
    msq = total / couts
    fan_in = torch.tensor([float(c.cin * c.kh * c.kw) for c in convs], device=device)
    gain = torch.ones(len(convs), device=device)
    gain[1 + 15 * num_rrdb] = TRUNK_GROWTH**-num_rrdb
    gain[-1] = LAST_GAIN
    biases[-convs[-1].cout :] = LAST_BIAS
    per_filter = fnorm * gain[layer] / torch.sqrt(msq[layer] * fan_in[layer])
    per_filter_size = torch.repeat_interleave(fan_in.long(), couts)
    return z.mul_(torch.repeat_interleave(per_filter, per_filter_size)), biases


def split(convs: list, weights: torch.Tensor, biases: torch.Tensor) -> list:
    """[(OIHW weight, bias or None)] views, one per conv."""
    out, wpos, bpos = [], 0, 0
    for c in convs:
        w = weights[wpos : wpos + c.weights].view(c.cout, c.cin, c.kh, c.kw)
        out.append((w, biases[bpos : bpos + c.cout] if c.bias else None))
        wpos += c.weights
        bpos += c.cout
    return out
