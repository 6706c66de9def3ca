"""A seed's weights on the card are the same bits in every draw: the
per-conv sums that scale them are added in a fixed order (a card's
``index_add_`` adds with atomics, in an order that changes from run to
run).

On a host with a card: ``python -m pytest benchmark/tests -q -m gpu``.
"""

from __future__ import annotations

import pytest
import torch

from benchmark import run
from benchmark.weights import trained_weights
from conftest import BENCH


@pytest.mark.gpu
def test_a_seed_draws_the_same_weights_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = run.load_config(BENCH, run.cell_of(run.load_spec(BENCH), "df2k-x4.photo-1024x768")[1])
    dev = torch.device("cuda", 0)
    first, again = (trained_weights(cfg["convs"], 3000020001, dev, cfg["num_rrdb"]) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, again))
