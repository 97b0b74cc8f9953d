"""The traffic generator is deterministic per seed, and a seed changes the
content and order of the work, never its amount."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from port_bench import harness, traffic as T

from .small import SMALL

SEEDS = (0, 7, 2 ** 31 + 5, 2 ** 40 + 3)


@pytest.mark.parametrize("seed", SEEDS)
def test_volume_depths_fixed_set_in_range(seed):
    tr = harness.load_json("traffic", "synapse-volumes")
    depths = T.volume_depths(tr, seed)
    assert all(85 <= d <= 198 for d in depths)
    assert sorted(depths) == sorted(T.volume_depths(tr, 1))
    assert min(depths) == 85 and max(depths) == 198 and len(depths) == tr["pool"]


def test_volume_order_follows_the_seed():
    tr = harness.load_json("traffic", "synapse-volumes")
    orders = {tuple(T.volume_depths(tr, s)) for s in SEEDS}
    assert len(orders) > 1


@pytest.mark.parametrize("seed", SEEDS)
def test_volume_pool_deterministic(seed):
    tr = dict(harness.load_json("traffic", "synapse-volumes"), depth_min=4, depth_max=12,
              pool=3)
    a = T.volume_pool(SMALL, tr, seed, "cpu")
    b = T.volume_pool(SMALL, tr, seed, "cpu")
    c = T.volume_pool(SMALL, tr, seed + 1, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(x.shape == y.shape and np.array_equal(x, y) for x, y in zip(a, c))
    assert all(v.dtype == np.float32 and v.shape[1:] == (32, 32) for v in a)
    assert all(0.0 <= v.min() and v.max() <= 1.0 for v in a)


@pytest.mark.parametrize("seed", SEEDS)
def test_train_batches_deterministic_and_distinct(seed):
    tr = dict(harness.load_json("traffic", "closed-loop-bs24"), batch=3)
    a = T.train_batches(SMALL, tr, seed, "cpu")
    b = T.train_batches(SMALL, tr, seed, "cpu")
    assert len(a) == tr["pool_batches"]
    for (xa, ya), (xb, yb) in zip(a, b):
        assert torch.equal(xa, xb) and torch.equal(ya, yb)
        assert xa.shape == (3, 32, 32, 1) and ya.shape == (3, 32, 32)
        assert int(ya.min()) >= 0 and int(ya.max()) <= tr["organs"]
    rows = torch.cat([x for x, _ in a]).flatten(1)
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]  # all rows differ


def test_sub_seeds_differ_by_stream_and_seed():
    assert T.sub_seed(5, "weights") != T.sub_seed(5, "drop_path")
    assert T.sub_seed(5, "weights") != T.sub_seed(6, "weights")
    assert 0 <= T.sub_seed(2 ** 40, "weights") < 2 ** 63
