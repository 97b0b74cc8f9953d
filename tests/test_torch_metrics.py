"""The port's host metrics against the JAX package's ``metrics`` (scipy path,
``use_native=False``): the same code path on the same masks, so the results
are equal, not merely close."""

import numpy as np
import pytest
from scipy import ndimage

from cswin_unet_tpu import metrics as jax_metrics
from cswin_unet_tpu_torch import metrics


def _blob(rng, shape, p, smooth=1.2):
    x = ndimage.gaussian_filter(rng.standard_normal(shape), smooth)
    return x > np.quantile(x, 1 - p)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dice_and_hd95_equal_jax(seed):
    rng = np.random.default_rng(seed)
    pred, gt = _blob(rng, (5, 28, 28), 0.25), _blob(rng, (5, 28, 28), 0.2)
    assert metrics.dice_binary(pred, gt) == jax_metrics.dice_binary(pred, gt)
    assert metrics.hd95(pred, gt) == jax_metrics.hd95(pred, gt, use_native=False)
    assert metrics.metric_per_case(pred, gt) == (
        jax_metrics.dice_binary(pred, gt), jax_metrics.hd95(pred, gt, use_native=False))


def test_edge_rules():
    full = np.ones((2, 4, 4), bool)
    empty = np.zeros((2, 4, 4), bool)
    assert metrics.metric_per_case(full, empty) == (1.0, 0.0)  # pred only
    assert metrics.metric_per_case(empty, full) == (0.0, 0.0)  # pred empty
    assert metrics.metric_per_case(empty, empty) == (0.0, 0.0)
    assert metrics.dice_binary(empty, empty) == 0.0


def test_volume_metrics_equal_jax(monkeypatch):
    scipy_hd95 = jax_metrics.hd95
    monkeypatch.setattr(jax_metrics, "hd95",
                        lambda p, g: scipy_hd95(p, g, use_native=False))
    rng = np.random.default_rng(3)
    label = rng.integers(0, 4, size=(4, 20, 20)).astype(np.int32)
    pred = label.copy()
    pred[label == 1] = np.where(rng.random((label == 1).sum()) < 0.8, 1, 0)
    pred[label == 3] = 0          # class 3: gt only -> (0, 0)
    pred[0, 0, :3] = 4            # class 4: pred only -> (1, 0)
    got = metrics.volume_metrics(pred, label, 6)
    want = [jax_metrics.metric_per_case(pred == c, label == c) for c in range(1, 6)]
    assert got == want
    assert got[2] == (0.0, 0.0) and got[3] == (1.0, 0.0) and got[4] == (0.0, 0.0)
