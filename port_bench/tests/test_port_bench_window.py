"""The window's arithmetic: a rate is taken over all the work and all the
time of the window, and the tail over every volume, so a stall moves both."""

from __future__ import annotations

import time

import pytest

from port_bench.drivers import serve_volumes, train
from port_bench.run import run_cell

from .small import small_cell


def _stall_every(cls, name, every, seconds, monkeypatch):
    calls = {"n": 0}
    original = getattr(cls, name)

    def slow(self, *a, **k):
        calls["n"] += 1
        if calls["n"] % every == 0:
            time.sleep(seconds)
        return original(self, *a, **k)

    monkeypatch.setattr(cls, name, slow)


def test_serve_rate_and_p95_move_with_a_stall(monkeypatch):
    cell = small_cell("tiny224-serve-vol")
    base = run_cell(cell["name"], 3, 1.5, False, device="cpu", cell=cell)["metrics"]
    from cswin_unet_tpu_torch.serve import VolumeServer

    _stall_every(VolumeServer, "segment", 3, 0.3, monkeypatch)
    slow = run_cell(cell["name"], 3, 1.5, False, device="cpu", cell=cell)["metrics"]
    assert slow["serve_slices_per_s"]["value"] < 0.8 * base["serve_slices_per_s"]["value"]
    assert slow["volume_p95_ms"]["value"] > base["volume_p95_ms"]["value"] + 200


def test_train_rate_moves_with_a_stall(monkeypatch):
    cell = small_cell("base384-train-bs24")
    base = run_cell(cell["name"], 3, 1.5, False, device="cpu", cell=cell)["metrics"]
    _stall_every(train.TrainRun, "step", 4, 0.3, monkeypatch)
    slow = run_cell(cell["name"], 3, 1.5, False, device="cpu", cell=cell)["metrics"]
    assert slow["train_samples_per_s"]["value"] < 0.85 * base["train_samples_per_s"]["value"]


def test_percentile_is_over_every_volume():
    xs = [0.01] * 95 + [1.0] * 5
    assert serve_volumes.percentile(xs, 95) == pytest.approx(0.01 + 0.05 * 0.99)
    assert serve_volumes.percentile(xs + [1.0] * 5, 95) == pytest.approx(1.0)
