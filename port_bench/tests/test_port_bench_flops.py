"""The yardstick's counts: the analytic model FLOPs against torch's
``FlopCounterMode`` over the plain reference, and the kernel work's launches
against the program's routing."""

from __future__ import annotations

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import harness, reference as R, work
from port_bench.weights import make_weights

from .small import SMALL

SHAPES = [SMALL,
          dict(SMALL, img_size=64, depths=[2, 1, 3, 2], split_size=[2, 4, 4, 2],
               num_heads=[2, 4, 4, 8]),
          dict(SMALL, img_size=64, embed_dim=8, depths=[1, 1, 1, 1], split_size=[1, 2, 4, 4],
               num_classes=4)]


@pytest.mark.parametrize("cfg", SHAPES, ids=["small", "deeper", "wide-img"])
def test_model_flops_match_flop_counter(cfg):
    w = make_weights(cfg, 1, "cpu")
    x = torch.rand(2, cfg["img_size"], cfg["img_size"], 1)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        R.forward(R.Numerics(), w, cfg, x)
    assert work.model_flops(cfg) * 2 == counter.get_total_flops()


@pytest.mark.parametrize("name", ["cswin-tiny-224-lite", "cswin-base-384"])
def test_published_sizes(name):
    cfg = harness.load_json("configs", name)
    params = sum(math.prod(shape) for _, shape, _ in R.param_spec(cfg))
    if name == "cswin-base-384":
        assert params == 150_845_028  # 150.8 M, the repository's own count
    flops = work.model_flops(cfg)
    assert 5e9 < flops < 5e11


@pytest.mark.parametrize("name,launches", [
    # per 32-slice serving forward, stage 3 paired (the program's counters,
    # PERF.md): 20 LN, 42 GEMM, 18 attention, 8 pairs, 2 CARAFE
    ("cswin-tiny-224-lite", dict(gemm=42, stripe_attention=18, block_pair=8,
                                 carafe_reassemble=2)),
    ("cswin-base-384", dict(gemm=322, stripe_attention=156, carafe_reassemble=2))])
def test_serve_route_from_counts(name, launches):
    cfg = harness.load_json("configs", name)
    units = [32, 32, 8]
    counts = {k: v * len(units) for k, v in launches.items()}
    calls = work.route_from_counts(cfg, units, counts, work.serve_calls)
    assert calls is not None
    assert work.launches(calls) == {k: v for k, v in counts.items() if v}
    assert work.route_from_counts(cfg, units, dict(counts, gemm=1), work.serve_calls) is None


def test_train_launches_match_the_program():
    # one bs-24 base-384 step (the program's counters, PERF.md): 322 GEMM,
    # 320 dX, 320 wgrad, 156 attention each way, 2 CARAFE
    cfg = harness.load_json("configs", "cswin-base-384")
    got = work.launches(work.train_calls(cfg, 24, 0.5))
    assert got == dict(gemm=322, gemm_dgrad=320, gemm_wgrad=320, stripe_attention=156,
                       stripe_attention_bwd=156, carafe_reassemble=2)


def test_bounds_of_the_smoke_test():
    # the kernel smoke test's bf16 bounds (PERF.md): base-384's 32-slice
    # forward, attention 1.6566 and GEMMs 7.7117 ms; a bs-24 step's dX
    # 6.4251, wgrad 5.2060, attention backward 2.1747 ms
    cfg = harness.load_json("configs", "cswin-base-384")
    fwd = work.serve_calls(cfg, 32)
    assert 1e3 * work.family_bound_s(fwd, "attention") == pytest.approx(1.6566, abs=5e-4)
    assert 1e3 * work.family_bound_s(fwd, "gemm") == pytest.approx(7.7117, abs=5e-4)
    step = work.train_calls(cfg, 24, 0.5)
    by = lambda w: 1e3 * sum(c.bound_s for c in step if c.wrapper == w)  # noqa: E731
    assert by("gemm_dgrad") == pytest.approx(6.4251, abs=5e-4)
    assert by("gemm_wgrad") == pytest.approx(5.2060, abs=5e-4)
    assert by("stripe_attention_bwd") == pytest.approx(2.1747, abs=5e-4)
