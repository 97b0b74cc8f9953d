"""The plain reference against the port's plain route at float32, and its
SGD against the trainer's, at a small size on the CPU."""

from __future__ import annotations

import pytest
import torch

from port_bench import program, reference as R, traffic as T
from port_bench.weights import make_weights

from .small import SMALL


def _port(cfg, weights, train):
    from cswin_unet_tpu_torch.models import build_model

    model = build_model(program.port_config(cfg), img_size=cfg["img_size"],
                        num_classes=cfg["num_classes"], device="cpu", impl="plain",
                        train=train)
    model.load_state_dict(weights, strict=True)
    return model


def test_parameters_match_the_port():
    cfg = dict(SMALL)
    model = _port(cfg, make_weights(cfg, 3, "cpu"), False)
    spec = {n: s for n, s, _ in R.param_spec(cfg)}
    assert {n: tuple(p.shape) for n, p in model.state_dict().items()} == spec


@pytest.mark.parametrize("seed", [0, 2 ** 33 + 1])
def test_forward_matches_the_plain_route(seed):
    cfg = dict(SMALL, compute_dtype="float32")
    w = make_weights(cfg, seed, "cpu")
    x = torch.rand(3, 32, 32, 1, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        want = _port(cfg, w, False)(x)
        got = R.forward(R.Numerics(), w, cfg, x)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_training_step_matches_the_plain_route():
    from cswin_unet_tpu_torch.losses import segmentation_loss

    cfg = dict(SMALL, compute_dtype="float32", drop_path_rate=0.4)
    w = make_weights(cfg, 4, "cpu")
    traffic = {"batch": 4, "pool_batches": 1, "organs": 8}
    (image, label), = T.train_batches(cfg, traffic, 4, "cpu")
    model = _port(cfg, w, True)
    logits = model(image, generator=torch.Generator().manual_seed(9))
    loss, _ = segmentation_loss(logits, label, cfg["num_classes"])
    loss.backward()
    dps = R.draw_drop_path(cfg, cfg["drop_path_rate"], 4, torch.Generator().manual_seed(9))
    assert len(dps) == sum(2 * d for d in cfg["depths"]) - 2  # rate-0 blocks draw nothing
    ref_loss, grads = R.train_step(R.Numerics(), w, cfg, image, label, dps, rows=3)
    assert ref_loss == pytest.approx(float(loss.detach()), rel=1e-5)
    for n, p in model.named_parameters():
        assert (grads[n] - p.grad).norm() <= 1e-4 * max(float(p.grad.norm()), 1e-6), n


def test_sgd_matches_the_trainer():
    from cswin_unet_tpu_torch.train.trainer import make_optimizer

    gen = torch.Generator().manual_seed(1)
    w = {"a": torch.randn(5, 3, generator=gen), "b": torch.randn(7, generator=gen)}
    params = [torch.nn.Parameter(v.clone()) for v in w.values()]
    opt, sched = make_optimizer(params, 0.01, 50, momentum=0.9, weight_decay=1e-4)
    mom = {}
    for k in range(3):
        grads = {n: torch.randn(v.shape, generator=gen) for n, v in w.items()}
        for p, g in zip(params, grads.values()):
            p.grad = g.clone()
        opt.step()
        sched.step()
        R.sgd_update(w, grads, mom, R.poly_lr(k, 0.01, 50), mu=0.9, weight_decay=1e-4)
    for p, v in zip(params, w.values()):
        assert torch.allclose(p.detach(), v, rtol=0, atol=1e-7)


def test_fp8_control_rounds_every_product():
    num = R.Numerics("bfloat16")
    a = torch.randn(8, 16, generator=torch.Generator().manual_seed(2))
    b = torch.randn(4, 16, generator=torch.Generator().manual_seed(3))
    exact = a @ b.t()
    low = num.linear(a, b)
    err = float((low - exact).abs().max() / exact.abs().max())
    assert 1e-3 < err < 0.2


def _fp8_as_before(t, dtype, top):
    """The float8 control's rounding as it was written when it was the only
    control: the bf16 cells' control must not move."""
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return (t / scale).to(dtype).to(t.dtype) * scale


def test_fp8_control_is_unchanged_bit_for_bit():
    gen = torch.Generator().manual_seed(5)
    a = torch.randn(12, 24, generator=gen).requires_grad_()
    b = torch.randn(6, 24, generator=gen).requires_grad_()
    g = torch.randn(12, 6, generator=gen)
    y = R.Numerics("bfloat16").linear(a, b)
    da, db = torch.autograd.grad(y, (a, b), g)
    ra, rb = (_fp8_as_before(t.detach(), torch.float8_e4m3fn, R.E4M3_MAX) for t in (a, b))
    rg = _fp8_as_before(g, torch.float8_e5m2, R.E5M2_MAX)
    assert torch.equal(y, ra @ rb.t())
    assert torch.equal(da, rg @ rb) and torch.equal(db, rg.t() @ ra)


def _bits(x: float) -> int:
    return int(torch.tensor([x]).view(torch.int32)[0])


@pytest.mark.parametrize("x,want", [
    (1 + 2 ** -11, 1.0),                          # a tie, to the even 1
    (1 + 3 * 2 ** -11, 1 + 2 ** -9),              # a tie, to the even 1 + 2^-9
    (1 + 2 ** -11 + 2 ** -20, 1 + 2 ** -10),      # past the tie: up
    (1 + 2 ** -11 - 2 ** -20, 1.0),               # short of it: down
    (-(1 + 3 * 2 ** -11), -(1 + 2 ** -9)),        # the sign kept
    (2 - 2 ** -12, 2.0),                          # up into the next binade
    (float("inf"), float("inf")), (-float("inf"), -float("inf")),
])
def test_tf32_rounds_to_nearest_even(x, want):
    got = R.tf32(torch.tensor([x], dtype=torch.float32))
    assert got.dtype == torch.float32 and float(got[0]) == want


def test_tf32_keeps_its_own_values_and_nan():
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(4096, generator=gen) * 10.0 ** torch.randint(-30, 30, (4096,), generator=gen)
    on_grid = (x.view(torch.int32) & ~0x1FFF).view(torch.float32)
    assert torch.equal(R.tf32(on_grid), on_grid)
    assert torch.equal(R.tf32(R.tf32(x)), R.tf32(x))
    assert bool(torch.isnan(R.tf32(torch.tensor([float("nan")])))[0])


def test_tf32_error_under_its_half_ulp():
    gen = torch.Generator().manual_seed(8)
    x = torch.randn(1 << 16, generator=gen) * 10.0 ** torch.randint(-30, 30, (1 << 16,),
                                                                    generator=gen)
    y = R.tf32(x)
    err = (y.double() - x.double()).abs()
    assert bool((err <= x.double().abs() * 2.0 ** -11).all())
    assert bool((y.view(torch.int32) & 0x1FFF == 0).all())   # 10 mantissa bits
    assert float((err / x.double().abs()).max()) > 2.0 ** -12  # it does round


def test_tf32_control_rounds_operands_and_cotangents():
    gen = torch.Generator().manual_seed(9)
    a = torch.randn(10, 32, generator=gen).requires_grad_()
    b = torch.randn(7, 32, generator=gen).requires_grad_()
    g = torch.randn(10, 7, generator=gen)
    num = R.Numerics("float32")
    y = num.linear(a, b)
    da, db = torch.autograd.grad(y, (a, b), g)
    ra, rb, rg = R.tf32(a.detach()), R.tf32(b.detach()), R.tf32(g)
    assert torch.equal(y, ra @ rb.t())
    assert torch.equal(da, rg @ rb) and torch.equal(db, rg.t() @ ra)
    exact = a.detach() @ b.detach().t()
    err = float((y.detach() - exact).abs().max() / exact.abs().max())
    assert 1e-5 < err < 2e-3  # TF32's, far under float8's
