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
    num = R.Numerics(fp8=True)
    a = torch.randn(8, 16, generator=torch.Generator().manual_seed(2))
    b = torch.randn(4, 16, generator=torch.Generator().manual_seed(3))
    exact = a @ b.t()
    low = num.linear(a, b)
    err = float((low - exact).abs().max() / exact.abs().max())
    assert 1e-3 < err < 0.2
