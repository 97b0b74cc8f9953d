"""The port's training slice against the JAX package: the data loader's
batches, the optimizer's updates, whole-model gradients, the kernel route
against the plain route, and a short ``trainer_synapse`` run.

Tolerances: loader batches exactly equal (same rng draws, same scipy
calls); optimizer updates rtol 1e-6 (float32 arithmetic of the same
formula); whole-model float32 gradients relative L2 <= 1e-3 per parameter
(two frameworks' summation orders through 26 layers of autodiff); the kernel
route against the plain route in float32 relative L2 <= 1e-4 (on the CPU
the kernels run their plain versions: only summation order differs).
"""

import argparse
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cswin_unet_tpu import losses as jax_losses
from cswin_unet_tpu.config import get_config
from cswin_unet_tpu.data import DataLoader as JaxLoader
from cswin_unet_tpu.data import RandomGenerator as JaxRandomGenerator
from cswin_unet_tpu.data import SynapseDataset as JaxDataset
from cswin_unet_tpu.data import make_synthetic_dataset
from cswin_unet_tpu.models import CSwinUnet as JaxCSwinUnet
from cswin_unet_tpu.models import CSWinUNet as JaxCSWinUNet
from cswin_unet_tpu.models import build_model as jax_build_model
from cswin_unet_tpu.train.trainer import make_optimizer as jax_make_optimizer
from cswin_unet_tpu.utils import checkpoint as jax_ckpt
from cswin_unet_tpu_torch.data import (DataLoader, RandomGenerator, SynapseDataset,
                                       device_prefetch)
from cswin_unet_tpu_torch.losses import segmentation_loss
from cswin_unet_tpu_torch.models import CSwinUnet, CSWinUNet
from cswin_unet_tpu_torch.ops.cuda.carafe_tail import CarafeFn
from cswin_unet_tpu_torch.ops.cuda.cswin_block import CSWinBlockFn
from cswin_unet_tpu_torch.train import make_optimizer, poly_lr, trainer_synapse
from cswin_unet_tpu_torch.utils.checkpoint import (load_checkpoint, load_into,
                                                   params_from_jax)

torch.set_num_threads(2)

GEOM = dict(img_size=64, in_chans=3, num_classes=4, embed_dim=32,
            depth=(1, 1, 1, 1), split_size=(1, 2, 2, 2), num_heads=(2, 4, 8, 16))


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


@pytest.fixture(scope="module")
def synapse(tmp_path_factory):
    root = tmp_path_factory.mktemp("synapse")
    return make_synthetic_dataset(str(root), num_train_slices=10, num_volumes=1,
                                  size=40, depth=2, num_classes=9, seed=3)


def test_loader_batches_equal_jax_loader(synapse):
    """Same seed, same (seed, epoch, index) sample rngs: the port's batches
    equal the JAX loader's, over two epochs and the wrapped final batch."""
    kw = dict(base_dir=synapse["train_dir"], list_dir=synapse["list_dir"],
              split="train")
    port = DataLoader(SynapseDataset(transform=RandomGenerator([32, 32]), **kw), 4,
                      seed=9, num_workers=2)
    ref = JaxLoader(JaxDataset(transform=JaxRandomGenerator([32, 32]), **kw), 4,
                    seed=9, num_workers=2)
    assert len(port) == len(ref) == 3
    for _ in range(2):
        for a, b in zip(port, ref, strict=True):
            assert a["case_name"] == b["case_name"]
            np.testing.assert_array_equal(a["image"], b["image"])
            np.testing.assert_array_equal(a["label"], b["label"])
            assert a["image"].shape == (4, 32, 32, 1) and a["label"].dtype == np.int32
    batches = list(device_prefetch(iter(port), "cpu"))
    assert len(batches) == 3 and batches[0]["image"].dtype == torch.float32


def test_sgd_poly_steps_match_optax():
    """Three steps of SGD(momentum 0.9, weight decay 1e-4) with the poly LR
    on fixed gradients equal optax's chain(add_decayed_weights, sgd)."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((5, 3)).astype(np.float32)
    grads = [rng.standard_normal((5, 3)).astype(np.float32) for _ in range(3)]
    base, max_it = 0.05, 4

    jopt = jax_make_optimizer(base, max_it)
    jp = jnp.asarray(p0)
    state = jopt.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt, sched = make_optimizer([tp], base, max_it)
    for it, g in enumerate(grads):
        assert opt.param_groups[0]["lr"] == pytest.approx(poly_lr(it, base, max_it))
        upd, state = jopt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g.copy())
        opt.step()
        sched.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   rtol=1e-6, atol=1e-7)


def test_model_grads_match_jax_grad():
    """Whole-model float32 gradients of 0.4·CE + 0.6·Dice on weights carried
    over from a JAX init: port autograd against ``jax.grad`` (XLA
    composition, drop-path 0)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 64, 64, 1)).astype(np.float32)
    y = rng.integers(0, 4, (2, 64, 64)).astype(np.int32)
    m = JaxCSwinUnet(backbone=JaxCSWinUNet(**GEOM, attn_impl="xla"))
    params = jax.jit(m.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))

    def loss(p):
        logits = m.apply(p, jnp.asarray(x), deterministic=True)
        return jax_losses.segmentation_loss(logits, jnp.asarray(y), 4)[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(params)
    flat = {k: np.array(v) for k, v in jax_ckpt.flatten(jax.device_get(params)).items()}
    want = params_from_jax({k: np.array(v) for k, v in
                            jax_ckpt.flatten(jax.device_get(jgrads)).items()})

    backbone = CSWinUNet(**GEOM, dtype=torch.float32, impl="fused")
    backbone.load_state_dict(params_from_jax(flat))
    model = CSwinUnet(backbone).train()
    tloss, _ = segmentation_loss(model(torch.from_numpy(x)), torch.from_numpy(y), 4)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    got = {f"{k}": p.grad for k, p in backbone.named_parameters()}
    assert set(got) == set(want)
    errs = {k: _rel_l2(got[k].numpy(), want[k].numpy()) for k in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-3, (worst, errs[worst])


def test_kernel_route_matches_plain_route_at_128(monkeypatch):
    """At img 128 all 8 blocks (stage 1 at 32x32, the last stage at 4x4
    among them) train through ``CSWinBlockFn`` and the tail through
    ``CarafeFn``. Same weights, same drop-path draws (rate 0.2) as the
    plain route: same loss and gradients."""
    calls = {"block": 0, "tail": 0}
    for key, cls in (("block", CSWinBlockFn), ("tail", CarafeFn)):
        apply = cls.apply

        def counted(*a, _apply=apply, _key=key):
            calls[_key] += 1
            return _apply(*a)

        monkeypatch.setattr(cls, "apply", counted)
    geom = dict(img_size=128, in_chans=3, num_classes=5, embed_dim=16,
                depth=(1, 1, 1, 1), split_size=(1, 2, 2, 2), num_heads=(2, 2, 4, 8))
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 128, 128, 1)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 5, (2, 128, 128)).astype(np.int64))
    state = None
    results = []
    for impl in ("fused", "plain"):
        backbone = CSWinUNet(**geom, drop_path_rate=0.2, dtype=torch.float32, impl=impl)
        if state is None:
            state = backbone.state_dict()
        backbone.load_state_dict(state)
        model = CSwinUnet(backbone).train()
        gen = torch.Generator().manual_seed(4)
        loss, _ = segmentation_loss(model(x, generator=gen), y, 5)
        loss.backward()
        results.append((loss.item(), {k: p.grad for k, p in backbone.named_parameters()}))
    assert calls == {"block": 8, "tail": 1}
    (lk, gk), (lp, gp) = results
    assert lk == pytest.approx(lp, rel=1e-5)
    for k in gp:
        assert _rel_l2(gk[k].numpy(), gp[k].numpy()) <= 1e-4, k


def test_trainer_synapse_one_epoch(synapse, tmp_path):
    """1 epoch at bs 4 on the tiny geometry: the reference log-line format,
    and ``epoch_0.npz`` in the JAX format — the JAX loader reads it into the
    JAX model's parameter tree, the port loads it into its model."""
    class _Cfg:
        cfg = "cswin_unet_tpu/configs/cswin_tiny_224_lite.yaml"
        opts = ["MODEL.CSWIN.EMBED_DIM", "16", "MODEL.CSWIN.DEPTH", "[1,1,1,1]",
                "MODEL.CSWIN.NUM_HEADS", "[2,2,4,8]", "MODEL.CSWIN.SPLIT_SIZE",
                "[1,2,2,1]", "DATA.IMG_SIZE", "32"]

    from cswin_unet_tpu_torch.models import build_model

    cfg = get_config(_Cfg)
    model = build_model(cfg, num_classes=9, device="cpu", seed=0, train=True)
    args = argparse.Namespace(
        root_path=synapse["train_dir"], list_dir=synapse["list_dir"], num_classes=9,
        batch_size=4, n_gpu=1, max_epochs=1, base_lr=0.01, img_size=32, seed=1234,
        num_workers=2, device="cpu")
    out = tmp_path / "run"
    assert trainer_synapse(args, model, str(out)) == "Training Finished!"
    log = (out / "log.txt").read_text().splitlines()
    pat = re.compile(r"^\[\d\d:\d\d:\d\d\.\d{3}\] iteration (\d+) : loss : "
                     r"\d+\.\d{6}, loss_ce: \d+\.\d{6}$")
    its = [int(m[1]) for m in map(pat.match, log) if m]
    assert its == [1, 2, 3]
    ck = out / "epoch_0.npz"
    assert any(line.endswith(f"save model to {ck}") for line in log)

    tree, _ = jax_ckpt.load_checkpoint(str(ck))
    jm = jax_build_model(cfg, img_size=32, num_classes=9, attn_impl="xla")
    jparams = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))
    want = {k: v.shape for k, v in jax_ckpt.flatten(jparams).items()}
    assert {k: v.shape for k, v in jax_ckpt.flatten(tree).items()} == want

    flat, _ = load_checkpoint(str(ck))
    fresh = build_model(cfg, num_classes=9, device="cpu", seed=7)
    assert load_into(fresh.cswin_unet, flat) == len(fresh.cswin_unet.state_dict())
    for k, v in model.cswin_unet.state_dict().items():
        torch.testing.assert_close(fresh.cswin_unet.state_dict()[k], v)


def _tiny_config(*opts):
    from cswin_unet_tpu_torch.config import get_config as port_get_config

    class _Cfg:
        cfg = "cswin_unet_tpu_torch/configs/cswin_tiny_224_lite.yaml"

    _Cfg.opts = ["MODEL.CSWIN.EMBED_DIM", "16", "MODEL.CSWIN.DEPTH", "[1,1,1,1]",
                 "MODEL.CSWIN.NUM_HEADS", "[2,2,4,8]", "MODEL.CSWIN.SPLIT_SIZE",
                 "[1,2,2,2]", "DATA.IMG_SIZE", "128", "MODEL.DROP_PATH_RATE", "0.2",
                 *opts]
    return port_get_config(_Cfg)


@pytest.mark.parametrize("impl", ["plain", "fused"])
def test_use_checkpoint_gives_the_same_loss_and_gradients(monkeypatch, impl):
    """``TRAIN.USE_CHECKPOINT`` (``--use-checkpoint``) recomputes each block
    in the backward, as the JAX model's ``nn.remat``: on the CPU, with
    drop-path 0.2 live (its draws made outside the recomputed region), the
    loss and every gradient equal those without it bit for bit. At img 128
    every block trains through ``CSWinBlockFn`` on the fused route."""
    from cswin_unet_tpu_torch.models import build_model
    from cswin_unet_tpu_torch.models.cswin_unet import CSWinBlock

    runs = []
    body = CSWinBlock._block
    monkeypatch.setattr(CSWinBlock, "_block", lambda self, *a: runs.append(1) or body(self, *a))
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 128, 128, 1)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 5, (2, 128, 128)).astype(np.int64))
    results = []
    for flag in ("False", "True"):
        model = build_model(_tiny_config("TRAIN.USE_CHECKPOINT", flag), num_classes=5,
                            device="cpu", impl=impl, seed=3, train=True)
        blocks = [m for m in model.modules() if hasattr(m, "use_checkpoint")]
        assert blocks and all(b.use_checkpoint == (flag == "True") for b in blocks)
        loss, _ = segmentation_loss(model(x, generator=torch.Generator().manual_seed(6)), y, 5)
        names, params = zip(*model.named_parameters())
        results.append((loss.detach(), dict(zip(names, torch.autograd.grad(loss, params)))))
        results[-1] += (len(runs),)
        runs.clear()
    (l0, g0, n0), (l1, g1, n1) = results
    assert (n0, n1) == (8, 16)  # 8 blocks; each runs again in the backward
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_build_model_refuses_a_drop_rate():
    """``MODEL.DROP_RATE`` outside [0, 1] is refused; 0.1 builds and trains:
    a train step on the fused route (every block through ``CSWinBlockFn``)
    gives a finite loss and finite gradients, a different loss than rate 0
    from the same generator, and the same loss again from that generator."""
    from cswin_unet_tpu_torch.models import build_model

    with pytest.raises(ValueError, match="DROP_RATE"):
        build_model(_tiny_config("MODEL.DROP_RATE", "1.5"), device="cpu")
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((2, 128, 128, 1)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 5, (2, 128, 128)).astype(np.int64))
    losses = []
    for rate in ("0.1", "0.1", "0.0"):
        model = build_model(_tiny_config("MODEL.DROP_RATE", rate), num_classes=5,
                            device="cpu", seed=3, train=True)
        assert model.cswin_unet.drop_rate == float(rate)
        loss, _ = segmentation_loss(model(x, generator=torch.Generator().manual_seed(6)),
                                    y, 5)
        loss.backward()
        assert all(torch.isfinite(p.grad).all() for p in model.parameters())
        losses.append(loss.item())
    assert np.isfinite(losses).all() and losses[0] == losses[1] != losses[2]
