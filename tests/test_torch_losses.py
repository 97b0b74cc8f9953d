"""The port's losses against ``cswin_unet_tpu.losses`` on the same logits
and labels (numpy, from a seed), value and gradient with respect to the
logits. All losses compute in float32: rtol = 1e-5, atol = 1e-6 (summation
order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cswin_unet_tpu import losses as JL
from cswin_unet_tpu_torch import losses as TL

torch.set_num_threads(2)

NC = 5


@pytest.fixture
def data():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 6, 7, NC)) * 2).astype(np.float32)
    teacher = (rng.standard_normal((2, 6, 7, NC)) * 2).astype(np.float32)
    labels = rng.integers(0, NC, (2, 6, 7)).astype(np.int32)
    weights = rng.uniform(0.5, 2.0, NC).astype(np.float32)
    return logits, teacher, labels, weights


CASES = {
    "ce": (lambda l, t, y, w: JL.cross_entropy_loss(l, y),
           lambda l, t, y, w: TL.cross_entropy_loss(l, y)),
    "ce_weighted": (lambda l, t, y, w: JL.cross_entropy_loss(l, y, w),
                    lambda l, t, y, w: TL.cross_entropy_loss(l, y, w)),
    "dice": (lambda l, t, y, w: JL.dice_loss(l, y, NC),
             lambda l, t, y, w: TL.dice_loss(l, y, NC)),
    "dice_weighted": (lambda l, t, y, w: JL.dice_loss(l, y, NC, w),
                      lambda l, t, y, w: TL.dice_loss(l, y, NC, w)),
    "focal": (lambda l, t, y, w: JL.focal_loss(l, y),
              lambda l, t, y, w: TL.focal_loss(l, y)),
    "focal_weighted": (lambda l, t, y, w: JL.focal_loss(l, y, alpha=0.5, gamma=2.0,
                                                        class_weights=w),
                       lambda l, t, y, w: TL.focal_loss(l, y, alpha=0.5, gamma=2.0,
                                                        class_weights=w)),
    "kd": (lambda l, t, y, w: JL.kd_loss(l, t, 3.0),
           lambda l, t, y, w: TL.kd_loss(l, t, 3.0)),
    "segmentation": (lambda l, t, y, w: JL.segmentation_loss(l, y, NC)[0],
                     lambda l, t, y, w: TL.segmentation_loss(l, y, NC)[0]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_loss_matches_jax(data, name):
    logits, teacher, labels, weights = data
    jfn, tfn = CASES[name]
    j_args = (jnp.asarray(teacher), jnp.asarray(labels), jnp.asarray(weights))
    want, want_g = jax.value_and_grad(lambda l: jfn(l, *j_args))(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    got = tfn(lt, torch.from_numpy(teacher), torch.from_numpy(labels),
              torch.from_numpy(weights))
    got.backward()
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-6)


def test_segmentation_loss_parts_and_bf16_logits(data):
    logits, _, labels, _ = data
    total, aux = TL.segmentation_loss(torch.from_numpy(logits).bfloat16(),
                                      torch.from_numpy(labels), NC)
    jt, jaux = JL.segmentation_loss(jnp.asarray(logits).astype(jnp.bfloat16),
                                    jnp.asarray(labels), NC)
    assert total.dtype == torch.float32
    for k in ("loss", "loss_ce", "loss_dice"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-5)
    np.testing.assert_allclose(total.item(), 0.4 * aux["loss_ce"].item()
                               + 0.6 * aux["loss_dice"].item(), rtol=1e-6)
