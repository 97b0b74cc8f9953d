"""Segmentation losses over NHWC logits and integer labels, in float32.

Counterpart of ``cswin_unet_tpu.losses``, formula for formula:
  * soft Dice over all classes including background, per class
    (2·Σpq + ε)/(Σp² + Σq² + ε) with ε = 1e-5, averaged over classes, the
    sums running over batch and pixels jointly;
  * pixel-mean cross entropy; with class weights torch's weighted mean
    Σ w_y·CE / Σ w_y;
  * focal loss α·(1 − pt)^γ·CE as the reference computes it, with its
    non-finite fallbacks;
  * KD loss KL(softmax(old/T) ‖ softmax(new/T))·T², batchmean over the
    leading axis;
  * ``segmentation_loss`` = 0.4·CE + 0.6·Dice from one shared softmax.

Under a data-parallel process group the Dice sums (Σpq, Σp², Σq per class)
are summed over the ranks (``parallel.all_reduce_sum``) before the ratio,
so every rank computes the global batch's Dice, as one process on the whole
batch does; the per-rank means (CE, focal, KD's batchmean) need nothing:
each rank holds an equal share and DDP averages them. Without a process
group the code path is unchanged.

Logits (B, H, W, C) of any float dtype; labels (B, H, W) integer. Every loss
reduces to a float32 scalar.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .parallel import all_reduce_sum, world_size


def _log_softmax(logits: torch.Tensor):
    """(log p, p) over the class axis (last), float32, one exp/sum pass."""
    x = logits.float()
    s = x - x.amax(-1, keepdim=True)
    e = torch.exp(s)
    z = e.sum(-1, keepdim=True)
    return s - torch.log(z), e / z


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    return F.one_hot(labels.long(), num_classes).float()


def _dice_from_probs(probs, onehot, num_classes, class_weights):
    axes = tuple(range(probs.ndim - 1))
    smooth = 1e-5
    intersect = (probs * onehot).sum(axes)
    z = (probs * probs).sum(axes)
    y = onehot.sum(axes)  # target² == target for one-hot
    if world_size() > 1:  # the global batch's sums, on every rank
        intersect, z, y = all_reduce_sum(torch.stack([intersect, z, y])).unbind(0)
    per_class = 1.0 - (2.0 * intersect + smooth) / (z + y + smooth)
    if class_weights is not None:
        per_class = per_class * class_weights.float()
    return per_class.sum() / num_classes


def dice_loss(logits: torch.Tensor, labels: torch.Tensor, num_classes: int,
              class_weights: torch.Tensor | None = None, *,
              apply_softmax: bool = True) -> torch.Tensor:
    """Soft Dice averaged over all classes (background included)."""
    probs = _log_softmax(logits)[1] if apply_softmax else logits.float()
    return _dice_from_probs(probs, one_hot(labels, num_classes), num_classes,
                            class_weights)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       class_weights: torch.Tensor | None = None) -> torch.Tensor:
    """Pixel cross entropy; with class weights Σ w_y·CE / Σ w_y."""
    logp, _ = _log_softmax(logits)
    onehot = one_hot(labels, logits.shape[-1])
    nll = -(logp * onehot).sum(-1)
    if class_weights is None:
        return nll.mean()
    w = (onehot * class_weights.float()).sum(-1)
    return (w * nll).sum() / torch.clamp(w.sum(), min=1e-12)


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, *, alpha: float = 1.0,
               gamma: float = 4.0,
               class_weights: torch.Tensor | None = None) -> torch.Tensor:
    """Per-pixel (weighted) CE, pt = exp(−CE), mean of α·(1 − pt)^γ·CE;
    non-finite CE values fall back to small/large constants and a
    non-finite result to 1e-3."""
    num_classes = logits.shape[-1]
    labels = labels.clamp(0, num_classes - 1)
    logp, _ = _log_softmax(logits)
    onehot = one_hot(labels, num_classes)
    ce = -(logp * onehot).sum(-1)
    if class_weights is not None:
        ce = ce * (onehot * class_weights.float()).sum(-1)
    ce = torch.nan_to_num(ce, nan=1e-6, posinf=10.0, neginf=1e-6)
    pt = torch.exp(-ce)
    result = (alpha * (1.0 - pt) ** gamma * ce).mean()
    return torch.where(torch.isfinite(result), result, result.new_tensor(1e-3))


def kd_loss(logits: torch.Tensor, teacher_logits: torch.Tensor,
            temperature: float = 3.0) -> torch.Tensor:
    """KL(teacher ‖ student) at temperature T, times T², divided by the
    batch size only (spatial positions are summed)."""
    t = temperature
    logp, _ = _log_softmax(logits.float() / t)
    logq, q = _log_softmax(teacher_logits.float() / t)
    return (q * (logq - logp)).sum() / logits.shape[0] * (t * t)


def segmentation_loss(logits: torch.Tensor, labels: torch.Tensor,
                      num_classes: int, *, ce_weight: float = 0.4,
                      dice_weight: float = 0.6):
    """The base training loss 0.4·CE + 0.6·Dice from one shared softmax.
    Returns (total, {"loss", "loss_ce", "loss_dice"})."""
    logp, probs = _log_softmax(logits)
    onehot = one_hot(labels, num_classes)
    l_ce = (-(logp * onehot).sum(-1)).mean()
    l_dice = _dice_from_probs(probs, onehot, num_classes, None)
    total = ce_weight * l_ce + dice_weight * l_dice
    return total, {"loss": total, "loss_ce": l_ce, "loss_dice": l_dice}
