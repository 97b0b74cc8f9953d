"""Surgical fine-tuning: per-tensor learning rates from gradient statistics.

Counterpart of ``cswin_unet_tpu.train.surgical`` (reference
``universal_train.py:626-748``):

  * layer set: every parameter whose name holds neither "bn" nor "norm";
  * a per-tensor metric over ``gradient_batches`` batches of the task loss,
    in eval mode (no drop-path) with gradients on: RGN ‖g‖ / ‖θ‖, or the
    eb-criterion mean(g² / Var(g, axis 0)), averaged over the batches;
  * per epoch, RGN weights are divided by their maximum and eb weights
    binarized at 0.95;
  * the optimizer clips the global gradient norm to 1.0, then Adam, then
    adds 0.01·θ, then scales each tensor by −lr(epoch)·w (w = 0 freezes
    it); its moments are rebuilt every epoch; lr follows a cosine over
    epochs.

Names are the port's backbone ``state_dict`` keys (``stage1.0.qkv.weight``).
The name rules (the filter, the architectural groups) and the layout rule
(the eb-criterion's axis 0) are the JAX package's, applied to each key's
JAX name and layout (``utils.checkpoint._jax_key`` / ``_jax_layout``), so a
tensor gets the weight JAX gives it: the stem's LayerNorm is
``stage1_conv_embed.2`` here and ``stage1_conv_embed_norm`` there, and axis
0 of a Linear weight is ``out`` here and ``in`` there.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..parallel import all_reduce_mean_
from ..utils.checkpoint import SEP, _jax_key

def backbone_params(model) -> dict[str, torch.nn.Parameter]:
    """The backbone's parameters of a ``CSwinUnet``, by ``state_dict`` key."""
    return dict(model.cswin_unet.named_parameters())


def jax_name(key: str, ndim: int) -> str:
    """The JAX package's flat name of a backbone key, with its envelope."""
    return f"params{SEP}backbone{SEP}" + _jax_key(key, ndim)


def jax_layout(t: torch.Tensor) -> torch.Tensor:
    """A torch-layout tensor viewed in the flax layout: Linear (out, in) as
    (in, out), conv OIHW as HWIO (``utils.checkpoint._jax_layout``)."""
    if t.ndim == 2:
        return t.t()
    if t.ndim == 4:
        return t.permute(2, 3, 1, 0)
    return t


def torch_layout(t: torch.Tensor) -> torch.Tensor:
    """Inverse of ``jax_layout``."""
    if t.ndim == 2:
        return t.t()
    if t.ndim == 4:
        return t.permute(3, 2, 0, 1)
    return t


def surgical_layer_names(params: dict[str, torch.Tensor]) -> list[str]:
    """Names eligible for surgical tuning (the JAX name holds no "bn" and
    no "norm")."""
    return [k for k, v in params.items()
            if "bn" not in jax_name(k, v.ndim).lower()
            and "norm" not in jax_name(k, v.ndim).lower()]


def make_grad_fn(model, loss_fn: Callable):
    """``grad_fn(image, label) -> {name: gradient}`` of ``loss_fn(logits,
    label)`` over the backbone's parameters, the model in eval mode (no
    drop-path) with gradients on; the model's mode is restored after. Under
    a process group the gradients are averaged over the ranks (the global
    batch's, DDP's convention) before any norm is taken of them."""
    params = backbone_params(model)

    def grad_fn(image: torch.Tensor, label: torch.Tensor) -> dict[str, torch.Tensor]:
        was_training = model.training
        model.eval()
        try:
            with torch.enable_grad():
                loss = loss_fn(model(image), label)
                grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        finally:
            model.train(was_training)
        grads = all_reduce_mean_(torch.zeros_like(p) if g is None else g
                                 for p, g in zip(params.values(), grads))
        return dict(zip(params, grads))

    return grad_fn


def _to_device(device, batch: dict, label_map):
    image = torch.as_tensor(batch["image"], device=device)
    label = torch.as_tensor(batch["label"], device=device)
    return image, (label_map(label) if label_map is not None else label)


def get_lr_weights(model, batches, loss_fn: Callable, *, method: str = "RGN",
                   label_map: Callable | None = None, grad_fn=None) -> dict[str, float]:
    """Per-tensor gradient metric of the surgical layers, averaged over
    ``batches`` (dicts of ``image`` and ``label``, numpy or tensors). The
    metrics are float64 on the model's device, one host copy a batch."""
    if grad_fn is None:
        grad_fn = make_grad_fn(model, loss_fn)
    params = backbone_params(model)
    device = next(iter(params.values())).device
    names = [k for k in surgical_layer_names(params)
             if method != "eb-criterion" or params[k].ndim > 0]
    sums, count = None, 0
    for batch in batches:
        grads = grad_fn(*_to_device(device, batch, label_map))
        vals = []
        for name in names:
            g = grads[name].double()
            if method == "eb-criterion":
                g = jax_layout(g)
                var = (g.var(dim=0, keepdim=True, unbiased=True) if g.shape[0] > 1
                       else torch.zeros_like(g))
                vals.append((g * g / (var + 1e-8)).mean())
            else:  # RGN
                pn = params[name].detach().double().norm()
                vals.append(torch.where(pn > 1e-8, g.norm() / pn, torch.zeros_like(pn)))
        row = torch.stack(vals).cpu()
        sums = row if sums is None else sums + row
        count += 1
    if not count:
        return {}
    return dict(zip(names, (sums / count).tolist()))


def normalize_weights(weights: dict[str, float], method: str) -> dict[str, float]:
    """Per-epoch post-processing: eb weights binarized at 0.95, RGN weights
    divided by their maximum (reference :876-891)."""
    if not weights:
        return {}
    if method == "eb-criterion":
        threshold = 0.95
        return {k: (1.0 if v >= threshold else 0.0) for k, v in weights.items()}
    max_w = max(weights.values())
    if max_w <= 0:
        return {k: 0.0 for k in weights}
    return {k: v / max_w for k, v in weights.items()}


_GROUP_PATTERNS = (
    ("stage1_conv_embed", "stem"),
    ("stage_up1", "decoder1"), ("stage_up2", "decoder2"),
    ("stage_up3", "decoder3"), ("stage_up4", "decoder4"),
    ("stage1", "encoder1"), ("stage2", "encoder2"),
    ("stage3", "encoder3"), ("stage4", "encoder4"),
    ("merge1", "merge1"), ("merge2", "merge2"), ("merge3", "merge3"),
    ("upsample1", "upsample1"), ("upsample2", "upsample2"),
    ("upsample3", "upsample3"), ("upsample4", "upsample4"),
    ("concat_linear2", "concat2"), ("concat_linear3", "concat3"),
    ("concat_linear4", "concat4"),
    ("norm_up", "norm_up"), ("norm", "bottleneck"), ("output", "output"),
)


def parameter_group_of(key: str) -> str:
    """Architectural group of a backbone key (reference finetune.py:77-113):
    stem / encoderN / mergeN / bottleneck / decoderN / upsampleN / concatN /
    norm_up / output, by the first component of its JAX name."""
    head = _jax_key(key, 0).split(SEP)[0]
    for prefix, group in _GROUP_PATTERNS:
        if head.startswith(prefix):
            return group
    return "other"


def get_group_lr_weights(model, batch, loss_fn, *, grad_fn=None,
                         label_map=None) -> dict[str, float]:
    """Per-group gradient norms from one batch, normalized to sum 1
    (reference finetune.py:115-144): a group's norm is sqrt(Σ‖g‖²) over its
    tensors, all parameters counted."""
    if grad_fn is None:
        grad_fn = make_grad_fn(model, loss_fn)
    params = backbone_params(model)
    device = next(iter(params.values())).device
    grads = grad_fn(*_to_device(device, batch, label_map))
    names = list(grads)
    sq = torch.stack([grads[k].double().square().sum() for k in names]).cpu().tolist()
    per_group: dict[str, float] = {}
    for name, v in zip(names, sq):
        group = parameter_group_of(name)
        per_group[group] = per_group.get(group, 0.0) + v
    norms = {k: math.sqrt(v) for k, v in per_group.items()}
    total = sum(norms.values())
    if total <= 0:
        return {k: 0.0 for k in norms}
    return {k: v / total for k, v in norms.items()}


def group_weights_to_param_weights(params: dict[str, torch.Tensor],
                                   group_weights: dict[str, float]) -> dict[str, float]:
    """Group weights spread to every parameter of the group."""
    return {name: group_weights.get(parameter_group_of(name), 0.0) for name in params}


def cosine_epoch_lr(base_lr: float, max_epochs: int) -> Callable[[int], float]:
    """torch ``CosineAnnealingLR(T_max=max_epochs)``, stepped per epoch."""

    def schedule(epoch):
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * epoch / max_epochs))

    return schedule


class WeightedAdam:
    """optax's ``chain(clip_by_global_norm(clip_norm), scale_by_adam(),
    add_decayed_weights(weight_decay))`` followed by a per-tensor scale
    −lr·w, applied in place: Adam b1 0.9, b2 0.999, eps 1e-8 with bias
    correction; the clip scales the gradients by clip_norm / ‖g‖ where the
    global norm ‖g‖ reaches clip_norm (``clip_norm=None``: no clip). A
    tensor of weight 0 stays unchanged while its moments advance, as in
    optax. ``init`` zeroes the moments and the step count."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params: list[torch.Tensor], *, weight_decay: float = 0.0,
                 clip_norm: float | None = None):
        self.params = list(params)
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.init()

    def init(self) -> None:
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor], lr: float,
             weights: list[float] | None = None) -> None:
        grads = [g.to(p.dtype) for g, p in zip(grads, self.params)]
        if self.clip_norm is not None:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            scale = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                                self.clip_norm / norm)
            grads = torch._foreach_mul(grads, scale)
        self.count += 1
        torch._foreach_mul_(self.mu, self.B1)
        torch._foreach_add_(self.mu, grads, alpha=1 - self.B1)
        torch._foreach_mul_(self.nu, self.B2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - self.B2)
        bc1, bc2 = 1 - self.B1 ** self.count, 1 - self.B2 ** self.count
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
        torch._foreach_add_(denom, self.EPS)
        upd = torch._foreach_div(torch._foreach_div(self.mu, bc1), denom)
        if self.weight_decay:
            torch._foreach_add_(upd, self.params, alpha=self.weight_decay)
        weights = [1.0] * len(self.params) if weights is None else weights
        live = [i for i, w in enumerate(weights) if w != 0.0]
        if live:
            scaled = torch._foreach_mul([upd[i] for i in live],
                                        [lr * weights[i] for i in live])
            torch._foreach_sub_([self.params[i] for i in live], scaled)


class SurgicalOptimizer:
    """AdamW with per-tensor lr weights, moments rebuilt by ``init`` every
    epoch, cosine LR over epochs, global-norm clip 1.0 (the JAX
    ``SurgicalOptimizer``'s optax chain, ``WeightedAdam``). ``params``: the
    backbone's parameters by key; ``step`` takes the gradients by key and
    the weights by key (an absent key weighs 0: frozen)."""

    def __init__(self, params: dict[str, torch.Tensor], base_lr: float,
                 max_epochs: int, *, weight_decay: float = 0.01, clip_norm: float = 1.0):
        self.names = list(params)
        self.base_lr = base_lr
        self.schedule = cosine_epoch_lr(base_lr, max_epochs)
        self._adam = WeightedAdam(list(params.values()), weight_decay=weight_decay,
                                  clip_norm=clip_norm)

    def init(self) -> None:
        self._adam.init()

    def step(self, grads: dict[str, torch.Tensor], weights: dict[str, float],
             epoch: int) -> None:
        self._adam.step([grads[k] for k in self.names], self.schedule(epoch),
                        [weights.get(k, 0.0) for k in self.names])


def log_layer_learning_rates(weights: dict[str, float], base_lr: float, logger, *,
                             stage: int, method: str) -> None:
    """The reference's table (:728-748)."""
    logger.info("\n" + "=" * 80)
    logger.info(
        f"CONTINUAL LEARNING STAGE {stage} - SURGICAL FINE-TUNING - {method.upper()} METHOD"
    )
    logger.info("=" * 80)
    logger.info(f"{'Layer Name':<50} {'Weight':<12} {'Learning Rate':<15}")
    logger.info("-" * 80)
    items = sorted(weights.items(), key=lambda kv: kv[1] * base_lr, reverse=True)
    active = 0
    for name, w in items:
        lr = w * base_lr
        status = "ACTIVE" if lr > 0 else "FROZEN"
        if lr > 0:
            active += 1
        logger.info(f"{name:<50} {w:<12.6f} {lr:<15.8f} [{status}]")
    logger.info("-" * 80)
    logger.info(
        f"Total layers: {len(items)}, Active layers: {active}, "
        f"Frozen layers: {len(items) - active}"
    )
    logger.info("=" * 80 + "\n")
