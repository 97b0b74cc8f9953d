"""TPGM: trainable projected gradient fine-tuning.

Counterpart of ``cswin_unet_tpu.train.tpgm`` (reference
``universal_train.py:391-615``): one trainable scalar constraint per
parameter tensor; the projected weight is

    θ_proj = θ_anchor + α · (θ − θ_anchor),
    α = clamp(clamp(c, lo, hi) / (‖θ − θ_anchor‖ + 1e-8), 0, 1)

with ``variant="v3"`` (the one the reference uses) the permissive init
max(3, 2‖θ‖) (max(10, 5‖θ‖) for head layers) and ceilings max(8n, 80) /
max(10n, 100) over a floor 1e-2; with ``variant="v1"`` the init ‖θ −
θ_anchor‖ / 2 and the clamp (1e-8, n), MARS norms then row-wise over dims
1.. of the JAX layout (per-row ratios). Norms are whole-tensor l2 or MARS
(Σ|·|).

The constraints are optimized by gradient through the projection, with θ
and the anchor detached, by Adam after a global-norm clip at 1.0. The
forward runs the model on the projected weights
(``torch.func.functional_call``): they are non-leaf tensors that require
grad, so the blocks at resolution >= 28 take ``CSWinBlockFn`` and its
kernel backward, whose weight gradients reach the constraints.

Names are backbone ``state_dict`` keys; the head rule reads each key's JAX
name (``surgical.jax_name``).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import functional_call

from ..losses import cross_entropy_loss, dice_loss
from ..parallel import all_reduce_mean_
from .surgical import WeightedAdam, jax_layout, jax_name, torch_layout

BACKBONE = "cswin_unet."  # the CSwinUnet attribute that holds the backbone
HEAD_MARKERS = ("head", "final", "classifier", "output", "segmentation_head")


def _is_head(key: str, ndim: int) -> bool:
    name = jax_name(key, ndim).lower()
    return any(m in name for m in HEAD_MARKERS)


def _excluded(key: str, ndim: int, exclude) -> bool:
    """``exclude`` may name a tensor by its key or by its JAX name."""
    return key in exclude or jax_name(key, ndim) in exclude


def init_constraints(params: dict[str, torch.Tensor], exclude=(), *,
                     variant: str = "v3", anchor=None) -> dict[str, torch.Tensor]:
    """Per-tensor scalar constraints (float32, on the parameters' device).
    v3: max(3, 2‖θ‖), max(10, 5‖θ‖) for heads; v1: ‖θ − θ_anchor‖ / 2 (0
    without an anchor). Norms in float64."""
    names = [k for k, v in params.items() if not _excluded(k, v.ndim, exclude)]
    if not names:
        return {}
    norms = []
    for k in names:
        v = params[k].detach().double()
        if variant == "v1":
            v = v - anchor[k].detach().double() if anchor is not None else v * 0.0
        norms.append(v.norm())
    out = {}
    for k, n in zip(names, torch.stack(norms).cpu().tolist()):
        if variant == "v1":
            init = n / 2.0
        elif _is_head(k, params[k].ndim):
            init = max(10.0, n * 5.0)
        else:
            init = max(3.0, n * 2.0)
        out[k] = torch.tensor(init, dtype=torch.float32, device=params[k].device)
    return out


def project(params: dict[str, torch.Tensor], anchor: dict[str, torch.Tensor],
            constraints: dict[str, torch.Tensor], *, norm_mode: str = "l2",
            variant: str = "v3"):
    """θ_anchor + α·(θ − θ_anchor) per constrained tensor, differentiable in
    ``constraints`` only (θ and the anchor detached; unconstrained tensors
    pass through detached). Returns (projected params, {key: mean ratio})."""
    out, ratios = {}, {}
    for name, theta in params.items():
        theta = theta.detach()
        if name not in constraints:
            out[name] = theta
            continue
        theta_a = anchor[name].detach().to(theta.dtype)
        tf = (theta - theta_a).float()
        if "l2" in norm_mode:
            n = torch.linalg.vector_norm(tf)
        elif variant == "v1" and tf.ndim > 1:
            tj = jax_layout(tf)  # rows of the JAX layout
            n = torch_layout(tj.abs().sum(dim=tuple(range(1, tj.ndim)), keepdim=True))
        else:
            n = tf.abs().sum()
        n_max = n.max()
        if variant == "v1":
            c = torch.clamp(constraints[name], min=torch.full_like(n_max, 1e-8), max=n_max)
        else:
            ceil = (torch.clamp(n_max * 10.0, min=100.0) if _is_head(name, theta.ndim)
                    else torch.clamp(n_max * 8.0, min=80.0))
            c = torch.clamp(constraints[name], min=torch.full_like(ceil, 1e-2), max=ceil)
        ratio = torch.clamp(c / (n + 1e-8), 0.0, 1.0)
        ratios[name] = ratio.mean()
        out[name] = theta_a + (ratio * tf).to(theta.dtype)
    return out, ratios


def ratio_stats(ratios: dict) -> tuple[float, float, float]:
    """(min, max, mean) of the ratios, one host copy."""
    if not ratios:
        return 0.0, 0.0, 0.0
    vals = torch.stack([torch.as_tensor(v).float().cpu() for v in ratios.values()])
    return float(vals.min()), float(vals.max()), float(vals.mean())


class TPGMTrainer:
    """Constraint optimization over a ``CSwinUnet``'s backbone parameters
    (reference tpgm_trainer, universal_train.py:518-615): the anchor is a
    copy of ``params`` at construction; ``optimize`` runs ``max_iters``
    constraint steps in eval mode on the projected weights, ``apply``
    returns the projection."""

    def __init__(self, model, params: dict[str, torch.Tensor], *, norm_mode: str = "l2",
                 proj_lr: float = 0.01, max_iters: int = 200,
                 active_classes: int | None = None, exclude=(), enabled: bool = True,
                 loss_fn: Callable | None = None, label_map: Callable | None = None,
                 variant: str = "v3"):
        self.model = model
        self.enabled = enabled
        self.norm_mode = norm_mode
        self.max_iters = max_iters
        self.variant = variant
        self.proj_lr = proj_lr
        self.active_classes = active_classes
        self.label_map = label_map
        self.anchor = {k: v.detach().clone() for k, v in params.items()}
        if not enabled:
            return
        self.constraints = init_constraints(params, exclude, variant=variant,
                                            anchor=self.anchor)
        self.optimizer = WeightedAdam(list(self.constraints.values()), clip_norm=1.0)
        if loss_fn is None:
            def loss_fn(logits, labels):
                nc = logits.shape[-1]
                return (0.4 * cross_entropy_loss(logits, labels)
                        + 0.6 * dice_loss(logits, labels, nc))
        self.loss_fn = loss_fn

    def constraint_grads(self, params: dict[str, torch.Tensor], image: torch.Tensor,
                         label: torch.Tensor):
        """The loss on the projected weights and its gradient with respect to
        each constraint, the model in eval mode (its mode restored after).
        Under a process group the loss and the gradients are averaged over
        the ranks (``image`` and ``label`` are this rank's shard). Returns
        (loss, ratios, gradients), on the device."""
        leaves = {k: c.detach().requires_grad_() for k, c in self.constraints.items()}
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.enable_grad():
                proj, ratios = project(params, self.anchor, leaves,
                                       norm_mode=self.norm_mode, variant=self.variant)
                logits = functional_call(
                    self.model, {BACKBONE + k: v for k, v in proj.items()}, (image,))
                if self.active_classes is not None:
                    logits = logits[..., :self.active_classes]
                loss = self.loss_fn(logits, label)
                grads = torch.autograd.grad(loss, list(leaves.values()))
        finally:
            self.model.train(was_training)
        loss = loss.detach()
        all_reduce_mean_([loss, *grads])
        return loss, {k: r.detach() for k, r in ratios.items()}, dict(zip(leaves, grads))

    def step(self, params: dict[str, torch.Tensor], image: torch.Tensor,
             label: torch.Tensor):
        """One constraint update on one batch. Returns (loss, ratios), on the
        device."""
        loss, ratios, grads = self.constraint_grads(params, image, label)
        self.optimizer.step(list(grads.values()), self.proj_lr)
        return loss, ratios

    def optimize(self, params: dict[str, torch.Tensor], data_iter, log=print,
                 ratio_logger=None):
        """``max_iters`` constraint steps over ``data_iter`` (dicts of
        ``image`` and ``label`` tensors on the model's device). Logs as the
        reference does; ``ratio_logger`` receives the ratio statistics
        (the reference's tpgm_ratios.log)."""
        if not self.enabled:
            log("TPGM is disabled - skipping")
            return None
        initial = self._constraint_values()
        count, loss, ratios = 0, None, None
        while count < self.max_iters:
            batch = next(data_iter)
            label = batch["label"]
            if self.label_map is not None:
                label = self.label_map(label)
            loss, ratios = self.step(params, batch["image"], label)
            count += 1
            if (count + 1) % 50 == 0:
                mn, mx, mean = ratio_stats(ratios)
                log(f"TPGM {count}/{self.max_iters} - Loss: {float(loss):.4f}, "
                    f"Mean ratio: {mean:.4f}")
                if ratio_logger is not None:
                    ratio_logger.info(f"iter {count}: loss {float(loss):.6f} ratio "
                                      f"min/mean/max {mn:.4f}/{mean:.4f}/{mx:.4f}")
        final = self._constraint_values()
        change = sum(abs(final[k] - initial[k]) for k in final) / max(1, len(final))
        log(f"TPGM optimization complete. Average constraint change: {change:.6f}")
        if ratio_logger is not None and ratios is not None:
            host = dict(zip(ratios, torch.stack(list(ratios.values())).cpu().tolist()))
            for name, r in sorted(host.items()):
                ratio_logger.info(f"ratio {name}: {r:.6f}")
        return ratios

    def _constraint_values(self) -> dict[str, float]:
        if not self.constraints:
            return {}
        vals = torch.stack(list(self.constraints.values())).cpu().tolist()
        return dict(zip(self.constraints, vals))

    @torch.no_grad()
    def apply(self, params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """The final projection of ``params`` (detached tensors)."""
        if not self.enabled:
            return {k: v.detach() for k, v in params.items()}
        return project(params, self.anchor, self.constraints, norm_mode=self.norm_mode,
                       variant=self.variant)[0]
