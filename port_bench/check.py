"""The numbers that decide ``correct``, each worked out against the plain
reference (``reference``), which gets the benchmark's weights and inputs
and works out again whatever the program derived from them.

Training (the first ``checked_steps`` steps of the timed step object):
  * ``loss_gap``: the largest |program − reference| / |reference| of each
    step's loss;
  * ``grad_gap``: the first gradient as the optimizer holds it (SGD's
    momentum buffer after one step, g + wd·p), by the worst leaf: the gap
    between the two norms of the leaf, over the larger of the reference's
    norm of that leaf and of the median leaf;
  * ``change_gap``: the same for each leaf's change over the checked steps,
    leaving out the leaves whose reference gradient is under a thousandth
    of the median leaf's (rounding moves them, not the loss).

Serving: ``logit_gap``, the widest gap by which the reference's logit of the
label the program served lies below the reference's best logit, over every
pixel of the sampled volumes; a label outside the classes reads infinite.
"""

from __future__ import annotations

import statistics

import torch

from . import reference as R


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    med = statistics.median(ref.values())
    names = [k for k in ref if keep is None or k in keep]
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in names}


def train_gaps(prog: dict, ref: dict, *, worst: bool = False) -> dict:
    """The compared numbers; with ``worst`` also the leaf that sets each
    leaf gap (``grad_leaf``, ``change_leaf``)."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    raw = ref["raw_grad_norms"]
    med = statistics.median(raw.values())
    moved = {k for k, v in raw.items() if v >= 1e-3 * med}
    grad = leaf_gaps(prog["grad_norms"], ref["grad_norms"])
    change = leaf_gaps(prog["change_norms"], ref["change_norms"], moved)
    out = {"loss_gap": max(losses), "grad_gap": max(grad.values()),
           "change_gap": max(change.values())}
    if worst:
        out.update(grad_leaf=max(grad, key=grad.get), change_leaf=max(change, key=change.get))
    return out


def reference_train(cfg: dict, traffic: dict, weights: dict, batches: list, generator,
                    *, rows: int, control: bool = False, steps: int | None = None) -> dict:
    """The reference's readings over the first ``steps`` steps (default the
    traffic's ``checked_steps``) from ``weights`` (updated in place) on
    ``batches``, drop-path drawn from ``generator``; with ``control``, of
    the control of the configuration's ``compute_dtype`` instead."""
    num = R.Numerics(cfg["compute_dtype"] if control else None)
    steps = steps or traffic["checked_steps"]
    w0 = {k: v.clone() for k, v in weights.items()}
    momentum: dict = {}
    out = {"losses": []}
    wd = traffic["weight_decay"]
    with num.exact():
        for k in range(steps):
            image, label = batches[k]
            dps = R.draw_drop_path(cfg, cfg["drop_path_rate"], image.shape[0], generator)
            loss, grads = R.train_step(num, weights, cfg, image, label, dps, rows=rows)
            out["losses"].append(loss)
            if k == 0:
                out["raw_grad_norms"] = {n: float(g.norm()) for n, g in grads.items()}
                out["grad_norms"] = {n: float((g + wd * weights[n]).norm())
                                     for n, g in grads.items()}
            R.sgd_update(weights, grads, momentum,
                         R.poly_lr(k, traffic["base_lr"], traffic["max_iterations"]),
                         mu=traffic["momentum"], weight_decay=wd)
            del grads
    out["change_norms"] = {n: float((weights[n] - w0[n]).norm()) for n in weights}
    return out


@torch.no_grad()
def serve_gap(cfg: dict, weights: dict, volumes: list, labels: list, device, *,
              rows: int, control: bool = False) -> float:
    """The widest logit gap of the served ``labels`` of ``volumes``; with
    ``control`` the gap of the labels that the control of the
    configuration's ``compute_dtype`` puts first instead."""
    exact, low = R.Numerics(), R.Numerics(cfg["compute_dtype"])
    nc, worst = cfg["num_classes"], 0.0
    with exact.exact():
        for vol, lab in zip(volumes, labels):
            for r0 in range(0, vol.shape[0], rows):
                x = torch.from_numpy(vol[r0:r0 + rows]).to(device)[..., None]
                ref = R.forward(exact, weights, cfg, x)
                if control:
                    served = R.forward(low, weights, cfg, x).argmax(-1)
                else:
                    served = torch.from_numpy(lab[r0:r0 + rows]).to(device).long()
                    if bool(((served < 0) | (served >= nc)).any()):
                        return float("inf")
                gap = ref.amax(-1) - ref.gather(-1, served[..., None])[..., 0]
                worst = max(worst, float(gap.max()))
    return worst
