"""Legacy surgical fine-tuning: per-group RGN over an (lr, wd) grid.

Counterpart of ``cswin_unet_tpu.train.finetune`` (reference
``finetune.py:146-254``): a 1/5 subset of the data, loss 0.2·CE + 0.8·Dice,
Adam with weight decay whose per-group learning rates are recomputed every
batch as RGN / max over the architectural groups (stem / encoderN / mergeN
/ decoderN / upsampleN / concatN / bottleneck / norm_up / output), over the
grid (lr, wd) ∈ {1e-3, 1e-4, 1e-5} × {1e-4}, each cell from the same
starting weights. The reference rebuilds its Adam every batch, losing the
moments; ``rebuild_moments_every_batch=True`` (the default) does the same.

Data parallel under ``torchrun`` (``parallel``): every rank draws the same
subset and restores the same starting weights per cell, loads its shard of
each epoch at ``batch_size / world`` rows, and averages the step's and the
RGN pass's gradients over the ranks (``all_reduce_mean_``; they come from
``torch.autograd.grad``, which DDP's hooks never see); the logged loss is
the global batch's, and rank 0 alone writes the log and checkpoints.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from ..data import DataLoader, RandomGenerator, Subset, SynapseDataset, device_prefetch
from ..losses import cross_entropy_loss, dice_loss
from ..parallel import all_reduce_mean_, process_shard_info
from ..utils.checkpoint import save_checkpoint
from ..utils.logging_utils import setup_logging
from .surgical import (WeightedAdam, backbone_params, get_group_lr_weights,
                       group_weights_to_param_weights, make_grad_fn)

LR_WD_GRID = ((1e-3, 1e-4), (1e-4, 1e-4), (1e-5, 1e-4))


def make_finetune_step(model, num_classes: int, weight_decay: float):
    """(optimizer, step): ``step(image, label, weights, base_lr, generator)
    -> aux`` runs the student in its mode (drop-path from ``generator`` in
    train mode), 0.2·CE + 0.8·Dice, and Adam + ``weight_decay``·θ scaled by
    −base_lr·w per tensor (``weights`` by key; ``optimizer.init`` resets
    the moments)."""
    params = backbone_params(model)
    optimizer = WeightedAdam(list(params.values()), weight_decay=weight_decay)

    def step(image, label, weights: dict[str, float], base_lr: float,
             generator: torch.Generator | None) -> dict:
        logits = model(image, generator=generator)
        l_ce = cross_entropy_loss(logits, label)
        l_dice = dice_loss(logits, label, num_classes)
        total = 0.2 * l_ce + 0.8 * l_dice
        grads = all_reduce_mean_(torch.autograd.grad(total, list(params.values())))
        optimizer.step(grads, base_lr, [weights.get(k, 0.0) for k in params])
        return dict(zip(("loss", "loss_ce", "loss_dice"), all_reduce_mean_(
            [total.detach(), l_ce.detach(), l_dice.detach()])))

    return optimizer, step


def surgical_trainer(args, model, snapshot_path: str, *,
                     rebuild_moments_every_batch: bool = True) -> str:
    """The grid fine-tuning loop (reference finetune.py:146-254); ``model``
    is a ``CSwinUnet`` in train mode on ``args.device``."""
    rank, world = process_shard_info()
    if rank == 0:
        setup_logging(snapshot_path)
    logging.info(str(args))
    device = torch.device(args.device)

    full_db = SynapseDataset(
        base_dir=args.root_path, list_dir=args.list_dir, split="train",
        transform=RandomGenerator(output_size=[args.img_size, args.img_size]),
    )
    dataset_size = len(full_db)
    subset_size = dataset_size // 5
    rng_np = np.random.default_rng(args.seed)
    indices = rng_np.permutation(dataset_size)[:subset_size]
    db_train = Subset(full_db, indices.tolist())
    print(f"Using subset of {len(db_train)} samples (1/5 of original {dataset_size})")

    batch_size = args.batch_size
    if batch_size % world:
        raise ValueError(f"batch_size {batch_size} not divisible by {world} processes")
    trainloader = DataLoader(db_train, batch_size // world, shuffle=True, seed=args.seed,
                             num_workers=8, num_shards=world, shard_index=rank)

    params = backbone_params(model)
    init_params = {k: v.detach().clone() for k, v in params.items()}

    def seg_loss_for_rgn(logits, labels):
        return (0.2 * cross_entropy_loss(logits, labels)
                + 0.8 * dice_loss(logits, labels, args.num_classes))

    grad_fn = make_grad_fn(model, seg_loss_for_rgn)

    for lr, wd in LR_WD_GRID:
        with torch.no_grad():  # a fresh copy of the starting weights per cell
            for k, v in init_params.items():
                params[k].copy_(v)
        optimizer, step = make_finetune_step(model, args.num_classes, wd)
        generator = torch.Generator(device=device).manual_seed(args.seed)

        iter_num = 0
        for epoch in range(args.max_epochs):
            logging.info(f"Epoch: {epoch}")
            for batch in device_prefetch(iter(trainloader), device):
                if args.auto_tune == "RGN":
                    gw = get_group_lr_weights(model, batch, seg_loss_for_rgn,
                                              grad_fn=grad_fn)
                    max_w = max(gw.values()) if gw else 1.0
                    pw = group_weights_to_param_weights(
                        params, {k: v / max_w if max_w > 0 else 0.0 for k, v in gw.items()})
                    if iter_num % 50 == 0:
                        for name, w in sorted(gw.items()):
                            logging.info(f"RGN chosen parameters: {name} = {w * lr / max_w}")
                    if rebuild_moments_every_batch:
                        optimizer.init()
                else:
                    pw = {k: 1.0 for k in params}
                aux = step(batch["image"], batch["label"], pw, lr, generator)
                iter_num += 1
                logging.info(f"Loss: {float(aux['loss'])}")

            if rank == 0 and epoch % args.save_interval == 0:
                path = os.path.join(snapshot_path, f"model_lr{lr}_wd{wd}_epoch{epoch}.npz")
                save_checkpoint(path, model.cswin_unet.state_dict())
                logging.info(f"saved {path}")

    return "Surgical Training Finished!"
