"""Base trainer: SGD + momentum, poly LR decay, 0.4·CE + 0.6·Dice.

Counterpart of ``cswin_unet_tpu.train.trainer`` (reference
``trainer_synapse``): SGD(momentum 0.9, weight decay 1e-4), per-iteration
poly decay ``lr = base·(1 − iter/max_iter)^0.9``, loss 0.4·CE + 0.6·Dice,
TensorBoard scalars every iteration and image triptychs every 20,
checkpoints every 3 epochs after the halfway point plus the final epoch, in
the JAX package's ``.npz`` format, each with ``train_state.pt`` beside it
(``args.resume`` continues from one exactly), and the same log-line format.

On one explicit device: batches come from a threaded host loader and are
copied one batch ahead (``data.device_prefetch``); drop-path masks come
from one ``torch.Generator`` on that device, seeded from ``--seed``; metrics
reach the host every 20 steps (``MetricBuffer``), so the loop does not wait
for the device per step. With ``args.device_augment`` the host only resizes
(``EvalResize``) and the step augments the batch on the device
(``ops.augment.augment_batch``) before the forward, its draws from the same
generator, as the JAX trainer does in its jitted step.

Data parallel (``torchrun``, one process per GPU; ``parallel``): the model
runs inside ``DistributedDataParallel``, each rank loads its shard of every
epoch (``DataLoader(num_shards=world, shard_index=rank)``) at
``batch_size · n_gpu / world`` rows, draws drop-path and augmentation for
the global batch and keeps its rows, and the Dice sums are the global
batch's (``losses``): a step equals one process's step on the ranks'
concatenated batches. The logged losses are the global batch's, averaged
over the ranks where ``MetricBuffer`` flushes. Rank 0 alone writes the log
file, TensorBoard, the checkpoints and ``train_state.pt`` (the unwrapped
model's keys), between barriers; ``args.resume`` loads on every rank.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from ..data import DataLoader, EvalResize, RandomGenerator, SynapseDataset, device_prefetch
from ..losses import segmentation_loss
from ..ops.augment import augment_batch
from ..parallel import multihost_barrier, process_shard_info, wrap_ddp
from ..utils.checkpoint import (TRAIN_STATE, restore_train_state, save_checkpoint,
                                save_train_state)
from ..utils.logging_utils import MetricBuffer, SummaryWriter, setup_logging


def poly_lr(step: int, base_lr: float, max_iterations: int,
            power: float = 0.9) -> float:
    """``base·(1 − step/max)^power``, the fraction clipped to [0, 1]."""
    frac = min(max(1.0 - step / max_iterations, 0.0), 1.0)
    return base_lr * frac**power


def make_optimizer(params, base_lr: float, max_iterations: int, *,
                   momentum: float = 0.9, weight_decay: float = 1e-4):
    """SGD with momentum and weight decay on every parameter, and a
    per-iteration poly LR schedule (call ``scheduler.step()`` after each
    ``optimizer.step()``). The update equals optax's
    ``chain(add_decayed_weights(wd), sgd(poly, momentum))``: the decayed
    gradient g + wd·p feeds the momentum trace, scaled by the step's LR."""
    optimizer = torch.optim.SGD(params, lr=base_lr, momentum=momentum,
                                weight_decay=weight_decay)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: poly_lr(step, 1.0, max_iterations))
    return optimizer, scheduler


def make_train_step(model, optimizer, scheduler, num_classes: int, *,
                    loss_fn=None, device_augment: bool = False):
    """``step(image, label, generator) -> aux``: forward, loss, backward,
    SGD update and LR step. ``loss_fn(logits, labels)`` defaults to
    0.4·CE + 0.6·Dice and returns (scalar, aux dict). ``aux`` holds the
    detached losses and the argmax map of sample 1 (``pred_vis``), all on
    the device. ``device_augment``: the batch is augmented first
    (``augment_batch``), its draws from ``generator`` before the
    drop-path's."""
    if loss_fn is None:
        def loss_fn(logits, labels):
            return segmentation_loss(logits, labels, num_classes)

    def step(image: torch.Tensor, label: torch.Tensor,
             generator: torch.Generator | None) -> dict:
        optimizer.zero_grad(set_to_none=True)
        if device_augment:
            image, label = augment_batch(image, label, generator)
        logits = model(image, generator=generator)
        total, aux = loss_fn(logits, label)
        total.backward()
        optimizer.step()
        scheduler.step()
        out = {k: v.detach() for k, v in aux.items()}
        out["pred_vis"] = logits[min(1, logits.shape[0] - 1)].detach().argmax(-1)
        return out

    return step


def trainer_synapse(args, model, snapshot_path: str) -> str:
    """End-to-end base training of ``model`` (a ``CSwinUnet`` in train mode,
    on ``args.device``; data parallel under a process group)."""
    rank, world = process_shard_info()
    main = rank == 0
    if main:
        setup_logging(snapshot_path)
    logging.info(str(args))
    device = torch.device(args.device)

    base_lr = args.base_lr
    num_classes = args.num_classes
    batch_size = args.batch_size * getattr(args, "n_gpu", 1)
    if batch_size % world:
        raise ValueError(f"batch_size {batch_size} not divisible by {world} processes")
    device_augment = bool(getattr(args, "device_augment", False))
    size = [args.img_size, args.img_size]
    db_train = SynapseDataset(base_dir=args.root_path, list_dir=args.list_dir,
                              split="train",
                              transform=EvalResize(size) if device_augment
                              else RandomGenerator(size))
    if main:
        print(f"The length of train set is: {len(db_train)}")
    trainloader = DataLoader(db_train, batch_size // world, shuffle=True, seed=args.seed,
                             num_workers=getattr(args, "num_workers", 8),
                             num_shards=world, shard_index=rank)

    max_epoch = args.max_epochs
    max_iterations = max_epoch * len(trainloader)
    logging.info(f"{len(trainloader)} iterations per epoch. {max_iterations} "
                 "max iterations ")

    model.train()
    optimizer, scheduler = make_optimizer(model.parameters(), base_lr,
                                          max_iterations)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    writer = SummaryWriter(os.path.join(snapshot_path, "log")) if main else None
    iter_num = start_epoch = 0
    resume = getattr(args, "resume", None)
    if resume:
        # The model, SGD momentum, LR step and drop-path generator as saved,
        # and the loader at the next epoch: the run continues exactly.
        iter_num, start_epoch = restore_train_state(resume, model, optimizer, scheduler,
                                                    generator)
        trainloader.epoch = start_epoch
        logging.info(f"resumed from {resume} at iteration {iter_num} (epoch {start_epoch})")
    train_step = make_train_step(wrap_ddp(model, device), optimizer, scheduler,
                                 num_classes, device_augment=device_augment)
    t_start = time.time()
    metrics = MetricBuffer(flush_every=20)

    def emit_step(it, v):
        if not main:
            return
        writer.add_scalar("info/lr", v["lr"], it)
        writer.add_scalar("info/total_loss", v["loss"], it)
        writer.add_scalar("info/loss_ce", v["loss_ce"], it)
        logging.info("iteration %d : loss : %f, loss_ce: %f"
                     % (it, v["loss"], v["loss_ce"]))
        if "image" in v:
            # Image triptych every 20 iterations (reference trainer.py:72-79).
            img = np.asarray(v["image"])[..., 0]
            span = img.max() - img.min()
            writer.add_image("train/Image",
                             ((img - img.min()) / (span if span > 0 else 1.0))[None], it)
            writer.add_image("train/Prediction",
                             np.asarray(v["pred_vis"])[None].astype(np.float32) * 50, it)
            writer.add_image("train/GroundTruth",
                             np.asarray(v["label"])[None].astype(np.float32) * 50, it)

    for epoch_num in range(start_epoch, max_epoch):
        for batch in device_prefetch(iter(trainloader), device):
            aux = train_step(batch["image"], batch["label"], generator)
            lr_ = poly_lr(iter_num, base_lr, max_iterations)
            iter_num += 1
            vals = {"lr": lr_, "loss": aux["loss"], "loss_ce": aux["loss_ce"]}
            if iter_num % 20 == 0:
                s = min(1, batch["image"].shape[0] - 1)
                vals["image"] = batch["image"][s]
                vals["label"] = batch["label"][s]
                vals["pred_vis"] = aux["pred_vis"]
            metrics.append(iter_num, vals, emit_step)
        metrics.flush()

        save_interval = 3
        is_last = epoch_num >= max_epoch - 1
        if (epoch_num > int(max_epoch / 2)
                and (epoch_num + 1) % save_interval == 0) or is_last:
            multihost_barrier("pre-checkpoint")  # every rank done with the epoch
            if main:  # the parameters are the same on every rank; one writes
                save_mode_path = os.path.join(snapshot_path, f"epoch_{epoch_num}.npz")
                save_checkpoint(save_mode_path, model.cswin_unet.state_dict())
                logging.info(f"save model to {save_mode_path}")
                save_train_state(os.path.join(snapshot_path, TRAIN_STATE), model,
                                 optimizer, scheduler, generator, iter_num, epoch_num + 1)
            multihost_barrier("post-checkpoint")
        if is_last:
            break

    logging.info(f"Training finished in {time.time() - t_start:.1f}s "
                 f"({iter_num} iterations)")
    if main:
        writer.close()
    return "Training Finished!"
