"""Continual learning: KD + surgical fine-tuning + TPGM across datasets.

Counterpart of ``cswin_unet_tpu.train.continual`` (reference
``universal_train.py``, Synapse → KiTS23 → LiTS17): the classifier head is
expanded with a shared background (9 → 12 → 14 classes), new-dataset labels
are remapped into the expanded space, training combines a focal + Dice
segmentation loss with knowledge distillation against the frozen previous
model, with per-epoch surgical LR reweighting, periodic TPGM constraint
optimization and a final TPGM projection. Positive oversampling, class
weights and the distribution analysis follow :193-241, :991-1035,
:1037-1059.

On one explicit device (``args.device``). Each step runs both routes of the
model: the teacher in eval mode under ``torch.no_grad()`` (the serving
route, stage 3 paired where ``cswin_block.PAIR_GEOMETRIES`` says), the
student in train mode with drop-path from a ``torch.Generator`` seeded from
``--seed``. The surgical and TPGM passes run the student in eval mode with
gradients on and restore its mode. Checkpoints are the JAX package's
``.npz`` under its names.

Data parallel under ``torchrun`` (``parallel``): the student's gradients
come from ``torch.autograd.grad``, which DDP's hooks never see, so the step
averages them over the ranks itself (``all_reduce_mean_``), as do the
surgical and TPGM passes; the Dice sums and the drop-path draws are the
global batch's. The subsets are drawn from the same seed on every rank, the
class weights scan the unsharded data on every rank (equal to one
process's), the train and TPGM loaders are sharded, the teacher runs
locally without gradients, and rank 0 alone writes logs and checkpoints.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from ..data import DataLoader, RandomGenerator, Subset, SynapseDataset, device_prefetch
from ..losses import _dice_from_probs, _log_softmax, focal_loss, kd_loss, one_hot
from ..parallel import all_reduce_mean_, multihost_barrier, process_shard_info
from ..utils.checkpoint import save_checkpoint
from ..utils.logging_utils import MetricBuffer, SummaryWriter, setup_logging
from .surgical import (SurgicalOptimizer, backbone_params, get_lr_weights,
                       log_layer_learning_rates, make_grad_fn, normalize_weights)
from .tpgm import TPGMTrainer

NUM_WORKERS = 4  # host loader threads, as the JAX trainer's


def get_stage_info(args):
    """(old classes, new-dataset classes, total, dataset) of a stage
    (reference universal_train.py:120-139)."""
    if args.stage == 1:
        old, new = args.num_classes_old, args.num_classes_new
        return old, new, old + new - 1, args.dataset
    if args.stage == 2:
        old, new = args.num_classes_old, args.num_classes_lits17
        return old, new, old + new - 1, "lits17"
    raise ValueError(f"Unsupported stage: {args.stage}")


def map_new_dataset_labels(labels, stage: int, num_classes_old: int):
    """Stage 1: 1, 2, 3 → old, old+1, old+2; stage 2: 1, 2 → old, old+1;
    background stays 0 (reference :243-258). numpy arrays or tensors."""
    where = torch.where if isinstance(labels, torch.Tensor) else np.where
    mapped = labels
    n_new = 3 if stage == 1 else 2
    for c in range(1, n_new + 1):
        mapped = where(labels == c, num_classes_old + c - 1, mapped)
    return mapped


class PositiveSamplingDataset:
    """Oversample slices holding foreground classes (reference :193-241).

    Scans the base dataset once for per-class slice indices over the raw
    (unmapped) labels, then biases draws: stage 1 — 30% class 3, then 50%
    class 2, then 80% class 1; stage 2 — 40% class 2, then 80% class 1.
    The draws come from the loader's per-sample rng.
    """

    def __init__(self, base_dataset, positive_ratio: float = 0.8, stage: int = 1,
                 seed: int = 1234):
        self.base = base_dataset
        self.positive_ratio = positive_ratio
        self.stage = stage
        self._rng = np.random.default_rng(seed)
        classes = range(4) if stage == 1 else range(3)
        self.class_indices = {c: [] for c in classes}
        for idx in range(len(base_dataset)):
            label = base_dataset.__getitem__(idx, np.random.default_rng(0))["label"]
            for cls in np.unique(label):
                if int(cls) in self.class_indices:
                    self.class_indices[int(cls)].append(idx)
        print("Class-wise sample distribution:")
        for cls, idxs in self.class_indices.items():
            print(f"  Class {cls}: {len(idxs)} samples")

    def __len__(self):
        return len(self.base)

    def __getitem__(self, idx, rng=None):
        r = rng if rng is not None else self._rng
        real_idx = idx % len(self.base)
        if self.stage == 1:
            if r.random() < 0.3 and self.class_indices[3]:
                real_idx = int(r.choice(self.class_indices[3]))
            elif r.random() < 0.5 and self.class_indices[2]:
                real_idx = int(r.choice(self.class_indices[2]))
            elif r.random() < self.positive_ratio and self.class_indices[1]:
                real_idx = int(r.choice(self.class_indices[1]))
        else:
            if r.random() < 0.4 and self.class_indices[2]:
                real_idx = int(r.choice(self.class_indices[2]))
            elif r.random() < self.positive_ratio and self.class_indices[1]:
                real_idx = int(r.choice(self.class_indices[1]))
        return self.base.__getitem__(real_idx, rng)


def calculate_extreme_class_weights(loader, num_classes: int, stage: int,
                                    stage_info) -> np.ndarray:
    """1/√pixel-count weights over the active classes from at most 21
    batches, normalized, background capped at 0.5 (reference :991-1035)."""
    old_classes, new_classes, _, _ = stage_info
    active = [0] + list(range(old_classes, old_classes + new_classes - 1))
    print(f"Active classes for weight calculation (Stage {stage}): {active}")

    counts = np.zeros(num_classes)
    for batch_idx, batch in enumerate(loader):
        mapped = map_new_dataset_labels(batch["label"], stage, old_classes)
        for c in active:
            counts[c] += int((mapped == c).sum())
        if batch_idx >= 20:
            break
    print(f"Class pixel counts: {counts}")

    weights = np.zeros(num_classes)
    for c in active:
        if counts[c] > 0:
            weights[c] = 1.0 / np.sqrt(counts[c] + 1e-6)
    s = weights[active].sum()
    if s > 0:
        weights[active] = weights[active] / s * len(active)
    weights[0] = min(weights[0], 0.5)
    print(f"Calculated class weights: {weights}")
    return weights.astype(np.float32)


def analyze_class_distribution(loader, stage: int = 1) -> dict:
    """Per-class slice and pixel counts over one epoch (reference
    :1037-1059)."""
    num_classes = 4 if stage == 1 else 3
    counts = {c: 0 for c in range(num_classes)}
    pixels = {c: 0 for c in range(num_classes)}
    total = 0
    for batch in loader:
        labels = batch["label"]
        total += labels.shape[0]
        for c in range(num_classes):
            mask = labels == c
            counts[c] += int((mask.sum(axis=(1, 2)) > 0).sum())
            pixels[c] += int(mask.sum())
    print(f"=== Class Distribution Analysis (Stage {stage}) ===")
    tp = max(1, sum(pixels.values()))
    for c in sorted(counts):
        print(f"Class {c}: {counts[c]} samples, {pixels[c]} pixels")
        print(f"  - Sample frequency: {counts[c] / max(1, total):.3f}")
        print(f"  - Pixel frequency: {pixels[c] / tp:.6f}")
    return {"counts": counts, "pixels": pixels}


def make_continual_loss(total_classes: int, old_classes: int, *, kd_weight: float,
                        kd_temperature: float, class_weights: np.ndarray,
                        focal_gamma: float = 4.0):
    """``loss_fn(logits, old_logits, mapped_labels) -> (total, aux)``:
    (1−w_kd)·(0.2·Focal + 0.8·Dice) + w_kd·KD(logits[..., :old], teacher)
    (reference :921-932), focal and Dice from one shared softmax."""
    cw = torch.as_tensor(np.asarray(class_weights, np.float32))

    def loss_fn(logits, old_logits, mapped_labels):
        labels_c = mapped_labels.clamp(0, total_classes - 1)
        logp, probs = _log_softmax(logits)
        onehot = one_hot(labels_c, total_classes)
        ce = -(logp * onehot).sum(-1)
        w = (onehot * cw.to(onehot.device)).sum(-1)
        ce = torch.nan_to_num(ce * w, nan=1e-6, posinf=10.0, neginf=1e-6)
        focal = (1.0 - torch.exp(-ce)) ** focal_gamma * ce
        l_ce = focal.mean()
        l_ce = torch.where(torch.isfinite(l_ce), l_ce, l_ce.new_tensor(1e-3))
        l_dice = _dice_from_probs(probs, onehot, total_classes, None)
        l_kd = kd_loss(logits[..., :old_classes], old_logits, kd_temperature)
        seg = 0.2 * l_ce + 0.8 * l_dice
        total = (1.0 - kd_weight) * seg + kd_weight * l_kd
        return total, {"loss": total, "loss_ce": l_ce, "loss_dice": l_dice,
                       "loss_kd": l_kd}

    return loss_fn


def make_continual_train_step(model, old_model, optimizer: SurgicalOptimizer, loss_fn,
                              stage: int, old_classes: int):
    """``step(image, label, weights, epoch, generator) -> aux``: the
    teacher's logits without gradients, the student's in train mode (its
    drop-path from ``generator``), the continual loss on the mapped labels,
    and one ``optimizer`` step on the gradients averaged over the ranks
    (one process: as they are). ``aux`` holds the detached losses on the
    device."""
    params = backbone_params(model)

    def step(image, label, weights: dict[str, float], epoch: int,
             generator: torch.Generator | None) -> dict:
        mapped = map_new_dataset_labels(label, stage, old_classes)
        with torch.no_grad():
            old_logits = old_model(image)
        logits = model(image, generator=generator)
        total, aux = loss_fn(logits, old_logits, mapped)
        grads = all_reduce_mean_(torch.autograd.grad(total, list(params.values())))
        optimizer.step(dict(zip(params, grads)), weights, epoch)
        return {k: v.detach() for k, v in aux.items()}

    return step


def trainer_continual_surgical_tpgm(args, model, old_model, snapshot_path: str,
                                    stage_info) -> str:
    """The master loop (reference :751-984): ``model`` is the student (a
    ``CSwinUnet`` with the expanded head, in train mode), ``old_model`` the
    teacher; both on ``args.device``."""
    old_classes, new_classes, total_classes, dataset_name = stage_info
    device = torch.device(args.device)
    rank, world = process_shard_info()
    main = rank == 0

    if main:
        setup_logging(snapshot_path)
    logging.info(str(args))

    base_lr = args.base_lr
    batch_size = args.batch_size * getattr(args, "n_gpu", 1)
    if batch_size % world:
        raise ValueError(f"batch_size {batch_size} not divisible by {world} processes")
    shard = dict(num_shards=world, shard_index=rank)

    db_train_full = SynapseDataset(
        base_dir=args.root_path, list_dir=args.list_dir, split="train",
        transform=RandomGenerator(output_size=[args.img_size, args.img_size]),
    )
    total_samples = len(db_train_full)
    subset_size = int(total_samples * args.data_fraction)
    if args.data_fraction < 1.0:
        rng = np.random.default_rng(args.seed)
        indices = rng.choice(total_samples, subset_size, replace=False)
        db_train = Subset(db_train_full, indices.tolist())
    else:
        db_train = db_train_full
        subset_size = total_samples

    tpgm_size = int(subset_size * args.tpgm_data_fraction)
    if not args.disable_tpgm and tpgm_size > 0:
        rng = np.random.default_rng(args.seed + 1)
        tpgm_indices = rng.choice(subset_size, tpgm_size, replace=False)
        db_tpgm = Subset(db_train, tpgm_indices.tolist())
    else:
        db_tpgm = None

    logging.info(f"Stage {args.stage}: Using {subset_size}/{total_samples} samples "
                 f"({args.data_fraction * 100:.1f}%) for continual learning")
    logging.info(f"Old classes: {old_classes}, New classes: {new_classes}, "
                 f"Total: {total_classes}")
    logging.info(f"Dataset: {dataset_name}")
    logging.info(f"TPGM enabled: {not args.disable_tpgm}")
    logging.info(f"Surgical fine-tuning method: {args.auto_tune}")

    db_positive = PositiveSamplingDataset(db_train, positive_ratio=0.8, stage=args.stage,
                                          seed=args.seed)
    temp_loader = DataLoader(db_positive, batch_size, shuffle=True, seed=args.seed,
                             num_workers=NUM_WORKERS)
    print("Analyzing class distribution...")
    analyze_class_distribution(temp_loader, stage=args.stage)
    print("Calculating class weights...")
    class_weights = calculate_extreme_class_weights(
        DataLoader(db_positive, batch_size, shuffle=True, seed=args.seed + 2,
                   num_workers=NUM_WORKERS),
        total_classes, args.stage, stage_info)

    trainloader = DataLoader(db_positive, batch_size // world, shuffle=True,
                             seed=args.seed, num_workers=NUM_WORKERS, **shard)
    tpgm_loader = (DataLoader(db_tpgm, batch_size // world, shuffle=True, seed=args.seed,
                              num_workers=NUM_WORKERS, **shard)
                   if db_tpgm is not None else None)

    old_model.eval()
    params = backbone_params(model)
    loss_fn = make_continual_loss(total_classes, old_classes, kd_weight=args.kd_weight,
                                  kd_temperature=args.kd_temperature,
                                  class_weights=class_weights)
    cw = torch.from_numpy(class_weights).to(device)

    def seg_ce_for_grads(logits, labels):
        return focal_loss(logits, labels, alpha=1.0, gamma=4.0, class_weights=cw)

    def label_map(labels):
        return map_new_dataset_labels(labels, args.stage, old_classes)

    tpgm = TPGMTrainer(model, params, norm_mode=args.tpgm_norm_mode,
                       proj_lr=args.tpgm_lr, max_iters=args.tpgm_iters,
                       active_classes=total_classes, exclude=tuple(args.tpgm_exclude),
                       enabled=not args.disable_tpgm, label_map=label_map)

    # The reference's dedicated ratio log (universal_train.py:556-567).
    ratio_logger = logging.getLogger("tpgm_ratios")
    ratio_logger.setLevel(logging.INFO)
    ratio_logger.propagate = False
    for h in list(ratio_logger.handlers):
        ratio_logger.removeHandler(h)
        h.close()
    handler = (logging.FileHandler(os.path.join(snapshot_path, "tpgm_ratios.log"), mode="w")
               if main else logging.NullHandler())
    handler.setFormatter(logging.Formatter("%(asctime)s - %(message)s"))
    ratio_logger.addHandler(handler)
    ratio_logger.info(f"TPGM Trainer Initialized. Enabled: {not args.disable_tpgm}, "
                      f"Stage: {args.stage}")

    optimizer = SurgicalOptimizer(params, base_lr, args.max_epochs)
    train_step = make_continual_train_step(model, old_model, optimizer, loss_fn,
                                           args.stage, old_classes)
    grad_fn = make_grad_fn(model, seg_ce_for_grads)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    writer = SummaryWriter(os.path.join(snapshot_path, "log")) if main else None
    max_epoch = args.max_epochs
    max_iterations = max_epoch * len(trainloader)
    logging.info(f"Combined Continual Learning Stage {args.stage} + Surgical + TPGM "
                 "Configuration:")
    logging.info(f"KD Temperature: {args.kd_temperature}")
    logging.info(f"KD Weight: {args.kd_weight}")
    logging.info(f"Auto-tune method: {args.auto_tune}")
    logging.info(f"TPGM start epoch: {args.tpgm_start_epoch}")
    logging.info(f"TPGM frequency: {args.tpgm_frequency}")
    logging.info(f"{len(trainloader)} iterations per epoch. {max_iterations} max "
                 "iterations ")

    iter_num = 0
    metrics = MetricBuffer(flush_every=20)
    # Uniform weights until the first surgical analysis (auto_tune none keeps
    # them 1.0: plain AdamW, reference :846-849, :701-702).
    weights = {k: 1.0 for k in params}

    for epoch_num in range(max_epoch):
        if args.auto_tune != "none":
            logging.info(f"\n[EPOCH {epoch_num + 1}] Calculating gradient weights for "
                         "surgical fine-tuning...")
            analysis_batches = []
            for i, b in enumerate(trainloader):
                analysis_batches.append(b)
                if i + 1 >= args.gradient_batches:
                    break
            raw = get_lr_weights(model, analysis_batches, seg_ce_for_grads,
                                 method=args.auto_tune, label_map=label_map,
                                 grad_fn=grad_fn)
            if args.auto_tune == "RGN" and raw:
                logging.info(f"RGN: Max weight before normalization: "
                             f"{max(raw.values()):.6f}")
            elif args.auto_tune == "eb-criterion" and raw:
                logging.info(f"EB-Criterion: Weight range before thresholding: "
                             f"{min(raw.values()):.6f} - {max(raw.values()):.6f}")
            weights = normalize_weights(raw, args.auto_tune)
            optimizer.init()  # fresh AdamW moments each epoch, as the reference
            log_layer_learning_rates(weights, base_lr, logging, stage=args.stage,
                                     method=args.auto_tune)

        if (not args.disable_tpgm and tpgm_loader is not None
                and epoch_num >= args.tpgm_start_epoch
                and (epoch_num - args.tpgm_start_epoch + 1) % args.tpgm_frequency == 0):
            # No TPGM loader when tpgm_data_fraction rounds to zero samples:
            # the reference skips then (universal_train.py:574).
            logging.info(f"Running TPGM constraint optimization after epoch {epoch_num}")
            tpgm.optimize(params, _cycle(tpgm_loader, device), log=logging.info,
                          ratio_logger=ratio_logger)

        lr_epoch = optimizer.schedule(epoch_num)

        def emit_step(it, v, lr_epoch=lr_epoch):
            if not main:
                return
            writer.add_scalar("info/lr", lr_epoch, it)
            writer.add_scalar("info/total_loss", v["loss"], it)
            writer.add_scalar("info/loss_ce", v["loss_ce"], it)
            writer.add_scalar("info/loss_dice", v["loss_dice"], it)
            writer.add_scalar("info/loss_kd", v["loss_kd"], it)
            if it % 10 == 0:
                logging.info("iteration %d : loss : %f, loss_ce: %f, loss_kd: %f"
                             % (it, v["loss"], v["loss_ce"], v["loss_kd"]))

        for batch in device_prefetch(iter(trainloader), device):
            aux = train_step(batch["image"], batch["label"], weights, epoch_num, generator)
            iter_num += 1
            metrics.append(iter_num, aux, emit_step)
        metrics.flush()

        if main and ((epoch_num + 1) % 5 == 0 or epoch_num == max_epoch - 1):
            path = os.path.join(
                snapshot_path,
                f"continual_surgical_tpgm_stage{args.stage}_epoch_{epoch_num}.npz")
            save_checkpoint(path, model.cswin_unet.state_dict())
            logging.info(f"save model to {path}")

    if not args.disable_tpgm:
        logging.info("Applying final TPGM projection")
        with torch.no_grad():
            for k, v in tpgm.apply(params).items():
                params[k].copy_(v)

    final_path = os.path.join(snapshot_path,
                              f"continual_surgical_tpgm_stage{args.stage}_final.npz")
    multihost_barrier("pre-checkpoint")
    if main:
        save_checkpoint(final_path, model.cswin_unet.state_dict())
        logging.info(f"save final model to {final_path}")
        writer.close()
    multihost_barrier("post-checkpoint")
    ratio_logger.removeHandler(handler)
    handler.close()
    return (f"Combined Continual Learning Stage {args.stage} + Surgical Fine-tuning "
            f"+ TPGM Finished!")


def _cycle(loader, device):
    """The loader's batches on ``device``, epoch after epoch."""
    while True:
        yield from device_prefetch(iter(loader), device)
