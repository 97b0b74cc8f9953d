"""Continual-learning CLI (KD + surgical fine-tuning + TPGM):

    python -m cswin_unet_tpu_torch.universal_train --cfg C --stage 1|2 \
        --pretrained_path CK --root_path DATA --list_dir LISTS --output_dir OUT \
        [--device cuda] ...

The argparse surface of the root ``universal_train.py`` (reference
universal_train.py:26-118), plus ``--device`` (default ``cuda``; ``cuda``
without a card raises; one process per GPU under ``python -m
torch.distributed.run --nproc_per_node N``, ``train.continual``). It
builds the old model and loads ``--pretrained_path`` (the JAX package's
``.npz``) onto it, keys that match only, expands the
head from the old classes to old + new − 1 (a shared background), and runs
``train.continual.trainer_continual_surgical_tpgm``: checkpoints
``continual_surgical_tpgm_stage{S}_epoch_{E}.npz`` and ``..._final.npz``.
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root_path", type=str, default="./datasets/kits23/train_npz",
                   help="root dir for data")
    p.add_argument("--dataset", type=str, default="kits23", help="experiment_name")
    p.add_argument("--list_dir", type=str, default="./lists/kits23", help="list dir")
    p.add_argument("--stage", type=int, choices=[1, 2], default=1,
                   help="Continual learning stage: 1 (Synapse->kits23), "
                        "2 (Synapse+kits23->lits17)")
    p.add_argument("--num_classes_old", type=int, default=9,
                   help="number of classes in the old model")
    p.add_argument("--num_classes_new", type=int, default=4,
                   help="number of classes in the new dataset")
    p.add_argument("--num_classes_lits17", type=int, default=3,
                   help="number of classes in lits17 dataset")
    p.add_argument("--output_dir", type=str, help="output dir")
    p.add_argument("--max_iterations", type=int, default=10000)
    p.add_argument("--max_epochs", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=12, help="batch_size per gpu")
    p.add_argument("--n_gpu", type=int, default=1, help="total gpu")
    p.add_argument("--deterministic", type=int, default=1)
    p.add_argument("--base_lr", type=float, default=0.001)
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--cfg", type=str, required=True, metavar="FILE",
                   help="path to config file")
    p.add_argument("--pretrained_path", type=str, required=True,
                   help="path to pretrained model checkpoint")
    p.add_argument("--data_fraction", type=float, default=1.0,
                   help="fraction of data to use for finetuning (default: 1.0)")
    p.add_argument("--kd_temperature", type=float, default=3.0)
    p.add_argument("--kd_weight", type=float, default=0.5)
    p.add_argument("--freeze_old_classes", action="store_true")
    p.add_argument("--auto_tune", type=str, default="RGN",
                   choices=["none", "RGN", "eb-criterion"])
    p.add_argument("--gradient_batches", type=int, default=5)
    p.add_argument("--tpgm_norm_mode", type=str, default="l2", choices=["l2", "mars"])
    p.add_argument("--tpgm_lr", type=float, default=0.01)
    p.add_argument("--tpgm_iters", type=int, default=200)
    p.add_argument("--tpgm_exclude", nargs="+", default=[])
    p.add_argument("--tpgm_frequency", type=int, default=5)
    p.add_argument("--tpgm_start_epoch", type=int, default=10)
    p.add_argument("--disable_tpgm", action="store_true")
    p.add_argument("--tpgm_data_fraction", type=float, default=0.1)
    p.add_argument("--opts", default=None, nargs="+")
    p.add_argument("--zip", action="store_true")
    p.add_argument("--cache-mode", type=str, default="part", choices=["no", "full", "part"])
    p.add_argument("--resume", help="resume from checkpoint")
    p.add_argument("--accumulation-steps", type=int)
    p.add_argument("--use-checkpoint", action="store_true")
    p.add_argument("--amp-opt-level", type=str, default="O1", choices=["O0", "O1", "O2"])
    p.add_argument("--tag", help="tag of experiment")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--throughput", action="store_true")
    p.add_argument("--device", type=str, default="cuda", help="torch device to train on")
    return p


def main(argv=None) -> str:
    from .config import get_config
    from .parallel import destroy_distributed, init_distributed

    args = build_parser().parse_args(argv)
    config = get_config(args)
    # Under torchrun: the process group, and cuda:LOCAL_RANK as the device
    # (a CUDA device without a card raises).
    _, _, device = init_distributed(args.device)
    args.device = str(device)
    try:
        return _run(args, config, device)
    finally:
        destroy_distributed()


def _run(args, config, device: torch.device) -> str:
    from .models import build_model
    from .train.continual import get_stage_info, trainer_continual_surgical_tpgm
    from .utils.checkpoint import expand_classifier, load_checkpoint, load_into

    random.seed(args.seed)
    np.random.seed(args.seed)
    os.makedirs(args.output_dir, exist_ok=True)

    stage_info = get_stage_info(args)
    old_classes, new_classes, total_classes, dataset_name = stage_info

    # The old model, its weights overlaid where the checkpoint's keys match.
    old_model = build_model(config, img_size=args.img_size, num_classes=old_classes,
                            device=device, seed=args.seed)
    print(f"Loading pretrained model from {args.pretrained_path}")
    load_into(old_model.cswin_unet, load_checkpoint(args.pretrained_path)[0])

    # The head expanded: old -> old + new - 1 classes (shared background).
    new_model = build_model(config, img_size=args.img_size, num_classes=total_classes,
                            device=device, seed=args.seed, train=True)
    new_model.cswin_unet.load_state_dict(
        expand_classifier(old_model.cswin_unet.state_dict(), total_classes, seed=args.seed))
    print(f"Expanded final layer 'output': {old_classes} -> {total_classes} classes")

    print(f"\n=== Combined Continual Learning Stage {args.stage} + Surgical + TPGM "
          "Configuration ===")
    print(f"Dataset: {dataset_name}")
    print(f"Old model classes: {old_classes}")
    print(f"New dataset classes: {new_classes}")
    print(f"Total classes: {total_classes}")
    print(f"KD Temperature: {args.kd_temperature}")
    print(f"KD Weight: {args.kd_weight}")
    print(f"Surgical fine-tuning method: {args.auto_tune}")
    print(f"TPGM enabled: {not args.disable_tpgm}")
    print(f"Data fraction: {args.data_fraction}")
    print(f"Base learning rate: {args.base_lr}")
    print(f"Max epochs: {args.max_epochs}")
    print("=" * 70)

    return trainer_continual_surgical_tpgm(args, new_model, old_model, args.output_dir,
                                           stage_info)


if __name__ == "__main__":
    main()
