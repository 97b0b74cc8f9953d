"""Legacy surgical fine-tuning CLI:

    python -m cswin_unet_tpu_torch.finetune --cfg C --output_dir OUT \
        [--pretrained_ckpt CK] [--device cuda] ...

The argparse surface of the root ``finetune.py`` (reference finetune.py),
plus ``--device`` (default ``cuda``; ``cuda`` without a card raises; one
process per GPU under ``python -m torch.distributed.run --nproc_per_node N``,
``train.finetune``): a
seeded model (``--seed``), the pretrained weights where ``--pretrained_ckpt``
names a file (the JAX package's ``.npz`` or a reference ``.pth``, loaded as
the base trainer loads them), then ``train.finetune.surgical_trainer``: the
grid over (lr, wd) with per-group RGN learning rates every batch, saving
``model_lr{lr}_wd{wd}_epoch{E}.npz``.
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
    p.add_argument("--pretrained_ckpt", type=str, default="./pretrain/epoch_149.npz",
                   help="Path to pre-trained checkpoint")
    p.add_argument("--root_path", type=str, default="./datasets/Synapse_blurred/train_npz")
    p.add_argument("--dataset", type=str, default="Synapse", help="Dataset name")
    p.add_argument("--list_dir", type=str, default="./lists/lists_Synapse_blurred")
    p.add_argument("--num_classes", type=int, default=9)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--max_epochs", type=int, default=51)
    p.add_argument("--batch_size", type=int, default=24)
    p.add_argument("--base_lr", type=float, default=0.001)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--cfg", type=str, required=True, metavar="FILE")
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--n_gpu", type=int, default=2)
    p.add_argument("--deterministic", type=int, default=1)
    p.add_argument("--save_interval", type=int, default=10)
    p.add_argument("--auto_tune", type=str, default="RGN",
                   choices=["RGN", "eb-criterion", "none"])
    p.add_argument("--zip", action="store_true")
    p.add_argument("--cache-mode", type=str, default="part", choices=["no", "full", "part"])
    p.add_argument("--opts", default=None, nargs="+")
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
    config.defrost()
    config.MODEL.PRETRAIN_CKPT = args.pretrained_ckpt
    config.freeze()
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
    from .train.finetune import surgical_trainer
    from .utils.checkpoint import load_from_pretrained

    random.seed(args.seed)
    np.random.seed(args.seed)
    model = build_model(config, img_size=args.img_size, num_classes=args.num_classes,
                        device=device, seed=args.seed, train=True)
    ck = args.pretrained_ckpt
    if os.path.exists(ck) or os.path.exists(ck + ".npz"):
        load_from_pretrained(model.cswin_unet, ck)
        print(f"Loaded pretrained weights from {ck}")

    os.makedirs(args.output_dir, exist_ok=True)
    return surgical_trainer(args, model, args.output_dir)


if __name__ == "__main__":
    main()
