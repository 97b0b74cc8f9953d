"""Base training CLI:

    python -m cswin_unet_tpu_torch.train --cfg C --root_path DATA \
        --output_dir OUT [--device cuda] ...

The argparse surface of the root ``train.py`` (reference train.py:19-69),
plus ``--device`` (default ``cuda``), so command lines are interchangeable.
Weights come from a seeded init (``--seed``), then from ``MODEL.PRETRAIN_CKPT``
when it names an existing file: the JAX package's ``.npz`` or a reference
``.pth``, loaded as the root ``train.py`` loads it
(``utils.checkpoint.load_from_pretrained``: encoder weights seed the decoder
stages the checkpoint lacks). ``--use-checkpoint`` recomputes each block's
forward in the backward (``TRAIN.USE_CHECKPOINT``). ``--resume PATH``
continues a run exactly from the ``train_state.pt`` the trainer writes beside
each checkpoint (PATH: the file, or the run's output directory): weights,
SGD momentum, LR step, drop-path generator and loader epoch.

Data parallel, one process per GPU (NCCL; gloo with ``--device cpu``):

    python -m torch.distributed.run --nproc_per_node N \
        -m cswin_unet_tpu_torch.train --cfg C ... [--device cuda]

``--batch_size`` stays the global batch per ``--n_gpu`` as in one process;
each rank takes ``batch_size · n_gpu / N`` rows of it on ``cuda:LOCAL_RANK``
(``train.trainer``). Rank 0 writes the log, checkpoints and train state.
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch

from ..config import get_config

DATASETS = {
    "Synapse": {"list_dir": "./lists/lists_Synapse_blurred", "num_classes": 9},
    "kits23": {"list_dir": "./lists/kits23", "num_classes": 4},
    "lits17": {"list_dir": "./lists/lits17", "num_classes": 3},
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root_path", type=str, default="../data/Synapse/train_npz",
                   help="root dir for data")
    p.add_argument("--dataset", type=str, default="Synapse", help="experiment_name")
    p.add_argument("--list_dir", type=str, default="./lists/lists_Synapse_blurred",
                   help="list dir")
    p.add_argument("--num_classes", type=int, default=9,
                   help="output channel of network")
    p.add_argument("--output_dir", type=str, help="output dir")
    p.add_argument("--max_iterations", type=int, default=30000,
                   help="maximum epoch number to train")
    p.add_argument("--max_epochs", type=int, default=150,
                   help="maximum epoch number to train")
    p.add_argument("--batch_size", type=int, default=24, help="batch_size per gpu")
    p.add_argument("--n_gpu", type=int, default=1, help="total gpu")
    p.add_argument("--deterministic", type=int, default=1,
                   help="whether use deterministic training")
    p.add_argument("--base_lr", type=float, default=0.01,
                   help="segmentation network learning rate")
    p.add_argument("--img_size", type=int, default=224,
                   help="input patch size of network input")
    p.add_argument("--seed", type=int, default=1234, help="random seed")
    p.add_argument("--cfg", type=str, required=True, metavar="FILE",
                   help="path to config file")
    p.add_argument("--opts", help="Modify config options by adding 'KEY VALUE' pairs. ",
                   default=None, nargs="+")
    p.add_argument("--zip", action="store_true",
                   help="use zipped dataset instead of folder dataset")
    p.add_argument("--cache-mode", type=str, default="part",
                   choices=["no", "full", "part"])
    p.add_argument("--resume", help="continue from a train_state.pt, or from the run "
                                    "directory that holds one")
    p.add_argument("--accumulation-steps", type=int, help="gradient accumulation steps")
    p.add_argument("--use-checkpoint", action="store_true",
                   help="whether to use gradient checkpointing to save memory")
    p.add_argument("--amp-opt-level", type=str, default="O1", choices=["O0", "O1", "O2"])
    p.add_argument("--tag", help="tag of experiment")
    p.add_argument("--eval", action="store_true", help="Perform evaluation only")
    p.add_argument("--throughput", action="store_true", help="Test throughput only")
    p.add_argument("--device_augment", action="store_true",
                   help="augment (rot90 / flip, rotation) on the device inside the "
                        "train step; the host loader only resizes")
    p.add_argument("--num_workers", type=int, default=8,
                   help="host loader threads")
    p.add_argument("--device", type=str, default="cuda", help="torch device to train on")
    return p


def main(argv=None) -> str:
    from ..parallel import destroy_distributed, init_distributed
    from ..utils.checkpoint import train_state_path

    args = build_parser().parse_args(argv)
    if args.resume:
        args.resume = train_state_path(args.resume)  # a missing state raises before any work
    if args.dataset == "Synapse":
        args.root_path = os.path.join(args.root_path, "train_npz")
    config = get_config(args)
    # Under torchrun: the process group, and cuda:LOCAL_RANK as the device
    # (a CUDA device without a card raises).
    rank, _, device = init_distributed(args.device)
    args.device = str(device)
    try:
        return _train(args, config, device, rank)
    finally:
        destroy_distributed()


def _train(args, config, device: torch.device, rank: int) -> str:
    from ..models import build_model
    from ..utils.checkpoint import load_from_pretrained
    from .trainer import trainer_synapse

    random.seed(args.seed)
    np.random.seed(args.seed)
    # LR/batch linear-scaling coupling (reference train.py:104-105).
    if args.batch_size != 24 and args.batch_size % 6 == 0:
        args.base_lr *= args.batch_size / 24
    args.num_classes = DATASETS[args.dataset]["num_classes"]
    args.list_dir = DATASETS[args.dataset]["list_dir"]
    os.makedirs(args.output_dir, exist_ok=True)

    model = build_model(config, img_size=args.img_size,
                        num_classes=args.num_classes, device=device,
                        seed=args.seed, train=True)
    ckpt_path = config.MODEL.PRETRAIN_CKPT
    if ckpt_path and os.path.exists(ckpt_path):
        if rank == 0:
            print(f"pretrained_path:{ckpt_path}")
        load_from_pretrained(model.cswin_unet, ckpt_path,
                             log=print if rank == 0 else lambda *a: None)
    elif rank == 0:
        print("none pretrain")
    return trainer_synapse(args, model, args.output_dir)


if __name__ == "__main__":
    main()
