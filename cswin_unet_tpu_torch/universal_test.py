"""Continual-evaluation CLI on one device:

    python -m cswin_unet_tpu_torch.universal_test --cfg C --volume_path DATA \
        --test_dataset synapse|kits23|lits17 --model_path CK_OR_DIR --output_dir OUT \
        [--device_metrics] [--device cuda] ...

The argparse surface of the root ``universal_test.py`` (reference
universal_test.py), plus ``--device`` (default ``cuda``; ``cuda`` without a
card raises). It finds the checkpoint (a file, or the newest final / epoch
checkpoint in a directory), detects the task level from the head's classes
(9 / 12 / 14) unless ``--model_task_level`` gives it, refuses a model
without the test dataset's output channels, and evaluates every case of
``<list_dir>/test_vol.txt`` on the dataset's channels of the expanded head
(gathered from the logits before the argmax) with the reference's log lines
(to ``<output_dir>/test_<dataset>.txt`` and stdout), then prints ``FLOPs:``
(torch's count, as the port's eval CLI) and ``Params:``.
"""

from __future__ import annotations

import argparse
import logging
import os
import random
import sys

import numpy as np
import torch

# Class channels of the expanded continual head (reference universal_test.py:27-40).
CLASS_MAPPINGS = {
    "synapse": {"classes": 9, "indices": list(range(9))},
    "kits23": {"classes": 4, "indices": [0] + list(range(9, 12))},
    "lits17": {"classes": 3, "indices": [0] + list(range(12, 14))},
}
TASK_CLASSES = {"task1": 9, "task2": 12, "task3": 14}
CLASS_TO_TASK = {9: "task1", 12: "task2", 14: "task3"}
LIST_DIRS = {
    "synapse": "./lists/lists_Synapse",
    "kits23": "./lists/kits23",
    "lits17": "./lists/lits17",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--volume_path", type=str, required=True,
                   help="root dir for validation volume data")
    p.add_argument("--test_dataset", type=str, required=True,
                   choices=["synapse", "kits23", "lits17"])
    p.add_argument("--model_path", type=str, required=True,
                   help="path to trained model checkpoint")
    p.add_argument("--model_task_level", type=str, choices=["task1", "task2", "task3"],
                   help="which task level the model was trained up to (auto-detected "
                        "if absent)")
    p.add_argument("--list_dir", type=str,
                   help="list dir (auto-set based on test_dataset if not provided)")
    p.add_argument("--output_dir", type=str, required=True, help="output dir for results")
    p.add_argument("--batch_size", type=int, default=1, help="batch_size for testing")
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--is_savenii", action="store_true")
    p.add_argument("--test_save_dir", type=str, default="./predictions")
    p.add_argument("--deterministic", type=int, default=1)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--cfg", type=str, required=True, metavar="FILE")
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
    p.add_argument("--device_metrics", action="store_true",
                   help="compute dice/hd95 on the device (the EDT kernel): predictions "
                        "never leave it; the host path is used automatically when "
                        "saving nii")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to evaluate on")
    return p


def main(argv=None, db_test=None) -> tuple[float, float]:
    """``db_test``: a sequence of ``{"image", "label", "case_name"}`` volumes
    in place of the list's ``.npy.h5`` files (which need h5py)."""
    from .config import get_config
    from .data import SynapseDataset
    from .eval.inference import VolumeInferencer, inference
    from .models import build_model
    from .utils.checkpoint import (detect_num_classes, find_checkpoint, load_checkpoint,
                                   load_into)
    from .utils.flops import clever_format, count_flops, count_params

    args = build_parser().parse_args(argv)
    config = get_config(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available")

    random.seed(args.seed)
    np.random.seed(args.seed)
    os.makedirs(args.output_dir, exist_ok=True)

    snapshot = find_checkpoint(args.model_path)
    if args.model_task_level:
        task_level = args.model_task_level
        model_num_classes = TASK_CLASSES[task_level]
    else:
        model_num_classes = detect_num_classes(snapshot)
        if model_num_classes not in CLASS_TO_TASK:
            raise RuntimeError(f"Unknown number of classes: {model_num_classes}. "
                               "Expected 9, 12, or 14.")
        task_level = CLASS_TO_TASK[model_num_classes]
        print(f"Auto-detected model task level: {task_level}")

    mapping = CLASS_MAPPINGS[args.test_dataset]
    # A gather past the head's channels would index out of range: refuse a
    # task level that lacks the dataset's channels, with the reason.
    if max(mapping["indices"]) >= model_num_classes:
        raise RuntimeError(
            f"Model task level {task_level} ({model_num_classes} classes) cannot "
            f"evaluate {args.test_dataset}, which needs output channels "
            f"{mapping['indices']}. Train the later continual stages first.")
    args.num_classes = mapping["classes"]
    args.list_dir = args.list_dir or LIST_DIRS[args.test_dataset]
    args.z_spacing = 1

    net = build_model(config, img_size=args.img_size, num_classes=model_num_classes,
                      device=device, seed=args.seed)
    load_into(net.cswin_unet, load_checkpoint(snapshot)[0])
    print(f"Loaded model from: {snapshot}")
    print(f"Testing on {args.test_dataset} using classes at indices: {mapping['indices']}")

    logging.basicConfig(
        filename=os.path.join(args.output_dir, f"test_{args.test_dataset}.txt"),
        level=logging.INFO, format="[%(asctime)s.%(msecs)03d] %(message)s",
        datefmt="%H:%M:%S", force=True)
    logging.getLogger().addHandler(logging.StreamHandler(sys.stdout))
    logging.info(str(args))

    test_save_path = None
    if args.is_savenii:
        test_save_path = os.path.join(args.output_dir, "predictions")
        os.makedirs(test_save_path, exist_ok=True)

    if db_test is None:
        db_test = SynapseDataset(base_dir=args.volume_path, split="test_vol",
                                 list_dir=args.list_dir)
    full_head = task_level == "task1" and args.test_dataset == "synapse"
    inferencer = VolumeInferencer(net, device=device, patch_size=(args.img_size,) * 2,
                                  class_indices=None if full_head else mapping["indices"])
    result = inference(args, inferencer, db_test, test_save_path)

    try:
        plain = build_model(config, img_size=args.img_size, num_classes=model_num_classes,
                            device=device, impl="plain", seed=args.seed)
        print("FLOPs:", clever_format(count_flops(plain, args.img_size)))
        print("Params:", clever_format(count_params(net)))
    except Exception as e:  # noqa: BLE001 — as the reference, the counts are extras
        print(f"Could not calculate FLOPs/Params: {e}")
    return result


if __name__ == "__main__":
    main()
