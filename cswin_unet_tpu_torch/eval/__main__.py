"""Volume evaluation CLI on one device:

    python -m cswin_unet_tpu_torch.eval --cfg C --volume_path DATA --output_dir RUN
        [--device_metrics] [--is_savenii] [--device cuda]

The argparse surface of the root ``test.py`` (reference test.py:24-69), plus
``--device`` (default ``cuda``), so command lines are interchangeable. It
loads ``<output_dir>/best_model.npz``, else ``epoch_{max_epochs-1}.npz``
(the JAX package's ``.npz``, as the port's trainer writes it), evaluates
every case of ``<list_dir>/test_vol.txt`` with the reference's log lines
(to ``./test_log/test_log_/log_<dataset>.txt`` and stdout), and prints
``FLOPs:`` and ``Params:``. FLOPs are torch's count
(``torch.utils.flop_counter.FlopCounterMode``, the plain route, batch 1),
not the XLA cost analysis that the JAX ``test.py`` prints; Params is the
same count in both. ``--device_metrics`` computes Dice and HD95 on the
device through the EDT kernel; the host path runs for ``--is_savenii``.
"""

from __future__ import annotations

import argparse
import logging
import os
import random
import sys

import numpy as np
import torch

DATASETS = {
    "Synapse": {"list_dir": "./lists/lists_Synapse", "num_classes": 9, "z_spacing": 1},
    "kits23": {"list_dir": "./lists/kits23", "num_classes": 4, "z_spacing": 1},
    "lits17": {"list_dir": "./lists/lits17", "num_classes": 3, "z_spacing": 1},
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--volume_path", type=str, default="./datasets/Synapse/test_vol_h5",
                   help="root dir for validation volume data")
    p.add_argument("--dataset", type=str, default="Synapse", help="experiment_name")
    p.add_argument("--num_classes", type=int, default=9,
                   help="output channel of network")
    p.add_argument("--list_dir", type=str, default="./lists/lists_Synapse",
                   help="list dir")
    p.add_argument("--output_dir", type=str, help="output dir")
    p.add_argument("--max_iterations", type=int, default=30000)
    p.add_argument("--max_epochs", type=int, default=150)
    p.add_argument("--batch_size", type=int, default=24, help="batch_size per gpu")
    p.add_argument("--img_size", type=int, default=224,
                   help="input patch size of network input")
    p.add_argument("--is_savenii", action="store_true",
                   help="whether to save results during inference")
    p.add_argument("--test_save_dir", type=str, default="../predictions",
                   help="saving prediction as nii!")
    p.add_argument("--deterministic", type=int, default=1)
    p.add_argument("--base_lr", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=1234, help="random seed")
    p.add_argument("--cfg", type=str, required=True, metavar="FILE",
                   help="path to config file")
    p.add_argument("--opts", default=None, nargs="+",
                   help="Modify config options by adding 'KEY VALUE' pairs. ")
    p.add_argument("--zip", action="store_true")
    p.add_argument("--cache-mode", type=str, default="part",
                   choices=["no", "full", "part"])
    p.add_argument("--resume", help="resume from checkpoint")
    p.add_argument("--accumulation-steps", type=int)
    p.add_argument("--use-checkpoint", action="store_true")
    p.add_argument("--amp-opt-level", type=str, default="O1", choices=["O0", "O1", "O2"])
    p.add_argument("--tag", help="tag of experiment")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--throughput", action="store_true")
    p.add_argument("--device_metrics", action="store_true",
                   help="compute dice/hd95 on the device (the EDT kernel): "
                        "predictions never leave it; the host path is used "
                        "automatically when saving nii")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to evaluate on")
    return p


def main(argv=None) -> tuple[float, float]:
    from ..config import get_config
    from ..data import SynapseDataset
    from ..models import build_model
    from ..utils.checkpoint import load_checkpoint, load_into
    from ..utils.flops import clever_format, count_flops, count_params
    from .inference import VolumeInferencer, inference

    args = build_parser().parse_args(argv)
    if args.dataset == "Synapse":
        args.volume_path = os.path.join(args.volume_path, "test_vol_h5")
    config = get_config(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available")

    random.seed(args.seed)
    np.random.seed(args.seed)
    ds = DATASETS[args.dataset]
    args.num_classes = ds["num_classes"]
    args.list_dir = ds["list_dir"]
    args.z_spacing = ds["z_spacing"]

    model = build_model(config, img_size=args.img_size, num_classes=args.num_classes,
                        device=device, seed=args.seed)
    snapshot = os.path.join(args.output_dir, "best_model.npz")
    if not os.path.exists(snapshot):
        snapshot = os.path.join(args.output_dir, f"epoch_{args.max_epochs - 1}.npz")
    flat, _ = load_checkpoint(snapshot)
    load_into(model.cswin_unet, flat)
    print("Loaded model from:", snapshot)
    snapshot_name = snapshot.split("/")[-1]

    log_folder = "./test_log/test_log_"
    os.makedirs(log_folder, exist_ok=True)
    logging.basicConfig(filename=os.path.join(log_folder, f"log_{args.dataset}.txt"),
                        level=logging.INFO,
                        format="[%(asctime)s.%(msecs)03d] %(message)s",
                        datefmt="%H:%M:%S", force=True)
    logging.getLogger().addHandler(logging.StreamHandler(sys.stdout))
    logging.info(str(args))
    logging.info(snapshot_name)

    if args.is_savenii:
        args.test_save_dir = os.path.join(args.output_dir, "predictions")
        test_save_path = args.test_save_dir
        os.makedirs(test_save_path, exist_ok=True)
    else:
        test_save_path = None

    visual_save_dir = "./test_visuals"
    os.makedirs(visual_save_dir, exist_ok=True)
    logging.info(f"Visualizations will be saved to {visual_save_dir}")

    db_test = SynapseDataset(base_dir=args.volume_path, list_dir=args.list_dir,
                             split="test_vol")
    inferencer = VolumeInferencer(model, device=device,
                                  patch_size=(args.img_size, args.img_size))
    result = inference(args, inferencer, db_test, test_save_path, visual_save_dir)

    try:
        plain = build_model(config, img_size=args.img_size,
                            num_classes=args.num_classes, device=device,
                            impl="plain", seed=args.seed)
        print("FLOPs:", clever_format(count_flops(plain, args.img_size)))
        print("Params:", clever_format(count_params(model)))
    except Exception as e:  # noqa: BLE001 — as test.py, the counts are extras
        print(f"Could not calculate FLOPs/Params: {e}")
    return result


if __name__ == "__main__":
    main()
