"""Blur a dataset for the continual pipeline's robustness runs:

    python -m cswin_unet_tpu_torch.tools.apply_blur train \
        [--input_dir D] [--output_dir O] [--list_output_dir L] \
        [--sample_dir S] [--sigma 1.0] [--num_samples 3] [--device cuda]
    python -m cswin_unet_tpu_torch.tools.apply_blur test \
        [--input_dir D] [--output_dir O] [--sample_dir S] [--sigma 1.5] \
        [--num_samples 10] [--device cuda]

Counterpart of the root ``tools/apply_blur_train.py`` and
``tools/apply_blur_test.py`` (reference ``apply_blur_train.py`` /
``apply_blur_test.py``), with their flags and defaults, without JAX:

  * ``train``: every ``.npz`` slice of ``--input_dir`` blurred (σ 1.0), its
    label (``label`` or ``segmentation``) untouched, written compressed
    under the same name, and ``train.txt`` regenerated in
    ``--list_output_dir``; side-by-side figures of the first
    ``--num_samples`` slices with more than one label;
  * ``test``: every ``.h5`` volume of ``--input_dir`` with its image
    dataset (``image`` or ``images``) blurred slice by slice (σ 1.5) and
    every other dataset copied, each with its compression and chunking, and
    the file's attrs kept; the middle slice's figure for the first
    ``--num_samples`` volumes.

The blur is ``ops.blur.gaussian_blur_2d`` (scipy's ``gaussian_filter`` on
each 2-D slice: truncated, normalised kernel, ``reflect`` boundary) on
``--device`` (default ``cuda``; ``cpu`` runs the same ops on the host).
matplotlib (figures) and h5py (``test``) are imported only when used;
``--num_samples 0`` draws no figure.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..ops.blur import gaussian_blur_2d

DEFAULTS = {
    "train": dict(input_dir="./datasets/Synapse/train_npz",
                  output_dir="./datasets/Synapse_blurred/train_npz",
                  sample_dir="./blur_samples_train", sigma=1.0, num_samples=3),
    "test": dict(input_dir="./datasets/Synapse/test_vol_h5",
                 output_dir="./datasets/Synapse_blurred/test_vol_h5",
                 sample_dir="./blur_samples_test", sigma=1.5, num_samples=10),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="mode", required=True)
    for mode, d in DEFAULTS.items():
        s = sub.add_parser(mode)
        s.add_argument("--input_dir", default=d["input_dir"])
        s.add_argument("--output_dir", default=d["output_dir"])
        if mode == "train":
            s.add_argument("--list_output_dir", default="./lists/lists_Synapse_blurred")
        s.add_argument("--sample_dir", default=d["sample_dir"])
        s.add_argument("--sigma", type=float, default=d["sigma"])
        s.add_argument("--num_samples", type=int, default=d["num_samples"])
        s.add_argument("--device", default="cuda", help="torch device of the blur")
    return p


def blur(image: np.ndarray, sigma: float, device: torch.device) -> np.ndarray:
    """``image`` (..., H, W) blurred on ``device``, float32 on the host."""
    t = torch.from_numpy(np.ascontiguousarray(image, dtype=np.float32)).to(device)
    return gaussian_blur_2d(t, sigma).cpu().numpy()


def _figure(panels, out_path: str) -> None:
    """``panels``: (image, title, colormap) side by side, axes off."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, len(panels), figsize=(5 * len(panels), 5))
    for ax, (img, title, cmap) in zip(axes, panels):
        ax.imshow(img, cmap=cmap)
        ax.set_title(title)
        ax.axis("off")
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)


def _normalize(img: np.ndarray) -> np.ndarray:
    mn, mx = img.min(), img.max()
    return (img - mn) / (mx - mn) if mx > mn else img


def blur_train(args, device: torch.device) -> list[str]:
    """The ``train`` mode; returns the slice names written to train.txt."""
    os.makedirs(args.output_dir, exist_ok=True)
    os.makedirs(args.list_output_dir, exist_ok=True)
    if args.num_samples > 0:
        os.makedirs(args.sample_dir, exist_ok=True)
    files = sorted(f for f in os.listdir(args.input_dir) if f.endswith(".npz"))
    processed, samples = [], 0
    for i, fname in enumerate(files):
        data = np.load(os.path.join(args.input_dir, fname))
        image = data["image"]
        label = data["label"] if "label" in data else data["segmentation"]
        blurred = blur(image, args.sigma, device)
        np.savez_compressed(os.path.join(args.output_dir, fname), image=blurred, label=label)
        processed.append(os.path.splitext(fname)[0])
        if samples < args.num_samples and len(np.unique(label)) > 1:
            _figure([(image, "Original", "gray"), (blurred, f"Blurred (σ={args.sigma})", "gray"),
                     (label, f"Labels {sorted(np.unique(label).tolist())}", "jet")],
                    os.path.join(args.sample_dir, f"sample_{samples}.png"))
            samples += 1
        if (i + 1) % 200 == 0:
            print(f"{i + 1}/{len(files)} processed")
    with open(os.path.join(args.list_output_dir, "train.txt"), "w") as f:
        f.write("\n".join(processed) + "\n")
    print(f"Successfully wrote {len(processed)} entries to train.txt")
    return processed


def blur_test(args, device: torch.device) -> list[str]:
    """The ``test`` mode; returns the volumes written."""
    import h5py

    os.makedirs(args.output_dir, exist_ok=True)
    if args.num_samples > 0:
        os.makedirs(args.sample_dir, exist_ok=True)
    files = sorted(f for f in os.listdir(args.input_dir) if f.endswith(".h5"))
    samples = 0
    for fname in files:
        with h5py.File(os.path.join(args.input_dir, fname), "r") as f_in, \
                h5py.File(os.path.join(args.output_dir, fname), "w") as f_out:
            for key in f_in.attrs:
                f_out.attrs[key] = f_in.attrs[key]
            image_key = "image" if "image" in f_in else "images"
            for name in f_in:
                ds = f_in[name]
                data = ds[:]
                if name == image_key:
                    blurred = blur(data, args.sigma, device)
                    if samples < args.num_samples:
                        mid = data.shape[0] // 2
                        _figure([(_normalize(data[mid]), "Original", "gray"),
                                 (_normalize(blurred[mid]), f"Blurred (σ={args.sigma})",
                                  "gray")],
                                os.path.join(args.sample_dir, f"{fname}_mid.png"))
                        samples += 1
                    data = blurred
                f_out.create_dataset(name, data=data, compression=ds.compression,
                                     chunks=ds.chunks)
        print(f"blurred {fname}")
    return files


def main(argv=None) -> list[str]:
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available (--device cpu "
                           "blurs on the host)")
    return (blur_train if args.mode == "train" else blur_test)(args, device)


if __name__ == "__main__":
    main()
