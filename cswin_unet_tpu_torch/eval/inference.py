"""Volume inference: batched slice-wise segmentation and per-case metrics,
on one device.

Counterpart of ``cswin_unet_tpu.eval.inference`` (reference
``test_single_volume``, ``utils.py:61-102``, and ``inference``,
``test.py:103-165``). ``VolumeInferencer`` sends slices at the model's
patch size through the forward in fixed-size chunks, the last chunk padded
up to the smallest bucket that holds it (8/16/32 at ``batch_slices`` 32),
so a 33-slice volume runs 32 + 8 slices, not 32 + 32. Without
``class_indices`` the model emits labels straight from its tail; with them
the logits path gathers those channels before the argmax.

``test_single_volume`` zooms the slices to the patch size (bicubic, on the
host), segments them and scores classes 1..C-1 with Dice and HD95 at native
resolution: on the host (nearest zoom back with scipy, ``metrics``), or with
``device_metrics`` entirely on the model's device (``ops.edt``: the labels
never leave it, only the (C-1, 2) metric array comes back). ``inference``
is the per-case loop with the reference's log lines.

Data parallelism over the devices of one process (the JAX inferencer's
``data_parallel``): with ``devices`` (or ``data_parallel`` on, by default
when more than one CUDA device is visible and no process group spans
processes) the inferencer holds one replica of the model per device, splits
every chunk into contiguous equal parts, one a device, launches each part on
its replica under ``torch.cuda.device`` (the kernels launch on the current
device) and gathers the parts in order. Slices are independent, so there
are no collectives. The part count divides ``batch_slices``, and the tail
buckets halve only while the part count divides them.
"""

from __future__ import annotations

import copy
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext

import numpy as np
import torch
from scipy.ndimage import zoom as nd_zoom

from ..metrics import volume_metrics
from ..parallel import devices_for_batch, local_devices, world_size
from ..utils.nifti import write_nifti
from ..utils.profiling import span


class VolumeInferencer:
    """Chunked slice segmentation with tail buckets, on one device or split
    over several (``devices``, ``data_parallel``)."""

    def __init__(self, model: torch.nn.Module, *, device: torch.device | str,
                 patch_size=(224, 224), batch_slices: int = 32,
                 class_indices=None, data_parallel: bool | None = None,
                 devices=None):
        self.model = model
        self.device = torch.device(device)
        self.patch = tuple(patch_size)
        self.batch = batch_slices
        if devices is None:
            if data_parallel is None:
                # one process's own devices only: under a process group that
                # spans processes each rank has its device (JAX's
                # process_count() == 1 rule)
                data_parallel = (self.device.type == "cuda" and world_size() == 1
                                 and torch.cuda.device_count() > 1)
            devices = local_devices() if data_parallel else [self.device]
        self.devices = [_indexed(d) for d in devices_for_batch(batch_slices, devices)]
        n = len(self.devices)
        # The model serves the first part on its own device; every other
        # part runs on a copy of it on that part's device.
        home = next(model.parameters()).device
        first = self.devices.index(home) if home in self.devices else None
        self.replicas = [model if i == first else copy.deepcopy(model).to(d)
                         for i, d in enumerate(self.devices)]
        self._buckets = [batch_slices]
        while (self._buckets[0] % 2 == 0 and self._buckets[0] // 2 >= 8
               and self._buckets[0] // 2 % n == 0):
            self._buckets.insert(0, self._buckets[0] // 2)
        self._idx = (None if class_indices is None else
                     torch.as_tensor(class_indices, dtype=torch.long,
                                     device=self.device))

    @torch.inference_mode()
    def _forward(self, images: torch.Tensor, model: torch.nn.Module) -> torch.Tensor:
        if self._idx is None:
            return model(images, emit="labels")
        logits = model(images)[..., self._idx.to(images.device)]
        return torch.softmax(logits, dim=-1).argmax(-1).to(torch.int32)

    def _chunk(self, x: np.ndarray, start: int):
        """The chunk at ``start``, padded to its bucket, segmented: (real,
        [labels of each part, on its device])."""
        with span("infer.chunk"):
            real = min(self.batch, x.shape[0] - start)
            size = next(b for b in self._buckets if b >= real)
            chunk = x[start:start + real]
            if real < size:  # pad to the bucket's shape
                with span("infer.pad"):
                    pad = np.repeat(chunk[-1:], size - real, axis=0)
                    chunk = np.concatenate([chunk, pad], axis=0)
            per = size // len(self.devices)
            preds = []
            for i, (d, replica) in enumerate(zip(self.devices, self.replicas)):
                with span("infer.copy_in"):
                    part = torch.from_numpy(chunk[i * per:(i + 1) * per]).to(
                        d, non_blocking=True)
                with (torch.cuda.device(d) if d.type == "cuda" else nullcontext()), \
                        span("infer.forward"):
                    preds.append(self._forward(part, replica))
            return real, preds

    def predict_slices(self, slices: np.ndarray) -> np.ndarray:
        """(N, H, W) float32 at patch size -> (N, H, W) int32 labels.

        Every chunk is queued on the device before the results are copied
        back, keeping at most a few in flight, so host copies overlap the
        device's work."""
        with span("infer.volume"):
            n = slices.shape[0]
            out = np.empty((n,) + self.patch, dtype=np.int32)
            x = np.ascontiguousarray(slices, dtype=np.float32)[..., None]  # NHWC
            pending = []

            def drain(item):
                start, real, preds = item
                with span("infer.drain"):
                    for pred in preds:  # the parts in order; the bucket's padding dropped
                        k = min(pred.shape[0], real)
                        out[start:start + k] = pred[:k].cpu().numpy()
                        start, real = start + k, real - k

            start = 0
            while start < n:
                real, preds = self._chunk(x, start)
                pending.append((start, real, preds))
                if len(pending) > 6:
                    drain(pending.pop(0))
                start += real
            for item in pending:
                drain(item)
            return out

    def predict_slices_device(self, slices: np.ndarray) -> torch.Tensor:
        """(N, H, W) float32 at patch size -> (N, H, W) int32 labels kept on
        the device (``device``; the device-metrics path copies no volume
        back)."""
        with span("infer.volume"):
            n = slices.shape[0]
            x = np.ascontiguousarray(slices, dtype=np.float32)[..., None]
            parts = []
            start = 0
            while start < n:
                real, preds = self._chunk(x, start)
                parts.append(torch.cat([p.to(self.device) for p in preds])[:real])
                start += real
            return torch.cat(parts) if len(parts) > 1 else parts[0]


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current device>``: a device a replica can name."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _zoom_slices(pool: ThreadPoolExecutor, vol: np.ndarray, factors,
                 order: int) -> np.ndarray:
    return np.stack(list(pool.map(lambda s: nd_zoom(s, factors, order=order), vol)))


def test_single_volume(image: np.ndarray, label: np.ndarray,
                       inferencer: VolumeInferencer, classes: int,
                       patch_size=(224, 224), test_save_path: str | None = None,
                       case: str | None = None, z_spacing: int = 1,
                       device_metrics: bool = False):
    """Segment one volume and compute per-class (dice, hd95).

    image/label: (D, H, W) numpy (or (H, W), a single slice).

    ``device_metrics`` keeps the tail on the inferencer's device: the
    predictions stay there, the inverse zoom is the scipy-exact nearest
    gather (``ops.edt.zoom_nearest``) and (dice, hd95) come from the EDT
    kernel (``ops.edt.volume_metrics_device``); only the (C-1, 2) metric
    array is copied back. The host path runs instead for 2-D inputs (2-D
    boundary semantics) and when saving NIfTI, as in the JAX package. The
    JAX package pads the depth to multiples of 16 for its compiler's sake;
    the padding is exact and eager PyTorch does not need it.
    """
    image = np.asarray(image)
    label = np.asarray(label)
    single = image.ndim == 2
    if single:
        image = image[None]

    x, y = image.shape[1], image.shape[2]
    ph, pw = patch_size
    needs_zoom = (x, y) != (ph, pw)

    with ThreadPoolExecutor(8) as pool:
        slices = (_zoom_slices(pool, image, (ph / x, pw / y), 3) if needs_zoom
                  else image).astype(np.float32)
        if device_metrics and not single and test_save_path is None:
            from ..ops.edt import volume_metrics_device, zoom_nearest

            preds = inferencer.predict_slices_device(slices)
            if needs_zoom:
                preds = zoom_nearest(preds, (x, y))
            lab = torch.from_numpy(label.astype(np.int32)).to(preds.device)
            metrics = volume_metrics_device(preds, lab, classes).cpu().numpy()
            return [tuple(float(v) for v in row) for row in metrics]

        preds = inferencer.predict_slices(slices)
        prediction = (_zoom_slices(pool, preds, (x / ph, y / pw), 0) if needs_zoom
                      else preds)
    prediction = prediction.astype(label.dtype, copy=False)
    if single:
        prediction = prediction[0]

    metric_list = volume_metrics(prediction, label, classes)

    if test_save_path is not None and case is not None:
        os.makedirs(test_save_path, exist_ok=True)
        spacing = (1, 1, z_spacing)
        write_nifti(os.path.join(test_save_path, f"{case}_pred.nii.gz"),
                    prediction.astype(np.float32), spacing)
        write_nifti(os.path.join(test_save_path, f"{case}_img.nii.gz"),
                    image.astype(np.float32), spacing)
        write_nifti(os.path.join(test_save_path, f"{case}_gt.nii.gz"),
                    label.astype(np.float32), spacing)
    return metric_list


def save_visuals(image, label, prediction, case_name, slice_idx, save_dir,
                 num_classes):
    """Side-by-side input / ground truth / prediction PNG (reference
    test.py:73-100)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(18, 6))
    axes[0].imshow(np.squeeze(image), cmap="gray")
    axes[0].set_title("Input Image")
    axes[1].imshow(np.squeeze(label), cmap="jet", vmin=0, vmax=num_classes - 1)
    axes[1].set_title("Ground Truth")
    axes[2].imshow(np.squeeze(prediction), cmap="jet", vmin=0, vmax=num_classes - 1)
    axes[2].set_title("Model Prediction")
    for ax in axes:
        ax.axis("off")
    fig.savefig(os.path.join(save_dir, f"{case_name}_slice_{slice_idx}.png"),
                bbox_inches="tight", pad_inches=0.1)
    plt.close(fig)


def inference(args, inferencer: VolumeInferencer, db_test, test_save_path=None,
              visual_save_dir=None, max_visuals: int = 5):
    """Per-case evaluation loop with the reference's log lines
    (test.py:103-165); mid-slice visuals for the first ``max_visuals``
    cases when ``visual_save_dir`` is set (test.py:128-153). ``db_test`` is
    any sequence of ``{"image", "label", "case_name"}`` dicts."""
    logging.info(f"{len(db_test)} test iterations per epoch")
    metric_sum = 0.0
    num_visuals_saved = 0
    for i_batch in range(len(db_test)):
        sample = db_test[i_batch]
        image, label = sample["image"], sample["label"]
        case_name = sample["case_name"]

        if visual_save_dir and num_visuals_saved < max_visuals and image.ndim == 3:
            mid = image.shape[0] // 2
            ph = pw = args.img_size
            x, y = image.shape[1], image.shape[2]
            mid_in = nd_zoom(image[mid], (ph / x, pw / y), order=3).astype(np.float32)
            pred_mid = inferencer.predict_slices(mid_in[None])[0]
            pred_mid = nd_zoom(pred_mid, (x / ph, y / pw), order=0)
            os.makedirs(visual_save_dir, exist_ok=True)
            save_visuals(image[mid], label[mid], pred_mid, case_name, mid,
                         visual_save_dir, args.num_classes)
            num_visuals_saved += 1
        metric_i = test_single_volume(
            image, label, inferencer, classes=args.num_classes,
            patch_size=(args.img_size, args.img_size),
            test_save_path=test_save_path, case=case_name,
            z_spacing=getattr(args, "z_spacing", 1),
            device_metrics=getattr(args, "device_metrics", False),
        )
        metric_sum = metric_sum + np.array(metric_i)
        logging.info(
            "idx %d case %s mean_dice %f mean_hd95 %f"
            % (i_batch, case_name, np.mean(metric_i, axis=0)[0],
               np.mean(metric_i, axis=0)[1])
        )
    metric_list = metric_sum / len(db_test)
    for i in range(1, args.num_classes):
        logging.info(
            "Mean class %d mean_dice %f mean_hd95 %f"
            % (i, metric_list[i - 1][0], metric_list[i - 1][1])
        )
    performance = np.mean(metric_list, axis=0)[0]
    mean_hd95 = np.mean(metric_list, axis=0)[1]
    logging.info(
        "Testing performance in best val model: mean_dice : %f mean_hd95 : %f"
        % (performance, mean_hd95)
    )
    return performance, mean_hd95
