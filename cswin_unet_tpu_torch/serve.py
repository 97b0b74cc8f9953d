"""Serving: CT volumes in, NIfTI labels and JSON stats lines out.

Counterpart of ``cswin_unet_tpu.serve`` and the root ``serve.py`` CLI, on one
CUDA device:

  one-shot:  python -m cswin_unet_tpu_torch.serve --cfg C --checkpoint ck.npz \
                 vol1.npy vol2.npz
  watching:  python -m cswin_unet_tpu_torch.serve --cfg C --checkpoint ck.npz \
                 --watch incoming/ --output_dir out/

``--checkpoint`` takes the JAX package's ``.npz`` files. The server warms the
forward once before the first volume; each volume prints one JSON stats
line. Watch mode moves inputs to ``done/`` (or ``failed/`` with the error).

``--trace_dir DIR`` processes the first volume after the warm-up under
``torch.profiler`` (``utils.profiling.device_trace``) and writes
``DIR/trace.json``, a Chrome trace (Perfetto, ``chrome://tracing``) that
holds the program's spans (``serve.read``, ``serve.segment`` with
``serve.prepare``, the inferencer's ``infer.*`` and ``serve.finish``, then
``serve.write``), the model's ``model.*`` stages, torch's ops and, on a
card, the kernels and copies, with each span drawn over the device work it
launched. That volume's stats line includes the profiler's cost.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from scipy.ndimage import zoom as nd_zoom

from .eval.inference import VolumeInferencer
from .utils.nifti import write_nifti
from .utils.profiling import device_trace, span

VOLUME_SUFFIXES = (".npy.h5", ".h5", ".npz", ".npy")


def read_volume(path: str) -> np.ndarray:
    """(D, H, W) float32 from .npy.h5/.h5 ('image'), .npz ('image'), .npy."""
    if path.endswith((".h5", ".npy.h5")):
        import h5py

        with h5py.File(path, "r") as f:
            key = "image" if "image" in f else "images"
            vol = f[key][:]
    elif path.endswith(".npz"):
        with np.load(path) as f:
            vol = f["image"]
    elif path.endswith(".npy"):
        vol = np.load(path)
    else:
        raise ValueError(f"unsupported volume format: {path}")
    vol = np.asarray(vol, dtype=np.float32)
    if vol.ndim == 2:
        vol = vol[None]
    if vol.ndim != 3:
        raise ValueError(f"expected (D, H, W) volume, got {vol.shape}: {path}")
    return vol


class VolumeServer:
    """Warm-once volume segmentation server on one device. With
    ``trace_dir`` the first volume ``process_file`` takes is traced into
    ``<trace_dir>/trace.json`` (``device_trace``)."""

    def __init__(self, model: torch.nn.Module, *, device: torch.device | str,
                 img_size: int = 224, batch_slices: int = 32,
                 class_indices=None, z_spacing: int = 1,
                 trace_dir: str | None = None):
        self.patch = (img_size, img_size)
        self.z_spacing = z_spacing
        self.trace_dir = trace_dir
        self.device = torch.device(device)
        self.inferencer = VolumeInferencer(
            model, device=self.device, patch_size=self.patch,
            batch_slices=batch_slices, class_indices=class_indices)

    def warmup(self) -> float:
        """Run the forward once on dummy data (builds the kernels); returns
        seconds."""
        t0 = time.perf_counter()
        self.inferencer.predict_slices(np.zeros((1,) + self.patch, np.float32))
        return time.perf_counter() - t0

    def segment(self, volume: np.ndarray) -> np.ndarray:
        """(D, H, W) float32 -> (D, H, W) int32 labels at input resolution."""
        d, x, y = volume.shape
        ph, pw = self.patch
        needs_zoom = (x, y) != (ph, pw)
        with span("serve.segment"), ThreadPoolExecutor(8) as pool:
            with span("serve.prepare"):
                if needs_zoom:
                    slices = np.stack(list(pool.map(
                        lambda s: nd_zoom(s, (ph / x, pw / y), order=3), volume
                    ))).astype(np.float32)
                else:
                    slices = volume.astype(np.float32)
            preds = self.inferencer.predict_slices(slices)
            with span("serve.finish"):
                if needs_zoom:
                    preds = np.stack(list(pool.map(
                        lambda s: nd_zoom(s, (x / ph, y / pw), order=0), preds
                    )))
                return preds.astype(np.int32)

    def process_file(self, path: str, output_dir: str) -> dict:
        """Segment one volume file; write <case>_pred.nii.gz; return stats."""
        if self.trace_dir is not None:
            trace_dir, self.trace_dir = self.trace_dir, None
            with device_trace(trace_dir):
                return self.process_file(path, output_dir)
        case = os.path.basename(path)
        for suf in VOLUME_SUFFIXES:
            if case.endswith(suf):
                case = case[: -len(suf)]
                break
        t0 = time.perf_counter()
        with span("serve.read"):
            vol = read_volume(path)
        t_read = time.perf_counter() - t0
        t0 = time.perf_counter()
        pred = self.segment(vol)
        t_seg = time.perf_counter() - t0
        os.makedirs(output_dir, exist_ok=True)
        out_path = os.path.join(output_dir, f"{case}_pred.nii.gz")
        t0 = time.perf_counter()
        with span("serve.write"):
            write_nifti(out_path, pred.astype(np.float32), (1, 1, self.z_spacing))
        t_write = time.perf_counter() - t0
        return {
            "case": case,
            "slices": int(vol.shape[0]),
            "shape": list(vol.shape),
            "output": out_path,
            "read_s": round(t_read, 4),
            "segment_s": round(t_seg, 4),
            "write_s": round(t_write, 4),
            "slices_per_s": round(vol.shape[0] / max(t_seg, 1e-9), 2),
        }


class ServeStats:
    """p50/p95 of per-volume segment and end-to-end latency, and overall
    slice throughput."""

    def __init__(self):
        self.seg_s: list[float] = []
        self.total_s: list[float] = []
        self.slices = 0
        self.failed = 0

    def record(self, stats: dict) -> None:
        self.seg_s.append(stats["segment_s"])
        self.total_s.append(stats["read_s"] + stats["segment_s"]
                            + stats["write_s"])
        self.slices += stats["slices"]

    def summary(self) -> dict:
        if not self.seg_s:
            return {"volumes": 0, "failed": self.failed}
        pct = lambda xs, q: round(float(np.percentile(xs, q)), 4)
        return {
            "volumes": len(self.seg_s),
            "failed": self.failed,
            "slices": self.slices,
            "segment_p50_s": pct(self.seg_s, 50),
            "segment_p95_s": pct(self.seg_s, 95),
            "latency_p50_s": pct(self.total_s, 50),
            "latency_p95_s": pct(self.total_s, 95),
            "slices_per_s": round(self.slices / max(sum(self.seg_s), 1e-9), 2),
        }


def watch_loop(server: VolumeServer, watch_dir: str, output_dir: str, *,
               poll_s: float = 1.0, quiesce_s: float | None = None,
               max_volumes: int | None = None, emit=print) -> int:
    """Poll ``watch_dir``, process each quiescent volume, move it to done/
    (failed/ on error). A file is taken once its (size, mtime) has been
    unchanged for ``quiesce_s`` seconds (default ``max(2·poll_s, 0.25)``);
    ``*.tmp`` names are ignored. ``max_volumes`` bounds the count (None =
    forever). Returns the count processed, after a summary line."""
    if quiesce_s is None:
        quiesce_s = max(2 * poll_s, 0.25)
    done_dir = os.path.join(watch_dir, "done")
    failed_dir = os.path.join(watch_dir, "failed")
    os.makedirs(done_dir, exist_ok=True)
    processed = 0
    agg = ServeStats()
    seen: dict[str, tuple] = {}  # name -> (sig, stable_since)
    while max_volumes is None or processed < max_volumes:
        now = time.monotonic()
        snap = {}
        for n in sorted(os.listdir(watch_dir)):
            if not n.endswith(VOLUME_SUFFIXES):
                continue
            p = os.path.join(watch_dir, n)
            if not os.path.isfile(p):
                continue
            try:
                st = os.stat(p)
            except OSError:
                continue  # renamed or removed between listdir and stat
            snap[n] = (st.st_size, st.st_mtime)
        for n, sig in snap.items():
            if n not in seen or seen[n][0] != sig:
                seen[n] = (sig, now)
        for n in list(seen):
            if n not in snap:
                del seen[n]
        ready = [n for n, sig in snap.items()
                 if sig[0] > 0 and now - seen[n][1] >= quiesce_s]
        if not ready:
            time.sleep(poll_s)
            continue
        for name in ready:
            if max_volumes is not None and processed >= max_volumes:
                break
            path = os.path.join(watch_dir, name)
            try:
                stats = server.process_file(path, output_dir)
                shutil.move(path, os.path.join(done_dir, name))
                agg.record(stats)
                emit(json.dumps(stats))
            except Exception as e:  # noqa: BLE001 — quarantine, keep serving
                os.makedirs(failed_dir, exist_ok=True)
                shutil.move(path, os.path.join(failed_dir, name))
                agg.failed += 1
                emit(json.dumps({"case": name, "error": str(e)[:200]}))
            seen.pop(name, None)
            processed += 1
    emit(json.dumps({"summary": agg.summary()}))
    return processed


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("volumes", nargs="*", help="volume files (.npy.h5/.npz/.npy)")
    p.add_argument("--cfg", type=str, required=True, metavar="FILE",
                   help="path to config file")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="model checkpoint (.npz of the JAX package)")
    p.add_argument("--output_dir", type=str, default="./served",
                   help="where predictions (<case>_pred.nii.gz) land")
    p.add_argument("--watch", type=str, default=None,
                   help="poll this directory for volumes instead of positional args")
    p.add_argument("--num_classes", type=int, default=9)
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--batch_slices", type=int, default=32,
                   help="slices per forward chunk")
    p.add_argument("--z_spacing", type=int, default=1)
    p.add_argument("--poll_s", type=float, default=1.0)
    p.add_argument("--max_volumes", type=int, default=None,
                   help="exit after N volumes (watch mode; default: run forever)")
    p.add_argument("--class_indices", type=int, nargs="+", default=None,
                   help="gather these output channels before argmax "
                        "(continual-learning task heads)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to serve on")
    p.add_argument("--trace_dir", type=str, default=None, metavar="DIR",
                   help="trace the first volume after the warm-up into DIR/trace.json")
    p.add_argument("--opts", default=None, nargs="+")
    return p


def main(argv=None) -> None:
    from .config import get_config
    from .models import build_model
    from .utils.checkpoint import load_checkpoint, load_into

    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.watch and not args.volumes:
        parser.error("provide volume paths or --watch DIR")
    config = get_config(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available")

    model = build_model(config, img_size=args.img_size,
                        num_classes=args.num_classes, device=device)
    flat, _ = load_checkpoint(args.checkpoint)
    load_into(model.cswin_unet, flat)

    server = VolumeServer(
        model, device=device, img_size=args.img_size,
        batch_slices=args.batch_slices, class_indices=args.class_indices,
        z_spacing=args.z_spacing, trace_dir=args.trace_dir)
    warm_s = server.warmup()
    print(json.dumps({"ready": True, "warmup_s": round(warm_s, 2),
                      "checkpoint": args.checkpoint,
                      "device": str(device)}), flush=True)

    if args.watch:
        n = watch_loop(server, args.watch, args.output_dir,
                       poll_s=args.poll_s, max_volumes=args.max_volumes,
                       emit=lambda s: print(s, flush=True))
        print(json.dumps({"drained": n}), flush=True)
        return
    for path in args.volumes:
        print(json.dumps(server.process_file(path, args.output_dir)), flush=True)


if __name__ == "__main__":
    main()
