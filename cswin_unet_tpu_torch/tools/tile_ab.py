"""One checkout's kernels timed at the main path's shapes, for holding two
builds against each other in one call on one card.

    python3 cswin_unet_tpu_torch/tools/tile_ab.py --root PARENT --harness . --out a1.json
    python3 cswin_unet_tpu_torch/tools/tile_ab.py --root . --out b1.json
    python3 cswin_unet_tpu_torch/tools/tile_ab.py --root . --out b2.json
    python3 cswin_unet_tpu_torch/tools/tile_ab.py --root PARENT --harness . --out a2.json
    python3 cswin_unet_tpu_torch/tools/tile_ab.py --table a1.json b1.json b2.json a2.json

``--root`` names the checkout whose ``cswin_unet_tpu_torch`` is imported,
so that its kernels are built and run; ``--harness`` the checkout whose
``chip_smoke.py`` gives the cases (default: the root's own), so that two
builds can be timed on the same cases. It runs ``chip_smoke.compare_kernels`` (every forward kernel at the shapes
of one 32-slice serving forward, each case held to its plain version, times
summed per forward, unpaired) and ``compare_backward_kernels`` (per bs-24
train step) and, where the harness has it, ``compare_base384_backward``
(weight 0; a build that refuses those windows is recorded as refusing
them), ``compare_edt`` (``edt_pass`` along the three axes of a
(48, 512, 512) volume, per 9-class ``volume_metrics_device`` call), then the
root's block lab's attention cases (``attn``: rows and
columns of (128, 56, 56, 32); ``attn3``: (512, 98, 128), 4 heads). Every
case is timed behind the lab's spin kernel (``chip_smoke.time_ms`` with
``primed``), so that a call shorter than its wrapper's host work reads
device time, not the host's enqueue rate. ``--out`` writes per kernel its
ms, bound_ms, plain_ms, library_ms and the kernel's ms over the library's
cases (``library_vs_ms``), and the lab's rows (median ms and min-max),
beside the card's name and power limit, and every ``[kernel]`` line
printed. ``--table`` prints the files side by side, one
column each, in the order given (parent, change, change, parent for an A/B
in turns).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

KERNELS = ("gemm", "gemm_dgrad", "stripe_attention", "cswin_attention", "block_pair",
           "layernorm", "carafe_reassemble", "layernorm_bwd", "gemm_wgrad",
           "stripe_attention_bwd", "edt_pass")


def measure(root: str, harness: str) -> dict:
    import torch

    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(harness, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = chip_smoke
    spec.loader.exec_module(chip_smoke)
    import cswin_unet_tpu_torch

    for mod, where in ((chip_smoke, harness), (cswin_unet_tpu_torch, root)):
        if not os.path.abspath(mod.__file__).startswith(where + os.sep):
            raise SystemExit(f"tile_ab: imported {mod.__file__}, not from {where}")
    from cswin_unet_tpu_torch.tools import block_lab

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    timer = chip_smoke.time_ms
    chip_smoke.time_ms = lambda fn, reps=10, rounds=5, primed=False: timer(
        fn, reps=reps, rounds=rounds, primed=True)
    cfg = chip_smoke.smoke_config()
    printed = io.StringIO()
    refused = None
    with contextlib.redirect_stdout(printed):
        tally = chip_smoke.compare_kernels(cfg, dev, chip_smoke.SERVE_BATCH)
        chip_smoke.compare_backward_kernels(cfg, dev, chip_smoke.TRAIN_BATCH, tally)
        if hasattr(chip_smoke, "compare_base384_backward"):
            try:
                chip_smoke.compare_base384_backward(dev, chip_smoke.TRAIN_BATCH, tally)
            except ValueError as e:  # a build whose kernel refuses 288-token windows
                refused = str(e)
        chip_smoke.compare_edt(dev, tally)
    print(printed.getvalue(), end="")
    rows: list[dict] = []
    for sub in ("attn", "attn3"):
        if block_lab.main([sub, "--batch", "128"], rows):
            raise SystemExit(f"tile_ab: block_lab {sub} failed")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    keys = ("ms", "bound_ms", "plain_ms", "library_ms", "library_vs_ms")
    return dict(root=root, harness=harness, device=torch.cuda.get_device_name(0),
                nvidia_smi=smi, base384_refused=refused,
                kernel_lines=[ln for ln in printed.getvalue().splitlines()
                              if ln.startswith("[kernel]")],
                kernels={k: {f: tally.rows[k][f] for f in keys} for k in KERNELS},
                lab=[{f: r[f] for f in ("sub", "case", "shape", "ms", "ms_min", "ms_max")}
                     for r in rows])


def table(paths: list[str]) -> None:
    runs = []
    for p in paths:
        with open(p) as f:
            runs.append(json.load(f))
    print("cards: " + "; ".join(f"{os.path.basename(p)} {r['nvidia_smi']}"
                                for p, r in zip(paths, runs)))
    head = " | ".join(os.path.basename(p) for p in paths)
    print(f"kernel (per unit of work): ms {head} | bound_ms | library_ms / the kernel's ms "
          f"on the same cases, per file")
    for k in KERNELS:
        cells = " | ".join(f"{r['kernels'][k]['ms']:.4f}" for r in runs)
        lib = " | ".join("none" if r["kernels"][k]["library_ms"] is None else
                         f"{r['kernels'][k]['library_ms']:.4f} / "
                         f"{r['kernels'][k]['library_vs_ms']:.4f}" for r in runs)
        print(f"{k}: {cells} | {runs[0]['kernels'][k]['bound_ms']:.4f} | {lib}")
    for p, r in zip(paths, runs):  # the weight-0 cases: per call, not summed
        lines = [ln for ln in r.get("kernel_lines", []) if "base-384" in ln]
        if r.get("base384_refused"):
            lines = [f"refused: {r['base384_refused']}"]
        for ln in lines:
            print(f"{os.path.basename(p)} {ln}")
    print(f"lab case: ms median [min-max] {head}")
    for i, row in enumerate(runs[0]["lab"]):
        cells = " | ".join(f"{r['lab'][i]['ms']:.4f} [{r['lab'][i]['ms_min']:.4f}-"
                           f"{r['lab'][i]['ms_max']:.4f}]" for r in runs)
        print(f"{row['sub']} {row['case']} {tuple(row['shape'])}: {cells}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", help="checkout whose kernels to time")
    ap.add_argument("--harness", help="checkout whose chip_smoke.py gives the cases "
                    "(default: the root)")
    ap.add_argument("--out", help="where to write the results (JSON)")
    ap.add_argument("--table", nargs="+", metavar="JSON", help="print result files side by side")
    args = ap.parse_args()
    if args.table:
        table(args.table)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("tile_ab: no CUDA device available", file=sys.stderr)
        return 2
    result = measure(os.path.abspath(args.root), os.path.abspath(args.harness or args.root))
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"[tile_ab] {args.root}: wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
