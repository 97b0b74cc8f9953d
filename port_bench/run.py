"""The benchmark of ``cswin_unet_tpu_torch`` on NVIDIA GPUs: one cell, one run.

    python port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's files by name (``harness.load_cell``), runs its traffic's
driver on the card, checks the outputs against the plain reference, and
prints the result as one JSON line, the last of standard output: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` the
per-layer metrics of every reader under ``metrics/`` that finds something
to read, and the device's busy time over a profiled stretch. The numbers
compared, each beside its limit, end standard error and the result line.
Exits non-zero, printing no result, without enough CUDA devices, or when a
module of JAX or of the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".port_bench_cache"
# Build and kernel caches of the libraries inside the checkout, at fixed
# paths (the port's own kernel library builds into its package's _build/).
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("USE_FLAX", "0")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from port_bench import harness  # noqa: E402


def card_line() -> str:
    """The card's name, SM clock, its maximum and the power limit, read by
    nvidia-smi."""
    q = "name,clocks.sm,clocks.max.sm,power.limit,power.draw,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=False)
        return f"nvidia-smi ({q}): {out.stdout.strip() or out.stderr.strip()}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float | None = None,
             root: Path = harness.HERE, cell: dict | None = None) -> dict:
    """One run of the cell ``name``; the result as a dict (keys in the
    order of the line). ``cell`` replaces the cell's files (the tests' small
    sizes)."""
    cell = cell or harness.load_cell(name, root)
    dev = torch.device(device)
    drv = harness.driver(cell["traffic_data"]["mode"])
    out = drv.run(cell, seed, seconds, trace, dev,
                  time.perf_counter() if t_start is None else t_start)
    ok, lines = harness.check_line(out.checks)
    if trace:
        metrics = harness.per_layer(out.context, root)
    else:
        metrics = {k: {"value": v, "unit": u} for k, (v, u) in out.metrics.items()
                   if k in cell["end_to_end"]}
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1, "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": ok and out.failed == 0, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": info}
    if trace:
        tr = out.context.trace
        busy = tr.busy_s
        info["busy_s"] = busy if busy is not None else tr.raw_busy_s
        info["window_s"] = tr.window_s
        info["busy_tallied"] = busy is not None
        result["breakdown"] = tr.breakdown()
    result["checks"] = out.checks
    result["_lines"] = lines
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cell = harness.load_cell(args.workload)
    chips = cell.get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(card_line(), file=sys.stderr, flush=True)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      t_start=T_START, cell=cell)
    lines = result.pop("_lines")
    harness.log("done")
    bad = harness.forbidden_modules()
    if bad:
        print(f"port_bench: JAX modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
