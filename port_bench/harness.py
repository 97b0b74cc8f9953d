"""What every cell shares: finding its files by name, the clock, the
profiled stretch, the per-layer readers and the result line.

A cell is ``workloads/<name>.json``: its configuration
(``configs/<config>.json``), its traffic (``traffic/<traffic>.json``, whose
``mode`` names the driver ``drivers/<mode>.py`` that runs it), its
end-to-end metrics, the length of its traced stretch and the limits of its
output check. Per-layer metrics are the readers ``metrics/<metric>.py``,
each run in every traced run; a reader that finds nothing to read returns
None and its metric is left out of the line.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cswin_unet_tpu")


def load_json(kind: str, name: str, root: Path = HERE) -> dict:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_cell(name: str, root: Path = HERE) -> dict:
    """The workload ``name`` with its configuration and traffic resolved."""
    cell = load_json("workloads", name, root)
    cell["name"] = name
    cell["config_data"] = load_json("configs", cell["config"], root)
    cell["traffic_data"] = load_json("traffic", cell["traffic"], root)
    return cell


def driver(mode: str):
    return importlib.import_module(f"port_bench.drivers.{mode}")


def readers(root: Path = HERE) -> dict:
    """Every per-layer reader under ``metrics/``, by metric name."""
    out = {}
    for path in sorted((root / "metrics").glob("*.py")):
        spec = importlib.util.spec_from_file_location(f"port_bench_metric_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[path.stem] = mod
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def log(message: str) -> None:
    """A progress line on standard error, with the process's clock."""
    print(f"[port_bench {time.perf_counter():9.2f}] {message}", file=sys.stderr, flush=True)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Context:
    """What a per-layer reader reads: the cell's configuration and traffic,
    the counts of the run's measured window (``window``) and its traced
    stretch (``trace``, a ``trace.Trace``)."""
    mode: str
    cfg: dict
    traffic: dict
    window: dict
    trace: object


@dataclass
class Outcome:
    """A driver's run: end-to-end metrics, per-layer context, the numbers
    of the output check beside their limits."""
    metrics: dict
    attempted: int
    failed: int
    checks: dict
    memory_peak_bytes: int
    context: Context | None = None


def profiled(device: torch.device, fn):
    """Run ``fn()`` under ``torch.profiler`` (host and device), between two
    synchronisations. Returns (fn's result, profiler, seconds)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        window_s = time.perf_counter() - t0
    return out, prof, window_s


def check_line(checks: dict) -> tuple[bool, list[str]]:
    """Whether every compared number lies within its limit, and one line a
    number."""
    lines, ok = [], True
    for name, c in checks.items():
        good = c["value"] == c["value"] and c["value"] <= c["limit"]
        ok &= good
        lines.append(f"check {name} {c['value']!r} limit {c['limit']!r} "
                     f"{'ok' if good else 'FAIL'}")
    return ok, lines


def per_layer(ctx: Context, root: Path = HERE) -> dict:
    out = {}
    for name, mod in readers(root).items():
        value = mod.read(ctx)
        if value is not None:
            out[name] = {"value": float(value), "unit": mod.UNIT}
    return out
