"""The reduction from a ``torch.profiler`` trace to device time.

The method of the program's ``utils.profiling.device_busy_ms``, copied: the
device records are the profiler's CUDA events without user annotations;
busy time is the union of their intervals; the records of the program's own
kernels (``PORT_KERNELS``) are counted and held to the program's launch
counters over the same stretch, and where the two differ the trace has lost
records and every reading built on it is left out, never guessed.
"""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field

import torch

# The program's __global__ functions, as the profiler names them (the
# kernels sit in anonymous namespaces), demangled or not.
_NS = r"(?:\(anonymous namespace\)::|_GLOBAL__N_\w*?\d)"
PORT_KERNELS = re.compile(
    _NS + r"(?:layernorm|layernorm_bwd|gemm|wgrad|stripe_attention|stripe_attention_bwd|"
    r"carafe|edt_pass|block_pair|lepe_windows|ln_mlp|block_one)(?:_f32)?(?:_rows|_keys)?"
    r"_kernel")
# Device kernels of each family the rooflines read, by the instance a
# configuration's compute_dtype runs. bf16: the GEMM family is the forward
# and dX (gemm_kernel) and the weight gradient (wgrad_kernel); the attention
# family the forward and the backward (the split's row and key kernels are
# instances of one template). float32: the same families' float32 kernels,
# the attention backward a row and a key kernel.
FAMILY_KERNELS = {
    "gemm": re.compile(_NS + r"(?:gemm|wgrad)_kernel"),
    "attention": re.compile(_NS + r"stripe_attention(?:_bwd)?_kernel"),
    "block_pair": re.compile(_NS + r"block_pair_kernel"),
}
F32_FAMILY_KERNELS = {
    "gemm": re.compile(_NS + r"(?:gemm|wgrad)_f32_kernel"),
    "attention": re.compile(_NS + r"stripe_attention(?:_bwd)?_f32(?:_rows|_keys)?_kernel"),
    "block_pair": re.compile(_NS + r"block_pair_f32_kernel"),
}
FAMILIES = {"bfloat16": FAMILY_KERNELS, "float32": F32_FAMILY_KERNELS}


@dataclass
class Trace:
    """One traced stretch: device records ``(name, start_us, end_us)``, the
    host's CPU ranges, the stretch's host-clock length, and the program's
    launch counters over it."""
    device: list[tuple[str, float, float]]
    cpu: list = field(default_factory=list)
    window_s: float = 0.0
    launched: int = 0                       # device kernels by the counters
    counts: dict = field(default_factory=dict)
    units: list = field(default_factory=list)   # steps, or each forward's batch
    optimizer_s: float | None = None
    done: float = 0.0       # work traced, in the window's unit (steps, slices)

    @property
    def tallied(self) -> bool:
        """The profiler kept a record of every kernel the program launched."""
        return sum(1 for n, _, _ in self.device if PORT_KERNELS.search(n)) == self.launched

    def merged(self) -> list[tuple[float, float]]:
        spans = sorted((s, e) for _, s, e in self.device)
        out: list[list[float]] = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def raw_busy_s(self) -> float:
        """The union of the device records, tallied or not."""
        return sum(e - s for s, e in self.merged()) / 1e6

    @property
    def busy_s(self) -> float | None:
        """The union of the device records, or None where the profiler lost
        records of the program's kernels."""
        if not self.device or not self.tallied:
            return None
        return self.raw_busy_s

    @property
    def kernels(self) -> int:
        """Device kernel records, the program's and torch's (not copies or
        sets)."""
        return sum(1 for n, _, _ in self.device if not n.startswith(("Memcpy", "Memset")))

    def family_s(self, family: str, compute_dtype: str) -> float:
        """Device seconds of ``family``'s kernels of the instance that
        ``compute_dtype`` runs."""
        pat = FAMILIES[compute_dtype][family]
        return sum(e - s for n, s, e in self.device if pat.search(n)) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, by name, and the
        longest idle gaps between device records, each named by the
        innermost host range open at its start."""
        by_name: dict[str, float] = defaultdict(float)
        for n, s, e in self.device:
            by_name[short_name(n)] += (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        merged = self.merged()
        gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self.host_range_at(a), (b - a) / 1e6] for a, b in gaps]}

    def host_range_at(self, t: float) -> str:
        best = None
        for name, s, e in self.cpu:
            if s <= t <= e and (best is None or e - s < best[2] - best[1]):
                best = (name, s, e)
        return short_name(best[0]) if best else "none"


def short_name(name: str) -> str:
    """A kernel's or range's name without its return type and its parameter
    list (the last balanced "(...)"), at most 96 characters."""
    n = name.removeprefix("void ")
    if n.endswith(")"):
        depth = 0
        for i in range(len(n) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(n[i], 0)
            if depth == 0:
                n = n[:i].rstrip() or n
                break
    return n[:96]


def collect(prof) -> tuple[list, list]:
    """(device records, CPU ranges) of a finished ``torch.profiler.profile``."""
    device, cpu = [], []
    for e in prof.events():
        rec = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                device.append(rec)
        else:
            cpu.append(rec)
    return device, cpu


def optimizer_device_s(prof) -> float | None:
    """Device seconds of the kernels launched under torch's
    ``Optimizer.step#<name>.step`` ranges: the kernels the profiler ties to
    each host op inside such a range, each once. None where there is no
    such range or it launched nothing on the device."""
    events = list(prof.events())
    ranges = [(e.thread, e.time_range.start, e.time_range.end) for e in events
              if e.name.startswith("Optimizer.step#")]
    if not ranges:
        return None
    total = 0.0
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        if any(t == e.thread and s <= e.time_range.start and e.time_range.end <= end
               for t, s, end in ranges):
            total += sum(k.duration for k in e.kernels)
    return total / 1e6 if total > 0 else None
