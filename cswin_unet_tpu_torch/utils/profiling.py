"""Profiling: a steady-state step timer, device traces, a synchronised
best-of-N timer and the device-busy reading of the port's kernels.

Counterpart of ``cswin_unet_tpu.utils.profiling``: ``StepTimer`` has the
same semantics (host clock between ticks, the first ``skip_first``
intervals dropped, a rolling window); ``device_trace`` wraps
``torch.profiler`` where the JAX package wraps ``jax.profiler`` and writes a
Chrome trace (``chrome://tracing``, Perfetto); ``block_and_time`` waits for
the result's device (``torch.cuda.synchronize``) where JAX blocks on the
array. ``device_busy_ms`` (the port's own) reads the union of a call's
device intervals from ``torch.profiler``, held to the kernels' launch
counters.
"""

from __future__ import annotations

import contextlib
import os
import re
import time

import torch


class StepTimer:
    """Rolling steady-state step timing (skips warm-up steps)."""

    def __init__(self, skip_first: int = 2, window: int = 50):
        self.skip_first = skip_first
        self.window = window
        self._count = 0
        self._times: list[float] = []
        self._last: float | None = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._count += 1
            if self._count > self.skip_first:
                self._times.append(now - self._last)
                if len(self._times) > self.window:
                    self._times.pop(0)
        self._last = now

    @property
    def mean_step_s(self) -> float:
        return sum(self._times) / len(self._times) if self._times else float("nan")

    def throughput(self, items_per_step: int) -> float:
        s = self.mean_step_s
        return items_per_step / s if s == s and s > 0 else float("nan")


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace the host and, when a card is present, the device:
    ``with device_trace('trace_dir') as prof: step()``. Writes
    ``<logdir>/trace.json`` (Chrome trace format) on exit and yields the
    profiler (``prof.key_averages()`` for sums by kernel)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _sync(out) -> None:
    """Wait for every CUDA device that holds a tensor of ``out``."""
    tensors = out if isinstance(out, (list, tuple)) else (
        list(out.values()) if isinstance(out, dict) else [out])
    for d in {t.device for t in tensors if isinstance(t, torch.Tensor)}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def block_and_time(fn, *args, iters: int = 3, **kwargs) -> tuple[float, object]:
    """Best-of-N wall time of ``fn`` with its result's device synchronised
    (the first call, a warm-up, excluded)."""
    out = fn(*args, **kwargs)
    _sync(out)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


# The port's __global__ functions (each kernel wrapper launches one of them
# per call, the float32 attention backward two: its row and key kernels; all
# in anonymous namespaces), as the profiler names them, demangled or not:
# what device_busy_ms holds to the launch counters (``device_launches``).
KERNEL_SYMBOLS = re.compile(
    r"(?:\(anonymous namespace\)::|_GLOBAL__N_\w*?\d)(?:layernorm|layernorm_bwd|gemm|"
    r"wgrad|stripe_attention|stripe_attention_bwd|carafe|edt_pass|block_pair|lepe_windows|"
    r"ln_mlp|block_one)(?:_f32)?(?:_rows|_keys)?_kernel")


def device_events(prof) -> list:
    """The profiler's device records: kernels, copies and sets, without the
    ranges user annotations draw on the device track (DDP's forward is one,
    spanning the idle gaps between its kernels)."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_busy_ms(fn, reps: int) -> float | None:
    """Device-busy ms per call: the union of the device intervals that
    ``torch.profiler`` records over ``reps`` back-to-back calls, over
    ``reps``. The profiler can lose records, so its count of the port's
    kernels (``KERNEL_SYMBOLS``) is held to the launch counters' count over
    the same calls: where they differ it prints ``busy unread (records r of
    n)`` and returns None, never a figure built from lost records; None too
    if it records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    from ..ops.cuda import kernels as K

    fn()
    torch.cuda.synchronize()
    before = K.device_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    launched = K.device_launches() - before
    events = device_events(prof)
    records = sum(1 for e in events if KERNEL_SYMBOLS.search(e.name))
    if records != launched:
        print(f"busy unread (records {records} of {launched})", flush=True)
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    if not spans:
        return None
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy, lo, hi = busy + hi - lo, s, e
        else:
            hi = max(hi, e)
    return (busy + hi - lo) / reps / 1e3  # the profiler counts µs
