"""Profiling: a steady-state step timer, device traces and a synchronised
best-of-N timer.

Counterpart of ``cswin_unet_tpu.utils.profiling``: ``StepTimer`` has the
same semantics (host clock between ticks, the first ``skip_first``
intervals dropped, a rolling window); ``device_trace`` wraps
``torch.profiler`` where the JAX package wraps ``jax.profiler`` and writes a
Chrome trace (``chrome://tracing``, Perfetto); ``block_and_time`` waits for
the result's device (``torch.cuda.synchronize``) where JAX blocks on the
array.
"""

from __future__ import annotations

import contextlib
import os
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
