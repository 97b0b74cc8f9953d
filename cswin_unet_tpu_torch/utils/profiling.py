"""Profiling: the program's spans, device traces and the device-busy
reading of the port's kernels.

``span(name)`` marks a stretch of the program's host work on
``torch.profiler``: while a profiler records (``device_trace``, or any
``torch.profiler.profile``) it is a ``record_function`` range, on the same
clock as the kernel and copy records, and a Chrome trace also draws it over
the device work it launched; otherwise it is one shared no-op, so the
program pays one check a span. Names are ``<layer>.<part>`` (``SPAN_NAMES``).
``device_trace`` wraps ``torch.profiler`` where the JAX package wraps
``jax.profiler`` and writes a Chrome trace (``chrome://tracing``,
Perfetto). ``device_busy_ms`` reads the union of a call's device intervals
from ``torch.profiler``, held to the kernels' launch counters.
"""

from __future__ import annotations

import contextlib
import os
import re

import torch

# Every span the program opens, by layer: the server (serve.py), the
# inferencer (eval/inference.py), the train step (train/trainer.py) and the
# model's stages and CARAFE tail (models/cswin_unet.py).
SPAN_NAMES = (
    "serve.read", "serve.segment", "serve.prepare", "serve.finish", "serve.write",
    "infer.volume", "infer.chunk", "infer.pad", "infer.copy_in", "infer.forward",
    "infer.drain",
    "train.step", "train.augment", "train.forward", "train.loss", "train.backward",
    "train.optimizer",
    "model.stage1", "model.stage2", "model.stage3", "model.stage4",
    "model.stage_up4", "model.stage_up3", "model.stage_up2", "model.stage_up1",
    "model.tail",
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """``with span("infer.chunk"): ...``: a ``record_function`` range named
    ``name`` while a profiler records, else a shared no-op that creates
    nothing and reads no clock."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


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
