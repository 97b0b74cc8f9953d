"""Logging with the reference's exact format: file ``<out>/log.txt`` plus
stdout, '[%H:%M:%S.%(msecs)03d] message'. Counterpart of
``cswin_unet_tpu.utils.logging_utils``; downstream tooling parses these
lines, so the format is part of the API."""

from __future__ import annotations

import logging
import os
import sys

import numpy as np
import torch

from ..parallel import all_reduce_mean_


def setup_logging(snapshot_path: str, filename: str = "log.txt") -> None:
    os.makedirs(snapshot_path, exist_ok=True)
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
    logging.basicConfig(
        filename=os.path.join(snapshot_path, filename),
        level=logging.INFO,
        format="[%(asctime)s.%(msecs)03d] %(message)s",
        datefmt="%H:%M:%S",
        force=True,
    )
    root.addHandler(logging.StreamHandler(sys.stdout))


def _to_host(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return v.item() if v.ndim == 0 else v.numpy()
    if isinstance(v, dict):
        return {k: _to_host(x) for k, x in v.items()}
    return v


class MetricBuffer:
    """Deferred metric pull: the train loop appends device scalars and an
    emit callback per step; only every ``flush_every`` steps are they
    copied to the host, in one pass, and emitted in order. The hot loop
    never waits for the device per step."""

    def __init__(self, flush_every: int = 20):
        self.flush_every = flush_every
        self._buf = []

    def append(self, step: int, device_values, emit) -> None:
        """``emit(step, host_values)`` is called at flush time with the
        values copied to the host (tensors -> Python scalars / numpy)."""
        self._buf.append((step, device_values, emit))
        if len(self._buf) >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        # Under a process group the 0-d values are averaged over the ranks,
        # in place: one collective a flush, not a host sync a step.
        all_reduce_mean_([v for _, values, _ in self._buf for v in values.values()
                          if isinstance(v, torch.Tensor) and v.ndim == 0])
        for step, values, emit in self._buf:
            emit(step, _to_host(values))
        self._buf.clear()


class SummaryWriter:
    """tensorboardX writer with a no-op fallback."""

    def __init__(self, logdir: str):
        try:
            from tensorboardX import SummaryWriter as TBWriter

            self._w = TBWriter(logdir)
        except Exception:
            self._w = None

    def add_scalar(self, tag, value, step):
        if self._w is not None:
            self._w.add_scalar(tag, float(value), step)

    def add_image(self, tag, img, step):
        if self._w is not None:
            self._w.add_image(tag, np.asarray(img), step)

    def close(self):
        if self._w is not None:
            self._w.close()
