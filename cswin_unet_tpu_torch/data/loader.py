"""Host data loading: a threaded batcher and a one-batch-ahead device copy.

Counterpart of ``cswin_unet_tpu.data.loader``:

  * a thread pool decodes and augments samples ahead of consumption;
  * batches have a fixed shape — the final partial batch is padded by
    wrapping around the shuffled epoch;
  * each sample's rng is ``np.random.default_rng((seed, epoch, index))``, so
    batches do not depend on thread scheduling and equal the JAX loader's
    for the same seed;
  * ``device_prefetch`` copies each batch from pinned host memory to the
    device with ``non_blocking`` copies on a side stream one batch ahead,
    so the copy of batch i + 1 overlaps the step on batch i.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import Iterator

import numpy as np
import torch


class DataLoader:
    """Each ``__iter__`` is the next epoch, counted from 0."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 seed: int = 1234, num_workers: int = 8):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.epoch = 0

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(idx)
        return np.resize(idx, len(self) * self.batch_size)  # wrap-around pad

    def __iter__(self) -> Iterator[dict]:
        indices = self._epoch_indices()
        epoch = self.epoch
        self.epoch += 1  # next __iter__ = next epoch, even if partially consumed

        def fetch(i: int):
            rng = np.random.default_rng((self.seed, epoch, int(i)))
            return self.dataset.__getitem__(int(i), rng)

        with ThreadPoolExecutor(self.num_workers) as pool:
            batch = []
            for sample in pool.map(fetch, indices):
                batch.append(sample)
                if len(batch) == self.batch_size:
                    yield _collate(batch)
                    batch = []


def _collate(samples: list[dict]) -> dict:
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        out[key] = np.stack(vals) if isinstance(vals[0], np.ndarray) else vals
    return out


class _OnDevice:
    """A batch whose host-to-device copies were issued on ``stream``."""

    def __init__(self, batch: dict, device: torch.device, stream):
        self.batch, self.event = {}, None
        with torch.cuda.stream(stream) if stream is not None else nullcontext():
            for k, v in batch.items():
                if isinstance(v, np.ndarray):
                    t = torch.from_numpy(v)
                    if stream is not None:
                        t = t.pin_memory()
                    v = t.to(device, non_blocking=True)
                self.batch[k] = v
        if stream is not None:
            self.event = torch.cuda.Event()
            self.event.record(stream)

    def ready(self, device: torch.device) -> dict:
        """The batch, after making the current stream wait for its copies."""
        if self.event is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(self.event)
            for v in self.batch.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(current)
        return self.batch


def device_prefetch(iterator, device: torch.device | str) -> Iterator[dict]:
    """Yield ``iterator``'s numpy batches as tensors on ``device``. On a CUDA
    device the next batch's pinned, ``non_blocking`` copies run on a side
    stream, issued before the current batch is handed out, so they overlap
    the current step. Non-array entries (case names) pass through."""
    device = torch.device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    it = iter(iterator)
    try:
        nxt = _OnDevice(next(it), device, stream)
    except StopIteration:
        return
    for batch in it:
        cur, nxt = nxt, _OnDevice(batch, device, stream)
        yield cur.ready(device)
    yield nxt.ready(device)
