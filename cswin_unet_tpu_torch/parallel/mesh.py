"""Process group and data-parallel helpers: the communication layer of the port.

Counterpart of ``cswin_unet_tpu.parallel.mesh``. The JAX package shards the
batch over a 1-D ``data`` mesh and lets XLA insert the gradient all-reduce;
here data parallelism is one process per GPU (``torch.distributed.run``,
i.e. ``torchrun``) with ``DistributedDataParallel``:

  * ``init_distributed`` reads the launcher's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``), sets
    the rank's CUDA device before any model is built and starts NCCL for
    CUDA devices, gloo for the CPU;
  * each rank loads a disjoint strided shard of every epoch
    (``data.DataLoader(num_shards=world, shard_index=rank)``) and holds
    ``1/world`` of the global batch; rank 0's rows come first in the global
    batch, as host 0's do in JAX's multi-host global array;
  * random draws per sample (drop-path, ``--device_augment``) are made for
    the global batch from one generator with the same state on every rank,
    and each rank keeps its rows (``rank_rows``), so a data-parallel step
    equals one process's step on the concatenated batch;
  * batch-global sums (the Dice ratio) go through ``all_reduce_sum``, whose
    backward all-reduces the incoming gradient: with DDP's mean over ranks
    that gives each rank's share of the global gradient;
  * gradients taken with ``torch.autograd.grad`` (which DDP's hooks never
    see) are averaged explicitly with ``all_reduce_mean_``, DDP's
    convention.

Without a process group every helper is the identity and ``(rank, world)``
is ``(0, 1)``, as JAX's are in one process.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist


def launched() -> bool:
    """Whether a launcher (``torchrun``) started this process: it sets
    ``LOCAL_RANK`` and ``WORLD_SIZE``."""
    return "LOCAL_RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_distributed(device: torch.device | str, *, backend: str | None = None,
                     timeout: timedelta | None = None, init_method: str = "env://"
                     ) -> tuple[int, int, torch.device]:
    """Join the process group the environment names and pick the rank's
    device. Returns (rank, world, device).

    The group is initialised when ``WORLD_SIZE`` > 1, or under a launcher
    (``launched()``: a world of one under ``torchrun`` still runs DDP, NCCL
    and all); otherwise this is one process. ``device``: a CUDA device
    without an index becomes ``cuda:LOCAL_RANK``, which is made the current
    device before any model is built (the kernels launch on the current
    device). ``backend``: NCCL for CUDA, gloo for the CPU, unless given
    (gloo also reduces CUDA tensors, and takes two ranks on one card, which
    NCCL refuses). ``init_method``: where the ranks meet, the launcher's
    ``MASTER_ADDR`` / ``MASTER_PORT`` by default, or a ``file://`` path
    that no earlier group used (a store no other process can take, as a
    released TCP port can be). A failed initialisation raises; nothing
    carries on in one process."""
    device = torch.device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}, but no CUDA device is available")
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), _rank_device(device)
    if world <= 1 and not launched():
        return 0, 1, device
    rank = int(os.environ["RANK"])
    device = _rank_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            **kw)
    return rank, world, device


def _rank_device(device: torch.device) -> torch.device:
    if device.type != "cuda":
        return device
    if device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    torch.cuda.set_device(device)
    return device


def destroy_distributed() -> None:
    """Leave the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_shard_info() -> tuple[int, int]:
    """(rank, world): the shard index and count for data sharding; (0, 1)
    without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def world_size() -> int:
    return process_shard_info()[1]


def multihost_barrier(name: str = "barrier") -> None:
    """Wait for every rank (a no-op without a process group). ``name`` only
    documents the call site, as JAX's ``sync_global_devices`` name does."""
    del name
    if not (dist.is_available() and dist.is_initialized()):
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def all_reduce_mean_(tensors) -> list[torch.Tensor]:
    """Average ``tensors`` over the ranks in place, DDP's convention (each
    divided by the world size, then summed), one collective per dtype and
    device. Without a process group: untouched. Returns the list."""
    tensors = list(tensors)
    world = world_size()
    if world == 1 or not tensors:
        return tensors
    groups: dict[tuple, list[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.reshape(-1) for t in ts]).div_(world)
        dist.all_reduce(flat)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    return tensors


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks; the backward all-reduces the incoming gradient, which
    is the same on every rank (the loss is), so each rank's gradient
    carries the factor ``world`` that DDP's mean divides away."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks; ``x`` itself without a
    process group."""
    return _AllReduceSum.apply(x) if world_size() > 1 else x


def rank_rows(t: torch.Tensor, batch: int, dim: int = 0) -> torch.Tensor:
    """This rank's ``batch`` rows ``[rank·batch, (rank+1)·batch)`` of a draw
    made for the global batch along ``dim`` (``t`` itself in one
    process)."""
    rank, world = process_shard_info()
    if t.shape[dim] != world * batch:
        raise ValueError(f"a draw of {t.shape[dim]} along dim {dim} is not {world} x "
                         f"{batch} rows")
    return t if world == 1 else t.narrow(dim, rank * batch, batch)


def local_devices() -> list[torch.device]:
    """The CUDA devices visible to this process."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def devices_for_batch(batch: int, devices=None) -> list[torch.device]:
    """The longest prefix of ``devices`` (default: every visible CUDA device)
    whose length divides ``batch``, as ``make_mesh_for_batch`` picks its
    mesh: a 4-sample batch on 8 devices uses 4 rather than fail. A CUDA
    device that is not visible raises (a smaller set would make a
    data-parallel run silently mean something else)."""
    devices = local_devices() if devices is None else [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("no device to split the batch over")
    visible = torch.cuda.device_count()
    missing = [d for d in devices if d.type == "cuda" and (d.index or 0) >= visible]
    if missing:
        raise ValueError(f"{missing} asked for, but only {visible} CUDA device(s) are "
                         "visible")
    n = len(devices)
    while n > 1 and batch % n:
        n -= 1
    return devices[:n]


def wrap_ddp(model: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """``model`` in ``DistributedDataParallel`` under a process group, else
    ``model`` itself. Parameters are the same on every rank already (the
    same seed or checkpoint); DDP broadcasts rank 0's all the same. The
    model holds no buffers, so there are none to keep in step."""
    if not (dist.is_available() and dist.is_initialized()):
        return model
    from torch.nn.parallel import DistributedDataParallel

    ids = [device.index] if device.type == "cuda" else None
    return DistributedDataParallel(model, device_ids=ids)
