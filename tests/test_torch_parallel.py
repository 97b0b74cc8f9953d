"""The port's data-parallel helpers in one process, the sharded loader, the
split ``VolumeInferencer``, the profiling utilities and the native EDT /
HD95 binding, against the JAX package.

Tolerances: loader indices, buckets and labels equal exactly (the same
permutations; the split route runs the same per-slice arithmetic as the
unsplit one); labels against the JAX inferencer by the margin rule
(``bench.py:478-489``: a pixel may differ only where JAX's top-two logits
are within 2% of max |logit|); the native EDT within rtol 1e-12 / atol
1e-9 of scipy and HD95 within 1e-9, as ``tests/test_native.py`` holds the
JAX binding; ``StepTimer`` exactly (the same arithmetic on the same fake
clock).
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from cswin_unet_tpu.data import DataLoader as JaxLoader
from cswin_unet_tpu.eval.inference import VolumeInferencer as JaxInferencer
from cswin_unet_tpu.metrics import _surface_distances
from cswin_unet_tpu.models import CSwinUnet as JaxCSwinUnet
from cswin_unet_tpu.models import CSWinUNet as JaxCSWinUNet
from cswin_unet_tpu.parallel import make_mesh_for_batch
from cswin_unet_tpu.utils import checkpoint as jax_ckpt
from cswin_unet_tpu.utils import native as jax_native
from cswin_unet_tpu.utils import profiling as jax_profiling
from cswin_unet_tpu_torch import metrics, parallel
from cswin_unet_tpu_torch.data import DataLoader
from cswin_unet_tpu_torch.eval.inference import VolumeInferencer
from cswin_unet_tpu_torch.models import CSwinUnet, CSWinUNet
from cswin_unet_tpu_torch.ops.cuda import kernels
from cswin_unet_tpu_torch.utils import native, profiling
from cswin_unet_tpu_torch.utils.checkpoint import params_from_jax

torch.set_num_threads(2)

SMALL = dict(img_size=32, embed_dim=16, depth=(1, 1, 1, 1), split_size=(1, 2, 2, 1),
             num_heads=(2, 2, 4, 8))


class _IdxDataset:
    """Sample i is an image filled with i (the JAX data tests' dataset)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i, rng=None):
        return {"image": np.full((2,), i, np.float32), "label": np.zeros((2,), np.int32)}


def _drain(loader):
    return [int(v) for b in loader for v in b["image"][:, 0]]


# ---- (a) the sharded loader ---------------------------------------------

@pytest.mark.parametrize("n,bs,shards", [(23, 4, 3), (12, 3, 2), (30, 4, 4), (25, 6, 2),
                                         (7, 2, 3), (50, 8, 3)])
def test_sharded_epoch_indices_equal_jax_loader(n, bs, shards):
    """For every shard, ``__len__`` and the epoch's indices over two epochs
    equal the JAX loader's (n not divisible by the shards; each shard holds
    at least half a batch, where the two loaders agree)."""
    for r in range(shards):
        port = DataLoader(_IdxDataset(n), bs, seed=5, num_workers=1, num_shards=shards,
                          shard_index=r)
        ref = JaxLoader(_IdxDataset(n), bs, seed=5, num_workers=1, num_shards=shards,
                        shard_index=r)
        assert len(port) == len(ref)
        for epoch in range(2):
            port.epoch = epoch
            ref.set_epoch(epoch)
            np.testing.assert_array_equal(port._epoch_indices(), ref._epoch_indices())


def test_shards_partition_the_epoch_in_lockstep():
    """Same-epoch shards cover the dataset and yield the same number of
    batches (``tests/test_data.py``'s multi-host case)."""
    n, bs, shards = 23, 4, 3
    per_shard = [_drain(DataLoader(_IdxDataset(n), bs, seed=5, num_workers=2,
                                   num_shards=shards, shard_index=r))
                 for r in range(shards)]
    assert {len(s) for s in per_shard} == {8}
    assert set().union(*per_shard) == set(range(n))


def test_shards_interleave_to_the_unsharded_order():
    """Every shard shuffles the same permutation: the two shards' samples,
    interleaved, are the one-shard loader's order."""
    n, bs = 12, 3
    full = DataLoader(_IdxDataset(n), bs, seed=9, num_workers=1)
    full.epoch = 4
    parts = []
    for r in range(2):
        dl = DataLoader(_IdxDataset(n), bs, seed=9, num_workers=1, num_shards=2,
                        shard_index=r)
        dl.epoch = 4
        parts.append(_drain(dl))
    assert [parts[i % 2][i // 2] for i in range(n)] == _drain(full)


def test_shard_index_validation():
    with pytest.raises(ValueError):
        DataLoader(_IdxDataset(4), 2, num_shards=2, shard_index=2)
    with pytest.raises(ValueError):
        DataLoader(_IdxDataset(4), 2, num_shards=2, shard_index=-1)


# ---- (b) the helpers in one process --------------------------------------

def test_helpers_single_process(monkeypatch):
    """Without a process group: (0, 1), a barrier that returns, reductions
    and row slices that leave their tensors as they are, and an
    ``init_distributed`` that starts no group."""
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert parallel.process_shard_info() == (0, 1)
    assert not parallel.launched()
    parallel.multihost_barrier("noop")
    t = torch.arange(6.0)
    assert parallel.all_reduce_mean_([t])[0] is t and torch.equal(t, torch.arange(6.0))
    assert parallel.all_reduce_sum(t) is t
    assert parallel.rank_rows(t, 6) is t
    with pytest.raises(ValueError, match="not 1 x 4 rows"):
        parallel.rank_rows(t, 4)
    assert parallel.init_distributed("cpu") == (0, 1, torch.device("cpu"))
    assert not torch.distributed.is_initialized()
    model = torch.nn.Linear(2, 2)
    assert parallel.wrap_ddp(model, torch.device("cpu")) is model


def test_failed_init_raises(monkeypatch):
    """Under WORLD_SIZE > 1 a process group that cannot start raises; the
    process does not carry on alone. ``--device cuda`` without a card
    raises too."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises(ValueError):
        parallel.init_distributed("cpu")
    assert not torch.distributed.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.init_distributed("cuda")


def test_devices_for_batch_divisibility():
    """The largest count of the given devices that divides the batch, as
    JAX's ``make_mesh_for_batch`` picks its mesh over 8 devices."""
    eight = ["cpu"] * 8
    for batch in (8, 4, 5, 7, 3, 11, 12, 32):
        assert len(parallel.devices_for_batch(batch, eight)) == \
            make_mesh_for_batch(batch).devices.size
    with pytest.raises(ValueError):
        parallel.devices_for_batch(4, [])


def test_devices_for_batch_refuses_devices_not_visible(monkeypatch):
    """Every visible card by default; a card asked for that is not visible
    raises, as ``make_mesh`` does for more devices than there are."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert parallel.local_devices() == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert parallel.devices_for_batch(6) == parallel.local_devices()
    assert parallel.devices_for_batch(6, ["cuda:1", "cuda:1"]) == [torch.device("cuda", 1)] * 2
    with pytest.raises(ValueError, match="only 2"):
        parallel.devices_for_batch(8, ["cuda:0", "cuda:2"])


def test_kernel_launch_names_a_device_mismatch(monkeypatch):
    """The C entry points launch on the current device: a tensor elsewhere
    is refused with both devices named. torch's two bindings stand in for
    a card (a CPU build of torch lacks them)."""
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 1000 + index,
                        raising=False)
    assert kernels._stream(torch.device("cuda", 0)) == 1000
    with pytest.raises(ValueError, match=r"cuda:1.*cuda:0"):
        kernels._stream(torch.device("cuda", 1))


# ---- (g) the split VolumeInferencer -------------------------------------

@pytest.fixture(scope="module")
def models():
    jm = JaxCSwinUnet(backbone=JaxCSWinUNet(num_classes=4, **SMALL))
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(3),
                                             jnp.zeros((1, 32, 32, 1))))
    backbone = CSWinUNet(num_classes=4, dtype=torch.float32, **SMALL)
    backbone.load_state_dict(params_from_jax(
        {k: np.array(v) for k, v in jax_ckpt.flatten(params).items()}))
    return jm, params, CSwinUnet(backbone).eval()


@pytest.mark.parametrize("parts", [2, 4])
def test_split_buckets_equal_jax(models, monkeypatch, parts):
    """Part counts and tail buckets of ``devices=[cpu] * parts`` equal the
    JAX inferencer's over ``parts`` local devices (its ``n_mesh``)."""
    jm, params, port = models
    devs = jax.devices()[:parts]
    monkeypatch.setattr(jax, "local_devices", lambda: devs)
    for bs in (8, 12, 16, 24, 32, 40, 64):
        ours = VolumeInferencer(port, device="cpu", batch_slices=bs, patch_size=(32, 32),
                                devices=["cpu"] * parts)
        theirs = JaxInferencer(jm, params, batch_slices=bs, patch_size=(32, 32),
                               data_parallel=True)
        assert ours._buckets == theirs._buckets, bs
        n_mesh = 1 if theirs._in_sharding is None else len(theirs._in_sharding.device_set)
        assert len(ours.devices) == n_mesh, bs


def test_split_labels_equal_one_device_and_jax(models):
    """Two CPU parts: the labels of 11 slices (a padded tail bucket) equal
    one device's, on the host and on the device-metrics path, with and
    without ``class_indices``; and the JAX inferencer's by the margin rule."""
    jm, params, port = models
    x = np.random.default_rng(5).normal(size=(11, 32, 32)).astype(np.float32)
    for idx in (None, [0, 2, 3]):
        one = VolumeInferencer(port, device="cpu", patch_size=(32, 32), batch_slices=8,
                               class_indices=idx)
        two = VolumeInferencer(port, device="cpu", patch_size=(32, 32), batch_slices=8,
                               class_indices=idx, devices=["cpu", "cpu"])
        assert len(two.devices) == 2 and two.replicas[1] is not port
        want = one.predict_slices(x)
        np.testing.assert_array_equal(two.predict_slices(x), want)
        np.testing.assert_array_equal(two.predict_slices_device(x).numpy(), want)
    got = VolumeInferencer(port, device="cpu", patch_size=(32, 32), batch_slices=8,
                           devices=["cpu", "cpu"]).predict_slices(x)
    logits = np.asarray(jax.jit(lambda p, v: jm.apply(p, v, deterministic=True))(
        params, jnp.asarray(x[..., None])))
    srt = np.sort(logits, -1)
    thr = 0.02 * float(np.abs(logits).max())
    assert int(np.sum((got != logits.argmax(-1)) & (srt[..., -1] - srt[..., -2] > thr))) == 0


# ---- (h) profiling -------------------------------------------------------

def test_step_timer_on_a_fake_clock_equals_jax(monkeypatch):
    """Both timers on one fake clock (ticks 1, 3, 6, 10, ... s apart): the
    same steady-state mean and throughput, warm-up skipped, window rolled."""
    clock = np.cumsum(np.arange(1, 13)).astype(float).tolist()
    for skip, window in ((2, 50), (0, 5), (3, 4)):
        timers = profiling.StepTimer(skip, window), jax_profiling.StepTimer(skip, window)
        for timer in timers:
            ticks = iter(clock)
            monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
            assert np.isnan(timer.mean_step_s) and np.isnan(timer.throughput(4))
            for _ in clock:
                timer.tick()
        ours, theirs = timers
        assert ours._times == theirs._times == np.diff(clock)[skip:][-window:].tolist()
        assert ours.mean_step_s == theirs.mean_step_s
        assert ours.throughput(24) == theirs.throughput(24)


def test_block_and_time_and_device_trace(tmp_path):
    """``block_and_time`` returns the best time and the result; the trace of
    a step on the CPU is a Chrome trace that names the step's ops."""
    best, out = profiling.block_and_time(torch.matmul, torch.ones(8, 8), torch.ones(8, 8),
                                         iters=2)
    assert best >= 0 and torch.equal(out, torch.full((8, 8), 8.0))
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        torch.nn.functional.relu(torch.randn(64, 64) @ torch.randn(64, 64))
    assert any("matmul" in e.key or "mm" in e.key for e in prof.key_averages())
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("mm" in ev.get("name", "") for ev in trace["traceEvents"])


# ---- (i) the native EDT and HD95 -----------------------------------------

def test_native_builds_into_the_ports_own_directory():
    assert native.available(), native.build_error
    path = native.library_path()
    assert path.exists() and path.parent.name == "_native_build"
    assert "cswin_unet_tpu_torch" in str(path)


@pytest.mark.parametrize("shape,frac", [((6, 20, 18), 0.97), ((25, 31), 0.95)])
def test_native_edt_matches_scipy_and_jax_binding(rng, shape, frac):
    mask = rng.random(shape) > frac
    mask[(0,) * len(shape)] = True
    got = native.edt_native(mask)
    np.testing.assert_allclose(got, ndimage.distance_transform_edt(~mask), rtol=1e-12,
                               atol=1e-9)
    np.testing.assert_array_equal(got, jax_native.edt_native(mask))


def _scipy_hd95(a, b):
    return float(np.percentile(np.hstack((_surface_distances(a, b),
                                          _surface_distances(b, a))), 95))


def test_native_hd95_matches_scipy_and_jax_binding():
    a = np.zeros((5, 24, 24), bool)
    b = np.zeros((5, 24, 24), bool)
    a[1:4, 4:12, 5:14] = True
    b[2:5, 7:16, 3:11] = True
    cases = [(a, b)]
    for seed in range(3):
        r = np.random.default_rng(seed)
        x = ndimage.binary_dilation(r.random((30, 30)) > 0.98, iterations=2)
        y = ndimage.binary_dilation(r.random((30, 30)) > 0.98, iterations=3)
        if x.any() and y.any():
            cases.append((x, y))
    for x, y in cases:
        got = native.hd95_native(x, y)
        assert abs(got - _scipy_hd95(x, y)) < 1e-9
        assert got == jax_native.hd95_native(x, y)
        assert metrics.hd95(x, y) == got
        assert abs(metrics.hd95(x, y, use_native=False) - got) < 1e-9


def test_native_refuses_masks_of_two_shapes():
    with pytest.raises(ValueError, match="differ in shape"):
        native.hd95_native(np.ones((4, 4), bool), np.ones((4, 5), bool))
