"""The program's spans (``utils.profiling.span``): a shared no-op while no
profiler records; under ``torch.profiler`` on the CPU, the server's, the
inferencer's, the train step's and the model's ranges, each where its work
is, nested as they are in the code, and the same results either way.

A tiny model (img 32, embed 16, one block a stage) in float32 on the CPU.
"""

import copy
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cswin_unet_tpu_torch.eval.inference import VolumeInferencer
from cswin_unet_tpu_torch.models import CSwinUnet, CSWinUNet
from cswin_unet_tpu_torch.serve import VolumeServer
from cswin_unet_tpu_torch.train.trainer import make_optimizer, make_train_step
from cswin_unet_tpu_torch.utils import profiling

torch.set_num_threads(2)

SMALL = dict(img_size=32, num_classes=4, embed_dim=16, depth=(1, 1, 1, 1),
             split_size=(1, 2, 2, 1), num_heads=(2, 2, 4, 8))
MODEL_SPANS = ["model.stage1", "model.stage2", "model.stage3", "model.stage4",
               "model.stage_up4", "model.stage_up3", "model.stage_up2", "model.stage_up1",
               "model.tail"]
PROGRAM_LIKE = re.compile(r"(?:serve|infer|train|model)\.")


def _model(seed: int = 0, train: bool = False) -> CSwinUnet:
    torch.manual_seed(seed)
    m = CSwinUnet(CSWinUNet(**SMALL, dtype=torch.float32))
    return m.train() if train else m.eval()


def _recorded(fn):
    """``fn()`` under the CPU profiler: (its result, [(name, start, end)] of
    every program span and torch optimizer range, in order of start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    names = {e.name for e in prof.events()}
    unknown = {n for n in names if PROGRAM_LIKE.match(n)} - set(profiling.SPAN_NAMES)
    assert not unknown, f"spans missing from SPAN_NAMES: {sorted(unknown)}"
    spans = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                    if e.name in profiling.SPAN_NAMES or e.name.startswith("Optimizer.step#")),
                   key=lambda s: (s[1], -s[2]))
    return out, spans


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_off_is_the_shared_no_op(monkeypatch):
    def record_function(*args, **kwargs):
        raise AssertionError("record_function called with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    first, second = profiling.span("infer.chunk"), profiling.span("model.tail")
    assert first is second
    with first:
        pass
    # the program's spans with nothing recording
    _model()(torch.zeros(1, 32, 32, 1), emit="labels")


def test_inferencer_spans_a_chunk_and_the_padded_tail():
    """20 slices at batch_slices 8: chunks of 8, 8 and 4 padded to 8."""
    inf = VolumeInferencer(_model(), device="cpu", patch_size=(32, 32), batch_slices=8)
    x = np.random.default_rng(0).normal(size=(20, 32, 32)).astype(np.float32)
    _, spans = _recorded(lambda: inf.predict_slices(x))
    (volume,) = _named(spans, "infer.volume")
    chunks, drains = _named(spans, "infer.chunk"), _named(spans, "infer.drain")
    assert len(chunks) == len(drains) == 3
    (pad,) = _named(spans, "infer.pad")
    assert _inside(pad, chunks[2]) and not any(_inside(pad, c) for c in chunks[:2])
    for part in ("infer.copy_in", "infer.forward"):
        found = _named(spans, part)
        assert len(found) == 3 and all(_inside(s, c) for s, c in zip(found, chunks))
    for c in chunks:
        copy_in = next(s for s in _named(spans, "infer.copy_in") if _inside(s, c))
        forward = next(s for s in _named(spans, "infer.forward") if _inside(s, c))
        assert copy_in[2] <= forward[1]
        tails = [s for s in _named(spans, "model.tail") if _inside(s, forward)]
        assert len(tails) == 1
    for d in drains:
        assert _inside(d, volume) and not any(_inside(d, c) for c in chunks)
    assert all(_inside(c, volume) for c in chunks)


def test_segment_spans_prepare_and_finish_around_the_inferencer():
    server = VolumeServer(_model(), device="cpu", img_size=32, batch_slices=8)
    vol = np.random.default_rng(1).normal(size=(5, 48, 48)).astype(np.float32)
    labels, spans = _recorded(lambda: server.segment(vol))
    assert labels.shape == (5, 48, 48) and labels.dtype == np.int32
    (segment,) = _named(spans, "serve.segment")
    (prepare,) = _named(spans, "serve.prepare")
    (finish,) = _named(spans, "serve.finish")
    (volume,) = _named(spans, "infer.volume")
    assert all(_inside(s, segment) for s in (prepare, volume, finish))
    assert prepare[2] <= volume[1] and volume[2] <= finish[1]


@pytest.mark.parametrize("device_augment", [False, True])
def test_train_step_spans_in_order(device_augment):
    model = _model(train=True)
    opt, sched = make_optimizer(model.parameters(), 0.01, 10)
    step = make_train_step(model, opt, sched, 4, device_augment=device_augment)
    rng = np.random.default_rng(2)
    image = torch.from_numpy(rng.normal(size=(2, 32, 32, 1)).astype(np.float32))
    label = torch.from_numpy(rng.integers(0, 4, (2, 32, 32)).astype(np.int64))
    _, spans = _recorded(lambda: step(image, label, torch.Generator().manual_seed(3)))
    (whole,) = _named(spans, "train.step")
    parts = ["train.forward", "train.loss", "train.backward", "train.optimizer"]
    if device_augment:
        parts.insert(0, "train.augment")
    else:
        assert not _named(spans, "train.augment")
    found = [_named(spans, p) for p in parts]
    assert all(len(f) == 1 for f in found)
    found = [f[0] for f in found]
    assert all(_inside(s, whole) for s in found)
    assert all(a[2] <= b[1] for a, b in zip(found, found[1:]))
    (sgd,) = _named(spans, "Optimizer.step#SGD.step")
    assert _inside(sgd, found[-1])
    assert all(_inside(s, found[parts.index("train.forward")])
               for s in spans if s[0] in MODEL_SPANS)


def test_forward_records_each_model_span_once():
    _, spans = _recorded(lambda: _model()(torch.zeros(2, 32, 32, 1)))
    assert [s[0] for s in spans if s[0].startswith("model.")] == MODEL_SPANS


def test_results_equal_with_the_profiler_on_and_off():
    """Serving labels and a train step's losses and parameters, bit for
    bit."""
    x = np.random.default_rng(4).normal(size=(11, 32, 32)).astype(np.float32)
    inf = VolumeInferencer(_model(), device="cpu", patch_size=(32, 32), batch_slices=8)
    off = inf.predict_slices(x)
    on, _ = _recorded(lambda: inf.predict_slices(x))
    np.testing.assert_array_equal(on, off)

    rng = np.random.default_rng(5)
    image = torch.from_numpy(rng.normal(size=(2, 32, 32, 1)).astype(np.float32))
    label = torch.from_numpy(rng.integers(0, 4, (2, 32, 32)).astype(np.int64))
    base = _model(seed=6, train=True)
    for blk in base.cswin_unet.stage3:
        blk.drop_path = 0.2  # the generator's draws live
    results = []
    for traced in (False, True):
        model = copy.deepcopy(base)
        opt, sched = make_optimizer(model.parameters(), 0.01, 10)
        step = make_train_step(model, opt, sched, 4)
        run = lambda: step(image, label, torch.Generator().manual_seed(7))  # noqa: E731
        aux = _recorded(run)[0] if traced else run()
        results.append((aux, model.state_dict()))
    (aux_off, state_off), (aux_on, state_on) = results
    for k in aux_off:
        assert torch.equal(aux_on[k], aux_off[k]), k
    for k, v in state_off.items():
        assert torch.equal(state_on[k], v), k
