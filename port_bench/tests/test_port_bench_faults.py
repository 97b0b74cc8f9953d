"""A run with the timed path broken underneath reads ``correct`` false, once
for each fault the cell can have; a sound run reads it true. The whole run
but the look for a card, at a small size on the CPU, against the limits as
committed. (No cell spans chips, so no exchange between chips can be left
out.)"""

from __future__ import annotations

import numpy as np
import pytest

from port_bench.run import run_cell

from .small import small_cell

TRAIN, SERVE, TRAIN_F32 = "base384-train-bs24", "tiny224-serve-vol", "base384-train-f32"


def _run(name):
    return run_cell(name, 11, 0.5, False, device="cpu", cell=small_cell(name))


@pytest.mark.parametrize("name", [TRAIN, SERVE, "base384-serve-vol"])
def test_sound_run_is_correct(name):
    out = _run(name)
    assert out["correct"], out["checks"]


def _patch_step(monkeypatch, wrap):
    import cswin_unet_tpu_torch.train.trainer as trainer

    original = trainer.make_train_step

    def make(model, optimizer, scheduler, num_classes, **kw):
        return wrap(original(model, optimizer, scheduler, num_classes, **kw), model,
                    optimizer, num_classes)

    monkeypatch.setattr(trainer, "make_train_step", make)


def _unchanged(step, model, optimizer, nc):
    from cswin_unet_tpu_torch.losses import segmentation_loss

    def frozen(image, label, generator):  # forward and loss, no update
        _, aux = segmentation_loss(model(image, generator=generator), label, nc)
        return aux
    return frozen


def _half_batch(step, model, optimizer, nc):
    return lambda image, label, gen: step(image[: len(image) // 2],
                                          label[: len(label) // 2], gen)


def test_step_that_leaves_its_state_unchanged(monkeypatch):
    _patch_step(monkeypatch, _unchanged)
    out = _run(TRAIN)
    assert not out["correct"], out["checks"]
    assert out["checks"]["change_gap"]["value"] > out["checks"]["change_gap"]["limit"]


def test_step_on_half_of_the_batch(monkeypatch):
    _patch_step(monkeypatch, _half_batch)
    out = _run(TRAIN)
    assert not out["correct"], out["checks"]


def test_float32_sound_run_is_correct():
    out = _run(TRAIN_F32)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [_unchanged, _half_batch], ids=["unchanged", "half_batch"])
def test_float32_step_fault(monkeypatch, fault):
    _patch_step(monkeypatch, fault)
    out = _run(TRAIN_F32)
    assert not out["correct"], out["checks"]


def test_float32_tf32_control_in_the_programs_place(monkeypatch):
    """The readings of the reference in TF32 take the program's: the run
    steps the program as ever, and its check reads the control."""
    from port_bench.drivers import train

    rows = small_cell(TRAIN_F32)["reference_rows"]
    original = train.TrainRun.checked_steps

    def control(self, batches=None):
        original(self, batches)
        return self.reference(rows, control=True)

    monkeypatch.setattr(train.TrainRun, "checked_steps", control)
    out = _run(TRAIN_F32)
    assert not out["correct"], out["checks"]


def _patch_segment(monkeypatch, alter):
    from cswin_unet_tpu_torch.serve import VolumeServer

    original = VolumeServer.segment
    monkeypatch.setattr(VolumeServer, "segment",
                        lambda self, volume: alter(original(self, volume)))


def test_answer_altered_where_it_is_produced(monkeypatch):
    def alter(labels):
        labels = labels.copy()
        labels[len(labels) // 2] = (labels[len(labels) // 2] + 1) % 9
        return labels

    _patch_segment(monkeypatch, alter)
    out = _run(SERVE)
    assert not out["correct"], out["checks"]


def test_half_of_each_chunk_left_out(monkeypatch):
    def alter(labels):  # the second half of each 32-slice chunk copies the first
        labels = labels.copy()
        for start in range(0, len(labels), 32):
            half = labels[start:start + 16]
            tail = labels[start + 16:start + 32]
            tail[:] = np.resize(half, tail.shape)
        return labels

    _patch_segment(monkeypatch, alter)
    out = _run(SERVE)
    assert not out["correct"], out["checks"]
