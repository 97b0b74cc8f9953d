"""``--resume``: the train state the port's trainer writes beside each
checkpoint continues a run exactly.

On the CPU at a tiny geometry: steps after a save and a restore equal the
same steps of a run that was never cut, bit for bit (weights, SGD momentum,
LR step, drop-path generator and loader epoch all carried); and a missing
state is refused before any work.
"""

import argparse
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cswin_unet_tpu.data import make_synthetic_dataset
from cswin_unet_tpu_torch.config import get_config
from cswin_unet_tpu_torch.models import build_model
from cswin_unet_tpu_torch.train import make_optimizer, make_train_step, trainer
from cswin_unet_tpu_torch.train import __main__ as train_cli
from cswin_unet_tpu_torch.utils.checkpoint import (TRAIN_STATE, load_checkpoint,
                                                   restore_train_state, save_train_state,
                                                   train_state_path)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = "cswin_unet_tpu_torch/configs/cswin_tiny_224_lite.yaml"
_TINY_OPTS = ["MODEL.CSWIN.EMBED_DIM", "16", "MODEL.CSWIN.DEPTH", "[1,1,1,1]",
              "MODEL.CSWIN.NUM_HEADS", "[2,2,4,8]", "MODEL.CSWIN.SPLIT_SIZE", "[1,2,2,1]",
              "DATA.IMG_SIZE", "32", "MODEL.DROP_PATH_RATE", "0.2"]


def _tiny_config():
    class _Cfg:
        cfg = TINY
        opts = _TINY_OPTS

    return get_config(_Cfg)


def _learner(seed: int):
    """A tiny model in train mode (drop-path 0.2 live), its SGD + poly LR
    and a drop-path generator; the generator's seed is fixed, the weights'
    are not (a restore overwrites them)."""
    model = build_model(_tiny_config(), num_classes=5, device="cpu", seed=seed, train=True)
    opt, sched = make_optimizer(model.parameters(), 0.05, 8)
    gen = torch.Generator().manual_seed(seed + 100)
    return model, opt, sched, gen, make_train_step(model, opt, sched, 5)


def test_train_state_round_trip_continues_exactly(tmp_path):
    """Two steps, save, restore into a fresh model / optimizer / scheduler /
    generator, two more steps: the same losses and weights as four straight
    steps, bit for bit."""
    rng = np.random.default_rng(0)
    batches = [(torch.from_numpy(rng.standard_normal((2, 32, 32, 1)).astype(np.float32)),
                torch.from_numpy(rng.integers(0, 5, (2, 32, 32)).astype(np.int64)))
               for _ in range(4)]
    model, opt, sched, gen, step = _learner(1)
    straight = [float(step(x, y, gen)["loss"]) for x, y in batches]

    cut, opt, sched, gen, step = _learner(1)
    losses = [float(step(x, y, gen)["loss"]) for x, y in batches[:2]]
    path = save_train_state(str(tmp_path / TRAIN_STATE), cut, opt, sched, gen, 2, 1)
    resumed, ropt, rsched, rgen, rstep = _learner(7)  # other weights, other generator
    assert restore_train_state(path, resumed, ropt, rsched, rgen) == (2, 1)
    assert rsched.last_epoch == 2 and ropt.param_groups[0]["lr"] == opt.param_groups[0]["lr"]
    losses += [float(rstep(x, y, rgen)["loss"]) for x, y in batches[2:]]
    assert losses == straight
    assert set(resumed.state_dict()) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(resumed.state_dict()[k], v), k


@pytest.fixture(scope="module")
def synapse(tmp_path_factory):
    root = tmp_path_factory.mktemp("synapse")
    return make_synthetic_dataset(str(root), num_train_slices=8, num_volumes=1,
                                  size=40, depth=2, num_classes=9, seed=4)


def _train(synapse, out, monkeypatch=None, cut_at=None, resume=None, device_augment=False):
    """``trainer_synapse`` for 7 epochs of 2 steps (bs 4 over 8 slices): it
    saves after epochs 5 and 6. ``cut_at``: the run dies on that step.
    ``device_augment``: the step augments on the device (its draws from the
    trainer's generator), the host only resizes."""
    if cut_at is not None:
        make = trainer.make_train_step

        def dying(*a, **kw):
            step, calls = make(*a, **kw), [0]

            def run(*b):
                calls[0] += 1
                if calls[0] == cut_at:
                    raise RuntimeError("run cut")
                return step(*b)
            return run

        monkeypatch.setattr(trainer, "make_train_step", dying)
    model = build_model(_tiny_config(), num_classes=9, device="cpu", seed=3 if resume is None
                        else 11, train=True)
    args = argparse.Namespace(
        root_path=synapse["train_dir"], list_dir=synapse["list_dir"], num_classes=9,
        batch_size=4, n_gpu=1, max_epochs=7, base_lr=0.01, img_size=32, seed=1234,
        num_workers=2, device="cpu", resume=resume, device_augment=device_augment)
    return trainer.trainer_synapse(args, model, str(out))


def _losses(log: str) -> dict[int, str]:
    return {int(i): v for i, v in re.findall(r"iteration (\d+) : loss : (\S+, loss_ce: \S+)",
                                             log)}


def test_trainer_resume_continues_a_cut_run(synapse, tmp_path, monkeypatch):
    """A run cut on its 13th step (after the checkpoint of epoch 5, 12
    steps) and resumed from its output directory ends where the uncut run
    ends: the same 14 logged losses (12 before the cut, 2 after) and the
    same final weights, bit for bit; its train state then says iteration 14,
    epoch 7."""
    _cut_and_resume(synapse, tmp_path, monkeypatch, device_augment=False)


def test_trainer_resume_with_device_augment(synapse, tmp_path, monkeypatch):
    """The same with ``device_augment``: the augmentation's draws come from
    the generator the train state saves, so the resumed run still ends bit
    for bit where the uncut run ends; and the augmentation moved the run
    (its losses differ from a run without it)."""
    _cut_and_resume(synapse, tmp_path, monkeypatch, device_augment=True)
    _train(synapse, tmp_path / "plain")
    assert _losses((tmp_path / "plain" / "log.txt").read_text()) != \
        _losses((tmp_path / "straight" / "log.txt").read_text())


def _cut_and_resume(synapse, tmp_path, monkeypatch, device_augment):
    kw = dict(device_augment=device_augment)
    _train(synapse, tmp_path / "straight", **kw)
    with pytest.raises(RuntimeError, match="run cut"):
        _train(synapse, tmp_path / "cut", monkeypatch, cut_at=13, **kw)
    monkeypatch.undo()
    state = torch.load(tmp_path / "cut" / TRAIN_STATE, weights_only=True)
    assert (state["iteration"], state["epoch"]) == (12, 6)
    assert _train(synapse, tmp_path / "cut", resume=str(tmp_path / "cut"), **kw) == \
        "Training Finished!"
    straight = _losses((tmp_path / "straight" / "log.txt").read_text())
    resumed_log = (tmp_path / "cut" / "log.txt").read_text()
    assert "resumed from" in resumed_log and "at iteration 12 (epoch 6)" in resumed_log
    assert _losses(resumed_log) == straight  # steps 1-12 before the cut, 13-14 after
    want, _ = load_checkpoint(str(tmp_path / "straight" / "epoch_6.npz"))
    got, _ = load_checkpoint(str(tmp_path / "cut" / "epoch_6.npz"))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    state = torch.load(tmp_path / "cut" / TRAIN_STATE, weights_only=True)
    assert (state["iteration"], state["epoch"]) == (14, 7)


def test_resume_from_a_missing_state_raises(tmp_path):
    """A path that holds no train state is refused: a missing file, a
    directory without ``train_state.pt``, and the CLI before it builds
    anything."""
    with pytest.raises(FileNotFoundError):
        train_state_path(str(tmp_path / "nope.pt"))
    with pytest.raises(FileNotFoundError):
        train_state_path(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no train state"):
        train_cli.main(["--cfg", TINY, "--root_path", str(tmp_path), "--output_dir",
                        str(tmp_path / "out"), "--device", "cpu", "--resume",
                        str(tmp_path / "missing")])
    assert not (tmp_path / "out").exists()
    (tmp_path / TRAIN_STATE).write_bytes(b"")
    assert train_state_path(str(tmp_path)) == str(tmp_path / TRAIN_STATE)


def test_device_augment_still_refused(synapse, tmp_path, monkeypatch):
    """``--device_augment`` was refused until the device augmentation was
    ported; now the CLI trains with it: one CPU epoch (2 steps at bs 4) at
    the tiny geometry, finite losses, a checkpoint and a train state."""
    monkeypatch.chdir(tmp_path)  # the CLI reads ./lists/lists_Synapse_blurred
    lists = tmp_path / "lists" / "lists_Synapse_blurred"
    lists.mkdir(parents=True)
    (lists / "train.txt").write_text(
        (Path(synapse["list_dir"]) / "train.txt").read_text())
    msg = train_cli.main(["--cfg", os.path.join(REPO, TINY), "--root_path",
                          str(Path(synapse["train_dir"]).parent), "--output_dir", "out",
                          "--device", "cpu", "--device_augment", "--max_epochs", "1",
                          "--batch_size", "4", "--img_size", "32", "--num_workers", "2",
                          "--opts", *_TINY_OPTS])
    assert msg == "Training Finished!"
    losses = _losses((tmp_path / "out" / "log.txt").read_text())
    assert sorted(losses) == [1, 2]
    assert all(np.isfinite(float(v.split(",")[0])) for v in losses.values())
    assert (tmp_path / "out" / "epoch_0.npz").exists()
    assert (tmp_path / "out" / TRAIN_STATE).exists()
