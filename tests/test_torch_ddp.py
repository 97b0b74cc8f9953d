"""Data-parallel training on the CPU: two gloo ranks against one process.

Each multi-process case spawns its ranks with ``multiprocessing``'s spawn
context, initialises gloo through ``parallel.init_distributed`` with a 60 s
timeout, the ranks meeting at a ``file://`` store in the case's own output
directory (no TCP port is picked, released and bound again, which another
process could take in between), and joins its processes with a deadline,
failing rather than waiting when one is left; a failed rank's exit code and
traceback are reported. The train CLI runs under
``python -m torch.distributed.run --nproc_per_node 2``.

A data-parallel step is held to one process's step on the ranks'
concatenated batches (rank 0's rows first): drop-path and the device
augmentation draw for the global batch and keep the rank's rows, the Dice
sums are the global batch's (``parallel.all_reduce_sum``), and gradients
are averaged over the ranks (DDP's hooks, or ``all_reduce_mean_`` where the
step takes them with ``torch.autograd.grad``). Tolerances, float32 on both
sides: losses within 1e-5 and parameters within rtol 1e-5 / atol 1e-6, the
JAX sharding test's (``tests/test_sharding.py:45-49``): only the order of
the sums differs; gradients of the loss cases and of the continual,
TPGM and RGN passes within relative L2 1e-5; the continual master loop's
weights after Adam steps within relative L2 1e-4 all together (the
continual step test's limit, ``tests/test_torch_continual.py``: Adam divides
by |g|, which magnifies summation-order differences of tiny gradients);
one step against the JAX package's on the global batch within the port's
whole-model limit, relative L2 1e-3 (``tests/test_torch_train.py``).
"""

import argparse
import functools
import os
import re
import subprocess
import sys
import time
import traceback
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from cswin_unet_tpu_torch.data import make_synthetic_dataset
from cswin_unet_tpu_torch.losses import dice_loss, segmentation_loss
from cswin_unet_tpu_torch.models import CSwinUnet, CSWinUNet
from cswin_unet_tpu_torch.parallel import (all_reduce_mean_, destroy_distributed,
                                           init_distributed, wrap_ddp)
from cswin_unet_tpu_torch.train import continual, surgical, trainer
from cswin_unet_tpu_torch.train.tpgm import TPGMTrainer, init_constraints
from cswin_unet_tpu_torch.utils.checkpoint import (TRAIN_STATE, load_checkpoint,
                                                   params_from_jax)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(img_size=32, embed_dim=16, depth=(1, 1, 1, 1), split_size=(1, 2, 2, 1),
             num_heads=(2, 2, 4, 8))
WORLD = 2
JOIN_S = 240
TINY_YAML = ("MODEL:\n  TYPE: cswin\n  NAME: cswin_test_tiny\n  DROP_PATH_RATE: {dp}\n"
             "  PRETRAIN_CKPT: \"\"\n  CSWIN:\n    EMBED_DIM: 16\n"
             "    DEPTH: [1, 1, 1, 1]\n    NUM_HEADS: [2, 2, 4, 8]\n"
             "    SPLIT_SIZE: [1, 2, 2, 1]\n")


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def _rank_main(rank, fn_name, args, out):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK="0")
    torch.set_num_threads(1)
    try:
        init_distributed("cpu", timeout=timedelta(seconds=60),
                         init_method=f"file://{os.path.join(out, 'rendezvous')}")
        try:
            torch.save(globals()[fn_name](rank, *args), os.path.join(out, f"rank{rank}.pt"))
        finally:
            destroy_distributed()
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _run_ranks(fn, out, *args):
    """``fn(rank, *args)`` on ``WORLD`` gloo ranks; their results in rank
    order. Fails when a rank fails or outlives the deadline."""
    os.makedirs(out, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, fn.__name__, args, str(out)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    left = [p for p in procs if p.is_alive()]
    for p in left:
        p.kill()
        p.join(10)
    codes = [p.exitcode for p in procs]
    if left or codes != [0] * WORLD:
        errs = {r: open(e).read() for r in range(WORLD)
                if os.path.exists(e := os.path.join(out, f"rank{r}.err"))}
        pytest.fail(f"{fn.__name__}: exit codes {codes} (None: killed at the {JOIN_S} s "
                    f"deadline); tracebacks by rank: {errs or 'none written'}")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]


def _rows(a, rank):
    """Rank ``rank``'s rows of a global batch (rank 0's first)."""
    b = a.shape[0] // WORLD
    return a[rank * b:(rank + 1) * b]


# The JAX package is imported where it is used, in this process only: the
# ranks import this module and need none of it.

@functools.cache
def _jax_init(num_classes, seed):
    import jax
    import jax.numpy as jnp

    from cswin_unet_tpu.models import CSwinUnet as JaxCSwinUnet
    from cswin_unet_tpu.models import CSWinUNet as JaxCSWinUNet

    jm = JaxCSwinUnet(backbone=JaxCSWinUNet(num_classes=num_classes, **SMALL))
    return jm, jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(seed),
                                               jnp.zeros((1, 32, 32, 1))))


def _state(params):
    from cswin_unet_tpu.utils import checkpoint as jax_ckpt

    return params_from_jax({k: np.array(v) for k, v in jax_ckpt.flatten(params).items()})


def _expanded(params, num_classes):
    from cswin_unet_tpu.utils import checkpoint as jax_ckpt

    return jax_ckpt.expand_classifier(params, num_classes, seed=0)


def _model(state, num_classes, drop_path_rate=0.0):
    backbone = CSWinUNet(num_classes=num_classes, dtype=torch.float32,
                         drop_path_rate=drop_path_rate, **SMALL)
    backbone.load_state_dict(state)
    return CSwinUnet(backbone)


def _params(model):
    return {k: v.detach().clone() for k, v in model.cswin_unet.named_parameters()}


# ---- the step-level cases: one spawn of two ranks computes them all ------

def _inputs():
    rng = np.random.default_rng(11)
    return dict(
        feat=rng.standard_normal((4, 8, 8, 3)).astype(np.float32),
        flabel=rng.integers(0, 5, (4, 8, 8)).astype(np.int64),
        image=rng.standard_normal((8, 32, 32, 1)).astype(np.float32),
        label=rng.integers(0, 4, (8, 32, 32)).astype(np.int64),
        cimage=rng.standard_normal((4, 32, 32, 1)).astype(np.float32),
        clabel=rng.integers(0, 4, (4, 32, 32)).astype(np.int64))


def _loss_grads(x, y, which):
    """Gradients of a 1x1 head (3 -> 5 channels, in DDP under a process
    group) through ``which`` loss: the head's weights are shared, so their
    gradient is what a missing world-size factor would scale."""
    torch.manual_seed(0)
    head = torch.nn.Linear(3, 5)
    net = wrap_ddp(head, torch.device("cpu"))
    logits = net(torch.from_numpy(x))
    y = torch.from_numpy(y)
    loss = dice_loss(logits, y, 5) if which == "dice" else segmentation_loss(logits, y, 5)[0]
    loss.backward()
    value = all_reduce_mean_([loss.detach()])[0]
    return float(value), {"weight": head.weight.grad.clone(), "bias": head.bias.grad.clone()}


def _train_steps(image, label, state, *, drop_path, augment, steps):
    model = _model(state, 4, drop_path).train()
    opt, sched = trainer.make_optimizer(model.parameters(), 0.05, 100)
    step = trainer.make_train_step(wrap_ddp(model, torch.device("cpu")), opt, sched, 4,
                                   device_augment=augment)
    gen = torch.Generator().manual_seed(7)
    losses = []
    for _ in range(steps):
        aux = step(torch.from_numpy(image), torch.from_numpy(label), gen)
        losses.append(float(all_reduce_mean_([aux["loss"]])[0]))
    return losses, _params(model)


class _Recorder:
    """An optimizer stand-in that keeps the gradients it is given."""

    def step(self, grads, weights, epoch):
        self.grads = {k: v.clone() for k, v in grads.items()}


def _continual_pieces(image, label, teacher_state, student_state, rows=lambda a: a):
    """The continual step's gradients (student drop-path 0.1, live), TPGM's
    constraint gradients and RGN weights on ``rows`` of ``image`` /
    ``label`` (the RGN pass: two global batches of half the rows each)."""
    rgn_batches = [{"image": rows(image[:2]), "label": rows(label[:2])},
                   {"image": rows(image[2:]), "label": rows(label[2:])}]
    image, label = rows(image), rows(label)
    teacher = _model(teacher_state, 4).eval()
    student = _model(student_state, 7, 0.1).train()
    cw = np.linspace(0.2, 1.0, 7).astype(np.float32)
    loss_fn = continual.make_continual_loss(7, 4, kd_weight=0.2, kd_temperature=3.0,
                                            class_weights=cw)
    rec = _Recorder()
    step = continual.make_continual_train_step(student, teacher, rec, loss_fn, 1, 4)
    aux = step(torch.from_numpy(image), torch.from_numpy(label), {}, 0,
               torch.Generator().manual_seed(3))
    loss = float(all_reduce_mean_([aux["loss"]])[0])
    params = surgical.backbone_params(student)
    label_map = functools.partial(continual.map_new_dataset_labels, stage=1,
                                  num_classes_old=4)
    tpgm = TPGMTrainer(student, params, max_iters=1, active_classes=7, label_map=label_map,
                       variant="v1")
    # the weights moved off the anchor, the constraints half-way (v1), so
    # every ratio is inside its clamp and every constraint has a gradient
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in params.values():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    tpgm.constraints = init_constraints(params, variant="v1", anchor=tpgm.anchor)
    t_loss, _, t_grads = tpgm.constraint_grads(params, torch.from_numpy(image),
                                               label_map(torch.from_numpy(label)))
    rgn = surgical.get_lr_weights(
        student, rgn_batches,
        lambda lg, lb: continual.focal_loss(lg, lb, class_weights=torch.from_numpy(cw)),
        method="RGN", label_map=label_map)
    return dict(loss=loss, grads=rec.grads, tpgm_loss=float(t_loss),
                tpgm_grads={k: v.clone() for k, v in t_grads.items()}, rgn=rgn)


def _steps_on_rank(rank, data, states):
    r = functools.partial(_rows, rank=rank)
    out = {w: _loss_grads(r(data["feat"]), r(data["flabel"]), w) for w in ("dice", "seg")}
    out["live"] = _train_steps(r(data["image"]), r(data["label"]), states["four"],
                               drop_path=0.2, augment=True, steps=2)
    out["plain"] = _train_steps(r(data["image"]), r(data["label"]), states["four"],
                                drop_path=0.0, augment=False, steps=1)
    out["continual"] = _continual_pieces(data["cimage"], data["clabel"], states["teacher"],
                                         states["student"], rows=r)
    return out


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """Every step-level case on two ranks, and on one process."""
    data = _inputs()
    _, four = _jax_init(4, 0)
    states = dict(four=_state(four), teacher=_state(four),
                  student=_state(_expanded(four, 7)))
    ranks = _run_ranks(_steps_on_rank, tmp_path_factory.mktemp("steps"), data, states)
    one = {w: _loss_grads(data["feat"], data["flabel"], w) for w in ("dice", "seg")}
    one["live"] = _train_steps(data["image"], data["label"], states["four"],
                               drop_path=0.2, augment=True, steps=2)
    one["plain"] = _train_steps(data["image"], data["label"], states["four"],
                                drop_path=0.0, augment=False, steps=1)
    one["continual"] = _continual_pieces(data["cimage"], data["clabel"],
                                         states["teacher"], states["student"])
    return ranks, one, data, four


@pytest.mark.parametrize("which", ["dice", "seg"])
def test_loss_gradients_two_ranks_equal_one_process(steps, which):
    """Dice (and 0.4·CE + 0.6·Dice) of the ranks' shards: the global batch's
    value on every rank, and the shared head's DDP gradient equal to one
    process's on the concatenated batch (half of it without the factor the
    all-reduce's backward carries)."""
    ranks, one, _, _ = steps
    want_loss, want = one[which]
    for loss, grads in (r[which] for r in ranks):
        assert abs(loss - want_loss) <= 1e-5
        for k in want:
            assert _rel_l2(grads[k], want[k]) <= 1e-5, k


def test_train_step_two_ranks_equal_one_process(steps):
    """Two steps of ``make_train_step`` in DDP with drop-path 0.2 and
    ``device_augment`` live: each rank's losses and parameters equal one
    process's steps on the concatenated batch."""
    ranks, one, _, _ = steps
    want_losses, want = one["live"]
    for losses, params in (r["live"] for r in ranks):
        np.testing.assert_allclose(losses, want_losses, rtol=0, atol=1e-5)
        for k in want:
            np.testing.assert_allclose(params[k].numpy(), want[k].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_train_step_two_ranks_equal_jax_step(steps):
    """One step at drop-path 0 without augmentation on two ranks against the
    JAX package's ``make_train_step`` on the global batch."""
    import jax
    import jax.numpy as jnp

    from cswin_unet_tpu.train.trainer import make_optimizer as jax_make_optimizer
    from cswin_unet_tpu.train.trainer import make_train_step as jax_make_train_step

    ranks, _, data, four = steps
    jm, _ = _jax_init(4, 0)
    jopt = jax_make_optimizer(0.05, 100)
    jstep = jax_make_train_step(jm, jopt, 4)
    new, _, jaux = jstep(four, jopt.init(four), jnp.asarray(data["image"]),
                         jnp.asarray(data["label"].astype(np.int32)), jax.random.PRNGKey(0))
    want = _state(jax.device_get(new))
    before = _state(four)
    for losses, params in (r["plain"] for r in ranks):
        assert abs(losses[0] - float(jaux["loss"])) <= 1e-4 * abs(float(jaux["loss"]))
        got = np.concatenate([(params[k] - before[k]).numpy().ravel() for k in want])
        ref = np.concatenate([(want[k] - before[k]).numpy().ravel() for k in want])
        assert _rel_l2(got, ref) <= 1e-3


def test_continual_grads_tpgm_and_rgn_two_ranks_equal_one_process(steps):
    """The continual step's student gradients (averaged over the ranks by the
    step itself: they come from ``torch.autograd.grad``), TPGM's constraint
    gradients and loss, and the RGN weights: two ranks against one process
    on the concatenated batch."""
    ranks, one, _, _ = steps
    want = one["continual"]
    for got in (r["continual"] for r in ranks):
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * max(1.0, abs(want["loss"]))
        g = np.concatenate([got["grads"][k].numpy().ravel() for k in want["grads"]])
        w = np.concatenate([want["grads"][k].numpy().ravel() for k in want["grads"]])
        assert _rel_l2(g, w) <= 1e-5
        assert abs(got["tpgm_loss"] - want["tpgm_loss"]) <= 1e-5
        g = np.array([float(got["tpgm_grads"][k]) for k in want["tpgm_grads"]])
        w = np.array([float(want["tpgm_grads"][k]) for k in want["tpgm_grads"]])
        assert _rel_l2(g, w) <= 1e-5
        assert got["rgn"].keys() == want["rgn"].keys()
        assert _rel_l2([got["rgn"][k] for k in want["rgn"]], list(want["rgn"].values())) <= 1e-5


# ---- the continual master loop on two ranks -----------------------------

def _continual_args(kits, device="cpu"):
    return argparse.Namespace(
        stage=1, dataset="kits23", num_classes_old=4, num_classes_new=4,
        num_classes_lits17=3, root_path=kits["train_dir"], list_dir=kits["list_dir"],
        img_size=32, batch_size=4, n_gpu=1, seed=1234, base_lr=1e-3, max_epochs=1,
        data_fraction=1.0, kd_temperature=3.0, kd_weight=0.2, auto_tune="RGN",
        gradient_batches=1, tpgm_norm_mode="l2", tpgm_lr=0.05, tpgm_iters=2,
        tpgm_exclude=[], tpgm_frequency=1, tpgm_start_epoch=0, disable_tpgm=False,
        tpgm_data_fraction=0.5, device=device)


def _continual_run(rank, kits, states, out):
    seen = []
    calc = continual.calculate_extreme_class_weights

    def recording(*a, **kw):
        seen.append(calc(*a, **kw))
        return seen[-1]

    continual.calculate_extreme_class_weights = recording
    teacher = _model(states["teacher"], 4).eval()
    student = _model(states["student"], 7).train()
    continual.trainer_continual_surgical_tpgm(_continual_args(kits), student, teacher, out,
                                              (4, 4, 7, "kits23"))
    return dict(class_weights=seen, params=_params(student))


def test_continual_master_loop_two_ranks_equals_one_process(tmp_path):
    """``trainer_continual_surgical_tpgm`` for one epoch (the RGN analysis,
    TPGM, 3 steps) on two ranks: the class weights equal one process's on
    every rank, the final weights are the same on both ranks and equal one
    process's, and rank 0 alone writes (one log line per event)."""
    kits = make_synthetic_dataset(str(tmp_path / "kits"), num_train_slices=12,
                                  num_volumes=1, size=40, depth=2, num_classes=4, seed=2)
    _, four = _jax_init(4, 0)
    states = dict(teacher=_state(four),
                  student=_state(_expanded(four, 7)))
    out2 = str(tmp_path / "two")
    ranks = _run_ranks(_continual_run, tmp_path / "ranks", kits, states, out2)
    seen = []
    calc = continual.calculate_extreme_class_weights
    try:
        continual.calculate_extreme_class_weights = (
            lambda *a, **kw: seen.append(calc(*a, **kw)) or seen[-1])
        student = _model(states["student"], 7).train()
        continual.trainer_continual_surgical_tpgm(
            _continual_args(kits), student, _model(states["teacher"], 4).eval(),
            str(tmp_path / "one"), (4, 4, 7, "kits23"))
    finally:
        continual.calculate_extreme_class_weights = calc
        import logging
        logging.getLogger().handlers.clear()
    want = _params(student)
    for r in ranks:
        np.testing.assert_array_equal(r["class_weights"][0], seen[0])
    for k in want:
        np.testing.assert_array_equal(ranks[0]["params"][k], ranks[1]["params"][k], k)
    got = np.concatenate([ranks[0]["params"][k].numpy().ravel() for k in want])
    assert _rel_l2(got, np.concatenate([v.numpy().ravel() for v in want.values()])) <= 1e-4
    log = open(os.path.join(out2, "log.txt")).read()
    assert log.count("Applying final TPGM projection") == 1
    assert log.count("save final model to") == 1
    assert os.path.exists(os.path.join(out2, "continual_surgical_tpgm_stage1_final.npz"))


# ---- the base trainer and its CLI on two ranks ---------------------------

@pytest.fixture(scope="module")
def synapse(tmp_path_factory):
    root = tmp_path_factory.mktemp("synapse")
    return make_synthetic_dataset(str(root), num_train_slices=8, num_volumes=1,
                                  size=40, depth=2, num_classes=9, seed=4)


def _trainer_run(rank, synapse, out, cut_at, resume):
    """``trainer_synapse`` for 7 epochs of one step (global bs 8 over 8
    slices, 4 rows a rank; it saves after epochs 5 and 6); ``cut_at``: every
    rank dies on that step."""
    from cswin_unet_tpu_torch.config import get_config
    from cswin_unet_tpu_torch.models import build_model
    from cswin_unet_tpu_torch.train.__main__ import build_parser

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

        trainer.make_train_step = dying
    cfg = out + "_cfg.yaml"
    with open(cfg, "w") as f:
        f.write(TINY_YAML.format(dp=0.1))
    config = get_config(build_parser().parse_args(["--cfg", cfg]))
    model = build_model(config, img_size=32, num_classes=9, device="cpu",
                        seed=3 if resume is None else 11, train=True)
    args = argparse.Namespace(
        root_path=synapse["train_dir"], list_dir=synapse["list_dir"], num_classes=9,
        batch_size=8, n_gpu=1, max_epochs=7, base_lr=0.01, img_size=32, seed=1234,
        num_workers=1, device="cpu", resume=resume, device_augment=True)
    try:
        trainer.trainer_synapse(args, model, out)
    except RuntimeError as e:
        if "run cut" not in str(e):
            raise
        return "cut"
    return "done"


def _losses(log: str) -> list[tuple[int, str]]:
    return [(int(i), v) for i, v in re.findall(
        r"iteration (\d+) : loss : (\S+, loss_ce: \S+)", log)]


def test_two_rank_run_cut_and_resumed_equals_uncut(synapse, tmp_path):
    """Two ranks with drop-path 0.1 and ``device_augment``: a run cut on its
    7th step (after epoch 5's checkpoint) and resumed on two ranks from its
    output directory logs the uncut run's 7 losses and ends with its
    weights, bit for bit."""
    straight, cut = str(tmp_path / "straight"), str(tmp_path / "cut")
    assert _run_ranks(_trainer_run, tmp_path / "a", synapse, straight, None, None) == \
        ["done"] * WORLD
    assert _run_ranks(_trainer_run, tmp_path / "b", synapse, cut, 7, None) == ["cut"] * WORLD
    state = torch.load(os.path.join(cut, TRAIN_STATE), weights_only=True)
    assert (state["iteration"], state["epoch"]) == (6, 6)
    assert _run_ranks(_trainer_run, tmp_path / "c", synapse, cut, None, cut) == \
        ["done"] * WORLD
    want_log = open(os.path.join(straight, "log.txt")).read()
    assert [i for i, _ in _losses(want_log)] == list(range(1, 8))
    assert _losses(open(os.path.join(cut, "log.txt")).read()) == _losses(want_log)
    want, _ = load_checkpoint(os.path.join(straight, "epoch_6.npz"))
    got, _ = load_checkpoint(os.path.join(cut, "epoch_6.npz"))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _cli(out, cfg, *extra):
    return ["--cfg", str(cfg), "--root_path", "synapse", "--dataset", "Synapse",
            "--output_dir", str(out), "--max_epochs", "2", "--batch_size", "4",
            "--img_size", "32", "--device", "cpu", "--num_workers", "1",
            "--opts", "TPU.COMPUTE_DTYPE", "float32", *extra]


def test_train_cli_under_torchrun_two_ranks(synapse, tmp_path, monkeypatch):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    cswin_unet_tpu_torch.train --device cpu`` (gloo): rank 0 alone writes
    one log (each iteration logged once), one checkpoint and one train
    state, and the checkpoint equals a one-process run's. Drop-path 0: the
    sharded loader interleaves the samples of a global batch, so with
    per-sample draws live the two runs would differ by where each draw
    lands (the step cases hold the draws on the concatenated batch)."""
    work = tmp_path / "work"
    os.makedirs(work / "lists" / "lists_Synapse_blurred")
    for name in os.listdir(synapse["list_dir"]):
        with open(os.path.join(synapse["list_dir"], name)) as f, \
                open(work / "lists" / "lists_Synapse_blurred" / name, "w") as g:
            g.write(f.read())
    os.symlink(synapse["root"], work / "synapse")
    cfg = work / "tiny.yaml"
    cfg.write_text(TINY_YAML.format(dp=0.0))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "cswin_unet_tpu_torch.train", *_cli("two", cfg)]
    res = subprocess.run(cmd, cwd=work, env=env, capture_output=True, text=True,
                         timeout=JOIN_S)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.count("The length of train set is: 8") == 1

    from cswin_unet_tpu_torch.train.__main__ import main

    monkeypatch.chdir(work)
    assert main(_cli("one", cfg)) == "Training Finished!"
    import logging
    logging.getLogger().handlers.clear()

    written = sorted(f for f in os.listdir(work / "two") if f != "log")  # log/: TensorBoard
    assert written == ["epoch_1.npz", "log.txt", TRAIN_STATE]
    two_log = (work / "two" / "log.txt").read_text()
    one_log = (work / "one" / "log.txt").read_text()
    assert [i for i, _ in _losses(two_log)] == [1, 2, 3, 4]
    assert two_log.count("save model to two/epoch_1.npz") == 1
    two_losses = [float(v.split(",")[0]) for _, v in _losses(two_log)]
    one_losses = [float(v.split(",")[0]) for _, v in _losses(one_log)]
    np.testing.assert_allclose(two_losses, one_losses, rtol=0, atol=1e-5)
    want, _ = load_checkpoint(str(work / "one" / "epoch_1.npz"))
    got, _ = load_checkpoint(str(work / "two" / "epoch_1.npz"))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    state = torch.load(work / "two" / TRAIN_STATE, weights_only=True)
    assert (state["iteration"], state["epoch"]) == (4, 2)
    assert not any(k.startswith("module.") for k in state["model"])
