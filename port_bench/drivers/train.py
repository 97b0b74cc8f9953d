"""Training traffic: the trainer's step run back to back in a closed loop.

Set-up builds one step object (``models.build_model(train=True)`` with the
benchmark's weights, the trainer's SGD, ``make_train_step``, a drop-path
generator from the seed) and drives it through the traffic's
``checked_steps`` first steps on distinct batches of the pool: these warm
every shape and give the readings that the reference follows. The window
then steps the same object on the pool, cycled, for ``seconds``, and ends
in a synchronisation: ``train_samples_per_s`` is every sample stepped over
the whole window, ``train_peak_gib`` the allocator's peak over it (reset at
its start). Once the window has closed and the program is freed, the
reference runs the checked steps again from the same weights, batches and
seed.
"""

from __future__ import annotations

import time

import torch

from .. import program, traffic as T
from ..check import reference_train, train_gaps
from ..harness import Context, Outcome, log, profiled, sync
from ..trace import Trace, collect, optimizer_device_s
from ..weights import make_weights


class TrainRun:
    """The program's step object and its inputs for one seed."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.weights = make_weights(cfg, T.sub_seed(seed, "weights"), device)
        self.model = program.build_model(cfg, self.weights, device, train=True)
        self.step_fn, self.optimizer = program.train_step(self.model, traffic,
                                                          cfg["num_classes"])
        self.generator = torch.Generator(device=device).manual_seed(
            T.sub_seed(seed, "drop_path"))
        self.pool = T.train_batches(cfg, traffic, seed, device)
        self.done = 0
        self.last = None

    def step(self, batches=None) -> dict:
        image, label = (batches or self.pool)[self.done % len(self.pool)]
        self.last = self.step_fn(image, label, self.generator)
        self.done += 1
        return self.last

    def checked_steps(self, batches=None) -> dict:
        """The first steps' readings: each loss, the first gradient as SGD
        holds it, each leaf's change over the steps."""
        params = dict(self.model.named_parameters())
        out = {"losses": []}
        for k in range(self.traffic["checked_steps"]):
            out["losses"].append(float(self.step(batches)["loss"].detach()))
            if k == 0:
                # a step that left the optimizer untouched holds no buffer
                out["grad_norms"] = {
                    n: float(self.optimizer.state[p]["momentum_buffer"].norm())
                    if "momentum_buffer" in self.optimizer.state[p] else 0.0
                    for n, p in params.items()}
        out["change_norms"] = {n: float((p.detach() - self.weights[n]).norm())
                               for n, p in params.items()}
        self.weights = None
        return out

    def free(self) -> None:
        self.model = self.step_fn = self.optimizer = self.last = None
        program.free(self.device)

    def reference(self, rows: int, *, control: bool = False) -> dict:
        weights = make_weights(self.cfg, T.sub_seed(self.seed, "weights"), self.device)
        gen = torch.Generator(device=self.device).manual_seed(
            T.sub_seed(self.seed, "drop_path"))
        return reference_train(self.cfg, self.traffic, weights, self.pool, gen,
                               rows=rows, control=control)


def run(cell: dict, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float) -> Outcome:
    cfg, traffic = cell["config_data"], cell["traffic_data"]
    batch = traffic["batch"]
    r = TrainRun(cfg, traffic, seed, device)
    prog = r.checked_steps()
    sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.2f} s, losses {prog['losses']}")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    first = r.done
    t0 = time.perf_counter()
    while True:
        r.step()
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    window_s = time.perf_counter() - t0
    steps = r.done - first
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    finite = bool(torch.isfinite(r.last["loss"]))

    context = None
    if trace:
        launches = program.Launches()
        launches.start()
        n = cell["trace_units"]
        _, prof, trace_s = profiled(device, lambda: [r.step() for _ in range(n)])
        launches.stop()
        dev, cpu = collect(prof)
        context = Context("train", cfg, traffic,
                          {"seconds": window_s, "steps": steps, "batch": batch, "done": steps},
                          Trace(dev, cpu, trace_s, launches.device, launches.counts,
                                [batch] * n, optimizer_device_s(prof), n))
    log(f"window {window_s:.2f} s, {steps} steps")
    r.free()
    ref = r.reference(cell["reference_rows"])
    log(f"reference losses {ref['losses']}")
    gaps = train_gaps(prog, ref)
    limits = cell["limits"]
    checks = {k: {"value": gaps[k], "limit": limits[k]} for k in limits}
    metrics = {"train_samples_per_s": (steps * batch / window_s, "samples/s"),
               "train_peak_gib": (peak / 2 ** 30, "GiB"),
               "setup_s": (setup_s, "s")}
    return Outcome(metrics, steps, 0 if finite else 1, checks, peak, context)
