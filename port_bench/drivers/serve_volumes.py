"""Volume traffic: one client in a closed loop, each volume sent through
``serve.VolumeServer.segment`` as soon as the last returned its labels.

Set-up builds the model (``models.build_model`` with the benchmark's
weights) and the server, draws the volume pool from the seed (on the
device, copied to the host, already at the model's size so ``segment``
skips the zoom) and warms the forward at each bucket of the traffic's
``warm_slices``. The window sends the pool's volumes in order, cycled, for
``seconds``: ``serve_slices_per_s`` is every real slice returned over the
whole window, ``volume_p95_ms`` the 95th percentile of every volume's time
from the call to its labels on the host. A forward pre-hook on the model
counts each chunk's slices (``pad_share.serve``). Once the window has closed
and the program is freed, the reference segments a sample of the served
volumes drawn from the seed, the deepest among them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import program, traffic as T
from ..check import serve_gap
from ..harness import Context, Outcome, log, profiled, sync
from ..trace import Trace, collect
from ..weights import make_weights


class ServeRun:
    """The program's server and the volume pool for one seed."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.volumes = T.volume_pool(cfg, traffic, seed, device)
        weights = make_weights(cfg, T.sub_seed(seed, "weights"), device)
        self.model = program.build_model(cfg, weights, device, train=False)
        del weights
        self.server = program.volume_server(self.model, device, cfg["img_size"],
                                            traffic["batch_slices"])
        self.chunks: list[int] = []
        self.hook = self.model.register_forward_pre_hook(
            lambda module, args: self.chunks.append(args[0].shape[0]))
        self.keep = self._sample()
        self.served: dict[int, np.ndarray] = {}
        self.sent = 0
        self.failed = 0

    def warm(self) -> None:
        size = self.cfg["img_size"]
        for n in self.traffic["warm_slices"]:
            self.server.inferencer.predict_slices(np.zeros((n, size, size), np.float32))
        self.chunks.clear()

    def send(self) -> tuple[int, float]:
        """Segment the next volume; (its slices, its seconds)."""
        i = self.sent % len(self.volumes)
        vol = self.volumes[i]
        t0 = time.perf_counter()
        labels = self.server.segment(vol)
        dt = time.perf_counter() - t0
        if labels.shape != vol.shape or labels.dtype != np.int32:
            self.failed += 1
        if i in self.keep:
            self.served[i] = labels
        self.sent += 1
        return vol.shape[0], dt

    def _sample(self) -> list[int]:
        """The pool volumes whose labels the check compares, drawn from the
        seed before the window: the deepest, and ``sample_volumes`` − 1
        others; each compared as it was last served."""
        order = range(len(self.volumes))
        deepest = max(order, key=lambda i: self.volumes[i].shape[0])
        rest = [i for i in order if i != deepest]
        rng = np.random.default_rng(T.sub_seed(self.seed, "check_sample"))
        k = min(len(rest), self.traffic["sample_volumes"] - 1)
        return [deepest] + sorted(int(i) for i in rng.choice(rest, k, replace=False))

    def free(self) -> None:
        self.hook.remove()
        self.model = self.server = None
        program.free(self.device)

    def gap(self, rows: int, *, control: bool = False) -> float:
        idx = [i for i in self.keep if i in self.served]
        weights = make_weights(self.cfg, T.sub_seed(self.seed, "weights"), self.device)
        return serve_gap(self.cfg, weights, [self.volumes[i] for i in idx],
                         [self.served[i] for i in idx], self.device, rows=rows,
                         control=control)


def percentile(xs: list[float], q: float) -> float:
    """numpy's linear-interpolation percentile (the server's ``ServeStats``)."""
    return float(np.percentile(xs, q))


def run(cell: dict, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float) -> Outcome:
    cfg, traffic = cell["config_data"], cell["traffic_data"]
    r = ServeRun(cfg, traffic, seed, device)
    r.warm()
    sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.2f} s")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    latencies, slices = [], 0
    t0 = time.perf_counter()
    while True:
        n, dt = r.send()
        latencies.append(dt)
        slices += n
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    window = {"seconds": window_s, "slices": slices, "volumes": len(latencies),
              "chunks": list(r.chunks), "done": slices}

    context = None
    if trace:
        r.chunks.clear()
        launches = program.Launches()
        launches.start()
        sent, prof, trace_s = profiled(
            device, lambda: [r.send() for _ in range(cell["trace_units"])])
        launches.stop()
        dev, cpu = collect(prof)
        context = Context("serve_volumes", cfg, traffic, window,
                          Trace(dev, cpu, trace_s, launches.device, launches.counts,
                                list(r.chunks), done=sum(n for n, _ in sent)))
    quart = [round(1e3 * float(q), 1) for q in np.percentile(latencies, [25, 50, 75])]
    half = max(len(latencies) // 2, 1)
    log(f"window {window_s:.2f} s, {len(latencies)} volumes; latency quartiles {quart} ms, "
        f"mean {1e3 * np.mean(latencies[:half]):.1f} ms a volume in the first half, "
        f"{1e3 * np.mean(latencies[half:] or latencies):.1f} in the second")
    r.free()
    checks = {"logit_gap": {"value": r.gap(cell["reference_rows"]),
                            "limit": cell["limits"]["logit_gap"]}}
    metrics = {"serve_slices_per_s": (slices / window_s, "slices/s"),
               "volume_p95_ms": (percentile(latencies, 95) * 1e3, "ms"),
               "setup_s": (setup_s, "s")}
    return Outcome(metrics, len(latencies), r.failed, checks, peak, context)
