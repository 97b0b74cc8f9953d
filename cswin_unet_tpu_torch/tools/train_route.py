"""The training route measured on the card: which block geometries train
through ``CSWinBlockFn`` and which as the composition under autograd.

    python -m cswin_unet_tpu_torch.tools.train_route [--cfg YAML] [--batch 24]
        [--rounds 4] [--device cuda|cpu] [--opts KEY VALUE ...]

Counterpart of the JAX package's ``scripts/exp_train_route.py`` (which A/Bs
the bs-24 step by ``_FUSE_TRAIN_MIN_RESO``) and of the block rows of
``scripts/profile_parts_bwd.py``. The default config is tiny-224;
``--cfg cswin_unet_tpu_torch/configs/cswin_base_384.yaml`` gives base-384.

It times the whole recipe step (``train.make_train_step``: forward with the
config's drop-path drawn from a seeded generator, 0.4·CE + 0.6·Dice,
backward, SGD with momentum 0.9 and the poly LR) on seeded synthetic slices
at the config's image size, under each route: ``kernel`` (every block
through ``CSWinBlockFn``, as the model trains) and, for each block geometry
(H, W, C, last stage) of the config, ``composed <geometry>`` (that
geometry's blocks alone as the composition under autograd). A route is set
by giving the geometry's blocks ``impl = "plain"`` (``CSWinBlock._block``
runs ``composed_block`` for it) and their own ``impl`` back afterwards; the
model has no flag for it.

Method: one model and optimizer; ``--rounds`` rounds, each a pass over the
routes in forward order and one in reverse order, a pass running each
route once (one untimed step after the switch, then ``STEP_REPS`` steps
between CUDA events); per route and order the median and min-max.
Then per route the device-busy ms of a step (``utils.profiling
.device_busy_ms``, ``not measured`` where the profiler lost records) and
the peak device memory of a step (``torch.cuda.max_memory_allocated`` after
``reset_peak_memory_stats``). For each geometry also one block's forward +
backward at the step's batch under both routes, with the same drop-path
multipliers, timed the same way.

Verdict per geometry, ``kernel`` against ``composed <geometry>``:
``kernel`` where its step is faster by more than the min-max spread (the
larger of the two routes') in both orders; ``composed`` where it is slower
by more than the spread in both orders; otherwise the route with the lower
peak memory. With fewer than two samples an order (``--rounds 1``) there is
no spread and the verdict is ``undecided``. The model trains every
geometry through ``CSWinBlockFn``; the last line before the JSON says
whether the verdicts agree (``undecided`` where one is).

Prints ``[route]`` lines and, last, one JSON line; writes no file. With
``--device cpu`` (a small config through ``--opts``, for the tests) the
wrappers run their plain versions, times come from the host clock and busy
and memory are not measured. ``--device cuda`` (the default) without a card
exits with an error.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from ..config import get_config
from ..models import build_model
from ..models import cswin_unet
from ..ops.cuda.cswin_block import BlockParams, composed_block, fused_cswin_block
from ..train import make_optimizer, make_train_step
from ..utils.profiling import device_busy_ms

CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "configs", "cswin_tiny_224_lite.yaml")
STEP_REPS = 2  # timed steps a sample
BLOCK_REPS = 5  # timed block fwd+bwd calls a sample
NUM_CLASSES = 9
SEED = 0


def geometry(blk) -> tuple[int, int, int, bool]:
    return blk.reso, blk.reso, blk.norm1.weight.shape[0], blk.last


def geometry_name(g: tuple[int, int, int, bool]) -> str:
    H, W, C, last = g
    return f"{H}x{W}x{C}{' last' if last else ''}"


def model_blocks(model) -> dict[tuple[int, int, int, bool], list]:
    """The model's blocks (encoder and decoder) by (H, W, C, last stage),
    largest resolution first."""
    out: dict[tuple[int, int, int, bool], list] = {}
    for m in model.modules():
        if isinstance(m, cswin_unet.CSWinBlock):
            out.setdefault(geometry(m), []).append(m)
    return dict(sorted(out.items(), reverse=True))


def routes(geoms) -> dict[str, tuple | None]:
    """Route name -> the geometry trained composed in it (None: none)."""
    return {"kernel": None, **{f"composed {geometry_name(g)}": g for g in geoms}}


class Clock:
    """ms per call of ``fn`` over ``reps`` back-to-back calls: CUDA events
    on the card, the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def __call__(self, fn, reps: int) -> float:
        if not self.cuda:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            return (time.perf_counter() - t0) * 1e3 / reps
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()


def peak_gib(fn, clock: Clock) -> float | None:
    """Peak device memory (GiB) allocated during one call of ``fn``."""
    if not clock.cuda:
        return None
    clock.sync()
    torch.cuda.reset_peak_memory_stats()
    fn()
    clock.sync()
    return torch.cuda.max_memory_allocated() / 2**30


def interleaved(fns: dict, rounds: int, reps: int, clock: Clock, before=None) -> dict:
    """{name: {"forward" | "reverse": [ms, ...]}}: ``rounds`` rounds, each
    a pass over the fns in forward order, then one in reverse order; a
    pass calls each fn once untimed (``before(name)`` first) and then
    times it."""
    names = list(fns)
    out = {n: {"forward": [], "reverse": []} for n in names}
    for _ in range(rounds):
        for order, seq in (("forward", names), ("reverse", names[::-1])):
            for n in seq:
                if before is not None:
                    before(n)
                fns[n]()
                clock.sync()
                out[n][order].append(clock(fns[n], reps))
    return out


def summary(times: list[float]) -> dict:
    return dict(median=statistics.median(times), min=min(times), max=max(times))


def beats(a: dict, b: dict) -> bool:
    """Whether route ``a`` is faster than ``b`` by more than the min-max
    spread (the larger of the two) in both orders."""
    for order in ("forward", "reverse"):
        sa, sb = summary(a[order]), summary(b[order])
        spread = max(sa["max"] - sa["min"], sb["max"] - sb["min"])
        if not sb["median"] - sa["median"] > spread:
            return False
    return True


def verdict(kernel: dict, composed: dict, kernel_gib, composed_gib) -> tuple[str, str]:
    """(route, reason) by the decision rule of the module docstring."""
    if min(len(t[o]) for t in (kernel, composed) for o in ("forward", "reverse")) < 2:
        return "undecided", "fewer than two samples an order, no spread"
    if beats(kernel, composed):
        return "kernel", "step faster beyond the spread in both orders"
    if beats(composed, kernel):
        return "composed", "composed step faster beyond the spread in both orders"
    if kernel_gib is None or composed_gib is None:
        return "undecided", "inside the spread, peak memory not measured"
    if kernel_gib <= composed_gib:
        return "kernel", "inside the spread, lower or equal peak memory"
    return "composed", "inside the spread, lower peak memory"


def _fmt(t: dict) -> str:
    return "; ".join(f"{o} {s['median']:.3f} [{s['min']:.3f}-{s['max']:.3f}]"
                     for o, s in ((o, summary(t[o])) for o in ("forward", "reverse"))
                     if t[o])


def _gib(v: float | None) -> str:
    return "not measured" if v is None else f"{v:.3f} GiB"


def block_ab(blk, batch: int, rate: float, rounds: int, clock: Clock,
             device: torch.device, dtype: torch.dtype) -> dict:
    """One block's parameters, forward + backward at ``batch`` under both
    routes on the same input, cotangent and drop-path multipliers."""
    H, W, C, last = geometry(blk)
    gen = torch.Generator().manual_seed(SEED + 1)
    x = torch.randn((batch, H, W, C), generator=gen).to(device, dtype)
    gout = torch.randn((batch, H, W, C), generator=gen).to(device, dtype)
    keep = 1.0 - rate
    dps = tuple(((torch.rand(batch, generator=gen) < keep).float() / keep).to(device)
                for _ in range(2))
    params = [p.detach() for p in blk.block_params()]
    kw = dict(heads=blk.num_heads, split=blk.split_size, last_stage=last,
              scale=blk.scale, dps=dps)

    def run(fn):
        ps = [p.clone().requires_grad_() for p in params]
        if last:  # one LePE, passed in both slots
            ps[6], ps[7] = ps[4], ps[5]
        leaves = [x.detach().requires_grad_(), *ps]
        out = fn(leaves[0], BlockParams(*ps), **kw)
        return torch.autograd.grad(out, leaves, gout)

    fns = {"kernel": lambda: run(fused_cswin_block),
           "composed": lambda: run(composed_block)}
    times = interleaved(fns, rounds, BLOCK_REPS, clock)
    return {n: dict(ms=times[n], peak_gib=peak_gib(fns[n], clock)) for n in fns}


def measure(cfg, batch: int, rounds: int, device: torch.device) -> dict:
    """The A/B; returns the JSON line's object and prints the ``[route]``
    lines."""
    clock = Clock(device)
    model = build_model(cfg, num_classes=NUM_CLASSES, device=device, seed=SEED, train=True)
    blocks = model_blocks(model)
    size = cfg.DATA.IMG_SIZE
    rng = np.random.default_rng(SEED)
    img = torch.from_numpy(rng.standard_normal((batch, size, size, 1)).astype(
        np.float32)).to(device)
    lab = torch.from_numpy(rng.integers(0, NUM_CLASSES, (batch, size, size)).astype(
        np.int64)).to(device)
    opt, sched = make_optimizer(model.parameters(), 0.01, 30000)
    gen = torch.Generator(device=device).manual_seed(SEED)
    step = make_train_step(model, opt, sched, NUM_CLASSES)
    rate = cfg.MODEL.DROP_PATH_RATE
    print(f"[route] {cfg.MODEL.NAME} img {size} batch {batch} drop-path {rate} on "
          f"{torch.cuda.get_device_name(device) if clock.cuda else 'cpu'}; blocks by "
          f"geometry {{{', '.join(f'{geometry_name(g)}: {len(b)}' for g, b in blocks.items())}}}",
          flush=True)
    table = routes(blocks)
    impls = {blk: blk.impl for bs in blocks.values() for blk in bs}
    res = dict(config=cfg.MODEL.NAME, img_size=size, batch=batch, drop_path=rate,
               rounds=rounds, clock="cuda events" if clock.cuda else
               "host (cpu, plain versions)", routes={}, blocks={}, verdicts={})
    try:
        def use(name):
            for blk, impl in impls.items():
                blk.impl = "plain" if geometry(blk) == table[name] else impl

        steps = {n: (lambda: step(img, lab, gen)) for n in table}
        times = interleaved(steps, rounds, STEP_REPS, clock, before=use)
        for n in table:
            use(n)
            busy = device_busy_ms(steps[n], 1) if clock.cuda else None
            peak = peak_gib(steps[n], clock)
            res["routes"][n] = dict(ms=times[n], busy_ms=busy, peak_gib=peak)
            print(f"[route] step {n}: ms median [min-max] by order: {_fmt(times[n])}; "
                  f"busy {'not measured' if busy is None else f'{busy:.3f} ms'}; peak "
                  f"{_gib(peak)}", flush=True)
    finally:
        for blk, impl in impls.items():
            blk.impl = impl
    r = res["routes"]
    del step, opt, sched
    for g, bs in blocks.items():
        name = geometry_name(g)
        blk = block_ab(bs[0], batch, rate, rounds, clock, device, model.cswin_unet.dtype)
        res["blocks"][name] = blk
        print(f"[route] block {name} fwd+bwd at batch {batch}: " + " | ".join(
            f"{n} {_fmt(b['ms'])} peak {_gib(b['peak_gib'])}" for n, b in blk.items()),
            flush=True)
        k, c = r["kernel"], r[f"composed {name}"]
        route, why = verdict(k["ms"], c["ms"], k["peak_gib"], c["peak_gib"])
        res["verdicts"][name] = dict(route=route, reason=why)
        print(f"[route] verdict {name} ({len(bs)} blocks): {route} ({why})", flush=True)
    decided = {v["route"] for v in res["verdicts"].values()}
    res["agree"] = None if "undecided" in decided else decided <= {"kernel"}
    print(f"[route] the model trains every geometry through CSWinBlockFn; the verdicts "
          f"agree: {({None: 'undecided', True: 'yes', False: 'no'})[res['agree']]}",
          flush=True)
    return res


def nvidia_smi() -> str | None:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m cswin_unet_tpu_torch.tools.train_route",
        description="A/B the training route of each block geometry on the whole "
                    "train step.")
    ap.add_argument("--cfg", default=CFG, help="config YAML (default tiny-224)")
    ap.add_argument("--batch", type=int, default=24, help="slices a step (default 24)")
    ap.add_argument("--rounds", type=int, default=4,
                    help="rounds, each one pass in each order (default 4)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--opts", nargs="+", default=None, help="KEY VALUE pairs")
    args = ap.parse_args(argv)
    if args.rounds < 1 or args.batch < 1:
        ap.error("--rounds and --batch are positive")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_route: no CUDA device available (ask for --device cpu "
                         "to run the plain versions)")
    cfg = get_config(argparse.Namespace(cfg=args.cfg, opts=args.opts))
    smi = nvidia_smi() if device.type == "cuda" else None
    if smi:
        print(f"[route] {smi}", flush=True)
    res = measure(cfg, args.batch, args.rounds, device)
    res["nvidia_smi"] = smi
    print(json.dumps({"train_route": res}), flush=True)
    return res


if __name__ == "__main__":
    main()
