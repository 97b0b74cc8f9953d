"""One checkout's kernels timed at the main path's shapes, for holding two
builds against each other in one call on one card.

    python3 cswin_unet_tpu_torch/tools/tile_ab.py --root PARENT --harness . --out a1.json
    python3 cswin_unet_tpu_torch/tools/tile_ab.py --root . --out b1.json
    python3 cswin_unet_tpu_torch/tools/tile_ab.py --root . --out b2.json
    python3 cswin_unet_tpu_torch/tools/tile_ab.py --root PARENT --harness . --out a2.json
    python3 cswin_unet_tpu_torch/tools/tile_ab.py --table a1.json b1.json b2.json a2.json

``--root`` names the checkout whose ``cswin_unet_tpu_torch`` is imported,
so that its kernels are built and run; ``--harness`` the checkout whose
``chip_smoke.py`` gives the cases (default: the root's own), so that two
builds can be timed on the same cases. It runs ``chip_smoke.compare_kernels`` (every forward kernel at the shapes
of one 32-slice serving forward, each case held to its plain version, times
summed per forward, unpaired) and ``compare_backward_kernels`` (per bs-24
train step, at tiny-224's and then at base-384's stage geometries: a build
that refuses one of base-384's shapes is recorded as refusing it, its
earlier cases kept), ``compare_edt`` (``edt_pass`` along the three axes of a
(48, 512, 512) volume, per 9-class ``volume_metrics_device`` call), then the
root's block lab's attention cases (``attn``: rows and
columns of (128, 56, 56, 32); ``attn3``: (512, 98, 128), 4 heads). Every
case is timed behind the lab's spin kernel (``chip_smoke.time_ms`` with
``primed``), so that a call shorter than its wrapper's host work reads
device time, not the host's enqueue rate. ``--out`` writes per kernel its
ms, bound_ms, plain_ms, library_ms and the kernel's ms over the library's
cases (``library_vs_ms``) at tiny-224, and the lab's rows (median ms and
min-max), beside the card's name and power limit, and every ``[kernel]``
and ``[base384:kernel]`` line printed. ``--table`` prints the files side by
side, one column each, in the order given (parent, change, change, parent
for an A/B in turns): the per-kernel sums, then each case's ms a call.

The lab's rows (``attn``, ``attn3``, ``lepe``, ``mlp``) carry a SHA-256 of
each case's output (``sha256``, the first 16 hex digits), so that ``--table``
over parent, change, change, parent shows beside the times in turns whether
a redesigned kernel gives the parent's bits.

``--lab`` times only the block lab, every subcommand that runs
``lepe_windows`` or ``ln_mlp`` beside the attention ones (``lepe``,
``bisect``, ``attn``, ``attn3``, ``mlp``, ``lane``, ``parts``), each row with
its digest, and ``ln_mlp`` in its five modes (``MLP_MODES``, stage 1, B =
128) beside the chain of the port's unfused launches for the same mode
(where the root's lab has ``mlp_chain``). ``--save PATH`` writes the five
modes' outputs (``torch.save``, ~260 MB: keep it out of ``chiprun_out/``);
``--ulps A B`` prints, per mode, the largest difference of two such files in
bf16 ulps (adjacent bf16 values are one apart) and how many values differ.

``--f32`` times the float32 instances instead: the harness's
``compare_f32_kernels`` (every float32 forward kernel at the shapes of one
32-slice float32 serving forward) and ``f32_backward_kernels`` (per bs-24
train step at float32, with the forward GEMM's training epilogues) at
tiny-224's and then at base-384's geometries, each case behind the
spin kernel, each case's output digested (``sha256`` per ``[f32:...]``
line's case, the elements of a tuple in order). ``--table`` then prints the
per-kernel sums, each case's ms a call and, per case, the output bits by
file: over parent, change, change, parent the float32 GEMM and dX cases read
``A A A A`` where the change keeps the parent's bits; a weight gradient with
a new split plan reads ``A B B A`` (its bits follow the plan; the float64
rule holds it).

``--forward`` times instead the root's whole serving forward end to end:
one 32-slice tiny-224 chunk to labels (``model(x, emit="labels")`` on the
fused route, random weights from a seed), CUDA events around 5 back-to-back
forwards in each of 10 rounds, unprimed, so that a forward whose
host work outlasts its device work reads the host, their peak device
memory, and the device busy ms of a forward (the root's ``utils.profiling.device_busy_ms``, or the
harness's ``device_busy_ms`` for a root from before it moved there: then give
``--harness`` a checkout of the root's age). ``--table`` prints such files as
one row each.

``--no-pair`` runs that forward with no geometry paired (the stage runner's
``cswin_block.PAIR_GEOMETRIES`` emptied), for holding the pair route
against two chains in turns.

``--phases`` times the float32 stage-3 pair of a tiny-224 forward (B =
32) by phase instead (``measure_phases``: the pair stopped after LN1 + qkv,
the attention and proj, the whole pair, and the same two blocks as two
float32 chains, in ``--rounds`` rounds of the cases in turns), with the
pair's grid (CTAs, CTAs an SM, shared memory) and each case's digest: the
pair's and the chains' agree where the pair keeps their bits.

``--step`` times the root's whole bs-24 train step instead (the recipe's
step, ``train.make_train_step``, every block through ``CSWinBlockFn``, on
seeded slices at the config's size, random weights from a seed): CUDA
events around 2 steps in each of ``--rounds`` rounds, the device busy ms of
a step and its peak device memory. ``--cfg`` names the config (default
tiny-224) and ``--opts`` its overrides (``TPU.COMPUTE_DTYPE float32`` for
the float32 step); ``--forward`` takes them too. ``--table`` prints such
files as one row each.

A root runs under a harness that calls only what the root has. This
checkout's harness reads nothing of the training route from the root, so
the default mode runs a root from before the route was measured (the
parent's build, held in turns against this one); ``--forward`` under it
needs a root whose ``utils.profiling`` has ``device_busy_ms``.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import importlib.util
import io
import json
import os
import re
import statistics
import subprocess
import sys

LAB_SUBS = ("lepe", "bisect", "attn", "attn3", "mlp", "lane", "parts")
MLP_MODES = (("gelu", True, False), ("clamp", True, False), ("gelu", False, False),
             ("gelu", False, True), ("clamp", False, True))  # (act, ln, fold), chip_smoke's

KERNELS = ("gemm", "gemm_dgrad", "stripe_attention", "cswin_attention", "block_pair",
           "layernorm", "carafe_reassemble", "layernorm_bwd", "gemm_wgrad",
           "stripe_attention_bwd", "edt_pass")


def _load(root: str, harness: str):
    """The harness's ``chip_smoke`` module over the root's package."""
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(harness, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = chip_smoke
    spec.loader.exec_module(chip_smoke)
    import cswin_unet_tpu_torch

    for mod, where in ((chip_smoke, harness), (cswin_unet_tpu_torch, root)):
        if not os.path.abspath(mod.__file__).startswith(where + os.sep):
            raise SystemExit(f"tile_ab: imported {mod.__file__}, not from {where}")
    return chip_smoke


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def digest(t) -> str:
    """The first 16 hex digits of the SHA-256 of a tensor's bytes."""
    import torch

    raw = t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


def lab_rows(block_lab, subs, dev) -> list[dict]:
    """The lab's subcommands at B = 128 (their lines printed), each row with
    the digest of its case's output: the same cases, built again from the
    same seed, run once more."""
    import torch

    rows: list[dict] = []
    for sub in subs:
        if block_lab.main([sub, "--batch", "128"], rows):
            raise SystemExit(f"tile_ab: block_lab {sub} failed")
    digests = []
    with torch.inference_mode():
        for sub in subs:
            cases = block_lab.SUBCOMMANDS[sub](block_lab.Inputs(dev), 128,
                                                block_lab.DEFAULT_STAGES[sub])
            digests += [digest(c.run()) for c in cases]
            del cases
    if len(digests) != len(rows):
        raise SystemExit(f"tile_ab: {len(rows)} lab rows, {len(digests)} digests")
    return [{f: r[f] for f in ("sub", "case", "shape", "ms", "ms_min", "ms_max")} | {"sha256": d}
            for r, d in zip(rows, digests)]


def mlp_mode_rows(block_lab, dev, save: str | None) -> list[dict]:
    """``ln_mlp`` in each of ``MLP_MODES`` on one stage-1 batch, timed as the
    lab times (``run_cases``), with the digest of its output; beside each,
    where the root's lab has it, the same mode through the chain of unfused
    launches (``mlp_chain``)."""
    import torch

    inp = block_lab.Inputs(dev, seed=21)
    g = block_lab.STAGES[1]
    x = inp.bf16(128, g["H"], g["W"], g["C"])
    p = block_lab.stage1_params(inp, g["C"])
    cases, outputs = [], {}
    chain = getattr(block_lab, "mlp_chain", None)
    with torch.inference_mode():
        for act, ln, fold in MLP_MODES:
            name = f"act={act} ln={int(ln)} fold={int(fold)}"
            case = block_lab.mlp_case(name, x, p, act, ln, fold)
            outputs[name] = case.run()
            cases.append(case)
            if chain is not None:  # a lab with mlp_chain keeps the case's inputs in args
                a = case.args
                cases.append(block_lab.Case(
                    f"{name} chain", case.shape,
                    lambda a=a: chain(a["x"], a["weights"], a["act"], a["ln"], a["fold"]),
                    case.plain, {}, moved=case.moved, tc_flops=case.tc_flops,
                    f32_ops=case.f32_ops))
        rows = block_lab.run_cases("mlp-modes", cases, dev)
    if save:
        torch.save({k: v.cpu() for k, v in outputs.items()}, save)
    with torch.inference_mode():
        return [{f: row[f] for f in ("sub", "case", "shape", "ms", "ms_min", "ms_max")}
                | {"sha256": digest(outputs[case.name] if case.name in outputs
                                    else case.run())}
                for case, row in zip(cases, rows)]


def measure(root: str, harness: str) -> dict:
    import torch

    chip_smoke = _load(root, harness)
    from cswin_unet_tpu_torch.tools import block_lab

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    timer = chip_smoke.time_ms
    chip_smoke.time_ms = lambda fn, reps=10, rounds=5, primed=False: timer(
        fn, reps=reps, rounds=rounds, primed=True)
    cfg = chip_smoke.smoke_config()
    printed = io.StringIO()
    refused = None
    with contextlib.redirect_stdout(printed):
        tally = chip_smoke.compare_kernels(cfg, dev, chip_smoke.SERVE_BATCH)
        chip_smoke.compare_backward_kernels(cfg, dev, chip_smoke.TRAIN_BATCH, tally)
        try:
            chip_smoke.compare_backward_kernels(
                chip_smoke.smoke_config(cfg=chip_smoke.CFG384), dev, chip_smoke.TRAIN_BATCH,
                chip_smoke.KernelTally("base384:kernel"))
        except ValueError as e:  # a build that refuses one of base-384's shapes
            refused = str(e)
        chip_smoke.compare_edt(dev, tally)
    print(printed.getvalue(), end="")
    lab = lab_rows(block_lab, ("attn", "attn3", "lepe", "mlp"), dev)
    smi = _smi()
    keys = ("ms", "bound_ms", "plain_ms", "library_ms", "library_vs_ms")
    return dict(root=root, harness=harness, device=torch.cuda.get_device_name(0),
                nvidia_smi=smi, base384_refused=refused,
                kernel_lines=[ln for ln in printed.getvalue().splitlines()
                              if ln.startswith(("[kernel]", "[base384:kernel]"))],
                kernels={k: {f: tally.rows[k][f] for f in keys} for k in KERNELS},
                lab=lab)


def measure_f32(root: str, harness: str) -> dict:
    import torch

    chip_smoke = _load(root, harness)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    digests: dict[str, str] = {}
    case = chip_smoke.KernelTally.case

    def digested(self, name, label, kernel_fn, *args, **kw):
        case(self, name, label, kernel_fn, *args, **kw)
        got = kernel_fn()
        parts = got if isinstance(got, tuple) else (got,)
        digests[f"[{self.tag}] {name} {label}"] = "/".join(digest(t) for t in parts)

    chip_smoke.KernelTally.case = digested
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        tally = chip_smoke.compare_f32_kernels(chip_smoke.smoke_config(), dev,
                                               chip_smoke.SERVE_BATCH)
        chip_smoke.f32_backward_kernels(chip_smoke.smoke_config(), dev,
                                        chip_smoke.TRAIN_BATCH, tally)
        cfg384 = chip_smoke.smoke_config(cfg=chip_smoke.CFG384)
        tally384 = chip_smoke.compare_f32_kernels(cfg384, dev, chip_smoke.SERVE_BATCH,
                                                  tag="f32:base384:kernel")
        chip_smoke.f32_backward_kernels(cfg384, dev, chip_smoke.TRAIN_BATCH, tally384)
    chip_smoke.KernelTally.case = case
    print(printed.getvalue(), end="")
    keys = ("ms", "bound_ms", "plain_ms", "library_ms", "library_vs_ms")
    names = [k for k in tally.rows if k.endswith("_f32") and tally.rows[k]["ms"] > 0]
    return dict(root=root, harness=harness, device=torch.cuda.get_device_name(0),
                nvidia_smi=_smi(),
                kernel_lines=[ln for ln in printed.getvalue().splitlines()
                              if ln.startswith(("[f32:kernel]", "[f32:base384:kernel]"))],
                kernels={k: {f: tally.rows[k][f] for f in keys} for k in names},
                kernels384={k: {f: tally384.rows[k][f] for f in keys}
                            for k in names if tally384.rows[k]["ms"] > 0},
                digests=digests)


PHASES = ("qkv", "attention", "proj")


def measure_phases(root: str, harness: str, rounds: int) -> dict:
    """The float32 stage-3 pair of a tiny-224 serving forward (B = 32, (14,
    14, 256), heads 8, split 7) timed by phase: the pair stopped after its
    first block's qkv (LN1 + qkv), attention and proj phases
    (``kernels.block_pair_phases``), the whole pair, and the same two blocks
    as two float32 chains, each behind the spin kernel, in ``rounds``
    rounds (the cases in turns within a round, in both orders). Differences of the stops
    give each phase: LN1 + qkv, attention, proj, then LN2 + fc1 + fc2 as
    half the pair less the first three. A root whose kernels lack the stops
    (before they existed) times the pair and the chains only. Each case's
    output is digested; the pair's grid is recorded."""
    import numpy as np
    import torch

    chip_smoke = _load(root, harness)
    from cswin_unet_tpu_torch.ops.cuda import kernels as K
    from cswin_unet_tpu_torch.ops.cuda.cswin_block import fused_cswin_block

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    B, H, C, heads, split = chip_smoke.SERVE_BATCH, 14, 256, 8, 7
    rng = np.random.default_rng(17)
    p1 = chip_smoke.block_params(rng, C, False, dev)
    p2 = chip_smoke.block_params(rng, C, False, dev)
    x = torch.from_numpy(rng.standard_normal((B, H, H, C)).astype(np.float32)).to(dev)
    kw = dict(heads=heads, split=split, scale=(C // heads) ** -0.5)
    cases = {"pair": lambda: K.block_pair(x, p1, p2, **kw),
             "chains": lambda: fused_cswin_block(fused_cswin_block(
                 x, p1, last_stage=False, **kw), p2, last_stage=False, **kw)}
    stops = hasattr(K, "block_pair_phases")
    if stops:
        for stop in PHASES:
            cases[stop] = (lambda stop=stop: K.block_pair_phases(x, p1, p2, stop=stop, **kw))
    ms = {name: [] for name in cases}
    for r in range(rounds):  # the cases in turns, the order reversed every other round
        for name in list(cases)[::1 if r % 2 == 0 else -1]:
            ms[name].append(chip_smoke.time_ms(cases[name], reps=10, rounds=1, primed=True))
    K.block_pair(x, p1, p2, **kw)
    grid = dict(K.block_pair.grid)
    digests = {name: digest(fn()) for name, fn in cases.items()}
    med = {name: statistics.median(v) for name, v in ms.items()}
    phases = None
    if stops:
        phases = {"ln1+qkv": med["qkv"], "attention": med["attention"] - med["qkv"],
                  "proj": med["proj"] - med["attention"],
                  "ln2+fc1+fc2": med["pair"] / 2 - med["proj"]}
    for name in cases:
        print(f"[phases] {name}: {med[name]:.4f} ms [{min(ms[name]):.4f}-{max(ms[name]):.4f}] "
              f"sha256 {digests[name]}", flush=True)
    print(f"[phases] pair grid {grid}; by phase (ms a block) {phases}", flush=True)
    return dict(root=root, harness=harness, device=torch.cuda.get_device_name(0),
                nvidia_smi=_smi(), phases=dict(ms=ms, median=med, by_phase=phases, grid=grid,
                                               digests=digests))


def measure_lab(root: str, harness: str, save: str | None) -> dict:
    import torch

    _load(root, harness)
    from cswin_unet_tpu_torch.tools import block_lab

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    lab = lab_rows(block_lab, LAB_SUBS, dev) + mlp_mode_rows(block_lab, dev, save)
    return dict(root=root, harness=harness, device=torch.cuda.get_device_name(0),
                nvidia_smi=_smi(), lab=lab)


def measure_step(root: str, harness: str, cfg_path: str | None, opts, rounds: int) -> dict:
    import numpy as np
    import torch

    chip_smoke = _load(root, harness)
    from cswin_unet_tpu_torch.models import build_model
    from cswin_unet_tpu_torch.train import make_optimizer, make_train_step
    from cswin_unet_tpu_torch.utils.profiling import device_busy_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = chip_smoke.smoke_config(opts, cfg=cfg_path or chip_smoke.CFG)
    batch, size = chip_smoke.TRAIN_BATCH, cfg.DATA.IMG_SIZE
    model = build_model(cfg, num_classes=9, device=dev, seed=0, train=True)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.standard_normal((batch, size, size, 1)).astype(
        np.float32)).to(dev)
    lab = torch.from_numpy(rng.integers(0, 9, (batch, size, size)).astype(np.int64)).to(dev)
    opt, sched = make_optimizer(model.parameters(), 0.01, 30000)
    gen = torch.Generator(device=dev).manual_seed(0)
    step = make_train_step(model, opt, sched, 9)
    ms = [chip_smoke.time_ms(lambda: step(img, lab, gen), reps=2, rounds=1)
          for _ in range(rounds)]
    busy = device_busy_ms(lambda: step(img, lab, gen), 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(img, lab, gen)
    torch.cuda.synchronize()
    return dict(root=root, harness=harness, device=torch.cuda.get_device_name(0),
                nvidia_smi=_smi(), step=dict(config=cfg.MODEL.NAME, img_size=size,
                                             dtype=cfg.TPU.COMPUTE_DTYPE, batch=batch, ms=ms,
                                             busy_ms=busy,
                                             peak_gib=torch.cuda.max_memory_allocated() / 2**30))


def measure_forward(root: str, harness: str, cfg_path: str | None = None, opts=None,
                    no_pair: bool = False) -> dict:
    import numpy as np
    import torch

    chip_smoke = _load(root, harness)
    from cswin_unet_tpu_torch.models import build_model
    from cswin_unet_tpu_torch.ops.cuda import cswin_block
    from cswin_unet_tpu_torch.utils import profiling

    if no_pair:  # the stage runner reads the geometries at call time
        cswin_block.PAIR_GEOMETRIES = frozenset()

    # A root from before the busy reading moved into utils.profiling reads it
    # through a harness of its own age, whose chip_smoke defines it.
    device_busy_ms = getattr(profiling, "device_busy_ms", None) or getattr(
        chip_smoke, "device_busy_ms", None)
    if device_busy_ms is None:
        raise SystemExit("tile_ab: neither the root's utils.profiling nor the harness "
                         "has device_busy_ms; give --harness a checkout of the root's age")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    batch = chip_smoke.SERVE_BATCH
    cfg = chip_smoke.smoke_config(opts, cfg=cfg_path or chip_smoke.CFG)
    size = cfg.DATA.IMG_SIZE
    model = build_model(cfg, num_classes=9, device=dev, seed=1)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (batch, size, size, 1)).astype(np.float32)).to(dev)

    def forward():
        with torch.inference_mode():
            return model(x, emit="labels")

    forward()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = [chip_smoke.time_ms(forward, reps=5, rounds=1) for _ in range(10)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    busy = device_busy_ms(forward, 5)
    return dict(root=root, harness=harness, device=torch.cuda.get_device_name(0),
                nvidia_smi=_smi(), forward=dict(config=cfg.MODEL.NAME, img_size=size,
                                                dtype=cfg.TPU.COMPUTE_DTYPE, batch=batch,
                                                pairs=sorted(cswin_block.PAIR_GEOMETRIES),
                                                ms=ms, busy_ms=busy, peak_gib=peak))


def table(paths: list[str]) -> None:
    runs = []
    for p in paths:
        with open(p) as f:
            runs.append(json.load(f))
    print("cards: " + "; ".join(f"{os.path.basename(p)} {r['nvidia_smi']}"
                                for p, r in zip(paths, runs)))
    if "forward" in runs[0] or "step" in runs[0]:
        what = "forward" if "forward" in runs[0] else "step"
        print(f"{'forward of one chunk to labels' if what == 'forward' else 'bs-24 train step'}"
              f": ms median [min-max] of the rounds, device busy ms, peak GiB, root")
        for p, r in zip(paths, runs):
            row = r[what]
            ms, busy, peak = row["ms"], row["busy_ms"], row.get("peak_gib")
            pairs = "" if "pairs" not in row else f" pairs {row['pairs'] or 'off'}"
            print(f"{os.path.basename(p)}: {row.get('config', '')} {row.get('dtype', '')}{pairs} "
                  f"{statistics.median(ms):.3f} [{min(ms):.3f}-{max(ms):.3f}] busy "
                  f"{'unread' if busy is None else f'{busy:.3f}'}"
                  f"{'' if peak is None else f' peak {peak:.3f} GiB'} {r['root']}")
        return
    head = " | ".join(os.path.basename(p) for p in paths)
    if "kernels" not in runs[0]:  # --lab
        lab_table(paths, runs, head)
        return
    print(f"kernel (per unit of work): ms {head} | bound_ms | library_ms / the kernel's ms "
          f"on the same cases, per file")
    for part in ("kernels", "kernels384"):
        for k in runs[0].get(part, {}):
            rows = [r[part][k] for r in runs]
            cells = " | ".join(f"{row['ms']:.4f}" for row in rows)
            lib = " | ".join("none" if row["library_ms"] is None else
                             f"{row['library_ms']:.4f} / {row['library_vs_ms']:.4f}"
                             for row in rows)
            name = k if part == "kernels" else f"{k} (base-384)"
            print(f"{name}: {cells} | {rows[0]['bound_ms']:.4f} | {lib}")
    cases: dict[str, list] = {}  # each case's ms a call, by file ('-': not run)
    for i, r in enumerate(runs):
        for ln in r.get("kernel_lines", []):
            ms = re.search(r" ms=([\d.]+)", ln)
            if ms:
                cases.setdefault(ln.split(": ")[0], ["-"] * len(runs))[i] = ms.group(1)
    print(f"case (its calls a unit): ms a call {head}")
    for case, cells in cases.items():
        print(f"{case}: {' | '.join(cells)}")
    for p, r in zip(paths, runs):
        if r.get("base384_refused"):
            print(f"{os.path.basename(p)} base-384 refused: {r['base384_refused']}")
    if "digests" in runs[0]:
        print("case: output bits by file (each distinct digest a letter, in file order)")
        for case in runs[0]["digests"]:
            letters: dict[str, str] = {}
            print(f"{case}: " + " ".join(
                "-" if case not in r["digests"] else
                letters.setdefault(r["digests"][case], "ABCD"[len(letters)]) for r in runs))
        return
    lab_table(paths, runs, head)


def lab_table(paths: list[str], runs: list[dict], head: str) -> None:
    """The lab's rows side by side, and whether the files' outputs agree:
    each distinct digest of a row gets a letter, in file order (``A A A A``:
    the same bits in all four runs)."""
    print(f"lab case: ms median [min-max] {head} | output bits by file ('-': a root "
          f"without the case)")
    by_run = [{(row["sub"], row["case"]): row for row in r["lab"]} for r in runs]
    keys = list(dict.fromkeys(k for rows in by_run for k in rows))
    for key in keys:
        found = [rows.get(key) for rows in by_run]
        cells = " | ".join("-" if r is None else
                           f"{r['ms']:.4f} [{r['ms_min']:.4f}-{r['ms_max']:.4f}]"
                           for r in found)
        letters: dict[str, str] = {}
        bits = " ".join("-" if r is None or r.get("sha256") is None else
                        letters.setdefault(r["sha256"], "ABCD"[len(letters)]) for r in found)
        shape = next(r["shape"] for r in found if r is not None)
        print(f"{key[0]} {key[1]} {tuple(shape)}: {cells} | {bits}")


def ulps(a_path: str, b_path: str) -> None:
    """Per output of two ``--save`` files: the largest difference in bf16
    ulps (the bit patterns as ordered integers, so that adjacent bf16 values
    differ by one and +0 equals -0) and how many values differ."""
    import torch

    a, b = torch.load(a_path), torch.load(b_path)
    print(f"bf16 ulps: {os.path.basename(a_path)} vs {os.path.basename(b_path)}")
    for k in a:
        def ordered(t):
            bits = t.contiguous().view(torch.int16).to(torch.int32)
            mag = bits & 0x7FFF
            return torch.where(bits < 0, -mag, mag)

        d = (ordered(a[k]) - ordered(b[k])).abs()
        print(f"{k}: max {int(d.max())} ulps, {int((d > 0).sum())} of {d.numel()} values "
              f"differ")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", help="checkout whose kernels to time")
    ap.add_argument("--harness", help="checkout whose chip_smoke.py gives the cases "
                    "(default: the root)")
    ap.add_argument("--out", help="where to write the results (JSON)")
    ap.add_argument("--table", nargs="+", metavar="JSON", help="print result files side by side")
    ap.add_argument("--forward", action="store_true",
                    help="time the root's 32-slice serving forward end to end instead")
    ap.add_argument("--no-pair", action="store_true",
                    help="with --forward: pair no geometry (cswin_block.PAIR_GEOMETRIES "
                    "emptied) instead of the committed ones")
    ap.add_argument("--step", action="store_true",
                    help="time the root's bs-24 train step end to end instead")
    ap.add_argument("--cfg", help="with --step or --forward: the config YAML "
                    "(default tiny-224)")
    ap.add_argument("--opts", nargs="+", default=None,
                    help="with --step or --forward: config overrides, KEY VALUE pairs")
    ap.add_argument("--rounds", type=int, default=10,
                    help="with --step: timed rounds of 2 steps (default 10)")
    ap.add_argument("--f32", action="store_true",
                    help="time the float32 instances, with their output digests")
    ap.add_argument("--phases", action="store_true",
                    help="time the float32 stage-3 pair by phase and two chains instead")
    ap.add_argument("--lab", action="store_true",
                    help="time only the block lab's cases, with their output digests")
    ap.add_argument("--save", help="with --lab: where to write ln_mlp's five outputs")
    ap.add_argument("--ulps", nargs=2, metavar="PT", help="compare two --save files")
    args = ap.parse_args()
    if args.table:
        table(args.table)
        return 0
    if args.ulps:
        ulps(*args.ulps)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("tile_ab: no CUDA device available", file=sys.stderr)
        return 2
    root, harness = os.path.abspath(args.root), os.path.abspath(args.harness or args.root)
    result = (measure_forward(root, harness, args.cfg, args.opts, args.no_pair) if args.forward
              else measure_step(root, harness, args.cfg, args.opts, args.rounds) if args.step
              else measure_phases(root, harness, args.rounds) if args.phases
              else measure_lab(root, harness, args.save) if args.lab
              else measure_f32(root, harness) if args.f32
              else measure(root, harness))
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"[tile_ab] {args.root}: wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
