#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cswin_unet_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the process then exits non-zero):

  1. torch / CUDA versions and the card's name and power limit.
  2. Build the hand-written CUDA kernels from ``csrc/`` with nvcc.
  3. Hold every kernel against its plain PyTorch version on the card, on
     bf16 inputs from a seeded numpy generator at the tiny-224 shapes: each
     kernel at every shape one 32-slice serving forward gives it, then at
     B = 8 the CSWin block at the four stage geometries, ``carafe_up`` @28
     and the tail (logits and labels) @56. Tolerance: relative L2 error
     <= 0.02 (the reference gate's bf16 default); labels by the margin rule
     (a mismatch counts only where the plain top-2 logit gap exceeds
     0.02·max|logit|). Times are CUDA-event medians of back-to-back runs.
     The backward kernels likewise at the 224 stage-1/2/3 geometries, B = 24
     (the train batch): ``layernorm_bwd``, ``gemm_dgrad`` (with its GELU
     backward and drop-path operand scale), ``gemm_wgrad``,
     ``stripe_attention_bwd``, and the forward GEMM's training epilogues
     (drop-path residual, GELU keeping its pre-activation).
  4. Modules: ``CSWinBlockFn`` forward and backward at stages 1, 2 and 3
     (B = 24, the same drop-path multipliers) and the two CARAFE Functions,
     each output and gradient against torch autograd through the plain
     composition, relative L2 <= 0.02. The CARAFE Functions' backward is
     autograd of that same plain composition, so their gradient lines check
     only the wiring (argument order, up factor); the arithmetic of that
     backward is held against ``jax.grad`` in
     ``tests/test_torch_carafe_grad.py``.
  5. Serve three volumes through ``VolumeServer`` from a seeded random
     tiny-224 checkpoint in the JAX package's ``.npz`` format: (40, 512, 512)
     ``.npy`` (zoom), (33, 224, 224) ``.npz`` (tail bucket), (64, 224, 224)
     ``.npy``. Checks the NIfTI outputs, the label range, each kernel's
     launch count against the routing, and one served chunk's labels against
     the plain path on the card; times the 32-slice forward on both paths.
  6. Train: 48 synthetic 512x512 ``.npz`` slices with blob labels, the
     port's ``trainer_synapse`` for 2 epochs at bs 24 (4 steps, drop-path
     0.2 live), launch counts against the training routing, the log lines,
     and ``epoch_1.npz`` served by ``VolumeServer``. Then on one fixed batch:
     the loss and every parameter gradient of the kernel route against the
     plain route (same weights, same drop-path draws), one step's launch
     counts, 10 SGD steps whose loss must fall, and the train step's time
     on both routes.
  7. One JSON line with the per-kernel results, then the contract line
     ``{"ok": true, "device": {...}}``.

Imports nothing of JAX. Exits non-zero without a result when no CUDA device
is available or when the package is not next to this file.
"""

from __future__ import annotations

import gzip
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(ROOT, "cswin_unet_tpu", "configs", "cswin_tiny_224_lite.yaml")
B = 8            # batch of the module comparisons
SERVE_BATCH = 32  # slices per forward chunk when serving (--batch_slices)
TRAIN_BATCH = 24  # the reference recipe's batch
TOL = 0.02
BWD = "cswin_unet_tpu/ops/pallas/cswin_block.py:1854"  # _fused_block_bwd_xt
SOURCES = {
    "layernorm": ("cswin_unet_tpu_torch/ops/cuda/csrc/layernorm.cu",
                  "cswin_unet_tpu/ops/pallas/cswin_block.py:1465"),
    "gemm": ("cswin_unet_tpu_torch/ops/cuda/csrc/gemm.cu",
             "cswin_unet_tpu/ops/pallas/cswin_block.py:1465"),
    "stripe_attention": ("cswin_unet_tpu_torch/ops/cuda/csrc/stripe_attention.cu",
                         "cswin_unet_tpu/ops/pallas/cswin_block.py:1465"),
    "carafe_reassemble": ("cswin_unet_tpu_torch/ops/cuda/csrc/carafe.cu",
                          "cswin_unet_tpu/ops/pallas/carafe_tail.py:69"),
    "layernorm_bwd": ("cswin_unet_tpu_torch/ops/cuda/csrc/layernorm.cu", BWD),
    "gemm_dgrad": ("cswin_unet_tpu_torch/ops/cuda/csrc/gemm.cu", BWD),
    "gemm_wgrad": ("cswin_unet_tpu_torch/ops/cuda/csrc/gemm.cu", BWD),
    "stripe_attention_bwd": ("cswin_unet_tpu_torch/ops/cuda/csrc/"
                             "stripe_attention_bwd.cu", BWD),
}
# Kernels whose tally is per bs-24 train step; the others' per 32-slice
# serving forward.
TRAIN_KERNELS = ("layernorm_bwd", "gemm_dgrad", "gemm_wgrad",
                 "stripe_attention_bwd")


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / max(float(want.norm()), 1e-12))


def margin_mismatches(labels, ref_logits) -> tuple[int, int]:
    """(raw mismatches, mismatches where the reference's top-2 gap exceeds
    0.02·max|logit|)."""
    import torch

    top2 = torch.topk(ref_logits.float(), 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    thr = 0.02 * float(ref_logits.float().abs().max())
    mism = labels.long() != ref_logits.float().argmax(-1)
    return int(mism.sum()), int((mism & (margin > thr)).sum())


def judge(label: str, got, want, check: str) -> tuple[str, bool, float]:
    """Hold an output against its plain version: (text, ok, max abs error).
    ``check="labels"``: int32 labels against plain logits, by the margin
    rule; ``"rel"``: finite values within relative L2 ``TOL``, each element
    of a tuple on its own."""
    import torch

    if isinstance(got, tuple):
        parts = [judge(f"{label}[{i}]", g, w, check)
                 for i, (g, w) in enumerate(zip(got, want))]
        return (" | ".join(t for t, _, _ in parts), all(ok for _, ok, _ in parts),
                max(m for _, _, m in parts))
    if check == "labels":
        require(got.dtype == torch.int32, f"{label}: labels dtype {got.dtype}")
        raw, above = margin_mismatches(got, want)
        return f"mismatches={raw} above_margin={above}", above == 0, 0.0
    got, want = got.float(), want.float()
    require(bool(torch.isfinite(got).all()), f"{label}: non-finite")
    err = rel_l2(got, want)
    mx = float((got - want).abs().max())
    return f"rel_l2={err:.3e} max_abs={mx:.3e}", err <= TOL, mx


def time_ms(fn, reps: int = 10, rounds: int = 5) -> float:
    """ms per call: CUDA events around ``reps`` back-to-back calls (so the
    device queue stays full), median over ``rounds`` after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def read_nifti(path: str, shape) -> np.ndarray:
    """Voxels of a NIfTI-1 file written by ``write_nifti`` (352-byte
    offset, float32)."""
    with gzip.open(path, "rb") as f:
        raw = f.read()
    require(raw[344:347] == b"n+1", f"{path}: not NIfTI-1")
    return np.frombuffer(raw[352:], np.float32).reshape(shape)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def stage_geometries(cfg):
    cs = cfg.MODEL.CSWIN
    ed, img = cs.EMBED_DIM, cfg.DATA.IMG_SIZE
    for s in range(4):
        reso = img // (4 * 2**s)
        yield dict(stage=s + 1, H=reso, C=ed * 2**s, heads=cs.NUM_HEADS[s],
                   split=cs.SPLIT_SIZE[s], depth=cs.DEPTH[s],
                   last=s == 3 or reso == cs.SPLIT_SIZE[s])


def block_params(rng, C, last, dev):
    import torch

    from cswin_unet_tpu_torch.ops.cuda.cswin_block import BlockParams

    cb = C if last else C // 2
    t = lambda *s, sc=0.1, off=0.0: torch.from_numpy(
        (rng.standard_normal(s) * sc + off).astype(np.float32)).to(dev)
    lk0, lb0 = t(cb, 1, 3, 3, sc=0.3), t(cb)
    lk1, lb1 = (lk0, lb0) if last else (t(cb, 1, 3, 3, sc=0.3), t(cb))
    return BlockParams(t(C, sc=0.3, off=1.0), t(C), t(3 * C, C), t(3 * C), lk0, lb0,
                       lk1, lb1, t(C, C), t(C), t(C, sc=0.3, off=1.0), t(C),
                       t(4 * C, C), t(4 * C), t(C, 4 * C), t(C))


def carafe_params(rng, C, C_out, up, nc, dev):
    import torch

    t = lambda *s, sc=0.2: torch.from_numpy(
        (rng.standard_normal(s) * sc).astype(np.float32)).to(dev)
    cm = C // 4
    p = [t(cm, C, 1, 1), t(cm), t(9 * up * up, cm, 3, 3), t(9 * up * up),
         t(C_out, C, 1, 1), t(C_out)]
    if nc is not None:
        p.append(t(nc, C_out, 1, 1))
    return p


class KernelTally:
    """Per-kernel worst error and time per serving forward (each case timed
    at the serving chunk's shapes and weighted by its number of calls in one
    forward)."""

    def __init__(self):
        self.rows = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0) for k in SOURCES}

    def case(self, name, label, kernel_fn, plain_fn, calls, check="rel"):
        import torch

        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        err_txt, ok, mx = judge(f"{name} {label}", got, want, check)
        self.rows[name]["max_abs_err"] = max(self.rows[name]["max_abs_err"], mx)
        ms, pms = time_ms(kernel_fn), time_ms(plain_fn)
        self.rows[name]["ms"] += calls * ms
        self.rows[name]["plain_ms"] += calls * pms
        print(f"[kernel] {name} {label} x{calls}: {err_txt} ms={ms:.4f} "
              f"plain_ms={pms:.4f} {'ok' if ok else 'FAIL'}", flush=True)
        require(ok, f"{name} {label}: {err_txt}")


def compare_kernels(cfg, dev, B: int) -> KernelTally:
    """Every kernel at every shape one forward of B slices gives it."""
    import torch

    from cswin_unet_tpu_torch.ops.cuda import kernels as K

    rng = np.random.default_rng(0)
    bf = torch.bfloat16
    rnd = lambda *s, sc=1.0: torch.from_numpy(
        (rng.standard_normal(s) * sc).astype(np.float32)).to(dev)
    tally = KernelTally()
    for g in stage_geometries(cfg):
        H, C, blocks = g["H"], g["C"], 2 * g["depth"]
        M = B * H * H
        x, r = rnd(M, C).to(bf), rnd(M, C).to(bf)
        w, b = rnd(C, sc=0.3) + 1, rnd(C, sc=0.1)
        tag = f"@{H}x{H}x{C}"
        tally.case("layernorm", tag, lambda: K.layernorm(x, w, b),
                   lambda: K.layernorm_plain(x, w, b), 2 * blocks)
        h = rnd(M, 4 * C).to(bf)
        for what, a, n, epi, res in (("qkv", x, 3 * C, "bias", None),
                                     ("proj", x, C, "residual", r),
                                     ("fc1", x, 4 * C, "gelu", None),
                                     ("fc2", h, C, "residual", r)):
            wt = rnd(n, a.shape[1], sc=a.shape[1] ** -0.5).to(bf)
            bias = rnd(n, sc=0.1)
            tally.case("gemm", f"{what}{tag}",
                       lambda: K.gemm(a, wt, bias, residual=res, epilogue=epi),
                       lambda: K.gemm_plain(a, wt, bias, residual=res, epilogue=epi),
                       blocks)
        qkv = rnd(B, H, H, 3 * C).to(bf)
        scale = (C // g["heads"]) ** -0.5
        if g["last"]:
            branches = [(0, C, g["heads"], H, H)]
        else:
            branches = [(0, C // 2, g["heads"] // 2, H, g["split"]),
                        (C // 2, C // 2, g["heads"] // 2, g["split"], H)]
        for off, cb, nh, hs, ws in branches:
            lw, lb = rnd(cb, 1, 3, 3, sc=0.3), rnd(cb, sc=0.1)
            out = torch.zeros(B, H, H, C, dtype=bf, device=dev)
            kw = dict(ch_off=off, heads=nh, h_sp=hs, w_sp=ws, scale=scale)
            sl = slice(off, off + cb)
            tally.case("stripe_attention", f"{tag} window {hs}x{ws}",
                       lambda: K.stripe_attention(qkv, lw, lb, out, **kw)[..., sl],
                       lambda: K.stripe_attention_plain(qkv, lw, lb, out.clone(),
                                                        **kw)[..., sl],
                       blocks)
    # CARAFE sites: upsample2 (28 -> 56, plain upsampler) and the x4 tail.
    C2 = cfg.MODEL.CSWIN.EMBED_DIM * 2
    for label, H, C, cm, nc, up, labels, calls in (
            ("up@28", 28, C2, C2 // 4, C2 // 2, 2, False, 1),
            ("tail-logits@56", 56, C2 // 2, C2 // 8, 9, 4, False, 0),
            ("tail-labels@56", 56, C2 // 2, C2 // 8, 9, 4, True, 1)):
        a = rnd(B * H * H, C).to(bf)
        wt = rnd(cm + nc, C, sc=C ** -0.5).to(bf)
        bias_cat = torch.cat([rnd(cm, sc=0.1), torch.zeros(nc, device=dev)])
        tally.case("gemm", f"carafe-{label}", lambda: K.gemm(a, wt, bias_cat),
                   lambda: K.gemm_plain(a, wt, bias_cat), calls)
        gy = rnd(B, H, H, cm + nc).to(bf)
        ew, eb, bo = rnd(9 * up * up, cm, 3, 3, sc=0.2), rnd(9 * up * up), rnd(nc)
        kw = dict(c_mid=cm, up=up, labels=labels)
        plain = (lambda: K.carafe_reassemble_plain(gy, ew, eb, bo, c_mid=cm, up=up,
                                                   labels=False).float()) \
            if labels else (lambda: K.carafe_reassemble_plain(gy, ew, eb, bo, **kw))
        tally.case("carafe_reassemble", label,
                   lambda: K.carafe_reassemble(gy, ew, eb, bo, **kw), plain, calls,
                   check="labels" if labels else "rel")
    return tally


def compare_backward_kernels(cfg, dev, B: int, tally: KernelTally) -> None:
    """The backward kernels and the forward GEMM's training epilogues at the
    224 stage-1/2/3 geometries, batch B; each case weighted by its calls in
    one train step (the dual-branch blocks at resolution >= 28 run them;
    stage 3 is timed for a later routing decision and weighted 0)."""
    import torch

    from cswin_unet_tpu_torch.models.cswin_unet import FUSE_TRAIN_MIN_RESO
    from cswin_unet_tpu_torch.ops.cuda import kernels as K

    rng = np.random.default_rng(3)
    bf = torch.bfloat16
    rnd = lambda *s, sc=1.0: torch.from_numpy(
        (rng.standard_normal(s) * sc).astype(np.float32)).to(dev)
    for g in stage_geometries(cfg):
        if g["last"]:
            continue
        H, C, heads, split = g["H"], g["C"], g["heads"], g["split"]
        M, hw = B * H * H, H * H
        routed = 2 * g["depth"] if H >= FUSE_TRAIN_MIN_RESO else 0
        tag = f"@{H}x{H}x{C}"
        dp = torch.from_numpy((rng.random(B) < 0.8).astype(np.float32) / 0.8).to(dev)
        x, dy, res = (rnd(M, C).to(bf) for _ in range(3))
        w, b = rnd(C, sc=0.3) + 1, rnd(C, sc=0.1)
        tally.case("layernorm_bwd", tag,
                   lambda: K.layernorm_bwd(x, dy, w, residual=res),
                   lambda: K.layernorm_bwd_plain(x, dy, w, residual=res), 2 * routed)
        h = rnd(M, 4 * C).to(bf)
        pre_k, pre_p = (torch.empty(M, 4 * C, dtype=bf, device=dev) for _ in range(2))
        for what, a, n, epi, kw in (
                ("proj+droppath", x, C, "residual", dict(residual=res, dp=dp)),
                ("fc1-gelu-keep-h", x, 4 * C, "gelu", {}),
                ("fc2+droppath", h, C, "residual", dict(residual=res, dp=dp))):
            wt = rnd(n, a.shape[1], sc=a.shape[1] ** -0.5).to(bf)
            bias = rnd(n, sc=0.1)
            kw = dict(kw, epilogue=epi, rows_per_sample=hw)
            if epi == "gelu":
                kern = lambda: (K.gemm(a, wt, bias, pre=pre_k, **kw), pre_k)
                plain = lambda: (K.gemm_plain(a, wt, bias, pre=pre_p, **kw), pre_p)
            else:
                kern = lambda: K.gemm(a, wt, bias, **kw)
                plain = lambda: K.gemm_plain(a, wt, bias, **kw)
            tally.case("gemm", f"train-{what}{tag}", kern, plain, 0)
        for what, n, k, kw in (("fc2-gelu_bwd", C, 4 * C, dict(dp=dp, gelu_h=h)),
                               ("fc1", 4 * C, C, {}),
                               ("proj+droppath", C, C, dict(dp=dp)),
                               ("qkv", 3 * C, C, {})):
            d = rnd(M, n).to(bf)
            wt = rnd(n, k, sc=n ** -0.5)
            kw = dict(kw, rows_per_sample=hw)
            tally.case("gemm_dgrad", f"{what}{tag}",
                       lambda: K.gemm_dgrad(d, wt, **kw),
                       lambda: K.gemm_dgrad_plain(d, wt, **kw), routed)
        for what, k, n, kw in (("fc2+droppath", 4 * C, C, dict(dp=dp)),
                               ("fc1", C, 4 * C, {}),
                               ("proj+droppath", C, C, dict(dp=dp)),
                               ("qkv", C, 3 * C, {})):
            a, d = rnd(M, k).to(bf), rnd(M, n).to(bf)
            kw = dict(kw, rows_per_sample=hw)
            tally.case("gemm_wgrad", f"{what}{tag}",
                       lambda: K.gemm_wgrad(a, d, **kw),
                       lambda: K.gemm_wgrad_plain(a, d, **kw), routed)
        qkv, dout = rnd(B, H, H, 3 * C).to(bf), rnd(B, H, H, C).to(bf)
        scale = (C // heads) ** -0.5
        for off, hs, ws in ((0, H, split), (C // 2, split, H)):
            lw = rnd(C // 2, 1, 3, 3, sc=0.3)
            kw = dict(ch_off=off, heads=heads // 2, h_sp=hs, w_sp=ws, scale=scale)
            chans = torch.cat([torch.arange(off, off + C // 2) + i * C
                               for i in range(3)]).to(dev)

            def run(fn):
                dqkv = torch.zeros(B, H, H, 3 * C, dtype=bf, device=dev)
                dw, db = fn(qkv, dout, lw, dqkv, **kw)
                return dqkv[..., chans], dw, db

            tally.case("stripe_attention_bwd", f"{tag} window {hs}x{ws}",
                       lambda: run(K.stripe_attention_bwd),
                       lambda: run(K.stripe_attention_bwd_plain), routed)


def grads_vs_plain(label, fn, plain, inputs, cotangent, names) -> None:
    """Output and gradients of ``fn(*inputs)`` against autograd through
    ``plain(*inputs)``, each within relative L2 ``TOL``; both timed
    forward + backward."""
    import torch

    def run(f):
        leaves = [t.detach().requires_grad_() for t in inputs]
        out = f(*leaves)
        return (out.detach(), *torch.autograd.grad(out, leaves, cotangent))

    got, want = run(fn), run(plain)
    torch.cuda.synchronize()
    errs = {}
    for name, g, w in zip(("out", *names), got, want):
        require(bool(torch.isfinite(g.float()).all()), f"{label} {name}: non-finite")
        errs[name] = rel_l2(g.float(), w.float())
    worst = max(errs, key=errs.get)
    ms, pms = time_ms(lambda: run(fn), reps=3, rounds=3), \
        time_ms(lambda: run(plain), reps=3, rounds=3)
    ok = errs[worst] <= TOL
    print(f"[module] {label} fwd+bwd: {len(errs)} outputs, worst {worst} "
          f"rel_l2={errs[worst]:.3e} ms={ms:.4f} plain_ms={pms:.4f} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    print("[module]   rel_l2 " + " ".join(f"{k}={v:.2e}" for k, v in errs.items()),
          flush=True)
    require(ok, f"{label}: {worst} rel_l2 {errs[worst]:.3e}")


BLOCK_GRAD_NAMES = ("dx", "norm1_w", "norm1_b", "qkv_w", "qkv_b", "lepe0_w",
                    "lepe0_b", "lepe1_w", "lepe1_b", "proj_w", "proj_b", "norm2_w",
                    "norm2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b")


def compare_module_grads(cfg, dev, B: int) -> None:
    """``CSWinBlockFn`` at stages 1-3 and the two CARAFE sites' ``CarafeFn``:
    forward and backward against autograd through the plain composition."""
    import torch

    from cswin_unet_tpu_torch.ops.cuda import carafe_tail as CT
    from cswin_unet_tpu_torch.ops.cuda.cswin_block import (BlockParams, composed_block,
                                                           fused_cswin_block)

    rng = np.random.default_rng(4)
    bf = torch.bfloat16
    rnd = lambda *s, sc=1.0: torch.from_numpy(
        (rng.standard_normal(s) * sc).astype(np.float32)).to(dev)
    for g in stage_geometries(cfg):
        if g["last"]:
            continue
        H, C = g["H"], g["C"]
        p = block_params(rng, C, False, dev)
        x, gout = rnd(B, H, H, C).to(bf), rnd(B, H, H, C).to(bf)
        dps = tuple(torch.from_numpy((rng.random(B) < 0.8).astype(np.float32) / 0.8)
                    .to(dev) for _ in range(2))
        kw = dict(heads=g["heads"], split=g["split"], last_stage=False,
                  scale=(C // g["heads"]) ** -0.5, dps=dps)
        grads_vs_plain(f"CSWinBlockFn stage{g['stage']} ({B},{H},{H},{C})",
                       lambda xx, *pp: fused_cswin_block(xx, BlockParams(*pp), **kw),
                       lambda xx, *pp: composed_block(xx, BlockParams(*pp), **kw),
                       (x, *p), gout, BLOCK_GRAD_NAMES)
    ed = cfg.MODEL.CSWIN.EMBED_DIM
    carafe_names = ("dx", "down_w", "down_b", "encoder_w", "encoder_b", "out_w",
                    "out_b", "cls_w")
    x28 = rnd(B, 28, 28, 2 * ed).to(bf)
    up = carafe_params(rng, 2 * ed, ed, 2, None, dev)
    grads_vs_plain(f"carafe_up CarafeFn ({B},28,28,{2 * ed})", CT.carafe_up,
                   CT.carafe_up_plain,
                   (x28, *up), rnd(B, 56, 56, ed).to(bf), carafe_names[:-1])
    x56 = rnd(B, 56, 56, ed).to(bf)
    tail = carafe_params(rng, ed, ed, 4, 9, dev)
    grads_vs_plain(f"carafe_tail CarafeFn ({B},56,56,{ed})", CT.carafe_tail,
                   CT.carafe_tail_plain, (x56, *tail), rnd(B, 224, 224, 9).to(bf),
                   carafe_names)


def compare_modules(cfg, dev) -> None:
    """The CSWin block at each stage and the CARAFE sites, kernels vs plain."""
    import torch

    from cswin_unet_tpu_torch.ops.cuda import carafe_tail as CT
    from cswin_unet_tpu_torch.ops.cuda.cswin_block import composed_block, fused_cswin_block

    rng = np.random.default_rng(1)
    bf = torch.bfloat16

    def report(label, fn, plain, check="rel"):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        txt, ok, _ = judge(label, got, want, check)
        ms, pms = time_ms(fn), time_ms(plain)
        print(f"[module] {label}: {txt} ms={ms:.4f} plain_ms={pms:.4f} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        require(ok, f"{label}: {txt}")

    for g in stage_geometries(cfg):
        H, C = g["H"], g["C"]
        p = block_params(rng, C, g["last"], dev)
        x = torch.from_numpy(rng.standard_normal((B, H, H, C)).astype(np.float32)).to(dev, bf)
        kw = dict(heads=g["heads"], split=g["split"], last_stage=g["last"],
                  scale=(C // g["heads"]) ** -0.5)
        report(f"block stage{g['stage']} ({B},{H},{H},{C})",
               lambda: fused_cswin_block(x, p, **kw), lambda: composed_block(x, p, **kw))
    ed = cfg.MODEL.CSWIN.EMBED_DIM
    x28 = torch.from_numpy(rng.standard_normal((B, 28, 28, 2 * ed)).astype(np.float32)).to(dev, bf)
    up = carafe_params(rng, 2 * ed, ed, 2, None, dev)
    report(f"carafe_up ({B},28,28,{2 * ed})", lambda: CT.carafe_up(x28, *up),
           lambda: CT.carafe_up_plain(x28, *up))
    x56 = torch.from_numpy(rng.standard_normal((B, 56, 56, ed)).astype(np.float32)).to(dev, bf)
    tail = carafe_params(rng, ed, ed, 4, 9, dev)
    report(f"carafe_tail logits ({B},56,56,{ed})", lambda: CT.carafe_tail(x56, *tail),
           lambda: CT.carafe_tail_plain(x56, *tail))
    report(f"carafe_tail argmax ({B},56,56,{ed})", lambda: CT.carafe_tail_argmax(x56, *tail),
           lambda: CT.carafe_tail_plain(x56, *tail).float(), check="labels")


# ---------------------------------------------------------------------------
# phase 4: serve three volumes
# ---------------------------------------------------------------------------

def expected_launches(cfg, forwards: int) -> dict[str, int]:
    """Kernel launches per the routing: every block runs 2 layernorms, 4
    GEMMs and one attention launch per branch; each fused CARAFE site
    (upsamplers at stage resolution >= 28, and the tail) one GEMM and one
    CARAFE launch; no backward kernel runs."""
    blocks = dual = 0
    for g in stage_geometries(cfg):
        blocks += 2 * g["depth"]
        dual += 0 if g["last"] else 2 * g["depth"]
    attention = blocks + dual
    img = cfg.DATA.IMG_SIZE
    carafe_sites = 1 + sum(1 for s in (1, 2, 3) if img // (4 * 2**s) >= 28)
    per = dict(layernorm=2 * blocks, gemm=4 * blocks + carafe_sites,
               stripe_attention=attention, carafe_reassemble=carafe_sites)
    return {k: per.get(k, 0) * forwards for k in SOURCES}


def serve_volumes(cfg, dev, workdir: str) -> dict[str, int]:
    import torch

    from cswin_unet_tpu_torch.models import build_model
    from cswin_unet_tpu_torch.ops.cuda import kernels as K
    from cswin_unet_tpu_torch.serve import ServeStats, VolumeServer
    from cswin_unet_tpu_torch.utils.checkpoint import (load_checkpoint, load_into,
                                                       save_checkpoint)

    nc, batch = 9, 32
    ck = save_checkpoint(os.path.join(workdir, "tiny224_seed0.npz"),
                         build_model(cfg, num_classes=nc, device="cpu",
                                     seed=0).cswin_unet.state_dict())
    print(f"[serve] checkpoint {os.path.basename(ck)} "
          f"{os.path.getsize(ck) / 2**20:.1f} MiB", flush=True)

    def from_checkpoint(impl):
        model = build_model(cfg, num_classes=nc, device=dev, impl=impl, seed=1)
        flat, _ = load_checkpoint(ck)
        n = load_into(model.cswin_unet, flat)
        require(n == len(model.cswin_unet.state_dict()), f"loaded {n} tensors")
        return model

    server = VolumeServer(from_checkpoint("fused"), device=dev, img_size=224,
                          batch_slices=batch)
    print(f"[serve] warmup_s={server.warmup():.3f}", flush=True)

    rng = np.random.default_rng(2)
    vols = [("ct40_512.npy", (40, 512, 512)), ("ct33.npz", (33, 224, 224)),
            ("ct64.npy", (64, 224, 224))]
    paths = []
    for name, shape in vols:
        vol = rng.standard_normal(shape).astype(np.float32)
        path = os.path.join(workdir, name)
        if name.endswith(".npz"):
            np.savez(path, image=vol)
        else:
            np.save(path, vol)
        paths.append((path, shape))

    out_dir = os.path.join(workdir, "served")
    stats = ServeStats()
    K.reset_launch_counts()
    torch.cuda.synchronize()
    served = [server.process_file(p, out_dir) for p, _ in paths]
    torch.cuda.synchronize()
    counts = K.launch_counts()

    for st in served:
        print(json.dumps(st), flush=True)
        stats.record(st)
    print(json.dumps({"summary": stats.summary()}), flush=True)
    forwards = sum(-(-shape[0] // batch) for _, shape in vols)
    want = expected_launches(cfg, forwards)
    print(f"[serve] launches {counts} expected {want} ({forwards} forwards)",
          flush=True)
    require(counts == want, f"launch counts {counts} != routing {want}")

    labels = {}
    for st, (path, shape) in zip(served, paths):
        require(os.path.exists(st["output"]), f"missing {st['output']}")
        lab = read_nifti(st["output"], shape)
        require(bool(np.all((lab >= 0) & (lab < nc) & (lab == np.round(lab)))),
                f"{st['case']}: labels outside [0, {nc})")
        labels[st["case"]] = lab
    print(f"[serve] {len(served)} volumes, NIfTI written, labels in [0, {nc})",
          flush=True)

    # One served chunk (ct64, slices 0..31, no zoom) against the plain path.
    vol = np.load(paths[2][0])[:batch]
    plain = from_checkpoint("plain")
    with torch.inference_mode():
        x = torch.from_numpy(vol[..., None]).to(dev)
        ref = plain(x)
        fused_logits = server.inferencer.model(x)
    require(bool(torch.isfinite(ref).all() and torch.isfinite(fused_logits).all()),
            "non-finite logits")
    served_lab = torch.from_numpy(labels["ct64"][:batch].astype(np.int32)).to(dev)
    raw, above = margin_mismatches(served_lab, ref)
    print(f"[serve] chunk ct64[0:{batch}] vs plain path: mismatches={raw}/"
          f"{served_lab.numel()} above_margin={above} logits_rel_l2="
          f"{rel_l2(fused_logits, ref):.3e}", flush=True)
    require(above == 0, f"{above} label mismatches above the margin")

    def forward(model):
        with torch.inference_mode():
            return model(x, emit="labels")

    fused_ms = time_ms(lambda: forward(server.inferencer.model), reps=5, rounds=3)
    plain_ms = time_ms(lambda: forward(plain), reps=2, rounds=3)
    print(f"[e2e] forward {batch} slices to labels: fused_ms={fused_ms:.3f} "
          f"({batch / fused_ms * 1e3:.1f} slices/s) plain_ms={plain_ms:.3f} "
          f"({batch / plain_ms * 1e3:.1f} slices/s)", flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 6: train
# ---------------------------------------------------------------------------

def expected_train_launches(cfg, steps: int) -> dict[str, int]:
    """Kernel launches of ``steps`` train steps per the training routing:
    only the dual-branch blocks at resolution >= FUSE_TRAIN_MIN_RESO run
    the kernel chain (2 LN, 4 GEMM, 2 attention forward; 2 LN backward, 4
    dX products, 4 weight gradients, 2 attention backward); the fused
    CARAFE sites (upsamplers at resolution >= 28, and the tail) run one GEMM
    and one CARAFE launch forward and the composition's vjp backward."""
    from cswin_unet_tpu_torch.models.cswin_unet import FUSE_TRAIN_MIN_RESO

    routed = sum(2 * g["depth"] for g in stage_geometries(cfg)
                 if not g["last"] and g["H"] >= FUSE_TRAIN_MIN_RESO)
    img = cfg.DATA.IMG_SIZE
    carafe_sites = 1 + sum(1 for s in (1, 2, 3) if img // (4 * 2**s) >= 28)
    per = dict(layernorm=2 * routed, gemm=4 * routed + carafe_sites,
               stripe_attention=2 * routed, carafe_reassemble=carafe_sites,
               layernorm_bwd=2 * routed, gemm_dgrad=4 * routed,
               gemm_wgrad=4 * routed, stripe_attention_bwd=2 * routed)
    return {k: v * steps for k, v in per.items()}


def write_train_slices(root: str, n: int, size: int, nc: int, seed: int) -> str:
    """``n`` synthetic CT-like slices with blob labels 0..nc-1 as
    ``train_npz/<case>.npz`` (image, label) plus ``lists/train.txt``;
    numpy only. Returns the list directory."""
    rng = np.random.default_rng(seed)
    train_dir, list_dir = os.path.join(root, "train_npz"), os.path.join(root, "lists")
    os.makedirs(train_dir, exist_ok=True)
    os.makedirs(list_dir, exist_ok=True)
    yy, xx = np.mgrid[0:size, 0:size]
    names = []
    for case in range(2):
        blobs = [((yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2, cls)
                 for cls, (cy, cx, r) in enumerate(
                     zip(*(rng.uniform(0.2, 0.8, (2, nc)) * size),
                         rng.uniform(0.06, 0.16, nc) * size)) if cls > 0]
        for z in range(n // 2):
            image = rng.normal(0.2, 0.1, (size, size)).astype(np.float32)
            label = np.zeros((size, size), np.uint8)
            for blob, cls in blobs:
                if rng.random() < 0.7:
                    label[blob] = cls
                    image[blob] += 0.3 + 0.1 * cls
            name = f"case{case:04d}_slice{z:03d}"
            np.savez(os.path.join(train_dir, name + ".npz"), image=image, label=label)
            names.append(name)
    with open(os.path.join(list_dir, "train.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return list_dir


def train_run(cfg, dev, workdir: str) -> tuple[dict[str, int], str]:
    """The port's trainer_synapse for 2 epochs (4 steps at bs 24) on
    synthetic slices; checks launch counts, log lines and the checkpoint,
    then serves one volume from ``epoch_1.npz``."""
    import argparse
    import re

    import torch

    from cswin_unet_tpu_torch.models import build_model
    from cswin_unet_tpu_torch.ops.cuda import kernels as K
    from cswin_unet_tpu_torch.serve import VolumeServer
    from cswin_unet_tpu_torch.train import trainer_synapse
    from cswin_unet_tpu_torch.utils.checkpoint import load_checkpoint, load_into

    nc, slices, epochs = 9, 48, 2
    data = os.path.join(workdir, "synapse")
    t0 = time.perf_counter()
    list_dir = write_train_slices(data, slices, 512, nc, seed=5)
    print(f"[train] wrote {slices} slices 512x512 in {time.perf_counter() - t0:.1f}s",
          flush=True)
    out_dir = os.path.join(workdir, "run")
    args = argparse.Namespace(
        root_path=os.path.join(data, "train_npz"), list_dir=list_dir, num_classes=nc,
        batch_size=TRAIN_BATCH, n_gpu=1, max_epochs=epochs, base_lr=0.01,
        img_size=224, seed=1234, num_workers=8, device=str(dev), output_dir=out_dir)
    model = build_model(cfg, num_classes=nc, device=dev, seed=0, train=True)
    require(model.training and cfg.MODEL.DROP_PATH_RATE > 0, "drop-path not live")
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    require(trainer_synapse(args, model, out_dir) == "Training Finished!", "trainer")
    torch.cuda.synchronize()
    counts = K.launch_counts()
    steps = epochs * (slices // TRAIN_BATCH)
    want = expected_train_launches(cfg, steps)
    print(f"[train] {steps} steps in {time.perf_counter() - t0:.1f}s; launches "
          f"{counts} expected {want}", flush=True)
    require(counts == want, f"train launch counts {counts} != routing {want}")

    with open(os.path.join(out_dir, "log.txt")) as f:
        log = f.read()
    its = re.findall(r"iteration (\d+) : loss : (\S+), loss_ce: (\S+)", log)
    require([int(i) for i, _, _ in its] == list(range(1, steps + 1)),
            f"log lines {its}")
    require(all(np.isfinite(float(a)) and np.isfinite(float(b)) for _, a, b in its),
            "non-finite loss in the log")
    ck = os.path.join(out_dir, f"epoch_{epochs - 1}.npz")
    require(os.path.exists(ck) and f"save model to {ck}" in log, f"missing {ck}")
    print(f"[train] log: {len(its)} lines 'iteration N : loss : L, loss_ce: C', "
          f"losses {[float(a) for _, a, _ in its]}; {os.path.basename(ck)} "
          f"{os.path.getsize(ck) / 2**20:.1f} MiB", flush=True)

    served = build_model(cfg, num_classes=nc, device=dev, seed=1)
    flat, _ = load_checkpoint(ck)
    require(load_into(served.cswin_unet, flat) == len(served.cswin_unet.state_dict()),
            "checkpoint does not load into the server's model")
    vol = np.random.default_rng(6).standard_normal((8, 224, 224)).astype(np.float32)
    path = os.path.join(workdir, "trained_vol.npy")
    np.save(path, vol)
    st = VolumeServer(served, device=dev, img_size=224,
                      batch_slices=SERVE_BATCH).process_file(path, out_dir)
    lab = read_nifti(st["output"], vol.shape)
    require(bool(np.all((lab >= 0) & (lab < nc))), "served labels out of range")
    print(f"[train] {os.path.basename(ck)} served {st['case']}: {json.dumps(st)}",
          flush=True)
    return counts, data


def train_step_checks(cfg, dev, data: str) -> None:
    """On one fixed batch of 24 slices: loss and gradients of the kernel
    route against the plain route, one step's launch counts, 10 steps with
    falling loss, and the train-step time of both routes."""
    import torch

    from cswin_unet_tpu_torch.data import EvalResize, SynapseDataset
    from cswin_unet_tpu_torch.losses import segmentation_loss
    from cswin_unet_tpu_torch.models import build_model
    from cswin_unet_tpu_torch.ops.cuda import kernels as K
    from cswin_unet_tpu_torch.train import make_optimizer, make_train_step

    nc = 9
    ds = SynapseDataset(os.path.join(data, "train_npz"), os.path.join(data, "lists"),
                        "train", transform=EvalResize([224, 224]))
    samples = [ds[i] for i in range(TRAIN_BATCH)]
    img = torch.from_numpy(np.stack([s["image"] for s in samples])).to(dev)
    lab = torch.from_numpy(np.stack([s["label"] for s in samples])).to(dev)

    def grads(impl, dtype):
        model = build_model(cfg, num_classes=nc, device=dev, impl=impl, dtype=dtype,
                            seed=3, train=True)
        gen = torch.Generator(device=dev).manual_seed(11)
        loss, _ = segmentation_loss(model(img, generator=gen), lab, nc)
        names, params = zip(*model.named_parameters())
        return loss.detach(), dict(zip(names, torch.autograd.grad(loss, params)))

    loss_k, g_k = grads("fused", torch.bfloat16)
    loss_p, g_p = grads("plain", torch.bfloat16)
    loss_f, g_f = grads("plain", torch.float32)
    torch.cuda.synchronize()
    loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    errs = {k: rel_l2(g_k[k], g_p[k]) for k in g_p}
    floor = {k: rel_l2(g_p[k], g_f[k]) for k in g_p}  # plain bf16 vs plain f32
    # Every gradient is held to TOL. Only a bias gradient (a cancellation-
    # dominated sum) whose plain bf16 route is itself that far from float32
    # gets a wider bound: twice the plain route's own bf16 error
    # (bench.py:382-388), printed beside that measurement.
    bound = {k: max(TOL, 2 * floor[k]) if k.endswith(".bias") else TOL for k in g_p}
    widened = {k: f"bound {bound[k]:.3e} (bf16-vs-f32 {floor[k]:.3e})"
               for k in bound if bound[k] > TOL}
    worst = max(errs, key=errs.get)
    over = {k: (f"{errs[k]:.3e}", f"bf16-vs-f32 {floor[k]:.3e}")
            for k in errs if errs[k] > TOL}
    bad = [k for k in errs if errs[k] > bound[k] or not np.isfinite(errs[k])]
    print(f"[train] grad parity, fixed batch of {TRAIN_BATCH}: loss kernel "
          f"{float(loss_k):.6f} plain {float(loss_p):.6f} f32 {float(loss_f):.6f} "
          f"(rel {loss_err:.2e}); {len(errs)} gradients, worst {worst} rel_l2="
          f"{errs[worst]:.3e} (plain bf16 vs f32 there {floor[worst]:.3e}); "
          f"above {TOL}: {over or 'none'}; widened bias bounds: "
          f"{widened or 'none'}", flush=True)
    require(loss_err <= TOL and not bad, f"gradient parity: loss {loss_err:.3e}, "
            f"beyond bound {[(k, errs[k], bound[k]) for k in bad]}")

    def trainer(impl):
        model = build_model(cfg, num_classes=nc, device=dev, impl=impl, seed=3,
                            train=True)
        opt, sched = make_optimizer(model.parameters(), 0.01, 1000)
        gen = torch.Generator(device=dev).manual_seed(12)
        step = make_train_step(model, opt, sched, nc)
        return lambda: step(img, lab, gen)

    step_k = trainer("fused")
    K.reset_launch_counts()
    torch.cuda.synchronize()
    losses = [float(step_k()["loss"])]
    torch.cuda.synchronize()
    counts, want = K.launch_counts(), expected_train_launches(cfg, 1)
    print(f"[train] one step's launches {counts} expected {want}", flush=True)
    require(counts == want, f"one step: launches {counts} != routing {want}")
    losses += [float(step_k()["loss"]) for _ in range(9)]
    print(f"[train] 10 steps on one batch: loss {losses[0]:.5f} -> {losses[-1]:.5f} "
          f"({' '.join(f'{v:.4f}' for v in losses)})", flush=True)
    require(all(np.isfinite(losses)) and losses[-1] < losses[0], "loss did not fall")

    # In turns (kernel, plain, plain, kernel): the step is host-bound, and
    # the host's load drifts within a run.
    step_p = trainer("plain")
    k1, p1, p2, k2 = (time_ms(fn, reps=4, rounds=3)
                      for fn in (step_k, step_p, step_p, step_k))
    k_ms, p_ms = min(k1, k2), min(p1, p2)
    print(f"[e2e] train step bs {TRAIN_BATCH} (fwd + bwd + SGD): kernel_ms={k_ms:.3f} "
          f"({TRAIN_BATCH / k_ms * 1e3:.1f} samples/s) plain_ms={p_ms:.3f} "
          f"({TRAIN_BATCH / p_ms * 1e3:.1f} samples/s); in turns kernel {k1:.3f}, "
          f"plain {p1:.3f}, plain {p2:.3f}, kernel {k2:.3f}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "cswin_unet_tpu_torch")):
        print("chip_smoke: the cswin_unet_tpu_torch package is not next to this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 is the oracle
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}",
          flush=True)
    print(smi, flush=True)

    from cswin_unet_tpu_torch.config import get_config
    from cswin_unet_tpu_torch.ops.cuda import build

    class _Args:
        cfg, opts = CFG, None

    cfg = get_config(_Args)
    t0 = time.perf_counter()
    build.library()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.1f}s "
          f"(nvcc {build.build_seconds if build.build_seconds is not None else 'cached'})",
          flush=True)
    for line in build.build_log.splitlines():  # ptxas -v: registers, spills
        if any(w in line for w in ("Compiling entry", "Used", "spill")):
            print(f"[build] {line.strip()}", flush=True)

    tally = compare_kernels(cfg, dev, SERVE_BATCH)
    compare_backward_kernels(cfg, dev, TRAIN_BATCH, tally)
    compare_modules(cfg, dev)
    compare_module_grads(cfg, dev, TRAIN_BATCH)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        counts = serve_volumes(cfg, dev, workdir)
        train_counts, data = train_run(cfg, dev, workdir)
        train_step_checks(cfg, dev, data)

    kernels = [dict(name=k, route="cuda", source=src, replaces=rep,
                    launches=counts[k] + train_counts[k],
                    launches_by_path=dict(serve=counts[k], train=train_counts[k]),
                    per="train step" if k in TRAIN_KERNELS else "serving forward",
                    **tally.rows[k])
               for k, (src, rep) in SOURCES.items()]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
