#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cswin_unet_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the process then exits non-zero):

  1. torch / CUDA versions and the card's name and power limit.
  2. Build the hand-written CUDA kernels from ``csrc/`` with nvcc; ``ptxas``
     must report no spills for ``block_pair`` (registers and spills are
     printed for ``block_one``, both LayerNorm kernels, CARAFE and
     ``edt_pass`` too), and the
     SASS of the attention and GEMM kernels, of the block backward's
     weight-gradient and attention kernels and of the CARAFE kernel
     (``cuobjdump -sass``) must hold tensor-core instructions (``HMMA`` /
     ``HGMMA``).
  3. Hold every kernel against its plain PyTorch version on the card, on
     bf16 inputs from a seeded numpy generator at the tiny-224 shapes: each
     kernel at every shape one 32-slice serving forward gives it, then at
     B = 8 the CSWin block at the four stage geometries, ``carafe_up`` @28
     and the tail (logits and labels) @56 (the CARAFE kernel on ``gy`` with
     the GEMM's padded channels, as the main path gives it), and the tail at
     the continual heads' 12 and 14 classes (logits and labels, B = 12 and
     32; checked and timed, outside the serving unit's sums). Tolerance:
     relative L2 error <= 0.02 (the reference gate's bf16 default); labels
     by the margin rule (a mismatch counts only where the plain top-2 logit
     gap exceeds 0.02·max|logit|). Times are CUDA-event medians of back-to-back runs.
     The backward kernels likewise at the four stage geometries, B = 24
     (the train batch), each weighted by its calls in a step (every block
     trains through ``CSWinBlockFn``): ``layernorm_bwd``,
     ``gemm_dgrad`` (with its GELU
     backward and drop-path operand scale), ``gemm_wgrad``,
     ``stripe_attention_bwd`` (its shared memory held to the wrapper's
     count at tiny-224's and base-384's windows; its yardstick aten's
     flash-attention backward on the same windows, attention only, no
     LePE), and the
     forward GEMM's training epilogues (drop-path residual, GELU keeping
     its pre-activation); and, outside the step's sums, the GEMMs' dropout
     instances at rate 0.1 (the fc1 GELU and fc2 residual epilogues, the
     fc2 dX product with both masks, its weight gradient), at base-384's
     shapes too (phase 10). The ``pallas``
     route's ``cswin_attention`` at every branch geometry (B = 32, q, k, v
     as channel slices of one qkv tensor) against the Pallas rounding's
     plain version, and ``edt_pass`` along each axis of a (48, 512, 512)
     volume, in ``edt_sq``'s order, bit for bit (max abs error 0; the O(L)
     pass's bound is its bytes, ``EDT_OPS``).
     ``block_pair`` (two blocks in one cooperative launch) at each pairable
     stage (2 and 3), B = 32, against ``block_pair_plain`` and against two
     single block chains, which it must equal bit for bit; ``ptxas`` must
     report no spills for it. ``tools/probe_chain.py``'s tensors (the chain,
     its training backward, the ``pallas`` route's kernel, the pair, the
     three CARAFE sites) equal the digests of the parent commit's build
     (``probe_reference.json``).
     Each kernel's line in the JSON also carries ``bound_ms`` (the larger
     of bytes over 3.35 TB/s and operations over the peak of their type)
     and ``library_ms`` (one PyTorch call computing the same function,
     where there is one; timed here only).
     The ``[pair]`` A/B: two block chains against one ``block_pair`` at
     stages 2 and 3, B = 32 and 128, CUDA events around back-to-back calls
     in interleaved rounds of both orders (medians and min-max spread) and
     device-busy time from ``torch.profiler`` where its record count of the
     port's kernels matches the launch counters (else ``busy unread``); a
     stage pays where the pair
     wins at B = 32 by more than the spread in both orders, which is
     printed beside ``cswin_block.PAIR_GEOMETRIES``.
  4. Modules: ``CSWinBlockFn`` forward and backward at stages 1-4 (the
     last stage's one full-window branch; B = 24, the same drop-path
     multipliers), the two CARAFE Functions and
     ``CSWinAttentionFn`` at the four branch geometries, each output and
     gradient against torch autograd through the plain composition,
     relative L2 <= 0.02 (the tail's ``CarafeFn`` also at 12 classes, B =
     12). The CARAFE Functions' and ``CSWinAttentionFn``'s
     backward is autograd of a plain composition, so their gradient lines
     check the wiring (argument order, up factor, window); the arithmetic of
     those backwards is held against ``jax.grad`` in
     ``tests/test_torch_carafe_grad.py`` and
     ``tests/test_torch_pallas_attention.py``. ``volume_metrics_device`` on
     (48, 512, 512) organ-like pred / label volumes (classes 1-8 in both,
     one pred-only, one empty) against the host ``metrics`` (scipy):
     Dice and HD95 within rtol 1e-5 and atol 1e-4.
  5. Serve three volumes through ``VolumeServer`` from a seeded random
     tiny-224 checkpoint in the JAX package's ``.npz`` format: (40, 512, 512)
     ``.npy`` (zoom), (33, 224, 224) ``.npz`` (tail bucket), (64, 224, 224)
     ``.npy``. Checks the NIfTI outputs, the label range, each kernel's
     launch count against the routing, and one served chunk's labels against
     the plain path on the card; times the 32-slice forward on both paths.
     The same chunk through the ``pallas`` route (``--opts TPU.ATTN_IMPL
     pallas``): labels by the margin rule, 50 ``cswin_attention`` launches
     and no other kernel's, and its forward time. The same chunk on the
     fused route with pairing forced on at every pairable stage: logits
     equal to the unpaired route's bit for bit, labels by the margin rule,
     launches ``block_pair`` 10 / ``layernorm`` 12 / ``gemm`` 26 /
     ``stripe_attention`` 10 / ``carafe_reassemble`` 2; then the forward
     with pairing off, as committed and forced on, in 6 interleaved rounds
     (medians [min-max]) with device busy from ``torch.profiler``.
     ``[f32]``: serving at ``TPU.COMPUTE_DTYPE float32``. Each float32
     instance (``layernorm``, ``gemm``, ``stripe_attention``,
     ``cswin_attention``, ``carafe_reassemble``, ``block_pair``) at every
     shape a float32 32-slice tiny-224 forward gives it, against its plain
     float32 version within ``F32_TOL`` (1e-5), the tail's labels by the
     margin rule, ``block_pair`` also bit for bit against two float32
     chains at the geometries paired at bf16 and timed by phase (the
     float32 routing pairs none); bounds at 67 TFLOP/s of float32 FFMA, cuBLAS float32 and
     ``F.layer_norm`` as yardsticks. Then ``python -m
     cswin_unet_tpu_torch.serve``'s ``main`` at ``--opts TPU.COMPUTE_DTYPE
     float32`` on a (64, 224, 224) volume, on the fused route and with
     ``TPU.ATTN_IMPL pallas``: every launch a float32 instance's as routed,
     the NIfTI labels by the margin rule and each route's logits within
     ``F32_MODEL_TOL`` (1e-4) of the plain float32 route; one chunk with
     the float32 pair forced on, equal to the committed route bit for bit;
     the float32 forward timed beside the bf16 one and the forced pair;
     ``eval.inference.inference`` of one
     (48, 512, 512) organ-like volume at float32 (launches as routed,
     device metrics equal to the host's); and one base-384 float32
     32-slice forward against its plain float32 route.
  6. Train: 48 synthetic 512x512 ``.npz`` slices with blob labels, the
     port's ``trainer_synapse`` for 2 epochs at bs 24 (4 steps, drop-path
     0.2 live), launch counts against the training routing, the log lines,
     and ``epoch_1.npz`` served by ``VolumeServer``. Then on one fixed batch:
     the loss and every parameter gradient of the kernel route against the
     plain route (same weights, same drop-path draws), one step's launch
     counts, 10 SGD steps whose loss must fall, and the train step's time
     on both routes. ``--resume``: a fresh model continues the 2-epoch run
     from its ``train_state.pt`` for a third epoch (starts at iteration 4,
     logs 5-6, one epoch's launches, its own checkpoint and train state).
     Every block of every training path (here, the continual,
     data-parallel and base-384 ones) trains through ``CSWinBlockFn``, and
     its launches are counted so. Then the ``[route]`` A/B of
     ``tools/train_route.py`` at bs 24 for one round: each route's step ms
     [min-max], device busy and peak memory, and one block's fwd+bwd a
     geometry (times only: one round gives no spread, so no verdict).
     ``[dropout]``: ``--opts MODEL.DROP_RATE 0.1``, the train CLI's ``main``
     for one epoch of 2 steps at bs 24 (launches as routed: the masks ride
     the GEMMs, so no launch more than at rate 0), the kernel route's loss
     and gradients against the plain route with the same generator (TOL, a
     bias twice the plain route's own bf16-vs-float32 error where larger),
     each GEMM's in-kernel mask at stage 1's shapes equal to
     ``ops.dropout.keep_mask``'s bits, and the train step's ms and device
     busy at rate 0.1 beside rate 0 (CUDA events in turns).
  7. Evaluate (48, 512, 512) and (37, 512, 512) organ-like CT volumes from
     ``epoch_1.npz`` through ``eval.inference.inference`` (``test.py``'s
     loop, an in-memory dataset): with device metrics (``edt_pass``
     launches as routed, only the metric array copied back) and with host
     metrics, per-class Dice and HD95 agreeing within rtol 1e-5 and atol
     1e-4, the reference log lines, seconds per volume for segmenting and
     for each metrics route, and the fused and plain routes' per-class
     scores side by side (printed, not gated: the weights are barely
     trained).
  8. Continual learning at tiny-224 width and depth: ``python -m
     cswin_unet_tpu_torch.universal_train``'s ``main`` for stage 1 (9 -> 12
     classes from the serve phase's seeded checkpoint, 48 KiTS-like 512x512
     slices from ``make_synthetic_dataset``, bs 12, 2 epochs, 2 surgical
     batches and 4 TPGM iterations an epoch) and stage 2 (12 -> 14 from
     stage 1's final checkpoint, 24 LiTS-like slices, 1 epoch), then
     ``universal_test``'s ``main`` of the stage-2 checkpoint on a (48, 512,
     512) KiTS-like volume with and without device metrics (Dice and HD95
     agreeing within rtol 1e-5 and atol 1e-4): the path's launches against
     both routings (each student pass with gradients as training, each
     forward without as serving, stage 3 paired), the JAX package's log
     lines and checkpoint names. Then on one fixed batch the kernel route
     against the plain route: the continual loss and every gradient (TOL,
     or twice the plain route's own bf16-vs-float32 error where larger),
     one TPGM step's constraint gradients and the RGN weights (relative L2
     <= 0.02), and the launches (CARAFE by class count: 9 and 12 in a
     step) and seconds of one continual step, one TPGM step and one
     surgical grad pass. ``[finetune]``: the legacy grid's CLI (``python -m
     cswin_unet_tpu_torch.finetune``'s ``main``) for one (lr, wd) cell and
     one epoch on 120 synthetic 224x224 slices from the serve phase's
     checkpoint (its launches, log and checkpoint), then on one fixed batch
     the RGN group weights and the RGN-weighted gradients of its loss, kernel
     route against plain route. ``[blur]``: ``python -m
     cswin_unet_tpu_torch.tools.apply_blur train``'s ``main`` with the blur
     on the card, each image within 1e-5 of scipy. ``[f32:train]``:
     training at ``TPU.COMPUTE_DTYPE float32``. Each float32 backward
     instance (``layernorm_bwd``, ``gemm_dgrad``, ``gemm_wgrad``,
     ``stripe_attention_bwd``) at tiny-224's four training geometries, B =
     24, against its plain float32 version within ``F32_TOL`` (a float32
     sum over M that misses it passes at most twice the plain version's
     error against float64), weighted by its calls in a step, behind the
     spin kernel, with cuBLAS float32 (TF32 off) and aten's LN backward as
     yardsticks, and the forward GEMM's float32 training epilogues (fc1
     keeping its pre-activation, proj and fc2 with drop-path) at the same
     geometries, against ``gemm_plain``; one float32 conv's weight gradient against float64 with
     cuDNN's TF32 flag at its default (the stock ``F.conv2d`` and the
     port's ``ops.precision.conv2d``); ``python -m
     cswin_unet_tpu_torch.train``'s ``main`` at ``--opts TPU.COMPUTE_DTYPE
     float32`` for one epoch of 2 steps at bs 24 (every launch a float32
     instance's as routed, no plain version called); the kernel route's
     loss and gradients against the plain float32 route on one fixed batch
     (loss within ``F32_TOL``, each gradient within ``F32_MODEL_TOL``);
     ``finetune.main`` for one step and ``universal_train.main`` for one
     stage-1 epoch at float32 (every launch a float32 instance's); one
     base-384 float32 step at B = 2 and its stage-3 attention backward
     (288-token windows) against its plain version; the bs-24 step at float32 beside bf16 and the plain
     float32 route, CUDA events in turns, device busy.
  9. Data parallel at tiny-224 width and depth, lines tagged ``[ddp]``:
     two gloo ranks share the one card (spawned processes, a free port,
     every rank on local device 0; NCCL refuses two ranks on one GPU)
     through ``trainer_synapse`` for one epoch of 3 global batches of 24
     (12 a rank, drop-path 0.2, dropout 0.1 and ``--device_augment`` live:
     every step of the phase runs at ``MODEL.DROP_RATE`` 0.1): each rank's
     launches against the routing, both ranks' weights equal, and each
     parameter's update θ3 − θ0 and the logged losses against one process
     run on the ranks' concatenated batches with the same seed (relative L2
     <= TOL); on the same two ranks one continual step's student gradients,
     one TPGM pass's constraint gradients and the RGN weights against one
     process at bs 12, on the plain route in float32 (all TOL: the split
     free of bf16 rounding) and on the kernel route in bf16 (TOL; a student
     gradient may take twice the plain route's own bf16-vs-float32 error
     where that is larger, phase 8's rule for the continual loss); the seconds of a step on each rank beside the
     one-process step (two processes on one card, not a multi-GPU figure);
     DDP's own cost: a bs-24 step with and without the DDP wrapper in one
     process under NCCL at world size 1, in turns (seconds, device busy,
     the kernels with the most device time); ``python -m
     torch.distributed.run --nproc_per_node 1 -m cswin_unet_tpu_torch.train``
     for one epoch (log lines, ``epoch_0.npz``, ``train_state.pt``);
     ``VolumeInferencer(devices=[cuda:0, cuda:0])`` on one 32-slice chunk
     (labels equal to one device's, bit for bit or by the margin rule
     against the plain route; launches doubled; its seconds beside the
     whole chunk's, in turns); the native HD95
     (``utils.native``, ``native/edt.cpp`` built with g++) against scipy on
     a (48, 512, 512) KiTS-like organ volume (3 organs) within 1e-9, both
     routes' seconds; and
     ``utils.profiling.device_trace`` of one step (a Chrome trace holding
     the port's kernels). The phase prints its seconds.
 10. base-384 (``configs/cswin_base_384.yaml``: embed 96, depths 2/4/32/2,
     heads 4/8/16/32, split 1/2/12/12, head dim 24, drop-path 0.5) at full
     width and depth, 9 classes, its lines tagged ``[base384:...]``: every
     kernel at every shape a 32-slice forward gives it (stage resolutions
     96/48/24/12, windows of 96, 96, 288 and 144 tokens; ``upsample2`` 48 ->
     96 and the x4 tail at 96 as the fused CARAFE sites) and the backward
     kernels at B = 24, each against its plain version as in phase 3, in a
     tally of their own; ``CSWinBlockFn`` at the stages that train through
     it and ``CarafeFn`` at both sites, B = 24, every output
     and gradient within TOL; ``ops.augment`` on the card bit for
     bit against the CPU at fixed draws, and the branch shares of a CUDA
     generator's draws; ``gaussian_blur_2d`` of a (48, 512, 512) volume at σ
     1.5 within 1e-5 of scipy. Then the paths through their entry points: a
     seeded checkpoint in the JAX ``.npz`` format served by ``VolumeServer``
     ((40, 512, 512) to NIfTI, launches as routed, the first chunk against
     the plain route by the margin rule, the 32-slice forward of both routes
     in interleaved rounds with device busy and its bf16 bound); ``python -m
     cswin_unet_tpu_torch.train``'s ``main`` at bs 24 with
     ``--device_augment`` for one epoch over 48 synthetic 512x512 slices (2
     steps: launches, finite losses, peak memory), one step's launches and
     seconds, and gradient parity against the plain route on
     ``PARITY384_BATCH`` slices; the ``[route]`` A/B at base-384 (as in
     phase 6); ``epoch_0.npz`` evaluated at patch 384 on a
     (48, 512, 512) organ-like volume (seconds by part, device metrics equal
     to the host's, ``inference()``'s means equal to them, launches of both
     passes).
 11. The block lab (``cswin_unet_tpu_torch/tools/block_lab.py``), the parts
     of the block as stand-alone kernels: ``lepe_windows``,
     ``window_attention``, ``ln_mlp`` and ``block_one`` against their plain
     versions on the lab's own cases at full shapes, B = 128 (LePE at the
     three branch geometries with the tap grid as given and transposed, V
     in place from packed qkv, two tap sets, two sources stacked on channels with the fold; attention on
     rows and columns of (128, 56, 56, 32) and on (512, 98, 128) with 4
     heads, in each mode; the MLP half on (128, 56, 56, 64) in each mode),
     relative L2 <= 0.02, each with its bound and, as yardsticks timed here
     only, ``F.conv2d`` (groups = c) and ``F.scaled_dot_product_attention``;
     for ``ln_mlp`` the block chain's three launches (``chain_ms``). These
     cases are timed as the lab times its own, behind a spin kernel that
     keeps the card busy while the host queues the calls. Two
     identities tie the parts to the whole at stages 1-3 on one packed qkv:
     ``window_attention`` + ``lepe_windows`` within 2 bf16 ulps of
     ``stripe_attention``, and ``ln_mlp`` within relative L2 5e-3 of
     ``layernorm`` -> ``gemm`` (GELU) -> ``gemm`` (residual). ``block_one``
     (the whole block in one cooperative launch) with every part on at
     stages 1-4, B = 128, against its plain version, timed beside the block
     chain on the same inputs (``chain_ms``), and equal to the chain bit for
     bit at stages 1-3 and at the last stage's single branch; with weights
     at 0.3 (where the residual does not hide the parts), every ``ablate``
     variant at stages 1-4 and every ``cum`` level at stage 1 within
     relative L2 0.02 of its plain version, each variant moving the output
     from ``full`` and each level from the one before by more than that
     (the last stage's ``no-transpose`` is ``full``, bit for bit). Then
     ``block_lab.main`` once per subcommand at B = 128, its output shown
     (``ablate``: eight variants at stages 1-4 with their deltas against
     ``full``; ``cum``: eight levels at stage 1 with their deltas), with the
     launches of every kernel exactly as its cases imply.
 12. The whole run's seconds, the card's name and power limit, one JSON line
     with the per-kernel results (launches by path, base-384's among them;
     each kernel that base-384's paths run also with its ms, plain_ms,
     bound_ms and library_ms at base-384's shapes under ``base384``), then
     the contract line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package (``cswin_unet_tpu``); the config
is the port's own YAML. Exits non-zero without a result when no CUDA device
is available or when the package is not next to this file.
"""

from __future__ import annotations

import gc
import gzip
import json
import logging
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(ROOT, "cswin_unet_tpu_torch", "configs", "cswin_tiny_224_lite.yaml")
CFG384 = os.path.join(ROOT, "cswin_unet_tpu_torch", "configs", "cswin_base_384.yaml")
B = 8            # batch of the module comparisons
SERVE_BATCH = 32  # slices per forward chunk when serving (--batch_slices)
TRAIN_BATCH = 24  # the reference recipe's batch
CONTINUAL_BATCH = 12  # universal_train's default batch
CONTINUAL_CLASSES = (12, 14)  # the continual heads: Synapse + KiTS23, + LiTS17
PARITY384_BATCH = 8  # base-384's gradient parity: three models' gradients side by side
TOL = 0.02
DROP_RATE = 0.1  # MODEL.DROP_RATE of the [dropout] phase and of [ddp]
DROP_OPTS = ["MODEL.DROP_RATE", str(DROP_RATE)]
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
    "cswin_attention": ("cswin_unet_tpu_torch/ops/cuda/csrc/stripe_attention.cu",
                        "cswin_unet_tpu/ops/pallas/cswin_attention.py:169"),
    "edt_pass": ("cswin_unet_tpu_torch/ops/cuda/csrc/edt.cu",
                 "cswin_unet_tpu/ops/edt.py:73"),
    "block_pair": ("cswin_unet_tpu_torch/ops/cuda/csrc/block_pair.cu",
                   "cswin_unet_tpu/ops/pallas/cswin_block.py:1957"),
    "lepe_windows": ("cswin_unet_tpu_torch/ops/cuda/csrc/lepe_windows.cu",
                     "scripts/exp_lepe_mm.py:56"),
    "window_attention": ("cswin_unet_tpu_torch/ops/cuda/csrc/stripe_attention.cu",
                         "scripts/exp_attn3.py:59"),
    "ln_mlp": ("cswin_unet_tpu_torch/ops/cuda/csrc/ln_mlp.cu", "scripts/exp_pack.py:60"),
    "block_one": ("cswin_unet_tpu_torch/ops/cuda/csrc/block_one.cu",
                  "scripts/ablate_block.py:181; scripts/exp_cum.py:137"),
}
# The float32 instances (TPU.COMPUTE_DTYPE float32) of the serving and
# training paths, by the wrapper that launches them: the same sources and
# TPU kernels.
F32_OF = {f"{k}_f32": k for k in ("layernorm", "gemm", "stripe_attention",
                                  "cswin_attention", "carafe_reassemble", "block_pair",
                                  "layernorm_bwd", "gemm_dgrad", "gemm_wgrad",
                                  "stripe_attention_bwd")}
SOURCES.update({k: SOURCES[w] for k, w in F32_OF.items()})
for k in ("gemm_f32", "gemm_dgrad_f32", "gemm_wgrad_f32"):  # their own source since PR 19
    SOURCES[k] = ("cswin_unet_tpu_torch/ops/cuda/csrc/gemm_f32.cu", SOURCES[k][1])
SOURCES["block_pair_f32"] = ("cswin_unet_tpu_torch/ops/cuda/csrc/block_pair_f32.cu",
                             SOURCES["block_pair"][1])
F32_OPTS = ["TPU.COMPUTE_DTYPE", "float32"]
F32_TOL = 1e-5        # a float32 instance against its plain float32 version
F32_MODEL_TOL = 1e-4  # the float32 model's logits against the plain float32 route
LAB_BATCH = 128   # the TPU experiments' batch
LAB_REPS = 10  # as block_lab.REPS, so that both readings of a case use one method
# What each kernel's ms, plain_ms, bound_ms and library_ms add up over.
PER = dict.fromkeys(("layernorm", "gemm", "stripe_attention", "carafe_reassemble"),
                    "32-slice serving forward, fused route")
PER.update(dict.fromkeys(("layernorm_bwd", "gemm_dgrad", "gemm_wgrad",
                          "stripe_attention_bwd"), "bs-24 train step"))
PER["cswin_attention"] = "32-slice serving forward, pallas route"
PER["edt_pass"] = "volume_metrics_device call, 9 classes, (48, 512, 512)"
PER["block_pair"] = "32-slice serving forward, pairing forced on"
PER.update(dict.fromkeys(("lepe_windows", "window_attention", "ln_mlp"),
                         f"the [kernel] cases of the lab phase, once each, B = {LAB_BATCH}"))
PER["block_one"] = (f"the whole block at stages 1-4 (every part on), once each, "
                    f"B = {LAB_BATCH}; chain_ms the block chain on the same four")
PER.update(dict.fromkeys(("layernorm_f32", "gemm_f32", "stripe_attention_f32",
                          "carafe_reassemble_f32"),
                         "32-slice serving forward at TPU.COMPUTE_DTYPE float32, fused "
                         "route (pairing as committed)"))
PER["block_pair_f32"] = ("32-slice serving forward at TPU.COMPUTE_DTYPE float32, fused "
                         "route, the bf16 route's pairs forced on")
PER["cswin_attention_f32"] = ("32-slice serving forward at TPU.COMPUTE_DTYPE float32, "
                              "pallas route")
PER.update(dict.fromkeys(("layernorm_bwd_f32", "gemm_dgrad_f32", "gemm_wgrad_f32",
                          "stripe_attention_bwd_f32"),
                         "bs-24 train step at TPU.COMPUTE_DTYPE float32"))
# H100 SXM peaks from NVIDIA's datasheet: memory, bf16 tensor cores,
# float32 outside them.
HBM_BPS, TC_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
EVAL_SHAPES = ((48, 512, 512), (37, 512, 512))  # Synapse-like CT volumes
# Operations an element of the O(L) edt_pass: each j is pushed onto its
# line's hull once and popped at most once (two hull tests), the walk makes
# at most two tests an output, each test ~10 operations, then the output.
# At most 50 an element, so the bound of a pass is its bytes (each element
# read and written once) whatever the data: 50 operations over 67 TFLOP/s
# is under 8 bytes over 3.35 TB/s.
EDT_OPS = 50


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


def judge(label: str, got, want, check: str, tol: float = TOL) -> tuple[str, bool, float]:
    """Hold an output against its plain version: (text, ok, max abs error).
    ``check="labels"``: int32 labels against plain logits, by the margin
    rule; ``"exact"``: equal bit for bit; ``"rel"``: finite values within
    relative L2 ``tol``, each element of a tuple on its own."""
    import torch

    if isinstance(got, tuple):
        parts = [judge(f"{label}[{i}]", g, w, check, tol)
                 for i, (g, w) in enumerate(zip(got, want))]
        return (" | ".join(t for t, _, _ in parts), all(ok for _, ok, _ in parts),
                max(m for _, _, m in parts))
    if check == "labels":
        require(got.dtype == torch.int32, f"{label}: labels dtype {got.dtype}")
        raw, above = margin_mismatches(got, want)
        return f"mismatches={raw} above_margin={above}", above == 0, 0.0
    if check == "exact":
        mx = float((got.double() - want.double()).abs().max())
        return f"max_abs={mx:.3e}", mx == 0.0 and got.dtype == want.dtype, mx
    got, want = got.float(), want.float()
    require(bool(torch.isfinite(got).all()), f"{label}: non-finite")
    err = rel_l2(got, want)
    mx = float((got - want).abs().max())
    return f"rel_l2={err:.3e} max_abs={mx:.3e}", err <= tol, mx


def judge_reduction(label: str, got, want, oracle, tol: float) -> tuple[str, bool, float]:
    """``judge`` of a tuple element by element at ``tol``, where an element
    with a float64 ``oracle`` (a float32 sum over M, whose order the kernel
    and the plain version choose differently) that misses ``tol`` passes if
    its error against the oracle is at most twice the plain version's."""
    texts, oks, mxs = [], [], []
    for i, (g, w, o) in enumerate(zip(got, want, oracle)):
        t, ok, mx = judge(f"{label}[{i}]", g, w, "rel", tol)
        if not ok and o is not None:
            e_k, e_p = rel_l2(g, o), rel_l2(w, o)
            ok = e_k <= 2 * e_p
            t += f" (vs float64 {e_k:.3e}, plain vs float64 {e_p:.3e})"
        texts.append(t)
        oks.append(ok)
        mxs.append(mx)
    return " | ".join(texts), all(oks), max(mxs)


def time_ms(fn, reps: int = 10, rounds: int = 5, primed: bool = False) -> float:
    """ms per call: CUDA events around ``reps`` back-to-back calls (so the
    device queue stays full), median over ``rounds`` after a warm-up.
    ``primed``: the calls are queued behind a ~2 ms spin kernel, as the block
    lab times its cases: for calls shorter than their host work the events
    then read device time, not the host's enqueue rate."""
    import torch

    from cswin_unet_tpu_torch.tools.block_lab import PRIME_CYCLES

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if primed:
            torch.cuda._sleep(PRIME_CYCLES)
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


def carafe_sites(cfg) -> list[tuple[int, int, int, int]]:
    """The fused CARAFE sites of a forward, as (low-res H, C in, C out, up):
    the decoder's x2 upsamplers whose input resolution is >= 28 (``upsample2``
    at 28 -> 56 for tiny-224, 48 -> 96 for base-384), then the x4 tail."""
    ed, img = cfg.MODEL.CSWIN.EMBED_DIM, cfg.DATA.IMG_SIZE
    ups = [(img // (4 * 2**s), ed * 2**s, ed * 2**(s - 1), 2) for s in (3, 2, 1)
           if img // (4 * 2**s) >= 28]
    return ups + [(img // 4, ed, ed, 4)]


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


class KernelTally:
    """Per-kernel worst error, and times summed over one unit of work
    (``PER``): each case timed at the main path's shapes and weighted by its
    number of calls in that unit. ``bound_ms``: the larger of the bytes the
    call must move (each input read once, each output written once) over
    ``HBM_BPS`` and its operations over the peak of their type
    (``tc_flops`` bf16 products, ``f32_ops`` the rest: the two pipes run
    side by side, so the slower of them counts), per case;
    ``library_ms``: one PyTorch call computing the same function, where
    there is one, with ``library_vs_ms`` the kernel's ms over the same
    cases."""

    def __init__(self, tag: str = "kernel"):
        self.tag = tag  # the lines' prefix
        self.rows = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                             bytes_ms=0.0, ops_ms=0.0, library_ms=None,
                             library_vs_ms=0.0) for k in SOURCES}

    def case(self, name, label, kernel_fn, plain_fn, calls, check="rel", *,
             moved=0, tc_flops=0.0, f32_ops=0.0, library=None, reps=10, primed=False,
             timed=None, tol=TOL, rounds=5, oracle=None):
        """``timed``: the (kernel, plain) calls to time where the checked
        calls also do the harness's own work (allocating and gathering the
        outputs to compare). ``tol``: the relative L2 limit (``TOL`` for
        bf16, ``F32_TOL`` for a float32 instance). ``oracle``: a call giving,
        for each output of a tuple, its float64 value where it is a float32
        sum over M (else None): such an output that misses ``tol`` passes
        if its error against float64 is at most twice the plain version's."""
        import torch

        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        if oracle is None:
            err_txt, ok, mx = judge(f"{name} {label}", got, want, check, tol)
        else:
            err_txt, ok, mx = judge_reduction(f"{name} {label}", got, want, oracle(), tol)
        row = self.rows[name]
        row["max_abs_err"] = max(row["max_abs_err"], mx)
        ms, pms = (time_ms(fn, reps=reps, rounds=rounds, primed=primed)
                   for fn in (timed or (kernel_fn, plain_fn)))
        bytes_ms = moved / HBM_BPS * 1e3
        ops_ms = max(tc_flops / TC_FLOPS, f32_ops / F32_FLOPS) * 1e3
        row["ms"] += calls * ms
        row["plain_ms"] += calls * pms
        row["bound_ms"] += calls * max(bytes_ms, ops_ms)
        row["bytes_ms"] += calls * bytes_ms
        row["ops_ms"] += calls * ops_ms
        lib = ""
        if library is not None:
            lms = time_ms(library, reps=reps, rounds=rounds, primed=primed)
            row["library_ms"] = (row["library_ms"] or 0.0) + calls * lms
            row["library_vs_ms"] += calls * ms
            lib = f" library_ms={lms:.4f}"
        print(f"[{self.tag}] {name} {label} x{calls}: {err_txt} ms={ms:.4f} "
              f"plain_ms={pms:.4f} bound_ms={max(bytes_ms, ops_ms):.4f} "
              f"({'bytes' if bytes_ms >= ops_ms else 'operations'}){lib} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        require(ok, f"{name} {label}: {err_txt}")


def attention_work(pixels: int, cb: int, L: int, heads: int, lw, lb) -> dict:
    """Bytes and operations of one stripe branch over ``pixels`` tokens:
    q, k, v read and the output written (bf16), the LePE taps; Q·Kᵀ and P·V
    (4·L·cb per token, tensor-core eligible), softmax (~5 per score) and
    the 9-tap LePE in float32."""
    return dict(moved=4 * pixels * cb * 2 + nbytes(lw, lb), tc_flops=4 * pixels * L * cb,
                f32_ops=5 * pixels * heads * L + 18 * pixels * cb)


def compare_kernels(cfg, dev, B: int, *, extra: bool = True,
                    tag: str = "kernel") -> KernelTally:
    """Every kernel at every shape one forward of B slices gives it.
    ``extra``: also ``block_pair`` at the stages with two or more blocks and
    the CARAFE tail at the continual heads (tiny-224's further checks)."""
    import torch
    import torch.nn.functional as F

    from cswin_unet_tpu_torch.ops.attention import cswin_attention_pallas_plain
    from cswin_unet_tpu_torch.ops.cuda import kernels as K

    rng = np.random.default_rng(0)
    bf = torch.bfloat16
    rnd = lambda *s, sc=1.0: torch.from_numpy(
        (rng.standard_normal(s) * sc).astype(np.float32)).to(dev)
    tally = KernelTally(tag)
    for g in stage_geometries(cfg):
        H, C, blocks = g["H"], g["C"], 2 * g["depth"]
        M = B * H * H
        x, r = rnd(M, C).to(bf), rnd(M, C).to(bf)
        w, b = rnd(C, sc=0.3) + 1, rnd(C, sc=0.1)
        w_bf, b_bf = w.to(bf), b.to(bf)  # F.layer_norm on CUDA takes one dtype
        tag = f"@{H}x{H}x{C}"
        tally.case("layernorm", tag, lambda: K.layernorm(x, w, b),
                   lambda: K.layernorm_plain(x, w, b), 2 * blocks,
                   moved=2 * nbytes(x) + nbytes(w, b), f32_ops=8 * M * C,
                   library=lambda: F.layer_norm(x, (C,), w_bf, b_bf))
        h = rnd(M, 4 * C).to(bf)
        for what, a, n, epi, res in (("qkv", x, 3 * C, "bias", None),
                                     ("proj", x, C, "residual", r),
                                     ("fc1", x, 4 * C, "gelu", None),
                                     ("fc2", h, C, "residual", r)):
            wt = rnd(n, a.shape[1], sc=a.shape[1] ** -0.5).to(bf)
            bias = rnd(n, sc=0.1)
            bias_bf = bias.to(bf)
            tally.case("gemm", f"{what}{tag}",
                       lambda: K.gemm(a, wt, bias, residual=res, epilogue=epi),
                       lambda: K.gemm_plain(a, wt, bias, residual=res, epilogue=epi),
                       blocks, moved=nbytes(a, wt, bias, res) + M * n * 2,
                       tc_flops=2 * M * n * a.shape[1],
                       f32_ops=M * n * (10 if epi == "gelu" else 2),
                       library=(lambda: F.linear(a, wt, bias_bf)) if epi == "bias"
                       else None)
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
                       blocks, **attention_work(B * H * H, cb, hs * ws, nh, lw, lb))
            # The pallas route's kernel on the same branch: q, k, v as the
            # channel slices of qkv that composed_block hands it.
            q, k, v = (qkv.view(B, H, H, 3, C)[..., i, off:off + cb] for i in range(3))
            akw = dict(h_sp=hs, w_sp=ws, num_heads=nh, scale=scale)
            tally.case("cswin_attention", f"{tag} window {hs}x{ws}",
                       lambda: K.cswin_attention(q, k, v, lw, lb, **akw),
                       lambda: cswin_attention_pallas_plain(q, k, v, lw, lb, **akw),
                       blocks, **attention_work(B * H * H, cb, hs * ws, nh, lw, lb))
        if extra and not g["last"] and g["depth"] > 1:
            compare_block_pair(tally, g, B, rng, dev)
    # CARAFE sites (carafe_sites: the x2 upsamplers at resolution >= 28, and
    # the x4 tail), in the layout the main path gives them: the GEMM's
    # output channels padded as carafe_fused pads them (a build without the
    # padding: cm + nc).
    from cswin_unet_tpu_torch.ops.cuda import carafe_tail as CT

    gy_channels = getattr(CT, "gy_channels", lambda cm, nc: cm + nc)
    *ups, (Ht, Ct, _, _) = carafe_sites(cfg)
    # (label, H, C, cm, nc, up, labels, calls, batch, with its GEMM)
    rows = [(f"up@{H}", H, C, C // 4, C_out, 2, False, 1, B, True) for H, C, C_out, _ in ups]
    rows += [(f"tail-{kind}@{Ht}", Ht, Ct, Ct // 4, 9, 4, kind == "labels",
              int(kind == "labels"), B, True) for kind in ("logits", "labels")]
    # The continual heads (12 and 14 classes: nc % 8 != 0 takes the
    # element stores) at the continual batch and the serving batch: checked
    # and timed, not in the serving unit's sums; their GEMM has the 9-class
    # tail's N, 32.
    if extra:
        rows += [(f"tail-{kind}@{Ht} nc{nc} B{bb}", Ht, Ct, Ct // 4, nc, 4, kind == "labels",
                  0, bb, False) for nc in CONTINUAL_CLASSES for bb in (CONTINUAL_BATCH, B)
                 for kind in ("logits", "labels")]
    for label, H, C, cm, nc, up, labels, calls, Bc, with_gemm in rows:
        N = gy_channels(cm, nc)
        if with_gemm:
            a = rnd(B * H * H, C).to(bf)
            wt = torch.cat([rnd(cm + nc, C, sc=C ** -0.5),
                            torch.zeros(N - cm - nc, C, device=dev)]).to(bf)
            bias_cat = torch.cat([rnd(cm, sc=0.1), torch.zeros(N - cm, device=dev)])
            bias_bf = bias_cat.to(bf)
            M = a.shape[0]
            tally.case("gemm", f"carafe-{label}", lambda: K.gemm(a, wt, bias_cat),
                       lambda: K.gemm_plain(a, wt, bias_cat), calls,
                       moved=nbytes(a, wt, bias_cat) + M * N * 2, tc_flops=2 * M * N * C,
                       f32_ops=2 * M * N, library=lambda: F.linear(a, wt, bias_bf))
        gy = torch.cat([rnd(Bc, H, H, cm + nc),
                        torch.zeros(Bc, H, H, N - cm - nc, device=dev)], -1).to(bf)
        ew, eb, bo = rnd(9 * up * up, cm, 3, 3, sc=0.2), rnd(9 * up * up), rnd(nc)
        kw = dict(c_mid=cm, up=up, labels=labels)
        plain = (lambda: K.carafe_reassemble_plain(gy, ew, eb, bo, c_mid=cm, up=up,
                                                   labels=False).float()) \
            if labels else (lambda: K.carafe_reassemble_plain(gy, ew, eb, bo, **kw))
        px, taps = Bc * H * H, 9 * up * up
        # Bytes: the cm + nc channels of gy the function needs (not the
        # padding), the weights, and the high-res output.
        tally.case("carafe_reassemble", label,
                   lambda: K.carafe_reassemble(gy, ew, eb, bo, **kw), plain, calls,
                   check="labels" if labels else "rel",
                   moved=px * (cm + nc) * 2 + nbytes(ew, eb, bo)
                   + px * up * up * (4 if labels else 2 * nc),
                   tc_flops=2 * px * taps * cm * 9,
                   f32_ops=px * taps * (4 + 2 * nc))
    return tally


def pair_weight_bytes(p) -> int:
    """Bytes of one block's parameters as ``block_pair`` reads them:
    matrices, LePE taps and LePE biases in bf16, the rest float32."""
    return sum(t.numel() * (2 if t.dim() > 1 or i in (5, 7) else 4)
               for i, t in enumerate(p) if t is not None)


def compare_block_pair(tally: KernelTally, g: dict, B: int, rng, dev) -> None:
    """``block_pair`` at one stage geometry against ``block_pair_plain``,
    weighted by its calls in a forward with pairing on (one per pair of
    blocks, encoder and decoder); then against two single block chains on
    the same inputs, which it must equal bit for bit."""
    import torch

    from cswin_unet_tpu_torch.ops.cuda import kernels as K
    from cswin_unet_tpu_torch.ops.cuda.cswin_block import fused_cswin_block

    H, C, heads, split = g["H"], g["C"], g["heads"], g["split"]
    p1, p2 = block_params(rng, C, False, dev), block_params(rng, C, False, dev)
    x = torch.from_numpy(rng.standard_normal((B, H, H, C)).astype(np.float32)).to(
        dev, torch.bfloat16)
    kw = dict(heads=heads, split=split, scale=(C // heads) ** -0.5)
    M = B * H * H
    # Per block: qkv, proj, fc1 and fc2 products (2·M·12·C²) and two
    # branches on tensor cores; softmax, LePE, two LNs (8 a value), GELU
    # (~10 a hidden value) and the bias / residual epilogues in float32.
    att = attention_work(M, C // 2, H * split, heads // 2, None, None)
    tc = 2 * M * 12 * C * C + 2 * att["tc_flops"]
    f32 = 2 * att["f32_ops"] + M * C * (16 + 40 + 18)
    label = f"@{H}x{H}x{C} B={B}"
    tally.case("block_pair", label, lambda: K.block_pair(x, p1, p2, **kw),
               lambda: K.block_pair_plain(x, p1, p2, **kw), 2 * (g["depth"] // 2),
               moved=2 * nbytes(x) + pair_weight_bytes(p1) + pair_weight_bytes(p2),
               tc_flops=2 * tc, f32_ops=2 * f32)
    got = K.block_pair(x, p1, p2, **kw)
    chain = fused_cswin_block(fused_cswin_block(x, p1, last_stage=False, **kw), p2,
                              last_stage=False, **kw)
    torch.cuda.synchronize()
    txt, ok, _ = judge(f"block_pair vs chain {label}", got, chain, "exact")
    print(f"[kernel] block_pair vs chain {label}: {txt}; grid {K.block_pair.grid} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    require(ok, f"block_pair vs two chains {label}: {txt}")


def pair_ab(cfg, dev, batches=(SERVE_BATCH, 128), rounds: int = 8, reps: int = 10) -> None:
    """The routing measurement: at each pairable stage geometry and batch,
    two single block chains against one ``block_pair`` on the same inputs,
    ms per call from CUDA events around ``reps`` back-to-back calls, in
    ``rounds`` rounds whose order alternates (chain first, pair first);
    medians and min-max spread per order, and device-busy ms beside them.
    Prints the geometries where the pair wins at the serving batch by more
    than the spread in both orders beside ``cswin_block.PAIR_GEOMETRIES``."""
    import torch

    from cswin_unet_tpu_torch.ops.cuda import cswin_block as CB
    from cswin_unet_tpu_torch.ops.cuda import kernels as K
    from cswin_unet_tpu_torch.utils.profiling import device_busy_ms

    rng = np.random.default_rng(5)
    wins = set()
    for g in stage_geometries(cfg):
        if g["last"] or g["depth"] < 2:
            continue
        H, C = g["H"], g["C"]
        p1, p2 = block_params(rng, C, False, dev), block_params(rng, C, False, dev)
        kw = dict(heads=g["heads"], split=g["split"], scale=(C // g["heads"]) ** -0.5)
        for b, dt in [(b, torch.bfloat16) for b in batches] + [(SERVE_BATCH, torch.float32)]:
            x = torch.from_numpy(rng.standard_normal((b, H, H, C)).astype(np.float32)).to(
                dev, dt)
            fns = dict(chain=lambda: CB.fused_cswin_block(
                CB.fused_cswin_block(x, p1, last_stage=False, **kw), p2,
                last_stage=False, **kw), pair=lambda: K.block_pair(x, p1, p2, **kw))
            times = {(first, n): [] for first in fns for n in fns}
            with torch.inference_mode():
                for r in range(rounds):
                    order = ("chain", "pair") if r % 2 == 0 else ("pair", "chain")
                    for n in order:
                        times[(order[0], n)].append(time_ms(fns[n], reps=reps, rounds=1))
                busy = {n: device_busy_ms(fns[n], reps) for n in fns}
            wins_both, parts = True, []
            for first in fns:
                med = {n: statistics.median(times[(first, n)]) for n in fns}
                spread = {n: max(times[(first, n)]) - min(times[(first, n)]) for n in fns}
                wins_both &= med["chain"] - med["pair"] > max(spread.values())
                parts.append(f"{first} first: " + " ".join(
                    f"{n} {med[n]:.4f} [{min(times[(first, n)]):.4f}-"
                    f"{max(times[(first, n)]):.4f}]" for n in fns))
            busy_txt = " ".join(f"{n} {'not measured' if v is None else f'{v:.4f}'}"
                                for n, v in busy.items())
            print(f"[pair] stage{g['stage']} ({b},{H},{H},{C}){' float32' * (dt == torch.float32)}"
                  f" ms per pair of blocks, "
                  f"median [min-max] of {rounds // 2} rounds per order: "
                  f"{'; '.join(parts)}; device busy ms: {busy_txt}; pair wins in both "
                  f"orders by more than the spread: {'yes' if wins_both else 'no'}",
                  flush=True)
            if b == SERVE_BATCH and wins_both:
                wins.add((H, H, C, str(dt).removeprefix("torch.")))
    print(f"[pair] measured routing (wins at B={SERVE_BATCH}): {sorted(wins)}; "
          f"cswin_block.PAIR_GEOMETRIES: {sorted(CB.PAIR_GEOMETRIES)}; agree: "
          f"{'yes' if wins == set(CB.PAIR_GEOMETRIES) else 'no'}", flush=True)


def probe_vs_parent(dev) -> None:
    """``tools/probe_chain.py``'s tensors (the block chain, its training
    forward and backward, the ``pallas`` route's kernel, the pair, the three
    CARAFE sites, the LayerNorm backward at every width; the float32 GEMM and
    dX products in every epilogue, the float32 chain, its training forward
    and input gradient, and the float32 pair) from this build, held bit for
    bit to the digests of the parent commit's build
    (``probe_chain.REFERENCE``): a change to the
    shared device bodies moved no result. A change meant to move these bits
    (a redesign of ``stripe_attention`` or ``gemm``, say) prints
    ``probe_chain.py --compare`` of the parent's build against its own, then
    regenerates the file from its own build (``probe_chain.py --root .
    --digest <file>``) once its results are held to the plain versions, so
    that the next change is held to it."""
    from cswin_unet_tpu_torch.tools import probe_chain

    ok, report = probe_chain.check(probe_chain.digests(probe_chain.probe(dev)))
    print(f"[probe] chain, pallas route, pair, CARAFE, LN backward and float32 GEMMs vs the "
          f"parent's build: "
          f"{report} {'ok' if ok else 'FAIL'}", flush=True)
    require(ok, f"probe_chain: {report}")


def compare_backward_kernels(cfg, dev, B: int, tally: KernelTally) -> None:
    """The backward kernels and the forward GEMM's training epilogues at
    every stage geometry of ``cfg``, batch B; each case weighted by its calls
    in one train step (``trained_blocks``)."""
    import torch

    from cswin_unet_tpu_torch.ops.cuda import kernels as K

    rng = np.random.default_rng(3)
    bf = torch.bfloat16
    rnd = lambda *s, sc=1.0: torch.from_numpy(
        (rng.standard_normal(s) * sc).astype(np.float32)).to(dev)
    for g, blocks in trained_blocks(cfg):
        H, C, heads, split = g["H"], g["C"], g["heads"], g["split"]
        M, hw = B * H * H, H * H
        tag = f"@{H}x{H}x{C}{' last' if g['last'] else ''}"
        dp = torch.from_numpy((rng.random(B) < 0.8).astype(np.float32) / 0.8).to(dev)
        x, dy, res = (rnd(M, C).to(bf) for _ in range(3))
        w, b = rnd(C, sc=0.3) + 1, rnd(C, sc=0.1)
        # The library call: aten's LayerNorm backward on the same shapes in
        # bf16 (its statistics from aten's forward); it leaves out the
        # residual add that the kernel fuses.
        w_bf, b_bf = w.to(bf), b.to(bf)
        _, mean, rstd = torch.ops.aten.native_layer_norm(x, [C], w_bf, b_bf, 1e-5)
        tally.case("layernorm_bwd", tag,
                   lambda: K.layernorm_bwd(x, dy, w, residual=res),
                   lambda: K.layernorm_bwd_plain(x, dy, w, residual=res), 2 * blocks,
                   moved=4 * nbytes(x) + 3 * nbytes(w), f32_ops=14 * M * C,
                   library=lambda: torch.ops.aten.native_layer_norm_backward(
                       dy, x, [C], mean, rstd, w_bf, b_bf, [True, True, True]))
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
            tally.case("gemm", f"train-{what}{tag}", kern, plain, 0,
                       moved=nbytes(a, wt, bias, kw.get("residual"), kw.get("dp"))
                       + M * n * (4 if epi == "gelu" else 2),
                       tc_flops=2 * M * n * a.shape[1])
        for what, n, k, kw in (("fc2-gelu_bwd", C, 4 * C, dict(dp=dp, gelu_h=h)),
                               ("fc1", 4 * C, C, {}),
                               ("proj+droppath", C, C, dict(dp=dp)),
                               ("qkv", 3 * C, C, {})):
            d = rnd(M, n).to(bf)
            wt = rnd(n, k, sc=n ** -0.5)
            wt_bf = wt.to(bf)
            plain_product = not kw
            kw = dict(kw, rows_per_sample=hw)
            tally.case("gemm_dgrad", f"{what}{tag}",
                       lambda: K.gemm_dgrad(d, wt, **kw),
                       lambda: K.gemm_dgrad_plain(d, wt, **kw), blocks,
                       moved=nbytes(d, wt, kw.get("gelu_h"), kw.get("dp")) + M * k * 2,
                       tc_flops=2 * M * n * k,
                       f32_ops=M * k * (16 if "gelu_h" in kw else 1),
                       library=(lambda: torch.matmul(d, wt_bf)) if plain_product
                       else None)
        for what, k, n, kw in (("fc2+droppath", 4 * C, C, dict(dp=dp)),
                               ("fc1", C, 4 * C, {}),
                               ("proj+droppath", C, C, dict(dp=dp)),
                               ("qkv", C, 3 * C, {})):
            a, d = rnd(M, k).to(bf), rnd(M, n).to(bf)
            plain_product = not kw
            kw = dict(kw, rows_per_sample=hw)
            tally.case("gemm_wgrad", f"{what}{tag}",
                       lambda: K.gemm_wgrad(a, d, **kw),
                       lambda: K.gemm_wgrad_plain(a, d, **kw), blocks,
                       moved=nbytes(a, d, kw.get("dp")) + (n * k + n) * 4,
                       tc_flops=2 * M * n * k, f32_ops=M * n,
                       library=(lambda: torch.matmul(d.t(), a)) if plain_product
                       else None)
        dropout_cases(tally, dev, rnd, x, res, h, dp, hw, C, tag)
        attention_bwd_cases(tally, dev, rnd, B, H, C, heads, split, g["last"], blocks, tag)


def dropout_sites(dev, seed: int, rate: float = DROP_RATE, row0: int = 0):
    """One block's (fc1, fc2) dropout sites, keys from a seeded generator on
    the card."""
    import torch

    from cswin_unet_tpu_torch.ops import dropout as D

    keys = D.draw_keys(torch.Generator(device=dev).manual_seed(seed), 2)
    return D.Drop(keys[0:1], rate, row0), D.Drop(keys[1:2], rate, row0)


def dropout_cases(tally: KernelTally, dev, rnd, x, res, h, dp, hw: int, C: int,
                  tag: str) -> None:
    """The GEMMs' dropout instances at one stage geometry (rate DROP_RATE,
    drop-path live): the fc1 GELU and fc2 residual epilogues, the fc2 dX
    product (both masks) and its weight gradient (dY's mask), each against
    its plain version; outside the step's sums (calls 0: the main path
    trains at rate 0). Each is timed behind the spin kernel beside the same
    call at rate 0 (the instance without dropout), printed as a ratio."""
    import torch

    from cswin_unet_tpu_torch.ops.cuda import kernels as K

    bf = torch.bfloat16
    M = x.shape[0]
    d1, d2 = dropout_sites(dev, 17)
    w1, b1 = rnd(4 * C, C, sc=C ** -0.5).to(bf), rnd(4 * C, sc=0.1)
    w2, b2 = rnd(C, 4 * C, sc=(4 * C) ** -0.5).to(bf), rnd(C, sc=0.1)
    d = rnd(M, C).to(bf)
    wt = rnd(C, 4 * C, sc=C ** -0.5)
    drops = ("drop", "drop_dy", "drop_dx")
    cases = (
        ("gemm", "train-fc1-gelu+dropout", K.gemm, K.gemm_plain, (x, w1, b1),
         dict(epilogue="gelu", drop=d1), dict(moved=nbytes(x, w1, b1) + M * 4 * C * 2,
                                              tc_flops=2 * M * 4 * C * C)),
        ("gemm", "train-fc2+droppath+dropout", K.gemm, K.gemm_plain, (h, w2, b2),
         dict(epilogue="residual", residual=res, dp=dp, rows_per_sample=hw, drop=d2),
         dict(moved=nbytes(h, w2, b2, res, dp) + M * C * 2, tc_flops=2 * M * C * 4 * C)),
        ("gemm_dgrad", "fc2-gelu_bwd+droppath+dropout", K.gemm_dgrad, K.gemm_dgrad_plain,
         (d, wt), dict(dp=dp, rows_per_sample=hw, gelu_h=h, drop_dy=d2, drop_dx=d1),
         dict(moved=nbytes(d, wt, h, dp) + M * 4 * C * 2, tc_flops=2 * M * C * 4 * C,
              f32_ops=M * 4 * C * 16)),
        ("gemm_wgrad", "fc2+droppath+dropout", K.gemm_wgrad, K.gemm_wgrad_plain, (h, d),
         dict(dp=dp, rows_per_sample=hw, drop=d2),
         dict(moved=nbytes(h, d, dp) + (C * 4 * C + C) * 4, tc_flops=2 * M * C * 4 * C,
              f32_ops=M * C)))
    for name, what, fn, plain, args, kw, work in cases:
        tally.case(name, f"{what}{tag}", lambda: fn(*args, **kw), lambda: plain(*args, **kw),
                   0, primed=True, **work)
        ms, ms0 = (time_ms(f, primed=True) for f in (
            lambda: fn(*args, **kw),
            lambda: fn(*args, **{k: v for k, v in kw.items() if k not in drops})))
        print(f"[{tally.tag}] {name} {what}{tag}: the dropout instance ms={ms:.4f}, the same "
              f"call at rate 0 ms={ms0:.4f} ({ms / ms0:.2f}x)", flush=True)


def check_attention_bwd_smem() -> None:
    """``stripe_attention_bwd``'s whole-window shared memory, held to the
    wrapper's count at every window this run gives the backward: tiny-224's
    56, 98 and 49 tokens at head dim 32, base-384's 96, 288 and 144 at 24
    (0 past one key block, where the whole-window kernel takes nothing); the
    bf16 plan (the route, the split's two kernels' shared memory,
    its row and key blocks) held to ``kernels.stripe_attention_bwd_plan``;
    and the float32 instance's plan (both kernels' shared memory, the row
    and key split) held to ``kernels.stripe_attention_bwd_f32_plan``."""
    from cswin_unet_tpu_torch.ops.cuda import build
    from cswin_unet_tpu_torch.ops.cuda import kernels as K

    lib = build.library()
    for L, d in ((56, 32), (98, 32), (49, 32), (96, 24), (288, 24), (144, 24)):
        got, want = lib.cswin_stripe_attention_bwd_smem(L, d), K.stripe_attention_bwd_smem(L, d)
        print(f"[kernel] stripe_attention_bwd shared memory at L={L} d={d}: kernel {got} "
              f"B, wrapper {want} B {'ok' if got == want else 'FAIL'}", flush=True)
        require(got == want, f"stripe_attention_bwd smem at L={L} d={d}: {got} != {want}")
        bp = K.stripe_attention_bwd_plan(L, d)
        want = ((1, bp.rows_smem, bp.keys_smem, bp.row_block, bp.key_tiles_per_cta)
                if bp.split else (0,))
        got = tuple(lib.cswin_stripe_attention_bwd_plan(L, d, w) for w in range(len(want)))
        print(f"[kernel] stripe_attention_bwd plan at L={L} d={d}: kernel {got}, wrapper "
              f"{want} {'ok' if got == want else 'FAIL'}", flush=True)
        require(got == want, f"stripe_attention_bwd plan at L={L} d={d}: {got} != {want}")
        # the float32 instance's two kernels: shared memory, rows of a row-kernel
        # CTA, key blocks of a key-kernel CTA
        plan = K.stripe_attention_bwd_f32_plan(L, d)
        want = (plan.rows_smem, plan.keys_smem, plan.row_block, plan.key_blocks_per_cta)
        got = tuple(lib.cswin_stripe_attention_bwd_f32_smem(L, d, w) for w in range(4))
        print(f"[kernel] stripe_attention_bwd_f32 plan at L={L} d={d}: kernel {got}, wrapper "
              f"{want} {'ok' if got == want else 'FAIL'}", flush=True)
        require(got == want, f"stripe_attention_bwd_f32 plan at L={L} d={d}: {got} != {want}")


def flash_attention_bwd(q, k, v, do, scale: float):
    """aten's flash-attention backward on (windows, heads, L, d) bf16: the
    softmax attention's dq, dk, dv without LePE. Its forward (out, logsumexp)
    runs here, once; the returned call is the backward alone."""
    import torch

    fwd = torch.ops.aten._scaled_dot_product_flash_attention(q, k, v, 0.0, False, False,
                                                              scale=scale)
    out, lse, cq, ck, mq, mk, seed, offset = fwd[:8]
    return lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        do, q, k, v, out, lse, cq, ck, mq, mk, 0.0, False, seed, offset, scale=scale)


def attention_bwd_cases(tally: KernelTally, dev, rnd, B: int, H: int, C: int, heads: int,
                        split: int, last: bool, calls: int, tag: str) -> None:
    """``stripe_attention_bwd`` on both branches of a dual-branch stage (the
    one full-window branch of a last-stage block), against its plain
    version, ``calls`` times a step, aten's
    flash-attention backward on the same windows as its yardstick
    (attention only, no LePE). Timed: the wrapper's call alone, into a
    buffer allocated once."""
    import torch

    from cswin_unet_tpu_torch.ops.cuda import kernels as K

    bf = torch.bfloat16
    qkv, dout = rnd(B, H, H, 3 * C).to(bf), rnd(B, H, H, C).to(bf)
    scale = (C // heads) ** -0.5
    cb, nh = (C, heads) if last else (C // 2, heads // 2)
    M = B * H * H
    for off, hs, ws in ([(0, H, H)] if last else [(0, H, split), (C // 2, split, H)]):
        lw = rnd(cb, 1, 3, 3, sc=0.3)
        kw = dict(ch_off=off, heads=nh, h_sp=hs, w_sp=ws, scale=scale)
        chans = torch.cat([torch.arange(off, off + cb) + i * C for i in range(3)]).to(dev)

        def run(fn):
            dqkv = torch.zeros(B, H, H, 3 * C, dtype=bf, device=dev)
            dw, db = fn(qkv, dout, lw, dqkv, **kw)
            return dqkv[..., chans], dw, db

        L = hs * ws
        win = lambda t: K._branch_windows(t[..., off:off + cb], hs, ws, nh).contiguous()
        thirds = [win(qkv[..., i * C:(i + 1) * C]) for i in range(3)]
        buf = torch.zeros(B, H, H, 3 * C, dtype=bf, device=dev)
        tally.case("stripe_attention_bwd", f"{tag} window {hs}x{ws}",
                   lambda: run(K.stripe_attention_bwd),
                   lambda: run(K.stripe_attention_bwd_plain), calls,
                   timed=(lambda: K.stripe_attention_bwd(qkv, dout, lw, buf, **kw),
                          lambda: K.stripe_attention_bwd_plain(qkv, dout, lw, buf, **kw)),
                   moved=M * cb * 2 * 7 + nbytes(lw) + 10 * cb * 4,
                   tc_flops=10 * M * L * cb,
                   f32_ops=M * nh * 8 * L + 36 * M * cb,
                   library=flash_attention_bwd(*thirds, win(dout), scale))


def organ_volume(rng, shape, nc: int, like=None):
    """A CT-like volume: ellipsoid organs with labels 1..nc-1, intensity
    tracking the label, noise on top. ``like``: another volume's organ list, each organ
    shifted and resized a little (a prediction with real overlap). Returns
    (image float32, label uint8, organs)."""
    d, h, w = shape
    zz = np.arange(d, dtype=np.float32)[:, None, None]
    yy = np.arange(h, dtype=np.float32)[None, :, None]
    xx = np.arange(w, dtype=np.float32)[None, None, :]
    if like is None:  # on a jittered 4-column grid, so no organ hides another
        rows = -(-(nc - 1) // 4)
        organs = [(c, rng.uniform(0.4, 0.6) * d,
                   ((c - 1) // 4 + 0.5 + rng.uniform(-0.1, 0.1)) / rows * h,
                   ((c - 1) % 4 + 0.5 + rng.uniform(-0.1, 0.1)) / 4 * w,
                   rng.uniform(0.2, 0.45) * d, rng.uniform(0.05, 0.09) * h,
                   rng.uniform(0.05, 0.09) * w) for c in range(1, nc)]
    else:
        organs = [(c, z + rng.normal(0, 1), y + rng.normal(0, 4), x + rng.normal(0, 4),
                   rz * rng.uniform(0.85, 1.15), ry * rng.uniform(0.85, 1.15),
                   rx * rng.uniform(0.85, 1.15)) for c, z, y, x, rz, ry, rx in like]
    label = np.zeros(shape, np.uint8)
    for c, z, y, x, rz, ry, rx in organs:
        label[((zz - z) / rz) ** 2 + ((yy - y) / ry) ** 2 + ((xx - x) / rx) ** 2 < 1] = c
    image = rng.normal(0.2, 0.1, shape).astype(np.float32)
    image += np.where(label > 0, 0.3 + 0.05 * label, 0).astype(np.float32)
    return image, label, organs


def compare_edt(dev, tally: KernelTally) -> None:
    """``edt_pass`` along each axis of a (48, 512, 512) volume, in
    ``edt_sq``'s order (W, H, D; each pass reads the previous one's
    output), against its plain version bit for bit; weighted by the calls of
    one ``volume_metrics_device`` call on 9 classes (two EDTs per class).
    Its bound is the bytes (``EDT_OPS``)."""
    import torch

    from cswin_unet_tpu_torch.ops.cuda import kernels as K
    from cswin_unet_tpu_torch.ops.edt import _INF, boundary

    _, label, _ = organ_volume(np.random.default_rng(8), EVAL_SHAPES[0], 9)
    seeds = boundary(torch.from_numpy(label > 0).to(dev))
    f = torch.full(seeds.shape, _INF, dtype=torch.float32, device=dev)
    f.masked_fill_(seeds, 0.0)
    calls = 2 * 8
    for ax in (2, 1, 0):
        tally.case("edt_pass", f"axis {ax} of {tuple(f.shape)}",
                   lambda: K.edt_pass(f, ax), lambda: K.edt_pass_plain(f, ax), calls,
                   check="exact", moved=2 * nbytes(f), f32_ops=EDT_OPS * f.numel(), reps=3)
        f = K.edt_pass(f, ax)


def grads_vs_plain(label, fn, plain, inputs, cotangent, names, tag: str = "module") -> None:
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
    print(f"[{tag}] {label} fwd+bwd: {len(errs)} outputs, worst {worst} "
          f"rel_l2={errs[worst]:.3e} ms={ms:.4f} plain_ms={pms:.4f} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    print(f"[{tag}]   rel_l2 " + " ".join(f"{k}={v:.2e}" for k, v in errs.items()),
          flush=True)
    require(ok, f"{label}: {worst} rel_l2 {errs[worst]:.3e}")


BLOCK_GRAD_NAMES = ("dx", "norm1_w", "norm1_b", "qkv_w", "qkv_b", "lepe0_w",
                    "lepe0_b", "lepe1_w", "lepe1_b", "proj_w", "proj_b", "norm2_w",
                    "norm2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b")


def compare_module_grads(cfg, dev, B: int, *, extra: bool = True,
                         tag: str = "module") -> None:
    """``CSWinBlockFn`` at the stage geometries and ``CarafeFn`` at the
    fused CARAFE sites: forward and backward against autograd through the
    plain composition at every stage. ``extra``: also the tail at the
    continual head and ``CSWinAttentionFn`` at every branch. A last-stage block's one LePE is
    one input, passed in both slots."""
    import torch

    from cswin_unet_tpu_torch.ops.cuda import carafe_tail as CT
    from cswin_unet_tpu_torch.ops.cuda.cswin_block import (BlockParams, composed_block,
                                                           fused_cswin_block)

    rng = np.random.default_rng(4)
    bf = torch.bfloat16
    rnd = lambda *s, sc=1.0: torch.from_numpy(
        (rng.standard_normal(s) * sc).astype(np.float32)).to(dev)
    for g in stage_geometries(cfg):
        H, C, last = g["H"], g["C"], g["last"]
        p = block_params(rng, C, last, dev)
        x, gout = rnd(B, H, H, C).to(bf), rnd(B, H, H, C).to(bf)
        dps = tuple(torch.from_numpy((rng.random(B) < 0.8).astype(np.float32) / 0.8)
                    .to(dev) for _ in range(2))
        kw = dict(heads=g["heads"], split=g["split"], last_stage=last,
                  scale=(C // g["heads"]) ** -0.5, dps=dps)
        if last:  # (x, the 14 distinct parameters): the LePE into both slots
            inputs, names = (x, *p[:6], *p[8:]), BLOCK_GRAD_NAMES[:7] + BLOCK_GRAD_NAMES[9:]
            params = lambda pp: BlockParams(*pp[:6], *pp[4:6], *pp[6:])
        else:
            inputs, names, params = (x, *p), BLOCK_GRAD_NAMES, lambda pp: BlockParams(*pp)
        grads_vs_plain(f"CSWinBlockFn stage{g['stage']} ({B},{H},{H},{C})"
                       f"{' last' if last else ''}",
                       lambda xx, *pp: fused_cswin_block(xx, params(pp), **kw),
                       lambda xx, *pp: composed_block(xx, params(pp), **kw),
                       inputs, gout, names, tag)
    carafe_names = ("dx", "down_w", "down_b", "encoder_w", "encoder_b", "out_w",
                    "out_b", "cls_w")
    for H, C, C_out, up in carafe_sites(cfg):
        tail = up == 4
        x = rnd(B, H, H, C).to(bf)
        p = carafe_params(rng, C, C_out, up, 9 if tail else None, dev)
        name, fn, plain = (("carafe_tail", CT.carafe_tail, CT.carafe_tail_plain) if tail
                           else ("carafe_up", CT.carafe_up, CT.carafe_up_plain))
        grads_vs_plain(f"{name} CarafeFn ({B},{H},{H},{C})", fn, plain, (x, *p),
                       rnd(B, up * H, up * H, 9 if tail else C_out).to(bf),
                       carafe_names if tail else carafe_names[:-1], tag)
    if not extra:
        return
    *_, (Ht, ed, _, _) = carafe_sites(cfg)
    nc = CONTINUAL_CLASSES[0]  # the continual student's head
    xc = rnd(CONTINUAL_BATCH, Ht, Ht, ed).to(bf)
    tail = carafe_params(rng, ed, ed, 4, nc, dev)
    grads_vs_plain(f"carafe_tail CarafeFn nc {nc} ({CONTINUAL_BATCH},{Ht},{Ht},{ed})",
                   CT.carafe_tail, CT.carafe_tail_plain, (xc, *tail),
                   rnd(CONTINUAL_BATCH, 4 * Ht, 4 * Ht, nc).to(bf), carafe_names)

    # The pallas route's branch: kernel forward, composition-vjp backward,
    # against autograd of the Pallas rounding's plain version.
    from cswin_unet_tpu_torch.ops.attention import cswin_attention_pallas_plain
    from cswin_unet_tpu_torch.ops.cuda.cswin_attention import cswin_attention_kernel_route

    for g in stage_geometries(cfg):
        H, C = g["H"], g["C"]
        cb, nh = (C, g["heads"]) if g["last"] else (C // 2, g["heads"] // 2)
        windows = [(H, H)] if g["last"] else [(H, g["split"]), (g["split"], H)]
        for hs, ws in windows:
            kw = dict(h_sp=hs, w_sp=ws, num_heads=nh, scale=(C // g["heads"]) ** -0.5)
            qkv = [rnd(B, H, H, cb).to(bf) for _ in range(3)]
            lepe = (rnd(cb, 1, 3, 3, sc=0.3), rnd(cb, sc=0.1))
            grads_vs_plain(
                f"CSWinAttentionFn stage{g['stage']} ({B},{H},{H},{cb}) window {hs}x{ws}",
                lambda *t: cswin_attention_kernel_route(*t, **kw),
                lambda *t: cswin_attention_pallas_plain(*t, **kw),
                (*qkv, *lepe), rnd(B, H, H, cb).to(bf),
                ("dq", "dk", "dv", "lepe_w", "lepe_b"))


def compare_volume_metrics(dev) -> None:
    """``volume_metrics_device`` against the host ``metrics`` on (48, 512,
    512) organ-like volumes: classes 1-8 in both (the prediction's organs
    shifted and resized), class 9 in the prediction only, class 10 in
    neither. Dice and HD95 within rtol 1e-5 and atol 1e-4 (float32 EDT on
    the card against scipy's float64)."""
    import torch

    from cswin_unet_tpu_torch.metrics import volume_metrics
    from cswin_unet_tpu_torch.ops.edt import volume_metrics_device

    rng = np.random.default_rng(9)
    shape, nc = EVAL_SHAPES[0], 11
    _, label, organs = organ_volume(rng, shape, 9)
    _, pred, _ = organ_volume(rng, shape, 9, like=organs)
    d, h, w = shape
    pred[d // 3:d // 3 + 4, :h // 16, :w // 16] = 9  # a corner no organ reaches
    lab_d, pred_d = (torch.from_numpy(v).to(dev) for v in (label, pred))
    dev_ms = time_ms(lambda: volume_metrics_device(pred_d, lab_d, nc), reps=1, rounds=3)
    got = volume_metrics_device(pred_d, lab_d, nc).cpu().numpy()
    t0 = time.perf_counter()
    want = np.array(volume_metrics(pred, label, nc))
    host_s = time.perf_counter() - t0
    err = np.abs(got - want) - (1e-4 + 1e-5 * np.abs(want))
    ok = bool(np.all(err <= 0)) and bool(np.all(want[:8, 1] > 0))
    print(f"[module] volume_metrics_device {shape} {nc - 1} classes vs host: "
          f"max |dice diff| {np.abs(got - want)[:, 0].max():.3e} max |hd95 diff| "
          f"{np.abs(got - want)[:, 1].max():.3e} device_ms={dev_ms:.3f} "
          f"host_s={host_s:.3f} {'ok' if ok else 'FAIL'}", flush=True)
    print("[module]   dice/hd95 per class (device | host): " + "; ".join(
        f"{c + 1}: {g[0]:.6f}/{g[1]:.6f} | {w[0]:.6f}/{w[1]:.6f}"
        for c, (g, w) in enumerate(zip(got, want))), flush=True)
    require(ok and tuple(want[8]) == (1.0, 0.0) and tuple(want[9]) == (0.0, 0.0),
            f"volume_metrics_device vs host: {got.tolist()} vs {want.tolist()}")


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

def expected_launches(cfg, forwards: int, dtype: str = "bfloat16") -> dict[str, int]:
    """Kernel launches per the routing: in a dual-branch stage that
    ``cswin_block.pair_fuse_ok`` accepts at the activations' ``dtype``
    (looked up now, so a patched routing counts), each two adjacent blocks
    are one ``block_pair``
    launch; every other block runs 2 layernorms, 4 GEMMs and one attention
    launch per branch; each fused CARAFE site (upsamplers at stage
    resolution >= 28, and the tail) one GEMM and one CARAFE launch; no
    backward kernel runs."""
    import torch

    from cswin_unet_tpu_torch.ops.cuda import cswin_block

    blocks = dual = pairs = 0
    for g in stage_geometries(cfg):
        n = 2 * g["depth"]  # encoder and decoder
        if not g["last"] and cswin_block.pair_fuse_ok(g["H"], g["H"], g["C"],
                                                       getattr(torch, dtype)):
            pairs += 2 * (g["depth"] // 2)
            n = 2 * (g["depth"] % 2)
        blocks += n
        dual += 0 if g["last"] else n
    attention = blocks + dual
    sites = len(carafe_sites(cfg))
    per = dict(layernorm=2 * blocks, gemm=4 * blocks + sites, stripe_attention=attention,
               carafe_reassemble=sites, block_pair=pairs)
    return {k: per.get(k, 0) * forwards for k in SOURCES}


def expected_pallas_launches(cfg, forwards: int) -> dict[str, int]:
    """The ``pallas`` route: one ``cswin_attention`` launch per branch (2
    per dual-branch block, 1 per last-stage block), no other kernel (the
    blocks are compositions, CARAFE and the tail plain)."""
    branches = sum(2 * g["depth"] * (1 if g["last"] else 2) for g in stage_geometries(cfg))
    return {k: branches * forwards if k == "cswin_attention" else 0 for k in SOURCES}


def serve_volumes(cfg, dev, workdir: str) -> tuple[dict[str, int], ...]:
    """Returns the launch counts of the three served volumes, of the
    ``pallas`` chunk and of the forced-pair chunk."""
    import torch

    from cswin_unet_tpu_torch.models import build_model
    from cswin_unet_tpu_torch.ops.cuda import cswin_block
    from cswin_unet_tpu_torch.ops.cuda import kernels as K
    from cswin_unet_tpu_torch.serve import ServeStats, VolumeServer
    from cswin_unet_tpu_torch.utils.checkpoint import (load_checkpoint, load_into,
                                                       save_checkpoint)
    from cswin_unet_tpu_torch.utils.profiling import device_busy_ms

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

    # The same chunk through the pallas route, chosen by the config as the
    # CLIs choose it (the --opts rule, TPU.ATTN_IMPL pallas).
    pcfg = type(cfg)(cfg.to_dict())
    pcfg.merge_from_list(["TPU.ATTN_IMPL", "pallas"])
    pcfg.freeze()
    pallas = build_model(pcfg, num_classes=nc, device=dev, seed=1)
    require(pallas.cswin_unet.impl == "pallas", "TPU.ATTN_IMPL pallas not routed")
    require(load_into(pallas.cswin_unet, load_checkpoint(ck)[0])
            == len(pallas.cswin_unet.state_dict()), "checkpoint into the pallas route")
    K.reset_launch_counts()
    torch.cuda.synchronize()
    pallas_lab = forward(pallas)
    torch.cuda.synchronize()
    pallas_counts = K.launch_counts()
    want = expected_pallas_launches(cfg, 1)
    raw, above = margin_mismatches(pallas_lab, ref)
    print(f"[serve] pallas route, chunk ct64[0:{batch}] vs plain path: mismatches="
          f"{raw}/{pallas_lab.numel()} above_margin={above}; launches {pallas_counts} "
          f"expected {want}", flush=True)
    require(above == 0, f"pallas route: {above} label mismatches above the margin")
    require(pallas_counts == want, f"pallas route launches {pallas_counts} != {want}")
    pallas_ms = time_ms(lambda: forward(pallas), reps=2, rounds=3)
    print(f"[e2e] forward {batch} slices to labels, pallas route: pallas_ms="
          f"{pallas_ms:.3f} ({batch / pallas_ms * 1e3:.1f} slices/s) beside fused_ms="
          f"{fused_ms:.3f} plain_ms={plain_ms:.3f}", flush=True)

    # The same chunk on the fused route with pairing forced off, as
    # committed, and forced on at every pairable stage. The pair is the
    # chain's arithmetic, so the logits agree bit for bit; the forward is
    # timed in interleaved rounds of the three routings (the host's load
    # moves it), with device busy beside.
    model, committed = server.inferencer.model, cswin_block.pair_fuse_ok
    routings = dict(off=lambda H, W, C, dtype=None: False, committed=committed,
                    forced=lambda H, W, C, dtype=None: True)
    times = {k: [] for k in routings}
    try:
        cswin_block.pair_fuse_ok = routings["off"]
        with torch.inference_mode():
            unpaired = model(x)
        cswin_block.pair_fuse_ok = routings["forced"]
        K.reset_launch_counts()
        torch.cuda.synchronize()
        pair_lab = forward(model)
        torch.cuda.synchronize()
        pair_counts = K.launch_counts()
        want = expected_launches(cfg, 1)
        with torch.inference_mode():
            paired = model(x)
        for r in range(6):
            for k in list(routings)[::1 if r % 2 == 0 else -1]:
                cswin_block.pair_fuse_ok = routings[k]
                times[k].append(time_ms(lambda: forward(model), reps=5, rounds=1))
        busy = {}
        for k, fn in routings.items():
            cswin_block.pair_fuse_ok = fn
            busy[k] = device_busy_ms(lambda: forward(model), 5)
    finally:
        cswin_block.pair_fuse_ok = committed
    raw, above = margin_mismatches(pair_lab, ref)
    same = torch.equal(paired, unpaired)
    print(f"[serve] forced-pair route, chunk ct64[0:{batch}] vs plain path: mismatches="
          f"{raw}/{pair_lab.numel()} above_margin={above}; logits equal to the unpaired "
          f"route's bit for bit: {'yes' if same else 'no'}; launches {pair_counts} "
          f"expected {want}", flush=True)
    require(above == 0, f"forced-pair route: {above} label mismatches above the margin")
    require(same, "forced-pair logits differ from the unpaired route's")
    require(pair_counts == want, f"forced-pair launches {pair_counts} != {want}")
    print(f"[e2e] forward {batch} slices to labels by pair routing, ms median "
          f"[min-max] of 6 interleaved rounds, device busy ms: " + "; ".join(
              f"{k} {statistics.median(v):.3f} [{min(v):.3f}-{max(v):.3f}] busy "
              f"{'not measured' if busy[k] is None else f'{busy[k]:.3f}'}"
              for k, v in times.items()), flush=True)
    return counts, pallas_counts, pair_counts


# ---------------------------------------------------------------------------
# phase 5b: serving at TPU.COMPUTE_DTYPE float32
# ---------------------------------------------------------------------------

def pair_routed(cswin_block, H: int, C: int, dtype) -> bool:
    """Whether the stage runner pairs (H, H, C) at ``dtype``; a root from
    before the routing named its dtype (``tools/tile_ab.py --root``) pairs
    a geometry at both."""
    try:
        return cswin_block.pair_fuse_ok(H, H, C, dtype)
    except TypeError:
        return cswin_block.pair_fuse_ok(H, H, C)


def expected_f32(want: dict[str, int]) -> dict[str, int]:
    """The launches of a float32 run routed as ``want``: each wrapper's
    launches all of its float32 instance."""
    return {k: want[F32_OF[k]] if k in F32_OF else want[k] for k in SOURCES}


def compare_f32_kernels(cfg, dev, B: int, tag: str = "f32:kernel") -> KernelTally:
    """Each float32 instance at every shape one float32 forward of B slices
    of ``cfg`` gives it (tiny-224, or base-384 as ``[f32:base384:kernel]``
    lines), against its plain float32 version (``F32_TOL``), weighted by
    its calls in that forward (pairing as committed), each timed behind
    the lab's spin kernel (device time); the CARAFE tail's labels by the
    margin rule; ``block_pair`` also equal to two float32 chains bit for
    bit. Bounds: bytes at 3.35 TB/s or the products at 67
    TFLOP/s of float32 FFMA. Yardsticks (timed here only): cuBLAS float32
    (``F.linear``, TF32 off) for the bias GEMMs, ``F.layer_norm`` for LN."""
    import torch
    import torch.nn.functional as F

    from cswin_unet_tpu_torch.ops.attention import cswin_attention_pallas_plain
    from cswin_unet_tpu_torch.ops.cuda import carafe_tail as CT
    from cswin_unet_tpu_torch.ops.cuda import cswin_block
    from cswin_unet_tpu_torch.ops.cuda import kernels as K
    from cswin_unet_tpu_torch.ops.cuda.cswin_block import fused_cswin_block

    rng = np.random.default_rng(17)
    rnd = lambda *s, sc=1.0: torch.from_numpy(
        (rng.standard_normal(s) * sc).astype(np.float32)).to(dev)
    tally = KernelTally(tag)
    kw_t = dict(tol=F32_TOL, reps=5, rounds=3, primed=True)  # device time
    for g in stage_geometries(cfg):
        H, C, depth = g["H"], g["C"], g["depth"]
        paired = not g["last"] and pair_routed(cswin_block, H, C, torch.float32)
        # the float32 pair at the geometries paired at bf16, held to two
        # chains whether or not the float32 forward routes it (its weight:
        # a forward with those pairs forced on, chip_smoke's f32_serve)
        pairable = not g["last"] and pair_routed(cswin_block, H, C, torch.bfloat16)
        chained = 2 * (depth % 2 if paired else depth)  # blocks through the chain
        M = B * H * H
        tag = f"@{H}x{H}x{C}"
        x, r = rnd(M, C), rnd(M, C)
        w, b = rnd(C, sc=0.3) + 1, rnd(C, sc=0.1)
        tally.case("layernorm_f32", tag, lambda: K.layernorm(x, w, b),
                   lambda: K.layernorm_plain(x, w, b), 2 * chained,
                   moved=2 * nbytes(x) + nbytes(w, b), f32_ops=8 * M * C,
                   library=lambda: F.layer_norm(x, (C,), w, b), **kw_t)
        h = rnd(M, 4 * C)
        for what, a, n, epi, res in (("qkv", x, 3 * C, "bias", None),
                                     ("proj", x, C, "residual", r),
                                     ("fc1", x, 4 * C, "gelu", None),
                                     ("fc2", h, C, "residual", r)):
            wt = rnd(n, a.shape[1], sc=a.shape[1] ** -0.5)
            bias = rnd(n, sc=0.1)
            tally.case("gemm_f32", f"{what}{tag}",
                       lambda: K.gemm(a, wt, bias, residual=res, epilogue=epi),
                       lambda: K.gemm_plain(a, wt, bias, residual=res, epilogue=epi),
                       chained, moved=nbytes(a, wt, bias, res) + M * n * 4,
                       f32_ops=2 * M * n * a.shape[1] + M * n * (10 if epi == "gelu" else 2),
                       library=(lambda: F.linear(a, wt, bias)) if epi == "bias" else None,
                       **kw_t)
        qkv = rnd(B, H, H, 3 * C)
        scale = (C // g["heads"]) ** -0.5
        branches = ([(0, C, g["heads"], H, H)] if g["last"] else
                    [(0, C // 2, g["heads"] // 2, H, g["split"]),
                     (C // 2, C // 2, g["heads"] // 2, g["split"], H)])
        for off, cb, nh, hs, ws in branches:
            lw, lb = rnd(cb, 1, 3, 3, sc=0.3), rnd(cb, sc=0.1)
            out = torch.zeros(B, H, H, C, device=dev)
            kw = dict(ch_off=off, heads=nh, h_sp=hs, w_sp=ws, scale=scale)
            sl = slice(off, off + cb)
            L, px = hs * ws, B * H * H
            work = dict(moved=4 * px * cb * 4 + nbytes(lw, lb),
                        f32_ops=4 * px * L * cb + 5 * px * nh * L + 18 * px * cb)
            tally.case("stripe_attention_f32", f"{tag} window {hs}x{ws}",
                       lambda: K.stripe_attention(qkv, lw, lb, out, **kw)[..., sl],
                       lambda: K.stripe_attention_plain(qkv, lw, lb, out.clone(),
                                                        **kw)[..., sl],
                       chained, **work, **kw_t)
            q, k, v = (qkv.view(B, H, H, 3, C)[..., i, off:off + cb] for i in range(3))
            akw = dict(h_sp=hs, w_sp=ws, num_heads=nh, scale=scale)
            tally.case("cswin_attention_f32", f"{tag} window {hs}x{ws}",
                       lambda: K.cswin_attention(q, k, v, lw, lb, **akw),
                       lambda: cswin_attention_pallas_plain(q, k, v, lw, lb, **akw),
                       2 * depth, **work, **kw_t)
        if pairable:
            p1, p2 = block_params(rng, C, False, dev), block_params(rng, C, False, dev)
            xb = rnd(B, H, H, C)
            pkw = dict(heads=g["heads"], split=g["split"], scale=scale)
            # per block: the four products, both branches' Q·Kᵀ and P·V, LN,
            # GELU and the epilogues
            ops = 2 * (2 * M * 12 * C * C + 4 * M * H * g["split"] * C + M * C * (16 + 40 + 18))
            label = f"{tag} B={B}"
            tally.case("block_pair_f32", label, lambda: K.block_pair(xb, p1, p2, **pkw),
                       lambda: K.block_pair_plain(xb, p1, p2, **pkw), 2 * (depth // 2),
                       moved=2 * nbytes(xb) + nbytes(*p1, *p2), f32_ops=ops, **kw_t)
            got = K.block_pair(xb, p1, p2, **pkw)
            chain = fused_cswin_block(fused_cswin_block(xb, p1, last_stage=False, **pkw), p2,
                                      last_stage=False, **pkw)
            torch.cuda.synchronize()
            txt, ok, _ = judge(f"block_pair_f32 vs chain {label}", got, chain, "exact")
            print(f"[{tag}] block_pair_f32 vs two float32 chains {label}: {txt}; grid "
                  f"{K.block_pair.grid} {'ok' if ok else 'FAIL'}", flush=True)
            require(ok, f"block_pair_f32 vs two chains {label}: {txt}")
            if not hasattr(K, "block_pair_phases"):  # a root from before the stops
                continue
            # its phases (the first block stopped after each) and the pair
            t = {stop: time_ms(lambda: K.block_pair_phases(xb, p1, p2, stop=stop, **pkw),
                               reps=5, rounds=3, primed=True)
                 for stop in ("qkv", "attention", "proj")}
            t["pair"] = time_ms(lambda: K.block_pair(xb, p1, p2, **pkw), reps=5, rounds=3,
                                primed=True)
            print(f"[{tag}] block_pair_f32 by phase {label}, ms a block (device time; two "
                  f"chains: the [pair] A/B): ln1+qkv {t['qkv']:.4f} attention "
                  f"{t['attention'] - t['qkv']:.4f} proj {t['proj'] - t['attention']:.4f} "
                  f"ln2+fc1+fc2 {t['pair'] / 2 - t['proj']:.4f}; the pair {t['pair']:.4f}",
                  flush=True)
    *ups, (Ht, Ct, _, _) = carafe_sites(cfg)
    rows = [(f"up@{H}", H, C, C // 4, C_out, 2, False, 1) for H, C, C_out, _ in ups]
    rows += [(f"tail-{kind}@{Ht}", Ht, Ct, Ct // 4, 9, 4, kind == "labels",
              int(kind == "labels")) for kind in ("logits", "labels")]
    for label, H, C, cm, nc, up, labels, calls in rows:
        N = CT.gy_channels(cm, nc)
        a = rnd(B * H * H, C)
        wt = torch.cat([rnd(cm + nc, C, sc=C ** -0.5), torch.zeros(N - cm - nc, C, device=dev)])
        bias_cat = torch.cat([rnd(cm, sc=0.1), torch.zeros(N - cm, device=dev)])
        M = a.shape[0]
        tally.case("gemm_f32", f"carafe-{label}", lambda: K.gemm(a, wt, bias_cat),
                   lambda: K.gemm_plain(a, wt, bias_cat), calls,
                   moved=nbytes(a, wt, bias_cat) + M * N * 4, f32_ops=2 * M * N * C + 2 * M * N,
                   library=lambda: F.linear(a, wt, bias_cat), **kw_t)
        gy = torch.cat([rnd(B, H, H, cm + nc), torch.zeros(B, H, H, N - cm - nc, device=dev)],
                       -1)
        ew, eb, bo = rnd(9 * up * up, cm, 3, 3, sc=0.2), rnd(9 * up * up), rnd(nc)
        ckw = dict(c_mid=cm, up=up, labels=labels)
        plain = (lambda: K.carafe_reassemble_plain(gy, ew, eb, bo, c_mid=cm, up=up,
                                                   labels=False)) \
            if labels else (lambda: K.carafe_reassemble_plain(gy, ew, eb, bo, **ckw))
        px, taps = B * H * H, 9 * up * up
        plan = K.carafe_f32_plan(cm, nc, N, up)
        print(f"[{tag}] carafe_reassemble_f32 plan {label}: {plan.threads} threads of "
              f"{getattr(plan, 'pixels', 1)} pixels, {plan.ctas_per_sm} CTAs an SM, "
              f"{plan.smem_bytes} B", flush=True)
        tally.case("carafe_reassemble_f32", label,
                   lambda: K.carafe_reassemble(gy, ew, eb, bo, **ckw), plain, calls,
                   check="labels" if labels else "rel",
                   moved=px * (cm + nc) * 4 + nbytes(ew, eb, bo)
                   + px * up * up * (4 if labels else 4 * nc),
                   f32_ops=2 * px * taps * cm * 9 + px * taps * (4 + 2 * nc), **kw_t)
    return tally


def f32_serve(cfg, dev, workdir: str, smi: str) -> dict[str, dict[str, int]]:
    """The serve CLI at ``--opts TPU.COMPUTE_DTYPE float32`` on one (64,
    224, 224) volume from the serve phase's seeded tiny-224 checkpoint, on
    the fused route and with ``TPU.ATTN_IMPL pallas``: each run's launches
    (every one a float32 instance's, as routed) and its NIfTI labels
    against the plain float32 route by the margin rule; on the first chunk
    both routes' logits within ``F32_MODEL_TOL`` of the plain float32
    route's; one chunk with the float32 pair forced on (the routing pairs
    no float32 geometry), equal to the committed route bit for bit; then
    the 32-slice float32 forward timed beside the bf16 and the plain
    float32 ones and the forced pair. Returns the launch counts of the two
    CLI runs and of the forced-pair chunk."""
    import torch

    from cswin_unet_tpu_torch import serve
    from cswin_unet_tpu_torch.models import build_model
    from cswin_unet_tpu_torch.ops.cuda import cswin_block
    from cswin_unet_tpu_torch.ops.cuda import kernels as K
    from cswin_unet_tpu_torch.utils.checkpoint import load_checkpoint, load_into
    from cswin_unet_tpu_torch.utils.profiling import device_busy_ms

    t0 = time.perf_counter()
    nc, batch = 9, SERVE_BATCH
    ck = os.path.join(workdir, "tiny224_seed0.npz")
    shape = (64, 224, 224)
    vol = np.random.default_rng(31).standard_normal(shape).astype(np.float32)
    path = os.path.join(workdir, "ct64_f32.npy")
    np.save(path, vol)
    f32cfg = type(cfg)(cfg.to_dict())  # the CLI's config: the YAML with --opts
    f32cfg.merge_from_list(F32_OPTS)
    f32cfg.freeze()

    def from_checkpoint(impl=None, c=f32cfg):
        model = build_model(c, num_classes=nc, device=dev, impl=impl, seed=1)
        require(load_into(model.cswin_unet, load_checkpoint(ck)[0])
                == len(model.cswin_unet.state_dict()), "checkpoint not loaded whole")
        return model

    models = dict(fused=from_checkpoint(), plain=from_checkpoint("plain"),
                  pallas=from_checkpoint("pallas"), bf16=from_checkpoint(c=cfg))
    require(all(models[k].cswin_unet.dtype == torch.float32 for k in ("fused", "plain",
                                                                      "pallas")),
            "TPU.COMPUTE_DTYPE float32 not taken")
    x = torch.from_numpy(vol[:batch, ..., None]).to(dev)
    with torch.inference_mode():
        ref = models["plain"](x)
    require(bool(torch.isfinite(ref).all()), "non-finite plain float32 logits")
    forwards = -(-shape[0] // batch) + 1  # the volume's chunks and the CLI's warmup
    counts = {}
    for route, opts, routed in (
            ("fused", [], expected_launches(cfg, forwards, "float32")),
            ("pallas", ["TPU.ATTN_IMPL", "pallas"], expected_pallas_launches(cfg, forwards))):
        out_dir = os.path.join(workdir, f"served_f32_{route}")
        K.reset_launch_counts()
        torch.cuda.synchronize()
        serve.main(["--cfg", CFG, "--checkpoint", ck, "--output_dir", out_dir,
                    "--batch_slices", str(batch), path, "--opts", *F32_OPTS, *opts])
        torch.cuda.synchronize()
        counts[route] = K.launch_counts()
        want = expected_f32(routed)
        served = read_nifti(os.path.join(out_dir, "ct64_f32_pred.nii.gz"), shape)
        lab = torch.from_numpy(served[:batch].astype(np.int32)).to(dev)
        raw, above = margin_mismatches(lab, ref)
        with torch.inference_mode():
            err = rel_l2(models[route](x), ref)
        ok = above == 0 and err <= F32_MODEL_TOL and counts[route] == want
        print(f"[f32:serve] the serve CLI at --opts {' '.join(F32_OPTS + opts)}: launches "
              f"{counts[route]} expected {want}; chunk ct64[0:{batch}] vs the plain float32 "
              f"route: mismatches={raw}/{lab.numel()} above_margin={above}, the {route} "
              f"route's logits rel_l2={err:.3e} (limit {F32_MODEL_TOL:g}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        require(ok, f"float32 serve, {route} route: launches {counts[route]} != {want} or "
                f"{above} above the margin or logits rel_l2 {err:.3e}")

    # The float32 pair, which the routing leaves out at float32
    # (cswin_block.PAIR_GEOMETRIES): the first chunk with the bf16 route's
    # pairs forced on at float32, its launches as so routed and its logits
    # equal to the committed route's bit for bit; timed below as fused_pair.
    committed = cswin_block.pair_fuse_ok
    f32_pairs = lambda H, W, C, dtype=None: committed(H, W, C, torch.bfloat16)
    try:
        cswin_block.pair_fuse_ok = f32_pairs
        K.reset_launch_counts()
        torch.cuda.synchronize()
        with torch.inference_mode():
            paired = models["fused"](x)
        torch.cuda.synchronize()
        counts["pair"] = K.launch_counts()
    finally:
        cswin_block.pair_fuse_ok = committed
    with torch.inference_mode():
        unpaired = models["fused"](x)
    want = expected_f32(expected_launches(cfg, 1))
    same = torch.equal(paired, unpaired)
    print(f"[f32:serve] chunk ct64[0:{batch}] with the float32 pair forced on at "
          f"{sorted(g[:3] for g in cswin_block.PAIR_GEOMETRIES)}: launches {counts['pair']} "
          f"expected {want}; logits equal to the committed (unpaired) route's bit for bit: "
          f"{'yes' if same else 'NO'}", flush=True)
    require(same and counts["pair"] == want, "float32 forced-pair chunk")

    def forward(model, pairs=None):
        try:
            if pairs is not None:
                cswin_block.pair_fuse_ok = pairs
            with torch.inference_mode():
                return model(x, emit="labels")
        finally:
            cswin_block.pair_fuse_ok = committed

    runs = {k: (lambda k=k: forward(models[k])) for k in models}
    runs["fused_pair"] = lambda: forward(models["fused"], f32_pairs)
    times = {k: [] for k in runs}
    for r in range(4):
        for k in list(runs)[::1 if r % 2 == 0 else -1]:
            times[k].append(time_ms(runs[k], reps=2, rounds=1))
    busy = {k: device_busy_ms(runs[k], 2) for k in ("fused", "fused_pair", "bf16")}
    print(f"[f32:e2e] forward {batch} slices to labels, tiny-224, ms median [min-max] of 4 "
          f"interleaved rounds: " + "; ".join(
              f"{k} {statistics.median(v):.3f} [{min(v):.3f}-{max(v):.3f}] "
              f"({batch / statistics.median(v) * 1e3:.1f} slices/s)"
              + (f" busy {'not measured' if busy[k] is None else f'{busy[k]:.3f}'}"
                 if k in busy else "")
              for k, v in times.items())
          + f" (fused, plain and pallas at float32, fused_pair with the float32 pair "
          f"forced on; bf16 the committed route); on {smi}; "
          f"phase {time.perf_counter() - t0:.1f}s", flush=True)
    return dict(serve_f32=counts["fused"], serve_f32_pallas=counts["pallas"],
                serve_f32_pair=counts["pair"])


def f32_eval(cfg, dev, ck: str) -> dict[str, int]:
    """test.py's evaluation at ``TPU.COMPUTE_DTYPE float32``: one (48, 512,
    512) organ-like volume through ``eval.inference.inference`` from ``ck``
    on the fused route with device metrics (launches: every one a float32
    instance's as routed, and the EDT passes) and with host metrics, which
    must agree; the plain float32 route's per-class scores printed beside.
    Returns the launch counts of the device-metrics pass."""
    import argparse

    import torch

    from cswin_unet_tpu_torch.eval.inference import VolumeInferencer, inference
    from cswin_unet_tpu_torch.models import build_model
    from cswin_unet_tpu_torch.ops.cuda import kernels as K
    from cswin_unet_tpu_torch.utils.checkpoint import load_checkpoint, load_into

    t_start = time.perf_counter()
    f32cfg = type(cfg)(cfg.to_dict())
    f32cfg.merge_from_list(F32_OPTS)
    f32cfg.freeze()
    nc, img, shape = 9, cfg.DATA.IMG_SIZE, EVAL_SHAPES[0]
    image, label, _ = organ_volume(np.random.default_rng(37), shape, nc)
    db = [dict(image=image, label=label, case_name="case0000")]

    def inferencer(impl=None):
        model = build_model(f32cfg, num_classes=nc, device=dev, impl=impl, seed=1)
        require(load_into(model.cswin_unet, load_checkpoint(ck)[0])
                == len(model.cswin_unet.state_dict()), f"{ck} into the {impl} route")
        return VolumeInferencer(model, device=dev, patch_size=(img, img))

    fused = inferencer()
    require(fused.model.cswin_unet.dtype == torch.float32, "TPU.COMPUTE_DTYPE not taken")
    fused.predict_slices(np.zeros((1, img, img), np.float32))  # warm up
    log = EvalLog()
    root = logging.getLogger()
    saved_handlers, saved_level = root.handlers[:], root.level
    root.handlers[:] = [log]
    root.setLevel(logging.INFO)
    try:
        args = argparse.Namespace(num_classes=nc, img_size=img, z_spacing=1,
                                  device_metrics=True)
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inference(args, fused, db)
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
        counts = K.launch_counts()
        dev_means, n = class_means(log.lines), len(log.lines)
        args.device_metrics = False
        inference(args, fused, db)
        host_means, n = class_means(log.lines[n:]), len(log.lines)
        args.device_metrics = True
        inference(args, inferencer("plain"), db)
        plain_means = class_means(log.lines[n:])
    finally:
        root.handlers[:] = saved_handlers
        root.setLevel(saved_level)
    want = expected_f32(expected_launches(cfg, -(-shape[0] // SERVE_BATCH), "float32"))
    want["edt_pass"] = (nc - 1) * 2 * 3
    ok = counts == want and len(dev_means) == nc - 1 and metrics_agree(dev_means, host_means)
    print(f"[f32:eval] inference() of a {shape} volume at float32, device metrics "
          f"{dev_s:.3f}s; launches {counts} expected {want}; device vs host metrics "
          f"max |diff| {np.abs(dev_means - host_means).max():.3e}; per class dice / hd95, "
          f"fused | plain float32 route (not gated): " + "; ".join(
              f"{c + 1}: {f[0]:.4f}/{f[1]:.2f} | {p[0]:.4f}/{p[1]:.2f}"
              for c, (f, p) in enumerate(zip(dev_means, plain_means)))
          + f"; phase {time.perf_counter() - t_start:.1f}s {'ok' if ok else 'FAIL'}",
          flush=True)
    require(ok, f"float32 eval: launches {counts} != {want} or device {dev_means.tolist()} "
            f"vs host {host_means.tolist()}")
    return counts


def f32_base384(dev, smi: str) -> dict[str, int]:
    """One base-384 32-slice forward at float32 from seeded weights, on
    the fused route against the plain float32 route: logits within
    ``F32_MODEL_TOL``, labels by the margin rule, every launch a float32
    instance's as routed; both forwards timed."""
    import torch

    from cswin_unet_tpu_torch.models import build_model
    from cswin_unet_tpu_torch.ops.cuda import kernels as K

    t0 = time.perf_counter()
    cfg = smoke_config(F32_OPTS, cfg=CFG384)
    img, batch = cfg.DATA.IMG_SIZE, SERVE_BATCH
    fused = build_model(cfg, num_classes=9, device=dev, seed=0)
    plain = build_model(cfg, num_classes=9, device=dev, seed=0, impl="plain")
    x = torch.from_numpy(np.random.default_rng(33).standard_normal(
        (batch, img, img, 1)).astype(np.float32)).to(dev)
    with torch.inference_mode():
        ref = plain(x)
        K.reset_launch_counts()
        torch.cuda.synchronize()
        logits = fused(x)
        torch.cuda.synchronize()
        counts = K.launch_counts()
        labels = fused(x, emit="labels")
    want = expected_f32(expected_launches(cfg, 1, "float32"))
    err = rel_l2(logits, ref)
    raw, above = margin_mismatches(labels, ref)
    ok = err <= F32_MODEL_TOL and above == 0 and counts == want
    print(f"[f32:base384] forward {batch} slices at float32: logits rel_l2={err:.3e} (limit "
          f"{F32_MODEL_TOL:g}), labels mismatches={raw}/{labels.numel()} above_margin={above}; "
          f"launches {counts} expected {want} {'ok' if ok else 'FAIL'}", flush=True)
    require(ok, f"base-384 float32 forward: rel_l2 {err:.3e}, {above} above the margin, "
            f"launches {counts}")

    def forward(model):
        with torch.inference_mode():
            return model(x, emit="labels")

    times = {"fused": [], "plain": []}
    for r in range(2):
        for k in list(times)[::1 if r % 2 == 0 else -1]:
            times[k].append(time_ms(lambda: forward(fused if k == "fused" else plain),
                                    reps=1, rounds=1))
    print(f"[f32:base384:e2e] forward {batch} slices to labels at float32, ms median "
          f"[min-max] of 2 interleaved rounds: " + "; ".join(
              f"{k} {statistics.median(v):.3f} [{min(v):.3f}-{max(v):.3f}]"
              for k, v in times.items()) + f"; on {smi}; phase "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 6: train
# ---------------------------------------------------------------------------

def trained_blocks(cfg) -> list[tuple[dict, int]]:
    """Each stage geometry with its blocks (encoder and decoder), every one
    of which trains through ``CSWinBlockFn``."""
    return [(g, 2 * g["depth"]) for g in stage_geometries(cfg)]


def expected_train_launches(cfg, steps: int) -> dict[str, int]:
    """Kernel launches of ``steps`` train steps: every block trains through
    ``CSWinBlockFn`` (``trained_blocks``) and runs
    the kernel chain, 2 LN and 4 GEMMs forward, 2 LN backward, 4 dX products
    and 4 weight gradients, and a forward and a backward attention launch a
    branch (2 in a dual-branch block, 1 at the last stage); the fused CARAFE
    sites (upsamplers at resolution >= 28, and
    the tail) one GEMM and one CARAFE launch forward and the composition's
    vjp backward."""
    routed = branches = 0
    for g, n in trained_blocks(cfg):
        routed += n
        branches += n * (1 if g["last"] else 2)
    sites = len(carafe_sites(cfg))
    per = dict(layernorm=2 * routed, gemm=4 * routed + sites,
               stripe_attention=branches, carafe_reassemble=sites,
               layernorm_bwd=2 * routed, gemm_dgrad=4 * routed,
               gemm_wgrad=4 * routed, stripe_attention_bwd=branches)
    return {k: per.get(k, 0) * steps for k in SOURCES}


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


def train_run(cfg, dev, workdir: str) -> tuple[dict[str, int], str, str]:
    """The port's trainer_synapse for 2 epochs (4 steps at bs 24) on
    synthetic slices; checks launch counts, log lines and the checkpoint,
    then serves one volume from ``epoch_1.npz``."""
    import argparse

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
    resume_run(cfg, dev, args, steps)
    return counts, data, ck


def resume_run(cfg, dev, args, steps: int) -> None:
    """``--resume``: a fresh model continues the finished run from the
    ``train_state.pt`` in its output directory for one more epoch (the
    trainer's ``args.resume``, as the CLI passes it): it starts at the saved
    iteration and epoch, logs the next iterations, launches one epoch's
    kernels and writes its own checkpoint and train state."""
    import argparse

    import torch

    from cswin_unet_tpu_torch.models import build_model
    from cswin_unet_tpu_torch.ops.cuda import kernels as K
    from cswin_unet_tpu_torch.train import trainer_synapse
    from cswin_unet_tpu_torch.utils.checkpoint import TRAIN_STATE

    epochs = args.max_epochs
    out_dir = os.path.join(os.path.dirname(args.output_dir), "run_resumed")
    rargs = argparse.Namespace(**dict(vars(args), max_epochs=epochs + 1,
                                      resume=args.output_dir, output_dir=out_dir))
    model = build_model(cfg, num_classes=args.num_classes, device=dev, seed=9, train=True)
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    require(trainer_synapse(rargs, model, out_dir) == "Training Finished!", "resumed trainer")
    torch.cuda.synchronize()
    counts, per_epoch = K.launch_counts(), steps // epochs
    want = expected_train_launches(cfg, per_epoch)
    with open(os.path.join(out_dir, "log.txt")) as f:
        log = f.read()
    its = re.findall(r"iteration (\d+) : loss : (\S+), loss_ce: (\S+)", log)
    state = torch.load(os.path.join(out_dir, TRAIN_STATE), weights_only=True)
    print(f"[train] resumed from {args.output_dir}: "
          f"{'starts at' if f'at iteration {steps} (epoch {epochs})' in log else 'MISSES'} "
          f"iteration {steps} (epoch {epochs}); logged iterations {[int(i) for i, _, _ in its]} "
          f"losses {[float(a) for _, a, _ in its]} in {time.perf_counter() - t0:.1f}s; "
          f"launches {counts} expected {want}; its train state: iteration "
          f"{state['iteration']}, epoch {state['epoch']}", flush=True)
    require(f"at iteration {steps} (epoch {epochs})" in log, "resume did not start at the "
            "saved iteration")
    require([int(i) for i, _, _ in its] == list(range(steps + 1, steps + per_epoch + 1))
            and all(np.isfinite(float(a)) for _, a, _ in its), f"resumed log lines {its}")
    require(counts == want, f"resumed run: launches {counts} != {want}")
    require(os.path.exists(os.path.join(out_dir, f"epoch_{epochs}.npz"))
            and (state["iteration"], state["epoch"]) == (steps + per_epoch, epochs + 1),
            f"resumed run's checkpoint / train state {state['iteration']}, {state['epoch']}")


def grad_parity(phase: str, what: str, kernel, plain, plain_f32, *,
                widen_weights: bool = False) -> None:
    """The loss and every parameter gradient of the kernel route against the
    plain route, each a (loss, {name: gradient}) pair (``plain_f32``: the
    plain route in float32). Every gradient is held to TOL; only a bias
    gradient (a cancellation-dominated sum) whose plain bf16 route is
    itself that far from float32 gets a wider bound: twice the plain route's
    own bf16 error (bench.py:382-388), printed beside that measurement.
    ``widen_weights``: any gradient may take that bound, for a loss whose
    gradients the bf16 forward itself moves beyond TOL (the continual loss:
    its focal term at gamma 4 and the KD term)."""
    import torch

    (loss_k, g_k), (loss_p, g_p), (loss_f, g_f) = kernel, plain, plain_f32
    torch.cuda.synchronize()
    loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    errs = {k: rel_l2(g_k[k], g_p[k]) for k in g_p}
    floor = {k: rel_l2(g_p[k], g_f[k]) for k in g_p}  # plain bf16 vs plain f32
    bound = {k: max(TOL, 2 * floor[k]) if widen_weights or k.endswith(".bias") else TOL
             for k in g_p}
    widened = {k: f"bound {bound[k]:.3e} (bf16-vs-f32 {floor[k]:.3e})"
               for k in bound if bound[k] > TOL}
    worst = max(errs, key=errs.get)
    over = {k: (f"{errs[k]:.3e}", f"bf16-vs-f32 {floor[k]:.3e}")
            for k in errs if errs[k] > TOL}
    bad = [k for k in errs if errs[k] > bound[k] or not np.isfinite(errs[k])]
    print(f"[{phase}] grad parity, {what}: loss kernel "
          f"{float(loss_k):.6f} plain {float(loss_p):.6f} f32 {float(loss_f):.6f} "
          f"(rel {loss_err:.2e}); {len(errs)} gradients, worst {worst} rel_l2="
          f"{errs[worst]:.3e} (plain bf16 vs f32 there {floor[worst]:.3e}); "
          f"above {TOL}: {over or 'none'}; widened "
          f"{'bounds' if widen_weights else 'bias bounds'}: {widened or 'none'}", flush=True)
    require(loss_err <= TOL and not bad, f"{phase} gradient parity: loss {loss_err:.3e}, "
            f"beyond bound {[(k, errs[k], bound[k]) for k in bad]}")


def fixed_batch(data: str, dev):
    """The first ``TRAIN_BATCH`` slices of ``data`` at 224 (image, label) on
    ``dev``."""
    import torch

    from cswin_unet_tpu_torch.data import EvalResize, SynapseDataset

    ds = SynapseDataset(os.path.join(data, "train_npz"), os.path.join(data, "lists"),
                        "train", transform=EvalResize([224, 224]))
    samples = [ds[i] for i in range(TRAIN_BATCH)]
    return tuple(torch.from_numpy(np.stack([s[k] for s in samples])).to(dev)
                 for k in ("image", "label"))


def route_grads(cfg, dev, img, lab, impl: str, dtype, nc: int = 9):
    """(loss, {name: gradient}) of one train-mode forward and backward of
    ``segmentation_loss`` on ``impl`` in ``dtype``: weights from seed 3,
    drop-path and dropout draws from a generator seeded 11."""
    import torch

    from cswin_unet_tpu_torch.losses import segmentation_loss
    from cswin_unet_tpu_torch.models import build_model

    model = build_model(cfg, num_classes=nc, device=dev, impl=impl, dtype=dtype, seed=3,
                        train=True)
    gen = torch.Generator(device=dev).manual_seed(11)
    loss, _ = segmentation_loss(model(img, generator=gen), lab, nc)
    names, params = zip(*model.named_parameters())
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss, params)))


def train_step_checks(cfg, dev, data: str) -> None:
    """On one fixed batch of 24 slices: loss and gradients of the kernel
    route against the plain route, one step's launch counts, 10 steps with
    falling loss, and the train-step time of both routes."""
    import torch

    from cswin_unet_tpu_torch.models import build_model
    from cswin_unet_tpu_torch.ops.cuda import kernels as K
    from cswin_unet_tpu_torch.train import make_optimizer, make_train_step

    nc = 9
    img, lab = fixed_batch(data, dev)
    grad_parity("train", f"fixed batch of {TRAIN_BATCH}",
                *(route_grads(cfg, dev, img, lab, impl, dtype) for impl, dtype in (
                    ("fused", torch.bfloat16), ("plain", torch.bfloat16),
                    ("plain", torch.float32))))

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


def dropout_masks(dev, M: int, C: int, rows_wgrad: int = 2048) -> dict[str, bool]:
    """Each GEMM's dropout mask at a block's shapes (M rows, width C, hidden
    4C; rate DROP_RATE, a rank's row offset), read from an output that it
    alone decides, against ``ops.dropout.keep_mask``'s bits: the fc1 GELU
    and fc2 residual epilogues (zero products, bias 1), the fc2 dX product's
    mask on its output (products of ones) and on dY (an identity weight),
    and the weight gradient's on dY (an identity X, ``rows_wgrad`` rows).
    {kernel site: equal bit for bit}."""
    import torch

    from cswin_unet_tpu_torch.ops import dropout as D
    from cswin_unet_tpu_torch.ops.cuda import kernels as K

    bf, N = torch.bfloat16, 4 * C
    d1, d2 = dropout_sites(dev, 23, row0=M)
    mask = lambda d, rows, cols: D.keep_mask(d.key, d.row0, rows, cols, d.rate)
    z, one = dict(dtype=bf, device=dev), torch.ones((), dtype=bf, device=dev)
    a0 = torch.zeros(M, 64, **z)
    out = {}
    out["gemm fc1 GELU epilogue"] = K.gemm(
        a0, torch.zeros(N, 64, **z), torch.ones(N, device=dev), epilogue="gelu",
        drop=d1) != 0
    out["gemm fc2 residual epilogue"] = K.gemm(
        a0, torch.zeros(C, 64, **z), torch.ones(C, device=dev),
        residual=torch.zeros(M, C, **z), epilogue="residual", drop=d2) != 0
    ones = one.expand(M, C).contiguous()
    out["gemm_dgrad output (fc1 site)"] = K.gemm_dgrad(
        ones, torch.ones(C, N, device=dev), gelu_h=torch.full((M, N), 10.0, **z),
        drop_dx=d1) != 0
    out["gemm_dgrad dY (fc2 site)"] = K.gemm_dgrad(
        ones, torch.eye(C, device=dev), gelu_h=torch.full((M, C), 10.0, **z),
        drop_dy=d2) != 0
    r = rows_wgrad
    e = dropout_sites(dev, 23, row0=M + r)[1]
    dw, _ = K.gemm_wgrad(torch.eye(r, **z), one.expand(r, C).contiguous(), drop=e)
    out["gemm_wgrad dY (fc2 site)"] = dw.t() != 0
    want = {"gemm fc1 GELU epilogue": mask(d1, M, N), "gemm fc2 residual epilogue":
            mask(d2, M, C), "gemm_dgrad output (fc1 site)": mask(d1, M, N),
            "gemm_dgrad dY (fc2 site)": mask(d2, M, C),
            "gemm_wgrad dY (fc2 site)": mask(e, r, C)}
    return {k: bool(torch.equal(out[k], want[k])) for k in want}


def dropout_run(cfg, dev, workdir: str, data: str, smi: str) -> dict[str, int]:
    """``--opts MODEL.DROP_RATE 0.1`` at tiny-224 width and depth: the train
    CLI (its ``main``, in this process) for one epoch of 2 steps at bs 24,
    its launches as routed (every block through ``CSWinBlockFn``, the masks
    in its GEMMs: no launch more than at rate 0); the kernel route's loss
    and gradients against the plain route with the same generator
    (``grad_parity``); the kernels' masks against the plain function's bits
    at stage 1's shapes; the train step's ms and device busy at rate 0.1
    beside rate 0. Returns the CLI's launches."""
    import torch

    from cswin_unet_tpu_torch.models import build_model
    from cswin_unet_tpu_torch.models.cswin_unet import dropout_keys
    from cswin_unet_tpu_torch.ops import dropout as D
    from cswin_unet_tpu_torch.ops.cuda import kernels as K
    from cswin_unet_tpu_torch.train import make_optimizer, make_train_step
    from cswin_unet_tpu_torch.train.__main__ import main as train_main
    from cswin_unet_tpu_torch.utils.profiling import device_busy_ms

    t_phase = time.perf_counter()
    dcfg = smoke_config(DROP_OPTS)
    cli = os.path.join(workdir, "dropout_cli")
    os.makedirs(os.path.join(cli, "lists", "lists_Synapse_blurred"))
    shutil.copy(os.path.join(data, "lists", "train.txt"),
                os.path.join(cli, "lists", "lists_Synapse_blurred", "train.txt"))
    argv = ["--cfg", CFG, "--root_path", data, "--dataset", "Synapse", "--output_dir", "run",
            "--max_epochs", "1", "--batch_size", str(TRAIN_BATCH), "--img_size", "224",
            "--num_workers", "8", "--device", dev.type, "--opts", *DROP_OPTS]
    here = os.getcwd()
    os.chdir(cli)  # the CLI reads ./lists/lists_Synapse_blurred, as the root train.py
    try:
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        require(train_main(argv) == "Training Finished!", "train CLI at dropout 0.1")
        torch.cuda.synchronize()
        cli_s, counts = time.perf_counter() - t0, K.launch_counts()
    finally:
        os.chdir(here)
    with open(os.path.join(cli, "run", "log.txt")) as f:
        log = f.read()
    its = re.findall(r"iteration (\d+) : loss : (\S+), loss_ce: (\S+)", log)
    steps = len(os.listdir(os.path.join(data, "train_npz"))) // TRAIN_BATCH
    want = expected_train_launches(dcfg, steps)
    print(f"[dropout] python -m cswin_unet_tpu_torch.train --opts MODEL.DROP_RATE "
          f"{DROP_RATE}: {steps} steps in {cli_s:.1f}s, logged iterations "
          f"{[int(i) for i, _, _ in its]} losses {[float(a) for _, a, _ in its]}; launches "
          f"{counts} expected {want}", flush=True)
    require([int(i) for i, _, _ in its] == list(range(1, steps + 1))
            and all(np.isfinite(float(a)) for _, a, _ in its), f"dropout CLI log {its}")
    require(counts == want, f"dropout CLI launches {counts} != routing {want}")

    img, lab = fixed_batch(data, dev)
    grad_parity("dropout", f"rate {DROP_RATE}, fixed batch of {TRAIN_BATCH}",
                *(route_grads(dcfg, dev, img, lab, impl, dtype) for impl, dtype in (
                    ("fused", torch.bfloat16), ("plain", torch.bfloat16),
                    ("plain", torch.float32))))
    g = next(stage_geometries(cfg))
    M = TRAIN_BATCH * g["H"] * g["H"]
    bits = dropout_masks(dev, M, g["C"])
    print(f"[dropout] the kernels' masks at stage 1 (M {M}, C {g['C']}, hidden "
          f"{4 * g['C']}, rows offset by M) vs ops.dropout.keep_mask, bit for bit: "
          f"{'; '.join(k + (' yes' if v else ' NO') for k, v in bits.items())}", flush=True)
    require(all(bits.values()), f"kernel dropout masks differ from the plain bits: {bits}")

    def trainer(c):
        model = build_model(c, num_classes=9, device=dev, seed=3, train=True)
        opt, sched = make_optimizer(model.parameters(), 0.01, 1000)
        gen = torch.Generator(device=dev).manual_seed(12)
        step = make_train_step(model, opt, sched, 9)
        return lambda: step(img, lab, gen)

    s0, s1 = trainer(cfg), trainer(dcfg)
    a1, b1, b2, a2 = (time_ms(fn, reps=4, rounds=3) for fn in (s0, s1, s1, s0))
    busy = [device_busy_ms(fn, 3) for fn in (s0, s1)]
    fmt = lambda v: "unread" if v is None else f"{v:.3f}"
    print(f"[dropout] train step bs {TRAIN_BATCH} (fwd + bwd + SGD), kernel route, CUDA "
          f"events in turns (rate 0, {DROP_RATE}, {DROP_RATE}, 0): rate 0 "
          f"ms={min(a1, a2):.3f} [{a1:.3f}, {a2:.3f}] busy {fmt(busy[0])} ms; rate "
          f"{DROP_RATE} ms={min(b1, b2):.3f} [{b1:.3f}, {b2:.3f}] busy {fmt(busy[1])} ms; on "
          f"{smi}", flush=True)

    # The step's added work outside the GEMMs: the stem's mask (torch ops on
    # the stem's output) and the keys (one draw a block, one for the stem).
    xs = torch.randn(TRAIN_BATCH, g["H"], g["H"], g["C"], device=dev).to(torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(5)
    site = dropout_keys(1, DROP_RATE, xs, gen)[0]
    blocks = sum(n for _, n in trained_blocks(cfg))

    def host_ms(fn, n=10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    stem_dev = time_ms(lambda: D.dropout(xs, site), primed=True)
    stem_host = host_ms(lambda: D.dropout(xs, site))
    keys_host = host_ms(lambda: [dropout_keys(2, DROP_RATE, xs, gen) for _ in range(blocks)])
    print(f"[dropout] a step's work outside the GEMMs: the stem's mask on {tuple(xs.shape)} "
          f"(torch ops) device ms={stem_dev:.3f} (behind the spin kernel), {stem_host:.3f} ms "
          f"a synchronised call; the {blocks} blocks' key draws {keys_host:.3f} ms a step "
          f"(synchronised); phase seconds {time.perf_counter() - t_phase:.1f}", flush=True)
    return counts


def finetune_run(cfg, dev, workdir: str, smi: str) -> dict[str, int]:
    """The legacy grid, ``python -m cswin_unet_tpu_torch.finetune --device
    cuda`` (its ``main``, in this process), for one (lr, wd) cell and one
    epoch on 120 synthetic 224x224 slices (its 1/5 subset: one batch of 24)
    from the serve phase's seeded checkpoint: its launches (the step and
    the RGN grad pass, each a train step's), its log and checkpoint; then
    on one fixed batch the RGN group weights and the RGN-weighted gradients
    of its loss on the kernel route against the plain route (``grad_parity``).
    Returns the CLI's launches."""
    import torch

    from cswin_unet_tpu_torch import finetune
    from cswin_unet_tpu_torch.losses import cross_entropy_loss, dice_loss
    from cswin_unet_tpu_torch.models import build_model
    from cswin_unet_tpu_torch.ops.cuda import kernels as K
    from cswin_unet_tpu_torch.train import finetune as ft
    from cswin_unet_tpu_torch.train import surgical
    from cswin_unet_tpu_torch.utils.checkpoint import load_checkpoint, load_into

    t_phase = time.perf_counter()
    nc, slices = 9, 5 * TRAIN_BATCH
    root = os.path.join(workdir, "finetune")
    list_dir = write_train_slices(root, slices, 224, nc, seed=31)
    ck = os.path.join(workdir, "tiny224_seed0.npz")
    out = os.path.join(root, "run")
    grid = ft.LR_WD_GRID
    ft.LR_WD_GRID = grid[:1]
    try:
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = finetune.main(["--cfg", CFG, "--root_path", os.path.join(root, "train_npz"),
                             "--list_dir", list_dir, "--output_dir", out, "--max_epochs", "1",
                             "--batch_size", str(TRAIN_BATCH), "--img_size", "224",
                             "--pretrained_ckpt", ck, "--save_interval", "1",
                             "--device", dev.type])
        torch.cuda.synchronize()
        cli_s, counts = time.perf_counter() - t0, K.launch_counts()
    finally:
        ft.LR_WD_GRID = grid
    lr, wd = grid[0]
    with open(os.path.join(out, "log.txt")) as f:
        log = f.read()
    losses = [float(v) for v in re.findall(r"Loss: (\S+)", log)]
    saved = os.path.join(out, f"model_lr{lr}_wd{wd}_epoch0.npz")
    steps = slices // 5 // TRAIN_BATCH
    want = expected_train_launches(cfg, 2 * steps)
    print(f"[finetune] python -m cswin_unet_tpu_torch.finetune --device {dev.type}, cell "
          f"(lr {lr}, wd {wd}), 1 epoch: {res!r} in {cli_s:.1f}s, {len(losses)} steps, "
          f"losses {losses}, {os.path.basename(saved)} "
          f"{'written' if os.path.exists(saved) else 'MISSING'}; launches {counts} expected "
          f"{want} (a step and an RGN grad pass each)", flush=True)
    require(res == "Surgical Training Finished!" and len(losses) == steps
            and all(np.isfinite(losses)) and os.path.exists(saved), "finetune CLI")
    require(counts == want, f"finetune launches {counts} != routing {want}")

    img, lab = fixed_batch(root, dev)
    flat = load_checkpoint(ck)[0]

    def seg(logits, labels):
        return 0.2 * cross_entropy_loss(logits, labels) + 0.8 * dice_loss(logits, labels, nc)

    def route(impl, dtype):
        model = build_model(cfg, num_classes=nc, device=dev, impl=impl, dtype=dtype,
                            seed=1234, train=True)
        load_into(model.cswin_unet, flat)
        params = surgical.backbone_params(model)
        gw = surgical.get_group_lr_weights(model, {"image": img, "label": lab}, seg)
        top = max(gw.values())
        pw = surgical.group_weights_to_param_weights(params, {k: v / top for k, v in
                                                              gw.items()})
        gen = torch.Generator(device=dev).manual_seed(1234)
        loss = seg(model(img, generator=gen), lab)
        grads = torch.autograd.grad(loss, list(params.values()))
        return ((loss.detach(), {k: g * pw[k] for k, g in zip(params, grads)}),
                torch.tensor([gw[k] for k in sorted(gw)], dtype=torch.float64))

    kernel, plain, f32 = (route("fused", torch.bfloat16), route("plain", torch.bfloat16),
                          route("plain", torch.float32))
    err, floor = rel_l2(kernel[1], plain[1]), rel_l2(plain[1], f32[1])
    print(f"[finetune] RGN group weights: {kernel[1].numel()} groups, kernel vs plain "
          f"rel_l2={err:.3e} (plain bf16 vs f32 {floor:.3e}) "
          f"{'ok' if err <= TOL else 'FAIL'}", flush=True)
    require(err <= TOL, f"finetune RGN weights: rel_l2 {err:.3e}")
    grad_parity("finetune", f"RGN-weighted gradients of 0.2·CE + 0.8·Dice, fixed batch of "
                f"{TRAIN_BATCH}", kernel[0], plain[0], f32[0])
    print(f"[finetune] phase seconds {time.perf_counter() - t_phase:.1f} ({smi})", flush=True)
    return counts


def f32_backward_kernels(cfg, dev, B: int, tally: KernelTally) -> None:
    """Each float32 backward instance, and the forward GEMM's float32
    training epilogues, at every training geometry of ``cfg`` (batch B),
    against its plain float32 version within ``F32_TOL`` (a
    float32 sum over M, dW, db, dγ, dβ and the LePE partials, by
    ``judge_reduction``'s float64 rule), weighted by its calls in one train
    step, each timed behind the lab's spin kernel (device time). Bounds:
    bytes at 3.35 TB/s or the operations at 67 TFLOP/s of float32 FFMA.
    Yardsticks (timed here only): cuBLAS float32 with TF32 off
    (``torch.matmul``) for the plain dX and dW products, aten's LayerNorm
    backward; none for the attention backward (flash has no LePE and no
    float32)."""
    import torch

    from cswin_unet_tpu_torch.ops.cuda import kernels as K

    rng = np.random.default_rng(23)
    rnd = lambda *s, sc=1.0: torch.from_numpy(
        (rng.standard_normal(s) * sc).astype(np.float32)).to(dev)
    kw_t = dict(tol=F32_TOL, reps=3, rounds=3, primed=True)
    for g, blocks in trained_blocks(cfg):
        H, C, heads, split = g["H"], g["C"], g["heads"], g["split"]
        M, hw = B * H * H, H * H
        tag = f"@{H}x{H}x{C}{' last' if g['last'] else ''}"
        dp = torch.from_numpy((rng.random(B) < 0.8).astype(np.float32) / 0.8).to(dev)
        x, dy, res = rnd(M, C), rnd(M, C), rnd(M, C)
        w, b = rnd(C, sc=0.3) + 1, rnd(C, sc=0.1)

        def ln_oracle(x=x, dy=dy):
            x64, dy64 = x.double(), dy.double()
            mu = x64.mean(-1, keepdim=True)
            xh = (x64 - mu) * torch.rsqrt(((x64 - mu) ** 2).mean(-1, keepdim=True) + 1e-5)
            return None, (dy64 * xh).sum(0), dy64.sum(0)

        _, mean, rstd = torch.ops.aten.native_layer_norm(x, [C], w, b, 1e-5)
        tally.case("layernorm_bwd_f32", tag,
                   lambda: K.layernorm_bwd(x, dy, w, residual=res),
                   lambda: K.layernorm_bwd_plain(x, dy, w, residual=res), 2 * blocks,
                   moved=4 * nbytes(x) + 3 * nbytes(w), f32_ops=14 * M * C,
                   library=lambda: torch.ops.aten.native_layer_norm_backward(
                       dy, x, [C], mean, rstd, w, b, [True, True, True]),
                   oracle=ln_oracle, **kw_t)
        h = rnd(M, 4 * C)
        # The forward GEMM's float32 training epilogues: fc1 keeping its
        # pre-activation (both outputs held), proj and fc2 with the
        # drop-path scale; timed with the serving cases, so no calls here.
        pre_k, pre_p = (torch.empty(M, 4 * C, device=dev) for _ in range(2))
        for what, a, n, epi, kw in (
                ("proj+droppath", x, C, "residual", dict(residual=res, dp=dp)),
                ("fc1-gelu-keep-h", x, 4 * C, "gelu", {}),
                ("fc2+droppath", h, C, "residual", dict(residual=res, dp=dp))):
            wt, bias = rnd(n, a.shape[1], sc=a.shape[1] ** -0.5), rnd(n, sc=0.1)
            kw = dict(kw, epilogue=epi, rows_per_sample=hw)
            if epi == "gelu":
                kern = lambda: (K.gemm(a, wt, bias, pre=pre_k, **kw), pre_k)
                plain = lambda: (K.gemm_plain(a, wt, bias, pre=pre_p, **kw), pre_p)
            else:
                kern = lambda: K.gemm(a, wt, bias, **kw)
                plain = lambda: K.gemm_plain(a, wt, bias, **kw)
            tally.case("gemm_f32", f"train-{what}{tag}", kern, plain, 0,
                       moved=nbytes(a, wt, bias, kw.get("residual"), kw.get("dp"))
                       + M * n * (8 if epi == "gelu" else 4),
                       f32_ops=2 * M * n * a.shape[1], **kw_t)
        for what, n, k, kw in (("fc2-gelu_bwd+droppath", C, 4 * C, dict(dp=dp, gelu_h=h)),
                               ("fc1", 4 * C, C, {}),
                               ("proj+droppath", C, C, dict(dp=dp)),
                               ("qkv", 3 * C, C, {})):
            d, wt = rnd(M, n), rnd(n, k, sc=n ** -0.5)
            plain_product = not kw
            kw = dict(kw, rows_per_sample=hw)
            tally.case("gemm_dgrad_f32", f"{what}{tag}",
                       lambda: K.gemm_dgrad(d, wt, **kw),
                       lambda: K.gemm_dgrad_plain(d, wt, **kw), blocks,
                       moved=nbytes(d, wt, kw.get("gelu_h"), kw.get("dp")) + M * k * 4,
                       f32_ops=2 * M * n * k + M * k * (16 if "gelu_h" in kw else 1),
                       library=(lambda: torch.matmul(d, wt)) if plain_product else None,
                       **kw_t)
        for what, k, n, kw in (("fc2+droppath", 4 * C, C, dict(dp=dp)),
                               ("fc1", C, 4 * C, {}),
                               ("proj+droppath", C, C, dict(dp=dp)),
                               ("qkv", C, 3 * C, {})):
            a, d = rnd(M, k), rnd(M, n)
            plain_product = not kw
            kw = dict(kw, rows_per_sample=hw)

            def wgrad_oracle(a=a, d=d, kw=kw):
                d64 = d.double()
                if "dp" in kw:
                    d64 = d64 * kw["dp"].double().repeat_interleave(hw)[:, None]
                return d64.t() @ a.double(), d64.sum(0)

            tally.case("gemm_wgrad_f32", f"{what}{tag}",
                       lambda: K.gemm_wgrad(a, d, **kw),
                       lambda: K.gemm_wgrad_plain(a, d, **kw), blocks,
                       moved=nbytes(a, d, kw.get("dp")) + (n * k + n) * 4,
                       f32_ops=2 * M * n * k + M * n,
                       library=(lambda: torch.matmul(d.t(), a)) if plain_product else None,
                       oracle=wgrad_oracle, **kw_t)
        f32_attention_bwd_cases(tally, dev, rnd, B, H, C, heads, split, g["last"], blocks, tag,
                                kw_t)


def f32_attention_bwd_cases(tally: KernelTally, dev, rnd, B: int, H: int, C: int, heads: int,
                            split: int, last: bool, calls: int, tag: str, kw_t: dict) -> None:
    """The float32 ``stripe_attention_bwd`` on both branches of a stage (the
    last stage's one full window) against its plain float32 version: dq, dk,
    dv within ``F32_TOL``, the LePE partials by the float64 rule; ``calls``
    times a step. Timed: the wrapper's call alone, into a buffer allocated
    once."""
    import torch

    from cswin_unet_tpu_torch.ops.cuda import kernels as K
    from cswin_unet_tpu_torch.ops.windows import window_partition

    qkv, dout = rnd(B, H, H, 3 * C), rnd(B, H, H, C)
    scale = (C // heads) ** -0.5
    cb, nh = (C, heads) if last else (C // 2, heads // 2)
    M = B * H * H
    buf = torch.zeros(B, H, H, 3 * C, device=dev)
    for off, hs, ws in ([(0, H, H)] if last else [(0, H, split), (C // 2, split, H)]):
        lw = rnd(cb, 1, 3, 3, sc=0.3)
        kw = dict(ch_off=off, heads=nh, h_sp=hs, w_sp=ws, scale=scale)
        chans = torch.cat([torch.arange(off, off + cb) + i * C for i in range(3)]).to(dev)

        def run(fn):
            dqkv = torch.zeros(B, H, H, 3 * C, device=dev)
            dw, db = fn(qkv, dout, lw, dqkv, **kw)
            return dqkv[..., chans], dw, db

        def oracle(off=off, hs=hs, ws=ws):
            v = qkv[..., 2 * C + off:2 * C + off + cb].double()
            do = dout[..., off:off + cb].double()
            v_img = window_partition(v, hs, ws).reshape(-1, hs, ws, cb)
            do_img = window_partition(do, hs, ws).reshape(-1, hs, ws, cb)
            v_pad = torch.nn.functional.pad(v_img, (0, 0, 1, 1, 1, 1))
            dw = torch.stack([(do_img * v_pad[:, a:a + hs, b:b + ws]).sum((0, 1, 2))
                              for a in range(3) for b in range(3)], dim=-1)
            return None, dw.reshape(cb, 1, 3, 3), do_img.sum((0, 1, 2))

        L = hs * ws
        tally.case("stripe_attention_bwd_f32", f"{tag} window {hs}x{ws}",
                   lambda: run(K.stripe_attention_bwd),
                   lambda: run(K.stripe_attention_bwd_plain), calls,
                   timed=(lambda: K.stripe_attention_bwd(qkv, dout, lw, buf, **kw),
                          lambda: K.stripe_attention_bwd_plain(qkv, dout, lw, buf, **kw)),
                   moved=M * cb * 4 * 7 + nbytes(lw) + 10 * cb * 4,
                   f32_ops=10 * M * L * cb + M * nh * 8 * L + 36 * M * cb,
                   oracle=oracle, **kw_t)


def f32_conv_check(dev) -> None:
    """The TF32 trap, on the card: one float32 convolution's weight gradient
    (a merge's 3x3 stride-2 conv at tiny-224's stage 1, B = 8) against
    float64, with cuDNN's TF32 flag at PyTorch's default (True): the stock
    ``F.conv2d``'s backward runs in TF32, the port's
    ``ops.precision.conv2d`` in full float32."""
    import torch

    from cswin_unet_tpu_torch.ops.precision import conv2d

    rng = np.random.default_rng(29)
    t = lambda *s, sc=1.0: torch.from_numpy(
        (rng.standard_normal(s) * sc).astype(np.float32)).to(dev)
    x, w, gy = t(8, 64, 56, 56), t(128, 64, 3, 3, sc=0.05), t(8, 128, 28, 28)
    w64 = w.double().requires_grad_()
    want = torch.autograd.grad(torch.nn.functional.conv2d(x.double(), w64, None, 2, 1), w64,
                               gy.double())[0]
    torch.backends.cudnn.allow_tf32 = True
    try:
        errs = {}
        for name, fn in (("F.conv2d", torch.nn.functional.conv2d), ("port conv2d", conv2d)):
            wl = w.clone().requires_grad_()
            gw = torch.autograd.grad(fn(x, wl, None, 2, 1), wl, gy)[0]
            errs[name] = rel_l2(gw, want)
        flag = torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False
    ok = errs["port conv2d"] <= F32_TOL and flag
    print(f"[f32:train] a float32 conv's weight gradient vs float64, cuDNN TF32 flag at its "
          f"default (True): " + "; ".join(f"{k} rel_l2={v:.3e}" for k, v in errs.items())
          + f" (limit {F32_TOL:g} for the port's; the flag still True after: {flag}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    require(ok, f"float32 conv weight gradient: {errs}")


PLAIN_VERSIONS = ("layernorm_plain", "gemm_plain", "stripe_attention_plain",
              "carafe_reassemble_plain", "layernorm_bwd_plain", "gemm_dgrad_plain",
              "gemm_wgrad_plain", "stripe_attention_bwd_plain")


def plain_calls(K, fn):
    """Run ``fn`` with each kernel wrapper's plain version counted: the
    calls a run makes to them (a wrapper takes its plain version only for a
    CPU tensor). Returns (fn's result, {name: calls})."""
    calls = dict.fromkeys(PLAIN_VERSIONS, 0)
    saved = {n: getattr(K, n) for n in PLAIN_VERSIONS}

    def counted(name):
        def wrapper(*a, **k):
            calls[name] += 1
            return saved[name](*a, **k)
        return wrapper

    for n in PLAIN_VERSIONS:
        setattr(K, n, counted(n))
    try:
        return fn(), calls
    finally:
        for n, f in saved.items():
            setattr(K, n, f)


def f32_train(cfg, dev, workdir: str, data: str, kits: dict, smi: str,
              tally: KernelTally) -> dict[str, dict[str, int]]:
    """Training at ``TPU.COMPUTE_DTYPE float32`` on the card: the float32
    backward instances against their plain versions (``[f32:kernel]``), the
    TF32 trap on one conv, the train CLI at ``--opts TPU.COMPUTE_DTYPE
    float32`` (tiny-224, full width and depth, bs 24, one epoch of 2 steps:
    launches all float32 instances as routed, no plain version called, the
    log), the kernel route's loss and gradients against the plain float32
    route on one fixed batch (``F32_MODEL_TOL`` a parameter, the loss within
    ``F32_TOL``), ``finetune.main`` for one step at float32,
    ``universal_train.main`` for one stage-1 epoch at float32 (every launch a
    float32 instance's), one base-384 float32 step at B = 2 (launches as
    routed) with its stage-3 attention backward held to its plain version,
    and the bs-24 step's ms and device busy at float32 beside bf16's.
    Returns the four runs' launches."""
    import torch

    from cswin_unet_tpu_torch import finetune, universal_train
    from cswin_unet_tpu_torch.models import build_model
    from cswin_unet_tpu_torch.ops.cuda import kernels as K
    from cswin_unet_tpu_torch.train import finetune as ft
    from cswin_unet_tpu_torch.train import make_optimizer, make_train_step
    from cswin_unet_tpu_torch.train.__main__ import main as train_main
    from cswin_unet_tpu_torch.utils.profiling import device_busy_ms

    t_phase = time.perf_counter()
    f32cfg = smoke_config(F32_OPTS)
    f32_backward_kernels(cfg, dev, TRAIN_BATCH, tally)
    f32_conv_check(dev)

    cli = os.path.join(workdir, "f32_cli")
    os.makedirs(os.path.join(cli, "lists", "lists_Synapse_blurred"))
    shutil.copy(os.path.join(data, "lists", "train.txt"),
                os.path.join(cli, "lists", "lists_Synapse_blurred", "train.txt"))
    argv = ["--cfg", CFG, "--root_path", data, "--dataset", "Synapse", "--output_dir", "run",
            "--max_epochs", "1", "--batch_size", str(TRAIN_BATCH), "--img_size", "224",
            "--num_workers", "8", "--device", dev.type, "--opts", *F32_OPTS]
    here = os.getcwd()
    os.chdir(cli)  # the CLI reads ./lists/lists_Synapse_blurred, as the root train.py
    try:
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        msg, plains = plain_calls(K, lambda: train_main(argv))
        torch.cuda.synchronize()
        cli_s, counts = time.perf_counter() - t0, K.launch_counts()
    finally:
        os.chdir(here)
    with open(os.path.join(cli, "run", "log.txt")) as f:
        its = re.findall(r"iteration (\d+) : loss : (\S+), loss_ce: (\S+)", f.read())
    steps = len(os.listdir(os.path.join(data, "train_npz"))) // TRAIN_BATCH
    want = expected_f32(expected_train_launches(cfg, steps))
    print(f"[f32:train] python -m cswin_unet_tpu_torch.train --opts {' '.join(F32_OPTS)}: "
          f"{msg} {steps} steps in {cli_s:.1f}s (model build included), logged iterations "
          f"{[int(i) for i, _, _ in its]} losses {[float(a) for _, a, _ in its]}; launches "
          f"{counts} expected {want}; plain versions called {plains}", flush=True)
    require(msg == "Training Finished!" and [int(i) for i, _, _ in its]
            == list(range(1, steps + 1)) and all(np.isfinite(float(a)) for _, a, _ in its),
            f"float32 train CLI: {msg}, log {its}")
    require(counts == want, f"float32 train CLI launches {counts} != routing {want}")
    require(not any(plains.values()), f"a plain version ran on the card: {plains}")

    img, lab = fixed_batch(data, dev)
    (loss_k, g_k), (loss_p, g_p) = (route_grads(f32cfg, dev, img, lab, impl, torch.float32)
                                    for impl in ("fused", "plain"))
    torch.cuda.synchronize()
    loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    errs = {k: rel_l2(g_k[k], g_p[k]) for k in g_p}
    worst = max(errs, key=errs.get)
    over = {k: f"{v:.3e}" for k, v in errs.items() if not v <= F32_MODEL_TOL}
    print(f"[f32:train] grad parity at float32, fixed batch of {TRAIN_BATCH}, drop-path "
          f"{f32cfg.MODEL.DROP_PATH_RATE}: loss kernel {float(loss_k):.7f} plain "
          f"{float(loss_p):.7f} (rel {loss_err:.2e}, limit {F32_TOL:g}); {len(errs)} gradients, "
          f"worst {worst} rel_l2={errs[worst]:.3e}, median "
          f"{statistics.median(errs.values()):.3e}; above {F32_MODEL_TOL:g}: {over or 'none'}",
          flush=True)
    require(loss_err <= F32_TOL and not over, f"float32 grad parity: loss {loss_err:.3e}, "
            f"{over}")

    # finetune.main at float32, one (lr, wd) cell, one step and one RGN pass
    root = os.path.join(workdir, "finetune")
    ck = os.path.join(workdir, "tiny224_seed0.npz")
    grid = ft.LR_WD_GRID
    ft.LR_WD_GRID = grid[:1]
    try:
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = finetune.main(["--cfg", CFG, "--root_path", os.path.join(root, "train_npz"),
                             "--list_dir", os.path.join(root, "lists"), "--output_dir",
                             os.path.join(root, "run_f32"), "--max_epochs", "1",
                             "--batch_size", str(TRAIN_BATCH), "--img_size", "224",
                             "--pretrained_ckpt", ck, "--save_interval", "1",
                             "--device", dev.type, "--opts", *F32_OPTS])
        torch.cuda.synchronize()
        ft_s, ft_counts = time.perf_counter() - t0, K.launch_counts()
    finally:
        ft.LR_WD_GRID = grid
    with open(os.path.join(root, "run_f32", "log.txt")) as f:
        ft_losses = [float(v) for v in re.findall(r"Loss: (\S+)", f.read())]
    ft_want = expected_f32(expected_train_launches(cfg, 2))
    print(f"[f32:train] python -m cswin_unet_tpu_torch.finetune --opts {' '.join(F32_OPTS)}, "
          f"one cell, 1 epoch: {res!r} in {ft_s:.1f}s, losses {ft_losses}; launches "
          f"{ft_counts} expected {ft_want} (a step and an RGN grad pass)", flush=True)
    require(res == "Surgical Training Finished!" and len(ft_losses) == 1
            and np.isfinite(ft_losses).all(), "float32 finetune CLI")
    require(ft_counts == ft_want, f"float32 finetune launches {ft_counts} != {ft_want}")

    # universal_train at float32: one stage-1 epoch on the continual phase's
    # KiTS-like slices (student passes through CSWinBlockFn, TPGM's
    # autograd.grad, the teacher's forwards)
    out = os.path.join(workdir, "continual_f32")
    root_log = logging.getLogger()
    saved_handlers, saved_level = root_log.handlers[:], root_log.level
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        msg = universal_train.main(
            ["--cfg", CFG, "--stage", "1", "--num_classes_old", "9", "--pretrained_path", ck,
             "--root_path", kits["train_dir"], "--list_dir", kits["list_dir"], "--output_dir",
             out, "--max_epochs", "1", "--batch_size", str(CONTINUAL_BATCH),
             "--gradient_batches", "2", "--tpgm_iters", "4", "--tpgm_start_epoch", "0",
             "--tpgm_frequency", "1", "--tpgm_data_fraction", "0.5", "--device", str(dev),
             "--opts", *F32_OPTS])
        torch.cuda.synchronize()
    finally:
        root_log.handlers[:] = saved_handlers
        root_log.setLevel(saved_level)
    cl_s, cl_counts = time.perf_counter() - t0, K.launch_counts()
    bwd = ("layernorm_bwd", "gemm_dgrad", "gemm_wgrad", "stripe_attention_bwd")
    all_f32 = all(cl_counts[F32_OF[k]] == cl_counts[k] for k in F32_OF)
    print(f"[f32:train] python -m cswin_unet_tpu_torch.universal_train --stage 1 --opts "
          f"{' '.join(F32_OPTS)}, 1 epoch at bs {CONTINUAL_BATCH}: {msg} in {cl_s:.1f}s; "
          f"launches {cl_counts}; every launch a float32 instance's: "
          f"{'yes' if all_f32 else 'NO'}", flush=True)
    require(msg.endswith("Finished!") and all_f32 and all(cl_counts[k] > 0 for k in bwd),
            f"float32 universal_train: {msg}, launches {cl_counts}")

    # one base-384 float32 step at B = 2, and its stage-3 attention backward
    cfg384 = smoke_config(F32_OPTS, cfg=CFG384)
    size, b384 = cfg384.DATA.IMG_SIZE, 2
    model = build_model(cfg384, num_classes=9, device=dev, seed=3, train=True)
    opt, sched = make_optimizer(model.parameters(), 0.01, 1000)
    step = make_train_step(model, opt, sched, 9)
    x = torch.from_numpy(np.random.default_rng(41).standard_normal(
        (b384, size, size, 1)).astype(np.float32)).to(dev)
    y = torch.from_numpy(np.random.default_rng(42).integers(0, 9, (b384, size, size))).to(
        dev, lab.dtype)
    gen = torch.Generator(device=dev).manual_seed(12)
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss384 = float(step(x, y, gen)["loss"])
    torch.cuda.synchronize()
    s384, counts384 = time.perf_counter() - t0, K.launch_counts()
    t0 = time.perf_counter()
    step(x, y, gen)
    torch.cuda.synchronize()
    s384b = time.perf_counter() - t0
    want384 = expected_f32(expected_train_launches(cfg384, 1))
    print(f"[f32:train] base-384 float32 step at B = {b384}: loss {loss384:.6f}, "
          f"{s384:.3f}s the first (allocations included), {s384b:.3f}s the second; launches "
          f"{counts384} expected {want384}", flush=True)
    require(np.isfinite(loss384) and counts384 == want384,
            f"base-384 float32 step: loss {loss384}, launches {counts384}")
    del model, opt, sched, step
    torch.cuda.empty_cache()
    g3 = list(stage_geometries(cfg384))[2]
    rng = np.random.default_rng(43)
    rnd = lambda *s, sc=1.0: torch.from_numpy(
        (rng.standard_normal(s) * sc).astype(np.float32)).to(dev)
    f32_attention_bwd_cases(tally, dev, rnd, 4, g3["H"], g3["C"], g3["heads"], g3["split"],
                            g3["last"], 0, f"@{g3['H']}x{g3['H']}x{g3['C']} base-384",
                            dict(tol=F32_TOL, reps=3, rounds=3, primed=True))

    # the bs-24 step at float32 beside bf16 (kernel routes) and the plain float32 route
    def trainer(c, impl=None):
        m = build_model(c, num_classes=9, device=dev, seed=3, train=True, impl=impl)
        o, sch = make_optimizer(m.parameters(), 0.01, 1000)
        g = torch.Generator(device=dev).manual_seed(12)
        st = make_train_step(m, o, sch, 9)
        return lambda: st(img, lab, g)

    s32, sbf, sp32 = trainer(f32cfg), trainer(cfg), trainer(f32cfg, "plain")
    a1, b1, c1, c2, b2, a2 = (time_ms(fn, reps=3, rounds=3)
                              for fn in (s32, sbf, sp32, sp32, sbf, s32))
    busy = []
    for fn in (s32, sbf):  # the profiler may lose records: up to three tries
        reading = None
        for _ in range(3):
            if (reading := device_busy_ms(fn, 3)) is not None:
                break
        busy.append(reading)
    fmt = lambda v: "unread" if v is None else f"{v:.3f}"
    print(f"[f32:e2e] train step bs {TRAIN_BATCH} (fwd + bwd + SGD), CUDA events in turns "
          f"(f32, bf16, plain f32, plain f32, bf16, f32): float32 kernel route "
          f"ms={min(a1, a2):.3f} [{a1:.3f}, {a2:.3f}] busy {fmt(busy[0])} ms; bf16 kernel "
          f"route ms={min(b1, b2):.3f} [{b1:.3f}, {b2:.3f}] busy {fmt(busy[1])} ms; float32 "
          f"plain route ms={min(c1, c2):.3f} [{c1:.3f}, {c2:.3f}]; on {smi}; phase seconds "
          f"{time.perf_counter() - t_phase:.1f}", flush=True)
    return dict(train_f32=counts, finetune_f32=ft_counts, continual_f32=cl_counts,
                base384_train_f32=counts384)


def blur_cli_run(dev, workdir: str) -> None:
    """``python -m cswin_unet_tpu_torch.tools.apply_blur train`` (its
    ``main``, in this process) with the blur on the card, on 8 synthetic
    512x512 slices: each image within 1e-5 of scipy's ``gaussian_filter``
    (σ 1.0), labels and names equal, ``train.txt`` regenerated."""
    from scipy.ndimage import gaussian_filter

    from cswin_unet_tpu_torch.tools import apply_blur

    root = os.path.join(workdir, "blur_cli")
    write_train_slices(root, 8, 512, 9, seed=41)
    src, out = os.path.join(root, "train_npz"), os.path.join(root, "blurred")
    t0 = time.perf_counter()
    names = apply_blur.main(["train", "--input_dir", src, "--output_dir", out,
                             "--list_output_dir", os.path.join(root, "blurred_lists"),
                             "--sample_dir", os.path.join(root, "samples"),
                             "--num_samples", "0", "--device", dev.type])
    secs = time.perf_counter() - t0
    worst, labels_equal = 0.0, True
    for name in names:
        a, b = np.load(os.path.join(src, name + ".npz")), np.load(os.path.join(out,
                                                                            name + ".npz"))
        worst = max(worst, float(np.abs(b["image"] - gaussian_filter(a["image"], 1.0)).max()))
        labels_equal &= bool(np.array_equal(a["label"], b["label"]))
    with open(os.path.join(root, "blurred_lists", "train.txt")) as f:
        listed = f.read().split()
    ok = worst <= 1e-5 and labels_equal and listed == names == sorted(
        n[:-4] for n in os.listdir(src))
    print(f"[blur] python -m cswin_unet_tpu_torch.tools.apply_blur train --device "
          f"{dev.type}: {len(names)} slices 512x512 in {secs:.2f}s, max |image - scipy "
          f"gaussian_filter(σ 1.0)| {worst:.3e}, labels equal: {labels_equal}, train.txt "
          f"{len(listed)} names {'ok' if ok else 'FAIL'}", flush=True)
    require(ok, f"blur CLI: max diff {worst:.3e}, labels {labels_equal}, list {listed}")


def route_phase(cfg_path: str, dev, tag: str) -> dict:
    """``tools/train_route.py`` at bs 24 for one round (a pass in each
    order): each route's step ms, busy and peak memory and the block rows,
    printed by the tool (one round gives no spread: every verdict is
    ``undecided``, and the model's comment cites the tool's own longer
    run). Checks that every route's times are finite and that the tool gave
    every block its own ``impl`` back."""
    import torch

    from cswin_unet_tpu_torch.models import cswin_unet
    from cswin_unet_tpu_torch.tools import train_route

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = train_route.main(["--cfg", cfg_path, "--batch", str(TRAIN_BATCH), "--rounds", "1",
                            "--device", str(dev)])
    require(all(np.isfinite(t) for r in res["routes"].values() for ts in r["ms"].values()
                for t in ts), f"{tag}: non-finite step times")
    require(all(v["route"] == "undecided" for v in res["verdicts"].values()),
            f"{tag}: a verdict from one round")
    print(f"[{tag}] {len(res['routes'])} routes x 1 round in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 7: evaluate volumes
# ---------------------------------------------------------------------------

class EvalLog(logging.Handler):
    """Prints the evaluation's log lines and keeps them."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: list[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())
        print(f"[eval] {record.getMessage()}", flush=True)


def class_means(lines: list[str]) -> np.ndarray:
    """(dice, hd95) per class from the 'Mean class' log lines."""
    rows = [m.groups() for m in map(re.compile(
        r"^Mean class \d+ mean_dice (\S+) mean_hd95 (\S+)$").match, lines) if m]
    return np.array(rows, dtype=np.float64)


def metrics_agree(got, want) -> bool:
    """Dice and HD95 within rtol 1e-5 and atol 1e-4 (the JAX package's
    tolerance for its device metrics against the host's)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return got.shape == want.shape and bool(
        np.all(np.abs(got - want) <= 1e-4 + 1e-5 * np.abs(want)))


def eval_run(cfg, dev, ck: str) -> dict[str, int]:
    """test.py's evaluation of two CT-like volumes from ``ck``: per volume,
    segmenting and each metrics route timed apart; then ``inference`` with
    device metrics (launches counted) and with host metrics, which must
    agree; the plain route's per-class scores beside the fused route's."""
    import argparse

    import torch

    from cswin_unet_tpu_torch.eval.inference import VolumeInferencer, inference
    from cswin_unet_tpu_torch.metrics import volume_metrics
    from cswin_unet_tpu_torch.models import build_model
    from cswin_unet_tpu_torch.ops.cuda import kernels as K
    from cswin_unet_tpu_torch.ops.edt import volume_metrics_device, zoom_nearest
    from cswin_unet_tpu_torch.utils.checkpoint import load_checkpoint, load_into
    from scipy.ndimage import zoom as nd_zoom

    nc, img = 9, cfg.DATA.IMG_SIZE
    rng = np.random.default_rng(7)
    db = []
    for i, shape in enumerate(EVAL_SHAPES):
        image, label, _ = organ_volume(rng, shape, nc)
        db.append(dict(image=image, label=label, case_name=f"case{i:04d}"))

    def inferencer(impl):
        model = build_model(cfg, num_classes=nc, device=dev, impl=impl, seed=1)
        require(load_into(model.cswin_unet, load_checkpoint(ck)[0])
                == len(model.cswin_unet.state_dict()), f"{ck} into the {impl} route")
        return VolumeInferencer(model, device=dev, patch_size=(img, img))

    fused = inferencer("fused")
    fused.predict_slices(np.zeros((1, img, img), np.float32))  # warm up
    for sample in db:
        image, label = sample["image"], sample["label"]
        d, h, w = image.shape
        t0 = time.perf_counter()
        slices = np.stack([nd_zoom(s, (img / h, img / w), order=3)
                           for s in image]).astype(np.float32)
        t1 = time.perf_counter()
        preds = zoom_nearest(fused.predict_slices_device(slices), (h, w))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        lab = torch.from_numpy(label.astype(np.int32)).to(dev)
        K.reset_launch_counts()
        t3 = time.perf_counter()
        on_dev = volume_metrics_device(preds, lab, nc).cpu().numpy()
        t4 = time.perf_counter()
        edt = K.edt_pass.launches
        host_pred = preds.cpu().numpy()
        t5 = time.perf_counter()
        on_host = np.array(volume_metrics(host_pred, label, nc))
        t6 = time.perf_counter()
        ok = metrics_agree(on_dev, on_host)
        print(f"[eval] {sample['case_name']} {image.shape}: zoom_s={t1 - t0:.3f} "
              f"segment_s={t2 - t1:.3f} device_metrics_s={t4 - t3:.3f} "
              f"host_metrics_s={t6 - t5:.3f} (labels to host {t5 - t4:.3f}); edt_pass "
              f"launches {edt}; device vs host max |diff| "
              f"{np.abs(on_dev - on_host).max():.3e} {'ok' if ok else 'FAIL'}",
              flush=True)
        require(ok, f"{sample['case_name']}: device {on_dev.tolist()} vs host "
                f"{on_host.tolist()}")
        require(edt == (nc - 1) * 2 * 3, f"edt_pass launches {edt}")

    log = EvalLog()
    root = logging.getLogger()
    saved_handlers, saved_level = root.handlers[:], root.level
    root.handlers[:] = [log]
    root.setLevel(logging.INFO)
    try:
        args = argparse.Namespace(num_classes=nc, img_size=img, z_spacing=1,
                                  device_metrics=True)
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inference(args, fused, db)
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
        counts = K.launch_counts()
        forwards = sum(-(-s[0] // SERVE_BATCH) for s in EVAL_SHAPES)
        want = expected_launches(cfg, forwards)
        want["edt_pass"] = (nc - 1) * 2 * 3 * len(db)
        dev_means, n_dev = class_means(log.lines), len(log.lines)
        args.device_metrics = False
        t0 = time.perf_counter()
        inference(args, fused, db)
        host_s = time.perf_counter() - t0
        host_means = class_means(log.lines[n_dev:])
        args.device_metrics = True
        n_fused = len(log.lines)
        inference(args, inferencer("plain"), db)
        plain_means = class_means(log.lines[n_fused:])
    finally:
        root.handlers[:] = saved_handlers
        root.setLevel(saved_level)
    print(f"[eval] inference() over {len(db)} volumes: device metrics {dev_s:.3f}s, "
          f"host metrics {host_s:.3f}s; launches {counts} expected {want}", flush=True)
    require(counts == want, f"eval launches {counts} != routing {want}")
    require(len(dev_means) == nc - 1 and metrics_agree(dev_means, host_means),
            f"inference(): device {dev_means.tolist()} vs host {host_means.tolist()}")
    print("[eval] per class dice / hd95, fused route | plain route (device "
          "metrics; not gated): " + "; ".join(
              f"{c + 1}: {f[0]:.4f}/{f[1]:.2f} | {p[0]:.4f}/{p[1]:.2f}"
              for c, (f, p) in enumerate(zip(dev_means, plain_means))), flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 8: the continual-learning pipeline
# ---------------------------------------------------------------------------

def expected_continual_launches(cfg, student_passes: int, forwards: int,
                                edt: int = 0) -> dict[str, int]:
    """Launches of the continual path per its two routings: each student pass
    with gradients (a train step in train mode, a surgical grad pass or a
    TPGM step on the projected weights in eval mode) as the training
    routing; each forward without gradients (the teacher in every step,
    ``universal_test``'s chunks) as the serving routing, stage 3 paired;
    ``edt`` ``edt_pass`` launches (device metrics)."""
    train = expected_train_launches(cfg, student_passes)
    serve = expected_launches(cfg, forwards)
    out = {k: train[k] + serve[k] for k in SOURCES}
    out["edt_pass"] += edt
    return out


class CarafeByClasses:
    """Counts the model's CARAFE kernel calls by their class count (the
    ``bias`` channels: C_out at the 28 -> 56 upsampler, the head's classes
    at the tail) while it is entered; each call is one launch."""

    def __enter__(self):
        from cswin_unet_tpu_torch.ops.cuda import carafe_tail as CT

        self.CT, self.real, self.counts = CT, CT.carafe_reassemble, {}

        def counted(gy, encoder_weight, encoder_bias, bias, **kw):
            nc = int(bias.shape[0])
            self.counts[nc] = self.counts.get(nc, 0) + 1
            return self.real(gy, encoder_weight, encoder_bias, bias, **kw)

        CT.carafe_reassemble = counted
        return self.counts

    def __exit__(self, *exc):
        self.CT.carafe_reassemble = self.real


def continual_run(cfg, dev, workdir: str) -> tuple[dict[str, int], dict]:
    """``universal_train`` stage 1 (9 -> 12 classes, from the serve phase's
    seeded 9-class checkpoint, on 48 KiTS-like 512x512 slices, 2 epochs),
    stage 2 (12 -> 14, from stage 1's final checkpoint, on 24 LiTS-like
    slices, 1 epoch), then ``universal_test`` of the stage-2 checkpoint on a
    (48, 512, 512) KiTS-like volume with and without device metrics. Checks
    the launch counts against both routings, the log lines and checkpoint
    names, and the device metrics against the host's. Returns the launch
    counts and the KiTS-like data set."""
    import torch

    from cswin_unet_tpu_torch import universal_test, universal_train
    from cswin_unet_tpu_torch.data import make_synthetic_dataset
    from cswin_unet_tpu_torch.ops.cuda import kernels as K
    from cswin_unet_tpu_torch.utils.checkpoint import detect_num_classes

    t0 = time.perf_counter()
    kits = make_synthetic_dataset(os.path.join(workdir, "kits23"), num_train_slices=48,
                                  num_volumes=0, size=512, num_classes=4, seed=21)
    lits = make_synthetic_dataset(os.path.join(workdir, "lits17"), num_train_slices=24,
                                  num_volumes=0, size=512, num_classes=3, seed=22)
    image, label, _ = organ_volume(np.random.default_rng(23), EVAL_SHAPES[0], 4)
    db = [dict(image=image, label=label, case_name="case0000")]
    print(f"[continual] wrote 48 KiTS-like and 24 LiTS-like 512x512 slices and a "
          f"{image.shape} KiTS-like volume in {time.perf_counter() - t0:.1f}s", flush=True)

    stages = ((1, kits, 9, 2, os.path.join(workdir, "tiny224_seed0.npz")),
              (2, lits, 12, 1, os.path.join(workdir, "continual_s1",
                                            "continual_surgical_tpgm_stage1_final.npz")))
    common = ["--cfg", CFG, "--batch_size", str(CONTINUAL_BATCH), "--gradient_batches", "2",
              "--tpgm_iters", "4", "--tpgm_start_epoch", "0", "--tpgm_frequency", "1",
              "--tpgm_data_fraction", "0.5", "--device", str(dev)]
    root = logging.getLogger()
    saved_handlers, saved_level = root.handlers[:], root.level
    passes = forwards = 0
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for stage, data, old, epochs, pretrained in stages:
            out = os.path.join(workdir, f"continual_s{stage}")
            ts = time.perf_counter()
            msg = universal_train.main(
                ["--stage", str(stage), "--num_classes_old", str(old), "--pretrained_path",
                 pretrained, "--root_path", data["train_dir"], "--list_dir",
                 data["list_dir"], "--output_dir", out, "--max_epochs", str(epochs),
                 *common])
            torch.cuda.synchronize()
            n = len(data["train_names"])
            steps = -(-n // CONTINUAL_BATCH)
            passes += epochs * (steps + min(2, steps) + 4)  # train, surgical, TPGM
            forwards += epochs * steps  # the teacher
            with open(os.path.join(out, "log.txt")) as f:
                log = f.read()
            with open(os.path.join(out, "tpgm_ratios.log")) as f:
                ratios = f.read()
            names = [f"continual_surgical_tpgm_stage{stage}_epoch_{epochs - 1}.npz",
                     f"continual_surgical_tpgm_stage{stage}_final.npz"]
            final = os.path.join(out, names[1])
            total = old + (3 if stage == 1 else 2)
            print(f"[continual] stage {stage} ({old} -> {total} classes, {n} slices, "
                  f"{epochs} epochs of {steps} steps at bs {CONTINUAL_BATCH}) in "
                  f"{time.perf_counter() - ts:.1f}s: {msg}; checkpoints "
                  f"{sorted(f for f in os.listdir(out) if f.endswith('.npz'))}", flush=True)
            require(msg.endswith("Finished!") and detect_num_classes(final) == total,
                    f"stage {stage}: {msg}, {final}")
            for line in (f"save model to {os.path.join(out, names[0])}",
                         f"save final model to {final}", "Applying final TPGM projection",
                         "RGN: Max weight before normalization: ",
                         "CONTINUAL LEARNING STAGE", "Total layers: "):
                require(line in log, f"stage {stage}: no log line {line!r}")
            require(log.count("TPGM optimization complete. Average constraint change: ")
                    == epochs and "ratio output.weight: " in ratios,
                    f"stage {stage}: TPGM log lines")
        outs = []
        for device_metrics in (True, False):
            out = os.path.join(workdir, f"continual_test_{'device' if device_metrics else 'host'}")
            ts = time.perf_counter()
            universal_test.main(
                ["--cfg", CFG, "--volume_path", workdir, "--test_dataset", "kits23",
                 "--model_path", os.path.join(workdir, "continual_s2"), "--output_dir", out,
                 "--device", str(dev)] + (["--device_metrics"] if device_metrics else []),
                db_test=db)
            torch.cuda.synchronize()
            with open(os.path.join(out, "test_kits23.txt")) as f:
                lines = [x.split("] ", 1)[-1].rstrip("\n") for x in f]
            outs.append((class_means(lines), time.perf_counter() - ts, lines))
    finally:
        root.handlers[:] = saved_handlers
        root.setLevel(saved_level)
    counts = K.launch_counts()
    forwards += 2 * -(-EVAL_SHAPES[0][0] // SERVE_BATCH)
    want = expected_continual_launches(cfg, passes, forwards, edt=3 * 2 * 3)
    print(f"[continual] path in {time.perf_counter() - t0:.1f}s: {passes} student passes "
          f"with gradients, {forwards} forwards without; launches {counts} expected "
          f"{want}", flush=True)
    require(counts == want, f"continual launches {counts} != routing {want}")
    (dev_means, dev_s, lines), (host_means, host_s, _) = outs
    for line in lines:
        if re.match(r"(idx \d+ case|Mean class|Testing performance)", line):
            print(f"[continual] {line}", flush=True)
    ok = len(dev_means) == 3 and metrics_agree(dev_means, host_means)
    print(f"[continual] universal_test kits23 channels [0, 9, 10, 11] of the 14-class "
          f"head: device metrics {dev_s:.2f}s, host metrics {host_s:.2f}s; per class "
          f"dice/hd95 device | host: " + "; ".join(
              f"{c + 1}: {d[0]:.6f}/{d[1]:.6f} | {h[0]:.6f}/{h[1]:.6f}"
              for c, (d, h) in enumerate(zip(dev_means, host_means)))
          + f" {'ok' if ok else 'FAIL'}", flush=True)
    require(ok, f"universal_test: device {dev_means.tolist()} vs host {host_means.tolist()}")
    require(any(x.startswith("Testing performance in best val model:") for x in lines),
            "universal_test: no result line")
    return counts, kits


def continual_checks(cfg, dev, data: dict, teacher_ck: str, smi: str) -> None:
    """On one fixed batch of 12 KiTS-like slices, the kernel route against
    the plain route on the same weights (the teacher, and its expansion to 12
    classes) and the same drop-path draws: the continual loss and every
    gradient (``grad_parity``), one TPGM step's constraint gradients on
    drifted weights (every ratio 0.5, inside its clamp), and the RGN weight
    vector, relative L2 <= TOL. Then one continual step's, one TPGM step's
    and one surgical grad pass's launches (CARAFE by class count) and
    seconds."""
    import torch

    from cswin_unet_tpu_torch.data import EvalResize, SynapseDataset
    from cswin_unet_tpu_torch.losses import focal_loss
    from cswin_unet_tpu_torch.models import build_model
    from cswin_unet_tpu_torch.ops.cuda import kernels as K
    from cswin_unet_tpu_torch.train import continual, surgical, tpgm
    from cswin_unet_tpu_torch.utils.checkpoint import (expand_classifier, load_checkpoint,
                                                       load_into)

    old, total, bs = 9, CONTINUAL_CLASSES[0], CONTINUAL_BATCH
    ds = SynapseDataset(data["train_dir"], data["list_dir"], "train",
                        transform=EvalResize([224, 224]))
    samples = [ds[i] for i in range(0, 4 * bs, 4)]
    img = torch.from_numpy(np.stack([s["image"] for s in samples])).to(dev)
    lab = torch.from_numpy(np.stack([s["label"] for s in samples])).to(dev)
    mapped = continual.map_new_dataset_labels(lab, 1, old)
    cw = np.linspace(0.3, 1.2, total).astype(np.float32)
    cw_dev = torch.from_numpy(cw).to(dev)
    loss_fn = continual.make_continual_loss(total, old, kd_weight=0.5, kd_temperature=3.0,
                                            class_weights=cw)
    flat = load_checkpoint(teacher_ck)[0]

    def seg_ce(logits, labels):
        return focal_loss(logits, labels, alpha=1.0, gamma=4.0, class_weights=cw_dev)

    def models(impl, dtype):
        teacher = build_model(cfg, num_classes=old, device=dev, impl=impl, dtype=dtype,
                              seed=0)
        load_into(teacher.cswin_unet, flat)
        student = build_model(cfg, num_classes=total, device=dev, impl=impl, dtype=dtype,
                              seed=0, train=True)
        student.cswin_unet.load_state_dict(
            expand_classifier(teacher.cswin_unet.state_dict(), total, seed=1234))
        return teacher, student

    def route(impl, dtype):
        teacher, student = models(impl, dtype)
        params = surgical.backbone_params(student)
        gen = torch.Generator(device=dev).manual_seed(13)
        with torch.no_grad():
            old_logits = teacher(img)
        loss, _ = loss_fn(student(img, generator=gen), old_logits, mapped)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        tr = tpgm.TPGMTrainer(student, params, active_classes=total)
        rng = np.random.default_rng(14)
        drifted = {k: v.detach() + torch.from_numpy(
            rng.standard_normal(tuple(v.shape)).astype(np.float32) * 0.02).to(dev)
            for k, v in params.items()}
        tr.constraints = {k: (drifted[k] - tr.anchor[k]).norm() / 2 for k in tr.constraints}
        _, ratios, cg = tr.constraint_grads(drifted, img, mapped)
        rgn = surgical.get_lr_weights(student, [{"image": img, "label": mapped}], seg_ce)
        return ((loss.detach(), grads), torch.stack([cg[k] for k in sorted(cg)]),
                torch.tensor([rgn[k] for k in sorted(rgn)], dtype=torch.float64),
                tpgm.ratio_stats(ratios), student.training)

    kernel, plain, f32 = (route("fused", torch.bfloat16), route("plain", torch.bfloat16),
                          route("plain", torch.float32))
    require(kernel[4] and plain[4], "a TPGM or surgical pass left the student in eval mode")
    grad_parity("continual", f"fixed batch of {bs}, {old} -> {total} classes, "
                f"KD from the {old}-class teacher", kernel[0], plain[0], f32[0],
                widen_weights=True)
    for what, i in (("TPGM constraint gradients", 1), ("RGN weights", 2)):
        err, floor = rel_l2(kernel[i], plain[i]), rel_l2(plain[i], f32[i])
        extra = f" (ratios min/max/mean {kernel[3]})" if i == 1 else ""
        print(f"[continual] {what}: {kernel[i].numel()} values, kernel vs plain rel_l2="
              f"{err:.3e} (plain bf16 vs f32 {floor:.3e}){extra} "
              f"{'ok' if err <= TOL else 'FAIL'}", flush=True)
        require(err <= TOL and bool(torch.isfinite(kernel[i]).all()),
                f"continual {what}: rel_l2 {err:.3e}")

    teacher, student = models("fused", torch.bfloat16)
    params = surgical.backbone_params(student)
    opt = surgical.SurgicalOptimizer(params, 1e-3, 2)
    step = continual.make_continual_train_step(student, teacher, opt, loss_fn, 1, old)
    weights = {k: 1.0 for k in params}
    gen = torch.Generator(device=dev).manual_seed(15)
    tr = tpgm.TPGMTrainer(student, params, active_classes=total)
    grad_fn = surgical.make_grad_fn(student, seg_ce)
    ed = cfg.MODEL.CSWIN.EMBED_DIM
    runs = (("one continual step (teacher forward, student fwd + bwd, AdamW)",
             lambda: step(img, lab, weights, 0, gen), 1, 1, {ed: 2, old: 1, total: 1}),
            ("one TPGM step", lambda: tr.step(params, img, mapped), 1, 0, {ed: 1, total: 1}),
            ("one surgical grad pass", lambda: grad_fn(img, mapped), 1, 0,
             {ed: 1, total: 1}))
    secs = []
    for what, fn, n_passes, n_fwd, by_nc in runs:
        with CarafeByClasses() as carafe:
            K.reset_launch_counts()
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            counts = K.launch_counts()
        want = expected_continual_launches(cfg, n_passes, n_fwd)
        print(f"[continual] {what}: launches {counts} expected {want}; CARAFE launches "
              f"by class count {carafe} expected {by_nc}", flush=True)
        require(counts == want and carafe == by_nc, f"{what}: launches {counts}, "
                f"CARAFE {carafe}")
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        secs.append(f"{what} {statistics.median(times):.4f}s [{min(times):.4f}-"
                    f"{max(times):.4f}]")
    print(f"[continual] seconds at bs {bs} (median of 3 [min-max], host clock around "
          f"synchronized calls): {'; '.join(secs)}; on {smi}", flush=True)
    require(student.training, "the student left train mode")


# ---------------------------------------------------------------------------
# phase 9: data parallel ([ddp])
# ---------------------------------------------------------------------------

DDP_WORLD = 2  # two gloo ranks share the one card
DDP_STEPS = 3  # trainer steps of the two-rank run
DDP_SLICES = DDP_STEPS * TRAIN_BATCH  # one epoch of DDP_STEPS global batches
DDP_TIMEOUT_S = 300


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ddp_rank_main(rank: int, world: int, port: int, backend: str, fn_name: str,
                   args: tuple, out: str) -> None:
    """A spawned rank: join the group (every rank on local device 0, the
    one card), run ``fn_name(rank, device, *args)`` and save its result."""
    from datetime import timedelta

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK="0")
    sys.path.insert(0, ROOT)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from cswin_unet_tpu_torch.parallel import destroy_distributed, init_distributed

    _, _, dev = init_distributed(args[0], backend=backend,
                                 timeout=timedelta(seconds=DDP_TIMEOUT_S // 2))
    try:
        torch.save(globals()[fn_name](rank, dev, *args[1:]),
                   os.path.join(out, f"rank{rank}.pt"))
    finally:
        destroy_distributed()


def ddp_spawn(fn_name: str, world: int, backend: str, args: tuple, out: str) -> list:
    """``fn_name`` of this module on ``world`` spawned ranks; their results
    in rank order. Fails when a rank fails or outlives ``DDP_TIMEOUT_S``;
    leaves no process behind."""
    import multiprocessing as mp

    import torch

    os.makedirs(out, exist_ok=True)
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_ddp_rank_main,
                         args=(r, world, port, backend, fn_name, args, out))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DDP_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        left = [p for p in procs if p.is_alive()]
        for p in left:
            p.kill()
            p.join(10)
    require(not left, f"{fn_name}: {len(left)} rank(s) still running after {DDP_TIMEOUT_S}s")
    require([p.exitcode for p in procs] == [0] * world,
            f"{fn_name}: rank exit codes {[p.exitcode for p in procs]}")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _host_params(model) -> dict:
    return {k: v.detach().float().cpu().clone() for k, v in model.named_parameters()}


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed_steps(step, dev, n: int = 5) -> float:
    """Median seconds of ``n`` synchronised calls after one warm-up."""
    step()
    times = []
    for _ in range(n):
        sync(dev)
        t0 = time.perf_counter()
        step()
        sync(dev)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def ddp_batch(data: str, n: int, size: int, rows=None):
    """The first ``n`` slices of ``data`` resized to ``size`` (``rows``: the
    range of them this rank holds), as (image, label) host tensors."""
    import torch

    from cswin_unet_tpu_torch.data import EvalResize, SynapseDataset

    ds = SynapseDataset(os.path.join(data, "train_npz"), os.path.join(data, "lists"),
                        "train", transform=EvalResize([size, size]))
    idx = range(n) if rows is None else rows
    samples = [ds[i] for i in idx]
    return (torch.from_numpy(np.stack([s["image"] for s in samples])),
            torch.from_numpy(np.stack([s["label"] for s in samples])))


def ddp_train_args(data: str, out: str, dev, batch: int):
    import argparse

    return argparse.Namespace(
        root_path=os.path.join(data, "train_npz"), list_dir=os.path.join(data, "lists"),
        num_classes=9, batch_size=batch, n_gpu=1, max_epochs=1, base_lr=0.01,
        img_size=224, seed=1234, num_workers=4, device=str(dev), output_dir=out,
        device_augment=True)


class _GradRecorder:
    """An optimizer stand-in for the continual step: keeps the gradients it
    is given (after the step's own mean over the ranks)."""

    def step(self, grads, weights, epoch):
        self.grads = {k: v.detach().float().cpu() for k, v in grads.items()}


def ddp_continual_pieces(cfg, dev, kits: dict, teacher_ck: str, rows=None, *,
                         impl: str | None = None, dtype=None) -> dict:
    """The continual step's student gradients (drop-path live), one TPGM
    pass's constraint gradients on drifted weights (every ratio 0.5) and the
    RGN weights, on a fixed global batch of ``CONTINUAL_BATCH`` KiTS-like
    slices (``rows``: this rank's part of it), on the route ``impl`` in
    ``dtype`` (default: the kernel route in bf16)."""
    import torch

    from cswin_unet_tpu_torch.data import EvalResize, SynapseDataset
    from cswin_unet_tpu_torch.losses import focal_loss
    from cswin_unet_tpu_torch.models import build_model
    from cswin_unet_tpu_torch.train import continual, surgical, tpgm
    from cswin_unet_tpu_torch.utils.checkpoint import (expand_classifier, load_checkpoint,
                                                       load_into)

    old, total, bs = 9, CONTINUAL_CLASSES[0], CONTINUAL_BATCH
    ds = SynapseDataset(kits["train_dir"], kits["list_dir"], "train",
                        transform=EvalResize([224, 224]))
    idx = list(range(0, 4 * bs, 4))
    idx = idx if rows is None else idx[rows]
    samples = [ds[i] for i in idx]
    img = torch.from_numpy(np.stack([s["image"] for s in samples])).to(dev)
    lab = torch.from_numpy(np.stack([s["label"] for s in samples])).to(dev)
    mapped = continual.map_new_dataset_labels(lab, 1, old)
    cw = np.linspace(0.3, 1.2, total).astype(np.float32)
    loss_fn = continual.make_continual_loss(total, old, kd_weight=0.5, kd_temperature=3.0,
                                            class_weights=cw)
    kw = dict(device=dev, seed=0, impl=impl, dtype=dtype)
    teacher = build_model(cfg, num_classes=old, **kw)
    load_into(teacher.cswin_unet, load_checkpoint(teacher_ck)[0])
    student = build_model(cfg, num_classes=total, train=True, **kw)
    student.cswin_unet.load_state_dict(
        expand_classifier(teacher.cswin_unet.state_dict(), total, seed=1234))
    rec = _GradRecorder()
    step = continual.make_continual_train_step(student, teacher, rec, loss_fn, 1, old)
    step(img, lab, {}, 0, torch.Generator(device=dev).manual_seed(13))
    params = surgical.backbone_params(student)
    tr = tpgm.TPGMTrainer(student, params, active_classes=total)
    rng = np.random.default_rng(14)
    drifted = {k: v.detach() + torch.from_numpy(
        rng.standard_normal(tuple(v.shape)).astype(np.float32) * 0.02).to(dev)
        for k, v in params.items()}
    tr.constraints = {k: (drifted[k] - tr.anchor[k]).norm() / 2 for k in tr.constraints}
    _, _, cg = tr.constraint_grads(drifted, img, mapped)
    cw_dev = torch.from_numpy(cw).to(dev)
    rgn = surgical.get_lr_weights(
        student, [{"image": img, "label": mapped}],
        lambda lg, lb: focal_loss(lg, lb, alpha=1.0, gamma=4.0, class_weights=cw_dev))
    return dict(grads=rec.grads, tpgm=torch.stack([cg[k].float().cpu() for k in sorted(cg)]),
                rgn=torch.tensor([rgn[k] for k in sorted(rgn)], dtype=torch.float64))


def ddp_rank(rank: int, dev, cfg_opts, data: str, kits: dict, teacher_ck: str,
             workdir: str) -> dict:
    """One rank of the two-rank phase: ``trainer_synapse`` for one epoch of
    ``DDP_STEPS`` global batches of ``TRAIN_BATCH`` (its launches, θ before
    and after), the seconds of one DDP step on a fixed batch of its rows,
    and the continual, TPGM and RGN pieces on its rows, on the kernel route
    in bf16 and on the plain route in float32."""
    import torch

    from cswin_unet_tpu_torch.models import build_model
    from cswin_unet_tpu_torch.ops.cuda import kernels as K
    from cswin_unet_tpu_torch.parallel import wrap_ddp
    from cswin_unet_tpu_torch.train import make_optimizer, make_train_step, trainer_synapse

    cfg = smoke_config(cfg_opts)
    per = TRAIN_BATCH // DDP_WORLD
    out = os.path.join(workdir, "ddp_run")
    model = build_model(cfg, num_classes=9, device=dev, seed=0, train=True)
    before = _host_params(model)
    K.reset_launch_counts()
    sync(dev)
    t0 = time.perf_counter()
    require(trainer_synapse(ddp_train_args(data, out, dev, TRAIN_BATCH), model, out)
            == "Training Finished!", "two-rank trainer")
    sync(dev)
    seconds, counts = time.perf_counter() - t0, K.launch_counts()
    after = _host_params(model)

    img, lab = (t.to(dev) for t in ddp_batch(data, TRAIN_BATCH, 224,
                                             range(rank * per, (rank + 1) * per)))
    opt, sched = make_optimizer(model.parameters(), 0.01, 1000)
    step = make_train_step(wrap_ddp(model, dev), opt, sched, 9, device_augment=True)
    gen = torch.Generator(device=dev).manual_seed(12)
    step_s = _timed_steps(lambda: step(img, lab, gen), dev)
    half = CONTINUAL_BATCH // DDP_WORLD
    rows = slice(rank * half, (rank + 1) * half)
    pieces = ddp_continual_pieces(cfg, dev, kits, teacher_ck, rows)
    pieces_f32 = ddp_continual_pieces(cfg, dev, kits, teacher_ck, rows, impl="plain",
                                      dtype=torch.float32)
    return dict(before=before, after=after, counts=counts, seconds=seconds,
                step_s=step_s, pieces=pieces, pieces_f32=pieces_f32)


def top_device_kernels(fn, n: int = 4) -> list[tuple[str, float]]:
    """The ``n`` device kernels (and copies) with the most device time in
    one call of ``fn`` (``torch.profiler``): (name, ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cswin_unet_tpu_torch.utils.profiling import device_events

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in device_events(prof):
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return [(k[:40], round(v, 3)) for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]


def ddp_step_cost(rank: int, dev, cfg_opts, data: str) -> dict:
    """DDP's own cost: a bs-24 train step with and without the DDP wrapper
    in one process under a world of one (NCCL), timed in turns (plain, DDP,
    DDP, plain); each one's seconds, device busy and top device kernels."""
    from cswin_unet_tpu_torch.models import build_model
    from cswin_unet_tpu_torch.parallel import wrap_ddp
    from cswin_unet_tpu_torch.utils.profiling import device_busy_ms

    cfg = smoke_config(cfg_opts)
    steps = {}
    for name in ("plain", "ddp"):
        model = build_model(cfg, num_classes=9, device=dev, seed=3, train=True)
        net = wrap_ddp(model, dev) if name == "ddp" else model
        steps[name] = ddp_fixed_step(model, net, data, dev)
    secs = {name: [] for name in steps}
    for name in ("plain", "ddp", "ddp", "plain"):
        secs[name].append(_timed_steps(steps[name], dev))
    out = {name: dict(step_s=min(v), turns=v) for name, v in secs.items()}
    if dev.type == "cuda":
        for name, fn in steps.items():
            out[name].update(busy_ms=device_busy_ms(fn, 3), top=top_device_kernels(fn))
    return out


def ddp_fixed_step(model, net, data: str, dev):
    """One bs-24 step of ``net`` (``model``, wrapped or not) on a fixed batch."""
    import torch

    from cswin_unet_tpu_torch.train import make_optimizer, make_train_step

    img, lab = (t.to(dev) for t in ddp_batch(data, TRAIN_BATCH, 224))
    opt, sched = make_optimizer(model.parameters(), 0.01, 1000)
    step = make_train_step(net, opt, sched, 9)
    gen = torch.Generator(device=dev).manual_seed(12)
    return lambda: step(img, lab, gen)


def ddp_reference(cfg, dev, data: str) -> tuple[dict, dict, list[float]]:
    """One process over the two ranks' concatenated batches (rank 0's rows
    first), with the trainer's optimizer, schedule, generator and
    augmentation: (θ before, θ after, losses)."""
    import torch

    from cswin_unet_tpu_torch.data import DataLoader, EvalResize, SynapseDataset
    from cswin_unet_tpu_torch.models import build_model
    from cswin_unet_tpu_torch.train import make_optimizer, make_train_step

    ds = SynapseDataset(os.path.join(data, "train_npz"), os.path.join(data, "lists"),
                        "train", transform=EvalResize([224, 224]))
    shards = [DataLoader(ds, TRAIN_BATCH // DDP_WORLD, seed=1234, num_workers=4,
                         num_shards=DDP_WORLD, shard_index=r) for r in range(DDP_WORLD)]
    model = build_model(cfg, num_classes=9, device=dev, seed=0, train=True)
    before = _host_params(model)
    opt, sched = make_optimizer(model.parameters(), 0.01, len(shards[0]))
    step = make_train_step(model, opt, sched, 9, device_augment=True)
    gen = torch.Generator(device=dev).manual_seed(1234)
    losses = []
    for parts in zip(*shards):
        img = torch.from_numpy(np.concatenate([p["image"] for p in parts])).to(dev)
        lab = torch.from_numpy(np.concatenate([p["label"] for p in parts])).to(dev)
        losses.append(float(step(img, lab, gen)["loss"]))
    return before, _host_params(model), losses


def ddp_run(cfg, dev, workdir: str, kits: dict, teacher_ck: str, smi: str,
            cfg_opts=None) -> dict[str, int]:
    """Phase 9: data parallelism on the one card. Returns the launches of
    its two-rank training and of the split inferencer."""
    import torch

    from cswin_unet_tpu_torch import metrics
    from cswin_unet_tpu_torch.eval.inference import VolumeInferencer
    from cswin_unet_tpu_torch.models import build_model
    from cswin_unet_tpu_torch.ops.cuda import kernels as K
    from cswin_unet_tpu_torch.utils import native
    from cswin_unet_tpu_torch.utils.profiling import KERNEL_SYMBOLS, device_trace

    t_phase = time.perf_counter()
    data = os.path.join(workdir, "ddp_data")
    write_train_slices(data, DDP_SLICES, 224, 9, seed=21)

    # Two gloo ranks through trainer_synapse, against one process on the
    # concatenated batches.
    ranks = ddp_spawn("ddp_rank", DDP_WORLD, "gloo",
                      (str(dev.type), cfg_opts, data, kits, teacher_ck, workdir),
                      os.path.join(workdir, "ddp_ranks"))
    before, after, ref_losses = ddp_reference(cfg, dev, data)
    want = expected_train_launches(cfg, DDP_STEPS)
    for r, res in enumerate(ranks):
        print(f"[ddp] rank {r}: {DDP_STEPS} steps at {TRAIN_BATCH // DDP_WORLD} a rank in "
              f"{res['seconds']:.1f}s; launches {res['counts']} expected {want}", flush=True)
        require({k: res["counts"][k] for k in want} == want,
                f"rank {r} launches {res['counts']} != routing {want}")
    for k in before:
        require(all(torch.equal(r["before"][k], before[k]) for r in ranks),
                f"rank weights differ at the start: {k}")
        require(torch.equal(ranks[0]["after"][k], ranks[1]["after"][k]),
                f"the ranks' weights differ after the run: {k}")
    errs = {k: rel_l2(ranks[0]["after"][k] - before[k], after[k] - before[k]) for k in before}
    worst = max(errs, key=errs.get)
    with open(os.path.join(workdir, "ddp_run", "log.txt")) as f:
        log = f.read()
    logged = [float(v) for v in re.findall(r"iteration \d+ : loss : (\S+),", log)]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(logged, ref_losses)) \
        if len(logged) == len(ref_losses) else float("inf")
    over = {k: f"{e:.3e}" for k, e in errs.items() if e > TOL}
    print(f"[ddp] 2 ranks (gloo, one card) vs one process on the concatenated batches, "
          f"{DDP_STEPS} steps at bs {TRAIN_BATCH}, drop-path {cfg.MODEL.DROP_PATH_RATE}, dropout "
          f"{cfg.MODEL.DROP_RATE} and --device_augment live: {len(errs)} updates θ3 − θ0, worst {worst} "
          f"rel_l2={errs[worst]:.3e}, above {TOL}: {over or 'none'}; logged losses "
          f"{logged} vs {[round(v, 6) for v in ref_losses]} (worst rel {loss_err:.2e}) "
          f"{'ok' if not over and loss_err <= TOL else 'FAIL'}", flush=True)
    require(not over and loss_err <= TOL, f"two ranks vs one process: {over}, losses "
            f"{logged} vs {ref_losses}")

    # The split itself, free of bf16 rounding: the plain route in float32 on
    # both sides, every continual gradient, the TPGM constraint gradients and
    # the RGN weights held to TOL.
    one = ddp_continual_pieces(cfg, dev, kits, teacher_ck)
    plain, f32 = (ddp_continual_pieces(cfg, dev, kits, teacher_ck, impl="plain", dtype=dt)
                  for dt in (torch.bfloat16, torch.float32))
    two = ranks[0]["pieces_f32"]
    f_errs = {k: rel_l2(two["grads"][k], f32["grads"][k]) for k in f32["grads"]}
    f_worst = max(f_errs, key=f_errs.get)
    f_tr = (rel_l2(two["tpgm"], f32["tpgm"]), rel_l2(two["rgn"], f32["rgn"]))
    f_ok = max(f_errs.values()) <= TOL and max(f_tr) <= TOL
    print(f"[ddp] continual step on the plain route in float32, "
          f"{CONTINUAL_BATCH // DDP_WORLD} a rank vs one process at {CONTINUAL_BATCH}: "
          f"{len(f_errs)} gradients, worst {f_worst} rel_l2={f_errs[f_worst]:.3e}; TPGM "
          f"constraint gradients rel_l2={f_tr[0]:.3e}; RGN weights rel_l2={f_tr[1]:.3e} "
          f"{'ok' if f_ok else 'FAIL'}", flush=True)
    require(f_ok, f"continual pieces on two ranks in float32: {f_worst} "
            f"{f_errs[f_worst]:.3e}, TPGM and RGN {f_tr}")

    # On the kernel route in bf16 the continual loss (focal at gamma 4, KD)
    # leaves some gradients cancellation-dominated sums whose rounding alone
    # moves them beyond TOL (the float32 check above shows the split exact):
    # each gradient is held to TOL, or to twice the plain route's own
    # bf16-vs-float32 error where that is larger (grad_parity's rule for the
    # continual loss, bench.py:382-388), and its float32 split error is
    # printed beside it.
    g_errs = {k: rel_l2(ranks[0]["pieces"]["grads"][k], one["grads"][k]) for k in one["grads"]}
    bound = {k: max(TOL, 2 * rel_l2(plain["grads"][k], f32["grads"][k])) for k in g_errs}
    worst = max(g_errs, key=g_errs.get)
    g_over = {k: f"{e:.3e} (bound {bound[k]:.3e}, float32 split {f_errs[k]:.1e})"
              for k, e in g_errs.items() if e > TOL}
    g_bad = [k for k, e in g_errs.items() if not e <= bound[k]]
    t_err = rel_l2(ranks[0]["pieces"]["tpgm"], one["tpgm"])
    r_err = rel_l2(ranks[0]["pieces"]["rgn"], one["rgn"])
    same = all(torch.equal(ranks[0]["pieces"][k], ranks[1]["pieces"][k])
               for k in ("tpgm", "rgn"))
    print(f"[ddp] continual step, {CONTINUAL_BATCH // DDP_WORLD} a rank vs one process at "
          f"{CONTINUAL_BATCH}: {len(g_errs)} gradients, worst {worst} rel_l2="
          f"{g_errs[worst]:.3e}, above {TOL}: {g_over or 'none'}, beyond their bound: "
          f"{g_bad or 'none'}; TPGM constraint gradients rel_l2={t_err:.3e}; RGN weights "
          f"rel_l2={r_err:.3e}; equal on both ranks: {'yes' if same else 'no'} "
          f"{'ok' if not g_bad and max(t_err, r_err) <= TOL and same else 'FAIL'}", flush=True)
    require(not g_bad and t_err <= TOL and r_err <= TOL and same,
            f"continual pieces on two ranks: {g_bad}, {t_err:.3e}, {r_err:.3e}, {same}")

    model = build_model(cfg, num_classes=9, device=dev, seed=3, train=True)
    ref_step = ddp_fixed_step(model, model, data, dev)
    one_s = _timed_steps(ref_step, dev)
    print(f"[ddp] step seconds (median of 5, host clock around synchronised calls): two "
          f"ranks sharing the card, {TRAIN_BATCH // DDP_WORLD} rows each: "
          f"{[round(r['step_s'], 4) for r in ranks]}; one process at bs {TRAIN_BATCH}: "
          f"{one_s:.4f} (two processes on one card, not a multi-GPU figure; {smi})",
          flush=True)

    # DDP's own cost: the step with and without DDP in one process under a
    # world of one (NCCL); beside it the step here, without a process group.
    cost = ddp_spawn("ddp_step_cost", 1, "nccl", (str(dev.type), cfg_opts, data),
                     os.path.join(workdir, "ddp_cost"))[0]

    def busy(v):
        return "unread" if v is None else f"{v:.3f}"

    print(f"[ddp] bs-{TRAIN_BATCH} step under NCCL at world size 1, in turns (plain, DDP, "
          f"DDP, plain), best of the medians: DDP {cost['ddp']['step_s']:.4f} s "
          f"{[round(t, 4) for t in cost['ddp']['turns']]} vs without the wrapper "
          f"{cost['plain']['step_s']:.4f} s {[round(t, 4) for t in cost['plain']['turns']]}; "
          f"device busy {busy(cost['ddp'].get('busy_ms'))} vs "
          f"{busy(cost['plain'].get('busy_ms'))} ms; most device time (ms) DDP "
          f"{cost['ddp'].get('top')} vs {cost['plain'].get('top')}; the step in this "
          f"process without a process group {one_s:.4f} s ({smi})", flush=True)

    # The train CLI under torchrun, one process: NCCL at world size 1.
    cli = os.path.join(workdir, "ddp_cli")
    os.makedirs(os.path.join(cli, "lists", "lists_Synapse_blurred"), exist_ok=True)
    shutil.copy(os.path.join(data, "lists", "train.txt"),
                os.path.join(cli, "lists", "lists_Synapse_blurred", "train.txt"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc_per_node", "1", "--master_addr", "127.0.0.1", "--master_port",
           str(free_port()), "-m", "cswin_unet_tpu_torch.train", "--cfg", CFG,
           "--root_path", data, "--dataset", "Synapse", "--output_dir", "run",
           "--max_epochs", "1", "--batch_size", str(TRAIN_BATCH), "--img_size", "224",
           "--num_workers", "4", "--device", dev.type] + (["--opts", *cfg_opts] if cfg_opts
                                                          else [])
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=cli, env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=DDP_TIMEOUT_S)
    cli_s = time.perf_counter() - t0
    require(res.returncode == 0, f"train CLI under torchrun: rc {res.returncode}\n"
            f"{res.stderr[-3000:]}")
    with open(os.path.join(cli, "run", "log.txt")) as f:
        log = f.read()
    its = [int(i) for i in re.findall(r"iteration (\d+) : loss : \S+, loss_ce: \S+", log)]
    state = torch.load(os.path.join(cli, "run", "train_state.pt"), weights_only=True)
    ok = (its == list(range(1, DDP_STEPS + 1))
          and os.path.exists(os.path.join(cli, "run", "epoch_0.npz"))
          and (state["iteration"], state["epoch"]) == (DDP_STEPS, 1)
          and not any(k.startswith("module.") for k in state["model"]))
    print(f"[ddp] python -m torch.distributed.run --nproc_per_node 1 -m "
          f"cswin_unet_tpu_torch.train (NCCL, world size 1): rc 0 in {cli_s:.1f}s, logged "
          f"iterations {its}, epoch_0.npz, train_state.pt at iteration "
          f"{state['iteration']} epoch {state['epoch']} {'ok' if ok else 'FAIL'}", flush=True)
    require(ok, f"train CLI under torchrun: iterations {its}, state {state['iteration']}")

    # VolumeInferencer over two replicas on the one card.
    model = build_model(cfg, num_classes=9, device=dev, seed=0)
    x = np.random.default_rng(22).standard_normal((SERVE_BATCH, 224, 224)).astype(np.float32)
    counts, infs = [], []
    for devices in (None, [dev, dev]):
        infs.append(VolumeInferencer(model, device=dev, batch_slices=SERVE_BATCH,
                                     devices=devices))
        infs[-1].predict_slices(x)  # warm
        K.reset_launch_counts()
        sync(dev)
        labels = infs[-1].predict_slices(x)
        sync(dev)
        counts.append((labels, K.launch_counts()))
    (one_lab, one_counts), (two_lab, two_counts) = counts
    # in turns (one, two, two, one): the chunk to host labels, host clock
    chunk_s = {0: [], 1: []}
    for i in (0, 1, 1, 0):
        chunk_s[i].append(_timed_steps(lambda: infs[i].predict_slices(x), dev, n=3))
    doubled = all(two_counts[k] == 2 * one_counts[k] for k in one_counts)
    equal = bool(np.array_equal(one_lab, two_lab))
    above = 0
    if not equal:
        plain = build_model(cfg, num_classes=9, device=dev, seed=0, impl="plain")
        with torch.no_grad():
            ref = plain(torch.from_numpy(x[..., None]).to(dev)).float().cpu().numpy()
        above = margin_mismatches(two_lab, ref)[0]
    print(f"[ddp] VolumeInferencer(devices=[{dev}, {dev}]) on one {SERVE_BATCH}-slice chunk "
          f"(two parts of {SERVE_BATCH // 2}): labels equal to one device's bit for bit: "
          f"{'yes' if equal else f'no, above_margin={above}'}; launches "
          f"{ {k: v for k, v in two_counts.items() if v} } vs one device "
          f"{ {k: v for k, v in one_counts.items() if v} } doubled: "
          f"{'yes' if doubled else 'no'}; the chunk to host labels {min(chunk_s[1]):.4f} s "
          f"split vs {min(chunk_s[0]):.4f} s whole (in turns, {smi}) "
          f"{'ok' if doubled and above == 0 else 'FAIL'}", flush=True)
    require(doubled and above == 0, f"split inferencer: launches {two_counts} vs "
            f"{one_counts}, above_margin {above}")

    # The native HD95 against scipy on an organ volume.
    require(native.available(), f"native EDT not built: {native.build_error}")
    rng = np.random.default_rng(23)
    _, label, organs = organ_volume(rng, EVAL_SHAPES[0], 4)  # KiTS-like: 3 organs
    _, pred, _ = organ_volume(rng, EVAL_SHAPES[0], 4, like=organs)
    vals, secs = {}, {}
    for route in (True, False):
        t0 = time.perf_counter()
        vals[route] = [metrics.hd95(pred == c, label == c, use_native=route)
                       for c in range(1, 4)]
        secs[route] = time.perf_counter() - t0
    diff = max(abs(a - b) for a, b in zip(vals[True], vals[False]))
    print(f"[ddp] native HD95 vs scipy on {EVAL_SHAPES[0]}, 3 classes: max |diff| "
          f"{diff:.3e}; native {secs[True]:.3f}s, scipy {secs[False]:.3f}s a volume "
          f"({native.library_path().name}) {'ok' if diff <= 1e-9 else 'FAIL'}", flush=True)
    require(diff <= 1e-9, f"native HD95 vs scipy: {vals}")

    # A device trace of one train step.
    trace_dir = os.path.join(workdir, "ddp_trace")
    with device_trace(trace_dir) as prof:
        ref_step()
    with open(os.path.join(trace_dir, "trace.json")) as f:
        names = [ev.get("name", "") for ev in json.load(f).get("traceEvents", [])]
    ours = sum(1 for n in names if KERNEL_SYMBOLS.search(n))
    gpu_ms = sum(e.device_time_total for e in prof.key_averages()) / 1e3
    print(f"[ddp] device_trace of one step: trace.json with {len(names)} events, "
          f"{ours} of the port's kernels, device time {gpu_ms:.3f} ms "
          f"{'ok' if ours > 0 else 'FAIL'}", flush=True)
    require(ours > 0, "device_trace recorded none of the port's kernels")
    print(f"[ddp] phase seconds {time.perf_counter() - t_phase:.1f}", flush=True)
    total = {k: sum(r["counts"][k] for r in ranks) + two_counts[k] for k in SOURCES}
    return total


# ---------------------------------------------------------------------------
# phase 10: base-384 served, trained and evaluated
# ---------------------------------------------------------------------------

def base384_run(dev, workdir: str, smi: str) -> tuple[KernelTally, dict[str, dict[str, int]]]:
    """base-384 (``configs/cswin_base_384.yaml``) at full width and depth,
    9 classes: its kernels, modules, the device augmentation and the blur on
    the card, then the serve, train and eval paths through their entry
    points. Returns the kernels' tally at base-384's shapes and the launch
    counts of the three paths."""
    cfg = smoke_config(cfg=CFG384)
    cs = cfg.MODEL.CSWIN
    print(f"[base384] {os.path.relpath(CFG384, ROOT)}: img {cfg.DATA.IMG_SIZE}, embed "
          f"{cs.EMBED_DIM}, depths {list(cs.DEPTH)}, heads {list(cs.NUM_HEADS)}, split "
          f"{list(cs.SPLIT_SIZE)}, drop-path {cfg.MODEL.DROP_PATH_RATE}; CARAFE sites "
          f"{carafe_sites(cfg)}", flush=True)
    tally = compare_kernels(cfg, dev, SERVE_BATCH, extra=False, tag="base384:kernel")
    compare_backward_kernels(cfg, dev, TRAIN_BATCH, tally)
    compare_module_grads(cfg, dev, TRAIN_BATCH, extra=False, tag="base384:module")
    augment_on_card(dev)
    blur_on_card(dev)
    root = os.path.join(workdir, "base384")
    os.makedirs(root)
    counts = dict(serve384=serve384(cfg, dev, root, smi))
    counts["train384"], data, ck = train384(cfg, dev, root)
    train384_checks(cfg, dev, data, smi)
    route_phase(CFG384, dev, "base384:route")
    counts["eval384"] = eval384(cfg, dev, ck)
    return tally, counts


def augment_on_card(dev) -> None:
    """``ops.augment`` on the card at base-384's slices against the same
    ops on the CPU, bit for bit: ``augment_batch`` at one set of draws (bs
    24), every (k, axis) of ``rot_flip`` and every angle of
    ``rotate_nearest``; then the branch shares of 4000 draws from a CUDA
    generator within 4 standard deviations, as the CPU test holds them."""
    import torch

    from cswin_unet_tpu_torch.ops import augment as A

    rng = np.random.default_rng(26)
    n = 384
    img = torch.from_numpy(rng.standard_normal((TRAIN_BATCH, n, n, 1)).astype(np.float32))
    lab = torch.from_numpy(rng.integers(0, 9, (TRAIN_BATCH, n, n)).astype(np.int32))
    d = A.draw(TRAIN_BATCH, torch.Generator().manual_seed(3), torch.device("cpu"))
    on = lambda t: t.to(dev)
    cases = [("augment_batch at fixed draws", A.apply_draws(img, lab, d),
              A.apply_draws(on(img), on(lab), {k: on(v) for k, v in d.items()}))]
    k, axis = torch.arange(8) // 2, torch.arange(8) % 2
    cases.append(("rot_flip, every (k, axis)", A.rot_flip(img[:8, ..., 0], lab[:8], k, axis),
                  A.rot_flip(on(img[:8, ..., 0]), on(lab[:8]), on(k), on(axis))))
    angles = torch.arange(-20, 20)
    one_i, one_l = img[:1, ..., 0].expand(40, n, n), lab[:1].expand(40, n, n)
    cases.append(("rotate_nearest, every angle in [-20, 20)",
                  A.rotate_nearest(one_i, one_l, angles),
                  A.rotate_nearest(on(one_i), on(one_l), on(angles))))
    torch.cuda.synchronize()
    for what, (ci, cl), (gi, gl) in cases:
        same = torch.equal(ci, gi.cpu()) and torch.equal(cl, gl.cpu())
        print(f"[base384:augment] {what} on the card vs the CPU: bit for bit "
              f"{'yes ok' if same else 'no FAIL'}", flush=True)
        require(same, f"augment: {what} differs between the card and the CPU")
    draws = 4000
    flip, rotate = A.branches(A.draw(draws, torch.Generator(device=dev).manual_seed(0), dev))
    shares = []
    for name, mask, p in (("rot/flip", flip, 0.5), ("rotate", rotate, 0.25),
                          ("identity", ~flip & ~rotate, 0.25)):
        got, sd = float(mask.float().mean()), np.sqrt(p * (1 - p) / draws)
        shares.append((name, got, p, abs(got - p) <= 4 * sd))
    ok = all(s[-1] for s in shares)
    gen = torch.Generator(device=dev).manual_seed(1)
    img_d, lab_d = on(img), on(lab)
    ms = time_ms(lambda: A.augment_batch(img_d, lab_d, gen), reps=10, rounds=3)
    print(f"[base384:augment] branch shares of {draws} draws from a CUDA generator: "
          + ", ".join(f"{n_} {g:.4f} (expected {p})" for n_, g, p, _ in shares)
          + f", each within 4 sd {'ok' if ok else 'FAIL'}; augment_batch of "
          f"({TRAIN_BATCH}, {n}, {n}, 1) ms={ms:.4f}", flush=True)
    require(ok, f"augment branch shares {shares}")


def blur_on_card(dev) -> None:
    """``gaussian_blur_2d`` of a (48, 512, 512) CT-like volume on the card
    at σ 1.5 (the test volumes' blur) against scipy's ``gaussian_filter``
    of each slice, within 1e-5."""
    import torch
    from scipy.ndimage import gaussian_filter

    from cswin_unet_tpu_torch.ops.blur import gaussian_blur_2d

    vol, _, _ = organ_volume(np.random.default_rng(28), EVAL_SHAPES[0], 9)
    vol_d = torch.from_numpy(vol).to(dev)
    got = gaussian_blur_2d(vol_d, 1.5).cpu().numpy()
    t0 = time.perf_counter()
    want = gaussian_filter(vol, (0, 1.5, 1.5))
    host_s = time.perf_counter() - t0
    err = float(np.abs(got - want).max())
    ms = time_ms(lambda: gaussian_blur_2d(vol_d, 1.5), reps=3, rounds=3)
    print(f"[base384:blur] gaussian_blur_2d {vol.shape} sigma 1.5 on the card vs scipy: "
          f"max_abs={err:.3e} (limit 1e-5) ms={ms:.4f} scipy_s={host_s:.3f} "
          f"{'ok' if err <= 1e-5 else 'FAIL'}", flush=True)
    require(err <= 1e-5, f"blur: max abs {err:.3e}")


def serve384(cfg, dev, workdir: str, smi: str) -> dict[str, int]:
    """A seeded base-384 checkpoint in the JAX package's ``.npz`` format,
    served through ``VolumeServer``: one (40, 512, 512) volume at 32-slice
    chunks to NIfTI, its launches as routed; the first chunk's forward
    against the plain route by the margin rule (and its labels, zoomed back,
    equal to the served ones); then the 32-slice forward on both routes in
    interleaved rounds, with device busy and its bf16 bound."""
    import torch
    from scipy.ndimage import zoom as nd_zoom

    from cswin_unet_tpu_torch.models import build_model
    from cswin_unet_tpu_torch.ops.cuda import kernels as K
    from cswin_unet_tpu_torch.serve import VolumeServer
    from cswin_unet_tpu_torch.utils.checkpoint import (load_checkpoint, load_into,
                                                       save_checkpoint)
    from cswin_unet_tpu_torch.utils.flops import count_flops, count_params
    from cswin_unet_tpu_torch.utils.profiling import device_busy_ms

    nc, batch, img = 9, SERVE_BATCH, cfg.DATA.IMG_SIZE
    t0 = time.perf_counter()
    seeded = build_model(cfg, num_classes=nc, device="cpu", seed=0)
    ck = save_checkpoint(os.path.join(workdir, "base384_seed0.npz"),
                         seeded.cswin_unet.state_dict())
    print(f"[base384:serve] checkpoint {os.path.basename(ck)} {count_params(seeded)} "
          f"parameters, {os.path.getsize(ck) / 2**20:.1f} MiB, in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    del seeded

    def from_checkpoint(impl):
        model = build_model(cfg, num_classes=nc, device=dev, impl=impl, seed=1)
        n = load_into(model.cswin_unet, load_checkpoint(ck)[0])
        require(n == len(model.cswin_unet.state_dict()), f"loaded {n} tensors")
        return model

    server = VolumeServer(from_checkpoint("fused"), device=dev, img_size=img,
                          batch_slices=batch)
    print(f"[base384:serve] warmup_s={server.warmup():.3f}", flush=True)
    shape = (40, 512, 512)
    vol = np.random.default_rng(29).standard_normal(shape).astype(np.float32)
    path = os.path.join(workdir, "ct40_512.npy")
    np.save(path, vol)
    K.reset_launch_counts()
    torch.cuda.synchronize()
    st = server.process_file(path, os.path.join(workdir, "served"))
    torch.cuda.synchronize()
    counts = K.launch_counts()
    forwards = -(-shape[0] // batch)
    want = expected_launches(cfg, forwards)
    print(json.dumps(st), flush=True)
    print(f"[base384:serve] launches {counts} expected {want} ({forwards} forwards)",
          flush=True)
    require(counts == want, f"base384 serve launches {counts} != routing {want}")
    served = read_nifti(st["output"], shape)
    require(bool(np.all((served >= 0) & (served < nc) & (served == np.round(served)))),
            f"labels outside [0, {nc})")

    # The first chunk as the server zoomed it, on both routes.
    x = torch.from_numpy(np.stack([nd_zoom(s, (img / 512, img / 512), order=3)
                                   for s in vol[:batch]]).astype(np.float32)[..., None]).to(dev)
    models = dict(fused=server.inferencer.model, plain=from_checkpoint("plain"))
    with torch.inference_mode():
        ref = models["plain"](x)
        labels = models["fused"](x, emit="labels")
    require(bool(torch.isfinite(ref).all()), "non-finite plain logits")
    raw, above = margin_mismatches(labels, ref)
    back = np.stack([nd_zoom(s, (512 / img, 512 / img), order=0)
                     for s in labels.cpu().numpy()])
    same = bool(np.array_equal(back, served[:batch]))
    print(f"[base384:serve] chunk ct40[0:{batch}] vs plain path: mismatches={raw}/"
          f"{labels.numel()} above_margin={above}; zoomed back equal to the served labels: "
          f"{'yes' if same else 'no'}", flush=True)
    require(above == 0 and same, f"base384 chunk: {above} above the margin, served {same}")

    def forward(model):
        with torch.inference_mode():
            return model(x, emit="labels")

    times = {k: [] for k in models}
    for r in range(4):
        for k in list(models)[::1 if r % 2 == 0 else -1]:
            times[k].append(time_ms(lambda: forward(models[k]), reps=2, rounds=1))
    busy = {k: device_busy_ms(lambda: forward(models[k]), 2) for k in models}
    flops = count_flops(models["plain"], img) * batch
    bound = flops / TC_FLOPS * 1e3
    print(f"[base384:e2e] forward {batch} slices to labels, ms median [min-max] of 4 "
          f"interleaved rounds: " + "; ".join(
              f"{k} {statistics.median(v):.3f} [{min(v):.3f}-{max(v):.3f}] "
              f"({batch / statistics.median(v) * 1e3:.1f} slices/s) busy "
              f"{'not measured' if busy[k] is None else f'{busy[k]:.3f}'}"
              for k, v in times.items())
          + f"; bf16 bound {bound:.3f} ms ({flops / 1e12:.2f} TFLOP by torch's count); "
          f"on {smi}", flush=True)
    return counts


def train384(cfg, dev, workdir: str) -> tuple[dict[str, int], str, str]:
    """``python -m cswin_unet_tpu_torch.train`` (its ``main``) at base-384,
    bs 24, drop-path 0.5 and ``--device_augment`` for one epoch over 48
    synthetic 512x512 slices (2 steps): launches as routed, finite losses in
    the log, ``epoch_0.npz``; peak device memory and seconds printed.
    Returns the launches, the data directory and the checkpoint."""
    import torch

    from cswin_unet_tpu_torch.ops.cuda import kernels as K
    from cswin_unet_tpu_torch.train import __main__ as train_cli

    slices = 48
    data = os.path.join(workdir, "synapse")
    t0 = time.perf_counter()
    list_dir = write_train_slices(data, slices, 512, 9, seed=25)
    lists = os.path.join(workdir, "lists", "lists_Synapse_blurred")  # the CLI's list dir
    os.makedirs(lists)
    shutil.copy(os.path.join(list_dir, "train.txt"), lists)
    print(f"[base384:train] wrote {slices} slices 512x512 in {time.perf_counter() - t0:.1f}s",
          flush=True)
    out = os.path.join(workdir, "run")
    gc.collect()  # the step takes ~70 GiB of the card's 80: free the earlier phases' cache
    torch.cuda.empty_cache()
    argv = ["--cfg", CFG384, "--root_path", data, "--dataset", "Synapse", "--output_dir", out,
            "--max_epochs", "1", "--batch_size", str(TRAIN_BATCH), "--img_size",
            str(cfg.DATA.IMG_SIZE), "--device_augment", "--device", str(dev)]
    cwd = os.getcwd()
    K.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    os.chdir(workdir)
    try:
        msg = train_cli.main(argv)
    finally:
        os.chdir(cwd)
    torch.cuda.synchronize()
    secs, peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    counts = K.launch_counts()
    steps = slices // TRAIN_BATCH
    want = expected_train_launches(cfg, steps)
    print(f"[base384:train] python -m cswin_unet_tpu_torch.train {' '.join(argv[2:])}: "
          f"{msg} {steps} steps in {secs:.1f}s (model build and loader included), peak "
          f"device memory {peak / 2**30:.2f} GiB; launches {counts} expected {want}",
          flush=True)
    require(msg == "Training Finished!", f"train CLI: {msg}")
    require(counts == want, f"base384 train launches {counts} != routing {want}")
    with open(os.path.join(out, "log.txt")) as f:
        log = f.read()
    its = re.findall(r"iteration (\d+) : loss : (\S+), loss_ce: (\S+)", log)
    require([int(i) for i, _, _ in its] == list(range(1, steps + 1))
            and all(np.isfinite(float(a)) and np.isfinite(float(b)) for _, a, b in its),
            f"base384 train log lines {its}")
    ck = os.path.join(out, "epoch_0.npz")
    require(os.path.exists(ck) and f"save model to {ck}" in log, f"missing {ck}")
    print(f"[base384:train] log: losses {[float(a) for _, a, _ in its]}; "
          f"{os.path.basename(ck)} {os.path.getsize(ck) / 2**20:.1f} MiB", flush=True)
    return counts, data, ck


def train384_checks(cfg, dev, data: str, smi: str) -> None:
    """At base-384 on 24 of the synthetic slices: one bs-24 step of the
    trainer's step (``--device_augment``) and its launches, then its
    seconds and peak memory over 3 steps; the same with ``--use-checkpoint``
    (its first loss equal bit for bit); gradient parity of the kernel
    route against the plain route on the first ``PARITY384_BATCH`` of them,
    augmented once (the float32 plain route at bs 24 would not fit beside
    the others)."""
    import torch

    from cswin_unet_tpu_torch.data import EvalResize, SynapseDataset
    from cswin_unet_tpu_torch.losses import segmentation_loss
    from cswin_unet_tpu_torch.models import build_model
    from cswin_unet_tpu_torch.ops.augment import augment_batch
    from cswin_unet_tpu_torch.ops.cuda import kernels as K
    from cswin_unet_tpu_torch.train import make_optimizer, make_train_step

    nc, size = 9, cfg.DATA.IMG_SIZE
    ds = SynapseDataset(os.path.join(data, "train_npz"), os.path.join(data, "lists"),
                        "train", transform=EvalResize([size, size]))
    samples = [ds[i] for i in range(TRAIN_BATCH)]
    img = torch.from_numpy(np.stack([s["image"] for s in samples])).to(dev)
    lab = torch.from_numpy(np.stack([s["label"] for s in samples])).to(dev)

    model = build_model(cfg, num_classes=nc, device=dev, seed=3, train=True)
    opt, sched = make_optimizer(model.parameters(), 0.01, 1000)
    gen = torch.Generator(device=dev).manual_seed(12)
    step = make_train_step(model, opt, sched, nc, device_augment=True)
    K.reset_launch_counts()
    torch.cuda.synchronize()
    loss = float(step(img, lab, gen)["loss"])
    torch.cuda.synchronize()
    counts, want = K.launch_counts(), expected_train_launches(cfg, 1)
    print(f"[base384:train] one step's launches {counts} expected {want}; loss {loss:.5f}",
          flush=True)
    require(counts == want and np.isfinite(loss), f"one base384 step: launches {counts}, "
            f"loss {loss}")
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(img, lab, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    print(f"[base384:e2e] train step bs {TRAIN_BATCH} (device augment, fwd + bwd + SGD), "
          f"host clock around synchronized steps: median {statistics.median(times):.4f}s "
          f"[{min(times):.4f}-{max(times):.4f}] ({TRAIN_BATCH / statistics.median(times):.1f} "
          f"samples/s); peak device memory {peak / 2**30:.2f} GiB; on {smi}", flush=True)
    del model, opt, sched, step
    torch.cuda.empty_cache()

    # --use-checkpoint (TRAIN.USE_CHECKPOINT): each block recomputed in the
    # backward, the same draws, so its first step's loss is the same bits.
    ck_cfg = smoke_config(["TRAIN.USE_CHECKPOINT", "True"], cfg=CFG384)
    model = build_model(ck_cfg, num_classes=nc, device=dev, seed=3, train=True)
    opt, sched = make_optimizer(model.parameters(), 0.01, 1000)
    step = make_train_step(model, opt, sched, nc, device_augment=True)
    gen = torch.Generator(device=dev).manual_seed(12)
    torch.cuda.reset_peak_memory_stats()
    ck_loss = float(step(img, lab, gen)["loss"])
    ck_times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(img, lab, gen)
        torch.cuda.synchronize()
        ck_times.append(time.perf_counter() - t0)
    ck_peak = torch.cuda.max_memory_allocated()
    print(f"[base384:e2e] train step bs {TRAIN_BATCH} with --use-checkpoint: "
          f"{' '.join(f'{t:.4f}' for t in ck_times)}s, peak device memory "
          f"{ck_peak / 2**30:.2f} GiB; first loss {ck_loss:.6f} equal to the step's without "
          f"it bit for bit: {'yes' if ck_loss == loss else 'no'}", flush=True)
    require(ck_loss == loss, f"--use-checkpoint moved the loss: {ck_loss} != {loss}")
    del model, opt, sched, step
    torch.cuda.empty_cache()

    b = PARITY384_BATCH
    x, y = augment_batch(img[:b], lab[:b], torch.Generator(device=dev).manual_seed(13))

    def grads(impl, dtype):
        model = build_model(cfg, num_classes=nc, device=dev, impl=impl, dtype=dtype,
                            seed=3, train=True)
        g = torch.Generator(device=dev).manual_seed(11)
        loss, _ = segmentation_loss(model(x, generator=g), y, nc)
        names, params = zip(*model.named_parameters())
        out = loss.detach(), dict(zip(names, torch.autograd.grad(loss, params)))
        del model, loss
        torch.cuda.empty_cache()
        return out

    grad_parity("base384:train", f"fixed batch of {b}, augmented, drop-path "
                f"{cfg.MODEL.DROP_PATH_RATE}", grads("fused", torch.bfloat16),
                grads("plain", torch.bfloat16), grads("plain", torch.float32))


def eval384(cfg, dev, ck: str) -> dict[str, int]:
    """The trained checkpoint through test.py's evaluation at patch 384 on a
    (48, 512, 512) organ-like volume: its seconds per volume by part (host
    zoom, segmentation, device metrics, host metrics) and the device
    metrics against the host's; then ``eval.inference.inference`` with
    device metrics, its per-class means against the host's. Launches of both
    passes as routed (two forwards and 48 ``edt_pass`` launches each)."""
    import argparse

    import torch
    from scipy.ndimage import zoom as nd_zoom

    from cswin_unet_tpu_torch.eval.inference import VolumeInferencer, inference
    from cswin_unet_tpu_torch.metrics import volume_metrics
    from cswin_unet_tpu_torch.models import build_model
    from cswin_unet_tpu_torch.ops.cuda import kernels as K
    from cswin_unet_tpu_torch.ops.edt import volume_metrics_device, zoom_nearest
    from cswin_unet_tpu_torch.utils.checkpoint import load_checkpoint, load_into

    nc, img = 9, cfg.DATA.IMG_SIZE
    image, label, _ = organ_volume(np.random.default_rng(27), EVAL_SHAPES[0], nc)
    model = build_model(cfg, num_classes=nc, device=dev, seed=1)
    require(load_into(model.cswin_unet, load_checkpoint(ck)[0])
            == len(model.cswin_unet.state_dict()), f"{ck} into the model")
    inferencer = VolumeInferencer(model, device=dev, patch_size=(img, img))
    inferencer.predict_slices(np.zeros((1, img, img), np.float32))  # warm up
    K.reset_launch_counts()
    torch.cuda.synchronize()
    d, h, w = image.shape
    t0 = time.perf_counter()
    slices = np.stack([nd_zoom(s, (img / h, img / w), order=3) for s in image]).astype(
        np.float32)
    t1 = time.perf_counter()
    preds = zoom_nearest(inferencer.predict_slices_device(slices), (h, w))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    on_dev = volume_metrics_device(preds, torch.from_numpy(label.astype(np.int32)).to(dev),
                                   nc).cpu().numpy()
    t3 = time.perf_counter()
    host_pred = preds.cpu().numpy()
    t4 = time.perf_counter()
    on_host = np.array(volume_metrics(host_pred, label, nc))
    t5 = time.perf_counter()
    ok = metrics_agree(on_dev, on_host)
    print(f"[base384:eval] case0000 {image.shape} at patch {img}: zoom_s={t1 - t0:.3f} "
          f"segment_s={t2 - t1:.3f} device_metrics_s={t3 - t2:.3f} host_metrics_s="
          f"{t5 - t4:.3f} (labels to host {t4 - t3:.3f}); device vs host max |diff| "
          f"{np.abs(on_dev - on_host).max():.3e} {'ok' if ok else 'FAIL'}", flush=True)
    require(ok, f"base384 eval: device {on_dev.tolist()} vs host {on_host.tolist()}")

    log = EvalLog()
    root = logging.getLogger()
    saved_handlers, saved_level = root.handlers[:], root.level
    root.handlers[:] = [log]
    root.setLevel(logging.INFO)
    try:
        t0 = time.perf_counter()
        inference(argparse.Namespace(num_classes=nc, img_size=img, z_spacing=1,
                                     device_metrics=True), inferencer,
                  [dict(image=image, label=label, case_name="case0000")])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        root.handlers[:] = saved_handlers
        root.setLevel(saved_level)
    counts = K.launch_counts()
    forwards = 2 * -(-d // SERVE_BATCH)
    want = expected_launches(cfg, forwards)
    want["edt_pass"] = 2 * (nc - 1) * 2 * 3
    means = class_means(log.lines)
    print(f"[base384:eval] inference() of one volume with device metrics in {secs:.3f}s; "
          f"its per-class means vs the host metrics above: "
          f"{'ok' if metrics_agree(means, on_host) else 'FAIL'}; launches of both passes "
          f"{counts} expected {want}", flush=True)
    require(len(means) == nc - 1 and metrics_agree(means, on_host),
            f"base384 inference(): {means.tolist()} vs host {on_host.tolist()}")
    require(counts == want, f"base384 eval launches {counts} != routing {want}")
    return counts


# ---------------------------------------------------------------------------
# phase 11: the block lab
# ---------------------------------------------------------------------------

def compare_lab(dev, tally: KernelTally) -> None:
    """``lepe_windows``, ``window_attention``, ``ln_mlp`` and ``block_one``
    (every part on at stages 1-4) against their plain versions at the lab's full shapes: the lab's own
    cases (``block_lab.Case``), each once in the tally, with the library
    yardsticks built from the cases' inputs; then the launch counts the
    cases imply (one check, one warm-up and 5 x ``LAB_REPS`` timed calls
    each), and the blocks' chain on the same inputs beside them
    (``chain_ms``, the same four cases as ``block_one``'s ms)."""
    import torch
    import torch.nn.functional as F

    from cswin_unet_tpu_torch.ops.cuda import kernels as K
    from cswin_unet_tpu_torch.ops.windows import window_partition
    from cswin_unet_tpu_torch.tools import block_lab as L

    inp = L.Inputs(dev, seed=21)
    bf = torch.bfloat16

    def conv2d(v, taps, bias, sp_h, sp_w, swap=False, nchw=False, **_):
        """The library's depthwise conv on the window batch: on the
        channels-last view of V as it lies, or on a contiguous NCHW copy
        made outside the timed region."""
        c = v.shape[-1]
        x = v.reshape(-1, sp_h, sp_w, c).permute(0, 3, 1, 2)
        x = x.contiguous() if nchw else x
        taps = taps.transpose(0, 1) if swap else taps
        w, b = taps.permute(2, 0, 1)[:, None].to(bf).contiguous(), bias.to(bf)
        return lambda: F.conv2d(x, w, b, padding=1, groups=c)

    def sdpa(q, k, v, heads, scale, h_sp=None, w_sp=None, **_):
        """The library's attention on the same windows, (n, heads, L, d)
        views. For windows that are not runs of pixels (columns) the call is
        given a windowed copy made outside the timed region."""
        if q.dim() == 4:
            q, k, v = (window_partition(t, h_sp, w_sp) for t in (q, k, v))
        n, Lw, C = q.shape
        q, k, v = (t.reshape(n, Lw, heads, C // heads).permute(0, 2, 1, 3) for t in (q, k, v))
        return lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)

    pick = lambda st, rungs: [c for c in L.bisect_stage(inp, LAB_BATCH, st)
                              if c.name.split()[1] in rungs]
    g1 = L.STAGES[1]
    x = inp.bf16(LAB_BATCH, g1["H"], g1["W"], g1["C"])
    p = L.stage1_params(inp, g1["C"])
    modes = ("attention", "no_softmax", "copy", "softmax", "stage")
    plain_geometry = L.lepe_cases(inp, LAB_BATCH, (3, 2, 1))  # F.conv2d computes these
    cases = (plain_geometry
             + pick(3, ("d", "f")) + pick(1, ("k_taps", "k_full"))  # packed V, two tap
             # sets, two sources stacked on channels, their fold
             + L.attn_cases(inp, LAB_BATCH, (1,), modes=modes)
             + [c for c in L.attn3_cases(inp, LAB_BATCH, (3,)) if "window_attention" in c.launches]
             + [L.mlp_case(f"act={act} ln={int(ln)} fold={int(fold)}", x, p, act, ln, fold)
                for act, ln, fold in (("gelu", True, False), ("clamp", True, False),
                                      ("gelu", False, False), ("gelu", False, True),
                                      ("clamp", False, True))])
    cases += [c for c in L.ablate_cases(inp, LAB_BATCH, (1, 2, 3, 4))
              if c.args["variant"] == "full"]
    n_cases = dict.fromkeys(("lepe_windows", "window_attention", "ln_mlp", "block_one"), 0)
    K.reset_launch_counts()
    for c in cases:
        (name, per_run), = c.launches.items()
        require(per_run == 1, f"{c.name}: not one launch")
        n_cases[name] += 1
        library = None
        if any(c is g for g in plain_geometry):
            library = conv2d(**c.args)
        elif name == "window_attention" and c.args["mode"] == "attention":
            library = sdpa(**c.args)
        tally.case(name, f"{c.name} {c.shape}", c.run, c.plain, 1, reps=LAB_REPS,
                   primed=True, library=library, moved=c.moved, tc_flops=c.tc_flops,
                   f32_ops=c.f32_ops)
        if library is not None and name == "lepe_windows":
            nchw = time_ms(conv2d(**c.args, nchw=True), reps=LAB_REPS, primed=True)
            print(f"[kernel] lepe_windows {c.name}: F.conv2d on a contiguous NCHW copy "
                  f"library_nchw_ms={nchw:.4f}", flush=True)
    require(n_cases == dict(lepe_windows=10, window_attention=15, ln_mlp=5, block_one=4),
            f"lab kernel cases: {n_cases}")
    mlp_chain_total = 0.0
    for c in cases:  # each ln_mlp mode beside the port's unfused launches of it
        if "ln_mlp" not in c.launches:
            continue
        a = c.args
        chain = lambda a=a: L.mlp_chain(a["x"], a["weights"], a["act"], a["ln"], a["fold"])
        err = rel_l2(chain().float(), c.plain().float())
        ms = time_ms(chain, reps=LAB_REPS, primed=True)
        mlp_chain_total += ms
        print(f"[kernel] ln_mlp {c.name}: the chain of unfused launches on the same rows "
              f"(block_lab.mlp_chain) chain_ms={ms:.4f} (rel_l2 {err:.3e} vs plain); no "
              "single PyTorch call computes the function (library_ms none)", flush=True)
        require(err <= TOL, f"ln_mlp {c.name}: the chain's rel_l2 {err:.3e}")
    tally.rows["ln_mlp"]["chain_ms"] = mlp_chain_total
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for c in plain_geometry[::2]:
        v = c.args["v"]
        plan = K.lepe_windows_kernel_plan(v.shape[0], c.args["sp_h"], c.args["sp_w"], v.shape[-1],
                                          c.args["sp_h"], c.args["sp_w"])
        print(f"[kernel] lepe_windows {c.name} plan {plan}", flush=True)
        require(plan == K.lepe_windows_plan(v.shape[0], c.args["sp_h"], c.args["sp_w"],
                                            v.shape[-1], c.args["sp_h"], c.args["sp_w"],
                                            ctas_per_sm=plan.ctas_per_sm, sms=sms),
                f"lepe_windows {c.name}: the kernel's plan is not lepe_windows_plan's")
    plan = K.ln_mlp_kernel_plan(x.numel() // x.shape[-1])
    print(f"[kernel] ln_mlp {tuple(x.shape)} plan {plan}", flush=True)
    require(plan == K.ln_mlp_plan(x.numel() // x.shape[-1], ctas_per_sm=plan.ctas_per_sm,
                                  sms=sms), "ln_mlp: the kernel's plan is not ln_mlp_plan's")

    counts = K.launch_counts()
    per_case = 2 + 5 * LAB_REPS
    want = {k: n * per_case for k, n in n_cases.items()}
    got = {k: counts[k] for k in want}
    print(f"[lab] launches of the [kernel] cases {got} expected {want}", flush=True)
    require(got == want, f"lab kernel cases: launches {got} != {want}")

    from cswin_unet_tpu_torch.ops.cuda.cswin_block import fused_cswin_block

    chain_total = 0.0
    for c in cases:
        if "block_one" not in c.launches:
            continue
        g = L.STAGES[c.args["stage"]]
        x1, p1 = L.script_block(c.args["stage"], LAB_BATCH, dev)
        kw = dict(heads=g["heads"], split=g["split"], scale=(g["C"] // g["heads"]) ** -0.5,
                  last_stage=g["last"])
        ms = time_ms(lambda: fused_cswin_block(x1, p1, **kw), reps=LAB_REPS, primed=True)
        chain_total += ms
        print(f"[kernel] block_one {c.name}: the block chain's launches on the same inputs "
              f"chain_ms={ms:.4f}", flush=True)
    tally.rows["block_one"]["chain_ms"] = chain_total


def lab_identities(dev) -> None:
    """The parts against the whole on the same inputs, stages 1-3, B = 128:
    both branches' ``window_attention`` + ``lepe_windows`` on the thirds of
    one packed qkv within 2 bf16 ulps of ``stripe_attention``; ``block_one``
    with every part on equal to one block chain bit for bit at stages 1-4
    (the last stage's single branch too), weights at scale 0.3; at that
    scale each ``ablate`` variant and ``cum`` level of ``block_one`` within
    ``TOL`` of its plain version and moving the output by more than ``TOL``
    (a switch that did nothing would fail here; at the scripts' 0.05 the
    residual hides some parts, stage 1's LePE to 0.013); at stage 1
    ``ln_mlp`` within relative L2 5e-3 of the chain's second half."""
    import torch

    from cswin_unet_tpu_torch.ops.cuda import kernels as K
    from cswin_unet_tpu_torch.tools import block_lab as L

    inp = L.Inputs(dev, seed=22)
    for st in (1, 2, 3):
        g = L.STAGES[st]
        H, W, C, split = g["H"], g["W"], g["C"], g["split"]
        qkv = inp.bf16(LAB_BATCH, H, W, 3 * C)
        for off, (sp_h, sp_w) in ((0, (H, split)), (C // 2, (split, W))):
            taps, bias = inp.f32(3, 3, C // 2, sc=0.3), inp.f32(C // 2, sc=0.1)
            att, lepe, whole = L.parts_vs_whole(
                qkv, taps, bias, sp_h=sp_h, sp_w=sp_w, heads=g["heads"] // 2,
                scale=(C // g["heads"]) ** -0.5, ch_off=off)
            torch.cuda.synchronize()
            try:
                txt = L.check_parts_vs_whole(att, lepe, whole)
            except L.LabFailure as e:
                raise SmokeFailure(f"stage {st} window {sp_h}x{sp_w}: {e}") from e
            print(f"[lab] identity stage{st} ({LAB_BATCH},{H},{W},{3 * C}) window "
                  f"{sp_h}x{sp_w}: window_attention + lepe_windows {txt} ok", flush=True)
    from cswin_unet_tpu_torch.ops.cuda.cswin_block import fused_cswin_block

    for st in (1, 2, 3, 4):  # the one-block kernel with every part on is the chain
        g = L.STAGES[st]
        x, p = L.script_block(st, LAB_BATCH, dev, scale=0.3)
        kw = dict(heads=g["heads"], split=g["split"], scale=(g["C"] // g["heads"]) ** -0.5,
                  last_stage=g["last"])
        one, chain = K.block_one(x, p, **kw), fused_cswin_block(x, p, **kw)
        torch.cuda.synchronize()
        txt, ok, _ = judge(f"block_one vs chain stage {st}", one, chain, "exact")
        print(f"[lab] identity stage{st} {tuple(x.shape)}: block_one (every part on) vs "
              f"the {'single-branch ' if g['last'] else ''}block chain {txt}; grid "
              f"{K.block_one.grid} {'ok' if ok else 'FAIL'}", flush=True)
        require(ok, f"block_one vs the block chain at stage {st}: {txt}")
        steps = [("variant", v) for v in K.BLOCK_VARIANTS if v != "full"]
        steps += [("level", lv) for lv in range(K.CUM_LEVELS)] if st == 1 else []
        before = "full"
        for key, val in steps:
            got = K.block_one(x, p, **kw, **{key: val})
            want = K.block_one_plain(x, p, **kw, **{key: val})
            torch.cuda.synchronize()
            err, moved = rel_l2(got.float(), want.float()), rel_l2(got.float(), one.float())
            same = g["last"] and val == "no-transpose"  # no vertical branch to window
            ok = (err <= TOL and (bool(torch.equal(got, one)) if same else moved > TOL)
                  and bool(torch.isfinite(got.float()).all()))
            print(f"[lab] identity stage{st} block_one {key} {val}: rel_l2={err:.3e} vs plain, "
                  f"moves the output {moved:.3e} from {before} "
                  f"{'(equal to full) ' if same else ''}{'ok' if ok else 'FAIL'}", flush=True)
            require(ok, f"block_one {key} {val} at stage {st}: rel_l2 {err:.3e}, moves "
                        f"{moved:.3e}")
            if key == "level":
                one, before = got, f"level {val}"
    g = L.STAGES[1]
    x = inp.bf16(LAB_BATCH, g["H"], g["W"], g["C"])
    p = L.stage1_params(inp, g["C"])
    one = K.ln_mlp(x, p["nw"], p["nb"], p["fc1_w"], p["fc1_b"], p["fc2_w"], p["fc2_b"])
    chain = L.chain_mlp(x, p)
    torch.cuda.synchronize()
    err = rel_l2(one.float(), chain.float())
    print(f"[lab] identity stage1 {tuple(x.shape)}: ln_mlp vs layernorm -> gemm(gelu) -> "
          f"gemm(residual) rel_l2={err:.3e} max_abs="
          f"{float((one.float() - chain.float()).abs().max()):.3e} "
          f"{'ok' if err <= 5e-3 else 'FAIL'}", flush=True)
    require(err <= 5e-3, f"ln_mlp vs the chain's second half: rel_l2 {err:.3e}")


def lab_run() -> dict[str, int]:
    """The lab's entry point once per subcommand at full width, output shown;
    returns the launch counts of the runs, which must be exactly what the
    printed cases imply: each case runs once for its check (once more where
    it has a further check), once to warm up and ``ROUNDS`` x ``REPS`` times
    under the clock."""
    import torch

    from cswin_unet_tpu_torch.ops.cuda import kernels as K
    from cswin_unet_tpu_torch.tools import block_lab

    rows: list[dict] = []
    K.reset_launch_counts()
    torch.cuda.synchronize()
    for sub in sorted(block_lab.SUBCOMMANDS):
        require(block_lab.main([sub, "--batch", str(LAB_BATCH)], rows) == 0,
                f"block_lab {sub} failed")
    torch.cuda.synchronize()
    counts = K.launch_counts()
    want = dict.fromkeys(counts, 0)
    for row in rows:
        runs = 2 + block_lab.ROUNDS * block_lab.REPS + (1 if row["extra"] else 0)
        for k, n in row["per_run"].items():
            want[k] += n * runs
    print(f"[lab] {len(rows)} cases over {len(block_lab.SUBCOMMANDS)} subcommands; "
          f"launches {counts} expected {want}", flush=True)
    require(counts == want, f"lab launches {counts} != implied by its cases {want}")
    require(all(counts[k] > 0 for k in ("lepe_windows", "window_attention", "ln_mlp",
                                        "block_one")),
            f"the lab did not launch its kernels: {counts}")
    return counts


def ptxas_resources(log: str, entry: str) -> list[tuple[str, int, int, int]]:
    """(entry, registers, spill store bytes, spill load bytes) from nvcc's
    ``-Xptxas -v`` output, for every compiled entry whose mangled name holds
    ``entry``."""
    found, current, spills = [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current, spills = m.group(1), None
            continue
        if current is None or entry not in current:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and spills is not None:
            found.append((current, int(m.group(1)), *spills))
            current = None
    return found


def tensor_core_ops(so: str, tool: str) -> dict[str, int]:
    """Tensor-core instructions (``HMMA``, ``HGMMA``) in the SASS of each
    compiled kernel entry of the library, by mangled name, from ``cuobjdump
    -sass``."""
    sass = subprocess.run([tool, "-sass", so], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = m.group(1)
            counts[current] = 0
        elif current is not None and re.search(r"\bHG?MMA\b", line):
            counts[current] += 1
    return counts


def smoke_config(opts=None, cfg: str = CFG):
    """A config from the port's own YAML (tiny-224 unless ``cfg`` names
    another), with ``--opts``."""
    from cswin_unet_tpu_torch.config import get_config

    class _Args:
        pass

    _Args.cfg = cfg

    _Args.opts = opts
    return get_config(_Args)


def main() -> int:
    import torch

    t_main = time.perf_counter()
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

    from cswin_unet_tpu_torch.ops.cuda import build

    cfg = smoke_config()
    t0 = time.perf_counter()
    build.library()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.1f}s "
          f"(nvcc {build.build_seconds if build.build_seconds is not None else 'cached'})",
          flush=True)
    for line in build.build_log.splitlines():  # ptxas -v: registers, spills
        if any(w in line for w in ("Compiling entry", "Used", "spill")):
            print(f"[build] {line.strip()}", flush=True)
    if build.build_log:
        spills = ptxas_resources(build.build_log, "block_pair_kernel")
        print(f"[build] block_pair (entry, registers, spill stores, spill loads): {spills}",
              flush=True)
        require(bool(spills) and all(st == ld == 0 for _, _, st, ld in spills),
                f"block_pair: ptxas reports spills {spills}")
        for entry in ("block_pair_f32_kernel", "carafe_f32_kernel",
                      "block_one_kernel", "layernorm_kernel", "layernorm_bwd_kernel",
                      "carafe_kernel", "edt_pass_kernel", "lepe_windows_kernel",
                      "ln_mlp_kernel", "gemm_kernel", "wgrad_kernel", "gemm_f32_kernel",
                      "wgrad_f32_kernel", "stripe_attention_f32_kernel",
                      "stripe_attention_bwd_f32_rows_kernel",
                      "stripe_attention_bwd_f32_keys_kernel"):
            res = ptxas_resources(build.build_log, entry)
            print(f"[build] {entry} (entry, registers, spill stores, spill loads): {res}",
                  flush=True)
            require(bool(res), f"{entry}: no ptxas resource line")
            # the float32 pair at its 3-CTA cap spills a few hundred bytes
            # outside its attention phase (PERF.md, the float32 pair); it runs on no
            # committed route
            if entry not in ("block_one_kernel", "layernorm_kernel", "carafe_kernel",
                             "edt_pass_kernel", "block_pair_f32_kernel"):
                # the lab's persistent kernels; the GEMMs' dropout instances,
                # which hold the Philox state beside the tile; the float32
                # instances (LN's 768 channels: twice the bytes a lane; the
                # attention backward's k, v, dK and dV of a key a lane; the
                # attention tile's 8 x 3 score and 8 x d/4 product blocks)
                require(all(st == ld == 0 for _, _, st, ld in res), f"{entry}: spills {res}")
    # The tiles' products run on the tensor cores: the SASS of the attention
    # and GEMM kernels, of the backward's weight gradient and attention, of
    # the CARAFE kernel's encoder conv and of the lab's ln_mlp holds HMMA
    # (mma.sync) or HGMMA (wgmma). A mangled name carries the length of the
    # kernel's name before it, then I (template) or E.
    tc = tensor_core_ops(str(build.library_path()), build.cuobjdump())
    for family in ("stripe_attention_kernel", "gemm_kernel", "wgrad_kernel",
                   "stripe_attention_bwd_kernel", "carafe_kernel", "ln_mlp_kernel"):
        per = [c for name, c in tc.items() if re.search(rf"\d{family}[IE]", name)]
        print(f"[build] {family}: {sum(per)} tensor-core instructions (HMMA / HGMMA in "
              f"cuobjdump -sass) over {len(per)} instances, per instance {per}", flush=True)
        require(sum(per) > 0, f"{family}: no tensor-core instruction in its SASS")

    tally = compare_kernels(cfg, dev, SERVE_BATCH)
    probe_vs_parent(dev)
    compare_backward_kernels(cfg, dev, TRAIN_BATCH, tally)
    check_attention_bwd_smem()
    compare_edt(dev, tally)
    pair_ab(cfg, dev)
    compare_modules(cfg, dev)
    compare_module_grads(cfg, dev, TRAIN_BATCH)
    compare_volume_metrics(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        serve_counts, pallas_counts, pair_counts = serve_volumes(cfg, dev, workdir)
        t_f32 = time.perf_counter()
        tally_f32 = compare_f32_kernels(cfg, dev, SERVE_BATCH)
        tally_f32_384 = compare_f32_kernels(smoke_config(cfg=CFG384), dev, SERVE_BATCH,
                                            tag="f32:base384:kernel")
        f32_counts = f32_serve(cfg, dev, workdir, smi)
        f32_counts["eval_f32"] = f32_eval(cfg, dev, os.path.join(workdir, "tiny224_seed0.npz"))
        f32_counts["base384_f32"] = f32_base384(dev, smi)
        print(f"[f32] phase {time.perf_counter() - t_f32:.1f}s", flush=True)
        train_counts, data, ck = train_run(cfg, dev, workdir)
        train_step_checks(cfg, dev, data)
        dropout_counts = dropout_run(cfg, dev, workdir, data, smi)
        route_phase(CFG, dev, "route")
        eval_counts = eval_run(cfg, dev, ck)
        continual_counts, kits = continual_run(cfg, dev, workdir)
        continual_checks(cfg, dev, kits, os.path.join(workdir, "tiny224_seed0.npz"), smi)
        finetune_counts = finetune_run(cfg, dev, workdir, smi)
        blur_cli_run(dev, workdir)
        f32_counts.update(f32_train(cfg, dev, workdir, data, kits, smi, tally_f32))
        ddp_counts = ddp_run(smoke_config(DROP_OPTS), dev, workdir, kits,
                             os.path.join(workdir, "tiny224_seed0.npz"), smi,
                             cfg_opts=DROP_OPTS)
        tally384, counts384 = base384_run(dev, workdir, smi)
    compare_lab(dev, tally)
    lab_identities(dev)
    lab_counts = lab_run()

    paths = dict(serve=serve_counts, serve_pallas=pallas_counts, serve_pair=pair_counts,
                 **f32_counts, train=train_counts, dropout=dropout_counts, eval=eval_counts,
                 continual=continual_counts, finetune=finetune_counts, ddp=ddp_counts,
                 **counts384, lab=lab_counts)
    for k in ("layernorm", "gemm", "stripe_attention", "carafe_reassemble"):
        require(all(c[k] > 0 for c in counts384.values()),
                f"{k} launched no time on a base-384 path: {counts384}")
    for k in F32_OF:  # every float32 instance ran on a float32 path, and only there
        require(sum(c[k] for c in f32_counts.values()) > 0,
                f"{k} launched no time at float32: {f32_counts}")
        require(all(c[k] == 0 for p, c in paths.items() if p not in f32_counts),
                f"{k} launched on a bf16 path")
    kernels = []
    for k, (src, rep) in SOURCES.items():
        row = dict((tally_f32 if k in F32_OF else tally).rows[k])
        row384 = dict((tally_f32_384 if k in F32_OF else tally384).rows[k])
        bound_by = "bytes" if row.pop("bytes_ms") >= row.pop("ops_ms") else "operations"
        by384 = "bytes" if row384.pop("bytes_ms") >= row384.pop("ops_ms") else "operations"
        if row384["bound_ms"] > 0:  # the kernels base-384's paths run, at its shapes
            row["base384"] = dict(row384, bound_by=by384, per=PER[k] + ", base-384")
        kernels.append(dict(name=k, route="cuda", source=src, replaces=rep,
                            launches=sum(c[k] for c in paths.values()),
                            launches_by_path={p: c[k] for p, c in paths.items()},
                            per=PER[k], bound_by=bound_by, **row))
    print(f"[done] every phase passed in {time.perf_counter() - t_main:.1f}s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
