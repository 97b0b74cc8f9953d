"""Python wrappers of the hand-written CUDA kernels, each beside its plain
PyTorch version.

A wrapper runs its plain version for a tensor on the CPU, and only there.
For a CUDA tensor it checks device, dtype, shape and contiguity, allocates
the output, launches its kernel on PyTorch's current stream and raises if
the launch returned a CUDA error; there is no fallback. Each wrapper counts
its launches in a plain integer attribute, ``<wrapper>.launches``, so a run
can show that it went through the kernel.

The serving and training paths' kernels (``layernorm``, ``gemm``,
``stripe_attention``, ``cswin_attention``, ``carafe_reassemble``,
``block_pair``; ``layernorm_bwd``, ``gemm_dgrad``, ``gemm_wgrad``,
``stripe_attention_bwd``) have a bf16 instance and a float32 one
(``TPU.COMPUTE_DTYPE float32``: float32 products and nothing rounded to
bf16), chosen by the dtype of the activations; any other dtype raises
``TypeError``. A float32 launch also counts in ``<wrapper>.launches_f32``
(``launch_counts`` reports it as ``<name>_f32``).

Kernels (``csrc/``):
  layernorm.cu             LN over channels, float32 statistics
                           (``layernorm``, bf16 or float32), and its
                           backward (``layernorm_bwd``)
  gemm.cu                  bf16 GEMM with bias / residual / drop-path / GELU
                           epilogues (``gemm``), the backward's dX products
                           with a GELU-backward epilogue (``gemm_dgrad``) and
                           the split-M weight gradient (``gemm_wgrad``); all
                           three with dropout masks (``ops.dropout``) and
                           float32 instances on FFMA
  stripe_attention.cu      CSWin stripe-window attention + LePE, one branch:
                           from the qkv GEMM output with the composition's
                           rounding (``stripe_attention``), or from separate
                           q, k, v with the Pallas kernel's
                           (``cswin_attention``); and the attention alone,
                           without LePE, with its stubbed modes
                           (``window_attention``, for the block lab)
  stripe_attention_bwd.cu  the backward of ``stripe_attention`` (bf16 on
                           tensor cores, float32 on FFMA)
  carafe.cu                CARAFE kernel prediction, softmax and reassembly
  block_pair.cu            two consecutive dual-branch CSWin blocks in one
                           cooperative launch (``block_pair``), on the
                           device bodies of layernorm / gemm / attention
  block_one.cu             one block in one cooperative launch on the same
                           bodies, with parts switched off or built up level
                           by level (``block_one``, for the block lab)
  edt.cu                   the exact 1-D squared-EDT min-plus pass along any
                           axis, O(L) a line on its lower envelope
                           (``edt_pass``)
  lepe_windows.cu          LePE alone, the depthwise 3x3 on windowed V
                           (``lepe_windows``, for the block lab)
  ln_mlp.cu                the MLP half of a block, LN -> fc1 -> activation ->
                           fc2 -> residual in one launch with the hidden kept
                           on chip (``ln_mlp``, for the block lab)
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import dropout as _dropout
from ..attention import (cswin_attention_pallas_plain, cswin_attention_xla,
                         depthwise_conv3x3)
from ..dropout import Drop
from ..precision import conv2d, conv_precision
from ..windows import window_merge, window_partition
from .build import check, library

_EPILOGUES = {"bias": 0, "residual": 1, "gelu": 2}
_GELU_BWD = 3
_SMS = 132  # SMs of an H100 SXM: wgrad_plan's wave where the occupancy API is not asked


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


def needs_grad(*tensors: torch.Tensor | None) -> bool:
    """Whether autograd will want gradients of a call on ``tensors``: the
    differentiable entry points then go through their ``autograd.Function``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _require(t: torch.Tensor, name: str, dtype: torch.dtype,
             device: torch.device, shape: tuple | None = None) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, the kernel takes {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")


_ACT_DTYPES = (torch.bfloat16, torch.float32)


def _act_dtype(t: torch.Tensor, name: str) -> torch.dtype:
    """The instance a wrapper launches: bf16 or float32, by the dtype of its
    activations; ``TypeError`` for any other."""
    if t.dtype not in _ACT_DTYPES:
        raise TypeError(f"{name} is {t.dtype}; the kernels have bfloat16 and float32 "
                        "instances")
    return t.dtype


def _counted(fn, dtype: torch.dtype) -> None:
    """One launch of ``fn``'s instance for ``dtype``."""
    fn.launches += 1
    if dtype == torch.float32:
        fn.launches_f32 += 1


def _vec(dtype: torch.dtype) -> int:
    """Elements of ``dtype`` in a 16-byte copy: 8 bf16, 4 float32."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def _require_aligned(**tensors: torch.Tensor | None) -> None:
    """The LayerNorm rows read x and write y in 16-byte vectors and γ / β
    as float4s: their data must start 16-byte aligned."""
    for name, t in tensors.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned (the LayerNorm rows' "
                             "16-byte vectors)")


def _stream(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``,
    which must be the current device: the C entry points launch there, and
    a tensor on another device would meet a bare CUDA error. The public
    ``torch.cuda.current_stream(device).cuda_stream`` builds a Stream object
    per call: 3.5 µs against 0.1 µs here on an H100 host, paid on every
    launch of a host-bound forward."""
    current = torch._C._cuda_getDevice()
    if device.index != current:
        raise ValueError(f"a kernel was given tensors on {device} while cuda:{current} is "
                         f"the current device; call it under torch.cuda.device({device})")
    return torch._C._cuda_getCurrentRawStream(device.index)


def _ptr(t: torch.Tensor | None) -> int:
    return 0 if t is None else t.data_ptr()


def _row_scale(t: torch.Tensor, scale: torch.Tensor | None,
               rows_per_sample: int) -> torch.Tensor:
    """``t`` (M, N) with row m multiplied by ``scale[m // rows_per_sample]``
    in float32 and rounded back to ``t.dtype`` (a per-sample drop-path
    multiplier, applied as the kernels apply it on load)."""
    if scale is None:
        return t
    s = scale.float().repeat_interleave(rows_per_sample)[:, None]
    return (t.float() * s).to(t.dtype)


def _check_scale(scale: torch.Tensor, rows: int, rows_per_sample: int,
                 device: torch.device) -> None:
    if rows_per_sample <= 0 or rows % rows_per_sample:
        raise ValueError(f"rows_per_sample={rows_per_sample} does not divide {rows}")
    _require(scale, "scale", torch.float32, device, (rows // rows_per_sample,))


def _drop_args(drop: Drop | None, cols: int, dtype: torch.dtype,
               device: torch.device) -> tuple[int, int, float, int]:
    """(key pointer, row0, divisor, threshold) of a dropout site for the C
    entry points; (0, 0, 1.0, 0) without one."""
    if drop is None:
        return 0, 0, 1.0, 0
    _require(drop.key, "dropout key", torch.int64, device, (1,))
    if cols % 8:
        raise ValueError(f"dropout in the GEMMs needs a width that is a multiple of 8, "
                         f"got {cols}")
    return (drop.key.data_ptr(), drop.row0, _dropout.keep_divisor(drop.rate, dtype),
            _dropout.keep_threshold(drop.rate))


def _check_head_dim(cb: int, heads: int) -> None:
    if cb % heads or cb // heads not in (16, 24, 32):
        raise ValueError(f"head dim {cb / heads} not compiled (16/24/32)")


def _gelu_grad(h: torch.Tensor) -> torch.Tensor:
    """d/dh of the exact erf GELU h·Φ(h): Φ(h) + h·φ(h), float32."""
    h = h.float()
    return 0.5 * (1.0 + torch.erf(h * 2.0 ** -0.5)) + h * torch.exp(
        -0.5 * h * h) * (2.0 * torch.pi) ** -0.5


# ---------------------------------------------------------------------------
# layernorm.cu
# ---------------------------------------------------------------------------

def layernorm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * weight.float()
            + bias.float()).to(x.dtype)


_LN_THREADS = 256  # layernorm.cu THREADS


class LnFwdPlan(NamedTuple):
    """How the forward LayerNorm cuts a row of C channels
    (``layernorm_row.cuh``): ``lanes`` lanes a row, ``vectors`` 16-byte
    vectors of ``elements`` values (8 bf16 or 4 float32) a lane (lane j of
    a group holds vectors j, j + lanes, ...), ``rows_per_step`` rows a CTA
    of 256 threads takes per step."""
    lanes: int
    vectors: int
    rows_per_step: int
    elements: int = 8


LN_MAX_C = 1024  # layernorm_row.cuh MAX_C


def layernorm_fwd_plan(C: int, dtype: torch.dtype = torch.bfloat16) -> LnFwdPlan:
    """The forward's instance for C at ``dtype``, mirrored from
    ``LN_ROW_INSTANCE`` (bf16) and ``LN_ROW_INSTANCE_F32`` (float32): the
    power of two >= C / E lanes, from 4 to 32, and ceil(C / E / lanes)
    vectors a lane, E = 8 or 4 values a vector; the float32 instances round
    5 and 7 vectors up to 6 and 8. Raises for a C the kernel does not
    take."""
    E = _vec(dtype)
    if C <= 0 or C % E or C > LN_MAX_C:
        raise ValueError(f"layernorm takes C % {E} == 0 and {E} <= C <= {LN_MAX_C} "
                         f"(16-byte rows of {E} {dtype}), got C={C}")
    n = C // E
    lanes = 4 if n <= 4 else 8 if n <= 8 else 16 if n <= 16 else 32
    vectors = -(-n // lanes)
    vectors += vectors in (5, 7)
    return LnFwdPlan(lanes, vectors, _LN_THREADS // lanes, E)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with float32 statistics; out in
    ``x.dtype`` (bf16 or float32). ``weight``/``bias``: (C,) float32. On the
    GPU C must be a multiple of 8 (bf16) or 4 (float32) up to 1024
    (``layernorm_fwd_plan``)."""
    if _on_cpu(x):
        return layernorm_plain(x, weight, bias, eps)
    C = x.shape[-1]
    dt = _act_dtype(x, "x")
    layernorm_fwd_plan(C, dt)
    _require(x, "x", dt, x.device)
    _require(weight, "weight", torch.float32, x.device, (C,))
    _require(bias, "bias", torch.float32, x.device, (C,))
    _require_aligned(x=x, weight=weight, bias=bias)
    out = torch.empty_like(x)
    fn = library().cswin_layernorm if dt == torch.bfloat16 else library().cswin_layernorm_f32
    err = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
             x.numel() // C, C, eps, _stream(x.device))
    check(err, "layernorm")
    _counted(layernorm, dt)
    return out


layernorm.launches = layernorm.launches_f32 = 0


def layernorm_bwd_plain(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor,
                        residual: torch.Tensor | None = None,
                        eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = (xf - mu) * rstd
    dyf = dy.float()
    dxhat = dyf * weight.float()
    dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    if residual is not None:
        dx = dx + residual.float()
    C = x.shape[-1]
    return (dx.to(x.dtype), (dyf * xhat).reshape(-1, C).sum(0),
            dyf.reshape(-1, C).sum(0))


class LnBwdPlan(NamedTuple):
    """How ``layernorm_bwd`` cuts its rows (``layernorm.cu``'s
    ``Shape<T, C>``): ``lanes`` lanes a row in 16-byte vectors (8 bf16, 4
    float32), a row a lane group, ``rows_per_step`` rows a CTA per step;
    ``grid`` CTAs (at most one wave) stride over the steps, each writing one
    partial row of dγ | dβ, summed within ``groups`` groups of 16 CTAs and
    then across them."""
    grid: int
    rows_per_step: int
    lanes: int
    groups: int


_LN_GROUP = 16     # layernorm.cu GROUP


def layernorm_bwd_plan(rows: int, C: int, ctas_per_sm: int = 1, sms: int = _SMS,
                       dtype: torch.dtype = torch.bfloat16) -> LnBwdPlan:
    """One wave of ``sms * ctas_per_sm`` CTAs (the wrapper asks the
    occupancy API for ``ctas_per_sm``), fewer where the rows run out first:
    every CTA gets at least one step of rows. Only the grid reaches the
    kernel, which cuts its rows itself: a plan that differed from
    ``Shape<T, C>`` would size the wave wrongly, never drop a row."""
    n = C // _vec(dtype)
    lanes = 4 if n <= 4 else 8 if n <= 8 else 16 if n <= 16 else 32
    step = _LN_THREADS // lanes
    grid = max(1, min(sms * ctas_per_sm, -(-rows // step)))
    return LnBwdPlan(grid, step, lanes, -(-grid // _LN_GROUP))


def layernorm_bwd_rows(plan: LnBwdPlan, rows: int, cta: int) -> list[int]:
    """The rows CTA ``cta`` takes, in the kernel's loop order: steps
    ``cta, cta + grid, ...``; in a step, row ``step·rows_per_step + group``
    for each lane group."""
    steps = -(-rows // plan.rows_per_step)
    return [row for step in range(cta, steps, plan.grid)
            for g in range(plan.rows_per_step)
            if (row := step * plan.rows_per_step + g) < rows]


_ln_bwd_fit: dict[tuple, int] = {}
_ln_bwd_plans: dict[tuple, LnBwdPlan] = {}  # by (device, rows, C, dtype): once a shape
_ln_bwd_arrival: dict[torch.device, torch.Tensor] = {}


def _layernorm_bwd_plan(dev: torch.device, rows: int, C: int,
                        dtype: torch.dtype = torch.bfloat16) -> LnBwdPlan:
    plan = _ln_bwd_plans.get((dev, rows, C, dtype))
    if plan is None:
        with torch.cuda.device(dev):
            key = (torch.cuda.current_device(), C, dtype)
            if key not in _ln_bwd_fit:
                fit = (library().cswin_layernorm_bwd_ctas_per_sm if dtype == torch.bfloat16
                       else library().cswin_layernorm_bwd_f32_ctas_per_sm)
                n = fit(C)
                if n < 1:
                    raise RuntimeError(f"layernorm_bwd: the occupancy API gave {n} CTAs "
                                       f"an SM at C={C} ({dtype})")
                _ln_bwd_fit[key] = n
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            plan = _ln_bwd_plans[dev, rows, C, dtype] = layernorm_bwd_plan(
                rows, C, _ln_bwd_fit[key], sms, dtype)
    return plan


def layernorm_bwd(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor,
                  residual: torch.Tensor | None = None, eps: float = 1e-5):
    """Backward of ``layernorm`` with float32 statistics recomputed from x.

    x, dy, residual: (rows, C) in ``x.dtype`` (bf16 or float32); weight (C,)
    float32. Returns (dx = residual + LN-vjp(dy) in ``x.dtype``, dweight,
    dbias), the last two float32 (C,). On the GPU one launch
    (``layernorm_bwd_plan``) sums dweight and dbias itself, in a fixed
    order: two calls give the same bits. Float32 launches the float32
    instance (dx unrounded)."""
    if _on_cpu(x):
        return layernorm_bwd_plain(x, dy, weight, residual, eps)
    rows, C = x.shape
    dev = x.device
    dt = _act_dtype(x, "x")
    _require(x, "x", dt, dev)
    _require(dy, "dy", dt, dev, (rows, C))
    _require(weight, "weight", torch.float32, dev, (C,))
    if residual is not None:
        _require(residual, "residual", dt, dev, (rows, C))
    if C % 32 or (C > 512 and C != 768):
        raise ValueError(f"layernorm_bwd takes C % 32 == 0 and C <= 512, or C = 768, got {C}")
    if any(_ptr(t) % 16 for t in (x, dy, residual)):
        raise ValueError("layernorm_bwd needs 16-byte aligned x, dy and residual")
    plan = _layernorm_bwd_plan(dev, rows, C, dt)
    arrival = _ln_bwd_arrival.get(dev)
    if arrival is None or arrival.numel() < 1 + plan.groups:
        # zero, and left zero by every launch (each counter's last CTA resets it)
        arrival = _ln_bwd_arrival[dev] = torch.zeros(max(1 + plan.groups, 256),
                                                     dtype=torch.int32, device=dev)
    dx = torch.empty_like(x)
    # dγ | dβ, then where there are several CTAs one partial row of both a
    # CTA and one a group of CTAs.
    out = torch.empty(2 * C * (1 + (plan.grid + plan.groups if plan.grid > 1 else 0)),
                      dtype=torch.float32, device=dev)
    fn = (library().cswin_layernorm_bwd if dt == torch.bfloat16
          else library().cswin_layernorm_bwd_f32)
    err = fn(x.data_ptr(), dy.data_ptr(), weight.data_ptr(), _ptr(residual), dx.data_ptr(),
             out.data_ptr(), arrival.data_ptr(), rows, C, plan.grid, eps, _stream(dev))
    check(err, "layernorm_bwd")
    _counted(layernorm_bwd, dt)
    return dx, out[:C], out[C:2 * C]


layernorm_bwd.launches = layernorm_bwd.launches_f32 = 0


# ---------------------------------------------------------------------------
# gemm.cu
# ---------------------------------------------------------------------------

def gemm_plain(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None,
               *, residual: torch.Tensor | None = None,
               epilogue: str = "bias", dp: torch.Tensor | None = None,
               rows_per_sample: int = 0,
               pre: torch.Tensor | None = None,
               drop: Drop | None = None) -> torch.Tensor:
    acc = a.float() @ w.to(a.dtype).float().t()
    if bias is not None:
        acc = acc + bias.float()
    if epilogue == "residual":
        branch = _dropout.dropout(acc.to(a.dtype), drop)
        branch = _row_scale(branch, dp, rows_per_sample)
        acc = residual.float() + branch.float()
    elif epilogue == "gelu":
        if pre is not None:
            pre.copy_(acc.to(pre.dtype))
        acc = F.gelu(acc)
        if drop is not None:
            acc = _dropout.dropout(acc.to(a.dtype), drop)
    return acc.to(a.dtype)


def gemm(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None, *,
         residual: torch.Tensor | None = None,
         epilogue: str = "bias", dp: torch.Tensor | None = None,
         rows_per_sample: int = 0,
         pre: torch.Tensor | None = None,
         drop: Drop | None = None) -> torch.Tensor:
    """``epilogue(a · wᵀ + bias)`` with float32 accumulation, out in
    ``a.dtype``.

    a: (M, K); w: (N, K), the torch Linear layout, in ``a.dtype``; bias:
    (N,) float32 or None; residual: (M, N) for ``epilogue="residual"``
    (out = residual + round(a·wᵀ + bias), or with the per-sample drop-path
    multiplier ``dp`` (M / rows_per_sample,) float32, out = residual +
    round(round(a·wᵀ + bias)·dp)); ``"gelu"`` applies the exact erf GELU to
    the float32 accumulator and, given a (M, N) buffer ``pre``, writes the
    rounded pre-activation into it (kept for the backward). ``drop``: a
    dropout site (``ops.dropout.Drop``) over the (M, N) output, for
    ``"residual"`` on the branch before ``dp`` and for ``"gelu"`` on the
    GELU's output: a kept value becomes round(round(v) / keep), a dropped
    one 0. ``a`` in float32 launches the float32 instance (FFMA products,
    nothing rounded: ``pre`` float32, a kept value v / keep).
    """
    if epilogue not in _EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if (residual is None) != (epilogue != "residual"):
        raise ValueError("residual is given exactly when epilogue='residual'")
    if dp is not None and epilogue != "residual":
        raise ValueError("dp scales the residual branch: epilogue='residual'")
    if pre is not None and epilogue != "gelu":
        raise ValueError("pre is written by epilogue='gelu' only")
    if drop is not None and epilogue == "bias":
        raise ValueError("dropout masks the residual branch or the GELU output")
    if _on_cpu(a):
        return gemm_plain(a, w, bias, residual=residual, epilogue=epilogue,
                          dp=dp, rows_per_sample=rows_per_sample, pre=pre, drop=drop)
    M, K = a.shape
    N = w.shape[0]
    dev = a.device
    dt = _act_dtype(a, "a")
    _require(a, "a", dt, dev)
    _require(w, "w", dt, dev, (N, K))
    if bias is not None:
        _require(bias, "bias", torch.float32, dev, (N,))
    if residual is not None:
        _require(residual, "residual", dt, dev, (M, N))
    if pre is not None:
        _require(pre, "pre", dt, dev, (M, N))
    if dp is not None:
        _check_scale(dp, M, rows_per_sample, dev)
    _check_gemm_operands(a, w)
    out = torch.empty((M, N), dtype=dt, device=dev)
    key, row0, kd, thr = _drop_args(drop, N, dt, dev)
    args = (a.data_ptr(), w.data_ptr(), _ptr(bias), _ptr(residual), _ptr(pre), 0, _ptr(dp),
            out.data_ptr(), M, N, K, max(rows_per_sample, 1), _EPILOGUES[epilogue], 0, key,
            row0, kd, thr)
    if dt == torch.bfloat16:
        err = library().cswin_gemm(*args, _stream(dev))
    else:
        plan = gemm_f32_plan(M, N)
        err = library().cswin_gemm_f32(*args, plan.bm, plan.bn, 0, _stream(dev))
    check(err, "gemm")
    _counted(gemm, dt)
    return out


def _check_gemm_operands(a: torch.Tensor, w: torch.Tensor) -> None:
    """The GEMM tiles' operand rule: K a multiple of the elements in a
    16-byte chunk (8 bf16, 4 float32) and 16-byte aligned operands (they
    copy 16-byte chunks), and at most 2^31 - 1 output tiles of 64 x 64
    (the one-dimensional grid)."""
    M, K = a.shape
    E = _vec(a.dtype)
    if K % E or a.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"gemm needs K % {E} == 0 and 16-byte aligned operands")
    if -(-M // 64) * -(-w.shape[0] // 64) > 2**31 - 1:
        raise ValueError(f"gemm: M={M}, N={w.shape[0]} exceed the grid limit")


class GemmF32Plan(NamedTuple):
    """The float32 GEMM of ``gemm`` and ``gemm_dgrad`` (``gemm_f32.cu``):
    ``bm`` x ``bn`` outputs a CTA of ``threads`` threads, each thread 8 x 4
    of them, over a ring of k-blocks 32 deep (``smem_bytes`` of dynamic
    shared memory, the staged output tile sharing it); ``ctas`` one per
    output tile; ``kn``: B is given as (K, N), the dX product's weight as
    stored."""
    bm: int
    bn: int
    kn: bool
    threads: int
    smem_bytes: int
    ctas: int


# gemm_tile.cuh: BM, BN, THREADS (the bf16 tile)
_GEMM_BM, _GEMM_BN, _GEMM_THREADS = 64, 64, 128
# gemm_f32_tile.cuh: gemm_f32::STAGES, BK, TN; gemm_f32.cu: the planner's
# tiles (Tile64x64, Tile128x32) as (bm, bn); block_phases.cuh: the float32
# pair's GEMM phases on the 64 x 64 one
_F32_STAGES, _F32_BK, _F32_TN = 3, 32, 4
_F32_TILES = ((64, 64), (128, 32))
_PAIR_F32_TILE = (64, 64)
_PAIR_F32_CTAS = 3  # block_pair.cuh F32_CTAS: the float32 pair's CTAs an SM (its register cap)
_PAIR_F32_MAX_C = 512  # block_phases.cuh F32_MAX_C: the float32 pair's widest rows


def gemm_f32_smem(bm: int, bn: int, kn: bool = False) -> int:
    """Dynamic shared memory of a float32 GEMM tile (``gemm_f32::Smem``):
    the ring of both operands (A's rows of ``BK + 4`` floats; B's the same,
    or with ``kn`` ``BK`` rows of ``bn + 4``) or, once it is idle, the
    staged output (rows of ``bn + bn / TN``), and a scale a row, 128-byte
    aligned."""
    bk = _F32_BK
    ring = _F32_STAGES * (bm * (bk + 4) + (bk * (bn + 4) if kn else bn * (bk + 4)))
    return -(-4 * (max(ring, bm * (bn + bn // _F32_TN)) + bm) // 128) * 128


def gemm_f32_plan(M: int, N: int, kn: bool = False) -> GemmF32Plan:
    """The 64 x 64 tile, or the 128 x 32 one where N's 32-column tiles waste
    fewer columns than its 64-column ones (N = 96: 128 columns computed
    against 96). Measured on the H100 at every forward and dX shape of
    tiny-224 and base-384 at bs 24, against 8 x 8 tiles of 128 x 128 and
    128 x 64 and other 8 x 4 shapes (``PERF.md``, PR 19): these two were
    the fastest or within a few percent of it. Either gives the same bits:
    each output is one fmaf chain over k in order. ``kn``: B as (K, N) (the
    dX product)."""
    key = (M, N, kn)
    plan = _gemm_f32_plans.get(key)
    if plan is None:
        bm, bn = _F32_TILES[1] if -(-N // 32) * 32 < -(-N // 64) * 64 else _F32_TILES[0]
        plan = _gemm_f32_plans[key] = GemmF32Plan(
            bm, bn, kn, bm * bn // (8 * _F32_TN), gemm_f32_smem(bm, bn, kn),
            -(-M // bm) * -(-N // bn))
    return plan


_gemm_f32_plans: dict[tuple, GemmF32Plan] = {}  # by (M, N, kn): once a shape


gemm.launches = gemm.launches_f32 = 0


def gemm_dgrad_plain(dy: torch.Tensor, w: torch.Tensor, *,
                     dp: torch.Tensor | None = None, rows_per_sample: int = 0,
                     gelu_h: torch.Tensor | None = None, drop_dy: Drop | None = None,
                     drop_dx: Drop | None = None) -> torch.Tensor:
    a = _dropout.dropout(_row_scale(dy, dp, rows_per_sample), drop_dy)
    acc = a.float() @ w.to(dy.dtype).float()
    if drop_dx is not None:
        acc = _dropout.dropout(acc.to(dy.dtype), drop_dx).float()
    if gelu_h is not None:
        acc = acc * _gelu_grad(gelu_h)
    return acc.to(dy.dtype)


def gemm_dgrad(dy: torch.Tensor, w: torch.Tensor, *,
               dp: torch.Tensor | None = None, rows_per_sample: int = 0,
               gelu_h: torch.Tensor | None = None, drop_dy: Drop | None = None,
               drop_dx: Drop | None = None) -> torch.Tensor:
    """Input gradient of a Linear layer, ``dX = dY' · w``, float32
    accumulation, out in ``dy.dtype`` (bf16, or float32: the float32
    instance, nothing rounded).

    dy: (M, N); w: (N, K), the torch Linear layout (the bf16 kernel reads a
    transposed copy, the float32 one w as stored); dY' is dy with row m
    scaled by the drop-path multiplier
    ``dp[m // rows_per_sample]`` and rounded, when ``dp`` is given. With
    ``gelu_h`` (M, K), the saved pre-activation of the GELU that feeds this
    layer, the output is ``(dY'·w) · GELU'(h)`` (the fc2 -> fc1 step).
    Dropout, with ``gelu_h`` only: ``drop_dy`` masks dY' (the fc2 site,
    kept values round(v / keep)), ``drop_dx`` the product before GELU'
    (the fc1 site, round(round(v) / keep))."""
    if (drop_dy is not None or drop_dx is not None) and gelu_h is None:
        raise ValueError("dropout in gemm_dgrad is the GELU-backward step's: pass gelu_h")
    if _on_cpu(dy):
        return gemm_dgrad_plain(dy, w, dp=dp, rows_per_sample=rows_per_sample,
                                gelu_h=gelu_h, drop_dy=drop_dy, drop_dx=drop_dx)
    M, N = dy.shape
    K = w.shape[1]
    dev = dy.device
    dt = _act_dtype(dy, "dy")
    _require(dy, "dy", dt, dev)
    if w.device != dev or tuple(w.shape) != (N, K):
        raise ValueError(f"w: {tuple(w.shape)} on {w.device}, expected ({N}, {K}) "
                         f"on {dev}")
    if gelu_h is not None:
        _require(gelu_h, "gelu_h", dt, dev, (M, K))
    if dp is not None:
        _check_scale(dp, M, rows_per_sample, dev)
    if dt == torch.bfloat16:
        b = w.to(dy.dtype).t().contiguous()                  # (K, N), the tile's B
    else:
        b = w.to(dt).contiguous()  # (N, K): the float32 tile reads it as stored
        if K % 4:
            raise ValueError(f"gemm_dgrad at float32 needs K % 4 == 0, got {K}")
    _check_gemm_operands(dy, b if dt == torch.bfloat16 else b.t())
    key_a, row0, kd, thr = _drop_args(drop_dy, N, dy.dtype, dev)
    key_out, row0_out, kd, thr = (_drop_args(drop_dx, K, dy.dtype, dev)
                                  if drop_dx is not None else (0, row0, kd, thr))
    if drop_dy is not None and drop_dx is not None and (
            (drop_dy.rate, drop_dy.row0) != (drop_dx.rate, drop_dx.row0)):
        raise ValueError("drop_dy and drop_dx are one block's sites: one rate, one row0")
    out = torch.empty((M, K), dtype=dt, device=dev)
    args = (dy.data_ptr(), b.data_ptr(), 0, 0, _ptr(gelu_h), _ptr(dp), 0, out.data_ptr(), M,
            K, N, max(rows_per_sample, 1),
            _GELU_BWD if gelu_h is not None else _EPILOGUES["bias"], key_a, key_out, row0_out,
            kd, thr)
    if dt == torch.bfloat16:
        err = library().cswin_gemm(*args, _stream(dev))
    else:
        plan = gemm_f32_plan(M, K, kn=True)
        err = library().cswin_gemm_f32(*args, plan.bm, plan.bn, 1, _stream(dev))
    check(err, "gemm_dgrad")
    _counted(gemm_dgrad, dt)
    return out


gemm_dgrad.launches = gemm_dgrad.launches_f32 = 0


def gemm_wgrad_plain(x: torch.Tensor, dy: torch.Tensor, *,
                     dp: torch.Tensor | None = None, rows_per_sample: int = 0,
                     drop: Drop | None = None):
    dyf = _dropout.dropout(_row_scale(dy, dp, rows_per_sample), drop).float()
    return dyf.t() @ x.float(), dyf.sum(0)


class WgradPlan(NamedTuple):
    """How ``gemm_wgrad`` cuts its work: ``bn`` x ``bk`` output tiles
    (``tiles`` of them), M in ``splits`` chunks of ``chunk`` rows per tile
    (the last ones may be short or empty), in clusters of ``cluster`` CTAs;
    ``partial_bytes`` is what the kernel writes to L2 between its two sums
    (0 with one cluster a tile)."""
    chunk: int
    splits: int
    cluster: int
    tiles: int
    partial_bytes: int
    bn: int
    bk: int


_WGRAD_ROWS = 64      # gemm.cu wgrad::MS, the rows of a ring stage
_WGRAD_CLUSTER = 8    # wgrad::MAX_CLUSTER


def wgrad_plan(M: int, N: int, K: int, max_clusters=None) -> WgradPlan:
    """Tiles 128 wide along N or K where it divides, else 64, so that the
    narrow operand is read by fewer tiles; then one wave of CTAs: each
    tile's M split over as many CTAs as fit the card at once beside the other
    tiles' (each chunk a multiple of the ring's row step), in the largest
    cluster (8, 4, 2 or 1) that keeps at least 7/8 of the best split count
    and whose partials stay under an eighth of the operands' bytes.
    ``max_clusters(bn, bk, cl)``: how many clusters of ``cl`` CTAs the card
    runs at once (the wrapper asks the occupancy API); by default one CTA on
    each of the H100's SMs."""
    bn = 128 if N % 128 == 0 else 64
    bk = 128 if K % 128 == 0 else 64
    tn = -(-N // bn)
    tiles = tn * -(-K // bk)
    steps = -(-M // _WGRAD_ROWS)
    fit = max_clusters or (lambda bn_, bk_, cl: _SMS // cl)

    def cut(cl: int, want: int):
        chunk = -(-max(1, -(-M // want)) // _WGRAD_ROWS) * _WGRAD_ROWS
        splits = -(-(-(-M // chunk)) // cl) * cl
        clusters = splits // cl
        partial = 4 * clusters * bn * (tiles * bk + tn) if clusters > 1 else 0
        return WgradPlan(chunk, splits, cl, tiles, partial, bn, bk)

    # Each cluster size's widest cut whose partials stay under an eighth of
    # the operands' bytes (one cluster a tile writes none): at most `most`
    # clusters a tile.
    most = max(1, 2 * M * (N + K) // (8 * 4 * bn * (tiles * bk + tn)))
    plans = [cut(1, 1)]
    for cl in (8, 4, 2, 1):
        want = min(fit(bn, bk, cl) * cl // tiles, steps, most * cl) // cl * cl
        if want:
            plans.append(cut(cl, want))
    best = max(p.splits for p in plans)
    return max((p for p in plans if 8 * p.splits >= 7 * best),
               key=lambda p: (p.cluster, p.splits))


_WGRAD_F32_ROWS = 32   # gemm_f32.cu wgrad_f32::MS, the rows of a float32 ring stage
# The float32 planner's model, fitted to the H100 (PERF.md, PR 19): a
# dependent load of the cross-split sums costs as much as _WGRAD_F32_STEP
# rows of a 128 x 128 tile's products, a split tile _WGRAD_F32_FIXED rows
# more (its barriers and fences).
_WGRAD_F32_STEP, _WGRAD_F32_FIXED = 6.0, 20.0


def _wgrad_f32_cost(tiles: int, bn: int, bk: int, chunk: int, splits: int, cl: int,
                    sms: int) -> float:
    """Modelled time of a float32 weight-gradient cut, in rows of a 128 x 128
    tile's products at the full FFMA rate of an SM: the busiest SM's CTAs
    (``c``, all in one wave) each stream ``chunk`` rows at a rate that
    rises with the warps the SM holds (0.4 + 0.6·warps/16 of it, all of it
    from 16 warps); then each thread's dependent loads of the sums, its ``items``
    16-byte words of the cluster's tile through distributed shared memory
    (every rank's at once) and, with several clusters a tile, the last
    cluster's pass over their partials in L2, eight at a time."""
    threads = bn * bk // 64
    c = -(-tiles * splits // sms)
    rate = min(1.0, 0.4 + 0.6 * c * threads / 32 / 16)
    t = c * chunk * bn * bk / 16384 / rate
    if splits > 1:
        clusters = splits // cl
        items = bn // cl * (bk // 4) / threads
        loads = items + (items * -(-clusters // 8) if clusters > 1 else 0)
        t += _WGRAD_F32_STEP * loads + _WGRAD_F32_FIXED
    return t


def wgrad_f32_plan(M: int, N: int, K: int, max_clusters=None, sms: int = _SMS) -> WgradPlan:
    """The float32 weight gradient's cut (``gemm_f32.cu::wgrad_f32_kernel``,
    8 x 8 outputs a thread, ``bn * bk / 64`` threads): tiles as
    ``wgrad_plan``'s; then, of every cut of each tile's M into splits of
    whole ``_WGRAD_F32_ROWS``-row stages, in clusters of 8, 4, 2 or 1 CTAs,
    within one wave (``max_clusters(bn, bk, cl)`` clusters at once, from the
    occupancy API; by default one CTA on each of ``sms`` SMs) and with
    partials no larger than the float32 operands' bytes ``4·M·(N + K)``,
    the one of least modelled time (``_wgrad_f32_cost``: a CTA's FFMA work
    against its share of the cross-split sums); ties go to fewer splits,
    then the larger cluster. Where the tiles alone fill the wave, one split
    a tile: no sums."""
    bn = 128 if N % 128 == 0 else 64
    bk = 128 if K % 128 == 0 else 64
    tn = -(-N // bn)
    tiles = tn * -(-K // bk)
    steps = -(-M // _WGRAD_F32_ROWS)
    fit = max_clusters or (lambda bn_, bk_, cl: sms // cl)
    cap = 4 * M * (N + K)
    best = (_wgrad_f32_cost(tiles, bn, bk, steps * _WGRAD_F32_ROWS, 1, 1, sms), 1, -1), \
        WgradPlan(steps * _WGRAD_F32_ROWS, 1, 1, tiles, 0, bn, bk)
    for cl in (8, 4, 2, 1):
        for want in range(cl, min(steps, fit(bn, bk, cl) * cl // tiles) + 1, cl):
            chunk = -(-steps // want) * _WGRAD_F32_ROWS
            splits = -(-(-(-M // chunk)) // cl) * cl
            if splits != want:
                continue  # the same cut as a smaller count
            clusters = splits // cl
            partial = 4 * clusters * bn * (tiles * bk + tn) if clusters > 1 else 0
            if splits == 1 or partial > cap:
                continue  # one split is the cut above
            key = (_wgrad_f32_cost(tiles, bn, bk, chunk, splits, cl, sms), splits, -cl)
            if key < best[0]:
                best = key, WgradPlan(chunk, splits, cl, tiles, partial, bn, bk)
    return best[1]


_wgrad_arrivals: dict[torch.device, torch.Tensor] = {}
_wgrad_fit: dict[tuple, int] = {}
_wgrad_plans: dict[tuple, WgradPlan] = {}  # by (device, M, N, K, dtype): once a shape


def _wgrad_max_clusters(bn: int, bk: int, cl: int,
                        dtype: torch.dtype = torch.bfloat16) -> int:
    """Clusters of ``cl`` CTAs of the ``bn`` x ``bk`` weight-gradient kernel
    for ``dtype`` the card runs at once, from the occupancy API (asked once a
    shape); 0 where none fits, and the planner then takes a smaller
    cluster."""
    key = (torch.cuda.current_device(), bn, bk, cl, dtype)
    if key not in _wgrad_fit:
        fit = (library().cswin_gemm_wgrad_max_clusters if dtype == torch.bfloat16
               else library().cswin_gemm_wgrad_f32_max_clusters)
        n = fit(bn, bk, cl)
        if n < 0 or (cl == 1 and n == 0):
            raise RuntimeError(f"gemm_wgrad: the occupancy API gave {n} for clusters of "
                               f"{cl} CTAs of the {bn}x{bk} tile ({dtype})")
        _wgrad_fit[key] = n
    return _wgrad_fit[key]


def _arrivals(dev: torch.device, n: int) -> torch.Tensor:
    """The wgrad kernel's per-slice arrival counters on ``dev``: zero, and
    left zero by every launch (the last arrival resets its counter). Kernels
    on one stream run in order, so calls share them."""
    buf = _wgrad_arrivals.get(dev)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _wgrad_arrivals[dev] = buf
    return buf


def gemm_wgrad(x: torch.Tensor, dy: torch.Tensor, *,
               dp: torch.Tensor | None = None, rows_per_sample: int = 0,
               drop: Drop | None = None):
    """Weight and bias gradients of a Linear layer ``y = x·Wᵀ + b``:
    ``(dW = dY'ᵀ·x (N, K), db = Σ_rows dY' (N,))``, both float32.

    x: (M, K), dy: (M, N) in one dtype (bf16, or float32: the float32
    instance, FFMA products); dY' as in ``gemm_dgrad``, with ``drop`` as its
    ``drop_dy``. On the GPU one launch (``wgrad_plan``, at float32
    ``wgrad_f32_plan``) splits M over one wave of CTAs and sums the splits
    itself, in a fixed order: two calls give the same bits."""
    if _on_cpu(x):
        return gemm_wgrad_plain(x, dy, dp=dp, rows_per_sample=rows_per_sample, drop=drop)
    M, K = x.shape
    N = dy.shape[1]
    dev = x.device
    dt = _act_dtype(x, "x")
    _require(x, "x", dt, dev)
    _require(dy, "dy", dt, dev, (M, N))
    if dp is not None:
        _check_scale(dp, M, rows_per_sample, dev)
    if K % 8 or N % 8 or x.data_ptr() % 16 or dy.data_ptr() % 16:
        raise ValueError("gemm_wgrad needs K % 8 == N % 8 == 0 and 16-byte "
                         "aligned operands")
    key, row0, kd, thr = _drop_args(drop, N, dt, dev)
    plan = _wgrad_plans.get((dev, M, N, K, dt))
    if plan is None:
        with torch.cuda.device(dev):
            fit = lambda bn, bk, cl: _wgrad_max_clusters(bn, bk, cl, dt)
            plan = _wgrad_plans[dev, M, N, K, dt] = (
                wgrad_plan(M, N, K, fit) if dt == torch.bfloat16 else wgrad_f32_plan(M, N, K, fit))
    if plan.tiles > 65535 or plan.splits * plan.chunk >= 2**31:
        raise ValueError(f"gemm_wgrad: M={M}, N={N}, K={K} exceed the grid limit")
    dw = torch.empty((N, K), dtype=torch.float32, device=dev)
    db = torch.empty((N,), dtype=torch.float32, device=dev)
    part = torch.empty((plan.partial_bytes // 4,), dtype=torch.float32, device=dev)
    part_b = part[plan.tiles * (plan.splits // plan.cluster) * plan.bn * plan.bk:]
    fn = (library().cswin_gemm_wgrad if dt == torch.bfloat16
          else library().cswin_gemm_wgrad_f32)
    err = fn(x.data_ptr(), dy.data_ptr(), _ptr(dp), dw.data_ptr(), db.data_ptr(),
             part.data_ptr(), part_b.data_ptr(),
             _arrivals(dev, plan.tiles * _WGRAD_CLUSTER).data_ptr(), M, N, K,
             max(rows_per_sample, 1), plan.chunk, plan.splits, plan.cluster, plan.bn, plan.bk,
             key, row0, kd, thr, _stream(dev))
    check(err, "gemm_wgrad")
    _counted(gemm_wgrad, dt)
    return dw, db


gemm_wgrad.launches = gemm_wgrad.launches_f32 = 0


# ---------------------------------------------------------------------------
# stripe_attention.cu
# ---------------------------------------------------------------------------

def stripe_attention_plain(qkv: torch.Tensor, lepe_weight: torch.Tensor,
                           lepe_bias: torch.Tensor | None, out: torch.Tensor, *,
                           ch_off: int, heads: int, h_sp: int, w_sp: int,
                           scale: float) -> torch.Tensor:
    C = qkv.shape[-1] // 3
    cb = lepe_weight.shape[0]
    sl = slice(ch_off, ch_off + cb)
    q = qkv[..., sl]
    k = qkv[..., C + ch_off:C + ch_off + cb]
    v = qkv[..., 2 * C + ch_off:2 * C + ch_off + cb]
    out[..., sl] = cswin_attention_xla(q, k, v, lepe_weight, lepe_bias,
                                       h_sp=h_sp, w_sp=w_sp, num_heads=heads,
                                       scale=scale)
    return out


def stripe_attention(qkv: torch.Tensor, lepe_weight: torch.Tensor,
                     lepe_bias: torch.Tensor | None, out: torch.Tensor, *,
                     ch_off: int, heads: int, h_sp: int, w_sp: int,
                     scale: float) -> torch.Tensor:
    """One stripe branch of CSWin attention, straight from the qkv GEMM
    output.

    qkv: (B, H, W, 3C), q | k | v thirds; the branch owns channels
    ``[ch_off, ch_off + cb)`` of each third, ``cb = lepe_weight.shape[0]``,
    split into ``heads`` heads and ``h_sp x w_sp`` windows. LePE weight
    (cb, 1, 3, 3) and bias (cb,) in the torch depthwise layout. Writes the
    branch's result into channels ``[ch_off, ch_off + cb)`` of ``out``
    (B, H, W, C) and returns ``out``. A float32 ``qkv`` launches the float32
    instance (scores, softmax, P·V and LePE in float32, nothing rounded).
    """
    if _on_cpu(qkv):
        return stripe_attention_plain(qkv, lepe_weight, lepe_bias, out,
                                      ch_off=ch_off, heads=heads, h_sp=h_sp,
                                      w_sp=w_sp, scale=scale)
    B, H, W, C3 = qkv.shape
    C = C3 // 3
    cb = lepe_weight.shape[0]
    dev = qkv.device
    dt = _act_dtype(qkv, "qkv")
    _require(qkv, "qkv", dt, dev)
    _require(out, "out", dt, dev, (B, H, W, C))
    if H % h_sp or W % w_sp or ch_off + cb > C:
        raise ValueError(f"bad branch geometry H={H} W={W} window=({h_sp},"
                         f"{w_sp}) cb={cb} heads={heads} ch_off={ch_off}")
    _check_head_dim(cb, heads)
    if B * (H // h_sp) * (W // w_sp) > 2**31 - 1:
        raise ValueError("too many windows for one launch")
    E = _vec(dt)
    if C % E or (qkv.data_ptr() + qkv.element_size() * ch_off) % 16:
        raise ValueError(f"stripe_attention copies 16-byte chunks: C % {E} == 0 and a "
                         "16-byte aligned branch")
    if dt == torch.float32:
        _check_attention_f32_smem(h_sp * w_sp, cb // heads)
        fn = library().cswin_stripe_attention_f32
    else:
        fn = library().cswin_stripe_attention
    w9 = lepe_weight.reshape(cb, 9).t().to(dt).contiguous()
    b = (torch.zeros(cb, dtype=dt, device=dev) if lepe_bias is None
         else lepe_bias.to(dt).contiguous())
    err = fn(qkv.data_ptr(), w9.data_ptr(), b.data_ptr(), out.data_ptr(),
             B, H, W, C, ch_off, cb, heads, h_sp, w_sp, scale, _stream(dev))
    check(err, "stripe_attention")
    _counted(stripe_attention, dt)
    return out


stripe_attention.launches = stripe_attention.launches_f32 = 0

_SM_SMEM = 233472  # shared memory of an H100 SM (228 KB), 1 KB of it reserved a CTA
_ATT_WARPS = 4  # attention_tile.cuh WARPS
_ATT_F32_QR = 8  # attention_tile.cuh QR: query rows a warp takes at once
_ATT_F32_SLOTS = 3  # attention_tile.cuh SLOTS: key slots of 32 keys a lane scores at once


class AttentionF32Plan(NamedTuple):
    """The float32 attention tile (``attention_tile.cuh::tile_f32``) at a
    window of L tokens and head dim d: k and v staged at a row stride of
    ``kv_stride`` floats; each of ``warps`` warps takes ``rows`` query rows
    at a time (two q buffers of its own) and holds their scores over
    ``score_keys`` keys (L rounded up to 32), a lane scoring up to ``slots``
    keys at once; ``smem_bytes`` of dynamic shared memory; one CTA a
    (window, head), ``ctas_per_sm`` of them an SM by shared memory (at most
    16 by threads)."""
    kv_stride: int
    score_keys: int
    rows: int
    slots: int
    warps: int
    smem_bytes: int
    ctas_per_sm: int


def _ctas_per_sm(smem: int) -> int:
    """CTAs of ``_ATT_WARPS`` warps an H100 SM holds at ``smem`` bytes of
    dynamic shared memory each (at most 16 by threads)."""
    return min(_SM_SMEM // (smem + 1024), 2048 // (32 * _ATT_WARPS))


def attention_f32_plan(L: int, d: int) -> AttentionF32Plan:
    """Mirrors ``attn_tile::smem_bytes_f32`` (the C entry
    ``cswin_stripe_attention_f32_smem`` returns the same count)."""
    ls = -(-L // 32) * 32
    smem = 4 * (2 * L * (d + 4) + 10 * d + _ATT_WARPS * _ATT_F32_QR * (2 * d + ls))
    return AttentionF32Plan(d + 4, ls, _ATT_F32_QR, _ATT_F32_SLOTS, _ATT_WARPS, smem,
                            _ctas_per_sm(smem))


def _check_attention_f32_smem(L: int, d: int) -> None:
    plan = attention_f32_plan(L, d)
    if plan.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"the float32 attention tile needs {plan.smem_bytes} bytes of shared "
                         f"memory at a window of {L} tokens, head dim {d}: more than the "
                         f"{SMEM_LIMIT} a block may use")


def _pixel_stride(t: torch.Tensor, name: str) -> int:
    """The pixel stride of a (B, H, W, c) view whose channels are contiguous
    and whose pixels lie evenly apart (a channel slice of an NHWC tensor)."""
    B, H, W, c = t.shape
    # the stride of the innermost spatial axis longer than 1, per pixel
    ps = next((st // span for n, st, span in zip((W, H, B), t.stride()[2::-1],
                                                  (1, W, H * W)) if n > 1), c)
    want = (H * W * ps, W * ps, ps, 1)
    if any(n > 1 and st != w for n, st, w in zip(t.shape, t.stride(), want)):
        raise ValueError(f"{name}: strides {t.stride()} are not a channel slice "
                         "of an NHWC tensor")
    return ps


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, h_sp: int,
               w_sp: int, heads: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Check separate q, k, v (B, H, W, cb) views of ``dtype`` for the
    attention kernels and return the pixel stride they share."""
    B, H, W, cb = q.shape
    dev = q.device
    strides = set()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, the kernel takes {dtype}")
        if tuple(t.shape) != (B, H, W, cb):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(B, H, W, cb)}")
        strides.add(_pixel_stride(t, name))
    if len(strides) != 1:
        raise ValueError(f"q, k and v must share one pixel stride, got {strides}")
    E = _vec(dtype)
    if any(t.data_ptr() % 16 for t in (q, k, v)) or next(iter(strides)) % E:
        raise ValueError("the attention tile copies 16-byte chunks: q, k and v 16-byte "
                         f"aligned, their pixel stride a multiple of {E}")
    if H % h_sp or W % w_sp:
        raise ValueError(f"bad branch geometry H={H} W={W} window=({h_sp},{w_sp})")
    _check_head_dim(cb, heads)
    if B * (H // h_sp) * (W // w_sp) > 2**31 - 1:
        raise ValueError("too many windows for one launch")
    return strides.pop()


def cswin_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lepe_weight: torch.Tensor, lepe_bias: torch.Tensor | None, *,
                    h_sp: int, w_sp: int, num_heads: int,
                    scale: float) -> torch.Tensor:
    """One stripe branch from separate q, k, v with the Pallas kernel's
    rounding (plain version: ``ops.attention.cswin_attention_pallas_plain``).

    q, k, v: (B, H, W, cb) bf16 or float32, channels contiguous, pixels one
    common stride apart, so they may be the q | k | v channel slices of one
    qkv tensor (no copy). LePE weight (cb, 1, 3, 3) and bias (cb,) or None,
    read as float32. Returns a new contiguous (B, H, W, cb) tensor of q's
    dtype; float32 launches the float32 instance (the same tile as
    ``stripe_attention``'s: at float32 the two roundings coincide).
    """
    if _on_cpu(q):
        return cswin_attention_pallas_plain(q, k, v, lepe_weight, lepe_bias,
                                            h_sp=h_sp, w_sp=w_sp,
                                            num_heads=num_heads, scale=scale)
    B, H, W, cb = q.shape
    dev = q.device
    dt = _act_dtype(q, "q")
    stride = _check_qkv(q, k, v, h_sp, w_sp, num_heads, dt)
    if dt == torch.float32:
        _check_attention_f32_smem(h_sp * w_sp, cb // num_heads)
        fn = library().cswin_cswin_attention_f32
    else:
        fn = library().cswin_cswin_attention
    w9 = lepe_weight.reshape(cb, 9).t().float().contiguous()
    b = (torch.zeros(cb, dtype=torch.float32, device=dev) if lepe_bias is None
         else lepe_bias.float().contiguous())
    out = torch.empty((B, H, W, cb), dtype=dt, device=dev)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), stride, w9.data_ptr(),
             b.data_ptr(), out.data_ptr(), B, H, W, cb, num_heads, h_sp, w_sp, scale,
             _stream(dev))
    check(err, "cswin_attention")
    _counted(cswin_attention, dt)
    return out


cswin_attention.launches = cswin_attention.launches_f32 = 0


def _branch_windows(t: torch.Tensor, h_sp: int, w_sp: int,
                    heads: int) -> torch.Tensor:
    """(B, H, W, cb) -> (windows, heads, L, cb // heads)."""
    w = window_partition(t, h_sp, w_sp)
    N, L, cb = w.shape
    return w.reshape(N, L, heads, cb // heads).permute(0, 2, 1, 3)


def stripe_attention_bwd_plain(qkv: torch.Tensor, dout: torch.Tensor,
                               lepe_weight: torch.Tensor, dqkv: torch.Tensor,
                               *, ch_off: int, heads: int, h_sp: int, w_sp: int,
                               scale: float):
    B, H, W, C3 = qkv.shape
    C = C3 // 3
    cb = lepe_weight.shape[0]
    dt = qkv.dtype
    win = lambda t: _branch_windows(t, h_sp, w_sp, heads)
    unwin = lambda t: window_merge(t.permute(0, 2, 1, 3).reshape(
        t.shape[0], h_sp * w_sp, cb), h_sp, w_sp, H, W)
    q, k, v = (qkv[..., i * C + ch_off:i * C + ch_off + cb] for i in range(3))
    do = dout[..., ch_off:ch_off + cb]
    qs = (win(q) * scale).float()                   # bf16(q·scale), as forward
    kf, vf, dof = win(k).float(), win(v).float(), win(do).float()
    p = torch.softmax(qs @ kf.transpose(-1, -2), dim=-1)
    dp = dof @ vf.transpose(-1, -2)
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True))).to(dt).float()
    dq = ds @ kf * scale
    dk = ds.transpose(-1, -2) @ qs
    dv = p.to(dt).float().transpose(-1, -2) @ dof
    # LePE on (h_sp, w_sp) window images, zero padded at the window borders.
    w = lepe_weight.to(dt).float()
    v_img = window_partition(v, h_sp, w_sp).reshape(-1, h_sp, w_sp, cb).float()
    do_img = window_partition(do, h_sp, w_sp).reshape(-1, h_sp, w_sp, cb).float()
    do_nchw = do_img.permute(0, 3, 1, 2)
    with conv_precision(dt):
        dv_lepe = F.conv_transpose2d(do_nchw, w, padding=1, groups=cb)
    dv_lepe = dv_lepe.permute(0, 2, 3, 1).reshape(-1, h_sp * w_sp, cb)
    v_pad = F.pad(v_img, (0, 0, 1, 1, 1, 1))
    dw = torch.stack([(do_img * v_pad[:, a:a + h_sp, b:b + w_sp]).sum((0, 1, 2))
                      for a in range(3) for b in range(3)], dim=-1)  # (cb, 9)
    dv = unwin(dv) + window_merge(dv_lepe, h_sp, w_sp, H, W)
    for i, g in enumerate((unwin(dq), unwin(dk), dv)):
        dqkv[..., i * C + ch_off:i * C + ch_off + cb] = g.to(dt)
    return dw.reshape(cb, 1, 3, 3), do_img.sum((0, 1, 2))


SMEM_LIMIT = 227 * 1024  # bytes of shared memory a block may use on an H100
_ATT_BWD_KEYS = 64        # stripe_attention_bwd.cu's key block (KB)
_ATT_BWD_WARPS = 4        # and its warps (WARPS), each with two 16-row output tiles


def stripe_attention_bwd_smem(L: int, d: int) -> int:
    """Bytes of shared memory the bf16 whole-window kernel takes for a
    window of ``L`` tokens at head dim ``d``, as
    ``stripe_attention_bwd.cu::smem_bytes`` counts them: q, k, v and dO in
    bf16 rows padded for ldmatrix, the bf16 P_b and dS_b tiles, each warp's
    two 16-row output tiles, the LePE taps. 0 past one key block: such a
    window takes the split route (``stripe_attention_bwd_plan``)."""
    lp = -(-L // 16) * 16
    if lp > _ATT_BWD_KEYS:
        return 0
    stride = -(-d // 16) * 16 + 8
    return (4 * lp * stride * 2 + 2 * lp * (_ATT_BWD_KEYS + 8) * 2
            + _ATT_BWD_WARPS * 2 * 16 * stride * 2 + 9 * d * 4)


# stripe_attention_bwd.cu RG, ROW_PART_TARGET, KEY_TILE, KEY_PART_TILES, SPLIT_TILES: the
# bf16 split route's row groups, rows a row-kernel CTA takes about, keys of a key tile,
# key tiles a key-kernel CTA takes at most, key tiles a window holds at most
_ATT_BWD_SPLIT_RG, _ATT_BWD_SPLIT_ROW_TARGET = 8, 96
_ATT_BWD_SPLIT_KEY_TILE, _ATT_BWD_SPLIT_KEY_TILES, _ATT_BWD_SPLIT_TILES = 16, 6, 19


class AttentionBwdPlan(NamedTuple):
    """The bf16 attention backward at a window of L tokens and head dim d
    (``stripe_attention_bwd.cu``). ``split`` False: one CTA a (window,
    head) takes the whole window (L up to one key block) in ``whole_smem``
    bytes (0 on the split). ``split`` True: a row kernel, ``row_ctas`` CTAs a (window, head)
    of ``row_block`` query rows (``_ATT_BWD_WARPS`` warps, k and v of the
    window staged), then a key kernel, ``key_ctas`` CTAs of ``key_tiles_per_cta``
    of the window's ``key_tiles`` 16-key tiles (a warp a tile; q·scale, dO
    and the rows' statistics staged); each kernel's dynamic shared memory and
    the CTAs an SM it leaves room for (0 off the split)."""
    split: bool
    whole_smem: int
    row_block: int
    row_ctas: int
    key_tiles: int
    key_tiles_per_cta: int
    key_ctas: int
    rows_smem: int
    keys_smem: int
    rows_ctas_per_sm: int
    keys_ctas_per_sm: int


def stripe_attention_bwd_plan(L: int, d: int) -> AttentionBwdPlan:
    """Mirrors ``split_rows_per_cta``, ``split_key_tiles_per_cta``,
    ``smem_rows_split`` and ``smem_keys_split`` of ``stripe_attention_bwd.cu``
    (the C entry ``cswin_stripe_attention_bwd_plan`` returns the same
    counts): the split takes every window longer than one key block, in
    near-equal parts of about ``ROW_PART_TARGET`` rows (whole 8-row groups of
    every warp) and of up to ``KEY_PART_TILES`` key tiles."""
    lp = -(-L // 16) * 16
    stride = -(-d // 16) * 16 + 8
    whole = stripe_attention_bwd_smem(L, d)
    if lp <= _ATT_BWD_KEYS:
        return AttentionBwdPlan(False, whole, 0, 0, 0, 0, 0, 0, 0, 0, 0)
    group = _ATT_BWD_SPLIT_RG * _ATT_BWD_WARPS
    parts = -(-L // _ATT_BWD_SPLIT_ROW_TARGET)
    row_block = -(-(-(-L // parts)) // group) * group
    tiles = -(-L // _ATT_BWD_SPLIT_KEY_TILE)
    per_cta = -(-tiles // -(-tiles // _ATT_BWD_SPLIT_KEY_TILES))
    rows = 2 * lp * stride * 2 + _ATT_BWD_WARPS * _ATT_BWD_SPLIT_RG * stride * 2
    keys = (2 * lp * stride * 2 + 3 * lp * 4 + 9 * d * 4
            + per_cta * _ATT_BWD_SPLIT_KEY_TILE * stride * 2)
    per_sm = lambda smem, warps: min(_SM_SMEM // (smem + 1024), 2048 // (32 * warps))
    return AttentionBwdPlan(True, whole, row_block, -(-L // row_block), tiles, per_cta,
                            -(-tiles // per_cta), rows, keys,
                            per_sm(rows, _ATT_BWD_WARPS), per_sm(keys, per_cta))


# stripe_attention_bwd.cu ROWS_B, ROW_TARGET, KEYS, KEY_BLOCKS
_ATT_BWD_F32_ROWS, _ATT_BWD_F32_ROW_TARGET = 4, 96
_ATT_BWD_F32_KEYS, _ATT_BWD_F32_KEY_BLOCKS = 32, 3


class AttentionBwdF32Plan(NamedTuple):
    """The float32 attention backward of one (window, head) at a window of
    L tokens and head dim d, in two kernels (``stripe_attention_bwd.cu``):
    the row kernel's ``row_ctas`` CTAs take ``row_block`` query rows each
    (k and v staged once at ``kv_stride`` floats; each warp ``rows`` rows at
    a time, their scores over ``score_keys`` keys, L rounded up to 32); the
    key kernel's ``key_ctas`` CTAs take ``key_blocks_per_cta`` of the
    window's ``key_blocks`` blocks of ``keys`` keys each (q and dO staged
    once), a warp a block and a lane a key; ``warps`` warps a row-kernel
    CTA; the dynamic shared memory and the CTAs an SM by shared memory of
    each."""
    kv_stride: int
    score_keys: int
    rows: int
    row_block: int
    row_ctas: int
    keys: int
    key_blocks: int
    key_blocks_per_cta: int
    key_ctas: int
    warps: int
    rows_smem: int
    keys_smem: int
    rows_ctas_per_sm: int
    keys_ctas_per_sm: int


def stripe_attention_bwd_f32_plan(L: int, d: int) -> AttentionBwdF32Plan:
    """Mirrors ``rows_per_cta``, ``key_blocks_per_cta``, ``smem_rows_f32``
    and ``smem_keys_f32`` of ``stripe_attention_bwd.cu`` (the C entry
    ``cswin_stripe_attention_bwd_f32_smem`` returns the same counts): the
    window in near-equal parts of about ``ROW_TARGET`` rows (whole row
    groups of every warp) and of up to ``KEY_BLOCKS`` key blocks; the row
    kernel's k and v, and per warp two buffers of q·scale and dO rows and
    the rows' S / P and dP / dS; the key kernel's q·scale and dO of the
    window, the rows' statistics (a float4 a row), the LePE taps and each
    warp's key block's v."""
    R, KB = _ATT_BWD_F32_ROWS, _ATT_BWD_F32_KEYS
    group = R * _ATT_BWD_WARPS
    parts = -(-L // _ATT_BWD_F32_ROW_TARGET)
    row_block = -(-(-(-L // parts)) // group) * group
    blocks = -(-L // KB)
    per_cta = -(-blocks // -(-blocks // _ATT_BWD_F32_KEY_BLOCKS))
    ls = -(-L // 32) * 32
    rows = 4 * (2 * L * (d + 4) + _ATT_BWD_WARPS * (4 * R * d + 2 * R * ls))
    keys = 4 * (2 * L * d + 4 * L + 9 * d + per_cta * KB * d)
    return AttentionBwdF32Plan(d + 4, ls, R, row_block, -(-L // row_block), KB, blocks, per_cta,
                               -(-blocks // per_cta), _ATT_BWD_WARPS, rows, keys,
                               _ctas_per_sm(rows), _ctas_per_sm(keys))


def stripe_attention_bwd(qkv: torch.Tensor, dout: torch.Tensor,
                         lepe_weight: torch.Tensor, dqkv: torch.Tensor, *,
                         ch_off: int, heads: int, h_sp: int, w_sp: int,
                         scale: float):
    """Backward of ``stripe_attention`` for one branch.

    qkv: (B, H, W, 3C), the forward's qkv output; dout: (B, H, W, C), the
    gradient of the attention output, of which the branch reads channels
    ``[ch_off, ch_off + cb)``. Writes dq, dk, dv (LePE included) into the
    branch's channels of the q, k and v thirds of ``dqkv`` (B, H, W, 3C) and
    returns the float32 LePE gradients (weight (cb, 1, 3, 3), bias (cb,)).
    A bf16 window longer than one key block takes the split route (a row
    kernel and a key kernel, ``stripe_attention_bwd_plan``), counted in
    ``stripe_attention_bwd.launches_split`` too. A float32 ``qkv`` launches
    the float32 instance (nothing rounded, the LePE taps float32; two
    kernels, ``stripe_attention_bwd_f32_plan``).
    """
    if _on_cpu(qkv):
        return stripe_attention_bwd_plain(qkv, dout, lepe_weight, dqkv,
                                          ch_off=ch_off, heads=heads, h_sp=h_sp,
                                          w_sp=w_sp, scale=scale)
    B, H, W, C3 = qkv.shape
    C = C3 // 3
    cb = lepe_weight.shape[0]
    dev = qkv.device
    dt = _act_dtype(qkv, "qkv")
    _require(qkv, "qkv", dt, dev)
    _require(dout, "dout", dt, dev, (B, H, W, C))
    _require(dqkv, "dqkv", dt, dev, (B, H, W, C3))
    if H % h_sp or W % w_sp or ch_off + cb > C:
        raise ValueError(f"bad branch geometry H={H} W={W} window=({h_sp},"
                         f"{w_sp}) cb={cb} heads={heads} ch_off={ch_off}")
    _check_head_dim(cb, heads)
    L, d = h_sp * w_sp, cb // heads
    if dt == torch.bfloat16:
        plan = stripe_attention_bwd_plan(L, d)
        smem = max(plan.rows_smem, plan.keys_smem) if plan.split else plan.whole_smem
        if L > _ATT_BWD_SPLIT_TILES * _ATT_BWD_SPLIT_KEY_TILE:
            raise ValueError(f"a window of {L} tokens is longer than the "
                             f"{_ATT_BWD_SPLIT_TILES * _ATT_BWD_SPLIT_KEY_TILE} the bf16 "
                             "backward holds")
    else:
        plan = stripe_attention_bwd_f32_plan(L, d)
        smem = max(plan.rows_smem, plan.keys_smem)
    if smem > SMEM_LIMIT:
        raise ValueError(f"a window of {L} tokens at head dim {d} needs {smem} bytes of "
                         f"shared memory ({dt}), more than the {SMEM_LIMIT} a block may use")
    E = _vec(dt)
    if C % E or ch_off % E or any(t.data_ptr() % 16 for t in (qkv, dout, dqkv)):
        raise ValueError(f"stripe_attention_bwd copies 16-byte chunks: C % {E} == 0, "
                         f"ch_off % {E} == 0 and 16-byte aligned qkv, dout and dqkv")
    windows = B * (H // h_sp) * (W // w_sp)
    if windows > 2**31 - 1:
        raise ValueError("too many windows for one launch")
    w9 = lepe_weight.reshape(cb, 9).t().to(dt).contiguous()
    head = (qkv.data_ptr(), dout.data_ptr(), w9.data_ptr(), dqkv.data_ptr())
    tail = (B, H, W, C, ch_off, cb, heads, h_sp, w_sp, scale, _stream(dev))
    split = False
    if dt == torch.float32:  # LePE partials a window and key block; the rows' statistics
        part = torch.empty((windows * plan.key_blocks, cb, 10), dtype=torch.float32, device=dev)
        stats = torch.empty((windows, heads, L, 4), dtype=torch.float32, device=dev)
        err = library().cswin_stripe_attention_bwd_f32(*head, part.data_ptr(), stats.data_ptr(),
                                                       *tail)
    elif plan.split:  # LePE partials a window and key CTA; the rows' statistics
        split = True
        part = torch.empty((windows * plan.key_ctas, cb, 10), dtype=torch.float32, device=dev)
        stats = torch.empty((windows, heads, 3, -(-L // 16) * 16), dtype=torch.float32,
                            device=dev)
        err = library().cswin_stripe_attention_bwd_split(*head, part.data_ptr(), stats.data_ptr(),
                                                         *tail)
    else:
        part = torch.empty((windows, cb, 10), dtype=torch.float32, device=dev)
        err = library().cswin_stripe_attention_bwd(*head, part.data_ptr(), *tail)
    check(err, "stripe_attention_bwd")
    _counted(stripe_attention_bwd, dt)
    stripe_attention_bwd.launches_split += split
    lepe = part.sum(0)  # (cb, 10): the nine taps, then the bias
    return lepe[:, :9].reshape(cb, 1, 3, 3), lepe[:, 9]


stripe_attention_bwd.launches = stripe_attention_bwd.launches_f32 = 0
# bf16 launches on the split route: two device kernels each (its row and key kernels)
stripe_attention_bwd.launches_split = 0


# ---------------------------------------------------------------------------
# carafe.cu
# ---------------------------------------------------------------------------

def carafe_reassemble_plain(gy: torch.Tensor, encoder_weight: torch.Tensor,
                            encoder_bias: torch.Tensor, bias: torch.Tensor, *,
                            c_mid: int, up: int, labels: bool) -> torch.Tensor:
    B, H, W, _ = gy.shape
    nc = bias.shape[0]
    mid = gy[..., :c_mid].float().permute(0, 3, 1, 2)
    enc = conv2d(mid, encoder_weight.to(gy.dtype).float(), padding=1, dtype=gy.dtype)
    enc = enc.permute(0, 2, 3, 1) + encoder_bias.float()
    kern = torch.softmax(enc.reshape(B, H, W, 9, up * up), dim=3).to(gy.dtype)
    y = F.pad(gy[..., c_mid:c_mid + nc].float(), (0, 0, 1, 1, 1, 1))
    patches = torch.stack([y[:, di:di + H, dj:dj + W] for di in range(3)
                           for dj in range(3)], dim=-1)    # (B, H, W, nc, 9)
    out = torch.einsum("bhwnt,bhwts->bhwns", patches, kern.float())
    out = out + bias.float()[:, None]
    out = out.reshape(B, H, W, nc, up, up).permute(0, 1, 4, 2, 5, 3)
    out = out.reshape(B, H * up, W * up, nc)
    if labels:
        return out.argmax(-1).to(torch.int32)
    return out.to(gy.dtype)


def carafe_reassemble(gy: torch.Tensor, encoder_weight: torch.Tensor,
                      encoder_bias: torch.Tensor, bias: torch.Tensor, *,
                      c_mid: int, up: int, labels: bool) -> torch.Tensor:
    """CARAFE after its (down | classes) GEMM.

    gy: (B, H, W, G), the 1x1 down conv with bias in the first ``c_mid``
    channels and ``x·W_y`` without bias in the next ``nc =
    bias.shape[0]``; channels past ``c_mid + nc`` (the GEMM's padding,
    ``carafe_tail.gy_channels``) reach no output. The kernel takes G and
    c_mid multiples of 8. Encoder weight (9·up²,
    c_mid, 3, 3) OIHW with output channel ``tap·up² + s``, encoder bias
    (9·up²,), ``bias`` (nc,) float32 added after reassembly. Returns (B,
    up·H, up·W, nc) logits in ``gy.dtype``, or int32 labels (B, up·H, up·W)
    with ``labels=True`` (first maximum wins). A float32 ``gy`` launches
    the float32 instance (FFMA encoder conv, float32 softmax weights,
    float32 logits), which takes G a multiple of 4 and any c_mid.
    """
    if _on_cpu(gy):
        return carafe_reassemble_plain(gy, encoder_weight, encoder_bias, bias,
                                       c_mid=c_mid, up=up, labels=labels)
    B, H, W, G = gy.shape
    nc = bias.shape[0]
    dev = gy.device
    dt = _act_dtype(gy, "gy")
    _require(gy, "gy", dt, dev)
    _require(bias, "bias", torch.float32, dev, (nc,))
    if dt == torch.float32:
        return _carafe_f32(gy, encoder_weight, encoder_bias, bias, c_mid=c_mid, up=up,
                           labels=labels)
    if up not in (2, 4) or nc < 1 or c_mid < 1 or G < c_mid + nc or G % 8 or c_mid % 8:
        raise ValueError(f"carafe kernel takes up 2 or 4, 1 <= nc, c_mid + nc <= G and "
                         f"c_mid, G multiples of 8 (pad gy as carafe_fused does), got up "
                         f"{up}, c_mid {c_mid}, nc {nc}, G {G}")
    if tuple(encoder_weight.shape) != (9 * up * up, c_mid, 3, 3):
        raise ValueError(f"encoder weight shape {tuple(encoder_weight.shape)}")
    wenc = encoder_weight.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()
    benc = encoder_bias.float().contiguous()
    if gy.data_ptr() % 16 or wenc.data_ptr() % 16:
        raise ValueError("carafe kernel needs a 16-byte aligned gy and encoder weight")
    if labels:
        out = torch.empty((B, H * up, W * up), dtype=torch.int32, device=dev)
    else:
        out = torch.empty((B, H * up, W * up, nc), dtype=gy.dtype, device=dev)
    err = library().cswin_carafe(gy.data_ptr(), wenc.data_ptr(), benc.data_ptr(),
                                 bias.data_ptr(), out.data_ptr(), B, H, W, G, c_mid,
                                 nc, up, int(labels), _stream(dev))
    check(err, "carafe")
    carafe_reassemble.launches += 1
    return out


carafe_reassemble.launches = carafe_reassemble.launches_f32 = 0


class CarafeF32Plan(NamedTuple):
    """The float32 CARAFE kernel (``carafe.cu::carafe_f32_kernel``):
    persistent CTAs of ``threads`` threads over 8x8 tiles of low-res pixels,
    a thread one up-position (the lane's fastest index) of ``pixels``
    consecutive pixels of a tile row, the encoder's ci in 16-byte words of
    4 (``c_pad``: c_mid rounded up to 4, the weight's and mid's padding
    zeros); shared memory ``smem_bytes``: the encoder weight once (9·up²
    rows of ``weight_row`` floats, 9·c_pad padded to an odd number of
    16-byte words), two halos of mid (``halo_stride`` floats a pixel), one
    of y (``y_stride`` floats a pixel: nc rounded up to 4, padded at up 2),
    the labels' stage, the encoder bias and the bias; ``ctas_per_sm`` CTAs
    an SM by shared memory and threads."""
    threads: int
    pixels: int
    c_pad: int
    weight_row: int
    halo_stride: int
    y_stride: int
    smem_bytes: int
    ctas_per_sm: int


_CARAFE_TILE = 8           # carafe.cu TW = TH: a tile of 8x8 low-res pixels
_CARAFE_HALO_PX = 100      # carafe.cu HALO_PX: the 8x8 tile and a one-pixel halo
_CARAFE_F32_VEC = 4        # carafe.cu F32_VEC: floats in a 16-byte word
_CARAFE_F32_THREADS = 128  # carafe.cu F32_THREADS


def carafe_f32_plan(c_mid: int, nc: int, G: int, up: int) -> CarafeF32Plan:
    """Mirrors ``carafe.cu::F32Shape`` and ``make_layout_f32`` (the C entry
    ``cswin_carafe_f32_smem`` returns the same count). G does not enter it:
    the halos hold mid's and y's channels, not the padding between."""
    del G
    up2, t, vec = up * up, _CARAFE_TILE, _CARAFE_F32_VEC
    pixels = t if up == 4 else 2
    pad = 0 if up == 4 else vec
    cmp = -(-c_mid // vec) * vec
    ncp = -(-nc // vec) * vec
    ws = 9 * cmp + (0 if 9 * cmp // vec % 2 else vec)
    r16 = lambda b: -(-b // 16) * 16
    smem = (9 * up2 * ws * 4 + 2 * _CARAFE_HALO_PX * (cmp + pad) * 4
            + _CARAFE_HALO_PX * (ncp + pad) * 4 + t * up * t * up * 4 + r16(9 * up2 * 4)
            + r16(nc * 4))
    per_sm = min(_SM_SMEM // (smem + 1024), 2)  # carafe_f32_kernel's launch bounds
    return CarafeF32Plan(_CARAFE_F32_THREADS, pixels, cmp, ws, cmp + pad, ncp + pad, smem,
                         per_sm)


def carafe_f32_items(H: int, W: int, up: int) -> list[tuple[int, int, int]]:
    """The (low-res y, x, up-position) items the float32 kernel's threads
    take over an H x W image, in the order (tile, thread, pixel), each
    inside the image: the kernel's thread mapping (``carafe_f32_kernel``),
    for holding it to cover every item once."""
    t = _CARAFE_TILE
    plan = carafe_f32_plan(4, 1, 8, up)
    xg_n = t // plan.pixels
    items = []
    for y0 in range(0, H, t):
        for x0 in range(0, W, t):
            for tid in range(plan.threads):
                grp, s = divmod(tid, up * up)
                ly, xg = divmod(grp, xg_n)
                for j in range(plan.pixels):
                    y, x = y0 + ly, x0 + xg * plan.pixels + j
                    if y < H and x < W:
                        items.append((y, x, s))
    return items


def _carafe_f32(gy, encoder_weight, encoder_bias, bias, *, c_mid: int, up: int,
                labels: bool) -> torch.Tensor:
    B, H, W, G = gy.shape
    nc = bias.shape[0]
    dev = gy.device
    if up not in (2, 4) or nc < 1 or c_mid < 1 or G < c_mid + nc or G % 4:
        raise ValueError(f"the float32 carafe kernel takes up 2 or 4, 1 <= nc, c_mid + nc "
                         f"<= G and G a multiple of 4, got up {up}, c_mid {c_mid}, nc {nc}, "
                         f"G {G}")
    if tuple(encoder_weight.shape) != (9 * up * up, c_mid, 3, 3):
        raise ValueError(f"encoder weight shape {tuple(encoder_weight.shape)}")
    plan = carafe_f32_plan(c_mid, nc, G, up)
    if plan.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"the float32 carafe kernel needs {plan.smem_bytes} bytes of shared "
                         f"memory at c_mid {c_mid}, G {G}, up {up}: more than {SMEM_LIMIT}")
    # (kh, kw, s, t, ci), ci padded to c_pad by zeros, each (kh, kw, s) row
    # to plan.weight_row (the kernel reads no float past 9·c_pad): a thread's
    # 9 taps of one up-position s as 16-byte words along ci, in one copy
    u2 = up * up
    wenc = torch.empty((3, 3, u2, plan.weight_row), dtype=torch.float32, device=dev)
    dst = wenc[..., :9 * plan.c_pad].unflatten(-1, (9, plan.c_pad))
    if plan.c_pad != c_mid:
        dst[..., c_mid:].zero_()
    dst[..., :c_mid].copy_(encoder_weight.reshape(9, u2, c_mid, 3, 3).permute(3, 4, 1, 0, 2))
    benc = encoder_bias.float().contiguous()
    if gy.data_ptr() % 16 or wenc.data_ptr() % 16:
        raise ValueError("carafe kernel needs a 16-byte aligned gy and encoder weight")
    if labels:
        out = torch.empty((B, H * up, W * up), dtype=torch.int32, device=dev)
    else:
        out = torch.empty((B, H * up, W * up, nc), dtype=torch.float32, device=dev)
    err = library().cswin_carafe_f32(gy.data_ptr(), wenc.data_ptr(), benc.data_ptr(),
                                     bias.data_ptr(), out.data_ptr(), B, H, W, G, c_mid,
                                     nc, up, int(labels), _stream(dev))
    check(err, "carafe")
    _counted(carafe_reassemble, torch.float32)
    return out


# ---------------------------------------------------------------------------
# block_pair.cu
# ---------------------------------------------------------------------------

def _block_weights(p, C: int, cb: int, dev: torch.device,
                   dtype: torch.dtype = torch.bfloat16) -> list:
    """One block's 16 parameters as the whole-block kernels read them:
    matrices and LePE biases in ``dtype`` (the activations'), LePE taps
    (9, cb) tap-major in ``dtype``, LN and GEMM biases float32 as given; a
    missing qkv bias stays None, a missing LePE bias becomes zeros. The list
    keeps the cast tensors alive until the launch is queued."""
    shapes = ((C,), (C,), (3 * C, C), (3 * C,), (cb, 1, 3, 3), (cb,), (cb, 1, 3, 3), (cb,),
              (C, C), (C,), (C,), (C,), (4 * C, C), (4 * C,), (C, 4 * C), (C,))
    names = ("norm1_w", "norm1_b", "qkv_w", "qkv_b", "lepe0_w", "lepe0_b", "lepe1_w",
             "lepe1_b", "proj_w", "proj_b", "norm2_w", "norm2_b", "fc1_w", "fc1_b",
             "fc2_w", "fc2_b")
    keep = []
    for i, (t, shape, name) in enumerate(zip(p, shapes, names)):
        if t is None and i in (3, 5, 7):  # qkv without bias; LePE bias as zeros
            keep.append(None if i == 3 else torch.zeros(cb, dtype=dtype, device=dev))
            continue
        _require(t, name, torch.float32, dev, shape)
        if i in (0, 1, 10, 11):
            _require_aligned(**{name: t})
        if i in (4, 6):
            keep.append(t.reshape(cb, 9).t().to(dtype).contiguous())
        elif i in (5, 7) or t.dim() == 2:
            keep.append(t.to(dtype).contiguous())
        else:
            keep.append(t)
    return keep


def _block_plain(x: torch.Tensor, p, *, heads: int, split: int, scale: float,
                 eps: float) -> torch.Tensor:
    """One dual-branch block through the chain's plain steps, in the
    chain's order (``cswin_block._chain`` on a CPU tensor)."""
    B, H, W, C = x.shape
    dt = x.dtype
    (n1w, n1b, qkv_w, qkv_b, l0w, l0b, l1w, l1b, proj_w, proj_b, n2w, n2b,
     fc1_w, fc1_b, fc2_w, fc2_b) = p
    rows = x.reshape(B * H * W, C).contiguous()
    xn = layernorm_plain(rows, n1w, n1b, eps)
    qkv = gemm_plain(xn, qkv_w.to(dt), qkv_b).view(B, H, W, 3 * C)
    att = torch.empty((B, H, W, C), dtype=dt, device=x.device)
    half = C // 2
    for off, lw, lb, hs, ws in ((0, l0w, l0b, H, split), (half, l1w, l1b, split, W)):
        stripe_attention_plain(qkv, lw, lb, att, ch_off=off, heads=heads // 2,
                               h_sp=hs, w_sp=ws, scale=scale)
    x1 = gemm_plain(att.view(B * H * W, C), proj_w.to(dt), proj_b, residual=rows,
                    epilogue="residual")
    y = layernorm_plain(x1, n2w, n2b, eps)
    g = gemm_plain(y, fc1_w.to(dt), fc1_b, epilogue="gelu")
    out = gemm_plain(g, fc2_w.to(dt), fc2_b, residual=x1, epilogue="residual")
    return out.view(B, H, W, C)


def block_pair_plain(x: torch.Tensor, p1, p2, *, heads: int, split: int,
                     scale: float, eps: float = 1e-5) -> torch.Tensor:
    for p in (p1, p2):
        x = _block_plain(x, p, heads=heads, split=split, scale=scale, eps=eps)
    return x


def block_pair(x: torch.Tensor, p1, p2, *, heads: int, split: int, scale: float,
               eps: float = 1e-5) -> torch.Tensor:
    """Two consecutive dual-branch CSWin blocks of one geometry in one
    launch (inference: no drop-path, no gradient).

    x: (B, H, W, C); p1, p2: each block's 16 parameters in the order of
    ``cswin_block.BlockParams`` (float32; Linear (out, in), LePE (C/2, 1, 3,
    3)). Returns what two block chains return: on the CPU the same plain
    steps in the same order, so the two agree bit for bit; on the GPU the
    same device code per tile. Matrices and LePE are cast to bf16 per call,
    as the chain casts them; a float32 ``x`` launches the float32 instance,
    on the chain's float32 tiles (equal to two float32 chains bit for bit)
    at C <= 512, every dual-branch width of the configs. A last-stage
    geometry (one full-window branch, ``split >= H``) is refused.
    """
    if _on_cpu(x):
        return block_pair_plain(x, p1, p2, heads=heads, split=split, scale=scale,
                                eps=eps)
    return _block_pair(x, p1, p2, heads=heads, split=split, scale=scale, eps=eps,
                       stop=PAIR_STOPS["all"])


def _block_pair(x: torch.Tensor, p1, p2, *, heads: int, split: int, scale: float,
                eps: float, stop: int) -> torch.Tensor:
    B, H, W, C = x.shape
    dev = x.device
    dt = _act_dtype(x, "x")
    _require(x, "x", dt, dev)
    _require_aligned(x=x)
    if split >= H or H % split or W % split or C % 8 or heads % 2:
        raise ValueError(f"block_pair takes two dual-branch blocks: H={H} W={W} "
                         f"C={C} heads={heads} split={split}")
    half = C // 2
    _check_head_dim(half, heads // 2)
    if dt == torch.float32:
        if C > _PAIR_F32_MAX_C:
            raise ValueError(f"the float32 block_pair takes C <= {_PAIR_F32_MAX_C}, got {C}")
        _check_attention_f32_smem(max(H, W) * split, half // (heads // 2))
    keep = _block_weights(p1, C, half, dev, dt) + _block_weights(p2, C, half, dev, dt)
    if any(_ptr(t) % 16 for t in keep):
        raise ValueError("block_pair copies 16-byte chunks of its weights: 16-byte aligned "
                         "parameters")
    ptrs = (ctypes.c_void_p * 32)(*(_ptr(t) for t in keep))
    info = (ctypes.c_int * 3)()
    scratch = torch.empty(7 * x.numel(), dtype=dt, device=dev)
    out = torch.empty_like(x)
    args = (x.data_ptr(), ctypes.addressof(ptrs), scratch.data_ptr(), out.data_ptr(), B, H, W,
            C, heads, split, scale, eps)
    if dt == torch.bfloat16:
        err = library().cswin_block_pair(*args, ctypes.addressof(info), _stream(dev))
    else:
        err = library().cswin_block_pair_f32(*args, stop, ctypes.addressof(info), _stream(dev))
    check(err, "block_pair")
    block_pair.grid = dict(ctas=info[0], ctas_per_sm=info[1], smem_bytes=info[2])
    if stop == PAIR_STOPS["all"]:
        _counted(block_pair, dt)
        return out
    mc = x.numel()  # the phase's output in the scratch (block_pair.cuh's ScratchT)
    if stop == PAIR_STOPS["qkv"]:
        return scratch[mc:4 * mc].view(B * H * W, 3 * C)
    return scratch[:mc].view_as(x) if stop == PAIR_STOPS["attention"] else \
        scratch[5 * mc:6 * mc].view_as(x)


# block_phases.cuh Stop: the first block's last phase of a stopped float32
# pair (``block_pair_phases``)
PAIR_STOPS = {"qkv": 2, "attention": 3, "proj": 4, "all": 7}


def block_pair_phases(x: torch.Tensor, p1, p2, *, stop: str, heads: int, split: int,
                      scale: float, eps: float = 1e-5) -> torch.Tensor:
    """The float32 pair's first block up to phase ``stop`` (``qkv``,
    ``attention`` or ``proj``) in one launch of the pair kernel, for timing
    the phases one by one: returns that phase's output (qkv (M, 3C), the
    attention's (B, H, W, C), x1 (B, H, W, C)). Counts no launch of
    ``block_pair``; a CUDA float32 ``x`` only."""
    if _on_cpu(x) or x.dtype != torch.float32 or stop not in ("qkv", "attention", "proj"):
        raise ValueError("block_pair_phases takes a CUDA float32 x and a stop of qkv, "
                         "attention or proj")
    return _block_pair(x, p1, p2, heads=heads, split=split, scale=scale, eps=eps,
                       stop=PAIR_STOPS[stop])


def block_pair_f32_smem(H: int, W: int, C: int, heads: int, split: int) -> int:
    """Dynamic shared memory of the float32 pair (``block_phases::
    smem_bytes<D, float>``): the larger of the float32 GEMM tile's
    (``gemm_f32::Smem<64, 64, false>``, the chain's ring and staged output)
    and the widest window's float32 attention staging."""
    return max(gemm_f32_smem(*_PAIR_F32_TILE),
               attention_f32_plan(max(H, W) * split, C // heads).smem_bytes)


block_pair.launches = block_pair.launches_f32 = 0
block_pair.grid = None  # the last launch's grid, CTAs per SM and shared memory


# ---------------------------------------------------------------------------
# block_one.cu
# ---------------------------------------------------------------------------

# The attention forms of the one-block kernel: (form of P, LePE) -> the
# tile's mode (attention_tile.cuh).
_BLOCK_FORMS = {("softmax", True): 0, ("softmax", False): 1, ("scale", True): 6,
                ("scale", False): 7, ("value", True): 8}
_LN, _GELU, _TRANSPOSE, _V_ONLY = 1, 2, 4, 8
_STOP_NONE, _STOP_QKV, _STOP_ATTENTION, _STOP_PROJ, _STOP_ALL = 0, 2, 3, 4, 7

# ``scripts/ablate_block.py``'s VARIANTS: the parts each switches off.
# ``form``: "softmax", "scale" (P = bf16(s/L)) or "value" (out = v).
BLOCK_VARIANTS = {
    "full": {},
    "no-lepe": dict(lepe=False),
    "no-transpose": dict(transpose=False),
    "no-softmax": dict(form="scale"),
    "no-attn": dict(form="value"),
    "no-ln": dict(ln=False),
    "no-gelu": dict(gelu=False),
    "matmuls-only": dict(lepe=False, transpose=False, form="scale", ln=False,
                         gelu=False),
}
CUM_LEVELS = 8  # scripts/exp_cum.py's levels 0-7


def block_plan(variant: str = "full", level: int | None = None) -> dict:
    """What a ``block_one`` call runs: LN, GELU, the vertical branch's
    transposed windows, the attention ``form``, LePE, the last phase
    (``stop``: 0 none, 2 qkv, 3 attention, 4 proj, 7 all) and whether the
    horizontal branch runs. A build-up ``level`` runs the phases its terms
    need (levels 1 and 2 the same, LN1 + qkv; 3 the vertical branch without
    LePE; 4 with it; 5 both branches; 6 + proj; 7 the whole block)."""
    if variant not in BLOCK_VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {sorted(BLOCK_VARIANTS)}")
    plan = dict(dict(ln=True, gelu=True, transpose=True, form="softmax", lepe=True,
                     stop=_STOP_ALL, v_only=False), **BLOCK_VARIANTS[variant])
    if level is None:
        return plan
    if variant != "full" or not 0 <= level < CUM_LEVELS:
        raise ValueError(f"a build-up level is 0-{CUM_LEVELS - 1} of the full block, got "
                         f"level={level} variant={variant!r}")
    plan["stop"] = (_STOP_NONE, _STOP_QKV, _STOP_QKV, _STOP_ATTENTION, _STOP_ATTENTION,
                    _STOP_ATTENTION, _STOP_PROJ, _STOP_ALL)[level]
    plan["v_only"] = level in (3, 4)
    plan["lepe"] = level != 3
    return plan


def _plan_branches(p, H: int, W: int, C: int, heads: int, split: int, last_stage: bool,
                   plan: dict):
    """(channel offset, width, heads, h_sp, w_sp, LePE weight, LePE bias) of
    each branch a plan runs."""
    if last_stage:
        return [(0, C, heads, H, W, p[4], p[5])]
    half, nh = C // 2, heads // 2
    vert = (H, split) if plan["transpose"] else (split, W)
    branches = [(0, half, nh, *vert, p[4], p[5])]
    if not plan["v_only"]:
        branches.append((half, half, nh, split, W, p[6], p[7]))
    return branches


def attention_form_plain(qkv: torch.Tensor, lepe_weight: torch.Tensor,
                         lepe_bias: torch.Tensor | None, out: torch.Tensor, *, ch_off: int,
                         heads: int, h_sp: int, w_sp: int, scale: float,
                         form: str = "softmax", lepe: bool = True) -> torch.Tensor:
    """One stripe branch from packed qkv (B, H, W, 3C) in one of the
    one-block kernel's forms, written into channels [ch_off, ch_off + cb) of
    ``out``: P = bf16(softmax(s)) (``"softmax"``), P = bf16(s · (1/L))
    (``"scale"``), or no attention (``"value"``, the branch's v), with
    s = bf16(q·scale)·kᵀ and P·v in float32; then with ``lepe`` the chain's
    LePE, bf16(bf16(o) + bf16(bf16(conv(v, w)) + b)), else bf16(o). The
    softmax form with LePE is ``stripe_attention_plain``."""
    if form == "softmax" and lepe:
        return stripe_attention_plain(qkv, lepe_weight, lepe_bias, out, ch_off=ch_off,
                                      heads=heads, h_sp=h_sp, w_sp=w_sp, scale=scale)
    B, H, W, C3 = qkv.shape
    C = C3 // 3
    cb = lepe_weight.shape[0]
    dt = qkv.dtype
    q, k, v = (qkv[..., i * C + ch_off:i * C + ch_off + cb] for i in range(3))
    vw = _branch_windows(v, h_sp, w_sp, heads).float()
    if form == "value":
        o = vw
    elif form in ("softmax", "scale"):
        s = (_branch_windows(q, h_sp, w_sp, heads) * scale).float() @ \
            _branch_windows(k, h_sp, w_sp, heads).float().transpose(-1, -2)
        p = torch.softmax(s, dim=-1) if form == "softmax" else s * (1.0 / (h_sp * w_sp))
        o = p.to(dt).float() @ vw
    else:
        raise ValueError(f"unknown attention form {form!r}")
    o = window_merge(o.to(dt).permute(0, 2, 1, 3).reshape(-1, h_sp * w_sp, cb), h_sp,
                     w_sp, H, W)
    if lepe:
        v_img = window_partition(v, h_sp, w_sp).reshape(-1, h_sp, w_sp, cb)
        term = depthwise_conv3x3(v_img, lepe_weight, lepe_bias)
        o = o + window_merge(term.reshape(-1, h_sp * w_sp, cb), h_sp, w_sp, H, W)
    out[..., ch_off:ch_off + cb] = o
    return out


def _cum_plain(x, qkv, att, x1, out, level: int) -> torch.Tensor:
    """The build-up's accumulator (block_one.cu::cum_phase), in its order:
    x + 1e-6·T(x), then each level's terms, rounded once to x.dtype."""
    C = x.shape[-1]
    half = C // 2
    T = lambda t: t.transpose(1, 2)                       # pixel (h, w) <- (w, h)
    D = lambda t: torch.cat([t, t], -1).float()           # both channel halves
    F_ = lambda o: (qkv[..., o:o + half] + qkv[..., C + o:C + o + half]) \
        + qkv[..., 2 * C + o:2 * C + o + half]            # q + k + v, bf16 adds
    acc = x.float() + T(x).float() * 1e-6
    if level >= 1:
        acc = acc + D(F_(half))
    if level >= 2:
        acc = acc + T(D(F_(0)))
    if level == 3:
        acc = acc + T(D(att[..., :half]))
    if level in (4, 5):
        acc = acc + D(att[..., :half])
    if level >= 5:
        acc = acc + D(att[..., half:])
    if level >= 6:
        acc = acc + x1.float()
    if level == 7:
        acc = acc + out.float()
    return acc.to(x.dtype)


def block_one_plain(x: torch.Tensor, p, *, heads: int, split: int, scale: float,
                    last_stage: bool, variant: str = "full", level: int | None = None,
                    eps: float = 1e-5) -> torch.Tensor:
    """``block_one``'s plain version: the chain's plain steps in the chain's
    order with the plan's parts switched off, then the build-up epilogue at a
    ``level``. With every part on it is the chain on a CPU tensor, bit for
    bit."""
    plan = block_plan(variant, level)
    B, H, W, C = x.shape
    dt = x.dtype
    (n1w, n1b, qkv_w, qkv_b, _, _, _, _, proj_w, proj_b, n2w, n2b,
     fc1_w, fc1_b, fc2_w, fc2_b) = p
    rows = x.reshape(B * H * W, C).contiguous()
    qkv = att = x1 = out = None
    if plan["stop"] >= _STOP_QKV:
        xn = layernorm_plain(rows, n1w, n1b, eps) if plan["ln"] else rows
        qkv = gemm_plain(xn, qkv_w.to(dt), qkv_b).view(B, H, W, 3 * C)
    if plan["stop"] >= _STOP_ATTENTION:
        att = torch.zeros((B, H, W, C), dtype=dt, device=x.device)
        for off, cb, nh, hs, ws, lw, lb in _plan_branches(p, H, W, C, heads, split,
                                                          last_stage, plan):
            attention_form_plain(qkv, lw, lb, att, ch_off=off, heads=nh, h_sp=hs,
                                 w_sp=ws, scale=scale, form=plan["form"],
                                 lepe=plan["lepe"])
    if plan["stop"] >= _STOP_PROJ:
        x1 = gemm_plain(att.view(B * H * W, C), proj_w.to(dt), proj_b, residual=rows,
                        epilogue="residual")
    if plan["stop"] >= _STOP_ALL:
        y = layernorm_plain(x1, n2w, n2b, eps) if plan["ln"] else x1
        g = gemm_plain(y, fc1_w.to(dt), fc1_b, epilogue="gelu" if plan["gelu"] else "bias")
        out = gemm_plain(g, fc2_w.to(dt), fc2_b, residual=x1,
                         epilogue="residual").view(B, H, W, C)
    if level is None:
        return out
    return _cum_plain(x, qkv, att, None if x1 is None else x1.view(B, H, W, C), out, level)


def block_one(x: torch.Tensor, p, *, heads: int, split: int, scale: float,
              last_stage: bool, variant: str = "full", level: int | None = None,
              eps: float = 1e-5) -> torch.Tensor:
    """One CSWin block in one cooperative launch, with one part switched off
    (``variant``, a key of ``BLOCK_VARIANTS``: ``scripts/ablate_block.py``)
    or built up to a ``level`` 0-7 (``scripts/exp_cum.py``: each level's
    values summed into one float32 accumulator, returned in x.dtype).

    x: (B, H, W, C); p: the block's 16 parameters in the order of
    ``cswin_block.BlockParams`` (float32; a last-stage block passes its one
    LePE in both slots). Inference only. ``last_stage``: one branch over the
    full H x W window with all heads. The kernel is compiled for head dim
    32 (tiny-224) and takes the build-up at square dual-branch stages only;
    other geometries raise. The full block (``variant="full"``) equals the
    block chain bit for bit."""
    plan = block_plan(variant, level)
    if _on_cpu(x):
        return block_one_plain(x, p, heads=heads, split=split, scale=scale,
                               last_stage=last_stage, variant=variant, level=level, eps=eps)
    B, H, W, C = x.shape
    dev = x.device
    _require(x, "x", torch.bfloat16, dev)
    _require_aligned(x=x)
    if last_stage != (split >= H):
        raise ValueError(f"last_stage={last_stage} but split={split}, H={H}: the kernel "
                         "takes a last stage as split >= H")
    if C % 8 or C % heads or C // heads != 32 or (not last_stage and (
            heads % 2 or H % split or W % split)):
        raise ValueError(f"block_one takes head dim 32 and windows that tile the image: "
                         f"H={H} W={W} C={C} heads={heads} split={split}")
    if level is not None and (last_stage or H != W):
        raise ValueError("the build-up runs at square dual-branch stages")
    keep = _block_weights(p, C, C if last_stage else C // 2, dev)
    ptrs = (ctypes.c_void_p * 16)(*(_ptr(t) for t in keep))
    info = (ctypes.c_int * 3)()
    flags = ((_LN if plan["ln"] else 0) | (_GELU if plan["gelu"] else 0)
             | (_TRANSPOSE if plan["transpose"] else 0) | (_V_ONLY if plan["v_only"] else 0))
    scratch = torch.empty(10 * x.numel(), dtype=torch.bfloat16, device=dev)
    out = torch.empty_like(x)
    err = library().cswin_block_one(
        x.data_ptr(), ctypes.addressof(ptrs), scratch.data_ptr(), out.data_ptr(), B, H, W,
        C, heads, split, scale, eps, _BLOCK_FORMS[(plan["form"], plan["lepe"])], flags,
        plan["stop"], -1 if level is None else level, ctypes.addressof(info), _stream(dev))
    check(err, "block_one")
    block_one.launches += 1
    block_one.grid = dict(ctas=info[0], ctas_per_sm=info[1], smem_bytes=info[2])
    return out


block_one.launches = 0
block_one.grid = None  # the last launch's grid, CTAs per SM and shared memory


# ---------------------------------------------------------------------------
# edt.cu
# ---------------------------------------------------------------------------

_EDT_MAX_L = 2048  # edt.cu FAST_MAX_L: the fast predicates' bound on L
_EDT_SMEM_MAX, _EDT_WARPS, _EDT_TW = 232448, 8, 9  # edt.cu SMEM_MAX, WARPS, TW


class EdtPlan(NamedTuple):
    """How ``edt_pass`` cuts the lines (``edt.cu``): each line in ``parts``
    parts of ``segment`` points, a warp a part of 32 lines; a CTA of eight
    warps stages ``lines`` lines in ``smem_bytes`` of shared memory."""
    parts: int
    segment: int
    lines: int
    smem_bytes: int


def _edt_smem(L: int, parts: int, lines: int, last: bool) -> int:
    seg = -(-L // parts)
    return ((_EDT_WARPS * 32 * _EDT_TW * 4 if last else 0) + L * (lines + 1) * 4
            + parts * seg * lines * 2 + parts * lines * (2 * 4 + 3 * 2 + 1))


def edt_pass_plan(L: int, last: bool) -> EdtPlan:
    """Mirrored from ``edt.cu``: parts of at most 32 points where 8 allow,
    32 lines a group of ``parts`` warps (256 / parts a CTA), fewer where a
    long line's tile would pass 227 KB; ``last``: along the contiguous axis
    (the warps' transpose buffers). ``lines`` 0 where one line does not
    fit."""
    parts = 1 if L <= 32 else 2 if L <= 64 else 4 if L <= 128 else 8
    seg = -(-L // parts)
    if 1 <= L <= 65535:
        lines = _EDT_WARPS // parts * 32
        while lines >= 1:
            if _edt_smem(L, parts, lines, last) <= _EDT_SMEM_MAX:
                return EdtPlan(parts, seg, lines, _edt_smem(L, parts, lines, last))
            lines -= 32 if lines > 32 else 1
    return EdtPlan(parts, seg, 0, 0)


class _Pt(NamedTuple):
    j: int
    f: float      # the float32 value, exactly
    n: int | None  # the value as an integer where the fast predicates take it


def _pt(j: int, f: float, L: int) -> _Pt:
    small = L <= _EDT_MAX_L and abs(f) <= 2.0 ** 40 and f == math.trunc(f)
    return _Pt(j, f, int(f) if small else None)


def _two_sum(a: float, b: float) -> tuple[float, float]:
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _sign_sum4(a: float, b: float, c: float, d: float) -> int:
    """The sign of a + b + c + d, exactly, as ``edt.cu`` reads it: the
    Grow-Expansion of the four by TwoSums, then its largest nonzero
    component."""
    q, e0 = _two_sum(b, a)
    r, e0 = _two_sum(c, e0)
    r, e1 = _two_sum(r, q)
    t, e0 = _two_sum(d, e0)
    t, e1 = _two_sum(t, e1)
    t, e2 = _two_sum(t, r)
    top = next((e for e in (t, e2, e1, e0) if e != 0.0), 0.0)
    return (top > 0.0) - (top < 0.0)


def edt_keep(a: _Pt, b: _Pt, q: _Pt) -> bool:
    """``edt.cu`` ``keep``: b (a < b < q) stays on the lower hull of
    (j, f[j] + j²), i.e. d1·f[q] + d2·f[a] − (d1 + d2)·f[b] + d1·d2·(d1 + d2)
    > 0 with d1 = b − a, d2 = q − b; in integers where every value is a
    small integer (the kernel's int64), else by the exact expansion of the
    float64 terms."""
    d1, d2 = b.j - a.j, q.j - b.j
    c = d1 * d2 * (d1 + d2)
    if a.n is not None and b.n is not None and q.n is not None:
        return d1 * q.n + d2 * a.n - (d1 + d2) * b.n + c > 0
    return _sign_sum4(float(d1) * q.f, float(d2) * a.f, -float(d1 + d2) * b.f, float(c)) > 0


def edt_advance(v: _Pt, w: _Pt, i: int) -> bool:
    """``edt.cu`` ``advance``: the hull point w > v is at least as good as v
    at i, f[w] − f[v] + (w − v)·(v + w − 2i) <= 0."""
    j = (w.j - v.j) * (v.j + w.j - 2 * i)
    if v.n is not None and w.n is not None:
        return w.n - v.n + j <= 0
    return _sign_sum4(w.f, -v.f, float(j), 0.0) <= 0


def _edt_parts(vals: list[float], L: int) -> tuple[list[list[_Pt]], int]:
    """Each part's hull, as ``edt.cu`` builds it (points above the line's
    pruning bound left out), and the line's flags (1: a NaN, 2: a -inf)."""
    plan = edt_pass_plan(L, True)
    finite = [v for v in vals if not math.isnan(v)]
    m = min(finite, default=math.inf)
    t = m + float(L - 1) * float(L - 1)
    bound = t + abs(t) * 2.0 ** -52
    flags, hulls = 0, []
    for part in range(plan.parts):
        stack: list[_Pt] = []
        for q in range(part * plan.segment, min(L, (part + 1) * plan.segment)):
            if not math.isfinite(vals[q]):
                flags |= 1 if math.isnan(vals[q]) else 2 if vals[q] < 0 else 0
                continue
            if vals[q] > bound:
                continue
            p = _pt(q, vals[q], L)
            while len(stack) >= 2 and not edt_keep(stack[-2], stack[-1], p):
                stack.pop()
            stack.append(p)
        hulls.append(stack)
    return hulls, flags


def _edt_merge(hulls: list[list[_Pt]]) -> tuple[list[int], list[int]]:
    """``edt.cu``'s merge of the parts' hulls, step for step: each part's
    points join one stack by the pop test until two of them stand on it,
    after which its convex rest stands too. Returns each part's surviving
    entries as ranges [lo, hi); the stack's top two are (ts, tp) and
    (ss, sp)."""
    P = len(hulls)
    lo, hi = [0] * P, [0] * P
    size = ts = tp = ss = sp = 0
    top = sec = None
    for w, pts in enumerate(hulls):
        n, l, h = len(pts), 0, 0
        for t in range(n):
            q = pts[t]
            while size >= 2 and not edt_keep(sec, top, q):  # pop the top
                if ts == w:
                    h = tp
                else:
                    hi[ts] = tp
                size -= 1
                top, ts, tp = sec, ss, sp
                if size >= 2:  # the element under the new top
                    if (sp > l) if ss == w else (sp > lo[ss]):
                        sp -= 1
                    else:
                        ss -= 1
                        while hi[ss] == lo[ss]:
                            ss -= 1
                        sp = hi[ss] - 1
                    sec = hulls[ss][sp]
            if h == l:  # push q
                l = t
            h = t + 1
            size += 1
            sec, ss, sp = top, ts, tp
            top, ts, tp = q, w, t
            if h - l >= 2:  # two of this part stand: so does its convex rest
                size += n - h
                if n > h:
                    top, sec, tp, ss, sp = pts[n - 1], pts[n - 2], n - 1, w, n - 2
                h = n
                break
        lo[w], hi[w] = l, h
    assert size == sum(b - a for a, b in zip(lo, hi))
    return lo, hi


def _edt_line(f: np.ndarray) -> np.ndarray:
    """One line through ``edt.cu``: a line of one value (no NaN) as it is;
    else the parts' hulls, their merge, and each part's outputs from the
    hull point a binary search finds for its first i."""
    L = f.shape[0]
    vals = [float(x) for x in f]
    if not any(math.isnan(v) for v in vals) and min(vals) == max(vals):
        return np.float32(0.0) + f.astype(np.float32)
    hulls, flags = _edt_parts(vals, L)
    lo, hi = _edt_merge(hulls)
    hull = [hulls[w][e] for w in range(len(hulls)) for e in range(lo[w], hi[w])]
    if flags or not hull:
        return np.full(L, np.nan if flags & 1 else -np.inf if flags & 2 else np.inf,
                       np.float32)
    out, seg = np.empty(L, np.float32), edt_pass_plan(L, True).segment
    for i0 in range(0, L, seg):
        a, b = 0, len(hull) - 1  # the first h whose next point is worse at i0
        while a < b:
            m = (a + b) // 2
            a, b = (m + 1, b) if edt_advance(hull[m], hull[m + 1], i0) else (a, m)
        h = a
        for i in range(i0, min(L, i0 + seg)):
            while h + 1 < len(hull) and edt_advance(hull[h], hull[h + 1], i):
                h += 1
            v = hull[h]
            out[i] = np.float32((i - v.j) * (i - v.j)) + np.float32(v.f)
    return out


def edt_envelope_reference(f: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """The O(L) lower-envelope pass of ``edt.cu`` mirrored in NumPy, line by
    line: the same parts, pruning, merge and walk, the same predicates in the same
    arithmetic, the same tie rule and the same float32 output expression. It
    runs on no path; the tests hold it to ``edt_pass_plain`` bit for bit,
    which checks on the CPU the exactness argument the kernel relies on."""
    x = f.detach().cpu().movedim(axis, -1).contiguous()
    lines = x.numpy().reshape(-1, x.shape[-1]).astype(np.float32, copy=False)
    out = np.stack([_edt_line(line) for line in lines]) if lines.size else lines.copy()
    return torch.from_numpy(out.reshape(x.shape)).movedim(-1, axis).contiguous()


def edt_pass_plain(f: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """``g[..., i, ...] = min_j (i - j)² + f[..., j, ...]`` along ``axis``,
    float32, in the order of the JAX ``_edt_pass_kernel``: the exact d·d
    plus f, then the min. Lines go in chunks so that the (lines, L, L)
    candidates stay near 256 MiB."""
    x = f.movedim(axis, -1)
    L = x.shape[-1]
    lines = x.reshape(-1, L)
    idx = torch.arange(L, device=f.device)
    d = (idx[:, None] - idx[None, :]).float()
    d2 = d * d
    out = torch.empty_like(lines)
    chunk = max(1, 2**26 // (L * L))
    for s in range(0, lines.shape[0], chunk):
        out[s:s + chunk] = (d2 + lines[s:s + chunk, None, :]).amin(-1)
    return out.reshape(x.shape).movedim(-1, axis).contiguous()


def edt_pass(f: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Exact 1-D squared-EDT min-plus pass along ``axis`` of a contiguous
    float32 tensor (+inf written as 1e12 at non-seeds): ``g[i] = min_j
    (i - j)² + f[j]`` per line. The kernel reads the volume in place as
    (outer, L, inner), so no axis is moved, and walks each line's lower
    envelope in O(L) with exact predicates; the result equals
    ``edt_pass_plain`` bit for bit (``edt_envelope_reference`` mirrors it).
    Lines of 1 to 2048."""
    if _on_cpu(f):
        return edt_pass_plain(f, axis)
    _require(f, "f", torch.float32, f.device)
    axis %= f.dim()
    L = f.shape[axis]
    if L > _EDT_MAX_L:
        raise ValueError(f"edt_pass: line length {L} exceeds {_EDT_MAX_L} (the float64 "
                         "predicates' bound)")
    g = torch.empty_like(f)
    if f.numel() == 0:
        return g
    outer = f.shape[:axis].numel()
    inner = f.shape[axis + 1:].numel()
    err = library().cswin_edt_pass(f.data_ptr(), g.data_ptr(), outer, L, inner,
                                   _stream(f.device))
    check(err, "edt_pass")
    edt_pass.launches += 1
    return g


edt_pass.launches = 0

# ---------------------------------------------------------------------------
# The block lab's kernels: the parts of the block alone (tools/block_lab.py)
# ---------------------------------------------------------------------------

_ATTENTION_MODES = {"attention": 1, "no_softmax": 2, "copy": 3, "softmax": 4, "stage": 5}
_ACTIVATIONS = {"gelu": 0, "clamp": 1}


def _as_image(t: torch.Tensor, sp_h: int, sp_w: int, name: str) -> torch.Tensor:
    """A stack of windows (n, L, c) as the image batch (n, sp_h, sp_w, c)
    whose images are the windows (a view); an image batch (B, H, W, c) as it
    is."""
    if t.dim() == 3:
        if t.shape[1] != sp_h * sp_w:
            raise ValueError(f"{name}: windows of {t.shape[1]} tokens, expected "
                             f"{sp_h}x{sp_w}")
        return t.unflatten(1, (sp_h, sp_w))
    if t.dim() != 4:
        raise ValueError(f"{name}: expected (n, L, c) or (B, H, W, c), got "
                         f"{tuple(t.shape)}")
    return t


def _lepe_taps(taps: torch.Tensor, bias: torch.Tensor | None, c: int, swap: bool,
               tap_dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Taps (3, 3, c) and bias (c,) as the kernel reads them: (9, c)
    tap-major, the tap grid transposed with ``swap``, in ``tap_dtype``."""
    if tuple(taps.shape) != (3, 3, c):
        raise ValueError(f"taps have shape {tuple(taps.shape)}, expected (3, 3, {c})")
    if bias is None:
        bias = torch.zeros(c, dtype=taps.dtype, device=taps.device)
    if tuple(bias.shape) != (c,):
        raise ValueError(f"bias has shape {tuple(bias.shape)}, expected ({c},)")
    if swap:
        taps = taps.transpose(0, 1)
    return taps.reshape(9, c).to(tap_dtype).contiguous(), bias.to(tap_dtype).contiguous()


# lepe_windows.cu's constants: THREADS, CH, SEG, STAGES, MAX_NB, TILE_BYTES
_LEPE_THREADS, _LEPE_CH, _LEPE_SEG, _LEPE_STAGES = 128, 4, 7, 2
_LEPE_MAX_NB, _LEPE_TILE_BYTES = 16, 14 * 1024
SMEM_MAX = 232448  # persistent.cuh SMEM_MAX: the H100's 227 KB a block


class LepePlan(NamedTuple):
    """How ``lepe_windows`` cuts its work (``lepe_windows.cu``): a tile is
    ``group`` consecutive windows times a channel block of ``nb`` output
    chunks of 8 channels, ``slots`` chunks staged a pixel (with ``fold`` the
    chunks of both halves, ``2·nb``); ``blocks`` channel blocks, ``tiles``
    tiles, the channel block fastest. A ring of ``stages`` tiles takes
    ``smem_bytes``; ``grid`` persistent CTAs (one wave of ``ctas_per_sm``
    an SM) walk tiles cta, cta + grid, ...; a thread takes ``CH`` channels
    of a chunk and walks ``seg`` outputs along a window row."""
    nb: int
    slots: int
    blocks: int
    group: int
    tiles: int
    smem_bytes: int
    ctas_per_sm: int
    grid: int
    seg: int = _LEPE_SEG
    stages: int = _LEPE_STAGES


def lepe_windows_plan(B: int, H: int, W: int, c: int, sp_h: int, sp_w: int,
                      fold: bool = False, ctas_per_sm: int = 4, sms: int = _SMS) -> LepePlan:
    """Mirrored from ``lepe_windows.cu::make_plan``: ``nb`` the largest power
    of two up to 16 that divides the output chunks, keeps a pixel's threads
    within a warp (the fold's shuffles) and one window's staged chunks
    within the 14 KB a tile aims at (down to one chunk), as many whole
    windows a tile as fit that; ``ctas_per_sm`` is the occupancy
    API's answer on the card (the wrapper does not need it: the kernel sizes
    its own wave). Raises for a geometry the kernel does not take, and for a
    window whose chunk (pair) does not fit two stages in 227 KB."""
    if (B < 1 or sp_h < 1 or sp_w < 1 or H % sp_h or W % sp_w or c < 8 or c % 8
            or (fold and c % 16) or B * H * W > 2**31 - 1):
        raise ValueError(f"lepe_windows: bad geometry B={B} H={H} W={W} window=({sp_h},"
                         f"{sp_w}) c={c} fold={fold}")
    windows, px = B * (H // sp_h) * (W // sp_w), sp_h * sp_w
    out_chunks = (c // 2 if fold else c) // 8
    per_window = lambda n: px * (2 * n if fold else n) * 16
    parts = 8 // _LEPE_CH  # threads a staged chunk
    max_nb = min(_LEPE_MAX_NB, 32 // (parts * (2 if fold else 1)))
    nb = 1
    while nb * 2 <= max_nb and out_chunks % (nb * 2) == 0:
        nb *= 2
    while nb > 1 and per_window(nb) > _LEPE_TILE_BYTES:
        nb //= 2
    if _LEPE_STAGES * per_window(nb) > SMEM_MAX:
        raise ValueError(f"lepe_windows: a window of {px} pixels takes {per_window(nb)} bytes "
                         f"a chunk{' pair' if fold else ''}; two ring stages do not fit 227 KB")
    group = max(1, min(windows, _LEPE_TILE_BYTES // per_window(nb)))
    blocks = out_chunks // nb
    tiles = -(-windows // group) * blocks
    if tiles > 2**31 - 1:
        raise ValueError(f"lepe_windows: {tiles} tiles")
    return LepePlan(nb, 2 * nb if fold else nb, blocks, group, tiles,
                    _LEPE_STAGES * group * per_window(nb), ctas_per_sm,
                    min(tiles, ctas_per_sm * sms))


def lepe_windows_outputs(plan: LepePlan, windows: int, sp_h: int, sp_w: int, cta: int):
    """The outputs CTA ``cta`` stores, in the kernel's loop order, as (window,
    row, column, first output channel of ``CH``): tiles cta, cta + grid, ...;
    in a tile the items (window, row, segment, slot, part), the part of a
    chunk fastest, each walking ``seg`` columns of its row; with fold the
    lower slot of a pair stores."""
    nseg, parts = -(-sp_w // plan.seg), 8 // _LEPE_CH
    for t in range(cta, plan.tiles, plan.grid):
        wg, kb = divmod(t, plan.blocks)
        for it in range(plan.group * sp_h * nseg * plan.slots * parts):
            r, lane = divmod(it, plan.slots * parts)
            slot, part = divmod(lane, parts)
            gy, seg = divmod(r, nseg)
            g, y = divmod(gy, sp_h)
            win = wg * plan.group + g
            if win < windows and slot < plan.nb:
                for x in range(seg * plan.seg, min(sp_w, (seg + 1) * plan.seg)):
                    yield win, y, x, (kb * plan.nb + slot) * 8 + part * _LEPE_CH


def lepe_windows_staged(plan: LepePlan, windows: int, px: int, half: int, t: int):
    """The (window, pixel, input chunk) copies tile ``t`` stages, in the
    kernel's order ([window][pixel][slot]); ``half``: with fold the first
    chunk of the second half, the partner of slot ``s`` being ``s + nb``."""
    wg, kb = divmod(t, plan.blocks)
    for g in range(min(plan.group, windows - wg * plan.group)):
        for p in range(px):
            for s in range(plan.slots):
                yield (wg * plan.group + g, p,
                       half + kb * plan.nb + s - plan.nb if s >= plan.nb else kb * plan.nb + s)


def div_magic(d: int) -> tuple[int, int]:
    """(m, l) of ``lepe_windows.cu``'s ``Div``: for 0 <= n < 2**31,
    ``n // d == ((n * m >> 32) + n) >> l``, l = ceil(log2 d)."""
    l = (d - 1).bit_length()
    return (((1 << l) - d) << 32) // d + 1, l


def lepe_windows_kernel_plan(B: int, H: int, W: int, c: int, sp_h: int, sp_w: int,
                             fold: bool = False,
                             tap_dtype: torch.dtype = torch.float32) -> LepePlan:
    """The plan the kernel takes for this geometry on the current device, as
    ``cswin_lepe_windows_plan`` reports it (the card's occupancy and SMs)."""
    info = (ctypes.c_int * 8)()
    check(library().cswin_lepe_windows_plan(B, H, W, c, sp_h, sp_w, int(fold),
                                            int(tap_dtype == torch.bfloat16), info),
          "lepe_windows_plan")
    return LepePlan(*info)


def lepe_windows_plain(v: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor | None,
                       *, sp_h: int, sp_w: int, swap: bool = False,
                       taps2: torch.Tensor | None = None,
                       bias2: torch.Tensor | None = None, n0: int | None = None,
                       v2: torch.Tensor | None = None, fold: bool = False,
                       tap_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    img = _as_image(v, sp_h, sp_w, "v")
    if v2 is not None:
        img = torch.cat([img, _as_image(v2, sp_h, sp_w, "v2")], -1)
    B, H, W, c = img.shape
    win = window_partition(img, sp_h, sp_w).reshape(-1, sp_h, sp_w, c).float()
    n = win.shape[0]
    k0, b0 = _lepe_taps(taps, bias, c, swap, tap_dtype)
    k, b = k0.float().expand(n, 9, c), b0.float().expand(n, c)
    if taps2 is not None:
        k1, b1 = _lepe_taps(taps2, bias2, c, False, tap_dtype)
        second = torch.arange(n, device=v.device) >= n0
        k = torch.where(second[:, None, None], k1.float(), k0.float())
        b = torch.where(second[:, None], b1.float(), b0.float())
    pad = F.pad(win, (0, 0, 1, 1, 1, 1))
    acc = b[:, None, None, :]
    for di in range(3):
        for dj in range(3):
            acc = acc + pad[:, di:di + sp_h, dj:dj + sp_w] * k[:, di * 3 + dj, None, None, :]
    if fold:
        acc = acc[..., :c // 2] + acc[..., c // 2:]
    out = window_merge(acc.reshape(n, sp_h * sp_w, -1), sp_h, sp_w, H, W).to(v.dtype)
    return out.reshape(*v.shape[:-1], out.shape[-1])


def lepe_windows(v: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor | None, *,
                 sp_h: int, sp_w: int, swap: bool = False,
                 taps2: torch.Tensor | None = None, bias2: torch.Tensor | None = None,
                 n0: int | None = None, v2: torch.Tensor | None = None,
                 fold: bool = False,
                 tap_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """LePE alone: the depthwise 3x3 convolution on V inside each
    ``(sp_h, sp_w)`` window, zero beyond the window's edge.

    ``out[.., i, j, ch] = bias[ch] + Σ_{a,b} taps[a, b, ch] · v[.., i+a-1,
    j+b-1, ch]``, float32 accumulation, one rounding. v: a stack of windows
    (n, L, c) or an image batch (B, H, W, c) tiled by windows, bf16 on the
    GPU, channels contiguous and pixels evenly apart, so it may be the last
    third of a packed (.., 3c) qkv tensor, read in place. taps: (3, 3, c),
    bias: (c,) or None, read in ``tap_dtype`` (float32 or bfloat16).
    ``swap`` transposes the tap grid (a branch computed in transposed image
    coordinates). ``taps2`` / ``bias2``: a second set, unswapped, for the
    windows from index ``n0`` on (two branches' windows stacked on the
    batch). ``v2``: a second source whose channels follow v's (two branches
    stacked on channels; the taps cover both); ``fold`` adds the two channel
    halves of the result, ``out[.., :c/2] + out[.., c/2:]``. Returns a new
    contiguous tensor in v's layout."""
    if (taps2 is None) != (n0 is None):
        raise ValueError("taps2 and n0 are given together")
    if tap_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"tap_dtype {tap_dtype}: float32 or bfloat16")
    kw = dict(sp_h=sp_h, sp_w=sp_w, swap=swap, taps2=taps2, bias2=bias2, n0=n0, v2=v2,
              fold=fold, tap_dtype=tap_dtype)
    if _on_cpu(v):
        return lepe_windows_plain(v, taps, bias, **kw)
    dev = v.device
    views = [_as_image(v, sp_h, sp_w, "v")]
    if v2 is not None:
        views.append(_as_image(v2, sp_h, sp_w, "v2"))
    B, H, W, c1 = views[0].shape
    strides = []
    for name, t in zip(("v", "v2"), views):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} is {t.dtype}, the kernel takes torch.bfloat16")
        if tuple(t.shape[:3]) != (B, H, W):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected ({B}, {H}, "
                             f"{W}, c)")
        strides.append(_pixel_stride(t, name))
        if t.shape[-1] % 8 or strides[-1] % 8 or t.data_ptr() % 16:
            raise ValueError(f"{name}: channels and pixel stride must be multiples of "
                             "8 and the data 16-byte aligned")
    c = sum(t.shape[-1] for t in views)
    lepe_windows_plan(B, H, W, c, sp_h, sp_w, fold)  # refuses what the kernel does not take
    windows = B * (H // sp_h) * (W // sp_w)
    for name, t in (("taps", taps), ("bias", bias), ("taps2", taps2), ("bias2", bias2)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    w0, b0 = _lepe_taps(taps, bias, c, swap, tap_dtype)
    w1, b1 = w0, b0
    if taps2 is not None:
        if not 0 <= n0 <= windows:
            raise ValueError(f"n0={n0} outside the {windows} windows")
        w1, b1 = _lepe_taps(taps2, bias2, c, False, tap_dtype)
    c_out = c // 2 if fold else c
    out = torch.empty((B, H, W, c_out), dtype=torch.bfloat16, device=dev)
    second = views[1] if v2 is not None else None
    err = library().cswin_lepe_windows(
        views[0].data_ptr(), strides[0], _ptr(second), strides[-1], c1, w0.data_ptr(),
        b0.data_ptr(), w1.data_ptr(), b1.data_ptr(), int(tap_dtype == torch.bfloat16),
        out.data_ptr(), B, H, W, c, sp_h, sp_w, windows if n0 is None else n0, int(fold),
        _stream(dev))
    check(err, "lepe_windows")
    lepe_windows.launches += 1
    return out.reshape(*v.shape[:-1], c_out)


lepe_windows.launches = 0


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           heads: int, scale: float, h_sp: int | None = None,
                           w_sp: int | None = None,
                           mode: str = "attention") -> torch.Tensor:
    image = q.dim() == 4
    qw, kw, vw = ((window_partition(t, h_sp, w_sp) for t in (q, k, v)) if image
                  else (q, k, v))
    if mode == "copy":
        out = (qw + kw) + vw
    elif mode == "stage":
        out = (kw.float() + vw.float()).to(q.dtype)
    else:
        n, L, C = qw.shape
        d = C // heads
        hd = lambda t: t.reshape(n, L, heads, d).permute(0, 2, 1, 3)
        s = (hd(qw) * scale).float() @ hd(kw).float().transpose(-1, -2)
        p = (s * 1e-4 if mode == "no_softmax" else torch.softmax(s, dim=-1)).to(q.dtype)
        if mode == "softmax":  # P's row folded to the head's width
            out = F.pad(p.float(), (0, -L % d)).reshape(n, heads, L, -1, d).sum(-2)
        else:
            out = p.float() @ hd(vw).float()
        out = out.to(q.dtype).permute(0, 2, 1, 3).reshape(n, L, C)
    return window_merge(out, h_sp, w_sp, q.shape[1], q.shape[2]) if image else out


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, heads: int,
                     scale: float, h_sp: int | None = None, w_sp: int | None = None,
                     mode: str = "attention") -> torch.Tensor:
    """Stripe-window attention alone, without LePE: per window and head
    ``bf16(P · v)`` with ``P = bf16(softmax(bf16(q·scale) · kᵀ))``, scores,
    softmax and P·v in float32.

    q, k, v: stacks of windows (n, L, C), or image batches (B, H, W, C) with
    the window ``(h_sp, w_sp)`` (1 x W: rows, H x 1: columns); bf16 on the
    GPU, channels contiguous, pixels one common stride apart (so they may be
    the thirds of one packed qkv tensor). ``mode``: ``"attention"``;
    ``"no_softmax"``, the two products with the softmax stubbed by
    ``P = bf16(s · 1e-4)`` (wrong math, the same shapes); ``"copy"``,
    ``bf16(bf16(q + k) + v)``, the traffic alone; ``"softmax"``, the first
    product and the softmax without the second product, P's row folded to
    the head's width d (``out[i, dd] = bf16(P[i, dd] + P[i, dd + d] + ...)``);
    ``"stage"``, ``bf16(k + v)`` through the kernel's shared-memory staging of
    q, k and v. Returns a new contiguous tensor in q's layout."""
    if mode not in _ATTENTION_MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if q.dim() not in (3, 4):
        raise ValueError(f"q: expected (n, L, C) or (B, H, W, C), got {tuple(q.shape)}")
    if (q.dim() == 4) != (h_sp is not None and w_sp is not None):
        raise ValueError("h_sp and w_sp are given exactly for image batches (B, H, W, C)")
    if _on_cpu(q):
        return window_attention_plain(q, k, v, heads=heads, scale=scale, h_sp=h_sp,
                                      w_sp=w_sp, mode=mode)
    qi, ki, vi = q, k, v
    if q.dim() == 3:  # each window an image of one row
        qi, ki, vi = (t.unsqueeze(1) for t in (q, k, v))
        h_sp, w_sp = 1, q.shape[1]
    B, H, W, cb = qi.shape
    stride = _check_qkv(qi, ki, vi, h_sp, w_sp, heads)
    out = torch.empty((B, H, W, cb), dtype=torch.bfloat16, device=q.device)
    err = library().cswin_window_attention(
        qi.data_ptr(), ki.data_ptr(), vi.data_ptr(), stride, out.data_ptr(), B, H, W, cb,
        heads, h_sp, w_sp, scale, _ATTENTION_MODES[mode], _stream(q.device))
    check(err, "window_attention")
    window_attention.launches += 1
    return out.reshape(q.shape)


window_attention.launches = 0


def _activate(h: torch.Tensor, act: str) -> torch.Tensor:
    if act == "gelu":
        return F.gelu(h)
    return h * (h + 0.5).clamp(0.0, 1.0)


# ln_mlp.cu's constants: C, HID, BM, WARPS, STAGES
_MLP_C, _MLP_HIDDEN, _MLP_ROWS, _MLP_WARPS, _MLP_STAGES = 64, 256, 192, 12, 2


class LnMlpPlan(NamedTuple):
    """How ``ln_mlp`` cuts its rows (``ln_mlp.cu``): tiles of
    ``rows_per_tile`` rows, 64 a warpgroup and 16 a warp of ``warps``,
    through a ring of ``stages`` tiles beside both weight matrices in
    ``smem_bytes``; ``grid`` persistent CTAs (one wave of ``ctas_per_sm`` an
    SM) walk tiles cta, cta + grid, ..."""
    rows_per_tile: int
    stages: int
    smem_bytes: int
    tiles: int
    ctas_per_sm: int
    grid: int
    warps: int = _MLP_WARPS


def ln_mlp_smem() -> int:
    """``sizeof(Smem)`` of ``ln_mlp.cu``: fc1_w and fc2_w, the biases, the
    ring and the normalised tile (rows padded by 8), in 128-byte units."""
    ldx = _MLP_C + 8
    size = (2 * (2 * _MLP_HIDDEN * _MLP_C + (_MLP_STAGES + 1) * _MLP_ROWS * ldx)
             + 4 * (_MLP_HIDDEN + _MLP_C))
    return -(-size // 128) * 128


def ln_mlp_plan(rows: int, C: int = _MLP_C, hidden: int = _MLP_HIDDEN, ctas_per_sm: int = 1,
                sms: int = _SMS) -> LnMlpPlan:
    """Mirrored from ``ln_mlp.cu::plan``; ``ctas_per_sm`` is the occupancy
    API's answer on the card (one: the shared memory). Raises for a width
    or a row count the kernel does not take."""
    if C != _MLP_C or hidden != _MLP_HIDDEN:
        raise ValueError(f"ln_mlp is compiled for C={_MLP_C} with hidden {_MLP_HIDDEN}, got "
                         f"C={C}, hidden={hidden}")
    if not 1 <= rows <= 2**31 - 1:
        raise ValueError(f"ln_mlp: {rows} rows")
    tiles = -(-rows // _MLP_ROWS)
    return LnMlpPlan(_MLP_ROWS, _MLP_STAGES, ln_mlp_smem(), tiles, ctas_per_sm,
                     min(tiles, ctas_per_sm * sms))


def ln_mlp_rows(plan: LnMlpPlan, rows: int, cta: int) -> list[int]:
    """The rows CTA ``cta`` takes, in its loop order: tiles cta, cta + grid,
    ..., each ``rows_per_tile`` rows, the last cut at ``rows``."""
    return [r for t in range(cta, plan.tiles, plan.grid)
            for r in range(t * plan.rows_per_tile, min(rows, (t + 1) * plan.rows_per_tile))]


def mma_fragment(kind: str, lane: int) -> list[tuple[int, int]]:
    """The (row, column) that each value of ``lane`` holds in PTX's
    mma.m16n8k16 fragments (``common.cuh``), in register order, two bf16
    halves a register: ``"a"`` the 16x16 A (four registers), ``"b"`` the
    16x8 B as (k, n) (two registers), ``"c"`` the 16x8 float32 C (four
    values)."""
    g, q = divmod(lane, 4)
    if kind == "a":
        return [(g + 8 * (r % 2), 2 * q + h + 8 * (r // 2)) for r in range(4) for h in range(2)]
    if kind == "b":
        return [(2 * q + h + 8 * r, g) for r in range(2) for h in range(2)]
    return [(g + 8 * (e // 2), 2 * q + e % 2) for e in range(4)]


def repack_c_to_a(c: np.ndarray) -> np.ndarray:
    """``ln_mlp.cu``'s repack of fc1's accumulators as fc2's A operand, per
    lane: c (lanes, 2k, 4), the values of 2k adjacent n8 C tiles, to
    (lanes, k, 8), the k16 A fragments in register order (pairs of values
    before their bf16 packing): tiles 2i and 2i + 1 give a0 a1 and a2 a3 of
    fragment i."""
    lanes, tiles, _ = c.shape
    a = np.empty((lanes, tiles // 2, 4, 2), c.dtype)
    for j in range(tiles):
        a[:, j // 2, (j % 2) * 2] = c[:, j, 0:2]
        a[:, j // 2, (j % 2) * 2 + 1] = c[:, j, 2:4]
    return a.reshape(lanes, tiles // 2, 8)


def ln_mlp_kernel_plan(rows: int, act: str = "gelu", ln: bool = True,
                       fold: bool = False) -> LnMlpPlan:
    """The plan the kernel takes for ``rows`` rows in this mode on the
    current device, as ``cswin_ln_mlp_plan`` reports it."""
    info = (ctypes.c_int * 6)()
    check(library().cswin_ln_mlp_plan(rows, _ACTIVATIONS[act], int(ln), int(fold), info),
          "ln_mlp_plan")
    return LnMlpPlan(*info)


def ln_mlp_plain(x: torch.Tensor, norm_w: torch.Tensor | None,
                 norm_b: torch.Tensor | None, fc1_w: torch.Tensor,
                 fc1_b: torch.Tensor | None, fc2_w: torch.Tensor | None = None,
                 fc2_b: torch.Tensor | None = None, *, act: str = "gelu",
                 ln: bool = True, fold: bool = False, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    C = x.shape[-1]
    y = layernorm_plain(x, norm_w, norm_b, eps) if ln else x
    h = y.float() @ fc1_w.to(dt).float().t()
    if fc1_b is not None:
        h = h + fc1_b.float()
    a = _activate(h.to(dt).float(), act)
    if fold:
        return a.reshape(*x.shape[:-1], -1, C).sum(-2).to(dt)
    o = a.to(dt).float() @ fc2_w.to(dt).float().t()
    if fc2_b is not None:
        o = o + fc2_b.float()
    return (x.float() + o.to(dt).float()).to(dt)


def ln_mlp(x: torch.Tensor, norm_w: torch.Tensor | None, norm_b: torch.Tensor | None,
           fc1_w: torch.Tensor, fc1_b: torch.Tensor | None,
           fc2_w: torch.Tensor | None = None, fc2_b: torch.Tensor | None = None, *,
           act: str = "gelu", ln: bool = True, fold: bool = False,
           eps: float = 1e-5) -> torch.Tensor:
    """The MLP half of a block in one launch, the hidden never written to
    memory: ``x + fc2(act(fc1(LN(x))))`` over the last axis, rounded to
    ``x.dtype`` after LN, fc1 (with its bias), the activation and fc2 (with
    its bias), then after the residual sum.

    x: (..., C); norm_w, norm_b: (C,) float32; fc1_w: (4C, C) and fc2_w:
    (C, 4C) in the torch Linear layout, in ``x.dtype`` on the GPU; fc1_b
    (4C,), fc2_b (C,) float32 or None. ``act``: ``"gelu"`` (exact erf) or
    ``"clamp"`` (``h · min(max(h + 0.5, 0), 1)``, a stand-in without the
    erf); ``ln=False`` feeds x to fc1 as it is; ``fold=True`` stops after
    the activation and returns the hidden, unrounded, summed over its four
    C-wide groups in float32 and rounded once (no fc2, no residual). The
    kernel is compiled for C = 64 (tiny-224's stage 1); other widths raise
    on the GPU."""
    if act not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}")
    if ln and (norm_w is None or norm_b is None):
        raise ValueError("ln=True needs norm_w and norm_b")
    if not fold and fc2_w is None:
        raise ValueError("fc2_w is needed unless fold=True")
    if _on_cpu(x):
        return ln_mlp_plain(x, norm_w, norm_b, fc1_w, fc1_b, fc2_w, fc2_b, act=act,
                            ln=ln, fold=fold, eps=eps)
    C = x.shape[-1]
    hidden = fc1_w.shape[0]
    dev = x.device
    rows = x.numel() // C
    ln_mlp_plan(rows, C, hidden)  # refuses what the kernel does not take
    _require(x, "x", torch.bfloat16, dev)
    _require(fc1_w, "fc1_w", torch.bfloat16, dev, (hidden, C))
    if ln:
        _require(norm_w, "norm_w", torch.float32, dev, (C,))
        _require(norm_b, "norm_b", torch.float32, dev, (C,))
        _require_aligned(norm_w=norm_w, norm_b=norm_b)
    if fc1_b is not None:
        _require(fc1_b, "fc1_b", torch.float32, dev, (hidden,))
    if not fold:
        _require(fc2_w, "fc2_w", torch.bfloat16, dev, (C, hidden))
        if fc2_b is not None:
            _require(fc2_b, "fc2_b", torch.float32, dev, (C,))
    if any(t.data_ptr() % 16 for t in (x, fc1_w) + (() if fold else (fc2_w,))):
        raise ValueError("ln_mlp needs 16-byte aligned x and weights (16-byte copies)")
    out = torch.empty_like(x)
    err = library().cswin_ln_mlp(
        x.data_ptr(), _ptr(norm_w if ln else None), _ptr(norm_b if ln else None),
        fc1_w.data_ptr(), _ptr(fc1_b), _ptr(None if fold else fc2_w),
        _ptr(None if fold else fc2_b), out.data_ptr(), rows, C, hidden, eps,
        _ACTIVATIONS[act], int(ln), int(fold), _stream(dev))
    check(err, "ln_mlp")
    ln_mlp.launches += 1
    return out


ln_mlp.launches = 0

KERNELS = (layernorm, gemm, stripe_attention, carafe_reassemble, layernorm_bwd,
           gemm_dgrad, gemm_wgrad, stripe_attention_bwd, cswin_attention, edt_pass,
           block_pair, lepe_windows, window_attention, ln_mlp, block_one)
# The wrappers with a float32 instance (``launches_f32``).
F32_KERNELS = (layernorm, gemm, stripe_attention, cswin_attention, carafe_reassemble,
               block_pair, layernorm_bwd, gemm_dgrad, gemm_wgrad, stripe_attention_bwd)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
    for k in F32_KERNELS:
        k.launches_f32 = 0
    stripe_attention_bwd.launches_split = 0


def launch_counts() -> dict[str, int]:
    """Each wrapper's launches (both instances), and as ``<name>_f32`` the
    float32 instances' among them."""
    return {**{k.__name__: k.launches for k in KERNELS},
            **{f"{k.__name__}_f32": k.launches_f32 for k in F32_KERNELS}}


def total_launches() -> int:
    """Launches of every kernel, each once."""
    return sum(k.launches for k in KERNELS)


def device_launches() -> int:
    """Device kernels the wrappers launched: one a launch, two a float32
    ``stripe_attention_bwd`` launch and two a bf16 one on the split route
    (their row and key kernels)."""
    return (total_launches() + stripe_attention_bwd.launches_f32
            + stripe_attention_bwd.launches_split)
