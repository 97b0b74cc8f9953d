"""The yardstick's arithmetic: the model's FLOPs, the work of the
program's kernel families, and the card's peaks.

Peaks: NVIDIA H100 SXM5 datasheet, dense rates at the 700 W limit: 989
TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32 outside them, 3.35
TB/s of HBM3.

``model_flops`` counts the published model's products, 2 a multiply-add, as
``torch.utils.flop_counter.FlopCounterMode`` counts them over
``reference.forward`` (linear layers, convolutions, both attention
products, the CARAFE reassembly); a training step is three forwards
(forward, and the backward's two products a product), recomputation not
counted.

``serve_calls`` and ``train_calls`` list the launches of the program's
GEMM, stripe-attention and block-pair kernels in one forward of B slices
or one bs-B training step, each with its bytes (each input read once, each
output written once) and operations, a frozen copy of the per-case
arithmetic that the repository's kernel smoke test (``chip_smoke.py``,
``compare_kernels`` and its backward cases; at float32
``compare_f32_kernels`` and ``f32_backward_kernels``) holds each kernel
to. The configuration's ``compute_dtype`` picks the instance: at
``bfloat16`` activations and the products' operands take 2 bytes an
element and the products run on the tensor cores; at ``float32`` they take
4 and every operation runs on FFMA. A call's bound is the larger of its
bytes over the bandwidth and its operations over the peak of their pipe
(bf16 products on the tensor cores, the rest in float32); a family's bound
is the sum over its calls. Which stages the program pairs and which CARAFE
sites it fuses are read from its launch counters (``route_from_counts``:
at float32 the float32 instances' counters, ``<name>_f32``), never
assumed.
"""

from __future__ import annotations

import itertools
from collections import Counter
from dataclasses import dataclass

from .reference import drop_path_rates, stages

HBM_BPS, TC_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
BF16, F32 = 2, 4
# By compute_dtype: the bytes of an activation or a product's operand, and
# the peak of the model's products.
ELEMENT = {"bfloat16": BF16, "float32": F32}
PEAK_FLOPS = {"bfloat16": TC_FLOPS, "float32": F32_FLOPS}
# The wrappers whose launch counters decide the route (route_from_counts).
COUNTED = ("gemm", "gemm_dgrad", "gemm_wgrad", "stripe_attention",
           "stripe_attention_bwd", "block_pair", "carafe_reassemble")


# ---------------------------------------------------------------------------
# Model FLOPs


def _block_flops(n: int, g: dict) -> int:
    C = g["dim"]
    flops = 2 * n * C * (3 * C + C + 4 * C + 4 * C)
    for cb, L in _branches(g):
        flops += 4 * n * L * cb + 18 * n * cb
    return flops


def _carafe_flops(r: int, c: int, c_out: int, up: int) -> int:
    cm, taps = c // 4, 9 * up * up
    hi = (r * up) ** 2
    return 2 * r * r * (cm * c + taps * cm * 9) + 2 * hi * c * 9 + 2 * hi * c_out * c


def model_flops(cfg: dict) -> int:
    """Products of one forward of one slice, 2 a multiply-add."""
    geo, ed, img = stages(cfg), cfg["embed_dim"], cfg["img_size"]
    r0 = img // 4
    flops = 2 * r0 * r0 * ed * cfg["in_chans"] * 49
    for s, g in enumerate(geo):
        n = g["reso"] ** 2
        flops += 2 * g["depth"] * _block_flops(n, g)
        if s < 3:
            nxt = geo[s + 1]
            flops += 2 * nxt["reso"] ** 2 * nxt["dim"] * g["dim"] * 9
        if s > 0:
            prev = geo[s - 1]
            flops += _carafe_flops(g["reso"], g["dim"], prev["dim"], 2)
            flops += 2 * prev["reso"] ** 2 * 2 * prev["dim"] * prev["dim"]
    flops += _carafe_flops(r0, ed, ed, 4)
    flops += 2 * img * img * ed * cfg["num_classes"]
    return flops


def train_step_flops(cfg: dict, batch: int) -> int:
    return 3 * batch * model_flops(cfg)


# ---------------------------------------------------------------------------
# Kernel work


@dataclass
class Call:
    family: str | None     # "gemm", "attention", "block_pair" (trace.FAMILIES), or None
    wrapper: str
    bytes: float = 0.0
    tc: float = 0.0        # bf16 tensor-core operations
    f32: float = 0.0       # other operations, float32

    @property
    def bound_s(self) -> float:
        return max(self.bytes / HBM_BPS, self.tc / TC_FLOPS, self.f32 / F32_FLOPS)


def _call(family: str, wrapper: str, nbytes, tc, f32, elem: int) -> Call:
    """A launch of the instance of element size ``elem``: a bf16 one's
    products (``tc``) on the tensor cores, a float32 one's on FFMA."""
    if elem == F32:
        return Call(family, wrapper, nbytes, 0.0, tc + f32)
    return Call(family, wrapper, nbytes, tc, f32)


def element_bytes(cfg: dict) -> int:
    return ELEMENT[cfg["compute_dtype"]]


def _branches(g: dict) -> list[tuple[int, int]]:
    """(channels, window tokens) of each stripe branch of a block."""
    C, H = g["dim"], g["reso"]
    if g["last"]:
        return [(C, H * H)]
    return [(C // 2, H * g["split"])] * 2


def _heads(g: dict) -> int:
    return g["heads"] if g["last"] else g["heads"] // 2


def _attention(M: int, cb: int, L: int, heads: int, e: int) -> Call:
    """One stripe branch over M tokens, activations of ``e`` bytes: q, k, v
    read and the output written, the float32 LePE taps and bias; Q·Kᵀ and
    P·V on the tensor cores (bf16), softmax (~5 a score) and the 9-tap LePE
    in float32."""
    return _call("attention", "stripe_attention", 4 * M * cb * e + (9 * cb + cb) * F32,
                 4 * M * L * cb, 5 * M * heads * L + 18 * M * cb, e)


def _attention_bwd(M: int, cb: int, L: int, heads: int, e: int) -> Call:
    return _call("attention", "stripe_attention_bwd", M * cb * e * 7 + 9 * cb * F32
                 + 10 * cb * F32, 10 * M * L * cb, M * heads * 8 * L + 36 * M * cb, e)


def _gemm_serve(M: int, K: int, n: int, e: int, *, residual: bool = False,
                gelu: bool = False) -> Call:
    return _call("gemm", "gemm", M * K * e + n * K * e + n * F32
                 + (M * n * e if residual else 0) + M * n * e,
                 2 * M * n * K, M * n * (10 if gelu else 2), e)


def _gemm_train(M: int, K: int, n: int, e: int, *, residual: bool = False,
                gelu: bool = False, dp: int = 0) -> Call:
    """The training forward's GEMM: fc1 also writes its pre-activation."""
    return _call("gemm", "gemm", M * K * e + n * K * e + n * F32
                 + (M * n * e if residual else 0) + dp * F32
                 + M * n * (2 * e if gelu else e), 2 * M * n * K, 0.0, e)


def _dgrad(M: int, n: int, k: int, e: int, *, gelu_h: bool = False, dp: int = 0) -> Call:
    """dX = dY·W: dY (M, n) of ``e`` bytes, W (n, k) as stored, float32."""
    return _call("gemm", "gemm_dgrad", M * n * e + n * k * F32
                 + (M * k * e if gelu_h else 0) + dp * F32 + M * k * e,
                 2 * M * n * k, M * k * (16 if gelu_h else 1), e)


def _wgrad(M: int, k: int, n: int, e: int, *, dp: int = 0) -> Call:
    """dW = dYᵀ·X and db: X (M, k), dY (M, n) of ``e`` bytes; dW, db
    float32."""
    return _call("gemm", "gemm_wgrad", M * k * e + M * n * e + dp * F32
                 + (n * k + n) * F32, 2 * M * n * k, M * n, e)


def _block_pair(M: int, g: dict, e: int) -> Call:
    """Two blocks in one launch: x read and written, both blocks' weights
    (matrices and LePE of ``e`` bytes, the rest float32); per block the four
    products and two branches on tensor cores (bf16), softmax, LePE, two
    LNs, GELU and the epilogues in float32."""
    C = g["dim"]
    cb, L = C // 2, g["reso"] * g["split"]
    heads = g["heads"] // 2
    att = _attention(M, cb, L, heads, e)
    weights = (2 * C + 3 * C + C + 2 * C + 4 * C + C) * F32 + 12 * C * C * e \
        + 2 * (9 * cb + cb) * e
    tc = 2 * M * 12 * C * C + 2 * att.tc
    f32 = 2 * att.f32 + M * C * (16 + 40 + 18)
    return _call("block_pair", "block_pair", 2 * M * C * e + 2 * weights, 2 * tc, 2 * f32, e)


def _gy_channels(c_mid: int, nc: int) -> int:
    return -(-(c_mid + nc) // 8) * 8


def _carafe_sites(cfg: dict, fused_ups: int, batch: int) -> list[Call]:
    """The (down | out) GEMM and the reassembly of each fused CARAFE site:
    the ``fused_ups`` upsamplers of highest resolution, and the tail."""
    geo, e = stages(cfg), element_bytes(cfg)
    sites = sorted(range(1, 4), key=lambda s: -geo[s]["reso"])[:fused_ups]
    calls = []
    for s in sites:
        r, C = geo[s]["reso"], geo[s]["dim"]
        calls += _carafe_site(batch * r * r, C, _gy_channels(C // 4, geo[s - 1]["dim"]), e)
    r, C = geo[0]["reso"], cfg["embed_dim"]
    calls += _carafe_site(batch * r * r, C, _gy_channels(C // 4, cfg["num_classes"]), e)
    return calls


def _carafe_site(M: int, C: int, N: int, e: int) -> list[Call]:
    return [_call("gemm", "gemm", M * C * e + N * C * e + N * F32 + M * N * e,
                  2 * M * N * C, 2 * M * N, e), Call(None, "carafe_reassemble")]


def serve_calls(cfg: dict, batch: int, paired: tuple[int, ...] = (),
                fused_ups: int = 1) -> list[Call]:
    """One forward of ``batch`` slices: the blocks of each stage in
    ``paired`` two a ``block_pair`` launch (an odd last block alone)."""
    calls, e = [], element_bytes(cfg)
    for s, g in enumerate(stages(cfg)):
        M = batch * g["reso"] ** 2
        C = g["dim"]
        pairs = g["depth"] // 2 if s in paired else 0
        singles = g["depth"] - 2 * pairs
        for _ in range(2):  # encoder and decoder
            calls += [_block_pair(M, g, e)] * pairs
            for _ in range(singles):
                calls += [_gemm_serve(M, C, 3 * C, e), _gemm_serve(M, C, C, e, residual=True),
                          _gemm_serve(M, C, 4 * C, e, gelu=True),
                          _gemm_serve(M, 4 * C, C, e, residual=True)]
                calls += [_attention(M, cb, L, _heads(g), e) for cb, L in _branches(g)]
    return calls + _carafe_sites(cfg, fused_ups, batch)


def train_calls(cfg: dict, batch: int, drop_path_rate: float,
                fused_ups: int = 1) -> list[Call]:
    """One training step of ``batch`` slices: every block's forward chain
    and its backward chain; a block of drop-path rate > 0 reads its (batch,)
    multipliers in its residual GEMMs."""
    calls, e = [], element_bytes(cfg)
    rates = drop_path_rates(cfg, drop_path_rate)
    for s, g in enumerate(stages(cfg)):
        M = batch * g["reso"] ** 2
        C = g["dim"]
        for rate in rates[s] * 2:  # encoder and decoder
            dp = batch if rate > 0 else 0
            calls += [_gemm_train(M, C, 3 * C, e), _gemm_train(M, C, C, e, residual=True, dp=dp),
                      _gemm_train(M, C, 4 * C, e, gelu=True),
                      _gemm_train(M, 4 * C, C, e, residual=True, dp=dp)]
            calls += [_attention(M, cb, L, _heads(g), e) for cb, L in _branches(g)]
            calls += [_dgrad(M, C, 4 * C, e, gelu_h=True, dp=dp), _wgrad(M, 4 * C, C, e, dp=dp),
                      _wgrad(M, C, 4 * C, e), _dgrad(M, 4 * C, C, e),
                      _wgrad(M, C, C, e, dp=dp), _dgrad(M, C, C, e, dp=dp),
                      _wgrad(M, C, 3 * C, e), _dgrad(M, 3 * C, C, e)]
            calls += [_attention_bwd(M, cb, L, _heads(g), e) for cb, L in _branches(g)]
    return calls + _carafe_sites(cfg, fused_ups, batch)


def launches(calls: list[Call]) -> Counter:
    return Counter(c.wrapper for c in calls)


def route_from_counts(cfg: dict, units: list, counts: dict, make) -> list[Call] | None:
    """The calls of ``units`` (each a batch size) under the one route whose
    launches equal the program's counters ``counts`` (wrapper -> launches
    over the same units; at float32 ``<wrapper>_f32``, the float32
    instances' launches), or None where no route does. ``make(cfg, batch,
    paired, fused_ups)`` lists one unit's calls. The routes tried: every set
    of stages with two or more dual-branch blocks paired, and 0 to 3 fused
    upsamplers."""
    geo = stages(cfg)
    eligible = [s for s, g in enumerate(geo) if g["depth"] > 1 and not g["last"]]
    suffix = "_f32" if cfg["compute_dtype"] == "float32" else ""
    want = {k: int(counts.get(k + suffix, 0)) for k in COUNTED}
    for n in range(len(eligible) + 1):
        for paired in itertools.combinations(eligible, n):
            for fused_ups in range(4):
                # launches do not depend on the batch: one unit's, times the units
                one = launches(make(cfg, 1, paired, fused_ups))
                if one and all(one.get(k, 0) * len(units) == v for k, v in want.items()):
                    return [c for b in units for c in make(cfg, b, paired, fused_ups)]
    return None


def family_bound_s(calls: list[Call], family: str) -> float:
    return sum(c.bound_s for c in calls if c.family == family)
