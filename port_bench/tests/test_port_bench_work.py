"""The yardstick at each configuration's precision: the bf16 cells' work
counts, routes, kernel families and per-layer readings as they were before
float32 had a cell (frozen figures), and the float32 counts, routes,
families and readings."""

from __future__ import annotations

import hashlib
import itertools
import re

import pytest

from port_bench import harness, rooflines, trace, work
from port_bench.reference import stages
from port_bench.trace import Trace

BASE, TINY = "cswin-base-384", "cswin-tiny-224-lite"


def _cfg(name: str, dtype: str | None = None) -> dict:
    cfg = harness.load_json("configs", name)
    return dict(cfg, compute_dtype=dtype) if dtype else cfg


def _digest(calls) -> str | None:
    if calls is None:
        return None
    rows = repr([(c.family, c.wrapper, c.bytes, c.tc, c.f32) for c in calls])
    return hashlib.sha256(rows.encode()).hexdigest()[:16]


def _every_serve_route(cfg: dict) -> list:
    geo = stages(cfg)
    eligible = [s for s, g in enumerate(geo) if g["depth"] > 1 and not g["last"]]
    calls = []
    for n in range(len(eligible) + 1):
        for paired in itertools.combinations(eligible, n):
            for fused_ups in range(4):
                calls += work.serve_calls(cfg, 32, paired, fused_ups)
    return calls


# Taken from the yardstick before float32 had a cell: every call's family,
# wrapper, bytes and operations, hashed, and each family's bound.
FROZEN = {
    BASE: dict(serve_routes="2fd6d71dce117648", serve="34fac659481467c1",
               train=["86fc38db2bacdba6", "acf78090cfa6d9fe", "649bff41c83fa3e4",
                      "abf04448976bad12"],
               serve_bound=("0.00771167157029896", "0.0016567901229850746"),
               train_bound=("0.01862560604331805", "0.0034174253086567165"),
               flops=191488499712),
    TINY: dict(serve_routes="2f69b467bcfcf6ed", serve="0a0646199643ac2d",
               train=["3e5e1c3e767ec6c9", "6087cda04dbe89b2", "822914b59d166666",
                      "b2e16abc881cb235"],
               serve_bound=("0.0006266378239227321", "0.0001342769671641791"),
               train_bound=("0.0015301026770149254", "0.00027700896477611943"),
               flops=10028225536),
}


@pytest.mark.parametrize("name", [BASE, TINY])
def test_bf16_calls_as_frozen(name):
    cfg, want = _cfg(name), FROZEN[name]
    assert cfg["compute_dtype"] == "bfloat16"
    assert _digest(_every_serve_route(cfg)) == want["serve_routes"]
    serve = work.serve_calls(cfg, 32)
    assert _digest(serve) == want["serve"]
    assert tuple(repr(work.family_bound_s(serve, f)) for f in ("gemm", "attention")) \
        == want["serve_bound"]
    rate = cfg["drop_path_rate"]
    assert [_digest(work.train_calls(cfg, 24, rate, fu)) for fu in range(4)] == want["train"]
    step = work.train_calls(cfg, 24, rate)
    assert tuple(repr(work.family_bound_s(step, f)) for f in ("gemm", "attention")) \
        == want["train_bound"]
    assert work.model_flops(cfg) == want["flops"]


# The existing tests' counters (per unit) and the routes found from them.
SERVE_COUNTS = {TINY: dict(gemm=42, stripe_attention=18, block_pair=8, carafe_reassemble=2),
                BASE: dict(gemm=322, stripe_attention=156, carafe_reassemble=2)}
FROZEN_ROUTES = {("serve", TINY): "ee979a22d090fb6c", ("serve", BASE): "d3336e9e01fae613",
                 ("train", TINY): "a029c61c8f1914ac", ("train", BASE): "bdbce26dc160e5d6"}


def _counts(one: dict, units: int, suffix: str = "") -> dict:
    return {k + suffix: v * units for k, v in one.items()}


def _train_counts(cfg: dict) -> dict:
    return work.launches(work.train_calls(cfg, 24, cfg["drop_path_rate"]))


@pytest.mark.parametrize("name", [BASE, TINY])
def test_bf16_routes_as_frozen(name):
    cfg = _cfg(name)
    serve = work.route_from_counts(cfg, [32, 32, 8], _counts(SERVE_COUNTS[name], 3),
                                   work.serve_calls)
    train = work.route_from_counts(cfg, [24] * 3, _counts(_train_counts(cfg), 3),
                                   rooflines.MAKERS["train"])
    assert _digest(serve) == FROZEN_ROUTES[("serve", name)]
    assert _digest(train) == FROZEN_ROUTES[("train", name)]


@pytest.mark.parametrize("name", [BASE, TINY])
def test_float32_calls_count_four_bytes_and_ffma(name):
    bf, f32 = _cfg(name), _cfg(name, "float32")
    for make in (lambda c: work.serve_calls(c, 32), lambda c: work.serve_calls(c, 32, (1,)),
                 lambda c: work.train_calls(c, 24, c["drop_path_rate"])):
        lo, hi = make(bf), make(f32)
        assert work.launches(lo) == work.launches(hi)
        for a, b in zip(lo, hi):
            assert (a.family, a.wrapper) == (b.family, b.wrapper)
            assert b.tc == 0 and b.f32 == a.tc + a.f32   # every product on FFMA
            assert b.bytes >= a.bytes
    # the last stage's attention forward (one full window): q, k, v and the
    # output at 4 bytes an element, the LePE taps and bias float32
    g = stages(f32)[3]
    M, cb = 24 * g["reso"] ** 2, g["dim"]
    att = [c for c in work.train_calls(f32, 24, 0.5) if c.wrapper == "stripe_attention"]
    assert att[-1].bytes == 4 * M * cb * 4 + 10 * cb * 4


def test_float32_bounds_of_the_smoke_test():
    # the kernel smoke test's float32 bounds (FFMA at 67 TFLOP/s; PERF.md
    # rows 1 and 5): base-384's bs-24 step dX 58.9350, wgrad 58.4846,
    # attention backward 18.1209 ms, its 32-slice forward's attention
    # 9.8744; tiny-224's step 2.9385, 2.8813, 0.5221, its forward with
    # stage 3 paired: attention 0.1508, GEMMs 1.5370, unpaired attention
    # 0.3139 ms
    for name, want in ((BASE, (58.9350, 58.4846, 18.1209)), (TINY, (2.9385, 2.8813, 0.5221))):
        step = work.train_calls(_cfg(name, "float32"), 24, 0.5)
        got = [1e3 * sum(c.bound_s for c in step if c.wrapper == w)
               for w in ("gemm_dgrad", "gemm_wgrad", "stripe_attention_bwd")]
        assert got == pytest.approx(want, abs=5e-4)
    fwd = work.serve_calls(_cfg(BASE, "float32"), 32)
    assert 1e3 * work.family_bound_s(fwd, "attention") == pytest.approx(9.8744, abs=5e-4)
    tiny = _cfg(TINY, "float32")
    paired = work.serve_calls(tiny, 32, (2,))
    assert 1e3 * work.family_bound_s(paired, "attention") == pytest.approx(0.1508, abs=5e-4)
    assert 1e3 * work.family_bound_s(paired, "gemm") == pytest.approx(1.5370, abs=5e-4)
    unpaired = work.serve_calls(tiny, 32)
    assert 1e3 * work.family_bound_s(unpaired, "attention") == pytest.approx(0.3139, abs=5e-4)


@pytest.mark.parametrize("name", [BASE, TINY])
def test_float32_route_from_the_f32_counters(name):
    cfg = _cfg(name, "float32")
    one = _train_counts(cfg)
    both = {**_counts(one, 3), **_counts(one, 3, "_f32")}
    make = rooflines.MAKERS["train"]
    calls = work.route_from_counts(cfg, [24] * 3, both, make)
    assert calls is not None and all(c.tc == 0 for c in calls)
    assert work.launches(calls) == _counts(one, 3)
    # a float32 configuration whose launches were bf16 instances reads nothing
    assert work.route_from_counts(cfg, [24] * 3, _counts(one, 3), make) is None
    # a bf16 configuration reads the counters of both instances, as before
    assert work.route_from_counts(_cfg(name), [24] * 3, both, make) is not None


# The families as they were written before float32 had a cell.
OLD_FAMILIES = {
    "gemm": re.compile(trace._NS + r"(?:gemm|wgrad)_kernel"),
    "attention": re.compile(trace._NS + r"stripe_attention(?:_bwd)?_kernel"),
    "block_pair": re.compile(trace._NS + r"block_pair_kernel"),
}
NS = "void (anonymous namespace)::"
# Device records as the profiler names them: every bf16 kernel name in the
# ledger's breakdowns, mangled forms, and torch's.
BF16_NAMES = [
    NS + "wgrad_kernel<128, 128, false>(WgradParams)",
    NS + "stripe_attention_kernel<24, __nv_bfloat16>(AttnParams)",
    NS + "gemm_kernel<0, false, false, false>(Params)",
    NS + "gemm_kernel<1, false, true, false>(Params)",
    NS + "gemm_kernel<3, true, false, false>(Params)",
    NS + "gemm_kernel<2, false, true, false>(Params)",
    NS + "gemm_kernel<1, false, false, false>(Params)",
    NS + "gemm_kernel<2, false, false, false>(Params)",
    NS + "stripe_attention_bwd_kernel<24, 1>(BwdArgs)",
    NS + "stripe_attention_bwd_kernel<24, 2>(BwdArgs)",
    NS + "layernorm_kernel<__nv_bfloat16, 32, 2>(Params)",
    NS + "block_pair_kernel<false>(PairParams)",
    NS + "carafe_kernel<false>(CarafeParams)",
    "_ZN12_GLOBAL__N_111gemm_kernelILi0ELb0ELb0ELb0EEEvNS_6ParamsE",
    "_ZN12_GLOBAL__N_112wgrad_kernelILi128ELi128ELb0EEEvNS_11WgradParamsE",
    "_ZN12_GLOBAL__N_123stripe_attention_kernelILi24E13__nv_bfloat16EEvNS_10AttnParamsE",
    "void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl>(int, Op)",
    "void at::native::vectorized_elementwise_kernel<8, at::native::bfloat16_copy>(int, Op)",
    "void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, float>(int)",
    "Memcpy HtoD (Pageable -> Device)", "Memcpy DtoH (Device -> Pageable)",
]
# The float32 kernels as the profiler named them in a traced float32 step on
# the card, and the other float32 kernels.
F32_NAMES = {
    NS + "wgrad_f32_kernel<128, 128, false>(WgradParams)": "gemm",
    NS + "gemm_f32_kernel<64, 64, true, 0, false, false, false>(Params)": "gemm",
    NS + "gemm_f32_kernel<64, 64, false, 1, true, false, false>(Params)": "gemm",
    NS + "gemm_f32_kernel<64, 64, true, 3, false, true, false>(Params)": "gemm",
    NS + "stripe_attention_f32_kernel<24>(AttnParams)": "attention",
    NS + "stripe_attention_bwd_f32_rows_kernel<24>(float const*, float const*)": "attention",
    NS + "stripe_attention_bwd_f32_keys_kernel<24>(float const*, float const*)": "attention",
    "_ZN12_GLOBAL__N_115gemm_f32_kernelILi64ELi64ELb1ELi0ELb0ELb0ELb0EEEvNS_6ParamsE": "gemm",
    NS + "block_pair_f32_kernel(PairParams)": "block_pair",
    NS + "carafe_f32_kernel<false>(CarafeParams)": None,
    NS + "layernorm_bwd_kernel<float, 768>(Params)": None,
}


def _family(pats: dict, name: str) -> str | None:
    found = [f for f, pat in pats.items() if pat.search(name)]
    assert len(found) <= 1, (name, found)
    return found[0] if found else None


@pytest.mark.parametrize("name", BF16_NAMES)
def test_bf16_kernels_keep_their_family(name):
    assert trace.FAMILIES["bfloat16"] is trace.FAMILY_KERNELS
    assert _family(trace.FAMILY_KERNELS, name) == _family(OLD_FAMILIES, name)
    assert _family(trace.FAMILIES["float32"], name) is None  # no bf16 kernel in a float32 cell


@pytest.mark.parametrize("name", sorted(F32_NAMES))
def test_float32_kernels_join_their_family(name):
    assert _family(trace.FAMILIES["float32"], name) == F32_NAMES[name]
    assert _family(trace.FAMILY_KERNELS, name) is None  # nor a float32 kernel in a bf16 cell
    assert trace.PORT_KERNELS.search(name)


# ---------------------------------------------------------------------------
# Per-layer readings on a traced stretch made by hand


KERNELS = {
    "bfloat16": {
        "layernorm": [NS + "layernorm_kernel<__nv_bfloat16, 32, 2>(Params)"],
        "layernorm_bwd": [NS + "layernorm_bwd_kernel<__nv_bfloat16, 768>(Params)"],
        "gemm": [NS + "gemm_kernel<0, false, false, false>(Params)"],
        "gemm_dgrad": [NS + "gemm_kernel<3, true, false, false>(Params)"],
        "gemm_wgrad": [NS + "wgrad_kernel<128, 128, false>(WgradParams)"],
        "stripe_attention": [NS + "stripe_attention_kernel<24, __nv_bfloat16>(AttnParams)"],
        "stripe_attention_bwd": [NS + "stripe_attention_bwd_kernel<24, 1>(BwdArgs)",
                                 NS + "stripe_attention_bwd_kernel<24, 2>(BwdArgs)"],
        "block_pair": [NS + "block_pair_kernel<false>(PairParams)"],
        "carafe_reassemble": [NS + "carafe_kernel<false>(CarafeParams)"],
    },
    "float32": {
        "layernorm": [NS + "layernorm_kernel<float, 32, 2>(Params)"],
        "layernorm_bwd": [NS + "layernorm_bwd_kernel<float, 768>(Params)"],
        "gemm": [NS + "gemm_f32_kernel<64, 64, 0, false>(Params)"],
        "gemm_dgrad": [NS + "gemm_f32_kernel<64, 64, 3, true>(Params)"],
        "gemm_wgrad": [NS + "wgrad_f32_kernel<64, 64>(WgradParams)"],
        "stripe_attention": [NS + "stripe_attention_f32_kernel<24>(AttnParams)"],
        "stripe_attention_bwd": [NS + "stripe_attention_bwd_f32_rows_kernel<24>(BwdArgs)",
                                 NS + "stripe_attention_bwd_f32_keys_kernel<24>(BwdArgs)"],
        "carafe_reassemble": [NS + "carafe_f32_kernel<false>(CarafeParams)"],
    },
}
TORCH = ["void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl>(int, Op)",
         "Memcpy HtoD (Pageable -> Device)"]


def _stretch(counts: dict, kernels: dict, units: list, spans: list, done) -> Trace:
    """A traced stretch: each counted launch's device records back to back,
    a torch kernel after every tenth record, a 3 µs gap after each."""
    device, t, i = [], 0.0, 0
    for name, n in sorted(counts.items()):
        for _ in range(n):
            for rec in kernels[name]:
                dur = 50.0 + (i % 7)
                device.append((rec, t, t + dur))
                t += dur + 3.0
                i += 1
                if i % 10 == 0:
                    device.append((TORCH[i % 2], t, t + 2.0))
                    t += 4.0
    launched = sum(len(kernels[k]) * n for k, n in counts.items())
    cpu = [(name, a * t, b * t) for name, a, b in spans]
    return Trace(device, cpu, t / 1e6 * 1.3, launched, dict(counts), units, 0.00289, done)


def _train_context(cfg: dict) -> harness.Context:
    counts = _counts(_train_counts(cfg), 3)
    counts.update(layernorm=3 * 320, layernorm_bwd=3 * 320)
    spans = [("train.step", 0.0, 1.0), ("train.forward", 0.0, 0.3),
             ("train.backward", 0.3, 0.9), ("Optimizer.step#SGD.step", 0.92, 0.99)]
    tr = _stretch(counts, KERNELS[cfg["compute_dtype"]], [24] * 3, spans, 3)
    if cfg["compute_dtype"] == "float32":   # the float32 instances' counters beside
        tr.counts.update(_counts(counts, 1, "_f32"))
    return harness.Context("train", cfg, {}, {"seconds": 20.0, "steps": 84, "batch": 24,
                                              "done": 84}, tr)


def _serve_context(cfg: dict) -> harness.Context:
    units = [32, 32, 8]
    counts = _counts(work.launches(work.serve_calls(cfg, 1)), len(units))
    counts.update(layernorm=len(units) * 160)
    spans = [("serve.segment", 0.0, 1.0), ("infer.volume", 0.01, 0.98),
             ("infer.drain", 0.2, 0.3), ("infer.copy_in", 0.5, 0.55),
             ("serve.prepare", 0.0, 0.01)]
    tr = _stretch(counts, KERNELS["bfloat16"], units, spans, sum(units))
    return harness.Context("serve_volumes", cfg, {}, {"seconds": 20.0, "slices": 4700,
                                                      "done": 4700, "chunks": [32] * 150}, tr)


# Each reader's value on these stretches before float32 had a cell (repr).
FROZEN_READINGS = {
    "train": {"attention_roofline.train": "13.776607710460036",
              "backward_idle_share.train": "60.01910795997385",
              "gemm_roofline.train": "36.53082423276595", "idle_share.train": "53.7034",
              "kernels_per_step.train": "2279.0", "mfu.train": "5.855017422943256",
              "optimizer_ms.train": "0.9633333333333334"},
    "serve": {"attention_roofline.serve": "15.029399575795685",
              "copy_idle_share.serve": "14.97883425594269",
              "idle_share.serve": "66.66296527777777", "kernels_per_chunk.serve": "704.0",
              "mfu.serve": "4.550030074046512", "pad_share.serve": "2.0833333333333335",
              "prep_idle_share.serve": "85.02116574405731"},
}


def _readings(ctx) -> dict:
    return {k: repr(v["value"]) for k, v in harness.per_layer(ctx).items()}


def test_bf16_readings_as_frozen():
    cfg = _cfg(BASE)
    assert _readings(_train_context(cfg)) == FROZEN_READINGS["train"]
    assert _readings(_serve_context(cfg)) == FROZEN_READINGS["serve"]


def test_float32_train_readings():
    ctx = _train_context(_cfg(BASE, "float32"))
    got = harness.per_layer(ctx)   # each a number (the stretch's times are made up)
    assert ctx.trace.tallied
    assert set(got) == set(FROZEN_READINGS["train"])
    assert all(v["value"] > 0 for v in got.values()), got
    # the model's FLOPs against the float32 peak, not the tensor cores'
    mfu16 = float(FROZEN_READINGS["train"]["mfu.train"])
    assert got["mfu.train"]["value"] == pytest.approx(mfu16 * work.TC_FLOPS / work.F32_FLOPS)
