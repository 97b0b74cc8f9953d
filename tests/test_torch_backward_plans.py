"""The block backward's two redesigned kernels, in what the CPU can check.

* ``stripe_attention_bwd_plain`` (the function the CUDA kernel is held to
  on the card) against ``jax.vjp`` of the JAX package's
  ``cswin_attention_xla`` at base-384's 288-token windows (24x12 and 12x24,
  head dim 24), float32, rtol = atol = 1e-4 (the frameworks sum in
  different orders, on O(1) values).
* The launch planners in Python: ``wgrad_plan`` (how the weight gradient
  cuts M into one wave of CTAs, and the partial bytes it writes),
  ``layernorm_bwd_plan`` (the LayerNorm backward's one wave, whose CTAs
  stride over the rows) and ``stripe_attention_bwd_smem`` (the attention
  backward's shared memory, mirrored from the kernel source and checked
  against it on the card by ``tests/test_torch_cuda.py``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cswin_unet_tpu.ops.attention import cswin_attention_xla as jax_attention
from cswin_unet_tpu_torch import config as port_config
from cswin_unet_tpu_torch.ops.cuda import kernels as K

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_BATCH = 24


@pytest.mark.parametrize("branch", [0, 1])
def test_plain_attention_bwd_matches_jax_vjp_at_base384_windows(branch):
    B, H, W, cb, heads = 1, 24, 24, 48, 2          # head dim 24, as base-384
    C = 2 * cb
    h_sp, w_sp = ((H, 12), (12, W))[branch]         # 24x12 and 12x24: L = 288
    off = branch * cb
    scale = (cb // heads) ** -0.5
    rng = np.random.default_rng(30 + branch)
    qkv = rng.standard_normal((B, H, W, 3 * C)).astype(np.float32)
    dout = rng.standard_normal((B, H, W, C)).astype(np.float32)
    lk = (rng.standard_normal((3, 3, 1, cb)) * 0.3).astype(np.float32)  # HWIO
    lb = (rng.standard_normal(cb) * 0.1).astype(np.float32)
    q, k, v = (qkv[..., i * C + off:i * C + off + cb] for i in range(3))

    def branch_fn(q_, k_, v_, lk_, lb_):
        return jax_attention(q_, k_, v_, lk_, lb_, h_sp=h_sp, w_sp=w_sp,
                             num_heads=heads, scale=scale)

    _, vjp = jax.vjp(branch_fn, *map(jnp.asarray, (q, k, v, lk, lb)))
    dq, dk, dv, dlk, dlb = (np.asarray(g) for g in vjp(jnp.asarray(dout[..., off:off + cb])))

    dqkv = torch.zeros(B, H, W, 3 * C)
    lw = torch.from_numpy(np.ascontiguousarray(lk.transpose(3, 2, 0, 1)))
    dw, db = K.stripe_attention_bwd_plain(
        torch.from_numpy(qkv), torch.from_numpy(dout), lw, dqkv, ch_off=off,
        heads=heads, h_sp=h_sp, w_sp=w_sp, scale=scale)
    for i, want in enumerate((dq, dk, dv)):
        got = dqkv[..., i * C + off:i * C + off + cb].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dw.numpy(), dlk.transpose(3, 2, 0, 1), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(db.numpy(), dlb, rtol=1e-4, atol=1e-4)
    # the other branch's channels are left alone
    rest = torch.ones(3 * C, dtype=torch.bool)
    for i in range(3):
        rest[i * C + off:i * C + off + cb] = False
    assert not dqkv[..., rest].any()


def _geometries(yaml: str):
    """(H, C, heads, split, last) of each stage of a config."""
    import argparse

    args = argparse.Namespace(cfg=os.path.join(REPO, "cswin_unet_tpu_torch", "configs", yaml),
                              opts=None)
    cfg = port_config.get_config(args)
    cs, img = cfg.MODEL.CSWIN, cfg.DATA.IMG_SIZE
    for s in range(4):
        H = img // (4 * 2**s)
        yield H, cs.EMBED_DIM * 2**s, cs.NUM_HEADS[s], cs.SPLIT_SIZE[s], \
            s == 3 or H == cs.SPLIT_SIZE[s]


def _wgrad_shapes(min_reso: int = 0):
    """(M, N, K) of the four weight gradients of each dual-branch stage of
    tiny-224 at resolution >= ``min_reso`` at the training batch (stages
    1-3)."""
    for H, C, _, _, last in _geometries("cswin_tiny_224_lite.yaml"):
        if not last and H >= min_reso:
            M = TRAIN_BATCH * H * H
            yield from ((M, C, 4 * C), (M, 4 * C, C), (M, C, C), (M, 3 * C, C))


@pytest.mark.parametrize("M,N,K_", [*_wgrad_shapes(), (1001, 96, 64), (64, 512, 2048),
                                    (130, 24, 64), (7, 8, 8), (75264, 2048, 2048),
                                    (4099, 40, 136)])
def test_wgrad_plan_covers_m_in_one_wave(M, N, K_):
    p = K.wgrad_plan(M, N, K_)
    # 128-wide tiles where they divide N or K, so fewer tiles re-read the
    # narrow operand
    assert (p.bn, p.bk) == (128 if N % 128 == 0 else 64, 128 if K_ % 128 == 0 else 64)
    assert p.tiles == -(-N // p.bn) * -(-K_ // p.bk)
    assert p.cluster in (1, 2, 4, 8) and p.splits % p.cluster == 0
    assert p.chunk % 64 == 0 and p.chunk > 0
    # the splits' row ranges cover [0, M) exactly, in order, and the last
    # cluster holds at least one non-empty split
    ranges = [(min(M, s * p.chunk), min(M, (s + 1) * p.chunk)) for s in range(p.splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == M
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert (p.splits - p.cluster) * p.chunk < M
    # one wave when the tiles leave room for splits; else one split a tile
    assert p.splits * p.tiles <= max(132, p.tiles)
    clusters = p.splits // p.cluster
    want = (4 * clusters * p.bn * (p.tiles * p.bk + -(-N // p.bn))) if clusters > 1 else 0
    assert p.partial_bytes == want
    assert 8 * p.partial_bytes <= 2 * M * (N + K_)


@pytest.mark.parametrize("M,N,K_", list(_wgrad_shapes()))
def test_wgrad_partials_stay_under_a_quarter_of_the_operands(M, N, K_):
    p = K.wgrad_plan(M, N, K_)
    assert p.partial_bytes <= 0.25 * 2 * M * (N + K_)


@pytest.mark.parametrize("M,N,K_", list(_wgrad_shapes(min_reso=28)))
def test_wgrad_wave_fills_the_card_at_the_trained_stages(M, N, K_):
    p = K.wgrad_plan(M, N, K_)
    assert 0.75 * 132 <= p.splits * p.tiles <= 132
    # where only 14 clusters of 8 fit at once (the occupancy API's answer
    # on a card whose smaller GPCs hold one), the wave shrinks to fit
    fit = lambda bn, bk, cl: {8: 14, 4: 30, 2: 64, 1: 132}[cl]
    q = K.wgrad_plan(M, N, K_, fit)
    assert q.splits * q.tiles <= fit(q.bn, q.bk, q.cluster) * q.cluster


def _attention_windows():
    """(yaml, L, d) of every stripe branch (and last-stage window) of
    tiny-224 and base-384."""
    for yaml in ("cswin_tiny_224_lite.yaml", "cswin_base_384.yaml"):
        for H, C, heads, split, last in _geometries(yaml):
            d = C // heads
            for hs, ws in ([(H, H)] if last else [(H, split), (split, H)]):
                yield yaml, hs * ws, d


@pytest.mark.parametrize("yaml,L,d", sorted(set(_attention_windows())))
def test_attention_bwd_smem_fits_every_geometry(yaml, L, d):
    """The whole-window kernel takes the windows of up to one key block and
    fits them; it takes no longer one (0 bytes: the split route's)."""
    smem = K.stripe_attention_bwd_smem(L, d)
    assert (smem > 0) == (L <= 64)
    assert smem <= K.SMEM_LIMIT


@pytest.mark.parametrize("d", [24, 32])
def test_attention_bwd_smem_takes_base384_windows(d):
    """base-384's windows (96, 144, 288 tokens) are longer than one key
    block: the whole-window kernel takes none of them (0 bytes) and the
    split route takes each. Its own parts at one key block: four staged
    bf16 tiles, the P_b and dS_b tiles, four warps' two 16-row output
    tiles, the taps."""
    windows = {(L, dd) for _, L, dd in _attention_windows()}
    assert (24 * 12, 24) in windows
    for L in sorted({L for L, dd in windows if dd == 24}):
        assert K.stripe_attention_bwd_smem(L, d) == 0
        assert K.stripe_attention_bwd_plan(L, d).split
    stride = 40
    fixed = 4 * 2 * 16 * stride * 2 + 9 * d * 4
    assert K.stripe_attention_bwd_smem(64, d) == 4 * 64 * stride * 2 + 2 * 64 * 72 * 2 + fixed
    assert K.stripe_attention_bwd_smem(65, d) == K.stripe_attention_bwd_smem(304, d) == 0


def _ln_bwd_shapes():
    """(rows, C) of the block backward's LayerNorms at the training batch:
    every stage of tiny-224 and base-384 (the last stages' blocks train
    through ``CSWinBlockFn`` too)."""
    for yaml in ("cswin_tiny_224_lite.yaml", "cswin_base_384.yaml"):
        for H, C, _, _, _ in _geometries(yaml):
            yield TRAIN_BATCH * H * H, C


@pytest.mark.parametrize("rows,C,ctas_per_sm", [
    *((r, c, 2) for r, c in sorted(set(_ln_bwd_shapes()))),
    (1, 64, 2), (63, 64, 2), (65, 128, 2), (200, 512, 1), (1000, 96, 3), (333, 32, 4),
    (75264, 480, 1)])
def test_layernorm_bwd_plan_covers_every_row_once(rows, C, ctas_per_sm):
    p = K.layernorm_bwd_plan(rows, C, ctas_per_sm)
    # 16-byte vectors: a row's C / 8 of them over the fewest lanes, a power
    # of two from 4 to 32, that take them in one go or two (C = 64: 8 lanes,
    # a warp takes 4 rows at once)
    assert p.lanes in (4, 8, 16, 32) and p.rows_per_step == 256 // p.lanes
    assert p.lanes >= min(C // 8, 32) and (p.lanes == 4 or p.lanes < 2 * min(C // 8, 32))
    if C == 64:
        assert (p.lanes, p.rows_per_step) == (8, 32)
    # one wave, never more CTAs than steps of rows
    assert 1 <= p.grid <= min(132 * ctas_per_sm, -(-rows // p.rows_per_step))
    assert p.groups == -(-p.grid // 16)
    taken = [K.layernorm_bwd_rows(p, rows, cta) for cta in range(p.grid)]
    assert all(taken), "a CTA without rows"
    flat = sorted(r for t in taken for r in t)
    assert flat == list(range(rows))


# ---- the bf16 attention backward's split route ------------------------------

BWD_SRC = os.path.join(REPO, "cswin_unet_tpu_torch", "ops", "cuda", "csrc",
                       "stripe_attention_bwd.cu")


@pytest.mark.parametrize("yaml,L,d", sorted(set(_attention_windows())))
def test_attention_bwd_split_plan_fits_every_geometry(yaml, L, d):
    """Windows longer than one key block take the row and key kernels, each
    in shared memory that leaves room for three CTAs an SM or more; the
    rest keep the whole-window kernel."""
    p = K.stripe_attention_bwd_plan(L, d)
    assert p.split == (L > 64)
    assert p.whole_smem == K.stripe_attention_bwd_smem(L, d)
    if not p.split:
        return
    assert max(p.rows_smem, p.keys_smem) <= K.SMEM_LIMIT
    assert p.rows_ctas_per_sm >= 3 and p.keys_ctas_per_sm >= 3
    # the row CTAs cover the window's rows once, in whole 8-row groups of
    # every warp; the key CTAs its 16-key tiles, a warp a tile
    assert p.row_block % (8 * K._ATT_BWD_WARPS) == 0
    assert (p.row_ctas - 1) * p.row_block < L <= p.row_ctas * p.row_block
    assert p.key_tiles == -(-L // 16) and 1 <= p.key_tiles_per_cta <= 6
    assert (p.key_ctas - 1) * p.key_tiles_per_cta < p.key_tiles <= p.key_ctas * p.key_tiles_per_cta


def test_attention_bwd_split_plan_at_base384_stage3():
    """L = 288, d = 24: k and v of the window (46,080 B) and four warps' dQ
    tiles in the row kernel, four CTAs an SM; q·scale and dO (46,080 B),
    the statistics, the taps and six warps' output tiles in the key kernel,
    three CTAs an SM; three CTAs of each a (window, head)."""
    p = K.stripe_attention_bwd_plan(288, 24)
    assert (p.row_block, p.row_ctas, p.key_tiles_per_cta, p.key_ctas) == (96, 3, 6, 3)
    assert p.rows_smem == 2 * 288 * 40 * 2 + 4 * 8 * 40 * 2 == 48640
    assert p.keys_smem == 2 * 288 * 40 * 2 + 3 * 288 * 4 + 9 * 24 * 4 + 6 * 16 * 40 * 2
    assert (p.rows_ctas_per_sm, p.keys_ctas_per_sm) == (4, 3)
    # the whole-window kernel takes no such window
    assert p.whole_smem == 0


def _source_constants() -> dict[str, int]:
    import re

    text = open(BWD_SRC).read()
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}


def test_attention_bwd_split_constants_are_the_source():
    c = _source_constants()
    assert (c["RG"], c["ROW_PART_TARGET"], c["KEY_TILE"], c["KEY_PART_TILES"],
            c["SPLIT_TILES"]) == (K._ATT_BWD_SPLIT_RG, K._ATT_BWD_SPLIT_ROW_TARGET,
                                  K._ATT_BWD_SPLIT_KEY_TILE, K._ATT_BWD_SPLIT_KEY_TILES,
                                  K._ATT_BWD_SPLIT_TILES)
    assert c["WARPS"] == K._ATT_BWD_WARPS and c["KT"] * 8 == K._ATT_BWD_KEYS


def _global_names() -> list[str]:
    import re

    text = open(BWD_SRC).read()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                      text, re.S)


@pytest.mark.parametrize("d", [16, 24, 32])
@pytest.mark.parametrize("form", ["demangled", "mangled"])
def test_attention_bwd_kernel_names_are_the_traces(d, form):
    """Every bf16 ``__global__`` of the backward (the whole window,
    ``<D>``; the split's row and key kernels, ``<D, 1>`` and ``<D, 2>``)
    reads as the attention family (``attention_roofline``) and as one of
    the program's kernels (``Trace.tallied``, ``device_busy_ms``); the
    float32 instance's two kernels as the program's, outside the family."""
    from cswin_unet_tpu_torch.utils.profiling import KERNEL_SYMBOLS
    from port_bench import trace

    names = _global_names()
    assert names.count("stripe_attention_bwd_kernel") == 2
    assert set(names) == {"stripe_attention_bwd_kernel", "stripe_attention_bwd_f32_rows_kernel",
                          "stripe_attention_bwd_f32_keys_kernel"}
    bf16_args = "PK13__nv_bfloat16S2_S2_PS0_Pfiiiiiiif"
    instances = [("stripe_attention_bwd_kernel", (d,), bf16_args),
                 ("stripe_attention_bwd_kernel", (d, 1), "NS_7BwdArgsE"),
                 ("stripe_attention_bwd_kernel", (d, 2), "NS_7BwdArgsE"),
                 ("stripe_attention_bwd_f32_rows_kernel", (d,), "PKfS1_PfP6float4iiiiiiif"),
                 ("stripe_attention_bwd_f32_keys_kernel", (d,), "PKfS1_S1_PfS2_PK6float4iiiiiiiif")]
    for name, targs, margs in instances:
        if form == "demangled":
            symbol = (f"void (anonymous namespace)::{name}<{', '.join(map(str, targs))}>"
                      "(__nv_bfloat16 const*)")
        else:
            ilist = "".join(f"Li{t}E" for t in targs)
            symbol = f"_ZN12_GLOBAL__N_1{len(name)}{name}I{ilist}EEv{margs}"
        assert trace.PORT_KERNELS.search(symbol), symbol
        assert KERNEL_SYMBOLS.search(symbol), symbol
        assert bool(trace.FAMILY_KERNELS["attention"].search(symbol)) == ("f32" not in name)
