"""The float32 attention tile (``attention_tile.cuh::tile_f32``) and the
float32 attention backward (``stripe_attention_bwd.cu``: its row and key
kernels), in what the CPU can check.

The kernels run only on the card (``tests/test_torch_cuda.py -k f32`` holds
them to their plain versions there). Here:

* the planners' constants are the CUDA sources', and both designs' shared
  memory fits two CTAs an SM at every float32 serving and training window
  of tiny-224 and base-384 (base-384's 288-token windows at head dim 24
  among them);
* mirrors of the kernels' thread-to-work maps give every (query, key) pair
  to one lane once and every output to one lane once, the reduce-scatter's
  rounds (the CUDA code's keep / give selects, simulated) summing all eight
  key groups into each output;
* float32 mirrors of both kernels that follow their split and their order of
  sums (one chain over d a score, the lanes' key partials and the warp's
  butterfly, the key groups' tree, the key kernel's rows in order, the
  LePE partials a key block and token parity) agree with JAX's
  ``cswin_attention_xla`` and ``jax.vjp`` of it at float32 within 1e-5, and
  with float64 by the reduction rule (within 1e-5 of JAX's float32, or at
  most twice JAX's error against float64), a 288-token window at d = 24
  included.
"""

import argparse
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cswin_unet_tpu.ops.attention import cswin_attention_xla as jax_attention
from cswin_unet_tpu_torch import config as port_config
from cswin_unet_tpu_torch.ops.cuda import kernels as K
from cswin_unet_tpu_torch.ops.windows import window_merge, window_partition

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "cswin_unet_tpu_torch" / "ops" / "cuda" / "csrc"
CONFIGS = REPO / "cswin_unet_tpu_torch" / "configs"
TOL = 1e-5


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _constants(name: str) -> dict[str, int]:
    """The ``constexpr int`` literals (and sums and products of earlier
    ones) of a CUDA source, by name."""
    out = {}
    for decl in re.findall(r"constexpr int ([^;]+);", (CSRC / name).read_text()):
        for part in decl.split(","):
            m = re.fullmatch(r"\s*(\w+)\s*=\s*([\w\s*+()]+?)\s*", part)
            if m and set(re.findall(r"[A-Za-z_]\w*", m.group(2))) <= set(out):
                out[m.group(1)] = eval(m.group(2), {}, dict(out))
    return out


TILE, BWD = _constants("attention_tile.cuh"), _constants("stripe_attention_bwd.cu")


def test_constants_are_the_sources():
    assert (TILE["WARPS"], TILE["QR"], TILE["SLOTS"]) == (
        K._ATT_WARPS, K._ATT_F32_QR, K._ATT_F32_SLOTS)
    assert (BWD["WARPS"], BWD["ROWS_B"], BWD["ROW_TARGET"], BWD["KEYS"], BWD["KEY_BLOCKS"]) == (
        K._ATT_BWD_WARPS, K._ATT_BWD_F32_ROWS, K._ATT_BWD_F32_ROW_TARGET, K._ATT_BWD_F32_KEYS,
        K._ATT_BWD_F32_KEY_BLOCKS)
    assert BWD["KEYS"] == 32  # a lane a key
    # the score rows are whole 16-byte quads, and the products' lane map
    # (eight key groups, four channel groups) leaves one row a lane (QR = 8)
    # or one row to two lanes (ROWS_B = 4)
    assert TILE["QR"] == 8 and BWD["ROWS_B"] == 4
    src = (CSRC / "attention_tile.cuh").read_text()
    assert re.search(r"2 \* \(size_t\)L \* \(D \+ 4\) \+ 10 \* \(size_t\)D \+\s*"
                     r"\(size_t\)WARPS \* QR \* \(2 \* D \+ 32 \* \(size_t\)key_slots\(L\)\)", src)
    src = (CSRC / "stripe_attention_bwd.cu").read_text()
    assert re.search(r"2 \* \(size_t\)L \* \(D \+ 4\) \+\s*\(size_t\)WARPS \* \(4 \* ROWS_B \* D"
                     r" \+ 2 \* ROWS_B \* 32 \*\s*\(size_t\)attn_tile::key_slots\(L\)\)", src)
    assert re.search(r"2 \* \(size_t\)L \* D \+ 4 \* \(size_t\)L \+ 9 \* D \+\s*"
                     r"\(size_t\)key_blocks_per_cta\(L\) \* KEYS \* D", src)


def _windows(yaml: str):
    """(L, d) of every stripe window of a config's four stages."""
    cfg = port_config.get_config(argparse.Namespace(cfg=str(CONFIGS / yaml), opts=None))
    cs, img = cfg.MODEL.CSWIN, cfg.DATA.IMG_SIZE
    out = set()
    for s in range(4):
        H, C, heads, split = img // (4 * 2**s), cs.EMBED_DIM * 2**s, cs.NUM_HEADS[s], \
            cs.SPLIT_SIZE[s]
        last = s == 3 or H == split
        out.add((H * H, C // heads) if last else (H * split, C // heads))
    return sorted(out)


WINDOWS = {"tiny-224": _windows("cswin_tiny_224_lite.yaml"),
           "base-384": _windows("cswin_base_384.yaml")}


def test_config_windows():
    assert WINDOWS["tiny-224"] == [(49, 32), (56, 32), (98, 32)]
    assert WINDOWS["base-384"] == [(96, 24), (144, 24), (288, 24)]


@pytest.mark.parametrize("cfg", sorted(WINDOWS))
def test_plans_fit_two_ctas_an_sm_at_every_window(cfg):
    """Serving and training run the same windows: the tile, the row kernel
    and the key kernel each within 227 KB and at least two CTAs (eight
    warps) an SM by shared memory."""
    for L, d in WINDOWS[cfg]:
        fwd, bwd = K.attention_f32_plan(L, d), K.stripe_attention_bwd_f32_plan(L, d)
        assert fwd.smem_bytes <= K.SMEM_LIMIT and fwd.ctas_per_sm >= 2, (L, d, fwd)
        for smem, ctas in ((bwd.rows_smem, bwd.rows_ctas_per_sm),
                           (bwd.keys_smem, bwd.keys_ctas_per_sm)):
            assert smem <= K.SMEM_LIMIT and ctas >= 2, (L, d, bwd)
        assert fwd.score_keys == bwd.score_keys == -(-L // 32) * 32
        assert bwd.row_ctas * bwd.row_block >= L and bwd.key_blocks * bwd.keys >= L
        # a quarter-warp's 16-byte reads of eight consecutive k or v rows fall
        # in distinct banks
        assert len({j * fwd.kv_stride % 32 for j in range(8)}) == 8
    if cfg == "base-384":  # stage 3: 24 x 12 = 288 tokens at head dim 24
        fwd, bwd = K.attention_f32_plan(288, 24), K.stripe_attention_bwd_f32_plan(288, 24)
        assert (fwd.smem_bytes, bwd.rows_smem, bwd.keys_smem) == (108480, 107520, 69984)
        assert (fwd.ctas_per_sm, bwd.rows_ctas_per_sm, bwd.keys_ctas_per_sm) == (2, 2, 3)


# --- the thread-to-work maps ------------------------------------------------

def _reduce_scatter(rows: int, D: int) -> dict[int, dict[tuple[int, int], set[int]]]:
    """``attn_tile::products``' reduce-scatter, simulated: per lane, the
    (row, channel) outputs it holds after the three rounds and the key
    groups summed into each (the CUDA code's keep / give selects)."""
    CL = D // 4
    held = {}
    for lane in range(32):
        kg, cg = lane >> 2, lane & 3
        held[lane] = {(r, cg * CL + u): {kg} for r in range(rows) for u in range(CL)}

    def round_(bit: int, split):
        new = {}
        for lane in range(32):
            hi = bool(lane & bit)
            # the partner gives the half it does not keep: the half this lane keeps
            keep, give_other = split(held[lane], hi), split(held[lane ^ bit], hi)
            assert set(keep) == set(give_other)
            new[lane] = {o: keep[o] | give_other[o] for o in keep}
            assert all(not (keep[o] & give_other[o]) for o in keep)  # no group twice
        held.update(new)

    def by_row(h, hi):
        rs = sorted({r for r, _ in h})
        mine = rs[len(rs) // 2:] if hi else rs[:len(rs) // 2]
        return {o: g for o, g in h.items() if o[0] in mine}

    def by_channel(h, hi):
        cs = sorted({c for _, c in h})
        mine = cs[len(cs) // 2:] if hi else cs[:len(cs) // 2]
        return {o: g for o, g in h.items() if o[1] in mine}

    round_(16, by_row)
    round_(8, by_row)
    round_(4, by_row if rows == 8 else by_channel)
    return held


@pytest.mark.parametrize("rows", [8, 4])
@pytest.mark.parametrize("D", [16, 24, 32])
def test_products_give_each_output_to_one_lane_with_every_key_group(rows, D):
    held = _reduce_scatter(rows, D)
    owners = {}
    for lane, outs in held.items():
        for o, groups in outs.items():
            assert groups == set(range(8)), (lane, o)
            assert o not in owners, (o, owners.get(o), lane)
            owners[o] = lane
        # the row and channels the kernels write for the lane
        kg, cg, CL = lane >> 2, lane & 3, D // 4
        if rows == 8:
            want = {(kg, cg * CL + u) for u in range(CL)}
        else:
            want = {(lane >> 3, cg * CL + (kg & 1) * CL // 2 + u) for u in range(CL // 2)}
        assert set(outs) == want, lane
    assert set(owners) == {(r, c) for r in range(rows) for c in range(D)}


def _score_keys(L: int) -> list[list[int]]:
    """Each lane's keys in ``attn_tile::scores``: slots of 32, up to SLOTS
    at once, the remainder in one call of one or two (keys past L scored on
    the clamped row, never used)."""
    ns, m0, slots = -(-L // 32), 0, []
    while m0 + K._ATT_F32_SLOTS <= ns:
        slots.append(list(range(m0, m0 + K._ATT_F32_SLOTS)))
        m0 += K._ATT_F32_SLOTS
    if ns > m0:
        slots.append(list(range(m0, ns)))
    return [[32 * m + lane for call in slots for m in call if 32 * m + lane < L]
            for lane in range(32)]


@pytest.mark.parametrize("L", [16, 30, 49, 56, 96, 98, 144, 288])
def test_tile_scores_and_sums_cover_every_pair_once(L):
    """The tile: every row in one warp's row group once, every key of a row
    scored by one lane once, and P·V's key groups take every key once."""
    plan = K.attention_f32_plan(L, 24)
    groups = -(-L // plan.rows)
    rows = [g * plan.rows + r for w in range(plan.warps) for g in range(w, groups, plan.warps)
            for r in range(plan.rows) if g * plan.rows + r < L]
    assert sorted(rows) == list(range(L))
    keys = _score_keys(L)
    assert sorted(j for lane in keys for j in lane) == list(range(L))
    assert sorted(j for kg in range(8) for j in range(kg, L, 8)) == list(range(L))


@pytest.mark.parametrize("L", [16, 30, 49, 56, 96, 98, 144, 288])
def test_backward_kernels_cover_every_row_and_key_once(L):
    """Row kernel: every query row in one CTA's block, one warp's group;
    key kernel: every key to one lane of one warp's block (each lane walks
    every row); the LePE partials' lanes take every (channel pair, token) of
    a block once."""
    plan = K.stripe_attention_bwd_f32_plan(L, 24)
    R, per_cta = plan.rows, plan.row_block // plan.rows
    # a CTA's rows are whole groups of every warp, the window in near-equal
    # parts of about ROW_TARGET rows; its key blocks at most KEY_BLOCKS
    assert plan.row_block % (R * plan.warps) == 0
    assert plan.row_ctas == -(-L // K._ATT_BWD_F32_ROW_TARGET)
    assert plan.row_block * (plan.row_ctas - 1) < L <= plan.row_block * plan.row_ctas
    assert plan.key_blocks_per_cta <= K._ATT_BWD_F32_KEY_BLOCKS
    assert plan.key_ctas == -(-plan.key_blocks // K._ATT_BWD_F32_KEY_BLOCKS)
    rows = []
    for z in range(plan.row_ctas):
        g_end = min((z + 1) * per_cta, -(-L // R))
        for w in range(plan.warps):
            for g in range(z * per_cta + w, g_end, plan.warps):
                rows += [g * R + r for r in range(R) if g * R + r < L]
    assert sorted(rows) == list(range(L))
    keys = [kb * plan.keys + lane for z in range(plan.key_ctas)
            for kb in range(z * plan.key_blocks_per_cta,
                            min(plan.key_blocks, (z + 1) * plan.key_blocks_per_cta))
            for lane in range(32) if kb * plan.keys + lane < L]
    assert keys == list(range(L))
    for d in (16, 24, 32):
        # the LePE partials: lane (channel pair lane % 16, token parity)
        for kb in range(plan.key_blocks):
            lo, hi = kb * plan.keys, min(L, (kb + 1) * plan.keys)
            taken = [(lane & 15, t) for lane in range(32) if (lane & 15) < d // 2
                     for t in range(lo + (lane >> 4), hi, 2)]
            assert sorted(taken) == sorted((cp, t) for cp in range(d // 2)
                                           for t in range(lo, hi))


# --- float32 mirrors of the kernels' order of sums ---------------------------

def _chain(a, b):
    """(..., R, D) x (..., J, D) -> (..., R, J): one chain over d in order."""
    acc = torch.zeros(*a.shape[:-1], b.shape[-2], dtype=torch.float32)
    for d in range(a.shape[-1]):
        acc = acc + a[..., :, d, None] * b[..., None, :, d]
    return acc


def _lanes(x, lanes: int = 32):
    """(..., L) -> (..., lanes): lane l's sum of x[j], j = l, l + lanes, ...
    in order."""
    acc = torch.zeros(*x.shape[:-1], lanes, dtype=x.dtype)
    for j0 in range(0, x.shape[-1], lanes):
        n = min(lanes, x.shape[-1] - j0)
        acc[..., :n] = acc[..., :n] + x[..., j0:j0 + n]
    return acc


def _tree(x):
    """The xor butterfly over the last axis (2^k lanes), its highest bit
    first: warp_sum over lanes, products' rounds over key groups."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _products(E, B):
    """(..., R, L) x (..., L, D): eight key groups j = kg (mod 8), each a
    chain over its keys in order, then the tree over the groups."""
    acc = torch.zeros(8, *E.shape[:-1], B.shape[-1], dtype=torch.float32)
    for j in range(E.shape[-1]):
        acc[j % 8] = acc[j % 8] + E[..., :, j, None] * B[..., j, None, :]
    return _tree(acc.movedim(0, -1))


def _taps(h_sp: int, w_sp: int):
    """(tap, offsets) in the kernels' order (di, then dj): for each tap the
    neighbour index of every token (-1 outside the window)."""
    L = h_sp * w_sp
    r, c = np.divmod(np.arange(L), w_sp)
    out = []
    for tap in range(9):
        di, dj = tap // 3 - 1, tap % 3 - 1
        rr, cc = r + di, c + dj
        ok = (rr >= 0) & (rr < h_sp) & (cc >= 0) & (cc < w_sp)
        out.append(torch.from_numpy(np.where(ok, rr * w_sp + cc, -1)))
    return out


def _gather(x, idx):
    """x[..., idx, :] with zeros where idx < 0."""
    g = x[..., idx.clamp(min=0), :]
    return torch.where((idx >= 0)[:, None], g, torch.zeros((), dtype=x.dtype))


def _tile_mirror(q, k, v, w9, b, h_sp, w_sp, scale):
    """``attn_tile::tile_f32`` on (N, h, L, D) windows: taps (h, 9, D),
    bias (h, D)."""
    S = _chain(q * scale, k)
    e = torch.exp(S - S.max(-1, keepdim=True).values)
    inv = 1.0 / _tree(_lanes(e))
    conv = torch.zeros_like(v)
    for tap, nb in enumerate(_taps(h_sp, w_sp)):  # conv = fmaf(w, v[nbr], conv) in tap order
        conv = conv + w9[:, tap, None, :] * _gather(v, nb)
    return _products(e, v) * inv[..., None] + (conv + b[:, None, :])


def _bwd_mirror(q, k, v, do, w9, h_sp, w_sp, scale):
    """The row and key kernels on (N, h, L, D) windows: dq, dk, dv, and the
    LePE weight (h, 9, D) and bias (h, D) gradients summed over the (window,
    key block) partials."""
    N, nh, L, D = q.shape
    qs = q * scale
    S, G = _chain(qs, k), _chain(do, v)
    mx = S.max(-1, keepdim=True).values
    e = torch.exp(S - mx)
    inv = (1.0 / _tree(_lanes(e)))[..., None]
    P = e * inv
    dl = _tree(_lanes(G * e))[..., None] * inv  # Σ dP·exp(s - max), then the division
    dS = P * (G - dl)
    dq = _products(dS, k) * scale
    # the key kernel: a score is two chains, over even and odd d, added; P
    # from the rows' statistics; a lane walks every row in order
    S = _chain(qs[..., 0::2], k[..., 0::2]) + _chain(qs[..., 1::2], k[..., 1::2])
    G = _chain(do[..., 0::2], v[..., 0::2]) + _chain(do[..., 1::2], v[..., 1::2])
    P = torch.exp(S - mx) * inv
    dS = P * (G - dl)
    dk = torch.zeros(N, nh, L, D)
    dv = torch.zeros_like(dk)
    for i in range(L):
        dk = dk + dS[..., i, :, None] * qs[..., i, None, :]
        dv = dv + P[..., i, :, None] * do[..., i, None, :]
    taps = _taps(h_sp, w_sp)
    lp = torch.zeros_like(dv)
    for tap, nb in enumerate(taps):  # the transposed conv: dO at the mirrored neighbour
        back = torch.full((L,), -1, dtype=torch.long)
        ok = nb >= 0
        back[nb[ok]] = torch.arange(L)[ok]
        lp = lp + w9[:, tap, None, :] * _gather(do, back)
    dv = dv + lp
    # LePE partials: a key block of KEYS tokens, the tokens of each parity a
    # chain in order, the two added, then the blocks summed
    KB = K._ATT_BWD_F32_KEYS
    parts = []
    for lo in range(0, L, KB):
        hi = min(L, lo + KB)
        acc = torch.zeros(N, nh, 10, D, 2)
        for t in range(lo, hi):
            g = (t - lo) % 2
            for tap, nb in enumerate(taps):  # dW[tap] += dO[t - off(tap)] · V[t]
                src = (nb == t).nonzero()
                if len(src):
                    acc[:, :, tap, :, g] = acc[:, :, tap, :, g] + do[..., int(src[0]), :] * v[..., t, :]
            acc[:, :, 9, :, g] = acc[:, :, 9, :, g] + do[..., t, :]
        parts.append(acc[..., 0] + acc[..., 1])
    lepe = torch.stack(parts).sum((0, 1))  # (h, 10, D)
    return dq, dk, dv, lepe[:, :9], lepe[:, 9]


def _branch(fn, h_sp, w_sp, heads, *tensors):
    """(B, H, W, C) tensors -> (N, heads, L, d) windows for ``fn``."""
    out = []
    for t in tensors:
        w = window_partition(t, h_sp, w_sp)
        N, L, C = w.shape
        out.append(w.reshape(N, L, heads, C // heads).permute(0, 2, 1, 3))
    return fn(*out)


def _unbranch(t, h_sp, w_sp, H, W):
    N, nh, L, d = t.shape
    return window_merge(t.permute(0, 2, 1, 3).reshape(N, L, nh * d), h_sp, w_sp, H, W)


def _rel(a, b) -> float:
    a, b = (np.asarray(x, np.float64) for x in (a, b))
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _reference64(q, k, v, lk, lb, dout, h_sp, w_sp, heads, scale):
    """The branch and its vjp in float64 (torch autograd)."""
    t = [torch.from_numpy(x.astype(np.float64)).requires_grad_() for x in (q, k, v, lk, lb)]
    tq, tk, tv, tw, tb = t
    B, H, W, C = q.shape
    win = lambda x: _branch(lambda y: y, h_sp, w_sp, heads, x)
    qw, kw, vw = win(tq), win(tk), win(tv)
    att = torch.softmax((qw * scale) @ kw.transpose(-1, -2), -1) @ vw
    v_img = window_partition(tv, h_sp, w_sp).reshape(-1, h_sp, w_sp, C).permute(0, 3, 1, 2)
    lepe = F.conv2d(v_img, tw.permute(3, 2, 0, 1), tb, padding=1, groups=C)
    lepe = lepe.permute(0, 2, 3, 1).reshape(-1, h_sp * w_sp, C)
    out = _unbranch(att, h_sp, w_sp, H, W) + window_merge(lepe, h_sp, w_sp, H, W)
    grads = torch.autograd.grad(out, t, torch.from_numpy(dout.astype(np.float64)))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _inputs(seed, B, H, W, C):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.standard_normal((B, H, W, C)).astype(np.float32) for _ in range(4))
    lk = (rng.standard_normal((3, 3, 1, C)) * 0.3).astype(np.float32)  # HWIO
    lb = (rng.standard_normal(C) * 0.1).astype(np.float32)
    return q, k, v, lk, lb, dout


def _mirrors(q, k, v, lk, lb, dout, h_sp, w_sp, heads, scale):
    """The forward and backward mirrors on one branch: out, dq, dk, dv, dlk
    (HWIO), dlb."""
    B, H, W, C = q.shape
    d = C // heads
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    w9 = torch.from_numpy(lk.reshape(9, heads, d).transpose(1, 0, 2).copy())  # (h, 9, d)
    b = torch.from_numpy(lb.reshape(heads, d).copy())
    out = _branch(lambda a, b_, c: _tile_mirror(a, b_, c, w9, b, h_sp, w_sp, scale),
                  h_sp, w_sp, heads, tq, tk, tv)
    dq, dk, dv, dw, db = _branch(
        lambda a, b_, c, e: _bwd_mirror(a, b_, c, e, w9, h_sp, w_sp, scale),
        h_sp, w_sp, heads, tq, tk, tv, tdo)
    un = lambda t: _unbranch(t, h_sp, w_sp, H, W).numpy()
    dlk = dw.permute(1, 0, 2).reshape(3, 3, 1, C).numpy()
    return [un(out), un(dq), un(dk), un(dv), dlk, db.reshape(C).numpy()]


def _jax(q, k, v, lk, lb, dout, h_sp, w_sp, heads, scale):
    kw = dict(h_sp=h_sp, w_sp=w_sp, num_heads=heads, scale=scale)
    out, vjp = jax.vjp(lambda *a: jax_attention(*a, **kw), *map(jnp.asarray, (q, k, v, lk, lb)))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(dout))]


NAMES = ("out", "dq", "dk", "dv", "dlepe_w", "dlepe_b")
# (B, H, W, C, h_sp, w_sp, heads): head dims 16, 24 and 32; windows of 16,
# 30, 49, 56 and 98 tokens (past one key slot and ragged in every map)
CASES = [(2, 8, 8, 32, 8, 2, 2), (1, 6, 10, 48, 3, 10, 2), (1, 7, 7, 32, 7, 7, 1),
         (1, 14, 8, 64, 14, 4, 2), (1, 14, 14, 32, 14, 7, 1)]


@pytest.mark.parametrize("B,H,W,C,hs,ws,heads", CASES)
def test_mirrors_agree_with_jax_at_float32(B, H, W, C, hs, ws, heads):
    x = _inputs(11, B, H, W, C)
    scale = (C // heads) ** -0.5
    got = _mirrors(*x, hs, ws, heads, scale)
    want = _jax(*x, hs, ws, heads, scale)
    out64, grads64 = _reference64(*x[:5], x[5], hs, ws, heads, scale)
    for name, g, w, o in zip(NAMES, got, want, [out64, *grads64]):
        assert g.shape == w.shape, name
        err, err_jax = _rel(g, w), _rel(w, o)
        if name.startswith("dlepe"):  # sums over every window: the reduction rule
            assert err <= TOL or _rel(g, o) <= 2 * err_jax, (name, err, _rel(g, o), err_jax)
        else:
            assert err <= TOL, (name, err)


def test_mirrors_at_a_288_token_window_against_float64():
    """Base-384's stage-3 window (24 x 12 tokens) at head dim 24: every
    output within 1e-5 of JAX's float32, and by the reduction rule against
    float64."""
    x = _inputs(12, 1, 24, 12, 24)
    scale = 24 ** -0.5
    got = _mirrors(*x, 24, 12, 1, scale)
    want = _jax(*x, 24, 12, 1, scale)
    out64, grads64 = _reference64(*x[:5], x[5], 24, 12, 1, scale)
    for name, g, w, o in zip(NAMES, got, want, [out64, *grads64]):
        err, err_jax, err64 = _rel(g, w), _rel(w, o), _rel(g, o)
        assert err <= TOL or err64 <= 2 * err_jax, (name, err, err64, err_jax)
        assert err64 <= max(2 * err_jax, TOL), (name, err64, err_jax)
