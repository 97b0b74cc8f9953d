"""The tile plans of the block lab's two persistent kernels, ``lepe_windows``
and ``ln_mlp``, on the CPU: their Python mirrors (``ops/cuda/kernels.py``)
against the constants of the CUDA sources, the shared memory they ask for
at every lab shape, the persistent walks covering every output once, the
multiply-and-shift division of ``lepe_windows.cu``, the repack of fc1's
accumulators as fc2's operand in ``ln_mlp.cu``, and the refusals a wrapper
makes before it reaches a card. ``tests/test_torch_cuda.py`` holds each
plan to what the kernel reports on the card."""

import collections
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cswin_unet_tpu_torch.ops.cuda import kernels as K
from cswin_unet_tpu_torch.tools import block_lab

CSRC = Path(K.__file__).resolve().parent / "csrc"


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _constants(name: str) -> dict[str, int]:
    """The ``constexpr int`` values of a CUDA source, by name."""
    text = (CSRC / name).read_text()
    out = {}
    for decl in re.findall(r"constexpr int ([^;]+);", text):
        for part in decl.split(","):
            m = re.fullmatch(r"\s*(\w+)\s*=\s*([\w\s*+]+?)\s*", part)
            if m:
                out[m.group(1)] = eval(m.group(2), {}, dict(out))  # literals and earlier names
    return out


def test_mirrors_match_the_sources():
    lepe = _constants("lepe_windows.cu")
    assert (K._LEPE_THREADS, K._LEPE_CH, K._LEPE_SEG, K._LEPE_STAGES, K._LEPE_MAX_NB,
            K._LEPE_TILE_BYTES) == (lepe["THREADS"], lepe["CH"], lepe["SEG"], lepe["STAGES"],
                                    lepe["MAX_NB"], lepe["TILE_BYTES"])
    mlp = _constants("ln_mlp.cu")
    assert (K._MLP_C, K._MLP_HIDDEN, K._MLP_ROWS, K._MLP_WARPS, K._MLP_STAGES) == (
        mlp["C"], mlp["HID"], mlp["BM"], mlp["WARPS"], mlp["STAGES"])
    assert mlp["LDX"] == K._MLP_C + 8 and mlp["BM"] == 64 * mlp["WG"] == 16 * mlp["WARPS"]
    assert _constants("persistent.cuh")["SMEM_MAX"] == K.SMEM_MAX
    # a thread's slot is fixed over a tile: a pixel's threads divide the CTA
    assert K._LEPE_THREADS % 32 == 0 and lepe["VEC"] % K._LEPE_CH == 0


def _lab_geometries():
    """(label, windows, sp_h, sp_w, c, fold) of every ``lepe_windows`` shape
    the lab runs at B = 128, and of base-384's branches (block_lab's rows
    31-34): both branches stacked on the batch, and two sources stacked on
    channels with and without the fold."""
    for st in block_lab.STAGES:
        sp_h, sp_w, c, _, per_image = block_lab.branch_geometry(st)
        n = 128 * per_image
        yield f"s{st}", 2 * n, sp_h, sp_w, c, False
        if not block_lab.STAGES[st]["last"]:
            yield f"s{st} stacked", n, sp_h, sp_w, 2 * c, False
            yield f"s{st} stacked fold", n, sp_h, sp_w, 2 * c, True


@pytest.mark.parametrize("label,windows,sp_h,sp_w,c,fold", list(_lab_geometries()))
def test_lepe_windows_fits_every_lab_shape(label, windows, sp_h, sp_w, c, fold):
    plan = K.lepe_windows_plan(windows, sp_h, sp_w, c, sp_h, sp_w, fold)
    assert plan.smem_bytes <= K.SMEM_MAX
    assert plan.group >= 1 and plan.nb * plan.blocks * 8 == (c // 2 if fold else c)
    assert plan.slots == (2 if fold else 1) * plan.nb
    # a window's chunks fit the tile's aim unless one chunk alone is larger
    per_window = sp_h * sp_w * plan.slots * 16
    assert per_window <= K._LEPE_TILE_BYTES or plan.nb == 1


def test_ln_mlp_fits():
    plan = K.ln_mlp_plan(128 * 56 * 56)
    assert plan.smem_bytes == K.ln_mlp_smem() <= K.SMEM_MAX
    # both weight matrices, the ring and the normalised tile
    assert plan.smem_bytes >= 2 * 2 * 64 * 256 + 3 * plan.rows_per_tile * 64 * 2
    assert (plan.tiles, plan.grid) == (-(-128 * 56 * 56 // plan.rows_per_tile), 132)


@pytest.mark.parametrize("B,H,W,c,sp_h,sp_w,fold", [
    (3, 7, 14, 128, 7, 14, False), (5, 2, 56, 64, 2, 28, True), (9, 1, 56, 32, 1, 56, False),
    (2, 14, 14, 512, 7, 7, False), (4, 10, 15, 24, 5, 3, False), (3, 12, 24, 96, 12, 24, True),
    (7, 1, 96, 48, 1, 96, False)])
@pytest.mark.parametrize("ctas_per_sm,sms", [(2, 1), (1, 3), (2, 132)])
def test_lepe_windows_walk_covers_every_output_once(B, H, W, c, sp_h, sp_w, fold, ctas_per_sm,
                                                    sms):
    """The Python mirror of the kernel's scheduler: over the grid's CTAs,
    every (window, row, column, output chunk) is stored exactly once, and
    every tile stages exactly the pixels and chunks its outputs read."""
    plan = K.lepe_windows_plan(B, H, W, c, sp_h, sp_w, fold, ctas_per_sm, sms)
    windows, px = B * (H // sp_h) * (W // sp_w), sp_h * sp_w
    out_chunks = (c // 2 if fold else c) // 8
    stored = collections.Counter(
        o for cta in range(plan.grid)
        for o in K.lepe_windows_outputs(plan, windows, sp_h, sp_w, cta))
    assert set(stored.values()) == {1}
    assert len(stored) == windows * px * out_chunks * 8 // K._LEPE_CH
    # a pixel's threads sit in one warp, where the fold's shuffles pair them
    assert plan.slots * 8 // K._LEPE_CH <= 32
    half = out_chunks if fold else 0
    staged = collections.Counter()
    for t in range(plan.tiles):
        copies = list(K.lepe_windows_staged(plan, windows, px, half, t))
        wg, kb = divmod(t, plan.blocks)
        chunks = [kb * plan.nb + s for s in range(plan.nb)]
        chunks += [half + k for k in chunks] if fold else []
        wins = range(wg * plan.group, min(windows, (wg + 1) * plan.group))
        assert sorted(copies) == sorted((w, p, k) for w in wins for p in range(px)
                                        for k in chunks)
        staged.update(copies)
    assert set(staged.values()) == {1} and len(staged) == windows * px * c // 8


@pytest.mark.parametrize("rows", [1, 191, 192, 193, 192 * 133 + 5, 128 * 56 * 56])
def test_ln_mlp_walk_covers_every_row_once(rows):
    plan = K.ln_mlp_plan(rows)
    got = [r for cta in range(plan.grid) for r in K.ln_mlp_rows(plan, rows, cta)]
    assert sorted(got) == list(range(rows))
    assert plan.grid == min(plan.tiles, 132)


def test_div_magic():
    """``lepe_windows.cu``'s division by a multiply and a shift is exact for
    every divisor it takes and every dividend below 2^31."""
    rng = np.random.default_rng(0)
    divisors = list(range(1, 300)) + [1000, 3136, 2**16 + 1, 2**20 + 3, 2**30 + 1, 2**31 - 1]
    for d in divisors:
        m, l = K.div_magic(d)
        assert 0 < m <= 2**32 - 1
        ns = [0, 1, d - 1, d, d + 1, 2 * d - 1, 2**31 - 1, 2**31 - 2]
        ns += rng.integers(0, 2**31, 64).tolist()
        for n in ns:
            assert ((n * m >> 32) + n) >> l == n // d, (d, n)


def test_repack_of_accumulators_is_the_fc2_operand():
    """fc1's float32 accumulators, four n8 C tiles of a 16-row strip, repacked
    in registers as two k16 A fragments of fc2 (``repack_c_to_a``): the
    product of those fragments with fc2's B fragments, summed as
    mma.m16n8k16 sums them, is ``h @ w.T`` exactly on integer values."""
    rng = np.random.default_rng(1)
    h = rng.integers(-8, 9, (16, 32)).astype(np.float32)   # the activated hidden chunk
    w = rng.integers(-8, 9, (64, 32)).astype(np.float32)   # fc2_w's columns of the chunk
    c_tiles = np.empty((32, 4, 4), np.float32)
    for lane in range(32):
        for j in range(4):
            for e, (r, col) in enumerate(K.mma_fragment("c", lane)):
                c_tiles[lane, j, e] = h[r, 8 * j + col]
    a = K.repack_c_to_a(c_tiles)  # (lanes, 2 k16 steps, 8 values)
    out = np.zeros((16, 64), np.float32)
    for n8 in range(8):
        d = np.zeros((32, 4), np.float32)
        for kk in range(2):
            A = np.zeros((16, 16), np.float32)
            Bm = np.zeros((16, 8), np.float32)
            for lane in range(32):
                for i, (r, k) in enumerate(K.mma_fragment("a", lane)):
                    A[r, k] = a[lane, kk, i]
                for i, (k, n) in enumerate(K.mma_fragment("b", lane)):
                    Bm[k, n] = w[8 * n8 + n, 16 * kk + k]
            prod = A @ Bm
            for lane in range(32):
                for e, (r, n) in enumerate(K.mma_fragment("c", lane)):
                    d[lane, e] += prod[r, n]
        for lane in range(32):
            for e, (r, n) in enumerate(K.mma_fragment("c", lane)):
                out[r, 8 * n8 + n] = d[lane, e]
    np.testing.assert_array_equal(out, h @ w.T)
    # every position of each fragment is held by exactly one lane and value
    for kind, shape in (("a", (16, 16)), ("b", (16, 8)), ("c", (16, 8))):
        cover = collections.Counter(rc for lane in range(32) for rc in K.mma_fragment(kind, lane))
        assert len(cover) == shape[0] * shape[1] and set(cover.values()) == {1}


@pytest.mark.parametrize("kw", [
    dict(B=0, H=7, W=14, c=128, sp_h=7, sp_w=14), dict(B=1, H=7, W=14, c=128, sp_h=2, sp_w=14),
    dict(B=1, H=7, W=14, c=12, sp_h=7, sp_w=14), dict(B=1, H=7, W=14, c=0, sp_h=7, sp_w=14),
    dict(B=1, H=7, W=14, c=24, sp_h=7, sp_w=14, fold=True),
    dict(B=1, H=64, W=64, c=16, sp_h=64, sp_w=64, fold=True),
    dict(B=2**16, H=256, W=256, c=8, sp_h=1, sp_w=256)])
def test_lepe_windows_plan_refuses(kw):
    """Windows that do not tile the image, channels that are no multiple of
    8 (16 with the fold), no windows, a window whose chunk pair does not fit
    two ring stages, more pixels than one launch takes."""
    with pytest.raises(ValueError):
        K.lepe_windows_plan(**kw)


def test_ln_mlp_plan_refuses():
    for kw in (dict(rows=8, C=128, hidden=512), dict(rows=8, C=64, hidden=128),
               dict(rows=0), dict(rows=2**31)):
        with pytest.raises(ValueError):
            K.ln_mlp_plan(**kw)


def test_wrappers_refuse_before_the_device():
    """What the wrappers refuse on any device, without a card."""
    x = torch.zeros(4, 64, dtype=torch.bfloat16)
    w1, w2 = torch.zeros(256, 64), torch.zeros(64, 256)
    with pytest.raises(ValueError, match="activation"):
        K.ln_mlp(x, None, None, w1, None, w2, None, act="tanh", ln=False)
    with pytest.raises(ValueError, match="norm_w"):
        K.ln_mlp(x, None, None, w1, None, w2, None)
    with pytest.raises(ValueError, match="fc2_w"):
        K.ln_mlp(x, None, None, w1, None, ln=False)
    v, taps = torch.zeros(2, 98, 16, dtype=torch.bfloat16), torch.zeros(3, 3, 16)
    with pytest.raises(ValueError, match="together"):
        K.lepe_windows(v, taps, None, sp_h=7, sp_w=14, taps2=taps)
    with pytest.raises(ValueError, match="tap_dtype"):
        K.lepe_windows(v, taps, None, sp_h=7, sp_w=14, tap_dtype=torch.float16)
    with pytest.raises(ValueError, match="unsupported device"):
        K.lepe_windows(v.to("meta"), taps, None, sp_h=7, sp_w=14)


@pytest.mark.parametrize("fold", [False, True])
def test_cpu_route_is_the_plain_version(fold):
    """On the CPU the wrappers run their plain versions, launch nothing, and
    take shapes the kernels' plans refuse (the plain version has no tile)."""
    rng = np.random.default_rng(2)
    v = torch.from_numpy(rng.standard_normal((3, 5, 3, 32)).astype(np.float32)).bfloat16()
    taps = torch.from_numpy(rng.standard_normal((3, 3, 32)).astype(np.float32))
    before = K.lepe_windows.launches
    kw = dict(sp_h=5, sp_w=3, fold=fold)
    assert torch.equal(K.lepe_windows(v, taps, None, **kw),
                       K.lepe_windows_plain(v, taps, None, **kw))
    x = torch.from_numpy(rng.standard_normal((5, 32)).astype(np.float32)).bfloat16()
    w1 = torch.from_numpy(rng.standard_normal((128, 32)).astype(np.float32) * 0.2)
    w2 = torch.from_numpy(rng.standard_normal((32, 128)).astype(np.float32) * 0.1)
    with pytest.raises(ValueError):
        K.ln_mlp_plan(5, 32, 128)
    got = K.ln_mlp(x, None, None, w1, None, None if fold else w2, None, ln=False, fold=fold)
    assert torch.equal(got, K.ln_mlp_plain(x, None, None, w1, None, None if fold else w2,
                                           None, ln=False, fold=fold))
    assert K.lepe_windows.launches == before


@pytest.mark.parametrize("act,ln,fold", [("gelu", True, False), ("clamp", True, False),
                                         ("gelu", False, False), ("gelu", False, True),
                                         ("clamp", False, True)])
def test_mlp_chain_computes_ln_mlps_function(act, ln, fold):
    """The yardstick ``chip_smoke.py`` times beside each ``ln_mlp`` mode, the
    port's unfused launches (``block_lab.mlp_chain``), computes the mode's
    function: within the lab's tolerance of ``ln_mlp_plain``."""
    inp = block_lab.Inputs(torch.device("cpu"))
    x = inp.bf16(2, 8, 8, 64)
    case = block_lab.mlp_case("mode", x, block_lab.stage1_params(inp, 64), act, ln, fold)
    a = case.args
    got = block_lab.mlp_chain(a["x"], a["weights"], a["act"], a["ln"], a["fold"])
    assert got.shape == x.shape
    assert block_lab.rel_l2(got.float(), case.plain().float()) <= block_lab.TOL
