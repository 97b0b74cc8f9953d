"""The float32 GEMM tile (forward and dX) and the float32 weight gradient
(``csrc/gemm_f32.cu``), in what the CPU can check.

The kernels run only on the card (``tests/test_torch_cuda.py -k f32`` holds
them to their plain versions there, every tile to the same bits). Here:

* ``wgrad_f32_plan`` covers M exactly, in whole float32 ring stages, in one
  wave, with its partials under its stated cap, at every training shape of
  tiny-224 and base-384, by default and where the card fits two CTAs an SM;
* the bf16 ``wgrad_plan`` gives the parent's plans at those shapes (the
  float32 planner is its own);
* a float32 mirror of the planned order of sums (each split a chain over
  its rows, the cluster's CTAs in rank order, then the clusters in order;
  db by row groups first) agrees with JAX's ``_wgrad`` and bias sum at
  float32 by the float64 rule;
* mirrors of both kernels' thread-to-output maps cover every output once,
  and their 16-byte shared-memory reads are conflict-free or broadcasts;
* ``gemm_f32_plan`` takes a tile the kernel has, 128 wide in N only where
  128 divides N, its grid covering the output, at every serving and
  training shape;
* the planners' constants are the CUDA source's.
"""

import argparse
import itertools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from cswin_unet_tpu.ops.pallas.cswin_block import _wgrad as jax_wgrad
from cswin_unet_tpu_torch import config as port_config
from cswin_unet_tpu_torch.ops.cuda import kernels as K

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "cswin_unet_tpu_torch" / "ops" / "cuda" / "csrc"
CONFIGS = REPO / "cswin_unet_tpu_torch" / "configs"
TRAIN_BATCH = 24


def _namespace_constants(path: Path, namespace: str) -> dict[str, int]:
    """The ``constexpr int`` literals (and sums and products of earlier
    ones) declared in ``namespace`` of a CUDA source."""
    body = re.search(rf"namespace {namespace} {{(.*?)}}  // namespace {namespace}",
                     path.read_text(), re.S).group(1)
    out = {}
    for decl in re.findall(r"constexpr int ([^;]+);", body):
        for part in decl.split(","):
            m = re.fullmatch(r"\s*(\w+)\s*=\s*([\w\s*+()]+?)\s*", part)
            if m and set(re.findall(r"[A-Za-z_]\w*", m.group(2))) <= set(out):
                out[m.group(1)] = eval(m.group(2), {}, dict(out))
    return out


GEMM_F32 = _namespace_constants(CSRC / "gemm_f32_tile.cuh", "gemm_f32")
WGRAD_F32 = _namespace_constants(CSRC / "gemm_f32.cu", "wgrad_f32")
WGRAD_SUM = _namespace_constants(CSRC / "wgrad_sum.cuh", "wgrad_sum")


def _training_shapes(yaml: str):
    """(M, N, K) of the four weight gradients of every stage of a config at
    the training batch."""
    cfg = port_config.get_config(argparse.Namespace(cfg=str(CONFIGS / yaml), opts=None))
    cs, img = cfg.MODEL.CSWIN, cfg.DATA.IMG_SIZE
    for s in range(4):
        H, C = img // (4 * 2**s), cs.EMBED_DIM * 2**s
        M = TRAIN_BATCH * H * H
        yield from ((M, C, 4 * C), (M, 4 * C, C), (M, C, C), (M, 3 * C, C))


SHAPES = [*_training_shapes("cswin_tiny_224_lite.yaml"),
          *_training_shapes("cswin_base_384.yaml")]


def test_constants_are_the_sources():
    assert (GEMM_F32["STAGES"], GEMM_F32["BK"], GEMM_F32["TN"]) == (
        K._F32_STAGES, K._F32_BK, K._F32_TN)
    assert WGRAD_F32["MS"] == K._WGRAD_F32_ROWS and WGRAD_SUM["MAX_CLUSTER"] == K._WGRAD_CLUSTER
    src = (CSRC / "gemm_f32.cu").read_text()
    # the tiles the C entry takes are the planner's, as (bm, bn)
    aliases = {name: tuple(map(int, t)) for name, *t in re.findall(
        r"using (\w+) = Tile<(\d+), (\d+)>;", src)}
    arms = re.findall(r"if \(bm == (\d+) && bn == (\d+)\) return CSWIN_GEMM_F32_TILE\((\w+)\)",
                      src)
    assert tuple(aliases[name] for *_, name in arms) == K._F32_TILES
    assert all(aliases[name][:2] == (int(bm), int(bn)) for bm, bn, name in arms)
    # the GEMM ring (or the staged output; gemm_f32_tile.cuh, the tile the
    # chain's kernel and the float32 pair share) and the weight gradient's
    # ring, as gemm_f32_smem and the wgrad mirror below size them
    tile = (CSRC / "gemm_f32_tile.cuh").read_text()
    assert re.search(r"float A\[STAGES\]\[BM\]\[S::LDS\];"
                     r"\s*float B\[STAGES\]\[S::BR\]\[S::BC\];\s*\} ring;"
                     r"\s*float C\[BM\]\[S::LDC\];.*?\s*\};\s*float sc\[BM\];", tile, re.S)
    assert re.search(r"LDS = BK \+ 4,\s*LDC = BN \+ TX,"
                     r" BR = KN \? BK : BN, BC = KN \? BN \+ 4 : LDS;", tile)
    assert re.search(r"float D\[STAGES\]\[MS\]\[BN\];\s*float X\[STAGES\]\[MS\]\[BK\];"
                     r"\s*float sc\[STAGES\]\[MS\];", src)


# --- wgrad_f32_plan -----------------------------------------------------------

# The bf16 plans of the parent commit at the training shapes: (M, N, K, chunk,
# splits, cluster, tiles, partial_bytes, bn, bk).
BF16_PLANS = [
    (75264, 64, 256, 1216, 64, 8, 2, 526336, 64, 128),
    (75264, 256, 64, 1216, 64, 8, 2, 532480, 128, 64),
    (75264, 64, 64, 640, 120, 8, 1, 249600, 64, 64),
    (75264, 192, 64, 1920, 40, 8, 3, 249600, 64, 64),
    (18816, 128, 512, 640, 32, 8, 4, 1050624, 128, 128),
    (18816, 512, 128, 640, 32, 8, 4, 1056768, 128, 128),
    (18816, 128, 128, 192, 104, 8, 1, 858624, 128, 128),
    (18816, 384, 128, 512, 40, 8, 3, 990720, 128, 128),
    (4704, 256, 1024, 640, 8, 8, 16, 0, 128, 128),
    (4704, 1024, 256, 640, 8, 8, 16, 0, 128, 128),
    (4704, 256, 256, 320, 16, 8, 4, 526336, 128, 128),
    (4704, 768, 256, 640, 8, 8, 12, 0, 128, 128),
    (1176, 512, 2048, 640, 2, 2, 64, 0, 128, 128),
    (1176, 2048, 512, 640, 2, 2, 64, 0, 128, 128),
    (1176, 512, 512, 192, 8, 8, 16, 0, 128, 128),
    (1176, 1536, 512, 640, 2, 2, 48, 0, 128, 128),
    (221184, 96, 384, 11072, 20, 4, 6, 985600, 64, 128),
    (221184, 384, 96, 11072, 20, 4, 6, 990720, 128, 64),
    (221184, 96, 96, 6912, 32, 8, 4, 264192, 64, 64),
    (221184, 288, 96, 18432, 12, 4, 10, 495360, 64, 64),
    (55296, 192, 768, 7936, 7, 1, 18, 4134144, 64, 128),
    (55296, 768, 192, 7936, 7, 1, 18, 4150272, 128, 64),
    (55296, 192, 192, 3968, 14, 2, 9, 1037568, 64, 64),
    (55296, 576, 192, 13824, 4, 4, 27, 0, 64, 64),
    (13824, 384, 1536, 6912, 2, 2, 36, 0, 128, 128),
    (13824, 1536, 384, 6912, 2, 2, 36, 0, 128, 128),
    (13824, 384, 384, 1152, 12, 4, 9, 1774080, 128, 128),
    (13824, 1152, 384, 3456, 4, 4, 27, 0, 128, 128),
    (3456, 768, 3072, 3456, 1, 1, 144, 0, 128, 128),
    (3456, 3072, 768, 3456, 1, 1, 144, 0, 128, 128),
    (3456, 768, 768, 1728, 2, 2, 36, 0, 128, 128),
    (3456, 2304, 768, 3456, 1, 1, 108, 0, 128, 128),
]


@pytest.mark.parametrize("row", BF16_PLANS, ids=lambda r: f"{r[0]}x{r[1]}x{r[2]}")
def test_bf16_wgrad_plan_is_the_parents(row):
    assert (*row[:3], *K.wgrad_plan(*row[:3])) == row


def _check_f32_plan(p, M, N, K_, wave):
    assert (p.bn, p.bk) == (128 if N % 128 == 0 else 64, 128 if K_ % 128 == 0 else 64)
    assert p.tiles == -(-N // p.bn) * -(-K_ // p.bk)
    assert p.cluster in (1, 2, 4, 8) and p.splits % p.cluster == 0 and p.cluster <= p.bn
    # whole float32 ring stages, as the C entry requires
    assert p.chunk > 0 and p.chunk % K._WGRAD_F32_ROWS == 0
    # the splits' row ranges cover [0, M) exactly, in order; the last cluster
    # holds a non-empty split
    ranges = [(min(M, s * p.chunk), min(M, (s + 1) * p.chunk)) for s in range(p.splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == M
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert (p.splits - p.cluster) * p.chunk < M
    # one wave, unless the tiles alone exceed it (then one split a tile)
    assert p.splits * p.tiles <= max(wave(p.bn, p.bk, p.cluster) * p.cluster, p.tiles)
    assert p.splits == 1 or p.splits * p.tiles <= wave(p.bn, p.bk, p.cluster) * p.cluster
    clusters = p.splits // p.cluster
    tn = -(-N // p.bn)
    want = 4 * clusters * p.bn * (p.tiles * p.bk + tn) if clusters > 1 else 0
    assert p.partial_bytes == want
    assert p.partial_bytes <= 4 * M * (N + K_)  # the stated cap


@pytest.mark.parametrize("ctas_per_sm", [1, 2])
@pytest.mark.parametrize("M,N,K_", SHAPES)
def test_wgrad_f32_plan_covers_m_in_one_wave(M, N, K_, ctas_per_sm):
    wave = lambda bn, bk, cl: ctas_per_sm * 132 // cl
    p = K.wgrad_f32_plan(M, N, K_, wave)
    _check_f32_plan(p, M, N, K_, wave)
    # where the tiles alone fill the card, no split and no sums
    if p.tiles >= ctas_per_sm * 132:
        assert p.splits == 1 and p.partial_bytes == 0


def test_wgrad_f32_plan_small_and_ragged():
    """Shapes off the model's: a few rows, N and K not multiples of 64, a
    card where only 14 clusters of 8 fit at once."""
    fit = lambda bn, bk, cl: {8: 14, 4: 30, 2: 64, 1: 132}[cl]
    for M, N, K_ in ((7, 8, 8), (130, 24, 64), (1001, 96, 64), (4099, 40, 136),
                     (64, 512, 2048), (75264, 2048, 2048)):
        for wave in (fit, lambda bn, bk, cl: 132 // cl):
            _check_f32_plan(K.wgrad_f32_plan(M, N, K_, wave), M, N, K_, wave)


def test_wgrad_f32_plan_takes_fewer_splits_than_the_bf16_one_where_tiles_fill_the_card():
    """The float32 planner weighs the sums against a CTA's FFMA work: at
    base-384's last stage the 144 tiles of fc1 / fc2 each take one CTA."""
    for M, N, K_ in ((3456, 768, 3072), (3456, 3072, 768), (3456, 2304, 768)):
        p = K.wgrad_f32_plan(M, N, K_)
        assert p.splits == 1 and p.chunk >= M


# --- the order of the float32 sums against JAX's _wgrad ----------------------

def _f64_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _wgrad_f32_mirror(x, dy, p):
    """dW and db in the kernel's order, in float32: each split's tile a
    chain over its rows (row m adds dY'[m] ⊗ X[m]); its db by row groups
    (rows g, g + RG, ... of each ring stage, stage after stage, then the
    groups in order); the cluster's splits in rank order from 0, then, with
    several clusters, the clusters' sums in order from 0."""
    M = x.shape[0]
    rg = p.bn * p.bk // 64 // (p.bn // 4)  # the dY pass's row groups, NT / QUADS
    tiles, biases = [], []
    for s in range(p.splits):
        lo, hi = min(M, s * p.chunk), min(M, (s + 1) * p.chunk)
        acc = np.zeros((dy.shape[1], x.shape[1]), np.float32)
        for m in range(lo, hi):
            acc += np.outer(dy[m], x[m]).astype(np.float32)
        groups = np.zeros((rg, dy.shape[1]), np.float32)
        for m0 in range(lo, hi, K._WGRAD_F32_ROWS):
            for r in range(K._WGRAD_F32_ROWS):
                if m0 + r < hi:
                    groups[r % rg] += dy[m0 + r]
        b = np.zeros(dy.shape[1], np.float32)
        for g in range(rg):
            b += groups[g]
        tiles.append(acc)
        biases.append(b)

    def ordered(parts):
        sums = []
        for c in range(p.splits // p.cluster):
            s = np.zeros_like(parts[0])
            for q in range(p.cluster):
                s += parts[c * p.cluster + q]
            sums.append(s)
        if len(sums) == 1:
            return sums[0]
        total = np.zeros_like(sums[0])
        for s in sums:
            total += s
        return total

    return ordered(tiles), ordered(biases)


@pytest.mark.parametrize("M,N,K_", [(4704, 256, 256), (1176, 64, 192), (18816, 64, 64)])
def test_wgrad_f32_order_of_sums_agrees_with_jax(M, N, K_):
    """At shapes whose plan splits M over one cluster (1176 x 64 x 192),
    several clusters through L2 (4704 x 256 x 256 at tiny-224's stage 3),
    and many short chunks (18816 x 64 x 64): within 1e-5 of JAX's float32
    ``_wgrad`` (relative L2), or no more than twice JAX's own error against
    float64."""
    p = K.wgrad_f32_plan(M, N, K_)
    assert p.splits > 1
    rng = np.random.default_rng(M + N)
    x = rng.standard_normal((M, K_)).astype(np.float32)
    dy = rng.standard_normal((M, N)).astype(np.float32)
    dw, db = _wgrad_f32_mirror(x, dy, p)
    want_dw = np.asarray(jax_wgrad(jnp.asarray(dy), jnp.asarray(x)))
    want_db = np.asarray(jnp.sum(jnp.asarray(dy), axis=0))
    for got, want, exact in ((dw, want_dw, dy.T.astype(np.float64) @ x.astype(np.float64)),
                             (db, want_db, dy.astype(np.float64).sum(0))):
        assert got.dtype == np.float32 and got.shape == want.shape
        assert (_f64_rel(got, want) <= 1e-5
                or _f64_rel(got, exact) <= 2 * _f64_rel(want, exact)), p


# --- the thread-to-output maps ------------------------------------------------

@pytest.mark.parametrize("kn", [False, True])
@pytest.mark.parametrize("bm,bn", K._F32_TILES)
def test_gemm_f32_tile_covers_each_output_once(bm, bn, kn):
    """Thread (tx, ty) = (tid % (bn/tn), tid / (bn/tn)) owns rows ty +
    (bm/8)i and columns tx + (bn/tn)j, i < 8, j < tn, or with ``kn`` (B as
    (K, N)) columns tn·tx + j; a quarter-warp's 16-byte reads of B fall in
    distinct banks and of A are one address; the staged output's stores of
    one accumulator (row stride bn + bn/tn) fall in distinct banks across a
    warp, or with ``kn`` a warp's 16-byte stores cover whole rows."""
    tn, bk = K._F32_TN, K._F32_BK
    tx_n, ty_n = bn // tn, bm // 8
    threads = tx_n * ty_n
    col = (lambda t, j: tn * (t % tx_n) + j) if kn else (lambda t, j: t % tx_n + tx_n * j)
    owned = [(tid // tx_n + ty_n * i, col(tid, j))
             for tid in range(threads) for i in range(8) for j in range(tn)]
    assert sorted(owned) == [(r, c) for r in range(bm) for c in range(bn)]
    lds, ldc = bk + 4, bn + tx_n
    for q in range(0, threads, 8):  # quarter-warps
        quarter = range(q, q + 8)
        if kn:  # row kk + e of B's ring, the thread's word of four columns
            assert len({col(t, 0) // 4 % 8 for t in quarter}) == 8
        else:
            for j in range(tn):
                words = {(col(t, j) * lds) // 4 % 8 for t in quarter}
                assert len(words) == 8
        assert len({t // tx_n for t in quarter}) == 1  # A: one row, a broadcast
    for w in range(0, threads, 32):
        if kn:
            words = {((t // tx_n) * ldc + col(t, 0)) // 4 for t in range(w, w + 32)}
            assert len(words) == 32 and ldc % 4 == 0
        else:
            banks = {((t // tx_n) * ldc + col(t, 0)) % 32 for t in range(w, w + 32)}
            assert len(banks) == 32
    # the ring's k-blocks load in whole passes of 16-byte chunks
    assert bm * bk // 4 % threads == 0 and bn * bk // 4 % threads == 0


@pytest.mark.parametrize("bn,bk", [(64, 64), (128, 64), (64, 128), (128, 128)])
def test_wgrad_f32_tile_covers_each_output_once(bn, bk):
    """Thread (tn, tk) = (tid / (bk/8), tid % (bk/8)) owns dW rows 4tn + e
    and bn/2 + 4tn + e, columns 4tk + e and bk/2 + 4tk + e; the dY pass
    takes each (row, 4-column quad) of a ring stage once; the summed tile,
    db and its row-group partials fit the ring."""
    threads, tk_n = bn * bk // 64, bk // 8
    rows = lambda tn: [4 * tn + e for e in range(4)] + [bn // 2 + 4 * tn + e for e in range(4)]
    cols = lambda tk: [4 * tk + e for e in range(4)] + [bk // 2 + 4 * tk + e for e in range(4)]
    owned = [(r, c) for tid in range(threads)
             for r in rows(tid // tk_n) for c in cols(tid % tk_n)]
    assert sorted(owned) == [(r, c) for r in range(bn) for c in range(bk)]
    quads, ms = bn // 4, K._WGRAD_F32_ROWS
    rg = threads // quads
    assert threads % quads == 0 and ms % rg == 0
    passed = [(tid // quads + rg * s, tid % quads) for tid in range(threads)
              for s in range(ms // rg)]
    assert sorted(passed) == [(r, q) for r in range(ms) for q in range(quads)]
    ring = -(-4 * (WGRAD_F32["STAGES"] * ms * (bn + bk + 1)) // 128) * 128
    assert 4 * (bn * (bk + 4) + bn + rg * bn) <= ring <= K.SMEM_LIMIT


# --- gemm_f32_plan --------------------------------------------------------------

def _gemm_shapes():
    """(M, N) of every float32 forward and dX product of both configs, at the
    serving batch (32) and the training batch (24)."""
    for yaml in ("cswin_tiny_224_lite.yaml", "cswin_base_384.yaml"):
        cfg = port_config.get_config(argparse.Namespace(cfg=str(CONFIGS / yaml), opts=None))
        cs, img = cfg.MODEL.CSWIN, cfg.DATA.IMG_SIZE
        for s in range(4):
            H, C = img // (4 * 2**s), cs.EMBED_DIM * 2**s
            for B in (32, 24):
                yield from ((B * H * H, n) for n in (3 * C, C, 4 * C))


def test_gemm_f32_plan_at_every_shape():
    for (M, N), kn in itertools.product(
            [*_gemm_shapes(), (1, 8), (130, 25), (64, 512), (200, 96), (64, 40)], (False, True)):
        p = K.gemm_f32_plan(M, N, kn)
        assert (p.bm, p.bn) in K._F32_TILES and p.kn == kn
        # 32-column tiles only where they waste fewer columns (N = 96: base-384's C)
        assert (p.bn == 32) == (-(-N // 32) * 32 < -(-N // 64) * 64)
        assert p.threads == p.bm * p.bn // (8 * K._F32_TN)
        assert p.ctas == -(-M // p.bm) * -(-N // p.bn)
        assert p.smem_bytes == K.gemm_f32_smem(p.bm, p.bn, kn) <= K.SMEM_LIMIT
    # four 64 x 64 CTAs an SM by shared memory
    assert 4 * (K.gemm_f32_smem(64, 64) + 1024) <= K._SM_SMEM
