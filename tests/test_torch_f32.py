"""Serving at ``TPU.COMPUTE_DTYPE: float32``, on the CPU.

The float32 instances of the serving path's kernels run only on the card
(``tests/test_torch_cuda.py -k f32`` holds each to its plain version there).
Here: (a) each instance's plan (shared memory, tile, vector width, CTAs an
SM) is a Python function mirroring the CUDA sources, and it fits the 227 KB
a block may use at every tiny-224 and base-384 geometry; (b) at float32 the
model's stock convolutions (stem, merges, the plain CARAFE sites) run with
cuDNN's TF32 off, and at bf16 with the flag untouched; (c) ``VolumeInferencer``
at float32 against the JAX package's at float32 on one seeded volume; (d)
every C entry a wrapper calls at float32 is defined in ``csrc/`` and bound by
``build.py``; and ``build_model``'s refusal of a dtype the port does not take.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cswin_unet_tpu.eval.inference import VolumeInferencer as JaxInferencer
from cswin_unet_tpu.models import CSwinUnet as JaxCSwinUnet
from cswin_unet_tpu.models import CSWinUNet as JaxCSWinUNet
from cswin_unet_tpu.utils import checkpoint as jax_ckpt
from cswin_unet_tpu_torch.config import get_config
from cswin_unet_tpu_torch.eval.inference import VolumeInferencer
from cswin_unet_tpu_torch.models import CSwinUnet, CSWinUNet, build_model
from cswin_unet_tpu_torch.ops.cuda import build
from cswin_unet_tpu_torch.ops.cuda import kernels as K
from cswin_unet_tpu_torch.utils.checkpoint import params_from_jax

CSRC = Path(K.__file__).resolve().parent / "csrc"
REPO = Path(__file__).resolve().parent.parent
CONFIGS = REPO / "cswin_unet_tpu_torch" / "configs"


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _config(name: str, opts=None):
    class Args:
        cfg = str(CONFIGS / name)

    Args.opts = opts
    return get_config(Args)


def _geometries(cfg):
    """(H, C, heads, split, last) of each stage of a config."""
    cs, img = cfg.MODEL.CSWIN, cfg.DATA.IMG_SIZE
    for s in range(4):
        H = img // (4 * 2**s)
        yield H, cs.EMBED_DIM * 2**s, cs.NUM_HEADS[s], cs.SPLIT_SIZE[s], s == 3 or H == cs.SPLIT_SIZE[s]


SERVING = [("cswin_tiny_224_lite.yaml", 224), ("cswin_base_384.yaml", 384)]


# --- (a) the plans -----------------------------------------------------------

def _constants(name: str) -> dict[str, int]:
    """The ``constexpr int`` values of a CUDA source that are literals or
    sums of earlier ones, by name (those of template parameters are
    skipped)."""
    out = {}
    for decl in re.findall(r"constexpr int ([^;]+);", (CSRC / name).read_text()):
        for part in decl.split(","):
            m = re.fullmatch(r"\s*(\w+)\s*=\s*([\w\s*+()]+?)\s*", part)
            if m and set(re.findall(r"[A-Za-z_]\w*", m.group(2))) <= set(out):
                out[m.group(1)] = eval(m.group(2), {}, dict(out))
    return out


@pytest.mark.parametrize("source", ["gemm_tile.cuh", "gemm_f32_tile.cuh", "block_pair.cuh",
                                    "attention_tile.cuh", "carafe.cu"])
def test_plan_constants_are_the_sources(source):
    c = _constants(source)
    if source == "gemm_tile.cuh":
        assert (c["BM"], c["BN"], c["THREADS"]) == (K._GEMM_BM, K._GEMM_BN, K._GEMM_THREADS)
    elif source == "gemm_f32_tile.cuh":  # the float32 tile of the chain and of the pair
        assert (c["STAGES"], c["BK"], c["TN"]) == (K._F32_STAGES, K._F32_BK, K._F32_TN)
        # its 16-byte rows: BK + 4 floats, 8 rows of B in distinct banks
        lds = K._F32_BK + 4
        assert lds % 4 == 0 and len({r * lds % 32 for r in range(8)}) == 8
    elif source == "block_pair.cuh":  # the float32 pair: its GEMM phases' tile, its cap
        phases = (CSRC / "block_phases.cuh").read_text()
        tile = re.search(r"using GemmF32Smem = gemm_f32::Smem<(\d+), (\d+), false>;", phases)
        assert tuple(map(int, tile.groups())) == K._PAIR_F32_TILE
        assert re.search(r"constexpr int BM = (\d+), BN = (\d+);", phases).groups() == \
            tuple(map(str, K._PAIR_F32_TILE))
        assert c["F32_CTAS"] == K._PAIR_F32_CTAS
        assert _constants("block_phases.cuh")["F32_MAX_C"] == K._PAIR_F32_MAX_C
    elif source == "attention_tile.cuh":
        assert (c["WARPS"], c["QR"]) == (K._ATT_WARPS, K._ATT_F32_QR)
    else:
        assert (c["TW"], c["TH"], c["HALO_PX"], c["F32_VEC"], c["F32_THREADS"]) == (
            K._CARAFE_TILE, K._CARAFE_TILE, K._CARAFE_HALO_PX, K._CARAFE_F32_VEC,
            K._CARAFE_F32_THREADS)


def _macro_instances(name: str) -> list[tuple[int, int, int]]:
    """(largest C, G, V) of each arm of a LayerNorm instance macro."""
    text = (CSRC / "layernorm_row.cuh").read_text()
    body = re.search(rf"#define {name}\(C, X\)(.*?)\n\n", text, re.S).group(1)
    arms = re.findall(r"\(C\) <= (\d+) \? X\((\d+), (\d+)\)", body)
    last = re.findall(r": X\((\d+), (\d+)\)\)\s*$", body.replace("\\\n", ""))
    return ([(int(c), int(g), int(v)) for c, g, v in arms]
            + [(K.LN_MAX_C, int(last[0][0]), int(last[0][1]))])


@pytest.mark.parametrize("dtype,macro", [(torch.bfloat16, "LN_ROW_INSTANCE"),
                                         (torch.float32, "LN_ROW_INSTANCE_F32")])
def test_layernorm_plan_is_the_instance_macro(dtype, macro):
    arms = _macro_instances(macro)
    E = 8 if dtype == torch.bfloat16 else 4
    for C in range(E, K.LN_MAX_C + 1, E):
        _, G, V = next(a for a in arms if C <= a[0])
        plan = K.layernorm_fwd_plan(C, dtype)
        assert (plan.lanes, plan.vectors, plan.elements) == (G, V, E), C
        assert plan.lanes * plan.vectors * E >= C and plan.rows_per_step * plan.lanes == 256
    for C in (0, E + 2, K.LN_MAX_C + E):
        with pytest.raises(ValueError):
            K.layernorm_fwd_plan(C, dtype)


@pytest.mark.parametrize("cfg_name,img", SERVING)
def test_float32_plans_fit_every_serving_geometry(cfg_name, img):
    """The shared memory of every float32 instance at each stage of a
    serving config (32 slices) stays within the 227 KB a block may use, and
    every instance fits at least one CTA on an SM."""
    cfg = _config(cfg_name)
    ed = cfg.MODEL.CSWIN.EMBED_DIM
    for H, C, heads, split, last in _geometries(cfg):
        M = 32 * H * H
        for n in (3 * C, C, 4 * C):
            plan = K.gemm_f32_plan(M, n)
            assert plan.smem_bytes <= K.SMEM_LIMIT  # dynamic shared memory
            assert plan.ctas == -(-M // plan.bm) * -(-n // plan.bn)
        ln = K.layernorm_fwd_plan(C, torch.float32)
        assert ln.lanes * ln.vectors * 4 >= C
        windows = [(H, H)] if last else [(H, split), (split, H)]
        for hs, ws in windows:
            att = K.attention_f32_plan(hs * ws, C // heads)
            assert att.smem_bytes <= K.SMEM_LIMIT and att.ctas_per_sm >= 1, (H, hs, ws)
        if not last:
            assert K.block_pair_f32_smem(H, H, C, heads, split) <= K.SMEM_LIMIT
    # the fused CARAFE sites: x2 upsamplers at stage resolution >= 28, the x4 tail
    from cswin_unet_tpu_torch.ops.cuda.carafe_tail import gy_channels

    sites = [(C // 4, C // 2, 2) for H, C, *_ in _geometries(cfg) if H >= 28 and C > ed]
    sites += [(ed // 4, nc, 4) for nc in (9, 12, 14)]
    for cm, nc, up in sites:
        plan = K.carafe_f32_plan(cm, nc, gy_channels(cm, nc), up)
        assert plan.smem_bytes <= K.SMEM_LIMIT and plan.ctas_per_sm >= 1, (cm, nc, up)
    if img == 384:  # the widest window: stage 3's 24 x 12 = 288 tokens, head dim 24
        assert K.attention_f32_plan(288, 24).ctas_per_sm == 2


# (H, W, C, heads, split): the pairable float32 geometries, tiny-224's stages
# 2 and 3 and base-384's
PAIR_GEOMETRIES = [(28, 28, 128, 4, 2), (14, 14, 256, 8, 7), (48, 48, 192, 8, 2),
                   (24, 24, 384, 16, 12)]


@pytest.mark.parametrize("H,W,C,heads,split", PAIR_GEOMETRIES)
def test_block_pair_f32_smem_is_the_sources(H, W, C, heads, split):
    """The float32 pair's shared memory is the larger of the chain's 64 x
    64 float32 GEMM tile (``gemm_f32::Smem``: the ring of A and B, rows of
    BK + 4 floats, or the staged outputs, rows of BN + BN / TN, and a scale
    a row, 128-byte aligned) and the widest window's float32 attention
    staging; at tiny-224's stage 3 it leaves room for the F32_CTAS CTAs an
    SM the register cap is chosen for."""
    bm, bn = K._PAIR_F32_TILE
    ring = K._F32_STAGES * 2 * 64 * (K._F32_BK + 4)
    gemm = -(-4 * (max(ring, bm * (bn + bn // K._F32_TN)) + bm) // 128) * 128
    assert gemm == K.gemm_f32_smem(bm, bn) == 55552
    att = K.attention_f32_plan(max(H, W) * split, C // heads).smem_bytes
    assert K.block_pair_f32_smem(H, W, C, heads, split) == max(gemm, att)
    assert C <= K._PAIR_F32_MAX_C  # the rows its LN phases take
    if (H, C) == (14, 256):
        assert K._PAIR_F32_CTAS * (K.block_pair_f32_smem(H, W, C, heads, split) + 1024) \
            <= K._SM_SMEM


# (c_mid, nc, up): tiny-224's upsample2 and tail (its 9 classes and the
# continual heads' 12 and 14), base-384's
CARAFE_F32_SITES = [(32, 64, 2), (16, 9, 4), (16, 12, 4), (16, 14, 4), (48, 96, 2),
                    (24, 9, 4), (24, 12, 4), (24, 14, 4)]


@pytest.mark.parametrize("cm,nc,up", CARAFE_F32_SITES)
def test_carafe_f32_plan_is_the_layout(cm, nc, up):
    """``carafe_f32_plan`` at every float32 CARAFE site: 128 threads, a
    thread one up-position of 8 pixels (up 4) or 2 (up 2); the weight of
    9·up² rows of 9 x c_mid padded to 4, each an odd number of 16-byte
    words; two mid halos and one y halo (padded at up 2), the labels'
    stage of the tile's (8·up)² labels and the biases; every site fits the
    227 KB of a block, tiny-224's two CTAs an SM."""
    from cswin_unet_tpu_torch.ops.cuda.carafe_tail import gy_channels

    plan = K.carafe_f32_plan(cm, nc, gy_channels(cm, nc), up)
    cmp, ncp, pad = -(-cm // 4) * 4, -(-nc // 4) * 4, 4 * (up == 2)
    assert (plan.threads, plan.pixels, plan.c_pad, plan.halo_stride, plan.y_stride) == (
        128, 8 if up == 4 else 2, cmp, cmp + pad, ncp + pad)
    # eight consecutive up-positions' 16-byte words fall in distinct banks
    assert plan.weight_row in (9 * cmp, 9 * cmp + 4) and plan.weight_row // 4 % 2 == 1
    assert len({s * plan.weight_row // 4 % 8 for s in range(8)}) == 8
    r16 = lambda b: -(-b // 16) * 16
    assert plan.smem_bytes == (9 * up * up * plan.weight_row * 4 + 2 * 100 * (cmp + pad) * 4
                               + 100 * (ncp + pad) * 4 + (8 * up) ** 2 * 4
                               + r16(36 * up * up) + r16(4 * nc))
    assert plan.smem_bytes <= K.SMEM_LIMIT and plan.ctas_per_sm >= 1
    if cm in (16, 32):
        assert plan.ctas_per_sm == 2


@pytest.mark.parametrize("H,W", [(8, 8), (28, 28), (56, 56), (11, 13), (7, 9), (1, 17)])
@pytest.mark.parametrize("up", [2, 4])
def test_carafe_f32_threads_cover_each_item_once(H, W, up):
    """The float32 kernel's register blocking (``kernels.carafe_f32_items``,
    the kernel's thread mapping): over the 8x8 tiles, ragged ones included,
    every (low-res pixel, up-position) is one thread's, once."""
    items = K.carafe_f32_items(H, W, up)
    assert len(items) == len(set(items)) == H * W * up * up
    assert set(items) == {(y, x, s) for y in range(H) for x in range(W)
                          for s in range(up * up)}


def test_attention_plan_walks_every_row_once():
    """Each warp takes QR rows at a time, warps striding: every query row of
    a window is some warp's, once; a warp's score rows hold the window's
    keys in whole slots of 32."""
    for L in (49, 56, 96, 98, 144, 288):
        plan = K.attention_f32_plan(L, 32)
        rows = [r0 + r for w in range(plan.warps)
                for r0 in range(w * plan.rows, L, plan.warps * plan.rows)
                for r in range(plan.rows) if r0 + r < L]
        assert sorted(rows) == list(range(L))
        assert plan.score_keys % 32 == 0 and L <= plan.score_keys < L + 32
        # a quarter-warp's 16-byte reads of k rows fall in distinct banks
        assert len({j * plan.kv_stride % 32 for j in range(8)}) == 8


# --- (b) full float32 convolutions -------------------------------------------

def _conv_flags(monkeypatch, dtype) -> list[bool]:
    """``torch.backends.cudnn.allow_tf32`` at each ``F.conv2d`` call of one
    forward of a narrow model on the plain route (stem, merges, the plain
    CARAFE sites and LePE)."""
    seen = []
    conv2d = torch.nn.functional.conv2d

    def spy(*args, **kw):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv2d(*args, **kw)

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    torch.manual_seed(0)
    model = CSwinUnet(CSWinUNet(img_size=32, num_classes=4, embed_dim=16, depth=(1, 1, 1, 1),
                                split_size=(1, 2, 2, 1), num_heads=(2, 2, 4, 8), dtype=dtype,
                                impl="fused")).eval()
    with torch.inference_mode():
        model(torch.zeros(1, 32, 32, 1))
    return seen


def test_float32_convolutions_run_without_tf32(monkeypatch):
    assert torch.backends.cudnn.allow_tf32  # PyTorch's default
    seen = _conv_flags(monkeypatch, torch.float32)
    # stem, 3 merges, the plain CARAFE sites at 4 -> 8 and 2 -> 4 (down,
    # encoder, out convs each) and the tail's plain reference: more than 5
    assert len(seen) > 5 and not any(seen)
    assert torch.backends.cudnn.allow_tf32  # restored after each call


def test_bf16_convolutions_leave_the_flag(monkeypatch):
    seen = _conv_flags(monkeypatch, torch.bfloat16)
    assert len(seen) > 5 and all(seen)


def test_conv_precision_keeps_the_other_cudnn_flags():
    from cswin_unet_tpu_torch.ops.precision import conv_precision

    cudnn = torch.backends.cudnn
    before = (cudnn.enabled, cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32)
    with conv_precision(torch.float32):
        assert (cudnn.enabled, cudnn.benchmark, cudnn.deterministic) == before[:3]
        assert not cudnn.allow_tf32
    with conv_precision(torch.bfloat16):
        assert (cudnn.enabled, cudnn.benchmark, cudnn.deterministic,
                cudnn.allow_tf32) == before
    assert (cudnn.enabled, cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32) == before


# --- (c) VolumeInferencer at float32 against the JAX package's ----------------

SMALL = dict(img_size=32, num_classes=4, embed_dim=16, depth=(1, 1, 1, 1),
             split_size=(1, 2, 2, 1), num_heads=(2, 2, 4, 8))


def _margin_mismatches(labels, ref_logits):
    srt = np.sort(ref_logits, -1)
    margin = srt[..., -1] - srt[..., -2]
    thr = 0.02 * float(np.abs(ref_logits).max())
    return int(np.sum((labels != ref_logits.argmax(-1)) & (margin > thr)))


@pytest.mark.parametrize("jax_impl,impl", [("xla", "plain"), ("fused", "fused"),
                                           ("pallas", "pallas")])
def test_volume_inferencer_float32_matches_jax(jax_impl, impl):
    """One seeded 11-slice volume at batch 8 (a full chunk and an 8-slice
    tail bucket) through both inferencers at float32: the port's labels by
    the margin rule against the JAX model's float32 logits, and its logits
    within 1e-4 of them (the JAX fused and pallas routes run their Pallas
    kernels in interpret mode)."""
    m = JaxCSwinUnet(backbone=JaxCSWinUNet(**SMALL, dtype=jnp.float32, attn_impl=jax_impl))
    params = m.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 1)))
    flat = {k: np.array(v) for k, v in jax_ckpt.flatten(jax.device_get(params)).items()}
    backbone = CSWinUNet(**SMALL, dtype=torch.float32, impl=impl)
    backbone.load_state_dict(params_from_jax(flat))
    port = CSwinUnet(backbone).eval()

    vol = np.random.default_rng(6).normal(size=(11, 32, 32)).astype(np.float32)
    ours = VolumeInferencer(port, device="cpu", patch_size=(32, 32),
                            batch_slices=8).predict_slices(vol)
    theirs = JaxInferencer(m, params, patch_size=(32, 32), batch_slices=8,
                           data_parallel=False).predict_slices(vol)
    logits = np.asarray(m.apply(params, jnp.asarray(vol[..., None]), deterministic=True),
                        np.float32)
    with torch.inference_mode():
        port_logits = port(torch.from_numpy(vol[..., None])).numpy()
    assert ours.shape == theirs.shape == (11, 32, 32) and ours.dtype == np.int32
    assert _margin_mismatches(ours, logits) == 0
    assert _margin_mismatches(theirs, logits) == 0
    rel = np.linalg.norm(port_logits - logits) / np.linalg.norm(logits)
    assert rel <= 1e-4


# --- (d) the C entries, and the dtypes build_model takes ---------------------

def test_float32_entries_are_defined_and_bound():
    """Every C entry the wrappers call at float32 is a ``CSWIN_API``
    function of a ``.cu`` file that ``build.py`` compiles, and ``build.py``
    binds it with as many arguments as the source declares."""
    wrappers = (CSRC.parent / "kernels.py").read_text()
    called = set(re.findall(r"library\(\)\.(cswin_\w+_f32)\b", wrappers))
    assert called == {"cswin_layernorm_f32", "cswin_gemm_f32", "cswin_stripe_attention_f32",
                      "cswin_cswin_attention_f32", "cswin_carafe_f32",
                      "cswin_block_pair_f32", "cswin_layernorm_bwd_f32",
                      "cswin_gemm_wgrad_f32", "cswin_stripe_attention_bwd_f32"}
    built = {p.name for p in build._sources()}
    defined = {}
    for src in CSRC.glob("*.cu"):
        for name, args in re.findall(r"CSWIN_API \w+(?: \w+)? (cswin_\w+)\(([^)]*)\)",
                                     src.read_text()):
            defined[name] = (src.name, len([a for a in args.split(",") if a.strip()]))
    for name in called | {"cswin_stripe_attention_f32_smem", "cswin_carafe_f32_smem",
                          "cswin_gemm_f32_smem"}:
        assert name in defined, name
        assert defined[name][0] in built
        assert len(build._SIGNATURES[name]) == defined[name][1], name


def test_launch_counts_report_the_float32_instances():
    K.reset_launch_counts()
    counts = K.launch_counts()
    for k in K.F32_KERNELS:
        assert counts[k.__name__] == counts[f"{k.__name__}_f32"] == 0
    assert K.total_launches() == 0
    # on the CPU a wrapper runs its plain version: nothing is launched
    x = torch.randn(4, 64)
    K.layernorm(x, torch.ones(64), torch.zeros(64))
    assert K.launch_counts()["layernorm_f32"] == 0


def test_build_model_names_the_dtypes_it_takes():
    cfg = _config("cswin_tiny_224_lite.yaml", ["TPU.COMPUTE_DTYPE", "float16",
                                              "MODEL.CSWIN.EMBED_DIM", "16"])
    with pytest.raises(ValueError, match="'bfloat16' or 'float32'"):
        build_model(cfg, img_size=32, device="cpu")
    ok = _config("cswin_tiny_224_lite.yaml", ["TPU.COMPUTE_DTYPE", "float32",
                                             "MODEL.CSWIN.EMBED_DIM", "16",
                                             "MODEL.CSWIN.DEPTH", "[1, 1, 1, 1]"])
    assert build_model(ok, img_size=32, device="cpu").cswin_unet.dtype == torch.float32
