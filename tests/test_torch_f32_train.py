"""Training at ``TPU.COMPUTE_DTYPE: float32``, on the CPU.

The float32 instances of the backward kernels run only on the card
(``tests/test_torch_cuda.py -k f32`` holds each to its plain version there).
Here: (a) every float32 backward plan (shared memory, tile, ring, CTAs)
comes from the CUDA sources' constants and fits the 227 KB a block may use
at every tiny-224 and base-384 training geometry, base-384's 288-token
windows at head dim 24 included; (b) at float32 cuDNN's TF32 flag reads
False in the backward of every stock convolution, through
``loss.backward()`` and through ``torch.autograd.grad``, inside ``CarafeFn``
and ``CSWinAttentionFn`` too, and at bf16 it is left as it was; (c) every C
entry a backward wrapper calls at float32 is defined in ``csrc/`` and bound
by ``build.py``; (d) the train CLI at ``--opts TPU.COMPUTE_DTYPE float32``
for 2 steps logs the JAX trainer's losses within 1e-5 on the same weights
and batches.
"""

import inspect
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cswin_unet_tpu.config import get_config as jax_get_config
from cswin_unet_tpu.data import make_synthetic_dataset
from cswin_unet_tpu.models import build_model as jax_build_model
from cswin_unet_tpu.train import trainer_synapse as jax_trainer_synapse
from cswin_unet_tpu.utils import checkpoint as jax_ckpt
from cswin_unet_tpu_torch.config import get_config
from cswin_unet_tpu_torch.losses import segmentation_loss
from cswin_unet_tpu_torch.models import CSwinUnet, CSWinUNet
from cswin_unet_tpu_torch.ops.cuda import build
from cswin_unet_tpu_torch.ops.cuda import kernels as K
from cswin_unet_tpu_torch.ops.cuda.carafe_tail import CarafeFn
from cswin_unet_tpu_torch.ops.cuda.cswin_attention import CSWinAttentionFn

CSRC = Path(K.__file__).resolve().parent / "csrc"
REPO = Path(__file__).resolve().parent.parent
CONFIGS = REPO / "cswin_unet_tpu_torch" / "configs"
F32 = torch.float32


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
        yield (H, cs.EMBED_DIM * 2**s, cs.NUM_HEADS[s], cs.SPLIT_SIZE[s],
               s == 3 or H == cs.SPLIT_SIZE[s])


# --- (a) the plans -----------------------------------------------------------

def _constants(name: str) -> dict[str, int]:
    """The ``constexpr int`` values of a CUDA source that are literals or
    sums and products of earlier ones, by name (those of template parameters
    are skipped)."""
    out = {}
    for decl in re.findall(r"constexpr int ([^;]+);", (CSRC / name).read_text()):
        for part in decl.split(","):
            m = re.fullmatch(r"\s*(\w+)\s*=\s*([\w\s*+()]+?)\s*", part)
            if m and set(re.findall(r"[A-Za-z_]\w*", m.group(2))) <= set(out):
                out[m.group(1)] = eval(m.group(2), {}, dict(out))
    return out


GEMM, ATT = _constants("gemm.cu"), _constants("stripe_attention_bwd.cu")
# gemm_f32.cu's weight-gradient ring (namespace wgrad_f32): MS rows a stage,
# STAGES stages
WGRAD_F32 = dict(re.findall(r"constexpr int (MS|STAGES) = (\d+);",
                            re.search(r"namespace wgrad_f32 \{(.*?)\}  // namespace wgrad_f32",
                                      (CSRC / "gemm_f32.cu").read_text(), re.S).group(1)))
WGRAD_F32 = {k: int(v) for k, v in WGRAD_F32.items()}


def _wgrad_f32_smem(bn: int, bk: int) -> int:
    """Bytes of dynamic shared memory of the float32 weight-gradient kernel
    of a ``bn`` x ``bk`` tile (``wgrad_f32::Smem``): ``STAGES`` stages of
    ``MS`` unpadded float32 rows of dY and X with the rows' scales, a
    128-byte aligned struct."""
    size = WGRAD_F32["STAGES"] * WGRAD_F32["MS"] * (bn + bk + 1) * 4
    return -(-size // 128) * 128


def test_backward_plan_constants_are_the_sources():
    g = GEMM
    assert g["MS"] == K._WGRAD_ROWS
    assert _constants("wgrad_sum.cuh")["MAX_CLUSTER"] == K._WGRAD_CLUSTER
    # the float32 weight gradient plans its own chunks, in whole float32 stages
    assert WGRAD_F32["MS"] == K._WGRAD_F32_ROWS
    a = ATT
    assert (a["WARPS"], a["KB"], a["ROWS_B"], a["ROW_TARGET"], a["KEYS"], a["KEY_BLOCKS"]) == (
        K._ATT_BWD_WARPS, K._ATT_BWD_KEYS, K._ATT_BWD_F32_ROWS, K._ATT_BWD_F32_ROW_TARGET,
        K._ATT_BWD_F32_KEYS, K._ATT_BWD_F32_KEY_BLOCKS)
    assert a["KEYS"] == 32  # a lane a key
    ln = _constants("layernorm.cu")
    assert (ln["THREADS"], ln["GROUP"]) == (K._LN_THREADS, K._LN_GROUP)
    # the float32 rows wider than 512 load the next row only after this one
    assert "PREFETCH = sizeof(T) == 2 || C <= 512;" in (CSRC / "layernorm.cu").read_text()
    # the float32 ring: unpadded rows of MS floats of dY and X, and the scales
    src = (CSRC / "gemm_f32.cu").read_text()
    assert re.search(r"float D\[STAGES\]\[MS\]\[BN\];\s*float X\[STAGES\]\[MS\]\[BK\];"
                     r"\s*float sc\[STAGES\]\[MS\];", src)


@pytest.mark.parametrize("C", [32, 64, 96, 128, 192, 256, 384, 512, 768])
def test_layernorm_bwd_plans_at_both_dtypes(C):
    """The float32 rows take 16-byte vectors of 4 floats: as many vectors a
    lane as bf16's 8 where bf16's lanes are not capped at 32, at most twice
    as many where they are, and the static shared memory (dγ | dβ partials
    of eight warps, the sums' staging) within 48 KB at every width."""
    vectors = lambda plan, E: -(-C // E // plan.lanes)  # a lane's, Shape::V
    for rows in (1, 65, 24 * 56 * 56):
        bf, f32 = (K.layernorm_bwd_plan(rows, C, 2, dtype=dt) for dt in (torch.bfloat16, F32))
        assert vectors(f32, 4) <= 2 * vectors(bf, 8)
        assert bf.lanes == 32 or vectors(f32, 4) == vectors(bf, 8)
        assert f32.lanes >= bf.lanes and f32.rows_per_step * f32.lanes == K._LN_THREADS
        assert f32.grid <= max(1, -(-rows // f32.rows_per_step))
    pairs = 2 if C <= 512 else 1
    assert 4 * pairs * 8 * C + 16 * K._LN_THREADS + 4 <= 48 * 1024


TRAINING = [("cswin_tiny_224_lite.yaml", 224), ("cswin_base_384.yaml", 384)]


@pytest.mark.parametrize("cfg_name,img", TRAINING)
def test_float32_backward_plans_fit_every_training_geometry(cfg_name, img):
    """At bs 24 at each stage: the weight gradient's ring and its summed
    tile, the dX products' tile, the attention backward's shared memory (both
    branches, the last stage's one full window), each within what a block may
    use and at least one CTA an SM."""
    cfg = _config(cfg_name)
    for H, C, heads, split, last in _geometries(cfg):
        M = 24 * H * H
        for n, k in ((C, 4 * C), (4 * C, C), (C, C), (3 * C, C)):
            wp = K.wgrad_f32_plan(M, n, k)
            smem = _wgrad_f32_smem(wp.bn, wp.bk)
            assert smem <= K.SMEM_LIMIT, (H, n, k)
            # the summed tile, db and its row-group partials fit the ring
            groups = wp.bn * wp.bk // 64 // (wp.bn // 4)
            assert 4 * (wp.bn * (wp.bk + 4) + wp.bn + groups * wp.bn) <= smem
            assert wp.chunk % WGRAD_F32["MS"] == 0
            assert K.gemm_f32_plan(M, k).smem_bytes <= K.SMEM_LIMIT  # the dX tile, dynamic
        windows = [(H, H)] if last else [(H, split), (split, H)]
        for hs, ws in windows:
            plan = K.stripe_attention_bwd_f32_plan(hs * ws, C // heads)
            for smem, ctas in ((plan.rows_smem, plan.rows_ctas_per_sm),
                               (plan.keys_smem, plan.keys_ctas_per_sm)):
                assert smem <= K.SMEM_LIMIT and ctas >= 2, (H, hs, ws)
            assert plan.score_keys % 32 == 0 and plan.score_keys >= hs * ws
            # a quarter-warp's 16-byte reads of k and v rows fall in distinct banks
            assert len({j * plan.kv_stride % 32 for j in range(8)}) == 8
    if img == 384:
        # stage 3's 288-token windows at head dim 24: the bf16 plan's tiles of
        # a 64-key block over all queries would not fit at float32, so the
        # rows and the keys are two kernels, two CTAs an SM each.
        plan = K.stripe_attention_bwd_f32_plan(288, 24)
        assert (plan.rows_smem, plan.keys_smem) == (107520, 69984)
        assert (plan.rows_ctas_per_sm, plan.keys_ctas_per_sm) == (2, 3)
        q_k_v_do, tiles = 4 * 288 * 24 * 4, 2 * 288 * 64 * 4
        assert q_k_v_do + tiles > K.SMEM_LIMIT
    for bn, bk in ((64, 64), (128, 64), (64, 128), (128, 128)):
        assert _wgrad_f32_smem(bn, bk) <= K.SMEM_LIMIT


def test_attention_bwd_plan_covers_rows_and_keys():
    """The row kernel gives every query row to one CTA's block and one warp
    of it; the key kernel every key to one lane of one warp's key block of
    one CTA."""
    for L in (49, 56, 96, 98, 144, 288):
        plan = K.stripe_attention_bwd_f32_plan(L, 24)
        per_cta = plan.row_block // plan.rows
        rows = [g * plan.rows + r for z in range(plan.row_ctas) for w in range(plan.warps)
                for g in range(z * per_cta + w, min((z + 1) * per_cta, -(-L // plan.rows)),
                               plan.warps)
                for r in range(plan.rows) if g * plan.rows + r < L]
        assert sorted(rows) == list(range(L))
        keys = [kb * plan.keys + lane for z in range(plan.key_ctas)
                for kb in range(z * plan.key_blocks_per_cta,
                                min(plan.key_blocks, (z + 1) * plan.key_blocks_per_cta))
                for lane in range(32) if kb * plan.keys + lane < L]
        assert keys == list(range(L))


# --- (b) cuDNN's TF32 flag in the backward of the stock convolutions -------

class _ConvFlags(TorchDispatchMode):
    """``torch.backends.cudnn.allow_tf32`` at each convolution the dispatcher
    runs: ``(op, flag)`` for the forward (``aten.convolution``) and the
    backward (``aten.convolution_backward``), the latter wherever autograd
    runs it (the engine, or a Function's backward)."""

    def __init__(self):
        super().__init__()
        self.seen: list[tuple[str, bool]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.convolution.default,
                    torch.ops.aten.convolution_backward.default):
            self.seen.append((func.__name__, torch.backends.cudnn.allow_tf32))
        return func(*args, **(kwargs or {}))


SMALL = dict(img_size=32, num_classes=4, embed_dim=16, depth=(1, 1, 1, 1),
             split_size=(1, 2, 2, 1), num_heads=(2, 2, 4, 8))


def _backward_flags(monkeypatch, dtype, impl: str, how: str):
    """The flags at each convolution of one train step's backward of a
    narrow model, and the Functions whose backward ran."""
    ran = []
    for cls in (CarafeFn, CSWinAttentionFn):
        bwd = cls.backward

        def spy(ctx, *g, _bwd=bwd, _name=cls.__name__):
            ran.append(_name)
            return _bwd(ctx, *g)

        monkeypatch.setattr(cls, "backward", staticmethod(spy))
    torch.manual_seed(0)
    model = CSwinUnet(CSWinUNet(**SMALL, dtype=dtype, impl=impl)).train()
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 1)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 4, (2, 32, 32)).astype(np.int64))
    loss, _ = segmentation_loss(model(x), y, 4)
    flags = _ConvFlags()
    with flags:
        if how == "backward":
            loss.backward()
        else:
            torch.autograd.grad(loss, list(model.parameters()))
    return [f for op, f in flags.seen if op.startswith("convolution_backward")], flags.seen, ran


@pytest.mark.parametrize("how", ["backward", "grad"])
@pytest.mark.parametrize("impl", ["fused", "pallas"])
def test_float32_backward_convolutions_run_without_tf32(monkeypatch, impl, how):
    """At float32 every convolution of the backward (the stem, the merges,
    the plain CARAFE sites, the plain-route LePE, and the compositions that
    ``CarafeFn`` and ``CSWinAttentionFn`` re-run and differentiate) reads
    TF32 off, and the flag is PyTorch's default again afterwards."""
    assert torch.backends.cudnn.allow_tf32  # PyTorch's default
    bwd, seen, ran = _backward_flags(monkeypatch, F32, impl, how)
    assert len(bwd) >= 6 and not any(f for _, f in seen), seen
    # the fused CARAFE tail (CarafeFn) on the fused route, the pallas route's
    # branches (CSWinAttentionFn) on the pallas route
    assert set(ran) == {"CarafeFn" if impl == "fused" else "CSWinAttentionFn"}
    assert torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("impl", ["fused", "pallas"])
def test_bf16_backward_convolutions_leave_the_flag(monkeypatch, impl):
    bwd, seen, ran = _backward_flags(monkeypatch, torch.bfloat16, impl, "backward")
    assert len(bwd) >= 6 and all(f for _, f in seen)
    assert set(ran) == {"CarafeFn" if impl == "fused" else "CSWinAttentionFn"}


def test_float32_conv_gradients_equal_the_stock_ones():
    """``ops.precision.conv2d`` at float32 gives ``F.conv2d``'s output and
    input, weight and bias gradients (on the CPU, where no TF32 exists), at
    the model's strides, paddings and groups."""
    from cswin_unet_tpu_torch.ops.precision import conv2d

    rng = np.random.default_rng(7)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    for shape, w_shape, bias, stride, pad, groups in (
            ((2, 1, 32, 32), (16, 1, 7, 7), True, 4, 2, 1),
            ((2, 16, 8, 8), (32, 16, 3, 3), True, 2, 1, 1),
            ((2, 8, 7, 7), (8, 1, 3, 3), False, 1, 1, 8),
            ((2, 12, 5, 6), (36, 12, 1, 1), True, 1, 0, 1)):
        x, w = t(*shape), t(*w_shape)
        b = t(w_shape[0]) if bias else None
        g = None
        res = []
        for fn in (conv2d, torch.nn.functional.conv2d):
            leaves = [v.clone().requires_grad_() for v in (x, w, b) if v is not None]
            out = fn(leaves[0], leaves[1], leaves[2] if bias else None, stride=stride,
                     padding=pad, groups=groups)
            if g is None:
                g = t(*out.shape)
            res.append([out, *torch.autograd.grad(out, leaves, g)])
        for a, want in zip(*res):
            torch.testing.assert_close(a, want, rtol=1e-6, atol=1e-6)


def test_conv2d_takes_the_activations_dtype():
    """A caller that upcasts its operands passes the activations' dtype:
    bf16 activations get the stock ``F.conv2d`` (its backward autograd's
    own), float32 ones the full float32 Function, with or without grad."""
    from cswin_unet_tpu_torch.ops.precision import conv2d

    x = torch.randn(1, 4, 6, 6, requires_grad=True)
    w = torch.randn(4, 1, 3, 3)
    kinds = [type(conv2d(x, w, padding=1, groups=4, dtype=dt).grad_fn).__name__
             for dt in (torch.bfloat16, None, F32)]
    assert kinds == ["ConvolutionBackward0", "_Conv2dF32Backward", "_Conv2dF32Backward"]
    with torch.no_grad():
        torch.testing.assert_close(conv2d(x, w, padding=1, groups=4),
                                   torch.nn.functional.conv2d(x, w, padding=1, groups=4))


# --- (c) the C entries -------------------------------------------------------

def test_backward_float32_entries_are_defined_and_bound():
    """Every C entry that a backward wrapper (or its planner) calls at
    float32 is a ``CSWIN_API`` function of a ``.cu`` file that ``build.py``
    compiles, bound with as many arguments as the source declares."""
    fns = (K.layernorm_bwd, K._layernorm_bwd_plan, K.gemm_dgrad, K.gemm_wgrad,
           K._wgrad_max_clusters, K.stripe_attention_bwd)
    called = {name for fn in fns for name in re.findall(r"library\(\)\.(cswin_\w+)",
                                                         inspect.getsource(fn))
              if "f32" in name}
    assert called == {"cswin_layernorm_bwd_f32", "cswin_layernorm_bwd_f32_ctas_per_sm",
                      "cswin_gemm_f32", "cswin_gemm_wgrad_f32",
                      "cswin_gemm_wgrad_f32_max_clusters", "cswin_stripe_attention_bwd_f32"}
    built = {p.name for p in build._sources()}
    defined = {}
    for src in CSRC.glob("*.cu"):
        for name, args in re.findall(r"CSWIN_API \w+(?: \w+)? (cswin_\w+)\(([^)]*)\)",
                                     src.read_text()):
            defined[name] = (src.name, len([a for a in args.split(",") if a.strip()]))
    for name in called | {"cswin_stripe_attention_bwd_f32_smem", "cswin_gemm_f32_smem"}:
        assert name in defined, name
        assert defined[name][0] in built
        assert len(build._SIGNATURES[name]) == defined[name][1], name
    # the float32 GEMM entry takes the bf16 entry's arguments (training
    # epilogues) and, before the stream, its tile (bm, bn) and B's layout
    c_int = build.ctypes.c_int
    assert build._SIGNATURES["cswin_gemm_f32"] == (
        *build._SIGNATURES["cswin_gemm"][:-1], c_int, c_int, c_int, build.ctypes.c_void_p)
    assert build._RESTYPES["cswin_stripe_attention_bwd_f32_smem"] is build.ctypes.c_longlong


def test_launch_counts_report_the_backward_float32_instances():
    K.reset_launch_counts()
    counts = K.launch_counts()
    for name in ("layernorm_bwd", "gemm_dgrad", "gemm_wgrad", "stripe_attention_bwd"):
        assert counts[name] == counts[f"{name}_f32"] == 0
    # on the CPU a wrapper runs its plain version: nothing is launched
    x = torch.randn(8, 64)
    K.layernorm_bwd(x, torch.randn(8, 64), torch.ones(64))
    K.gemm_wgrad(x, torch.randn(8, 32))
    assert not any(K.launch_counts().values())


# --- (d) the train CLI at float32 against the JAX trainer --------------------

TINY_OPTS = ["MODEL.CSWIN.EMBED_DIM", "16", "MODEL.CSWIN.DEPTH", "[1, 1, 1, 1]",
             "MODEL.CSWIN.NUM_HEADS", "[2, 2, 4, 8]", "MODEL.CSWIN.SPLIT_SIZE",
             "[1, 2, 2, 1]", "MODEL.DROP_PATH_RATE", "0.0", "TPU.COMPUTE_DTYPE", "float32"]


def _log_losses(path) -> list[tuple[int, float, float]]:
    text = Path(path).read_text()
    return [(int(i), float(a), float(b)) for i, a, b in
            re.findall(r"iteration (\d+) : loss : (\S+), loss_ce: (\S+)", text)]


def test_train_cli_float32_matches_the_jax_trainer(tmp_path, monkeypatch):
    """``python -m cswin_unet_tpu_torch.train --opts TPU.COMPUTE_DTYPE
    float32`` for one epoch of 2 steps (bs 4, img 32, drop-path 0) from a
    JAX-initialised checkpoint (``MODEL.PRETRAIN_CKPT``), and the JAX
    package's ``trainer_synapse`` at float32 from the same parameters on the
    same data (the loaders draw the same batches from the same seed): the
    logged losses within 1e-5 at both steps."""
    from cswin_unet_tpu_torch.train import __main__ as train_cli

    data = make_synthetic_dataset(str(tmp_path / "synapse"), num_train_slices=8,
                                  num_volumes=1, size=40, depth=2, num_classes=9, seed=5)
    lists = tmp_path / "lists" / "lists_Synapse_blurred"
    lists.mkdir(parents=True)
    (lists / "train.txt").write_text(Path(data["list_dir"], "train.txt").read_text())

    class _Cfg:
        cfg = "cswin_unet_tpu/configs/cswin_tiny_224_lite.yaml"
        opts = TINY_OPTS + ["DATA.IMG_SIZE", "32"]

    jcfg = jax_get_config(_Cfg)
    jm = jax_build_model(jcfg, img_size=32, num_classes=9)
    params = jm.init(jax.random.PRNGKey(1234), jnp.zeros((1, 32, 32, 1)))
    ck = tmp_path / "init.npz"
    jax_ckpt.save_checkpoint(str(ck), jax.device_get(params))

    import argparse

    jargs = argparse.Namespace(root_path=data["train_dir"], list_dir=data["list_dir"],
                               num_classes=9, batch_size=4, n_gpu=1, max_epochs=1,
                               base_lr=0.01, img_size=32, seed=1234, num_workers=2)
    jax_trainer_synapse(jargs, jm, params, str(tmp_path / "jax_run"))
    want = _log_losses(tmp_path / "jax_run" / "log.txt")

    monkeypatch.chdir(tmp_path)
    msg = train_cli.main(["--cfg", str(CONFIGS / "cswin_tiny_224_lite.yaml"),
                          "--root_path", str(Path(data["train_dir"]).parent),
                          "--dataset", "Synapse", "--output_dir", str(tmp_path / "run"),
                          "--max_epochs", "1", "--batch_size", "4", "--img_size", "32",
                          "--device", "cpu", "--num_workers", "2",
                          "--opts", *TINY_OPTS, "MODEL.PRETRAIN_CKPT", str(ck)])
    assert msg == "Training Finished!"
    got = _log_losses(tmp_path / "run" / "log.txt")
    assert [i for i, _, _ in got] == [i for i, _, _ in want] == [1, 2]
    for (_, loss, ce), (_, jloss, jce) in zip(got, want):
        assert abs(loss - jloss) <= 1e-5 * abs(jloss) + 1e-6, (got, want)
        assert abs(ce - jce) <= 1e-5 * abs(jce) + 1e-6, (got, want)
