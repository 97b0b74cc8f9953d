"""The training route: every block, last stage included, trains through
``CSWinBlockFn`` on the fused route (a block whose ``impl`` is ``"plain"``
trains as the composition, the switch ``tools/train_route.py`` uses), and
that tool on the CPU.

Tolerances: whole-model float32 gradients against ``jax.grad`` relative L2
<= 1e-3 per parameter, as ``tests/test_torch_train.py`` holds the model
(two frameworks' summation orders through the layers of autodiff); the
kernel route against the plain route in float32, loss rel 1e-5 and each
gradient relative L2 <= 1e-4 (on the CPU the kernels run their plain
versions: only summation order differs); ``--use-checkpoint`` bit for bit.
"""

import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cswin_unet_tpu import losses as jax_losses
from cswin_unet_tpu.models import CSwinUnet as JaxCSwinUnet
from cswin_unet_tpu.models import CSWinUNet as JaxCSWinUNet
from cswin_unet_tpu.utils import checkpoint as jax_ckpt
from cswin_unet_tpu_torch.config import get_config
from cswin_unet_tpu_torch.losses import segmentation_loss
from cswin_unet_tpu_torch.models import CSwinUnet, CSWinUNet, cswin_unet
from cswin_unet_tpu_torch.ops.cuda.cswin_block import CSWinBlockFn
from cswin_unet_tpu_torch.tools import train_route as tool
from cswin_unet_tpu_torch.utils.checkpoint import params_from_jax

torch.set_num_threads(2)

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "cswin_unet_tpu_torch", "configs")
GEOM = dict(img_size=64, in_chans=3, num_classes=4, embed_dim=32,
            depth=(1, 1, 1, 1), split_size=(1, 2, 2, 2), num_heads=(2, 4, 8, 16))
YAMLS = ("cswin_tiny_224_lite.yaml", "cswin_base_384.yaml")
NARROW = ["MODEL.CSWIN.EMBED_DIM", "16", "MODEL.CSWIN.DEPTH", "[1,1,1,1]",
          "MODEL.CSWIN.NUM_HEADS", "[2,2,4,8]", "MODEL.CSWIN.SPLIT_SIZE", "[1,2,2,1]",
          "DATA.IMG_SIZE", "32", "TPU.COMPUTE_DTYPE", "float32"]


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def _stage_geometries(yaml: str):
    """(H, C, heads, split, last) of each stage, read from the YAML alone."""
    cfg = get_config(argparse.Namespace(cfg=os.path.join(CONFIGS, yaml), opts=None))
    cs, img = cfg.MODEL.CSWIN, cfg.DATA.IMG_SIZE
    for s in range(4):
        H = img // (4 * 2**s)
        yield H, cs.EMBED_DIM * 2**s, cs.NUM_HEADS[s], cs.SPLIT_SIZE[s], s == 3


def _geoms(model) -> set:
    return {(b.reso, b.reso, b.norm1.weight.shape[0], b.last) for b in model.modules()
            if isinstance(b, cswin_unet.CSWinBlock)}


def _count_block_fn(monkeypatch) -> list:
    calls = []
    apply = CSWinBlockFn.apply
    monkeypatch.setattr(CSWinBlockFn, "apply", lambda *a: calls.append(1) or apply(*a))
    return calls


@pytest.mark.parametrize("stage", range(4))
@pytest.mark.parametrize("yaml", YAMLS)
def test_stage_block_trains_through_block_fn(monkeypatch, yaml, stage):
    """A block at each stage geometry of tiny-224 and base-384 (one slice,
    float32) under autograd: one ``CSWinBlockFn.apply`` on the fused route,
    none with ``impl = "plain"``, and the same output and gradients."""
    H, C, heads, split, last = list(_stage_geometries(yaml))[stage]
    torch.manual_seed(stage)
    blk = cswin_unet.CSWinBlock(C, H, heads, split, last_stage=last).train()
    x = torch.randn(1, H, H, C)
    calls = _count_block_fn(monkeypatch)
    results = []
    for impl in ("fused", "plain"):
        blk.impl = impl
        xx = x.clone().requires_grad_()
        out = blk(xx)
        leaves = [xx, *blk.parameters()]
        results.append((out.detach(), torch.autograd.grad(out.square().sum(), leaves)))
        assert len(calls) == 1
    (ok, gk), (op, gp) = results
    assert _rel_l2(ok.numpy(), op.numpy()) <= 1e-4
    for a, b in zip(gk, gp):
        assert _rel_l2(a.numpy(), b.numpy()) <= 1e-4


def test_plain_impl_on_one_geometry_trains_it_composed(monkeypatch):
    """``impl = "plain"`` on one geometry's blocks (the switch of
    ``tools/train_route.py``): those train as the composition, every other
    block through ``CSWinBlockFn``."""
    geom = dict(GEOM, num_classes=5, embed_dim=16, depth=(1, 2, 1, 1),
                num_heads=(2, 2, 4, 8))
    backbone = CSWinUNet(**geom, dtype=torch.float32, impl="fused")
    model = CSwinUnet(backbone).train()
    blocks = [b for b in backbone.modules() if isinstance(b, cswin_unet.CSWinBlock)]
    for b in blocks:
        if (b.reso, b.norm1.weight.shape[0]) == (8, 32):
            b.impl = "plain"
    calls = _count_block_fn(monkeypatch)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 64, 64, 1))
                         .astype(np.float32))
    model(x).sum().backward()
    assert len(blocks) == 10 and len(calls) == 10 - 4  # stage 2: 2 encoder, 2 decoder


@pytest.mark.parametrize("route", ["kernel", "composed"])
def test_model_grads_match_jax_grad_by_route(monkeypatch, route):
    """Whole-model float32 gradients of 0.4·CE + 0.6·Dice with every block
    (the last stage's too) forced through ``CSWinBlockFn``, or through the
    composition, against ``jax.grad`` of the JAX model (XLA composition,
    drop-path 0) on weights carried over from a JAX init; a spy counts one
    ``CSWinBlockFn.apply`` a block on the kernel route, none on the other."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 64, 64, 1)).astype(np.float32)
    y = rng.integers(0, 4, (2, 64, 64)).astype(np.int32)
    m = JaxCSwinUnet(backbone=JaxCSWinUNet(**GEOM, attn_impl="xla"))
    params = jax.jit(m.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))

    def loss(p):
        logits = m.apply(p, jnp.asarray(x), deterministic=True)
        return jax_losses.segmentation_loss(logits, jnp.asarray(y), 4)[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(params)
    flat = {k: np.array(v) for k, v in jax_ckpt.flatten(jax.device_get(params)).items()}
    want = params_from_jax({k: np.array(v) for k, v in
                            jax_ckpt.flatten(jax.device_get(jgrads)).items()})

    backbone = CSWinUNet(**GEOM, dtype=torch.float32, impl="fused")
    backbone.load_state_dict(params_from_jax(flat))
    geoms = _geoms(backbone)
    assert (2, 2, 256, True) in geoms and len(geoms) == 4
    if route == "composed":
        for b in backbone.modules():
            if isinstance(b, cswin_unet.CSWinBlock):
                b.impl = "plain"
    calls = _count_block_fn(monkeypatch)
    model = CSwinUnet(backbone).train()
    tloss, _ = segmentation_loss(model(torch.from_numpy(x)), torch.from_numpy(y), 4)
    tloss.backward()
    assert len(calls) == (8 if route == "kernel" else 0)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    got = {k: p.grad for k, p in backbone.named_parameters()}
    assert set(got) == set(want)
    errs = {k: _rel_l2(got[k].numpy(), want[k].numpy()) for k in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-3, (worst, errs[worst])


def _loss_and_grads(state, geom, impl, x, y, nc, seed, use_checkpoint=False):
    backbone = CSWinUNet(**geom, drop_path_rate=0.2, dtype=torch.float32, impl=impl,
                         use_checkpoint=use_checkpoint)
    backbone.load_state_dict(state)
    model = CSwinUnet(backbone).train()
    loss, _ = segmentation_loss(model(x, generator=torch.Generator().manual_seed(seed)), y, nc)
    names, params = zip(*backbone.named_parameters())
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss, params)))


@pytest.mark.parametrize("depth,split", [((1, 1, 1, 1), (1, 2, 2, 2)),
                                         ((1, 1, 2, 1), (1, 2, 2, 1))])
def test_kernel_route_matches_plain_route_below_28(monkeypatch, depth, split):
    """Every block (all below resolution 28, the last stage's among them)
    through ``CSWinBlockFn``, with drop-path 0.2 from the same generator:
    the same loss and gradients as the plain route."""
    geom = dict(GEOM, num_classes=5, embed_dim=16, depth=depth, split_size=split,
                num_heads=(2, 2, 4, 8))
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 64, 64, 1)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 5, (2, 64, 64)).astype(np.int64))
    state = CSWinUNet(**geom, dtype=torch.float32).state_dict()
    calls = _count_block_fn(monkeypatch)
    lk, gk = _loss_and_grads(state, geom, "fused", x, y, 5, 4)
    assert len(calls) == 2 * sum(depth)
    lp, gp = _loss_and_grads(state, geom, "plain", x, y, 5, 4)
    assert len(calls) == 2 * sum(depth)
    assert float(lk) == pytest.approx(float(lp), rel=1e-5)
    for k in gp:
        assert _rel_l2(gk[k].numpy(), gp[k].numpy()) <= 1e-4, k


def test_use_checkpoint_under_the_kernel_route(monkeypatch):
    """``--use-checkpoint`` (``torch.utils.checkpoint`` around the block)
    with every block through ``CSWinBlockFn``: the
    same loss and gradients bit for bit, each block's Function applied again
    in the backward."""
    geom = dict(GEOM, num_classes=5, embed_dim=16, num_heads=(2, 2, 4, 8))
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 64, 64, 1)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 5, (2, 64, 64)).astype(np.int64))
    state = CSWinUNet(**geom, dtype=torch.float32).state_dict()
    calls = _count_block_fn(monkeypatch)
    l0, g0 = _loss_and_grads(state, geom, "fused", x, y, 5, 6)
    n0 = len(calls)
    l1, g1 = _loss_and_grads(state, geom, "fused", x, y, 5, 6, use_checkpoint=True)
    assert (n0, len(calls) - n0) == (8, 16)
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_tool_runs_on_the_cpu_and_restores_the_blocks(capsys, monkeypatch):
    """``tools/train_route.py --device cpu`` at a narrow config for one
    round: a header, one line a route, a block line and a verdict a
    geometry (``undecided``: one sample an order), the agreement line, then
    the JSON line; every block's ``impl`` given back."""
    built = []
    build = tool.build_model
    monkeypatch.setattr(tool, "build_model", lambda *a, **k: built.append(build(*a, **k))
                        or built[-1])
    res = tool.main(["--device", "cpu", "--batch", "1", "--rounds", "1", "--opts", *NARROW])
    assert {b.impl for b in built[0].modules()
            if isinstance(b, cswin_unet.CSWinBlock)} == {"fused"}
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {"train_route": json.loads(json.dumps(res))}
    assert all(ln.startswith("[route] ") for ln in lines[:-1])
    geoms = ["8x8x16", "4x4x32", "2x2x64 last", "1x1x128 last"]
    assert lines[0].endswith(f"{{{', '.join(f'{g}: 2' for g in geoms)}}}")
    assert list(res["routes"]) == ["kernel", *(f"composed {g}" for g in geoms)]
    for r in res["routes"].values():
        assert [len(v) for v in r["ms"].values()] == [1, 1]
        assert r["busy_ms"] is None and r["peak_gib"] is None  # not measured on a CPU
    assert list(res["blocks"]) == list(res["verdicts"]) == geoms
    assert {v["route"] for v in res["verdicts"].values()} == {"undecided"}
    assert sum(ln.startswith("[route] step ") for ln in lines) == 5
    assert sum(ln.startswith("[route] verdict ") for ln in lines) == 4
    assert lines[-2].endswith("the verdicts agree: undecided") and res["agree"] is None
    assert res["clock"] == "host (cpu, plain versions)" and res["nvidia_smi"] is None


def _t(fwd, rev):
    return {"forward": fwd, "reverse": rev}


@pytest.mark.parametrize("kernel,composed,gib,want", [
    (_t([10, 11], [10, 11]), _t([20, 21], [20, 21]), (5.0, 4.0), "kernel"),
    (_t([10], [10]), _t([20], [20]), (3.0, 4.0), "undecided"),
    (_t([20, 21], [20, 21]), _t([10, 11], [10, 11]), (1.0, 4.0), "composed"),
    (_t([10, 15], [10, 11]), _t([14, 16], [20, 21]), (3.0, 4.0), "kernel"),
    (_t([10, 15], [10, 11]), _t([14, 16], [20, 21]), (5.0, 4.0), "composed"),
    (_t([10, 11], [20, 21]), _t([20, 21], [10, 11]), (None, 4.0), "undecided"),
])
def test_tool_decision_rule(kernel, composed, gib, want):
    """Faster beyond the larger min-max spread in both orders wins; else the
    lower peak memory; without a memory reading, or with one sample an
    order, no verdict."""
    assert tool.verdict(kernel, composed, *gib)[0] == want


def test_tool_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run")
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main(["--device", "cuda"])
