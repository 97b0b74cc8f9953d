"""Dropout (``MODEL.DROP_RATE``) in the port against the JAX model.

The port draws its masks from counter-based Philox keys
(``cswin_unet_tpu_torch.ops.dropout``), JAX from its own PRNG: the JAX
modules run with ``deterministic=False`` and ``capture_intermediates``, each
mask is recovered as ``captured != 0`` (the inputs are nonzero) and fed to
the port by patching its mask function ``keep_mask``, in the port's call
order (the first call with a new key takes the next JAX mask; a call with a
known key, as the kernel route's backward makes, gets the same one).

Geometry: embed 16, depths 1/1/1/1, heads 2/2/4/8, splits 1/2/2/1, img 32.
Tolerances: the MLP in float32 1e-5 (absolute and relative), one block 2e-4
(as ``test_torch_block_grad`` holds the block), the whole model relative L2
1e-5 (logits and every gradient); bf16 relative L2 0.02, a bias gradient of
the whole model within twice JAX's own bf16-vs-float32 error where that is
larger (the repo's rule for cancellation-dominated sums).
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cswin_unet_tpu import losses as jax_losses
from cswin_unet_tpu.models import CSwinUnet as JaxCSwinUnet
from cswin_unet_tpu.models import CSWinUNet as JaxCSWinUNet
from cswin_unet_tpu.models.cswin_unet import CSWinBlock as JaxCSWinBlock
from cswin_unet_tpu.models.cswin_unet import Mlp as JaxMlp
from cswin_unet_tpu.utils import checkpoint as jax_ckpt
from cswin_unet_tpu_torch.losses import segmentation_loss
from cswin_unet_tpu_torch.models import CSwinUnet, CSWinUNet
from cswin_unet_tpu_torch.models import cswin_unet as port_unet
from cswin_unet_tpu_torch.ops import dropout as D
from cswin_unet_tpu_torch.ops.cuda import kernels as K
from cswin_unet_tpu_torch.parallel import mesh
from cswin_unet_tpu_torch.utils.checkpoint import params_from_jax

torch.set_num_threads(2)

GEOM = dict(img_size=32, in_chans=3, num_classes=4, embed_dim=16,
            depth=(1, 1, 1, 1), split_size=(1, 2, 2, 1), num_heads=(2, 2, 4, 8))
SITES = ["Dropout_0"] + [f"{p}{s}_0/mlp/Dropout_{i}"
                         for p, stages in (("stage", "1234"), ("stage_up", "4321"))
                         for s in stages for i in (0, 1)]
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def _captured(inter, path):
    node = inter
    for part in path.split("/"):
        node = node[part]
    return node["__call__"]


def _masks(inter, paths):
    """The keep masks (rows, cols) of the captured Dropout outputs, in order."""
    out = []
    for path in paths:
        for y in _captured(inter, path):
            y = np.asarray(y.astype(jnp.float32))
            out.append(torch.from_numpy(y.reshape(-1, y.shape[-1]) != 0))
    return out


class _JaxMasks:
    """Stands in for ``ops.dropout.keep_mask``: JAX's masks by key."""

    def __init__(self, masks):
        self.masks, self.by_key = list(masks), {}

    def __call__(self, key, row0, rows, cols, rate):
        k = int(key.reshape(()).item())
        if k not in self.by_key:
            self.by_key[k] = self.masks.pop(0)
        m = self.by_key[k]
        assert tuple(m.shape) == (rows, cols) and row0 == 0
        return m


# ---------------------------------------------------------------------------
# the mask function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("counter,high,key,want", [
    (0, (0, 0), 0, (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    (-1, (0xFFFFFFFF, 0xFFFFFFFF), -1, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    (0x85A308D3243F6A88 - 2**64, (0x13198A2E, 0x03707344), 0x299F31D0A4093822,
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, high, key, want):
    """Philox-4x32-10 against the known-answer vectors of Random123."""
    got = D.philox4x32_10(torch.tensor([counter]), torch.tensor(key), high)
    assert tuple(int(v) for v in got[0]) == want


def test_keep_mask_digest():
    """The mask function's bits, held to a stored digest (the CUDA epilogues
    are held to this function on the card, tests/test_torch_cuda.py)."""
    m = D.keep_mask(torch.tensor([-0x1234567890ABCDE]), 7, 33, 40, 0.1)
    assert m.shape == (33, 40)
    digest = hashlib.sha256(np.packbits(m.numpy()).tobytes()).hexdigest()
    assert digest == "74f60c80bdfd7e3e1d7910a2a11be7d1338da733f18d5776e2a413108287c785"


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_fraction(rate):
    """Over 2^20 elements the kept share lies within 5 sigma of 1 - rate."""
    m = D.keep_mask(D.draw_keys(torch.Generator().manual_seed(1), 1), 3, 1024, 1024, rate)
    keep = 1.0 - rate
    assert abs(m.float().mean().item() - keep) <= 5 * (keep * rate / m.numel()) ** 0.5


def test_rank_rows_equal_one_process():
    """Two ranks' row ranges, each drawn alone, are one process's draw; so
    are chunks of the counter range."""
    key = torch.tensor([987654321])
    whole = D.keep_mask(key, 0, 6, 1000, 0.3)
    halves = torch.cat([D.keep_mask(key, 0, 3, 1000, 0.3), D.keep_mask(key, 3, 3, 1000, 0.3)])
    assert torch.equal(whole, halves)
    odd = D.keep_mask(key, 0, 5, 7, 0.3)  # rows that straddle Philox blocks
    assert torch.equal(odd[2:], D.keep_mask(key, 2, 3, 7, 0.3))


def test_block_rows_of_two_ranks_equal_one_process(monkeypatch):
    """A block in train mode at rate 0.3 (drop-path 0.2): each of two ranks
    (``process_shard_info`` patched) runs its half of the batch with the same
    generator state and gives the rows one process gives, on both routes."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((4, 8, 8, 32)).astype(np.float32))
    for impl in ("fused", "plain"):
        blk = port_unet.CSWinBlock(32, 8, 2, 2, impl=impl).train()
        blk.drop, blk.drop_path = 0.3, 0.2
        want = blk(x, torch.Generator().manual_seed(5))
        for rank in (0, 1):
            for mod in (port_unet, mesh):
                monkeypatch.setattr(mod, "process_shard_info", lambda r=rank: (r, 2))
            monkeypatch.setattr(port_unet, "world_size", lambda: 2)
            got = blk(x[2 * rank:2 * rank + 2], torch.Generator().manual_seed(5))
            torch.testing.assert_close(got, want[2 * rank:2 * rank + 2], rtol=0, atol=0)
        monkeypatch.undo()


def test_dropout_rates_0_and_1():
    """No site at rate 0 (the identity); rate 1 gives zeros and a zero
    gradient."""
    x = torch.randn(4, 16, requires_grad=True)
    y = D.dropout(x, D.Drop(torch.tensor([3]), 1.0))
    y.sum().backward()
    assert torch.equal(y, torch.zeros_like(y)) and torch.equal(x.grad, torch.zeros_like(x))
    assert D.dropout(x, None) is x
    with pytest.raises(ValueError, match="outside"):
        D.keep_threshold(1.5)


# ---------------------------------------------------------------------------
# the MLP, one block and the whole model against JAX's masks
# ---------------------------------------------------------------------------

def _port_mlp(y, w1, b1, w2, b2, drops):
    """The MLP as ``CSWinBlockFn`` runs it (the kernels' plain versions on
    the CPU): forward and, for a cotangent, the hand-written backward."""
    d1, d2 = drops
    M = y.shape[0]
    h = torch.empty(M, w1.shape[0], dtype=y.dtype)
    g = K.gemm(y, w1, b1, epilogue="gelu", pre=h, drop=d1)
    out = K.gemm(g, w2, b2, residual=torch.zeros(M, w2.shape[0], dtype=y.dtype),
                 epilogue="residual", drop=d2)

    def backward(do):
        dh = K.gemm_dgrad(do, w2, gelu_h=h, drop_dy=d2, drop_dx=d1)
        dw2, db2 = K.gemm_wgrad(g, do, drop=d2)
        dw1, db1 = K.gemm_wgrad(y, dh)
        return K.gemm_dgrad(dh, w1), dw1, db1, dw2, db2

    return out, backward


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mlp_matches_jax(monkeypatch, dt):
    """``Mlp(drop=0.3)``: output and the input and weight gradients."""
    jdt, tdt = DT[dt]
    rng = np.random.default_rng(7)
    C, hidden, M = 16, 64, 96
    y = rng.standard_normal((M, C)).astype(np.float32)
    do = rng.standard_normal((M, C)).astype(np.float32)
    mlp = JaxMlp(hidden_features=hidden, out_features=C, drop=0.3, dtype=jdt)
    params = mlp.init(jax.random.PRNGKey(0), jnp.zeros((1, C)))
    rngs = {"dropout": jax.random.PRNGKey(11)}
    yj = jnp.asarray(y).astype(jdt)
    _, state = mlp.apply(params, yj, deterministic=False, rngs=rngs,
                         capture_intermediates=True, mutable=["intermediates"])
    masks = _masks(state["intermediates"], ["Dropout_0", "Dropout_1"])
    out_j, vjp = jax.vjp(lambda p, a: mlp.apply(p, a, deterministic=False, rngs=rngs),
                         params, yj)
    gp, gy = vjp(jnp.asarray(do).astype(jdt))
    f = lambda t: np.asarray(jnp.asarray(t).astype(jnp.float32))
    want = [f(out_j), f(gy), f(gp["params"]["fc1"]["kernel"]).T, f(gp["params"]["fc1"]["bias"]),
            f(gp["params"]["fc2"]["kernel"]).T, f(gp["params"]["fc2"]["bias"])]

    monkeypatch.setattr(D, "keep_mask", _JaxMasks(masks))
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    w1, w2 = t(params["params"]["fc1"]["kernel"]).T.contiguous(), t(params["params"]["fc2"]["kernel"]).T.contiguous()
    b1, b2 = t(params["params"]["fc1"]["bias"]), t(params["params"]["fc2"]["bias"])
    keys = D.draw_keys(torch.Generator().manual_seed(2), 2)
    drops = (D.Drop(keys[0:1], 0.3), D.Drop(keys[1:2], 0.3))
    out, backward = _port_mlp(t(y).to(tdt), w1.to(tdt), b1, w2.to(tdt), b2, drops)
    got = [out, *backward(t(do).to(tdt))]
    got = [g.float().numpy() for g in got]
    for i, (a, b) in enumerate(zip(got, want)):
        if dt == "f32":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=str(i))
        else:
            assert _rel_l2(a, b) <= 0.02, (i, _rel_l2(a, b))


def _block_case(dt):
    jdt, tdt = DT[dt]
    rng = np.random.default_rng(8)
    C, reso, heads, split = 32, 8, 4, 2
    x = rng.standard_normal((2, reso, reso, C)).astype(np.float32)
    g = rng.standard_normal((2, reso, reso, C)).astype(np.float32)
    blk = JaxCSWinBlock(dim=C, reso=(reso, reso), num_heads=heads, split_size=split,
                        drop=0.1, drop_path=0.3, deterministic=False, dtype=jdt,
                        attn_impl="xla")
    params = blk.init({"params": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)},
                      jnp.zeros((2, reso, reso, C), jdt))
    rngs = {"dropout": jax.random.PRNGKey(9)}
    xj = jnp.asarray(x).astype(jdt)
    _, state = blk.apply(params, xj, rngs=rngs, capture_intermediates=True,
                         mutable=["intermediates"])
    inter = state["intermediates"]
    masks = _masks(inter, ["mlp/Dropout_0", "mlp/Dropout_1"])
    # drop-path: the block's Dropout_0, called on the attention and MLP
    # branches, keeps or drops whole samples
    dps = tuple(torch.from_numpy(
        (np.abs(np.asarray(y.astype(jnp.float32))).reshape(2, -1).max(1) > 0)
        .astype(np.float32) / 0.7) for y in _captured(inter, "Dropout_0"))
    out, vjp = jax.vjp(lambda p, a: blk.apply(p, a, rngs=rngs), params, xj)
    gp, gx = vjp(jnp.asarray(g).astype(jdt))
    flat = {f"stage1_0/{k[len('params/'):]}": np.array(v, np.float32)
            for k, v in jax_ckpt.flatten(jax.device_get(params)).items()}
    gflat = {f"stage1_0/{k[len('params/'):]}": np.array(jnp.asarray(v).astype(jnp.float32))
             for k, v in jax_ckpt.flatten(jax.device_get(gp)).items()}
    strip = lambda d: {k[len("stage1.0."):]: v for k, v in params_from_jax(d).items()}
    return (x, g, masks, dps, np.asarray(out.astype(jnp.float32)),
            np.asarray(gx.astype(jnp.float32)), strip(flat), strip(gflat), tdt)


@pytest.mark.parametrize("impl", ["plain", "fused"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_block_matches_jax(monkeypatch, impl, dt):
    """One ``CSWinBlock`` in training at dropout 0.1 and drop-path 0.3 (JAX
    trains it through the composition), both of the port's routes: output,
    input and parameter gradients."""
    x, g, masks, dps, out_j, gx_j, state, gstate, tdt = _block_case(dt)
    monkeypatch.setattr(D, "keep_mask", _JaxMasks(masks))
    blk = port_unet.CSWinBlock(32, 8, 4, 2, impl=impl).train()
    blk.load_state_dict(state)
    blk.drop = 0.1
    xx = torch.from_numpy(x).to(tdt).requires_grad_()
    drops = blk.dropout_sites(xx, torch.Generator().manual_seed(3))
    out = blk._block(xx, dps, drops)
    out.backward(torch.from_numpy(g).to(tdt))
    got = {"out": out.detach(), "dx": xx.grad, **{k: p.grad for k, p in blk.named_parameters()}}
    want = {"out": out_j, "dx": gx_j, **gstate}
    assert set(got) == set(want)
    for k in want:
        a, b = got[k].float().numpy(), want[k]
        if dt == "f32":
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4, err_msg=k)
        else:
            assert _rel_l2(a, b) <= 0.02, (k, _rel_l2(a, b))


@pytest.fixture(scope="module")
def jax_model():
    m = JaxCSwinUnet(backbone=JaxCSWinUNet(**GEOM, drop_rate=0.1, attn_impl="xla"))
    params = jax.jit(m.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 32, 1)).astype(np.float32)
    y = rng.integers(0, 4, (2, 32, 32)).astype(np.int32)
    return params, x, y


def _port_model(params, dt, impl, drop_rate=0.1):
    flat = {k: np.array(v) for k, v in jax_ckpt.flatten(jax.device_get(params)).items()}
    backbone = CSWinUNet(**GEOM, dtype=dt, impl=impl, drop_rate=drop_rate)
    backbone.load_state_dict(params_from_jax(flat))
    return CSwinUnet(backbone)


@pytest.mark.parametrize("impl,dt", [("plain", "f32"), ("fused", "f32"), ("plain", "bf16")])
def test_model_matches_jax(monkeypatch, jax_model, impl, dt):
    """The whole model at ``DROP_RATE`` 0.1: every site, the stem's
    included, in call order; logits and the gradients of 0.4·CE + 0.6·Dice."""
    params, x, y = jax_model
    jdt, tdt = DT[dt]
    m = JaxCSwinUnet(backbone=JaxCSWinUNet(**GEOM, drop_rate=0.1, attn_impl="xla", dtype=jdt))
    rngs = {"dropout": jax.random.PRNGKey(5)}
    # bf16: JAX op by op, each op rounding to bf16 as flax's ops do one at a
    # time (XLA's fusions under jit keep some intermediates in float32)
    jit = jax.jit if dt == "f32" else (lambda f: f)
    logits_j, state = jit(lambda p: m.apply(
        p, jnp.asarray(x), deterministic=False, rngs=rngs, capture_intermediates=True,
        mutable=["intermediates"]))(params)
    masks = _masks(state["intermediates"]["backbone"], SITES)
    assert len(masks) == 17

    def grads(model):
        def loss(p):
            out = model.apply(p, jnp.asarray(x), deterministic=False, rngs=rngs)
            return jax_losses.segmentation_loss(out, jnp.asarray(y), 4)[0]

        g = jit(jax.grad(loss))(params)
        return params_from_jax({k: np.array(jnp.asarray(v).astype(jnp.float32)) for k, v in
                                jax_ckpt.flatten(jax.device_get(g)).items()})

    want = grads(m)
    patched = _JaxMasks(masks)
    monkeypatch.setattr(D, "keep_mask", patched)
    model = _port_model(params, tdt, impl).train()
    logits = model(torch.from_numpy(x), generator=torch.Generator().manual_seed(4))
    assert not patched.masks and len(patched.by_key) == 17  # every site, once each
    tloss, _ = segmentation_loss(logits, torch.from_numpy(y).long(), 4)
    tloss.backward()
    got = {k: p.grad for k, p in model.cswin_unet.named_parameters()}
    assert set(got) == set(want)
    errs = {k: _rel_l2(got[k].numpy(), want[k].numpy()) for k in want}
    worst = max(errs, key=errs.get)
    lerr = _rel_l2(logits.detach().numpy(), np.asarray(logits_j, np.float32))
    if dt == "f32":
        assert lerr <= 1e-5 and errs[worst] <= 1e-5, (lerr, worst, errs[worst])
        return
    # bf16: every gradient within 0.02, a bias gradient (a cancellation-
    # dominated sum) within twice JAX's own bf16-vs-float32 error where that
    # is larger (the repo's rule, bench.py:382-388)
    m32 = JaxCSwinUnet(backbone=JaxCSWinUNet(**GEOM, drop_rate=0.1, attn_impl="xla"))
    jit = jax.jit
    f32 = grads(m32)
    bound = {k: max(0.02, 2 * _rel_l2(want[k].numpy(), f32[k].numpy()))
             if k.endswith(".bias") else 0.02 for k in want}
    assert lerr <= 0.02, lerr
    assert all(errs[k] <= bound[k] for k in errs), {
        k: (errs[k], bound[k]) for k in errs if errs[k] > bound[k]}


def test_eval_at_rate_equals_rate_0(jax_model):
    """Eval mode at dropout 0.1 equals rate 0, in JAX and in the port."""
    params, x, _ = jax_model
    outs = []
    for rate in (0.1, 0.0):
        m = JaxCSwinUnet(backbone=JaxCSWinUNet(**GEOM, drop_rate=rate, attn_impl="xla"))
        outs.append(np.asarray(m.apply(params, jnp.asarray(x), deterministic=True)))
        with torch.inference_mode():
            outs.append(_port_model(params, torch.float32, "fused", rate).eval()(
                torch.from_numpy(x)).numpy())
    assert np.array_equal(outs[0], outs[2]) and np.array_equal(outs[1], outs[3])
    assert _rel_l2(outs[1], outs[0]) <= 1e-4


def _tiny_config(*opts):
    from cswin_unet_tpu_torch.config import get_config

    class _Cfg:
        cfg = "cswin_unet_tpu_torch/configs/cswin_tiny_224_lite.yaml"

    _Cfg.opts = ["MODEL.CSWIN.EMBED_DIM", "16", "MODEL.CSWIN.DEPTH", "[1,1,1,1]",
                 "MODEL.CSWIN.NUM_HEADS", "[2,2,4,8]", "MODEL.CSWIN.SPLIT_SIZE",
                 "[1,2,2,1]", "DATA.IMG_SIZE", "32", "MODEL.DROP_PATH_RATE", "0.2",
                 "MODEL.DROP_RATE", "0.1", *opts]
    return get_config(_Cfg)


@pytest.mark.parametrize("impl", ["plain", "fused"])
def test_use_checkpoint_with_dropout(impl):
    """``--use-checkpoint`` at dropout 0.1 (keys drawn before the recomputed
    region): the loss and every gradient equal those without it."""
    from cswin_unet_tpu_torch.models import build_model

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 1)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 5, (2, 32, 32)).astype(np.int64))
    results = []
    for flag in ("False", "True"):
        model = build_model(_tiny_config("TRAIN.USE_CHECKPOINT", flag), num_classes=5,
                            device="cpu", impl=impl, seed=3, train=True)
        assert model.cswin_unet.drop_rate == 0.1
        loss, _ = segmentation_loss(model(x, generator=torch.Generator().manual_seed(6)), y, 5)
        names, params = zip(*model.named_parameters())
        results.append((loss.detach(), dict(zip(names, torch.autograd.grad(loss, params)))))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
