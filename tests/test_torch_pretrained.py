"""The port's pretrained load against the JAX package's
``load_from_pretrained``.

Both start from the same weights (seeded numpy values in the JAX model's
parameter tree, carried over with ``params_from_jax``) and load the same
file: a pretrain of another seed and another class count (so its
classifier mismatches in shape), without its decoder (``stage_up*``)
entries, as the JAX package's ``.npz``, that ``.npz`` named without its
suffix, and a reference-style ``.pth`` (a ``state_dict`` envelope, keys
under ``module.cswin_unet.``). After the load
the two parameter sets are equal exactly: the decoder seeded from the
encoder, the classifier kept, the mismatch logged as the same ``delete:``
line (up to the port's torch names and layouts).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cswin_unet_tpu.models import CSwinUnet as JaxCSwinUnet
from cswin_unet_tpu.models import CSWinUNet as JaxCSWinUNet
from cswin_unet_tpu.utils import checkpoint as jax_ckpt
from cswin_unet_tpu_torch.models import CSWinUNet
from cswin_unet_tpu_torch.utils import checkpoint as port_ckpt

torch.set_num_threads(2)

GEOM = dict(img_size=64, in_chans=3, embed_dim=32, depth=(1, 1, 1, 1),
            split_size=(1, 2, 2, 2), num_heads=(2, 4, 8, 16))


def _jax_init(num_classes: int, seed: int) -> dict:
    """The JAX model's parameter tree (its shapes from ``eval_shape``, no
    compile) filled with seeded numpy values."""
    m = JaxCSwinUnet(backbone=JaxCSWinUNet(**GEOM, num_classes=num_classes, attn_impl="xla"))
    shapes = jax.eval_shape(m.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32), shapes)


@pytest.fixture(scope="module")
def start():
    """The model's starting weights (4 classes), as a JAX tree."""
    return _jax_init(4, 0)


@pytest.fixture(scope="module")
def pretrain(tmp_path_factory):
    """A 3-class pretrain without its decoder entries: (.npz path, .pth path)."""
    root = tmp_path_factory.mktemp("pretrain")
    flat = {k: np.array(v) for k, v in jax_ckpt.flatten(_jax_init(3, 1)).items()
            if "stage_up" not in k}
    npz = str(root / "encoder_only.npz")
    jax_ckpt.save_checkpoint(npz, jax_ckpt.unflatten(flat))
    state = port_ckpt.params_from_jax(flat)
    assert state and not any(k.startswith("stage_up") for k in state)
    pth = str(root / "encoder_only.pth")
    torch.save({"state_dict": {f"module.cswin_unet.{k}": v for k, v in state.items()},
                "epoch": 3}, pth)
    return npz, pth


def _backbone_state(tree: dict) -> dict:
    return port_ckpt.params_from_jax(
        {k: np.array(v) for k, v in jax_ckpt.flatten(tree).items()})


def _load_both(start: dict, path: str):
    """(JAX result, port result, JAX log, port log): port state_dicts."""
    jax_log, port_log = [], []
    want = _backbone_state(jax_ckpt.load_from_pretrained(start, path, log=jax_log.append))
    backbone = CSWinUNet(**GEOM, num_classes=4)
    backbone.load_state_dict(_backbone_state(start))
    port_ckpt.load_from_pretrained(backbone, path, log=port_log.append)
    return want, backbone.state_dict(), jax_log, port_log


def _assert_same(want: dict, got: dict, start: dict):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # The decoder was seeded from the encoder, not left at its start.
    before = _backbone_state(start)
    moved = [k for k in got if k.startswith("stage_up") and not torch.equal(got[k], before[k])]
    assert moved and all(torch.equal(got[k], got["stage" + k[len("stage_up"):]])
                         for k in moved)
    assert torch.equal(got["output.weight"], before["output.weight"])


@pytest.mark.parametrize("suffix", [".npz", ""])
def test_npz_without_decoder_loads_as_jax(start, pretrain, suffix):
    npz, _ = pretrain
    path = npz[:-len(".npz")] + suffix
    assert suffix or not os.path.exists(path)
    want, got, jax_log, port_log = _load_both(start, path)
    _assert_same(want, got, start)
    assert len(jax_log) == len(port_log) == 1


def test_pth_in_an_envelope_loads_as_jax(start, pretrain):
    _, pth = pretrain
    want, got, jax_log, port_log = _load_both(start, pth)
    _assert_same(want, got, start)
    assert len(jax_log) == len(port_log) == 1


def test_shape_mismatch_logs_the_same_delete_line(start, pretrain):
    """The classifier (3 classes in the file, 4 in the model) is dropped and
    logged once; the port's line is the JAX line with the key and shapes in
    the port's torch names and layouts."""
    npz, _ = pretrain
    _, _, (jax_line,), (port_line,) = _load_both(start, npz)
    key, pre, model = (part.split(":", 1)[1] for part in jax_line.split(";"))
    assert jax_line.startswith("delete:") and port_line.startswith("delete:")

    def torch_shape(shape_txt):
        shape = tuple(int(n) for n in shape_txt.strip("()").split(",") if n.strip())
        (t,) = port_ckpt.params_from_jax({key: np.zeros(shape, np.float32)}).values()
        return tuple(t.shape)

    torch_key = port_ckpt._torch_key(key)
    assert torch_key == "output.weight"
    assert port_line == (f"delete:{torch_key};shape pretrain:{torch_shape(pre)};"
                         f"shape model:{torch_shape(model)}")
