"""The port's config system against the JAX package's, key for key.

Each YAML is read by both packages from their own copy, with and without
``--opts`` overrides and the CLI flags ``update_config`` folds in; the
frozen configs must be equal as nested dicts.
"""

import argparse
import os

import pytest

from cswin_unet_tpu import config as jax_config
from cswin_unet_tpu_torch import config as port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = ("cswin_tiny_224_lite.yaml", "cswin_base_384.yaml", "finetune.yaml",
         "finetune2.yaml", "finetune3.yaml")
OPTS = (None,
        ["TPU.ATTN_IMPL", "pallas", "MODEL.CSWIN.DEPTH", "[1,1,1,1]"],
        ["TPU.USE_PALLAS_ATTENTION", "False", "MODEL.DROP_PATH_RATE", "0.0",
         "DATA.IMG_SIZE", "32", "MODEL.NAME", "tiny"])


def _args(pkg: str, yaml: str, opts):
    return argparse.Namespace(cfg=os.path.join(REPO, pkg, "configs", yaml), opts=opts,
                              batch_size=12, zip=False, cache_mode="part",
                              resume=None, accumulation_steps=None,
                              use_checkpoint=True, amp_opt_level="O1", tag="t",
                              eval=False, throughput=False)


@pytest.mark.parametrize("opts", OPTS)
@pytest.mark.parametrize("yaml", YAMLS)
def test_get_config_matches_jax(yaml, opts):
    port = port_config.get_config(_args("cswin_unet_tpu_torch", yaml, opts))
    ref = jax_config.get_config(_args("cswin_unet_tpu", yaml, opts))
    assert port.to_dict() == ref.to_dict()
    assert port.is_frozen()


def test_yaml_copies_are_identical():
    for yaml in YAMLS:
        with open(os.path.join(REPO, "cswin_unet_tpu_torch", "configs", yaml)) as a, \
                open(os.path.join(REPO, "cswin_unet_tpu", "configs", yaml)) as b:
            assert a.read() == b.read(), yaml


def test_defaults_and_opts_rules_match_jax():
    port, ref = port_config.default_config(), jax_config.default_config()
    assert port.to_dict() == ref.to_dict()
    for cfg in (port, ref):
        cfg.merge_from_list(["MODEL.NAME", "123", "DATA.IMG_SIZE", "64",
                             "MODEL.CSWIN.SPLIT_SIZE", "[1,2,2,1]"])
    assert port.to_dict() == ref.to_dict()
    assert port.MODEL.NAME == "123" and port.DATA.IMG_SIZE == 64
    with pytest.raises(ValueError):
        port.merge_from_list(["MODEL.NAME"])


@pytest.mark.parametrize("frozen", [True, False])
def test_clone_is_an_unfrozen_deep_copy(frozen):
    """``clone()`` of a frozen or unfrozen two-level node: equal, unfrozen
    at every depth, independent of the original, which keeps its state.
    (``copy.deepcopy`` used to set the frozen flag before the items.)"""
    node = port_config.CfgNode({"A": 1, "B": {"C": [1, 2], "D": "x"}})
    if frozen:
        node.freeze()
    c = node.clone()
    assert c.to_dict() == node.to_dict()
    assert not c.is_frozen() and not c.B.is_frozen()
    assert node.is_frozen() == frozen and node.B.is_frozen() == frozen
    c.A, c.B.D = 2, "y"
    c.B.C.append(3)
    assert node.to_dict() == {"A": 1, "B": {"C": [1, 2], "D": "x"}}


def test_deepcopy_keeps_the_frozen_state():
    import copy

    node = port_config.CfgNode({"A": {"B": {"C": 1}}})
    node.freeze()
    c = copy.deepcopy(node)
    assert c.to_dict() == node.to_dict() and c.is_frozen() and c.A.B.is_frozen()
    with pytest.raises(AttributeError):
        c.A.B.C = 2


@pytest.mark.parametrize("yaml", YAMLS)
def test_clone_of_a_loaded_config(yaml):
    cfg = port_config.get_config(_args("cswin_unet_tpu_torch", yaml, None))
    c = cfg.clone()
    assert c.to_dict() == cfg.to_dict() and cfg.is_frozen() and not c.is_frozen()
    c.MODEL.CSWIN.EMBED_DIM = 8
    assert cfg.MODEL.CSWIN.EMBED_DIM != 8
