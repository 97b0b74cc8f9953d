"""Hierarchical frozen config system: the port's own copy of the JAX
package's, key for key.

A dict-with-attributes ``CfgNode`` with recursive ``BASE`` YAML inheritance,
``--opts KEY VALUE`` merging and CLI overrides (reference
``config.py:170-224``), without the yacs dependency. Keys, defaults and the
``--opts`` rules are those of ``cswin_unet_tpu.config``, so YAML files and
command lines work the same in both packages; the YAML files themselves
live in ``cswin_unet_tpu_torch/configs/``.
"""

from __future__ import annotations

import ast
import copy
import os
from typing import Any, Iterable

import yaml


class CfgNode(dict):
    """A dict with attribute access, freezing, and recursive merge."""

    _FROZEN = "_is_frozen"

    def __init__(self, init: dict | None = None):
        super().__init__()
        object.__setattr__(self, CfgNode._FROZEN, False)
        if init:
            for k, v in init.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode._FROZEN):
            raise AttributeError(f"CfgNode is frozen; cannot set {name}")
        self[name] = value

    def __setitem__(self, key: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode._FROZEN):
            raise AttributeError(f"CfgNode is frozen; cannot set {key}")
        super().__setitem__(key, value)

    # -- freeze / defrost ---------------------------------------------------
    def freeze(self) -> None:
        object.__setattr__(self, CfgNode._FROZEN, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()

    def defrost(self) -> None:
        object.__setattr__(self, CfgNode._FROZEN, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode._FROZEN)

    # -- merging ------------------------------------------------------------
    def merge_from_dict(self, other: dict) -> None:
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), CfgNode):
                self[k].merge_from_dict(v)
            elif isinstance(v, dict):
                self[k] = CfgNode(v)
            else:
                self[k] = _coerce(v, self.get(k))

    def merge_from_file(self, cfg_file: str) -> None:
        with open(cfg_file) as f:
            data = yaml.safe_load(f) or {}
        # Recursive BASE inheritance, depth-first (reference config.py:175-179).
        for base in data.pop("BASE", [""]) or [""]:
            if base:
                self.merge_from_file(os.path.join(os.path.dirname(cfg_file), base))
        self.merge_from_dict(data)

    def merge_from_list(self, opts: Iterable[str]) -> None:
        opts = list(opts)
        if len(opts) % 2 != 0:
            raise ValueError(f"--opts must be KEY VALUE pairs, got {opts}")
        for key, value in zip(opts[::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            node[parts[-1]] = _coerce(value, node.get(parts[-1]))

    def clone(self) -> "CfgNode":
        c = copy.deepcopy(self)
        c.defrost()
        return c

    def to_dict(self) -> dict:
        return {
            k: v.to_dict() if isinstance(v, CfgNode) else v for k, v in self.items()
        }

    def dump(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=False)


def _coerce(value: Any, old: Any) -> Any:
    """Parse string CLI values into python literals where sensible."""
    if not isinstance(value, str):
        return value
    try:
        lit = ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value
    if old is not None and isinstance(old, str):
        return value
    return lit


# ---------------------------------------------------------------------------
# Defaults — same keys/values as reference config.py:6-167 so YAML configs and
# ``--opts`` command lines from the reference work unchanged.
# ---------------------------------------------------------------------------

def default_config() -> CfgNode:
    c = CfgNode()
    c.BASE = [""]

    c.DATA = CfgNode()
    c.DATA.BATCH_SIZE = 128
    c.DATA.DATA_PATH = ""
    c.DATA.DATASET = "imagenet"
    c.DATA.IMG_SIZE = 224
    c.DATA.INTERPOLATION = "bicubic"
    c.DATA.ZIP_MODE = False
    c.DATA.CACHE_MODE = "part"
    c.DATA.PIN_MEMORY = True
    c.DATA.NUM_WORKERS = 8

    c.MODEL = CfgNode()
    c.MODEL.TYPE = "cswin"
    c.MODEL.NAME = "cswin_tiny_224"
    c.MODEL.PRETRAIN_CKPT = "./pretrained_ckpt/cswin_tiny_224.pth"
    c.MODEL.RESUME = ""
    c.MODEL.NUM_CLASSES = 1000
    c.MODEL.DROP_RATE = 0.0
    c.MODEL.DROP_PATH_RATE = 0.1
    c.MODEL.LABEL_SMOOTHING = 0.1

    c.MODEL.CSWIN = CfgNode()
    c.MODEL.CSWIN.PATCH_SIZE = 4
    c.MODEL.CSWIN.IN_CHANS = 3
    c.MODEL.CSWIN.EMBED_DIM = 64
    c.MODEL.CSWIN.DEPTH = [1, 2, 9, 1]
    c.MODEL.CSWIN.NUM_HEADS = [2, 4, 8, 16]
    c.MODEL.CSWIN.SPLIT_SIZE = [1, 2, 7, 7]
    c.MODEL.CSWIN.MLP_RATIO = 4.0
    c.MODEL.CSWIN.QKV_BIAS = True
    c.MODEL.CSWIN.QK_SCALE = None
    c.MODEL.CSWIN.APE = False
    c.MODEL.CSWIN.PATCH_NORM = True

    c.TRAIN = CfgNode()
    c.TRAIN.START_EPOCH = 0
    c.TRAIN.EPOCHS = 300
    c.TRAIN.WARMUP_EPOCHS = 20
    c.TRAIN.WEIGHT_DECAY = 0.05
    c.TRAIN.BASE_LR = 5e-4
    c.TRAIN.WARMUP_LR = 5e-7
    c.TRAIN.MIN_LR = 5e-6
    c.TRAIN.CLIP_GRAD = 5.0
    c.TRAIN.AUTO_RESUME = True
    c.TRAIN.ACCUMULATION_STEPS = 0
    c.TRAIN.USE_CHECKPOINT = False  # remat (jax.checkpoint) per block

    c.TRAIN.LR_SCHEDULER = CfgNode()
    c.TRAIN.LR_SCHEDULER.NAME = "cosine"
    c.TRAIN.LR_SCHEDULER.DECAY_EPOCHS = 30
    c.TRAIN.LR_SCHEDULER.DECAY_RATE = 0.1

    c.TRAIN.OPTIMIZER = CfgNode()
    c.TRAIN.OPTIMIZER.NAME = "adamw"
    c.TRAIN.OPTIMIZER.EPS = 1e-8
    c.TRAIN.OPTIMIZER.BETAS = (0.9, 0.999)
    c.TRAIN.OPTIMIZER.MOMENTUM = 0.9

    c.AUG = CfgNode()
    c.AUG.COLOR_JITTER = 0.4
    c.AUG.AUTO_AUGMENT = "rand-m9-mstd0.5-inc1"
    c.AUG.REPROB = 0.25
    c.AUG.REMODE = "pixel"
    c.AUG.RECOUNT = 1
    c.AUG.MIXUP = 0.8
    c.AUG.CUTMIX = 1.0
    c.AUG.CUTMIX_MINMAX = None
    c.AUG.MIXUP_PROB = 1.0
    c.AUG.MIXUP_SWITCH_PROB = 0.5
    c.AUG.MIXUP_MODE = "batch"

    c.TEST = CfgNode()
    c.TEST.CROP = True

    c.AMP_OPT_LEVEL = ""
    c.OUTPUT = ""
    c.TAG = "default"
    c.SAVE_FREQ = 1
    c.PRINT_FREQ = 10
    c.SEED = 0
    c.EVAL_MODE = False
    c.THROUGHPUT_MODE = False
    c.LOCAL_RANK = 0

    # --- extensions absent in the reference (the section keeps the JAX
    # package's name, so its YAML files and --opts lines carry over) ---
    c.TPU = CfgNode()
    c.TPU.COMPUTE_DTYPE = "bfloat16"   # activation compute dtype
    c.TPU.PARAM_DTYPE = "float32"      # parameter storage dtype
    # Attention/block implementation: 'fused' (the whole block as a kernel
    # chain), 'pallas' (the composed block with the stripe-attention kernel
    # per branch), or 'xla' (plain composition everywhere); the port's
    # build_model maps these to its routes 'fused', 'pallas' and 'plain'.
    c.TPU.ATTN_IMPL = "fused"
    c.TPU.USE_PALLAS_ATTENTION = True  # legacy alias: False forces 'xla'
    c.TPU.MESH_DATA_AXIS = -1          # -1: all visible devices on the data axis
    return c


def update_config(config: CfgNode, args) -> None:
    """Merge file + opts + known CLI args (reference config.py:185-214)."""
    if getattr(args, "cfg", None):
        config.merge_from_file(args.cfg)
    if getattr(args, "opts", None):
        config.merge_from_list(args.opts)
    if getattr(args, "batch_size", None):
        config.DATA.BATCH_SIZE = args.batch_size
    if getattr(args, "zip", False):
        config.DATA.ZIP_MODE = True
    if getattr(args, "cache_mode", None):
        config.DATA.CACHE_MODE = args.cache_mode
    if getattr(args, "resume", None):
        config.MODEL.RESUME = args.resume
    if getattr(args, "accumulation_steps", None):
        config.TRAIN.ACCUMULATION_STEPS = args.accumulation_steps
    if getattr(args, "use_checkpoint", False):
        config.TRAIN.USE_CHECKPOINT = True
    if getattr(args, "amp_opt_level", None):
        config.AMP_OPT_LEVEL = args.amp_opt_level
    if getattr(args, "tag", None):
        config.TAG = args.tag
    if getattr(args, "eval", False):
        config.EVAL_MODE = True
    if getattr(args, "throughput", False):
        config.THROUGHPUT_MODE = True
    config.freeze()


def get_config(args) -> CfgNode:
    """Build the frozen config for a CLI invocation (reference config.py:217-224)."""
    config = default_config()
    update_config(config, args)
    return config
