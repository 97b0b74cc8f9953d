"""Checkpoints in the JAX package's format, and JAX <-> torch parameter names.

The JAX package stores parameters as an ``.npz`` of '/'-joined flat keys
(``params/backbone/stage1_0/qkv/kernel``), with layouts of flax: Dense
kernels (in, out), conv kernels HWIO, LayerNorm ``scale``. The port names its
modules after the reference torch ``state_dict`` (``stage1.0.qkv.weight``)
with torch layouts: Linear (out, in), conv OIHW, LayerNorm ``weight``.
``params_from_jax`` and ``jax_from_params`` map between the two; the second
is the same map as ``cswin_unet_tpu.utils.checkpoint.torch_to_jax``, written
here without JAX.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

SEP = "/"
_PREFIX = f"params{SEP}backbone{SEP}"
# Torch submodules whose parameters sit on their parent in JAX:
# ``attns.0.get_v.weight`` <-> ``attns_0/get_v_kernel``,
# ``upsample2.down.bias`` <-> ``upsample2/down_bias``.
_FOLDED = ("get_v", "down", "encoder", "out")


def flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict -> '/'-joined flat dict."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{SEP}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def unflatten(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split(SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_checkpoint(path: str, state_dict: dict[str, torch.Tensor],
                    extra: dict | None = None) -> str:
    """Write a backbone ``state_dict`` as the JAX package's ``.npz`` (keys
    under ``params/backbone/``). Returns the path written."""
    flat = {_PREFIX + k: v for k, v in jax_from_params(state_dict).items()}
    if extra:
        flat.update({f"__extra__{SEP}{k}": np.asarray(v) for k, v in extra.items()})
    path = path if path.endswith(".npz") else path + ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)
    return path


def load_checkpoint(path: str) -> tuple[dict[str, np.ndarray], dict]:
    """Read a JAX-format ``.npz``. Returns (flat params with backbone-relative
    keys, extra)."""
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    flat, extra = {}, {}
    with np.load(path) as data:
        for k in data.files:
            if k.startswith(f"__extra__{SEP}"):
                extra[k.split(SEP, 1)[1]] = data[k]
            else:
                flat[_strip(k)] = data[k]
    return flat, extra


TRAIN_STATE = "train_state.pt"


def save_train_state(path: str, model: torch.nn.Module, optimizer, scheduler,
                     generator: torch.Generator, iteration: int, epoch: int) -> str:
    """Write what a resumed run needs to continue exactly (the counterpart of
    ``cswin_unet_tpu.utils.checkpoint.save_train_state``, with ``torch.save``
    for orbax): the model's state dict, the optimizer's (SGD momentum
    buffers), the LR scheduler's, the drop-path generator's state, the
    iteration count and the loader epoch to start from. Returns the path."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                "scheduler": scheduler.state_dict(), "generator": generator.get_state(),
                "iteration": int(iteration), "epoch": int(epoch)}, tmp)
    os.replace(tmp, path)  # a run cut while writing leaves the previous state whole
    return path


def train_state_path(path: str) -> str:
    """``path`` itself, or ``TRAIN_STATE`` inside it when it is a directory
    (a run's output directory); raises FileNotFoundError if neither exists."""
    if os.path.isdir(path):
        path = os.path.join(path, TRAIN_STATE)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no train state at {path}")
    return path


def restore_train_state(path: str, model: torch.nn.Module, optimizer, scheduler,
                        generator: torch.Generator) -> tuple[int, int]:
    """Load a ``save_train_state`` file (or a directory holding one) into
    ``model``, ``optimizer``, ``scheduler`` and ``generator`` in place.
    Returns (iteration, epoch to start from)."""
    state = torch.load(train_state_path(path), map_location="cpu", weights_only=True)
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    scheduler.load_state_dict(state["scheduler"])
    generator.set_state(state["generator"])
    return state["iteration"], state["epoch"]


def _strip(key: str) -> str:
    for p in ("params", "backbone"):
        if key.startswith(p + SEP):
            key = key[len(p) + 1:]
    return key


def _torch_layout(leaf: str, val: np.ndarray) -> np.ndarray:
    if leaf.endswith("kernel"):
        if val.ndim == 2:
            return val.T                       # Dense (in, out) -> (out, in)
        if val.ndim == 4:
            return val.transpose(3, 2, 0, 1)   # HWIO -> OIHW
    return val


def _jax_layout(val: np.ndarray) -> np.ndarray:
    if val.ndim == 2:
        return val.T
    if val.ndim == 4:
        return val.transpose(2, 3, 1, 0)       # OIHW -> HWIO
    return val


def _torch_key(jax_key: str) -> str:
    *mods, leaf = _strip(jax_key).split(SEP)
    path = []
    for m in mods:
        if m == "stage1_conv_embed_conv":
            path.append("stage1_conv_embed.0")
        elif m == "stage1_conv_embed_norm":
            path.append("stage1_conv_embed.2")
        elif mt := re.fullmatch(r"(stage_up|stage)(\d)_(\d+)", m):
            path.append(f"{mt[1]}{mt[2]}.{mt[3]}")
        elif mt := re.fullmatch(r"attns_(\d)", m):
            path.append(f"attns.{mt[1]}")
        else:
            path.append(m)
    if mt := re.fullmatch(r"(\w+)_(kernel|bias)", leaf):
        path.append(mt[1])
        leaf = mt[2]
    path.append({"kernel": "weight", "scale": "weight"}.get(leaf, leaf))
    return ".".join(path)


def _jax_key(torch_key: str, ndim: int) -> str:
    parts = torch_key.split(".")
    *mods, leaf = parts
    if leaf == "weight":
        leaf = "scale" if ndim == 1 else "kernel"
    if mods and mods[-1] in _FOLDED:
        leaf = f"{mods.pop()}_{leaf}"
    path, i = [], 0
    while i < len(mods):
        m = mods[i]
        nxt = mods[i + 1] if i + 1 < len(mods) else None
        if m == "stage1_conv_embed":
            path.append("stage1_conv_embed_conv" if nxt == "0" else "stage1_conv_embed_norm")
            i += 2
        elif (re.fullmatch(r"stage_up\d|stage\d", m) or m == "attns") and nxt is not None:
            path.append(f"{m}_{nxt}")
            i += 2
        else:
            path.append(m)
            i += 1
    return SEP.join(path + [leaf])


def params_from_jax(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """JAX flat params (keys with or without ``params/backbone/``) -> the
    port backbone's ``state_dict`` (float32 tensors, torch layouts)."""
    out = {}
    for key, val in flat.items():
        val = np.asarray(val, dtype=np.float32)
        leaf = key.rsplit(SEP, 1)[-1]
        out[_torch_key(key)] = torch.from_numpy(
            np.ascontiguousarray(_torch_layout(leaf, val)))
    return out


def jax_from_params(state_dict: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The port backbone's ``state_dict`` -> JAX flat params (backbone-
    relative keys, flax layouts). Inverse of ``params_from_jax``."""
    out = {}
    for key, val in state_dict.items():
        arr = val.detach().cpu().float().numpy()
        out[_jax_key(key, arr.ndim)] = np.ascontiguousarray(_jax_layout(arr))
    return out


# ---------------------------------------------------------------------------
# the reference's pretrained load (cswin_unet_tpu/utils/checkpoint.py:119-296)
# on the port's names, which are the reference torch state_dict's
# ---------------------------------------------------------------------------

def strip_prefixes(state: dict, prefixes=("module.", "base_model.")) -> dict:
    """Drop DataParallel / PEFT-style key prefixes."""
    out = {}
    for k, v in state.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
        out[k] = v
    return out


def unwrap_envelope(ckpt: dict) -> dict:
    """The state dict inside a ``{"state_dict_ema" | "state_dict" | "model":
    ...}`` envelope, or the checkpoint itself."""
    for key in ("state_dict_ema", "state_dict", "model"):
        if key in ckpt and isinstance(ckpt[key], dict):
            return ckpt[key]
    return ckpt


def load_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A reference ``.pth`` as a flat dict of CPU tensors. The reference's
    files carry more than tensors (its config, optimizer state), so this
    unpickles them in full, as the JAX loader does: load trusted files only."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return {k: torch.as_tensor(v) for k, v in unwrap_envelope(ckpt).items()}


def mirror_encoder_to_decoder(flat: dict) -> dict:
    """Add a ``stage_up*`` copy of every encoder ``stage*`` entry (not the
    stem, ``stage1_conv_embed``) that lacks one: pretrained encoder weights
    seed the mirrored decoder stages."""
    out = dict(flat)
    for k, v in flat.items():
        if (k.startswith("stage") and not k.startswith("stage_up")
                and not k.startswith("stage1_conv_embed")):
            out.setdefault("stage_up" + k[len("stage"):], v)
    return out


def merge_matching(template: dict[str, torch.Tensor], incoming: dict,
                   log=print) -> dict[str, torch.Tensor]:
    """Overlay ``incoming`` onto ``template`` (a state_dict), in the
    template's dtype, dropping unknown keys and logging each shape mismatch
    as the reference does."""
    out = dict(template)
    for k, v in incoming.items():
        if k not in out:
            continue
        v = torch.as_tensor(v)
        if tuple(out[k].shape) == tuple(v.shape):
            out[k] = v.to(out[k].dtype)
        else:
            log(f"delete:{k};shape pretrain:{tuple(v.shape)};shape model:{tuple(out[k].shape)}")
    return out


def load_from_pretrained(model: torch.nn.Module, ckpt_path: str, log=print) -> None:
    """The reference's ``load_from`` onto a backbone in place: the JAX
    package's ``.npz`` (also given as the path without ``.npz``) or a
    reference ``.pth`` (envelope, ``module.`` / ``base_model.`` and
    ``cswin_unet.`` prefixes stripped); encoder weights mirrored onto the
    decoder where the checkpoint has no decoder entry; unknown keys dropped
    and shape mismatches logged and dropped."""
    if ckpt_path.endswith(".npz") or os.path.exists(ckpt_path + ".npz"):
        incoming = params_from_jax(load_checkpoint(ckpt_path)[0])
    else:
        state = strip_prefixes(load_torch_state_dict(ckpt_path))
        incoming = {k[len("cswin_unet."):] if k.startswith("cswin_unet.") else k: v
                    for k, v in state.items()}
    incoming = mirror_encoder_to_decoder(incoming)
    model.load_state_dict(merge_matching(model.state_dict(), incoming, log))


def load_into(model: torch.nn.Module, flat: dict[str, np.ndarray],
              log=print) -> int:
    """Overlay JAX flat params onto ``model`` (a backbone), dropping unknown
    keys and shape mismatches as the JAX loader does. Returns the number of
    tensors loaded."""
    state = model.state_dict()
    loaded = 0
    for k, v in params_from_jax(flat).items():
        if k not in state:
            continue
        if tuple(state[k].shape) != tuple(v.shape):
            log(f"delete:{k};shape pretrain:{tuple(v.shape)};"
                f"shape model:{tuple(state[k].shape)}")
            continue
        state[k] = v
        loaded += 1
    model.load_state_dict(state)
    return loaded
