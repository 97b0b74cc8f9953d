"""The system under test, as the benchmark reaches it: the port's own
entry points (``models.build_model``, ``serve.VolumeServer``,
``train.trainer.make_optimizer`` / ``make_train_step``) and its kernels'
launch counters. Nothing else in ``port_bench`` imports the port, and the
plain reference imports none of it.
"""

from __future__ import annotations

import torch


def port_config(cfg: dict):
    """The port's frozen config for a configuration file's sizes."""
    from cswin_unet_tpu_torch.config import default_config

    c = default_config()
    cs = c.MODEL.CSWIN
    cs.EMBED_DIM, cs.DEPTH = cfg["embed_dim"], list(cfg["depths"])
    cs.NUM_HEADS, cs.SPLIT_SIZE = list(cfg["num_heads"]), list(cfg["split_size"])
    cs.MLP_RATIO, cs.QKV_BIAS, cs.IN_CHANS = cfg["mlp_ratio"], cfg["qkv_bias"], cfg["in_chans"]
    c.MODEL.DROP_PATH_RATE = cfg["drop_path_rate"]
    c.MODEL.DROP_RATE = 0.0
    c.DATA.IMG_SIZE = cfg["img_size"]
    c.TPU.COMPUTE_DTYPE = cfg["compute_dtype"]
    c.freeze()
    return c


def build_model(cfg: dict, weights: dict, device, *, train: bool):
    """``models.build_model`` at the configuration, then the benchmark's
    weights loaded into it (every key, every shape)."""
    from cswin_unet_tpu_torch.models import build_model as build

    model = build(port_config(cfg), img_size=cfg["img_size"],
                  num_classes=cfg["num_classes"], device=device, train=train)
    model.load_state_dict(weights, strict=True)
    return model


def volume_server(model, device, img_size: int, batch_slices: int):
    from cswin_unet_tpu_torch.serve import VolumeServer

    return VolumeServer(model, device=device, img_size=img_size, batch_slices=batch_slices)


def train_step(model, traffic: dict, num_classes: int):
    """(step, optimizer): the trainer's SGD and poly schedule and its
    ``make_train_step``."""
    from cswin_unet_tpu_torch.train.trainer import make_optimizer, make_train_step

    optimizer, scheduler = make_optimizer(
        model.parameters(), traffic["base_lr"], traffic["max_iterations"],
        momentum=traffic["momentum"], weight_decay=traffic["weight_decay"])
    return make_train_step(model, optimizer, scheduler, num_classes), optimizer


class Launches:
    """The kernels' launch counters between ``start()`` and ``stop()``:
    by wrapper, and the device kernels they make."""

    def __init__(self):
        from cswin_unet_tpu_torch.ops.cuda import kernels

        self._k = kernels
        self.counts: dict = {}
        self.device = 0

    def start(self) -> None:
        self._c0, self._d0 = self._k.launch_counts(), self._k.device_launches()

    def stop(self) -> None:
        c1 = self._k.launch_counts()
        self.counts = {k: c1[k] - self._c0.get(k, 0) for k in c1}
        self.device = self._k.device_launches() - self._d0


def free(device: torch.device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
