"""Model wrapper and factory: config -> model on a device.

Counterpart of ``cswin_unet_tpu.models.wrapper`` (reference ``CSwinUnet``,
networks/vision_transformer.py): repeats 1-channel CT slices to 3 channels
before the backbone. The backbone sits under ``cswin_unet``, the reference's
attribute name, so full-model ``state_dict`` keys match reference ``.pth``
files.
"""

from __future__ import annotations

import torch
from torch import nn

from .cswin_unet import CSWinUNet
from .initializers import init_weights


class CSwinUnet(nn.Module):
    """(B, H, W, 1|3) NHWC in; logits (B, H, W, num_classes) or labels out."""

    def __init__(self, backbone: CSWinUNet):
        super().__init__()
        self.cswin_unet = backbone

    def forward(self, x: torch.Tensor, emit: str = "logits",
                generator: torch.Generator | None = None) -> torch.Tensor:
        if x.shape[-1] == 1:
            x = x.expand(*x.shape[:-1], 3)
        return self.cswin_unet(x, emit=emit, generator=generator)


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


# The JAX package's TPU.ATTN_IMPL values -> the port's routes.
_ROUTES = {"fused": "fused", "pallas": "pallas", "xla": "plain"}


def build_model(config, img_size: int | None = None, num_classes: int = 9, *,
                device: torch.device | str, dtype: torch.dtype | None = None,
                impl: str | None = None, seed: int = 0,
                train: bool = False) -> CSwinUnet:
    """Build the model from a frozen config, with weights drawn from
    ``torch.Generator().manual_seed(seed)`` on the CPU, moved to ``device``
    and set to eval mode, or with ``train=True`` to train mode with the
    config's ``MODEL.DROP_PATH_RATE``. Parameters are float32; activations
    run in ``dtype`` (default ``config.TPU.COMPUTE_DTYPE``). ``impl`` picks
    the route; by default the config does, as the JAX ``build_model`` does
    (``cswin_unet_tpu/models/wrapper.py:45-49``): ``USE_PALLAS_ATTENTION``
    False gives ``plain``, ``ATTN_IMPL`` fused / pallas / xla gives fused /
    pallas / plain. ``TRAIN.USE_CHECKPOINT`` recomputes each block's forward
    in the backward. ``MODEL.DROP_RATE`` must be 0: the port has no dropout
    (every config has 0)."""
    if config.MODEL.DROP_RATE:
        raise NotImplementedError(
            f"MODEL.DROP_RATE={config.MODEL.DROP_RATE}: dropout is not ported (the JAX "
            "model applies it after the patch embedding and in each block's MLP, "
            "cswin_unet_tpu/models/cswin_unet.py:415,490)")
    cs = config.MODEL.CSWIN
    if dtype is None:
        dtype = _DTYPES[config.TPU.COMPUTE_DTYPE]
    if impl is None:
        impl = (_ROUTES[config.TPU.get("ATTN_IMPL", "fused")]
                if config.TPU.USE_PALLAS_ATTENTION else "plain")
    with torch.device("meta"):
        backbone = CSWinUNet(
            img_size=img_size or config.DATA.IMG_SIZE,
            in_chans=cs.IN_CHANS,
            num_classes=num_classes,
            embed_dim=cs.EMBED_DIM,
            depth=tuple(cs.DEPTH),
            split_size=tuple(cs.SPLIT_SIZE),
            num_heads=tuple(cs.NUM_HEADS),
            mlp_ratio=cs.MLP_RATIO,
            qkv_bias=cs.QKV_BIAS,
            qk_scale=cs.QK_SCALE,
            drop_path_rate=config.MODEL.DROP_PATH_RATE if train else 0.0,
            dtype=dtype,
            impl=impl,
            use_checkpoint=bool(config.TRAIN.USE_CHECKPOINT),
        )
        model = CSwinUnet(backbone)
    model.to_empty(device="cpu")
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).train(train)
