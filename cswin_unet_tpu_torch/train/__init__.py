"""Training: the base trainer (``trainer_synapse``) and its CLI
(``python -m cswin_unet_tpu_torch.train``)."""

from .trainer import make_optimizer, make_train_step, poly_lr, trainer_synapse

__all__ = ["make_optimizer", "make_train_step", "poly_lr", "trainer_synapse"]
