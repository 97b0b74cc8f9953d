"""Training: the base trainer (``trainer_synapse``) and its CLI
(``python -m cswin_unet_tpu_torch.train``); surgical fine-tuning, TPGM and
the continual trainer (CLIs ``python -m cswin_unet_tpu_torch.finetune`` and
``python -m cswin_unet_tpu_torch.universal_train``)."""

from .continual import (PositiveSamplingDataset, get_stage_info, map_new_dataset_labels,
                        trainer_continual_surgical_tpgm)
from .surgical import (SurgicalOptimizer, get_lr_weights, normalize_weights,
                       surgical_layer_names)
from .tpgm import TPGMTrainer, init_constraints, project, ratio_stats
from .trainer import make_optimizer, make_train_step, poly_lr, trainer_synapse

__all__ = [
    "trainer_synapse",
    "make_optimizer",
    "make_train_step",
    "poly_lr",
    "TPGMTrainer",
    "init_constraints",
    "project",
    "ratio_stats",
    "SurgicalOptimizer",
    "get_lr_weights",
    "normalize_weights",
    "surgical_layer_names",
    "PositiveSamplingDataset",
    "get_stage_info",
    "map_new_dataset_labels",
    "trainer_continual_surgical_tpgm",
]
