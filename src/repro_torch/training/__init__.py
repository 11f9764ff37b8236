"""Training path of the port (counterpart of ``repro.training``): the LM
loss, AdamW as the reference computes it, gradient compression with
error feedback, and the fault-tolerant train loop."""
from repro_torch.training.optimizer import (
    AdamWState,
    OptimizerConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    lr_schedule,
)
from repro_torch.training.loss import lm_loss

__all__ = ["AdamWState", "OptimizerConfig", "adamw_init", "adamw_update",
           "clip_by_global_norm", "lm_loss", "lr_schedule"]
