"""Checkpoints of the port, in the reference's on-disk format
(counterpart of ``repro.checkpointing``)."""
from repro_torch.checkpointing.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    restore,
    save,
)

__all__ = ["AsyncCheckpointer", "latest_step", "restore", "save"]
