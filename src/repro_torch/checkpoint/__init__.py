"""Sharded async checkpointing (port of `repro.checkpoint`)."""
from repro_torch.checkpoint.checkpointer import (AsyncCheckpointer,
                                                 CheckpointCorruptionError,
                                                 latest_step, restore, save)

__all__ = ["AsyncCheckpointer", "CheckpointCorruptionError", "latest_step",
           "restore", "save"]
