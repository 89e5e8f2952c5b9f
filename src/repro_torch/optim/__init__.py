"""Optimizers and distributed-optimization helpers (port of `repro.optim`)."""
from repro_torch.optim.adamw import AdamW, AdamWState, adamw, global_norm
from repro_torch.optim.schedules import constant, warmup_cosine
from repro_torch.optim.compression import (CompressionState, compress_grads,
                                           init_state as init_compression_state)

__all__ = ["AdamW", "AdamWState", "adamw", "global_norm", "constant",
           "warmup_cosine", "CompressionState", "compress_grads",
           "init_compression_state"]
