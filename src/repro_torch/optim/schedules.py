"""LR schedules: linear warmup + cosine decay (the production default).

Port of `repro.optim.schedules`: functions of the optimizer's int step
tensor, computed in float32 tensors on its device."""
from __future__ import annotations

import math

import torch


def warmup_cosine(peak_lr: float, *, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clip((step - warmup_steps)
                          / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


def constant(lr_value: float):
    return lambda step: torch.full((), lr_value, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)
