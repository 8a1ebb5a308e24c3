"""LR schedules.

PyTorch counterpart of ``repro/optim/schedule.py``: the same formula in
f32, so the learning rate is 0 at step 0 during warmup."""
from __future__ import annotations

import math
from typing import Union

import torch


def cosine_schedule(step: Union[int, torch.Tensor], *, peak_lr: float,
                    warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then cosine decay to
    ``min_ratio * peak_lr`` at ``total_steps``; a 0-d f32 tensor on the
    step's device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    frac = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    frac = frac.clamp(0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio)
                     * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup_steps, warm, cos)
