"""LR schedules (pure functions of the step counter).

Port of ``repro/optim/schedule.py``.  The step may be a Python number or
a tensor (a device scalar stays on its device: no host read).  Note that
the warmup factor is step / warmup, so step 0 gives 0 for any warmup.
"""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup: int = 100, total: int = 10_000,
                  floor: float = 0.1):
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return warm * (floor + (1.0 - floor) * cos)
