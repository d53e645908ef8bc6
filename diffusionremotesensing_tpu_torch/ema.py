"""Exponential moving average of the parameters with a warm-up copy (port of
``diffusionremotesensing_tpu/ema.py``).

For the first ``warmup`` (2000) optimizer steps the EMA weights are reset to
the online weights; afterwards ema = beta * ema + (1 - beta) * online with
beta = 0.995. ``step`` is the counter before the step's increment, so steps
0 .. warmup-1 copy and step >= warmup decays. The EMA covers the parameters
only; the BatchNorms' running statistics are the online model's.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

EMA_BETA = 0.995
EMA_WARMUP_STEPS = 2000


@torch.no_grad()
def ema_update(ema: List[torch.Tensor], params: List[torch.Tensor], step: int,
               beta: float = EMA_BETA, warmup: int = EMA_WARMUP_STEPS) -> None:
    """One EMA step, in place on ``ema`` (aligned with ``params``): an exact
    copy while ``step < warmup``, else ema * beta + params * (1 - beta), both
    factors float32 as the reference computes them."""
    if step < warmup:
        torch._foreach_copy_(ema, params)
        return
    decay = np.float32(beta)
    torch._foreach_mul_(ema, float(decay))
    torch._foreach_add_(ema, params, alpha=float(np.float32(1.0) - decay))
