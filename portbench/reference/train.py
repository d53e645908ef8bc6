"""The super-resolution training step, plainly.

x_t = sqrt(alpha_hat_t) x0 + sqrt(1 - alpha_hat_t) noise; the UNet's
training forward (batch-statistic BatchNorms); the mean squared error
against the noise; autograd; Adam (betas 0.9, 0.999, eps 1e-8, no
weight decay, bias-corrected); the EMA of the parameters, which copies
them for the first 2000 steps and then decays, ema = beta ema + (1 - beta)
p. The unused skip convs get a zero gradient and so do not move.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from portbench.reference.downblur import downblur
from portbench.reference.precision import float32
from portbench.reference.unet import UNet, trainable

BETAS, EPS = (0.9, 0.999), 1e-8
EMA_WARMUP = 2000


def steps(params: Dict[str, torch.Tensor], shapes, feed: List[dict], ah: np.ndarray, lr: float,
          mag: int, blur: float, q: Callable = float32, step0: int = 0, beta: float = 0.995):
    """Follow ``feed`` (dicts of 'hr_u8', 't', 'noise') from ``params``,
    fresh Adam moments and the EMA a copy of ``params``; ``step0`` is the
    count of steps taken before (the EMA decays from step ``EMA_WARMUP``
    on). Returns each step's loss, the gradients of the first step, and
    the parameters and EMA after the last, by name (trainable ones)."""
    names = trainable(shapes)
    p = {n: v.detach().float().clone() for n, v in params.items()}
    m = {n: torch.zeros_like(p[n]) for n in names}
    v = {n: torch.zeros_like(p[n]) for n in names}
    ema = {n: p[n].clone() for n in names}
    ah_t = torch.from_numpy(ah)
    losses, first_grads = [], None
    for k, b in enumerate(feed, start=1):
        for n in names:
            p[n].requires_grad_(True)
        x0, cond = downblur(b["hr_u8"], mag, blur)
        a = ah_t.to(x0.device)[b["t"]][:, None, None, None]
        x_t = torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * b["noise"]
        out = UNet(p, "superres", mag, q)(x_t, b["t"], cond, train=True)
        loss = ((out - b["noise"]) ** 2).mean()
        grads = torch.autograd.grad(loss, [p[n] for n in names], allow_unused=True)
        grads = {n: (g if g is not None else torch.zeros_like(p[n])) for n, g in zip(names, grads)}
        losses.append(float(loss.detach()))
        if first_grads is None:
            first_grads = {n: g.detach().clone() for n, g in grads.items()}
        with torch.no_grad():
            for n in names:
                g = grads[n]
                p[n] = p[n].detach()
                m[n].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v[n].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                mhat = m[n] / (1 - BETAS[0] ** k)
                vhat = v[n] / (1 - BETAS[1] ** k)
                p[n] = p[n] - lr * mhat / (torch.sqrt(vhat) + EPS)
                if step0 + k - 1 < EMA_WARMUP:
                    ema[n] = p[n].clone()
                else:
                    ema[n] = ema[n] * beta + p[n] * (1.0 - beta)
    return losses, first_grads, {n: p[n].detach() for n in names}, ema
