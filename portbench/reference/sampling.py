"""The noise schedule and the DDIM sampler, plainly.

* cosine schedule (Nichol & Dhariwal, s = 0.008) in float32:
  alpha_hat_t = f(t) / f(0), as the reference repository computes it;
* DDIM (Song et al., arXiv:2010.02502) at eta = 0 over the linear
  subsequence round(linspace(1, T-1, steps)), de-duplicated, descending;
  the last step lands on alpha_hat = 1. With ``clip_x0`` each step's x0
  prediction is clamped to [0, 1] and the noise prediction recomputed from
  it;
* classifier-free guidance at scale s: eps_u + s (eps_c - eps_u), the
  label embedding masked to 0 for the unconditioned half.
"""

from __future__ import annotations

import numpy as np
import torch


def cosine_alpha_hat(steps: int, s: float = 0.008) -> np.ndarray:
    t = np.arange(steps, dtype=np.float32)
    f = np.cos((((t / np.float32(steps)) + np.float32(s)) / (1.0 + np.float32(s)))
               * np.float32(np.pi) / 2.0, dtype=np.float32) ** 2
    return (f / f[0]).astype(np.float32)


def alpha_hat(schedule: str, steps: int) -> np.ndarray:
    if schedule != "cosine":
        raise ValueError(f"the reference holds the cosine schedule, not {schedule!r}")
    return cosine_alpha_hat(steps)


def ddim_timesteps(noise_steps: int, steps: int) -> np.ndarray:
    grid = np.linspace(1, noise_steps - 1, steps)
    return np.unique(grid.round().astype(np.int64))[::-1].copy()


def ddim(eps_fn, x_T: torch.Tensor, ah: np.ndarray, steps: int, clip_x0: bool = True):
    """x0 from x_T (B, H, W, C) by DDIM at eta = 0; ``eps_fn(x, t)`` with t a
    (B,) float tensor."""
    ts = ddim_timesteps(len(ah), steps)
    x = x_T.float()
    for t, t_prev in zip(ts, list(ts[1:]) + [0]):
        a = float(ah[t])
        a_prev = float(ah[t_prev]) if t_prev > 0 else 1.0
        eps = eps_fn(x, torch.full((x.shape[0],), float(t), device=x.device))
        x0 = (x - np.sqrt(1.0 - a) * eps) / np.sqrt(a)
        if clip_x0:
            x0 = x0.clamp(0.0, 1.0)
            eps = (x - np.sqrt(a) * x0) / np.sqrt(1.0 - a)
        x = np.sqrt(a_prev) * x0 + np.sqrt(max(1.0 - a_prev, 0.0)) * eps
    return x


def guided(model, labels: torch.Tensor, scale: float):
    """eps_fn of classifier-free guidance over ``labels`` (B,)."""
    n = labels.shape[0]
    lab2 = torch.cat([labels, labels])
    mask = torch.cat([torch.ones(n), torch.zeros(n)]).to(labels.device)

    def eps(x, t):
        e = model(torch.cat([x, x]), torch.cat([t, t]), lab2, mask)
        return e[n:] + scale * (e[:n] - e[n:])
    return eps
