"""DDPM noise schedules (port of ``diffusionremotesensing_tpu/schedules.py``).

* ``linear``: beta = linspace(beta_start, beta_end, T) in float64, then
  float32; alpha = 1 - beta; alpha_hat = cumprod(alpha).
* ``cosine`` (Nichol & Dhariwal, s = 0.008), computed in float32:
  alpha_hat_t = f(t)/f(0), beta recovered as 1 - alpha_hat_t/alpha_hat_{t-1}
  with beta_0 = 1 - alpha_hat_0, NOT clipped at 0.999 (the reference's
  quirk, kept).

The tables are built with numpy exactly as the reference builds them and
only then become float32 tensors, so they equal the JAX tables bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Schedule(NamedTuple):
    """Per-timestep schedule tables, each a float32 tensor of shape (T,)."""

    beta: torch.Tensor
    alpha: torch.Tensor
    alpha_hat: torch.Tensor

    @property
    def noise_steps(self) -> int:
        return int(self.beta.shape[0])


def linear_beta(noise_steps: int, beta_start: float = 1e-4, beta_end: float = 0.02) -> np.ndarray:
    return np.linspace(beta_start, beta_end, noise_steps, dtype=np.float64)


def cosine_alpha_hat(noise_steps: int, s: float = 0.008) -> np.ndarray:
    """Cosine alpha_hat in float32 arithmetic (the beta recovery near t = T
    amplifies any precision mismatch, so the dtype is part of the contract)."""
    t = np.arange(noise_steps, dtype=np.float32)
    f_t = np.cos((((t / np.float32(noise_steps)) + np.float32(s)) / (1.0 + np.float32(s)))
                 * np.float32(np.pi) / 2.0, dtype=np.float32) ** 2
    return (f_t / f_t[0]).astype(np.float32)


def beta_from_alpha_hat(alpha_hat: np.ndarray) -> np.ndarray:
    """beta_t = 1 - alpha_hat_t / alpha_hat_{t-1}, beta_0 = 1 - alpha_hat_0, unclipped."""
    alpha_hat = np.asarray(alpha_hat)
    beta = np.empty_like(alpha_hat)
    beta[0] = 1.0 - alpha_hat[0]
    beta[1:] = 1.0 - alpha_hat[1:] / alpha_hat[:-1]
    return beta


def make_schedule(noise_schedule: str, noise_steps: int, beta_start: float = 1e-4,
                  beta_end: float = 0.02, device="cpu") -> Schedule:
    """The (beta, alpha, alpha_hat) triple for 'linear' or 'cosine'."""
    if noise_schedule == "linear":
        beta = linear_beta(noise_steps, beta_start, beta_end)
        alpha = 1.0 - beta
        alpha_hat = np.cumprod(alpha)
    elif noise_schedule == "cosine":
        alpha_hat = cosine_alpha_hat(noise_steps)
        beta = beta_from_alpha_hat(alpha_hat)
        alpha = 1.0 - beta
    else:
        raise ValueError("The noise schedule must be either 'linear' or 'cosine'")

    def f32(a):
        return torch.from_numpy(np.asarray(a).astype(np.float32)).to(device)

    return Schedule(beta=f32(beta), alpha=f32(alpha), alpha_hat=f32(alpha_hat))
