"""Reverse diffusion: the ancestral DDPM and DDIM samplers (port of
``diffusionremotesensing_tpu/diffusion.py``).

* ancestral step, for i = T-1 .. 1:
  x <- (x - (1-alpha_i)/sqrt(1-alpha_hat_i) * eps_hat) / sqrt(alpha_i) + sqrt(beta_i) z,
  with z = 0 at i == 1;
* DDIM at eta = 0 (deterministic) over a linear subsequence of [1, T-1],
  with the optional per-step clamp of the x0 prediction to [0, 1]
  (``clip_x0``); one step is anchored at T-1.

The reference runs the loop as one compiled ``lax.scan``; here it is a
Python loop of eager steps under ``torch.inference_mode``. The per-step
schedule coefficients are computed on the host in float32, as the reference
computes them on the device in float32, and enter the tensor ops as scalars.
Noise comes from a ``torch.Generator`` (another stream than JAX's threefry;
``noise_fn`` injects noise, in the original layout, for tests). With
``fused_update=True`` the ancestral step and its noise draw are one call of
``ops.fused_update.ancestral_update`` (a CUDA kernel on the card), whose
in-kernel generator gives another noise stream again: opt-in, as in the
reference.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional

import numpy as np
import torch

from diffusionremotesensing_tpu_torch.ops.fused_update import (
    ancestral_update,
    draw_seed,
    update_coefs,
)
from diffusionremotesensing_tpu_torch.ops.s2d import depth_to_space, space_to_depth
from diffusionremotesensing_tpu_torch.schedules import Schedule, make_schedule


def _ddpm_coefs(schedule: Schedule, t: int):
    a, ah, b = schedule.alpha[t], schedule.alpha_hat[t], schedule.beta[t]
    return float((1.0 - a) / torch.sqrt(1.0 - ah)), float(torch.sqrt(a)), float(torch.sqrt(b))


def ddpm_step(schedule: Schedule, x: torch.Tensor, eps_hat: torch.Tensor, t: int,
              noise: torch.Tensor) -> torch.Tensor:
    """One ancestral step at integer timestep t (noise already zero at t == 1)."""
    coef, sqrt_a, sqrt_b = _ddpm_coefs(schedule, t)
    return (x - coef * eps_hat) / sqrt_a + sqrt_b * noise


def _noise(noise_fn, generator, i, shape, like, enc):
    if noise_fn is not None:
        z = noise_fn(i, shape).to(device=like.device, dtype=like.dtype)
    else:
        z = torch.randn(shape, generator=generator, device=like.device, dtype=like.dtype)
    return enc(z) if enc is not None else z


def _hoisted(encode_cond_fn, prepare_fn, cond):
    feats = encode_cond_fn(cond) if encode_cond_fn is not None and cond is not None else None
    aux = prepare_fn() if prepare_fn is not None else None
    return feats, aux


def make_sampler(apply_fn: Callable, schedule: Schedule, *,
                 encode_cond_fn: Optional[Callable] = None,
                 prepare_fn: Optional[Callable] = None,
                 state_codec: Optional[tuple] = None,
                 fused_update: bool = False):
    """Ancestral sampler over t = T-1 .. 1.

    ``apply_fn(x, t, cond, cond_features, aux) -> eps_hat``; the condition
    stem ``encode_cond_fn(cond)`` and ``prepare_fn()`` (the s2d kernels) run
    once per call, outside the loop. ``state_codec=(encode, decode)`` keeps
    the state in another layout for the whole loop (s2d execution).

    ``fused_update=True`` runs each step's update and noise draw as one
    ``ancestral_update`` call, its noise drawn in the state's layout from a
    generator keyed once per call from ``generator`` (no synchronisation per
    step); ``bits_fn(i, state_shape) -> (2, *state_shape) int32`` then
    replaces that generator's words, for tests.

    Returns ``sample(x_T, cond=None, generator=None, noise_fn=None,
    bits_fn=None) -> x0`` (``noise_fn`` for the unfused update only,
    ``bits_fn`` for the fused one)."""
    T = schedule.noise_steps
    enc, dec = state_codec if state_codec is not None else (None, None)
    coefs = [update_coefs(schedule, i) if i > 0 else None for i in range(T)] if fused_update else None

    @torch.inference_mode()
    def sample(x_T, cond=None, generator=None, noise_fn=None, bits_fn=None):
        if fused_update and noise_fn is not None:
            raise ValueError("noise_fn applies to the unfused update; the fused one takes bits_fn")
        if not fused_update and bits_fn is not None:
            raise ValueError("bits_fn applies to the fused update (fused_update=True)")
        feats, aux = _hoisted(encode_cond_fn, prepare_fn, cond)
        n = x_T.shape[0]
        x = enc(x_T) if enc is not None else x_T
        seed = draw_seed(generator, x.device) if fused_update and bits_fn is None else None
        for i in range(T - 1, 0, -1):
            t = torch.full((n,), float(i), device=x.device)
            eps_hat = apply_fn(x, t, cond, feats, aux)
            if fused_update:
                bits = bits_fn(i, tuple(x.shape)).to(x.device) if bits_fn is not None else None
                x = ancestral_update(x.contiguous(), eps_hat.contiguous(), coefs[i], seed, i, bits)
                continue
            if i > 1:
                z = _noise(noise_fn, generator, i, x_T.shape, x, enc)
            else:
                z = torch.zeros_like(x)
            x = ddpm_step(schedule, x, eps_hat, i, z)
        return dec(x) if dec is not None else x

    return sample


def ddim_timesteps(noise_steps: int, num_steps: int) -> np.ndarray:
    """Descending linear subsequence of [1, T-1]; one step sits at T-1."""
    t_start = noise_steps - 1
    grid = np.asarray([t_start], np.float64) if num_steps == 1 else np.linspace(1, t_start, num_steps)
    return np.unique(grid.round().astype(np.int64))[::-1].copy()


def make_ddim_sampler(apply_fn: Callable, schedule: Schedule, num_steps: int, *,
                      clip_x0: bool = False,
                      encode_cond_fn: Optional[Callable] = None,
                      prepare_fn: Optional[Callable] = None,
                      state_codec: Optional[tuple] = None):
    """Deterministic DDIM sampler (Song et al., arXiv:2010.02502, eta = 0) with
    ``num_steps`` model evaluations over a linear subsequence; the last step
    lands on t_prev = 0, where alpha_hat is taken as 1. Arguments as
    :func:`make_sampler`; returns ``sample(x_T, cond=None, generator=None) ->
    x0``, whose ``generator`` is unused (no noise is drawn) and kept so that
    both samplers take the same call."""
    taus = ddim_timesteps(schedule.noise_steps, num_steps)
    taus_prev = np.concatenate([taus[1:], [0]])
    enc, dec = state_codec if state_codec is not None else (None, None)
    one = torch.ones((), dtype=torch.float32)

    @torch.inference_mode()
    def sample(x_T, cond=None, generator=None):
        feats, aux = _hoisted(encode_cond_fn, prepare_fn, cond)
        n = x_T.shape[0]
        x = enc(x_T) if enc is not None else x_T
        for t, t_prev in zip(taus.tolist(), taus_prev.tolist()):
            eps_hat = apply_fn(x, torch.full((n,), float(t), device=x.device), cond, feats, aux)
            ah = schedule.alpha_hat[t]
            ah_prev = schedule.alpha_hat[t_prev] if t_prev > 0 else one
            x0_pred = (x - float(torch.sqrt(1.0 - ah)) * eps_hat) / float(torch.sqrt(ah))
            if clip_x0:
                x0_pred = x0_pred.clamp(0.0, 1.0)
                eps_hat = (x - float(torch.sqrt(ah)) * x0_pred) / float(torch.sqrt(1.0 - ah))
            x = float(torch.sqrt(ah_prev)) * x0_pred + float(torch.sqrt(1.0 - ah_prev)) * eps_hat
        return dec(x) if dec is not None else x

    return sample


class DiffusionProcess:
    """A UNet bound to a schedule, with its samplers.

    Built by :func:`make_process`. The weights are taken as they are when the
    process is made: a compute copy in ``dtype`` (channels-last) and, for the
    s2d path, the prepared kernels are made once here."""

    def __init__(self, model, noise_schedule: str, noise_steps: int, image_size: int,
                 dtype: Optional[torch.dtype] = None):
        dtype = dtype or model.dtype
        self.noise_steps = noise_steps
        self.image_size = image_size
        self.image_channels = model.image_channels
        self.dtype = dtype
        self.schedule = make_schedule(noise_schedule, noise_steps)
        net = model if model.dtype == dtype else copy.deepcopy(model).to(dtype)
        self.net = net.to(memory_format=torch.channels_last).eval()
        self.s2d = bool(model.s2d)
        # folded in float32 from the model's own parameters
        self.kernels = model.prepare_s2d_kernels(dtype) if self.s2d else None
        self.state_codec = (space_to_depth, depth_to_space) if self.s2d else None
        self._samplers: dict = {}

    def apply_fn(self, x, t, cond, cond_features=None, aux=None):
        return self.net(x, t, cond, cond_features=cond_features, s2d_kernels=aux,
                        s2d_io=self.s2d)

    def encode_cond_fn(self, cond):
        return self.net.encode_cond_s2d(cond) if self.s2d else self.net.encode_cond(cond)

    def prepare_fn(self):
        return self.kernels

    def _hooks(self):
        return dict(encode_cond_fn=self.encode_cond_fn,
                    prepare_fn=self.prepare_fn if self.s2d else None,
                    state_codec=self.state_codec)

    def sampler(self, fused_update: bool = False):
        """The ancestral sampler (cached); ``fused_update`` as in
        :func:`make_sampler`."""
        key = ("ddpm", fused_update)
        if key not in self._samplers:
            self._samplers[key] = make_sampler(self.apply_fn, self.schedule,
                                               fused_update=fused_update, **self._hooks())
        return self._samplers[key]

    def ddim_sampler(self, num_steps: int, clip_x0: bool = False):
        """The DDIM sampler with ``num_steps`` model evaluations (cached)."""
        key = ("ddim", num_steps, clip_x0)
        if key not in self._samplers:
            self._samplers[key] = make_ddim_sampler(self.apply_fn, self.schedule, num_steps,
                                                    clip_x0=clip_x0, **self._hooks())
        return self._samplers[key]


def make_process(model, noise_schedule: str, noise_steps: int, image_size: int,
                 dtype: Optional[torch.dtype] = None) -> DiffusionProcess:
    """A :class:`DiffusionProcess` for ``model`` computing in ``dtype``
    (default: the parameters' dtype); the model's device is the process's."""
    return DiffusionProcess(model, noise_schedule, noise_steps, image_size, dtype)
