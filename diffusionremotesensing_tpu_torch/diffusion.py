"""Reverse diffusion: the ancestral DDPM and DDIM samplers (port of
``diffusionremotesensing_tpu/diffusion.py``).

* ancestral step, for i = start_t .. 1 (start_t = T-1 unless truncated):
  x <- (x - (1-alpha_i)/sqrt(1-alpha_hat_i) * eps_hat) / sqrt(alpha_i) + sqrt(beta_i) z,
  with z = 0 at i == 1;
* DDIM (Song et al., arXiv:2010.02502) over a linear or quadratic
  subsequence of [1, start_t], deterministic at eta = 0, with the optional
  per-step clamp of the x0 prediction to [0, 1] (``clip_x0``); one step is
  anchored at start_t;
* classifier-free guidance (``cfg_scale``): one model call on the batch
  twice over, the label embedding masked by ``cond_mask = [1]*n + [0]*n``,
  then eps_u + s * (eps_c - eps_u);
* truncated warm-start sampling (``start_t`` with :func:`warm_start_state`,
  SDEdit arXiv:2108.01073 / CCDF arXiv:2112.05146) and the denoising
  trajectory (``capture_frames``).

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


def _start(noise_steps: int, start_t: Optional[int]) -> int:
    t_start = noise_steps - 1 if start_t is None else int(start_t)
    if not 1 <= t_start <= noise_steps - 1:
        raise ValueError(f"start_t must be in [1, {noise_steps - 1}], got {start_t}")
    return t_start


def _noise(noise_fn, generator, i, shape, like, enc):
    if noise_fn is not None:
        z = noise_fn(i, shape).to(device=like.device, dtype=like.dtype)
    else:
        z = torch.randn(shape, generator=generator, device=like.device, dtype=like.dtype)
    return enc(z) if enc is not None else z


def _eps_fn(apply_fn, encode_cond_fn, prepare_fn, cond, cfg_scale, n):
    """eps_hat(x, t) for one sampler call: the condition stem and
    ``prepare_fn`` hoisted out of the loop; under ``cfg_scale`` the batched
    guidance of the reference (the conditioned half masked 1, the
    unconditioned half 0, in one model call at 2n)."""
    if cfg_scale is not None and cond is None:
        raise ValueError("cfg_scale requires cond (labels): classifier-free guidance lerps the "
                         "conditioned and unconditioned predictions; pass cond or sample with "
                         "cfg_scale=None")
    aux = prepare_fn() if prepare_fn is not None else None
    if cfg_scale is None:
        feats = encode_cond_fn(cond) if encode_cond_fn is not None and cond is not None else None
        return lambda x, t: apply_fn(x, t, cond, feats, aux)
    cond2 = torch.cat([cond, cond])
    mask = torch.cat([torch.ones(n), torch.zeros(n)]).to(cond.device)

    def eps(x, t):
        eps2 = apply_fn(torch.cat([x, x]), torch.cat([t, t]), cond2, None, aux, cond_mask=mask)
        eps_c, eps_u = eps2[:n], eps2[n:]
        return eps_u + cfg_scale * (eps_c - eps_u)
    return eps


def make_sampler(apply_fn: Callable, schedule: Schedule, *,
                 cfg_scale: Optional[float] = None,
                 capture_frames: bool = False,
                 encode_cond_fn: Optional[Callable] = None,
                 prepare_fn: Optional[Callable] = None,
                 state_codec: Optional[tuple] = None,
                 fused_update: bool = False,
                 start_t: Optional[int] = None):
    """Ancestral sampler over t = start_t .. 1 (start_t = T-1 by default).

    ``apply_fn(x, t, cond, cond_features, aux, cond_mask=None) -> eps_hat``;
    the condition stem ``encode_cond_fn(cond)`` and ``prepare_fn()`` (the
    s2d kernels) run once per call, outside the loop. ``state_codec=(encode,
    decode)`` keeps the state in another layout for the whole loop (s2d
    execution). ``cfg_scale`` guides a class-conditional model by its labels
    (``cond``); ``start_t`` truncates the chain (the caller passes x at
    t = start_t, see :func:`warm_start_state`).

    ``fused_update=True`` runs each step's update and noise draw as one
    ``ancestral_update`` call on the n rows of the state (under CFG the
    guided eps of the 2n-row model call), its noise drawn in the state's
    layout from a generator keyed once per call from ``generator`` (no
    synchronisation per step); ``bits_fn(i, state_shape) -> (2,
    *state_shape) int32`` then replaces that generator's words, for tests.

    Returns ``sample(x_T, cond=None, generator=None, noise_fn=None,
    bits_fn=None) -> x0`` (``noise_fn`` for the unfused update only,
    ``bits_fn`` for the fused one), or ``(x0, frames)`` with
    ``capture_frames``: frames (start_t, B, H, W, C), the state after each
    step."""
    T = schedule.noise_steps
    t_start = _start(T, start_t)
    enc, dec = state_codec if state_codec is not None else (None, None)
    coefs = ([update_coefs(schedule, i) if i > 0 else None for i in range(t_start + 1)]
             if fused_update else None)

    @torch.inference_mode()
    def sample(x_T, cond=None, generator=None, noise_fn=None, bits_fn=None):
        if fused_update and noise_fn is not None:
            raise ValueError("noise_fn applies to the unfused update; the fused one takes bits_fn")
        if not fused_update and bits_fn is not None:
            raise ValueError("bits_fn applies to the fused update (fused_update=True)")
        n = x_T.shape[0]
        eps_fn = _eps_fn(apply_fn, encode_cond_fn, prepare_fn, cond, cfg_scale, n)
        x = enc(x_T) if enc is not None else x_T
        seed = draw_seed(generator, x.device) if fused_update and bits_fn is None else None
        frames = []
        for i in range(t_start, 0, -1):
            eps_hat = eps_fn(x, torch.full((n,), float(i), device=x.device))
            if fused_update:
                bits = bits_fn(i, tuple(x.shape)).to(x.device) if bits_fn is not None else None
                x = ancestral_update(x.contiguous(), eps_hat.contiguous(), coefs[i], seed, i, bits)
            else:
                if i > 1:
                    z = _noise(noise_fn, generator, i, x_T.shape, x, enc)
                else:
                    z = torch.zeros_like(x)
                x = ddpm_step(schedule, x, eps_hat, i, z)
            if capture_frames:
                frames.append(dec(x) if dec is not None else x)
        x = dec(x) if dec is not None else x
        return (x, torch.stack(frames)) if capture_frames else x

    return sample


def ddim_timesteps(noise_steps: int, num_steps: int, tau_spacing: str = "linear",
                   start_t: Optional[int] = None) -> np.ndarray:
    """Descending subsequence of [1, start_t] (start_t = T-1 by default):
    'linear' an even stride, 'quadratic' (Song et al. section 4.2) denser
    near t = 0; one step sits at start_t."""
    t_start = _start(noise_steps, start_t)
    if num_steps == 1:
        grid = np.asarray([t_start], np.float64)
    elif tau_spacing == "quadratic":
        grid = np.linspace(1.0, np.sqrt(t_start), num_steps) ** 2
    elif tau_spacing == "linear":
        grid = np.linspace(1, t_start, num_steps)
    else:
        raise ValueError(f"tau_spacing must be linear|quadratic, got {tau_spacing!r}")
    return np.unique(grid.round().astype(np.int64))[::-1].copy()


def make_ddim_sampler(apply_fn: Callable, schedule: Schedule, num_steps: int, *,
                      eta: float = 0.0,
                      cfg_scale: Optional[float] = None,
                      tau_spacing: str = "linear",
                      clip_x0: bool = False,
                      encode_cond_fn: Optional[Callable] = None,
                      prepare_fn: Optional[Callable] = None,
                      state_codec: Optional[tuple] = None,
                      start_t: Optional[int] = None,
                      capture_frames: bool = False):
    """DDIM sampler with ``num_steps`` model evaluations over
    :func:`ddim_timesteps`; the last step lands on t_prev = 0, where
    alpha_hat is taken as 1 (so sigma is 0 there at any eta). ``eta > 0``
    adds sigma z, z drawn in the original layout (``noise_fn`` as in
    :func:`make_sampler`). Other arguments as :func:`make_sampler`;
    ``capture_frames`` (not in the reference's DDIM sampler) returns the
    state after each step as frames (steps, B, H, W, C). Returns
    ``sample(x_T, cond=None, generator=None, noise_fn=None) -> x0`` (or
    ``(x0, frames)``); at eta = 0 no noise is drawn."""
    taus = ddim_timesteps(schedule.noise_steps, num_steps, tau_spacing, start_t)
    taus_prev = np.concatenate([taus[1:], [0]])
    enc, dec = state_codec if state_codec is not None else (None, None)
    one = torch.ones((), dtype=torch.float32)

    @torch.inference_mode()
    def sample(x_T, cond=None, generator=None, noise_fn=None):
        n = x_T.shape[0]
        eps_fn = _eps_fn(apply_fn, encode_cond_fn, prepare_fn, cond, cfg_scale, n)
        x = enc(x_T) if enc is not None else x_T
        frames = []
        for t, t_prev in zip(taus.tolist(), taus_prev.tolist()):
            eps_hat = eps_fn(x, torch.full((n,), float(t), device=x.device))
            ah = schedule.alpha_hat[t]
            ah_prev = schedule.alpha_hat[t_prev] if t_prev > 0 else one
            x0_pred = (x - float(torch.sqrt(1.0 - ah)) * eps_hat) / float(torch.sqrt(ah))
            if clip_x0:
                x0_pred = x0_pred.clamp(0.0, 1.0)
                eps_hat = (x - float(torch.sqrt(ah)) * x0_pred) / float(torch.sqrt(1.0 - ah))
            sigma = eta * torch.sqrt((1.0 - ah_prev) / (1.0 - ah)) * torch.sqrt(1.0 - ah / ah_prev)
            dir_xt = float(torch.sqrt(torch.clamp(1.0 - ah_prev - sigma ** 2, min=0.0))) * eps_hat
            x = float(torch.sqrt(ah_prev)) * x0_pred + dir_xt
            if float(sigma) > 0.0:
                x = x + float(sigma) * _noise(noise_fn, generator, t, x_T.shape, x, enc)
            if capture_frames:
                frames.append(dec(x) if dec is not None else x)
        x = dec(x) if dec is not None else x
        return (x, torch.stack(frames)) if capture_frames else x

    return sample


def warm_start_state(schedule: Schedule, init: torch.Tensor, start_t: int,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q-sample a cheap reconstruction to t = start_t, the warm start of
    truncated sampling: sqrt(alpha_hat) init + sqrt(1 - alpha_hat) eps.
    init (B, H, W, C) in the data range (e.g. the bicubic upsample for
    super-resolution); eps from ``generator``, or ``noise`` when given."""
    ah = schedule.alpha_hat[start_t]
    if noise is None:
        noise = torch.randn(init.shape, generator=generator, device=init.device)
    return float(torch.sqrt(ah)) * init.float() + float(torch.sqrt(1.0 - ah)) * noise.to(init.device)


class DiffusionProcess:
    """A UNet bound to a schedule, with its samplers.

    Built by :func:`make_process`. The weights are taken as they are when the
    process is made: a compute copy in ``dtype`` (channels-last) and, for the
    s2d path, the prepared kernels are made once here."""

    def __init__(self, model, noise_schedule: str, noise_steps: int, image_size: int,
                 dtype: Optional[torch.dtype] = None, beta_start: float = 1e-4,
                 beta_end: float = 0.02):
        dtype = dtype or model.dtype
        self.noise_steps = noise_steps
        self.image_size = image_size
        self.image_channels = model.image_channels
        self.conditioning = model.conditioning
        self.dtype = dtype
        self.device = model.conv0.weight.device
        self.schedule = make_schedule(noise_schedule, noise_steps, beta_start, beta_end)
        net = model if model.dtype == dtype else copy.deepcopy(model).to(dtype)
        self.net = net.to(memory_format=torch.channels_last).eval()
        self.s2d = bool(model.s2d)
        # folded in float32 from the model's own parameters
        self.kernels = model.prepare_s2d_kernels(dtype) if self.s2d else None
        self.state_codec = (space_to_depth, depth_to_space) if self.s2d else None
        self._samplers: dict = {}

    def apply_fn(self, x, t, cond, cond_features=None, aux=None, cond_mask=None):
        return self.net(x, t, cond, cond_mask, cond_features=cond_features, s2d_kernels=aux,
                        s2d_io=self.s2d)

    def encode_cond_fn(self, cond):
        return self.net.encode_cond_s2d(cond) if self.s2d else self.net.encode_cond(cond)

    def prepare_fn(self):
        return self.kernels

    def _hooks(self):
        image_cond = self.conditioning in ("superres", "sar")
        return dict(encode_cond_fn=self.encode_cond_fn if image_cond else None,
                    prepare_fn=self.prepare_fn if self.s2d else None,
                    state_codec=self.state_codec)

    def sampler(self, cfg_scale: Optional[float] = None, capture_frames: bool = False,
                fused_update: bool = False, start_t: Optional[int] = None):
        """The ancestral sampler (cached by its options), as
        :func:`make_sampler`."""
        key = ("ddpm", cfg_scale, capture_frames, fused_update, start_t)
        if key not in self._samplers:
            self._samplers[key] = make_sampler(
                self.apply_fn, self.schedule, cfg_scale=cfg_scale, capture_frames=capture_frames,
                fused_update=fused_update, start_t=start_t, **self._hooks())
        return self._samplers[key]

    def ddim_sampler(self, num_steps: int, eta: float = 0.0, cfg_scale: Optional[float] = None,
                     tau_spacing: str = "linear", clip_x0: bool = False,
                     start_t: Optional[int] = None, capture_frames: bool = False):
        """The DDIM sampler with ``num_steps`` model evaluations (cached by
        its options), as :func:`make_ddim_sampler`."""
        key = ("ddim", num_steps, eta, cfg_scale, tau_spacing, clip_x0, start_t, capture_frames)
        if key not in self._samplers:
            self._samplers[key] = make_ddim_sampler(
                self.apply_fn, self.schedule, num_steps, eta=eta, cfg_scale=cfg_scale,
                tau_spacing=tau_spacing, clip_x0=clip_x0, start_t=start_t,
                capture_frames=capture_frames, **self._hooks())
        return self._samplers[key]

    def sample(self, n: int, cond=None, cfg_scale: Optional[float] = None,
               capture_frames: bool = False, ddim_steps: Optional[int] = None,
               ddim_eta: float = 0.0, ddim_spacing: str = "linear", ddim_clip_x0: bool = True,
               start_t: Optional[int] = None, init=None,
               generator: Optional[torch.Generator] = None):
        """Generate n images, as the reference's ``Process.sample``.

        ``cond`` is one condition image (H, W, C) or one label, broadcast to
        n, or a batch of n images or labels. ``ddim_steps`` runs the DDIM
        sampler with the ``ddim_*`` options; None, the ancestral chain.
        ``start_t`` with ``init`` (a cheap reconstruction, (H, W, C) or n of
        them) q-samples init to t = start_t and runs only the steps below it.
        Noise comes from ``generator`` (a generator of the process's device)."""
        if (start_t is None) != (init is None):
            raise ValueError("start_t and init go together: truncated sampling needs a "
                             "warm-start image (init) and a truncation point (start_t)")
        dev = self.device
        if start_t is not None:
            init = torch.as_tensor(np.asarray(init, np.float32)).to(dev)
            if init.dim() == 3:
                init = init[None].expand((n,) + tuple(init.shape))
            x_T = warm_start_state(self.schedule, init, start_t, generator)
        else:
            x_T = torch.randn((n, self.image_size, self.image_size, self.image_channels),
                              generator=generator, device=dev)
        if cond is not None:
            if self.conditioning == "class":
                cond = torch.as_tensor(np.asarray(cond, np.int64)).to(dev)
                if cond.dim() == 0:
                    cond = cond.expand(n)
            else:
                cond = torch.as_tensor(np.asarray(cond, np.float32)).to(dev)
                if cond.dim() == 3:
                    cond = cond[None].expand((n,) + tuple(cond.shape))
        if ddim_steps is not None:
            fn = self.ddim_sampler(ddim_steps, eta=ddim_eta, cfg_scale=cfg_scale,
                                   tau_spacing=ddim_spacing, clip_x0=ddim_clip_x0,
                                   start_t=start_t, capture_frames=capture_frames)
        else:
            fn = self.sampler(cfg_scale, capture_frames, start_t=start_t)
        return fn(x_T, cond, generator=generator)


def make_process(model, noise_schedule: str, noise_steps: int, image_size: int,
                 dtype: Optional[torch.dtype] = None, beta_start: float = 1e-4,
                 beta_end: float = 0.02) -> DiffusionProcess:
    """A :class:`DiffusionProcess` for ``model`` computing in ``dtype``
    (default: the parameters' dtype) on the schedule ``noise_schedule``
    (``beta_start`` and ``beta_end`` bound the 'linear' one); the model's
    device is the process's."""
    return DiffusionProcess(model, noise_schedule, noise_steps, image_size, dtype,
                            beta_start, beta_end)
