"""Forward noising and reverse diffusion: ``q_sample`` and
``sample_timesteps`` for training, the ancestral DDPM and DDIM samplers
(port of ``diffusionremotesensing_tpu/diffusion.py``).

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

A sampler built with ``replicas`` (``DiffusionProcess.sampler(mesh=...)``,
a ``parallel.Mesh``) splits the batch axis over the mesh: each replica,
the model on one device, denoises its rows on that device's current
stream, and the results are gathered (over the mesh's ranks too, by
``all_gather``). The noise is the whole batch's: the unfused update's is
drawn for every row from the one generator and each replica takes its
rows; the fused update's kernel starts each replica's Philox quads where
its rows start. So a split batch gives the rows one device would give,
up to the model's own dependence on the batch size (a GEMM's blocking).

A sampler built with ``bands`` (``DiffusionProcess.sampler(spatial=...)``,
a ``parallel.sharding.spatial_sharding``) splits the image HEIGHT instead:
each band (the model on one device, on one thread in one process or one a
rank) holds its rows of x_T, of the condition image and of the state for
the whole chain, runs the model on them with its halos exchanged
(``parallel.halo``), and only the final image is gathered. The noise is
the whole image's, drawn once a step and sliced; the fused update's kernel
draws a band's quads where they sit in the whole state (``item_quads``).
So a split image gives the image one device would give, up to float32
rounding (with a W8A8 quant map, also an activation that this rounding
moves across a quantizer's edge). Every inference configuration of the
model splits.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional

import numpy as np
import torch

from diffusionremotesensing_tpu_torch import profiling
from diffusionremotesensing_tpu_torch.ops.fused_update import (
    ancestral_update,
    draw_seed,
    update_coefs,
)
from diffusionremotesensing_tpu_torch.ops.s2d import depth_to_space, space_to_depth
from diffusionremotesensing_tpu_torch.parallel.halo import Band, gather_bands, make_link
from diffusionremotesensing_tpu_torch.parallel.sharding import (
    SpatialSharding,
    all_gather_rows,
    global_replicated,
    split_rows,
)
from diffusionremotesensing_tpu_torch.schedules import Schedule, make_schedule


def q_sample(schedule: Schedule, x0: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward noising of x0 (B, H, W, C) to the integer timesteps t (B,):
    sqrt(alpha_hat_t) x0 + sqrt(1 - alpha_hat_t) noise, in float32. The
    caller draws ``noise`` (N(0, I), x0's shape)."""
    ah = schedule.alpha_hat.to(x0.device)[t]
    sqrt_ah = torch.sqrt(ah)[:, None, None, None]
    sqrt_omah = torch.sqrt(1.0 - ah)[:, None, None, None]
    return sqrt_ah * x0 + sqrt_omah * noise


def sample_timesteps(generator: Optional[torch.Generator], n: int, noise_steps: int,
                     device=None) -> torch.Tensor:
    """n timesteps uniform over [1, noise_steps), the reference's range, from
    ``generator`` (int64, on ``device`` or the generator's)."""
    device = device if device is not None else (generator.device if generator is not None
                                                else "cpu")
    return torch.randint(1, noise_steps, (n,), generator=generator, device=device)


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


def _eps_fn(apply_fn, encode_cond_fn, prepare_fn, cond, cfg_scale, n, band=None):
    """eps_hat(x, t) for one sampler call: the condition stem and
    ``prepare_fn`` hoisted out of the loop; under ``cfg_scale`` the batched
    guidance of the reference (the conditioned half masked 1, the
    unconditioned half 0, in one model call at 2n). ``band``: a band of a
    spatial split, passed to the condition stem and the model."""
    if cfg_scale is not None and cond is None:
        raise ValueError("cfg_scale requires cond (labels): classifier-free guidance lerps the "
                         "conditioned and unconditioned predictions; pass cond or sample with "
                         "cfg_scale=None")
    kw = {} if band is None else {"band": band}
    aux = prepare_fn() if prepare_fn is not None else None
    if cfg_scale is None:
        feats = (encode_cond_fn(cond, **kw) if encode_cond_fn is not None and cond is not None
                 else None)
        return lambda x, t: apply_fn(x, t, cond, feats, aux, **kw)
    cond2 = torch.cat([cond, cond])
    mask = torch.cat([torch.ones(n), torch.zeros(n)]).to(cond.device)

    def eps(x, t):
        eps2 = apply_fn(torch.cat([x, x]), torch.cat([t, t]), cond2, None, aux, cond_mask=mask,
                        **kw)
        eps_c, eps_u = eps2[:n], eps2[n:]
        return eps_u + cfg_scale * (eps_c - eps_u)
    return eps


class _Shard:
    """One replica's rows [lo, hi) of a sampler call on ``device``; with
    ``band`` (a ``parallel.halo.Band``) only its image rows [r0, r1) of
    ``height`` too. :meth:`prepare` makes the replica's eps function."""

    def __init__(self, hooks: dict, device, lo: int, hi: int, band=None, r0=0, r1=0, height=1):
        self.hooks, self.device, self.lo, self.hi = hooks, torch.device(device), lo, hi
        self.band, self.r0, self.r1, self.height = band, r0, r1, height

    def prepare(self, cond, cfg_scale):
        h = self.hooks
        self.eps = _eps_fn(h["apply_fn"], h.get("encode_cond_fn"), h.get("prepare_fn"),
                           self.rows(cond), cfg_scale, self.hi - self.lo, self.band)

    def rows(self, x, axis: int = 0):
        """This shard's part of ``x`` (its batch axis ``axis``) on its device:
        its batch rows and, on a band, the band's rows of an image-like x
        (the axis after the batch, in x's own rows: H, H/2 in s2d, H/mag)."""
        if x is None:
            return None
        x = x.narrow(axis, self.lo, self.hi - self.lo)
        if self.band is not None and x.dim() >= axis + 4:
            h = x.shape[axis + 1]
            lo, hi = self.r0 * h // self.height, self.r1 * h // self.height
            x = x.narrow(axis + 1, lo, hi - lo)
        return x.to(self.device)


def _shards(replicas, bands, own: dict, x_T, cond, cfg_scale):
    """The sampler call's shards, each with its eps function: one over
    every row without replicas or bands; else the rows of this process's
    replicas (``replicas`` is (mesh, hooks of each local device)) among the
    mesh's equal slices, or the image rows of this process's bands
    (``bands`` is (spatial_sharding, hooks of each local device))."""
    n = x_T.shape[0]
    if bands is not None:
        spatial, hooks = bands
        height = x_T.shape[1]
        rows, local = spatial.band_rows(height), spatial.local_bands()
        link = make_link(spatial, local)
        shards = [_Shard(h, d, 0, n, Band(i, spatial.bands, link), *rows[i], height)
                  for h, d, i in zip(hooks, spatial.mesh.devices, local)]
    elif replicas is None:
        shards = [_Shard(own, x_T.device, 0, n)]
    else:
        mesh, hooks = replicas
        local = len(mesh.devices)
        slices = split_rows(n, mesh.size)[mesh.rank * local:(mesh.rank + 1) * local]
        shards = [_Shard(h, d, lo, hi) for h, d, (lo, hi) in zip(hooks, mesh.devices, slices)]
    _each(shards, lambda k, sh: sh.prepare(cond, cfg_scale))
    return shards


def _each(shards, fn):
    """``[fn(k, shard) for each shard]``: in turn, or at once on the bands
    of a spatial split (their halo exchanges wait for each other)."""
    if shards[0].band is None:
        return [fn(k, sh) for k, sh in enumerate(shards)]
    return shards[0].band.link.run([lambda k=k, sh=sh: fn(k, sh) for k, sh in enumerate(shards)])


def _gather(parts, replicas, bands, device):
    """The shards' rows as one batch on ``device`` (every rank's, in rank
    order, under a group); the bands' image rows joined along the height."""
    if bands is not None:
        return gather_bands(parts, bands[0], device)
    x = torch.cat([p.to(device) for p in parts])
    return x if replicas is None else all_gather_rows(x, replicas[0])


def make_sampler(apply_fn: Callable, schedule: Schedule, *,
                 cfg_scale: Optional[float] = None,
                 capture_frames: bool = False,
                 encode_cond_fn: Optional[Callable] = None,
                 prepare_fn: Optional[Callable] = None,
                 state_codec: Optional[tuple] = None,
                 fused_update: bool = False,
                 start_t: Optional[int] = None,
                 replicas: Optional[tuple] = None,
                 bands: Optional[tuple] = None):
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
    step. ``replicas=(mesh, hooks)`` splits the rows over the mesh (module
    docstring): ``hooks`` holds the apply_fn, encode_cond_fn and prepare_fn
    of each of the mesh's local devices; every rank passes the whole batch
    and gets the whole result. ``bands=(spatial_sharding, hooks)`` splits
    the image height over its mesh instead (module docstring)."""
    if replicas is not None and bands is not None:
        raise ValueError("a sampler splits the batch (mesh=) or the height (spatial=), not both")
    T = schedule.noise_steps
    t_start = _start(T, start_t)
    enc, dec = state_codec if state_codec is not None else (None, None)
    coefs = ([update_coefs(schedule, i) if i > 0 else None for i in range(t_start + 1)]
             if fused_update else None)
    own = dict(apply_fn=apply_fn, encode_cond_fn=encode_cond_fn, prepare_fn=prepare_fn)

    @torch.inference_mode()
    def sample(x_T, cond=None, generator=None, noise_fn=None, bits_fn=None):
        if fused_update and noise_fn is not None:
            raise ValueError("noise_fn applies to the unfused update; the fused one takes bits_fn")
        if not fused_update and bits_fn is not None:
            raise ValueError("bits_fn applies to the fused update (fused_update=True)")
        n = x_T.shape[0]
        with profiling.annotate("sampler.call", rows=n):
            return _ancestral(x_T, cond, generator, noise_fn, bits_fn, n)

    def _ancestral(x_T, cond, generator, noise_fn, bits_fn, n):
        shards = _shards(replicas, bands, own, x_T, cond, cfg_scale)
        xs = [enc(sh.rows(x_T)) if enc is not None else sh.rows(x_T) for sh in shards]
        if bands is None:
            state_shape = (n,) + tuple(xs[0].shape[1:])
        else:  # the whole image's state: the bands' rows summed
            state_shape = (n, xs[0].shape[1] * bands[0].bands) + tuple(xs[0].shape[2:])
        per_row = xs[0][0].numel()
        seed = draw_seed(generator, x_T.device) if fused_update and bits_fn is None else None
        if fused_update and bands is None and any(sh.lo * per_row % 4 for sh in shards):
            raise ValueError(f"a replica's rows start inside a Philox quad ({per_row} elements "
                             "a row): the fused update cannot split this state")
        if fused_update and bands is not None and (state_shape[2] * state_shape[3]) % 4:
            raise ValueError(f"a band's rows start inside a Philox quad ({state_shape[2:]} a "
                             "state row): the fused update cannot split this state")
        frames = []
        for i in range(t_start, 0, -1):
            def step(k, sh, i=i):
                x = xs[k]
                eps_hat = sh.eps(x, torch.full((sh.hi - sh.lo,), float(i), device=sh.device))
                if fused_update:
                    b = None if bits is None else sh.rows(bits, axis=1)
                    s_ = None if seed is None else seed.to(sh.device)
                    if sh.band is None:
                        return ancestral_update(x.contiguous(), eps_hat.contiguous(), coefs[i], s_,
                                                i, b, quad0=sh.lo * per_row // 4)
                    # the band's quads where they sit in the whole state
                    row = state_shape[2] * state_shape[3]
                    r0 = sh.r0 * state_shape[1] // sh.height
                    return ancestral_update(x.contiguous(), eps_hat.contiguous(), coefs[i], s_, i,
                                            b, quad0=r0 * row // 4,
                                            item_quads=state_shape[1] * row // 4)
                zk = sh.rows(z) if i > 1 else torch.zeros_like(x)
                return ddpm_step(schedule, x, eps_hat, i, zk)

            with profiling.annotate("sampler.step", step=t_start - i, t=i, rows=n):
                if fused_update:
                    bits = bits_fn(i, state_shape) if bits_fn is not None else None
                elif i > 1:
                    z = _noise(noise_fn, generator, i, x_T.shape, x_T, enc)
                xs = _each(shards, step)
                if capture_frames:
                    x = _gather(xs, replicas, bands, x_T.device)
                    frames.append(dec(x) if dec is not None else x)
        x = _gather(xs, replicas, bands, x_T.device)
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
                      capture_frames: bool = False,
                      replicas: Optional[tuple] = None,
                      bands: Optional[tuple] = None):
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
    own = dict(apply_fn=apply_fn, encode_cond_fn=encode_cond_fn, prepare_fn=prepare_fn)

    if replicas is not None and bands is not None:
        raise ValueError("a sampler splits the batch (mesh=) or the height (spatial=), not both")

    @torch.inference_mode()
    def sample(x_T, cond=None, generator=None, noise_fn=None):
        n = x_T.shape[0]
        with profiling.annotate("sampler.call", rows=n):
            return _ddim(x_T, cond, generator, noise_fn, n)

    def _ddim(x_T, cond, generator, noise_fn, n):
        shards = _shards(replicas, bands, own, x_T, cond, cfg_scale)
        xs = [enc(sh.rows(x_T)) if enc is not None else sh.rows(x_T) for sh in shards]
        frames = []
        for j, (t, t_prev) in enumerate(zip(taus.tolist(), taus_prev.tolist())):
            ah = schedule.alpha_hat[t]
            ah_prev = schedule.alpha_hat[t_prev] if t_prev > 0 else one
            sigma = eta * torch.sqrt((1.0 - ah_prev) / (1.0 - ah)) * torch.sqrt(1.0 - ah / ah_prev)

            def step(k, sh, t=t, ah=ah, ah_prev=ah_prev, sigma=sigma):
                x = xs[k]
                eps_hat = sh.eps(x, torch.full((sh.hi - sh.lo,), float(t), device=sh.device))
                x0_pred = (x - float(torch.sqrt(1.0 - ah)) * eps_hat) / float(torch.sqrt(ah))
                if clip_x0:
                    x0_pred = x0_pred.clamp(0.0, 1.0)
                    eps_hat = (x - float(torch.sqrt(ah)) * x0_pred) / float(torch.sqrt(1.0 - ah))
                dir_xt = (float(torch.sqrt(torch.clamp(1.0 - ah_prev - sigma ** 2, min=0.0)))
                          * eps_hat)
                return float(torch.sqrt(ah_prev)) * x0_pred + dir_xt

            with profiling.annotate("sampler.step", step=j, t=t, rows=n):
                xs = _each(shards, step)
                if float(sigma) > 0.0:
                    z = _noise(noise_fn, generator, t, x_T.shape, x_T, enc)
                    xs = [x + float(sigma) * sh.rows(z) for x, sh in zip(xs, shards)]
                if capture_frames:
                    x = _gather(xs, replicas, bands, x_T.device)
                    frames.append(dec(x) if dec is not None else x)
        x = _gather(xs, replicas, bands, x_T.device)
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
    s2d path, the prepared kernels are made once here. ``q_sample`` and
    ``sample_timesteps`` are the training draws, from an explicit
    ``torch.Generator``."""

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
        if model.conv0.weight.dtype == dtype == model.dtype:
            net = model
        else:  # a copy with the parameters in the compute dtype
            net = copy.deepcopy(model).to(dtype)
            net.compute_dtype = None
        self.net = net.to(memory_format=torch.channels_last).eval()
        self.s2d = bool(model.s2d)
        # folded in float32 from the model's own parameters
        self.kernels = model.prepare_s2d_kernels(dtype) if self.s2d else None
        self.state_codec = (space_to_depth, depth_to_space) if self.s2d else None
        self._samplers: dict = {}

    def sample_timesteps(self, generator: torch.Generator, n: int) -> torch.Tensor:
        return sample_timesteps(generator, n, self.noise_steps, self.device)

    def q_sample(self, x0: torch.Tensor, t: torch.Tensor,
                 generator: Optional[torch.Generator] = None):
        """(x_t, noise): x0 noised to t with noise drawn from ``generator``."""
        noise = torch.randn(x0.shape, generator=generator, device=x0.device)
        return q_sample(self.schedule, x0, t, noise), noise

    def apply_fn(self, x, t, cond, cond_features=None, aux=None, cond_mask=None, band=None):
        return self.net(x, t, cond, cond_mask, cond_features=cond_features, s2d_kernels=aux,
                        s2d_io=self.s2d, band=band)

    def encode_cond_fn(self, cond, band=None):
        return (self.net.encode_cond_s2d(cond, band) if self.s2d
                else self.net.encode_cond(cond, band))

    def prepare_fn(self):
        return self.kernels

    def _hooks(self):
        image_cond = self.conditioning in ("superres", "sar")
        return dict(encode_cond_fn=self.encode_cond_fn if image_cond else None,
                    prepare_fn=self.prepare_fn if self.s2d else None,
                    state_codec=self.state_codec)

    def replica(self, device, k: int = 0) -> "DiffusionProcess":
        """This process's k-th replica on ``device``: itself for the first on
        its own device, else a copy whose compute weights and prepared
        kernels are this one's, moved (cached per device and k). The copy's
        net shares this net's ``quant_sites``, so a quant map attached later
        reaches it."""
        device = _indexed(device)
        if device == self.device and k == 0:
            return self
        reps = self.__dict__.setdefault("_replica_cache", {})
        if (device, k) not in reps:
            rep = copy.copy(self)
            shared = getattr(self.net, "quant_sites", None)
            rep.net = copy.deepcopy(self.net, {id(shared): shared}).to(device)
            rep.kernels = _moved(self.kernels, device)
            rep.device = device
            rep._samplers, rep._replica_cache = {}, {}
            reps[(device, k)] = rep
        return reps[(device, k)]

    def _replicas(self, mesh):
        """(mesh, the hooks of its local replicas) for the samplers, or None:
        a device that appears twice in the mesh holds two replicas."""
        if mesh is None:
            return None
        if isinstance(mesh, SpatialSharding):
            raise TypeError("a spatial_sharding goes in spatial=, a Mesh in mesh=")
        devices = [_indexed(d) for d in mesh.devices]
        hooks = []
        for i, d in enumerate(devices):
            rep = self.replica(d, devices[:i].count(d))
            h = rep._hooks()
            del h["state_codec"]
            hooks.append(dict(apply_fn=rep.apply_fn, **h))
        return mesh, hooks

    def _bands(self, spatial):
        """(spatial, the hooks of its local bands' replicas) for the
        samplers, or None. Every inference configuration splits, a quant
        map attached or not."""
        if spatial is None:
            return None
        if not isinstance(spatial, SpatialSharding):
            raise TypeError(f"spatial= takes parallel.sharding.spatial_sharding(mesh), got "
                            f"{type(spatial).__name__}")
        spatial.local_bands()
        return spatial, self._replicas(spatial.mesh)[1]

    def sampler(self, cfg_scale: Optional[float] = None, capture_frames: bool = False,
                fused_update: bool = False, start_t: Optional[int] = None, mesh=None,
                spatial=None):
        """The ancestral sampler (cached by its options), as
        :func:`make_sampler`; with ``mesh`` (a ``parallel.Mesh``) the batch
        axis split over the mesh's replicas; with ``spatial``
        (``parallel.sharding.spatial_sharding(mesh)``) the image height
        split into bands over its mesh."""
        key = (("ddpm", cfg_scale, capture_frames, fused_update, start_t)
               + ((mesh,) if mesh else ()) + (("spatial", spatial) if spatial else ()))
        if key not in self._samplers:
            self._samplers[key] = make_sampler(
                self.apply_fn, self.schedule, cfg_scale=cfg_scale, capture_frames=capture_frames,
                fused_update=fused_update, start_t=start_t, replicas=self._replicas(mesh),
                bands=self._bands(spatial), **self._hooks())
        return self._samplers[key]

    def ddim_sampler(self, num_steps: int, eta: float = 0.0, cfg_scale: Optional[float] = None,
                     tau_spacing: str = "linear", clip_x0: bool = False,
                     start_t: Optional[int] = None, capture_frames: bool = False, mesh=None,
                     spatial=None):
        """The DDIM sampler with ``num_steps`` model evaluations (cached by
        its options), as :func:`make_ddim_sampler`; ``mesh`` and ``spatial``
        as in :meth:`sampler`."""
        key = (("ddim", num_steps, eta, cfg_scale, tau_spacing, clip_x0, start_t, capture_frames)
               + ((mesh,) if mesh else ()) + (("spatial", spatial) if spatial else ()))
        if key not in self._samplers:
            self._samplers[key] = make_ddim_sampler(
                self.apply_fn, self.schedule, num_steps, eta=eta, cfg_scale=cfg_scale,
                tau_spacing=tau_spacing, clip_x0=clip_x0, start_t=start_t,
                capture_frames=capture_frames, replicas=self._replicas(mesh),
                bands=self._bands(spatial), **self._hooks())
        return self._samplers[key]

    def sample(self, n: int, cond=None, cfg_scale: Optional[float] = None,
               capture_frames: bool = False, ddim_steps: Optional[int] = None,
               ddim_eta: float = 0.0, ddim_spacing: str = "linear", ddim_clip_x0: bool = True,
               start_t: Optional[int] = None, init=None,
               generator: Optional[torch.Generator] = None, mesh=None, spatial=None):
        """Generate n images, as the reference's ``Process.sample``.

        ``cond`` is one condition image (H, W, C) or one label, broadcast to
        n, or a batch of n images or labels. ``ddim_steps`` runs the DDIM
        sampler with the ``ddim_*`` options; None, the ancestral chain.
        ``start_t`` with ``init`` (a cheap reconstruction, (H, W, C) or n of
        them) q-samples init to t = start_t and runs only the steps below it.
        Noise comes from ``generator`` (a generator of the process's device).
        ``mesh``: a call every rank of the mesh's group makes at the same
        point (the trainer's previews): the generator's state, x_T and cond
        are rank 0's on every rank, so every rank samples the same images.
        ``spatial`` (``parallel.sharding.spatial_sharding(mesh)``): each
        image's height split into bands over its mesh (the samplers'
        ``spatial``); x_T and cond as under ``mesh``, replicated over the
        mesh's group when it has one."""
        if (start_t is None) != (init is None):
            raise ValueError("start_t and init go together: truncated sampling needs a "
                             "warm-start image (init) and a truncation point (start_t)")
        if mesh is not None and spatial is not None:
            raise ValueError("sample splits nothing over mesh= and the height over spatial=: "
                             "pass one")
        dev = self.device
        mesh = mesh if spatial is None else spatial.mesh  # whose group x_T and cond come from
        if generator is not None:
            global_replicated(generator, mesh)
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
        x_T = global_replicated(x_T, mesh)
        if cond is not None:
            cond = global_replicated(cond, mesh)
        if ddim_steps is not None:
            fn = self.ddim_sampler(ddim_steps, eta=ddim_eta, cfg_scale=cfg_scale,
                                   tau_spacing=ddim_spacing, clip_x0=ddim_clip_x0,
                                   start_t=start_t, capture_frames=capture_frames, spatial=spatial)
        else:
            fn = self.sampler(cfg_scale, capture_frames, start_t=start_t, spatial=spatial)
        return fn(x_T, cond, generator=generator)


def _indexed(device) -> torch.device:
    """``device`` with a CUDA device's index (the current card's if none)."""
    device = torch.device(device)
    if device.index is None and device.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _moved(obj, device):
    """``obj`` (tensors in dicts, lists and tuples) with every tensor on
    ``device``."""
    if torch.is_tensor(obj):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _moved(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_moved(v, device) for v in obj)
    return obj


def make_process(model, noise_schedule: str, noise_steps: int, image_size: int,
                 dtype: Optional[torch.dtype] = None, beta_start: float = 1e-4,
                 beta_end: float = 0.02) -> DiffusionProcess:
    """A :class:`DiffusionProcess` for ``model`` computing in ``dtype``
    (default: the parameters' dtype) on the schedule ``noise_schedule``
    (``beta_start`` and ``beta_end`` bound the 'linear' one); the model's
    device is the process's."""
    return DiffusionProcess(model, noise_schedule, noise_steps, image_size, dtype,
                            beta_start, beta_end)
