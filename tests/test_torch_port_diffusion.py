"""The port's samplers (diffusionremotesensing_tpu_torch/diffusion.py) against
the reference package's, on the same weights and the same x_T: DDIM at
eta = 0 end to end (deterministic), and the ancestral chain with its noise
made in numpy and handed to both, including the zero noise of the last
step. Float32; atol 1e-4 on the final images (per-step float32 differences
grow by at most the 1/sqrt(alpha) of a few steps)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu import diffusion as jdiff
from diffusionremotesensing_tpu.models.unet import residual_attention_unet_superres as jax_superres
from diffusionremotesensing_tpu.schedules import make_schedule as jax_schedule
from diffusionremotesensing_tpu_torch import diffusion as tdiff
from diffusionremotesensing_tpu_torch.schedules import make_schedule as torch_schedule
from tests.torch_port_helpers import port_model, random_jax_variables

HR = 16


@pytest.fixture(scope="module")
def variables():
    return random_jax_variables(seed=11, image_size=HR)


def _state(seed, batch=2):
    rng = np.random.default_rng(seed)
    x_T = rng.standard_normal((batch, HR, HR, 3)).astype(np.float32)
    cond = rng.random((batch, HR // 2, HR // 2, 3)).astype(np.float32)
    return x_T, cond


@pytest.mark.parametrize("t", [1, 2, 750, 1499])
def test_ddpm_step_matches_reference(t):
    rng = np.random.default_rng(t)
    x, eps, z = (rng.standard_normal((2, 8, 8, 3)).astype(np.float32) for _ in range(3))
    want = jdiff.ddpm_step(jax_schedule("cosine", 1500), jnp.asarray(x), jnp.asarray(eps), t,
                           jnp.asarray(z))
    got = tdiff.ddpm_step(torch_schedule("cosine", 1500), torch.from_numpy(x),
                          torch.from_numpy(eps), t, torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("T,steps", [(1500, 100), (1500, 1), (20, 4), (10, 50)])
def test_ddim_subsequence_matches_reference(T, steps):
    """Same timesteps as the reference builds (make_ddim_sampler, linear tau)."""
    grid = np.asarray([T - 1.0]) if steps == 1 else np.linspace(1, T - 1, steps)
    want = np.unique(grid.round().astype(np.int64))[::-1]
    np.testing.assert_array_equal(tdiff.ddim_timesteps(T, steps), want)


def test_ancestral_chain_with_injected_noise_matches_reference(variables):
    """s2d + tap_block model (the main path), T=6: the port's sampler with
    noise_fn against the reference model and ddpm_step stepped by hand with
    the same noise; no noise is drawn for the last step."""
    T = 6
    x_T, cond = _state(12)
    rng = np.random.default_rng(13)
    noise = {i: rng.standard_normal(x_T.shape).astype(np.float32) for i in range(2, T)}

    jm = jax_superres(magnification_factor=2, s2d=True, tap44="block")
    apply = jax.jit(lambda v, x, t, c: jm.apply(v, x, t, c, train=False))
    sched = jax_schedule("cosine", T)
    x = jnp.asarray(x_T)
    for i in range(T - 1, 0, -1):
        eps = apply(variables, x, jnp.full((2,), i, jnp.int32), jnp.asarray(cond))
        z = jnp.asarray(noise[i]) if i > 1 else jnp.zeros_like(x)
        x = jdiff.ddpm_step(sched, x, eps, i, z)

    asked = []

    def noise_fn(i, shape):
        asked.append(i)
        assert tuple(shape) == x_T.shape
        return torch.from_numpy(noise[i])

    proc = tdiff.make_process(port_model(variables, s2d=True, tap44="block"), "cosine", T, HR)
    got = proc.sampler()(torch.from_numpy(x_T), torch.from_numpy(cond), noise_fn=noise_fn)
    assert asked == list(range(T - 1, 1, -1))
    np.testing.assert_allclose(got.numpy(), np.asarray(x), atol=1e-4)


def test_ddim_eta0_end_to_end_matches_reference(variables):
    """The served configuration: s2d + tap_block, clip_x0 on, from one x_T."""
    T, steps = 30, 4
    x_T, cond = _state(14)
    jproc = jdiff.make_process(jax_superres(magnification_factor=2, s2d=True, tap44="block"),
                               "cosine", T, HR)
    want = jproc.ddim_sampler(steps, clip_x0=True)(variables, jax.random.PRNGKey(0),
                                                   jnp.asarray(x_T), jnp.asarray(cond))
    tproc = tdiff.make_process(port_model(variables, s2d=True, tap44="block"), "cosine", T, HR)
    got = tproc.ddim_sampler(steps, clip_x0=True)(torch.from_numpy(x_T), torch.from_numpy(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_ddim_single_step_unclipped_matches_reference(variables):
    """num_steps == 1 anchors the one step at T-1; plain execution, no clip."""
    T = 30
    x_T, cond = _state(15)
    jproc = jdiff.make_process(jax_superres(magnification_factor=2), "cosine", T, HR)
    want = jproc.ddim_sampler(1, clip_x0=False)(variables, jax.random.PRNGKey(0),
                                               jnp.asarray(x_T), jnp.asarray(cond))
    tproc = tdiff.make_process(port_model(variables), "cosine", T, HR)
    got = tproc.ddim_sampler(1, clip_x0=False)(torch.from_numpy(x_T), torch.from_numpy(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_bf16_process_keeps_master_weights_and_agrees(variables):
    """dtype=bfloat16 computes on a bf16 copy; the caller's model stays
    float32 and the result stays near the float32 one (bf16 rounding of
    every layer, 5 DDIM steps)."""
    T = 30
    x_T, cond = _state(16)
    model = port_model(variables, s2d=True, tap44="block")
    f32 = tdiff.make_process(model, "cosine", T, HR).ddim_sampler(5, clip_x0=True)
    b16 = tdiff.make_process(model, "cosine", T, HR, dtype=torch.bfloat16).ddim_sampler(5, clip_x0=True)
    assert model.dtype == torch.float32
    a = f32(torch.from_numpy(x_T), torch.from_numpy(cond))
    b = b16(torch.from_numpy(x_T), torch.from_numpy(cond))
    assert b.dtype == torch.float32
    assert (a - b).abs().max().item() < 0.1
