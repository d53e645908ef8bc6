"""The samplers' options of the port (diffusion.py) against the reference
package's samplers, run as they are, on the same weights, x_T and noise: the
reference draws its noise along a chain of split keys, which the test
replays with the reference's own functions and hands to the port through
noise_fn. The class-conditional model at HR 16 (the port in s2d execution,
its state in s2d layout, the reference's plain forward): DDPM with
classifier-free guidance and capture_frames; DDIM at eta 0.5 on the
quadratic subsequence with CFG and start_t; warm_start_state; make_process's
beta_start / beta_end. Float32, atol 1e-4. Also the fused update under CFG
(n rows, not the 2n of the model batch) against the unfused one, and
DiffusionProcess.sample's broadcasting and refusals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu import diffusion as jdiff
from diffusionremotesensing_tpu_torch import diffusion as tdiff
from diffusionremotesensing_tpu_torch.ops.s2d import depth_to_space
from tests.test_torch_port_fused_stack import _box_muller
from tests.torch_port_helpers import JAX_MODELS, port_model, random_jax_variables

HR = 16
LABELS = np.array([0, 3], np.int64)


@pytest.fixture(scope="module")
def variables():
    return random_jax_variables(seed=31, image_size=HR, variant="generation")


@pytest.fixture(scope="module")
def port_proc(variables):
    def make(T):
        return tdiff.make_process(port_model(variables, "generation", s2d=True, tap44="block"),
                                  "cosine", T, HR)
    return make


def _x_T(seed, n=2):
    return np.random.default_rng(seed).standard_normal((n, HR, HR, 3)).astype(np.float32)


def _key_chain_noise(key, steps, shape):
    """The reference sampler's per-step noise: k, k_noise = split(k), z drawn
    from k_noise, step after step."""
    out, k = [], key
    for _ in range(steps):
        k, kn = jax.random.split(k)
        out.append(np.array(jdiff._normal_packed(kn, shape, jnp.float32)))
    return out


def test_ddpm_cfg_capture_frames_matches_reference(variables, port_proc):
    T, cfg = 8, 3.0
    x_T, key = _x_T(40), jax.random.PRNGKey(41)
    jproc = jdiff.make_process(JAX_MODELS["generation"](), "cosine", T, HR)
    want, want_frames = jproc.sampler(cfg_scale=cfg, capture_frames=True)(
        variables, key, jnp.asarray(x_T), jnp.asarray(LABELS))
    noise = dict(zip(range(T - 1, 0, -1), _key_chain_noise(key, T - 1, x_T.shape)))
    got, frames = port_proc(T).sampler(cfg, capture_frames=True)(
        torch.from_numpy(x_T), torch.from_numpy(LABELS),
        noise_fn=lambda i, shape: torch.from_numpy(noise[i]))
    assert frames.shape == (T - 1, 2, HR, HR, 3)
    np.testing.assert_allclose(frames.numpy(), np.asarray(want_frames), atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    torch.testing.assert_close(frames[-1], got, rtol=0, atol=0)


def test_ddim_eta_quadratic_cfg_start_t_matches_reference(variables, port_proc):
    T, steps, start_t = 40, 5, 30
    opts = dict(eta=0.5, cfg_scale=2.0, tau_spacing="quadratic", clip_x0=True, start_t=start_t)
    x_T, key = _x_T(42), jax.random.PRNGKey(43)
    jproc = jdiff.make_process(JAX_MODELS["generation"](), "cosine", T, HR)
    want = jproc.ddim_sampler(steps, **opts)(variables, key, jnp.asarray(x_T), jnp.asarray(LABELS))
    taus = tdiff.ddim_timesteps(T, steps, "quadratic", start_t)
    assert taus[0] == start_t and taus[-1] == 1 and len(taus) == steps
    noise = dict(zip(taus.tolist(), _key_chain_noise(key, len(taus), x_T.shape)))
    asked = []

    def noise_fn(t, shape):
        asked.append(t)
        return torch.from_numpy(noise[t])

    got = port_proc(T).ddim_sampler(steps, **opts)(torch.from_numpy(x_T), torch.from_numpy(LABELS),
                                                   noise_fn=noise_fn)
    assert asked == taus.tolist()[:-1]  # the last step's sigma is 0: no draw
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_warm_start_and_linear_betas_match_reference():
    """warm_start_state on the same eps; make_process's beta_start/beta_end
    reach the linear schedule exactly."""
    js = jdiff.make_process(JAX_MODELS["generation"](), "linear", 50, HR,
                            beta_start=2e-4, beta_end=0.03).schedule
    ts = tdiff.make_process(port_model(random_jax_variables(31, HR, "generation"), "generation"),
                            "linear", 50, HR, beta_start=2e-4, beta_end=0.03).schedule
    for name in ("beta", "alpha", "alpha_hat"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)))
    init, key = np.random.default_rng(44).random((2, HR, HR, 3)).astype(np.float32), jax.random.PRNGKey(45)
    want = jdiff.warm_start_state(js, jnp.asarray(init), 20, key)
    eps = np.array(jdiff._normal_packed(key, init.shape, jnp.float32))
    got = tdiff.warm_start_state(ts, torch.from_numpy(init), 20, noise=torch.from_numpy(eps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_fused_update_under_cfg_updates_n_rows(port_proc):
    """CFG's model call has 2n rows; the fused update runs on the n rows of
    the state: given bits, the same as the unfused update fed their z."""
    proc = port_proc(5)
    rng = np.random.default_rng(46)
    x_T = torch.from_numpy(_x_T(47))
    bits = {i: rng.integers(0, 2**32, (2, 2, 8, 8, 12), dtype=np.uint32) for i in range(1, 5)}

    def bits_fn(i, shape):
        assert shape == (2, 8, 8, 12)
        return torch.from_numpy(bits[i].view(np.int32))

    got = proc.sampler(2.0, fused_update=True)(x_T, torch.from_numpy(LABELS), bits_fn=bits_fn)
    want = proc.sampler(2.0)(x_T, torch.from_numpy(LABELS),
                             noise_fn=lambda i, s: depth_to_space(torch.from_numpy(_box_muller(bits[i]))))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)


def test_process_sample_broadcasts_and_refuses(port_proc):
    proc = port_proc(12)
    g = torch.Generator().manual_seed(0)
    out = proc.sample(3, cond=2, cfg_scale=2.0, ddim_steps=3, generator=g)
    assert out.shape == (3, HR, HR, 3) and torch.isfinite(out).all()
    x0, frames = proc.sample(2, cond=LABELS, ddim_steps=3, start_t=6,
                             init=np.full((HR, HR, 3), 0.5, np.float32), capture_frames=True,
                             generator=g)
    assert frames.shape == (3, 2, HR, HR, 3) and torch.equal(frames[-1], x0)
    with pytest.raises(ValueError, match="init"):
        proc.sample(2, cond=LABELS, start_t=6)
    with pytest.raises(ValueError, match="cfg_scale requires cond"):
        proc.sampler(2.0)(torch.zeros(1, HR, HR, 3))
    with pytest.raises(ValueError, match="start_t"):
        proc.ddim_sampler(3, start_t=12)
    with pytest.raises(ValueError, match="tau_spacing"):
        proc.ddim_sampler(3, tau_spacing="cubic")
    # the samplers are cached by all of their options
    assert proc.ddim_sampler(3, eta=0.5) is proc.ddim_sampler(3, eta=0.5)
    assert proc.ddim_sampler(3, eta=0.5) is not proc.ddim_sampler(3, eta=0.25)
