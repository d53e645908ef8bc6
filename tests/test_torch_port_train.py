"""One train step of the port (train.Trainer.train_step) against the
reference package's Trainer step, from the same weights (random, drawn with
numpy, carried over by convert.from_jax_variables), batch, timesteps and
noise: the reference's step runs as it is (jitted, its t and noise drawn
from its key), and the test replays that key's t and noise into the port's
step. Full width at HR 16, batch 4, float32: superres dense and s2d_train,
SAR->NDVI, generation with cond_mask 1 and 0; EMA on.

The reference's Adam state after one step holds mu = 0.1 g, so its
gradients are read from there. Tolerances (float32):

* loss: rtol 1e-5 (measured <= 5e-7);
* every gradient within 1e-5 of the model's largest gradient (measured <=
  1e-6: the biases of convolutions that feed a train-mode BatchNorm have a
  zero gradient in exact arithmetic, float32 noise of ~1e-8 here);
* parameters after Adam within 1e-6 where the reference's gradient exceeds
  1e-5 of the largest; everywhere within 2 lr: Adam's first step is
  lr g / (|g| + eps), so the noise-level gradients above move their
  parameters by up to lr either way (measured 2.4e-4 at lr 3e-4);
* the BatchNorm running statistics (the s2d_train path's level-0 ones
  included) within 1e-6;
* EMA: at step 0 a copy of the parameters after Adam; at step 2000 the
  decay, 0.995 ema + 0.005 params.

A bfloat16-compute step (float32 parameters) against the reference's
(flax dtype bfloat16): loss rtol 1e-3 (measured 2e-5), the whole gradient's
relative L2 error <= 5e-2. And pad_mask: a batch wrap-padded by a whole
repetition of its rows gives the unpadded batch's loss and gradients."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu import diffusion as jdiff
from diffusionremotesensing_tpu.train import Trainer as JaxTrainer
from diffusionremotesensing_tpu_torch.convert import from_jax_variables
from diffusionremotesensing_tpu_torch.train import Trainer
from tests.torch_port_helpers import JAX_MODELS, PORT_MODELS, random_jax_variables

HR, B, T, LR = 16, 4, 1500, 3e-4
CASES = {
    "superres": ("superres", {}, None),
    "superres_s2d_train": ("superres", {"s2d_train": True}, None),
    "sar": ("sar", {}, None),
    "generation_mask1": ("generation", {}, 1.0),
    "generation_mask0": ("generation", {}, 0.0),
}


def _batch(variant, mask, seed=0):
    rng = np.random.default_rng(seed)
    c = 1 if variant == "sar" else 3
    batch = {"x": rng.random((B, HR, HR, c)).astype(np.float32)}
    batch["cond"] = {"superres": lambda: rng.random((B, HR // 2, HR // 2, 3)).astype(np.float32),
                     "sar": lambda: rng.random((B, HR, HR, 2)).astype(np.float32),
                     "generation": lambda: np.array([0, 1, 2, 3], np.int64)}[variant]()
    if mask is not None:
        batch["cond_mask"] = np.full((B,), mask, np.float32)
    return batch


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_step(variant, flags, bf16=False):
    """The reference Trainer's jitted step for the model `variant` (one
    compile, shared by the cases and tests that use it)."""
    kw = dict(flags, **({"dtype": jnp.bfloat16} if bf16 else {}))
    tr = JaxTrainer(JAX_MODELS[variant](**kw), "cosine", T, HR, lr=LR, ema_smoothing=True)
    return tr, jax.jit(tr._train_step_fn())


def _reference(variant, flags, mask, bf16=False, step=0, seed=3):
    """The reference's step from random_jax_variables(seed): (loss, grads,
    params, batch_stats, ema_params) as numpy trees, and the t and noise it
    drew."""
    v = random_jax_variables(seed=seed, image_size=HR, variant=variant)
    tr, fn = _jax_step(variant, tuple(sorted(flags.items())), bf16)
    state = tr.init_state(jax.tree_util.tree_map(jnp.asarray, v))
    state = state.replace(step=jnp.asarray(step, jnp.int32))
    batch = _batch(variant, mask)
    key = jax.random.PRNGKey(11)
    new, loss = fn(state, jax.tree_util.tree_map(jnp.asarray, batch), key)
    k_t, k_noise = jax.random.split(key)
    t = np.array(jdiff.sample_timesteps(k_t, B, T))
    noise = np.array(jdiff._normal_packed(k_noise, batch["x"].shape, jnp.float32))
    grads = jax.tree_util.tree_map(lambda m: np.asarray(m) / np.float32(0.1), new.opt_state[0].mu)
    return dict(loss=float(loss), grads=grads, params=_numpy(new.params),
                stats=_numpy(new.batch_stats), ema=_numpy(new.ema_params),
                ema0=_numpy(state.ema_params), t=t, noise=noise, batch=batch, variables=v)


def _port_step(variant, flags, ref, bf16=False, step=0):
    """The port's step from the same weights, batch, t and noise."""
    m = PORT_MODELS[variant](**flags, **({"compute_dtype": torch.bfloat16} if bf16 else {}))
    tr = Trainer(m, "cosine", T, HR, lr=LR, ema_smoothing=True, device="cpu")
    v = ref["variables"]
    state = tr.init_state(from_jax_variables(v["params"], v["batch_stats"]))
    state.step = step
    batch = {k: torch.from_numpy(np.asarray(a)) for k, a in ref["batch"].items()}
    loss = tr.train_step(state, batch, torch.from_numpy(ref["t"]).long(),
                         torch.from_numpy(ref["noise"]))
    return tr, state, float(loss)


def _as_state_dict(ref, tree_name):
    """A reference tree (params-shaped) under the port's names."""
    return from_jax_variables(ref[tree_name], ref["stats"])


@pytest.fixture(scope="module")
def steps():
    """Each case's reference step and the port's, computed once."""
    out = {}
    for name, (variant, flags, mask) in CASES.items():
        ref = _reference(variant, flags, mask)
        out[name] = (ref, _port_step(variant, flags, ref))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_loss_matches_reference(steps, case):
    ref, (_, _, loss) = steps[case]
    assert loss == pytest.approx(ref["loss"], rel=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_reference(steps, case):
    ref, (_, state, _) = steps[case]
    want = _as_state_dict(ref, "grads")
    named = dict(state.model.named_parameters())
    gmax = max(float(want[n].abs().max()) for n in named)
    for n, p in named.items():
        assert p.grad is not None, n  # the unused skip convs get zeros, as in the reference
        err = float((p.grad - want[n]).abs().max())
        assert err <= 1e-5 * gmax, (n, err, gmax)


@pytest.mark.parametrize("case", list(CASES))
def test_adam_update_and_batch_stats_match_reference(steps, case):
    ref, (_, state, _) = steps[case]
    grads, params = _as_state_dict(ref, "grads"), _as_state_dict(ref, "params")
    named = dict(state.model.named_parameters())
    gmax = max(float(grads[n].abs().max()) for n in named)
    for n, p in named.items():
        d = (p.detach() - params[n]).abs()
        assert float(d.max()) <= 2 * LR, n
        live = grads[n].abs() > 1e-5 * gmax
        if live.any():
            assert float(d[live].max()) <= 1e-6, n
    sd = state.model.state_dict()
    for k in sd:
        if "running" in k:
            torch.testing.assert_close(sd[k], params[k], rtol=0, atol=1e-6, msg=k)


def test_s2d_train_moves_the_level0_statistics(steps):
    """The s2d_train step's level-0 BatchNorms (merged into batch_stats by
    the reference's Trainer, written to the buffers by the port) moved from
    their initial values, and equal the reference's."""
    ref, (_, state, _) = steps["superres_s2d_train"]
    v = ref["variables"]
    before = from_jax_variables(v["params"], v["batch_stats"])
    after = _as_state_dict(ref, "params")
    sd = state.model.state_dict()
    for k in ("conv_blocks.0.batch_norm1.running_var",
              "conv_blocks.0.shortcut_batch_norm.running_mean",
              "attention_blocks.2.result.1.running_var", "ups.2.batch_norm.running_mean"):
        assert float((sd[k] - before[k]).abs().max()) > 1e-3, k
        torch.testing.assert_close(sd[k], after[k], rtol=0, atol=1e-6)


def test_ema_copies_at_step_zero(steps):
    ref, (_, state, _) = steps["superres"]
    params = [p.detach() for p in state.model.parameters()]
    assert all(torch.equal(e, p) for e, p in zip(state.ema_params, params))
    want = _as_state_dict(ref, "ema")
    for e, (n, _) in zip(state.ema_params, state.model.named_parameters()):
        assert float((e - want[n]).abs().max()) <= 2 * LR, n


def test_ema_decays_from_step_2000():
    """At step 2000 the EMA decays: 0.995 ema + 0.005 params, the port's
    against that formula (float32) and against the reference's step."""
    variant, flags, mask = CASES["superres"]
    ref = _reference(variant, flags, mask, step=2000)
    _, state, _ = _port_step(variant, flags, ref, step=2000)
    assert state.step == 2001
    ema0 = _as_state_dict(ref, "ema0")
    want = _as_state_dict(ref, "ema")
    d, om = np.float32(0.995), np.float32(1.0) - np.float32(0.995)
    for e, (n, p) in zip(state.ema_params, state.model.named_parameters()):
        formula = d * ema0[n].numpy() + om * p.detach().numpy()
        np.testing.assert_allclose(e.numpy(), formula, rtol=0, atol=1e-6, err_msg=n)
        assert float((e - want[n]).abs().max()) <= 0.005 * 2 * LR + 1e-6, n


def test_bf16_compute_step_matches_reference():
    variant, flags, mask = CASES["superres"]
    ref = _reference(variant, flags, mask, bf16=True)
    _, state, loss = _port_step(variant, flags, ref, bf16=True)
    assert state.model.conv0.weight.dtype == torch.float32  # master weights
    assert loss == pytest.approx(ref["loss"], rel=1e-3)
    want = _as_state_dict(ref, "grads")
    got = torch.cat([p.grad.reshape(-1) for p in state.model.parameters()])
    ref_g = torch.cat([want[n].reshape(-1) for n, _ in state.model.named_parameters()])
    assert float((got - ref_g).norm() / ref_g.norm()) <= 5e-2


def test_pad_mask_weighting_matches_the_unpadded_batch():
    """4 real rows wrap-padded to 8 (a whole repetition, so the BatchNorm
    statistics are the same) with pad_mask [1]*4 + [0]*4: the loss and
    every gradient of the unpadded 4-row batch."""
    variant, flags, mask = CASES["superres"]
    v = random_jax_variables(seed=3, image_size=HR, variant=variant)
    batch = {k: torch.from_numpy(a) for k, a in _batch(variant, mask).items()}
    rng = np.random.default_rng(5)
    t = torch.from_numpy(rng.integers(1, T, B)).long()
    noise = torch.from_numpy(rng.standard_normal((B, HR, HR, 3)).astype(np.float32))
    out = []
    for pad in (False, True):
        tr = Trainer(PORT_MODELS[variant](), "cosine", T, HR, lr=LR, device="cpu")
        state = tr.init_state(from_jax_variables(v["params"], v["batch_stats"]))
        b, tt, nn_ = batch, t, noise
        if pad:
            b = {k: torch.cat([a, a]) for k, a in batch.items()}
            b["pad_mask"] = torch.tensor([1.0] * B + [0.0] * B)
            tt, nn_ = torch.cat([t, t]), torch.cat([noise, noise])
        loss = tr.train_step(state, b, tt, nn_)
        out.append((float(loss), [p.grad.clone() for p in state.model.parameters()]))
    (l0, g0), (l1, g1) = out
    assert l1 == pytest.approx(l0, rel=1e-5)
    gmax = max(float(g.abs().max()) for g in g0)
    assert all(float((a - b).abs().max()) <= 1e-5 * gmax for a, b in zip(g0, g1))


def test_q_sample_and_timesteps_match_reference():
    """q_sample on the reference's noise gives the reference's x_t (its t
    and noise drawn from one key); the timesteps are uniform over [1, T);
    DiffusionProcess draws its noise from the generator it is given."""
    from diffusionremotesensing_tpu_torch import diffusion as tdiff
    from diffusionremotesensing_tpu_torch.schedules import make_schedule

    x0 = np.random.default_rng(2).random((B, HR, HR, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    t = np.array(jdiff.sample_timesteps(key, B, T))
    x_t, eps = jdiff.q_sample(jdiff.make_schedule("cosine", T), jnp.asarray(x0), jnp.asarray(t),
                              key)
    got = tdiff.q_sample(make_schedule("cosine", T), torch.from_numpy(x0),
                         torch.from_numpy(t).long(), torch.from_numpy(np.array(eps)))
    np.testing.assert_allclose(got.numpy(), np.asarray(x_t), rtol=1e-6, atol=1e-6)
    ts = tdiff.sample_timesteps(torch.Generator().manual_seed(0), 4096, T)
    assert ts.dtype == torch.int64 and int(ts.min()) == 1 and int(ts.max()) == T - 1
    proc = tdiff.make_process(PORT_MODELS["superres"](), "cosine", T, HR)
    a = proc.q_sample(torch.from_numpy(x0), ts[:B], torch.Generator().manual_seed(3))
    b = proc.q_sample(torch.from_numpy(x0), ts[:B], torch.Generator().manual_seed(3))
    assert torch.equal(a[0], b[0]) and a[1].shape == x0.shape
    assert torch.equal(proc.sample_timesteps(torch.Generator().manual_seed(0), 8), ts[:8])


def test_bf16_compute_eval_forward_matches_reference():
    """train=False with float32 parameters and bfloat16 compute (the
    trainer's validation forward): BatchNorm on the running statistics in
    float32 as flax's; the reference's dtype-bfloat16 model within 2e-2 of
    max |output| (measured 7.7e-3; the reference's own bf16 and float32
    forwards differ by 7.0e-3: bf16 rounds every layer's output)."""
    v = random_jax_variables(seed=3, image_size=HR, variant="superres")
    batch = _batch("superres", None)
    t = np.array([5, 300, 900, 1499], np.float32)
    ref = JAX_MODELS["superres"](dtype=jnp.bfloat16)
    want = np.asarray(jax.jit(lambda v, x, t, c: ref.apply(v, x, t, c, train=False))(
        v, batch["x"], t, batch["cond"]))
    m = PORT_MODELS["superres"](compute_dtype=torch.bfloat16)
    m.load_state_dict(from_jax_variables(v["params"], v["batch_stats"]))
    with torch.no_grad():
        got = m(torch.from_numpy(batch["x"]), torch.from_numpy(t),
                torch.from_numpy(batch["cond"])).numpy()
    assert m.conv0.weight.dtype == torch.float32 and got.dtype == np.float32
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
