"""The port's UNet at magnification_factor=4 against the reference
package's flax UNet on the same weights: the plain forward, and the s2d
forward (dense s2d and tap44='block'; the reference runs its Pallas
tap_block in interpret mode off-TPU). The factor only sizes the bicubic
upsample of the condition image (LR edge = HR edge / 4), so the x2 tree of
random variables serves both. Float32 on the CPU, atol 1e-4, as
tests/test_torch_port_model.py holds the x2 model."""

import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu.models.unet import residual_attention_unet_superres as jax_superres
from diffusionremotesensing_tpu_torch.convert import from_jax_variables
from diffusionremotesensing_tpu_torch.models.unet import (
    residual_attention_unet_superres as torch_superres,
)
from tests.torch_port_helpers import random_jax_variables


@pytest.fixture(scope="module")
def variables():
    return random_jax_variables(seed=3)


def _inputs(seed, batch=2, hr=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, hr, hr, 3)).astype(np.float32)
    t = rng.integers(1, 1500, (batch,)).astype(np.int32)
    cond = rng.random((batch, hr // 4, hr // 4, 3)).astype(np.float32)
    return x, t, cond


def _port(variables, **kwargs):
    m = torch_superres(magnification_factor=4, **kwargs)
    m.load_state_dict(from_jax_variables(variables["params"], variables["batch_stats"]),
                      strict=True)
    return m.eval()


@pytest.mark.parametrize("kwargs", [{}, {"s2d": True}, {"s2d": True, "tap44": "block"}],
                         ids=["plain", "s2d", "s2d_block"])
def test_x4_forward_matches_jax(variables, kwargs):
    x, t, cond = _inputs(seed=4)
    want = np.asarray(jax_superres(magnification_factor=4, **kwargs).apply(
        variables, x, t, cond, train=False))
    with torch.no_grad():
        got = _port(variables, **kwargs)(torch.from_numpy(x), torch.from_numpy(t),
                                         torch.from_numpy(cond)).numpy()
    assert got.shape == want.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_x4_encode_cond_matches_jax(variables):
    """The condition stem alone: RRDB encode, bicubic x4, conv."""
    _, _, cond = _inputs(seed=5)
    want = np.asarray(jax_superres(magnification_factor=4).apply(
        variables, cond, method="encode_cond"))
    with torch.no_grad():
        got = _port(variables).encode_cond(torch.from_numpy(cond)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
