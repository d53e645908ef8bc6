"""The port's s2d execution of the UNet (tap44=False: dense s2d
convolutions; tap44='block': ResConvBlock-0 through ops.tap_block, whose CPU
path is tap_block_plain) against the reference package's flax UNet on the
same weights. The reference runs its Pallas tap_block in interpret mode
off-TPU. Float32, atol 1e-4."""

import jax
import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu.models.unet import residual_attention_unet_superres as jax_superres
from diffusionremotesensing_tpu_torch.ops.s2d import space_to_depth
from tests.torch_port_helpers import model_inputs, port_model, random_jax_variables


@pytest.fixture(scope="module")
def variables():
    return random_jax_variables(seed=5)


@pytest.mark.parametrize("tap44", [False, "block"])
def test_s2d_forward_matches_jax(variables, tap44):
    x, t, cond = model_inputs(seed=6)
    jm = jax_superres(magnification_factor=2, s2d=True, tap44=tap44)
    want = np.asarray(jm.apply(variables, x, t, cond, train=False))
    with torch.no_grad():
        got = port_model(variables, s2d=True, tap44=tap44)(
            torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_s2d_io_with_hoisted_cond_and_kernels(variables):
    """The sampler's call: s2d state in and out, cond features and kernels
    prepared once outside."""
    x, t, cond = model_inputs(seed=7)
    m = port_model(variables, s2d=True, tap44="block")
    with torch.no_grad():
        want = m(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond))
        feats = m.encode_cond_s2d(torch.from_numpy(cond))
        got = m(space_to_depth(torch.from_numpy(x)), torch.from_numpy(t),
                cond_features=feats, s2d_kernels=m.prepare_s2d_kernels(), s2d_io=True)
    np.testing.assert_allclose(got.numpy(), space_to_depth(want).numpy(), atol=1e-6)


def test_bf16_prepared_kernels_keep_float32_fold(variables):
    """prepare_s2d_kernels folds in float32 and casts once: the bf16 weights
    equal the float32 ones rounded to bf16."""
    m = port_model(variables, s2d=True, tap44="block")
    k32, k16 = m.prepare_s2d_kernels(), m.prepare_s2d_kernels(torch.bfloat16)
    for name in ("w1", "w2", "b1", "bsh"):
        assert k16["tap_block"][name].dtype == torch.bfloat16
        assert torch.equal(k16["tap_block"][name], k32["tap_block"][name].to(torch.bfloat16))
    assert k16["head_bT_taps"].dtype == torch.float32
