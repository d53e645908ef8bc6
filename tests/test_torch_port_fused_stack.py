"""The slice as a whole: the port's UNet with every fused kernel of the
super-resolution path on (tap44='block', fused_att=True, dec_block=True;
on the CPU each kernel's wrapper runs its plain version) against the
reference package's flax UNet with the same flags, whose Pallas kernels run
in interpret mode (float32, atol 1e-4); and the port's fused ancestral
sampler (fused_update=True, given bits) against its unfused sampler fed the
same noise through noise_fn."""

import jax
import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu.models.unet import residual_attention_unet_superres as jax_superres
from diffusionremotesensing_tpu_torch.diffusion import make_process
from diffusionremotesensing_tpu_torch.ops.s2d import depth_to_space
from tests.torch_port_helpers import model_inputs, port_model, random_jax_variables

FUSED = dict(s2d=True, tap44="block", fused_att=True, dec_block=True)


@pytest.fixture(scope="module")
def variables():
    return random_jax_variables(seed=11, image_size=16)


def test_fused_forward_matches_jax(variables):
    x, t, cond = model_inputs(seed=12, batch=2, hr=16)
    want = np.asarray(jax_superres(magnification_factor=2, **FUSED).apply(
        variables, x, t, cond, train=False))
    with torch.no_grad():
        got = port_model(variables, **FUSED)(*(torch.from_numpy(a) for a in (x, t, cond))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("flags", [dict(fused_att=True), dict(dec_block=True)],
                         ids=["fused_att", "dec_block"])
def test_each_fused_branch_matches_the_unfused_path(variables, flags):
    """Each flag alone: the same function as the unfused s2d forward."""
    x, t, cond = (torch.from_numpy(a) for a in model_inputs(seed=13, batch=2, hr=16))
    with torch.no_grad():
        want = port_model(variables, s2d=True)(x, t, cond)
        got = port_model(variables, s2d=True, **flags)(x, t, cond)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_fused_flags_need_the_s2d_path(variables):
    with pytest.raises(ValueError, match="s2d"):
        port_model(variables, fused_att=True)


def _box_muller(bits):
    """numpy float32 z from (2, ...) uint32 words, the reference's map."""
    f1 = (np.uint32(0x3F800000) | (bits[0] >> 9)).view(np.float32)
    f2 = (np.uint32(0x3F800000) | (bits[1] >> 9)).view(np.float32)
    return (np.sqrt(np.float32(-2.0) * np.log(np.float32(2.0) - f1))
            * np.cos(np.float32(6.283185307179586) * (f2 - np.float32(1.0))))


def test_fused_sampler_with_bits_matches_unfused_with_same_noise(variables):
    """A few ancestral steps (T=5) of the fused model: the fused update fed
    given bits against the unfused update fed the same z (in the original
    layout, as noise_fn takes it) through noise_fn."""
    proc = make_process(port_model(variables, **FUSED), "cosine", 5, 16)
    rng = np.random.default_rng(14)
    x_T = torch.from_numpy(rng.standard_normal((2, 16, 16, 3)).astype(np.float32))
    cond = torch.from_numpy(rng.random((2, 8, 8, 3)).astype(np.float32))
    bits = {i: rng.integers(0, 2**32, (2, 2, 8, 8, 12), dtype=np.uint32) for i in range(1, 5)}
    seen = []

    def bits_fn(i, shape):
        assert shape == (2, 8, 8, 12)  # the s2d state
        seen.append(i)
        return torch.from_numpy(bits[i].view(np.int32))

    def noise_fn(i, shape):
        return depth_to_space(torch.from_numpy(_box_muller(bits[i])))

    got = proc.sampler(fused_update=True)(x_T, cond, bits_fn=bits_fn)
    want = proc.sampler()(x_T, cond, noise_fn=noise_fn)
    assert seen == [4, 3, 2, 1]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)
    with pytest.raises(ValueError, match="noise_fn"):
        proc.sampler(fused_update=True)(x_T, cond, noise_fn=noise_fn)
