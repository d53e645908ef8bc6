"""The port's UNet (diffusionremotesensing_tpu_torch/models) against the
reference package's flax UNet with the same weights, carried across by
convert.from_jax_variables: the plain forward, the parameter count and the
state_dict keys. Float32 on the CPU, atol 1e-4 (as tests/test_s2d_model.py
holds the reference's own execution paths to each other)."""

import jax
import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu.io import export_torch_state_dict
from diffusionremotesensing_tpu.models.unet import residual_attention_unet_superres as jax_superres
from diffusionremotesensing_tpu_torch.convert import from_jax_variables, init_params
from diffusionremotesensing_tpu_torch.models.unet import (
    ResidualAttentionUNet,
    param_count,
    residual_attention_unet_superres,
)
from tests.torch_port_helpers import model_inputs, port_model, random_jax_variables


@pytest.fixture(scope="module")
def variables():
    return random_jax_variables(seed=0)


def test_plain_forward_matches_jax(variables):
    x, t, cond = model_inputs(seed=1)
    want = np.asarray(jax_superres(magnification_factor=2).apply(variables, x, t, cond, train=False))
    with torch.no_grad():
        got = port_model(variables)(torch.from_numpy(x), torch.from_numpy(t),
                                    torch.from_numpy(cond)).numpy()
    assert got.shape == want.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_encode_cond_matches_jax(variables):
    _, _, cond = model_inputs(seed=2)
    want = np.asarray(jax_superres(magnification_factor=2).apply(
        variables, cond, method="encode_cond"))
    with torch.no_grad():
        got = port_model(variables).encode_cond(torch.from_numpy(cond)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_param_count_is_the_reference_contract():
    assert param_count(residual_attention_unet_superres(magnification_factor=2)) == 4_383_058


def test_state_dict_keys_equal_the_reference_export(variables):
    exported = export_torch_state_dict(variables, conditioning="superres")
    model = residual_attention_unet_superres(magnification_factor=2)
    assert set(model.state_dict()) == set(exported)
    converted = from_jax_variables(variables["params"], variables["batch_stats"])
    assert set(converted) == set(exported)
    for k, v in exported.items():
        np.testing.assert_array_equal(converted[k].numpy(), v.numpy(), err_msg=k)
    model.load_state_dict(exported, strict=True)


def test_duplicate_batchnorm_names_share_one_module():
    m = residual_attention_unet_superres()
    blk = m.conv_blocks[0]
    assert blk.conv1[1] is blk.batch_norm1
    assert blk.shortcut_conv[1] is blk.shortcut_batch_norm
    sd = m.state_dict()
    assert "conv_blocks.0.conv1.1.running_var" in sd and "conv_blocks.0.batch_norm1.running_var" in sd


def test_init_params_is_seeded_and_loads_strict():
    a, b = init_params(3, device="cpu"), init_params(3, device="cpu")
    assert set(a) == set(residual_attention_unet_superres().state_dict())
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv0.weight"], init_params(4, device="cpu")["conv0.weight"])
    residual_attention_unet_superres().load_state_dict(a, strict=True)


# tap44='l1', the class conditioning and s2d_train (training) are ported
# now; 'l2' is no level of the reference, 'depth' no conditioning of it
@pytest.mark.parametrize("kwargs", [{"conditioning": "depth"}, {"tap44": "l2"}, {"tap44": 1}])
def test_unported_options_raise(kwargs):
    with pytest.raises((ValueError, NotImplementedError)):
        ResidualAttentionUNet(**kwargs)


def test_missing_condition_raises():
    m = residual_attention_unet_superres().eval()
    with pytest.raises(ValueError):
        m(torch.zeros(1, 16, 16, 3), torch.ones(1))
