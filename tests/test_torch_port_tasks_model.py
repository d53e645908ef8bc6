"""The SAR->NDVI and class-conditional models of the port against the
reference package's, on the same weights (random, drawn with numpy, carried
over by convert.from_jax_variables): every configuration the port serves
them in (plain, dense-s2d, tap44 'block' and 'stem', fused_att + dec_block
with use_pallas, packed_head) computes the reference's plain forward, the
class model with labels and a CFG mask. Float32, atol 1e-4 of max |output|
(the kernels' plain versions sum the same products in other orders). Also
the parameter counts, the reference's state_dict names and the refusals."""

import functools

import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu.io import export_torch_state_dict
from diffusionremotesensing_tpu_torch.convert import conditioning_of, from_jax_variables, init_params
from diffusionremotesensing_tpu_torch.models.unet import (
    ResidualAttentionUNet,
    param_count,
    residual_attention_unet_generation,
    residual_attention_unet_sar_to_ndvi,
)
from tests.torch_port_helpers import GEN_CLASSES, JAX_MODELS, port_model, random_jax_variables

HR = 16
CONFIGS = {
    "plain": {},
    "dense": dict(s2d=True),
    "block": dict(s2d=True, tap44="block"),
    "stem": dict(s2d=True, tap44="stem"),
    "fused": dict(s2d=True, tap44="stem", fused_att=True, dec_block=True, use_pallas=True),
    "packed": dict(s2d=True, tap44="block", packed_head=True),
}


def _inputs(variant, seed=0):
    """x, t, the condition (SAR image or labels) and the CFG mask (None for SAR)."""
    rng = np.random.default_rng(seed)
    c = 1 if variant == "sar" else 3
    x = rng.standard_normal((2, HR, HR, c)).astype(np.float32)
    t = np.array([7, 1200], np.float32)
    if variant == "sar":
        return x, t, rng.random((2, HR, HR, 2)).astype(np.float32), None
    return x, t, np.array([1, 3], np.int64), np.array([1.0, 0.0], np.float32)


@functools.lru_cache(maxsize=None)
def _reference(variant):
    """The reference package's plain float32 forward on _inputs(variant)."""
    v = random_jax_variables(seed=3, image_size=HR, variant=variant)
    x, t, cond, mask = _inputs(variant)
    return np.asarray(JAX_MODELS[variant]().apply(v, x, t, cond, mask, train=False))


def test_parameter_counts_are_the_references():
    assert param_count(residual_attention_unet_sar_to_ndvi()) == 4_382_238
    assert param_count(residual_attention_unet_generation(num_classes=10)) == 4_383_022


@pytest.mark.parametrize("variant,conditioning", [("sar", "sar"), ("generation", "class")])
def test_state_dict_is_the_references_export(variant, conditioning):
    """from_jax_variables names every tensor as the reference torch model of
    the task does (its export_torch_state_dict), values equal, and reads the
    variant from the tree."""
    v = random_jax_variables(seed=3, image_size=HR, variant=variant)
    assert conditioning_of(v["params"]) == conditioning
    sd = from_jax_variables(v["params"], v["batch_stats"])
    want = export_torch_state_dict(v, conditioning)
    assert set(sd) == set(want) == set(port_model(v, variant).state_dict())
    assert all(torch.equal(sd[k].float(), want[k].float()) for k in want)


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("variant", ["sar", "generation"])
def test_model_matches_reference(variant, config):
    v = random_jax_variables(seed=3, image_size=HR, variant=variant)
    x, t, cond, mask = _inputs(variant)
    want = _reference(variant)
    m = port_model(v, variant, **CONFIGS[config])
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond),
                None if mask is None else torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_class_mask_zero_is_the_unconditioned_forward():
    """cond_mask 0 takes the label embedding out entirely: the same output
    as no labels at all; mask 1 is the labels' own."""
    v = random_jax_variables(seed=3, image_size=HR, variant="generation")
    m = port_model(v, "generation", s2d=True, tap44="block")
    x, t, labels, _ = (None if a is None else torch.from_numpy(a) for a in _inputs("generation"))
    with torch.no_grad():
        none = m(x, t, None)
        masked = m(x, t, labels, torch.zeros(2))
        full = m(x, t, labels, torch.ones(2))
        plain = m(x, t, labels)
    torch.testing.assert_close(masked, none, rtol=0, atol=1e-6)
    torch.testing.assert_close(full, plain, rtol=0, atol=0)
    assert (full - none).abs().max() > 1e-3


@pytest.mark.parametrize("variant", ["sar", "generation"])
def test_init_params_variants_load_strict_and_are_seeded(variant):
    a, b = init_params(5, variant, device="cpu"), init_params(5, variant, device="cpu")
    fac = {"sar": residual_attention_unet_sar_to_ndvi,
           "generation": residual_attention_unet_generation}[variant]
    fac().load_state_dict(a, strict=True)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv0.weight"], init_params(6, variant, device="cpu")["conv0.weight"])


def test_refusals():
    with pytest.raises(NotImplementedError, match="s2d_train"):
        residual_attention_unet_sar_to_ndvi(s2d_train=True)
    with pytest.raises(ValueError, match="conditioning"):
        ResidualAttentionUNet(conditioning="text")
    with pytest.raises(ValueError, match="variant"):
        init_params(0, "cpu")
    sar = residual_attention_unet_sar_to_ndvi().eval()
    with pytest.raises(ValueError, match="condition image"):
        sar(torch.zeros(1, HR, HR, 1), torch.ones(1))
    gen = residual_attention_unet_generation(num_classes=GEN_CLASSES).eval()
    with pytest.raises(ValueError, match="image-conditioned"):
        gen.encode_cond(torch.zeros(1, HR, HR, 3))
