"""The port's UNet at the tap44 levels 'conv2', True, 'stem' and 'l1', with
use_pallas and with packed_head (each kernel's wrapper runs its plain
version on the CPU)
against the reference package's flax UNet (float32, atol 1e-4, as for the
other s2d configurations): tap44=True (tap_conv_pair and tap_conv) and the
stem configuration (tap_stem_block, the fused gates, att_head_block,
dec_block), 'packed' (tap_block and packed_head), 'l1' (tap_block at levels
0 and 1) and 'l1_fused' ('l1' with gate 0 fused, att_head_block and
dec_block) against the reference with the same flags, its Pallas kernels
in interpret mode; the others against the reference's dense forward of
the same path, which the reference's own tests pin equal to its kernel
configurations (interpret mode there costs a JAX compile each, ~5-10 s).
Each also against the port's dense-s2d forward (float32, atol 1e-5: the
same function, sums in other orders), at HR 32. Then what each level prepares, the
stem configuration in bfloat16 against dense-s2d, a DDIM-3 sample of the
stem process against the 'block' process, and where packed_head runs."""

import jax
import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu.models.unet import residual_attention_unet_superres as jax_superres
from diffusionremotesensing_tpu_torch.diffusion import make_process
from tests.torch_port_helpers import model_inputs, port_model, random_jax_variables

STEM = dict(s2d=True, tap44="stem", fused_att=True, dec_block=True, use_pallas=True)
PACKED = dict(s2d=True, tap44="block", packed_head=True)
L1 = dict(s2d=True, tap44="l1")
L1_FUSED = dict(L1, use_pallas=True, fused_att=True, dec_block=True)
# name: (the port's flags, the reference's flags it is held against)
CONFIGS = {
    "packed": (PACKED, PACKED),
    "l1": (L1, L1),
    "l1_fused": (L1_FUSED, dict(L1_FUSED, use_pallas="interpret")),
    "conv2": (dict(s2d=True, tap44="conv2"), dict(s2d=True)),
    "tap": (dict(s2d=True, tap44=True), dict(s2d=True, tap44=True)),
    "stem_level": (dict(s2d=True, tap44="stem"), dict(s2d=True)),
    "stem": (STEM, dict(STEM, use_pallas="interpret")),
    "plain_use_pallas": (dict(use_pallas=True), dict()),
    "s2d_use_pallas": (dict(s2d=True, use_pallas=True), dict(s2d=True)),
}
_JAX_OUT = {}  # the reference's outputs by flags, computed once per session


@pytest.fixture(scope="module")
def variables():
    return random_jax_variables(seed=11, image_size=32)


@pytest.fixture(scope="module")
def inputs():
    return model_inputs(seed=15, batch=2, hr=32)


def _port(variables, inputs, **flags):
    with torch.no_grad():
        return port_model(variables, **flags)(*(torch.from_numpy(a) for a in inputs)).numpy()


@pytest.fixture(scope="module")
def dense(variables, inputs):
    return _port(variables, inputs, s2d=True)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_jax_and_dense_s2d(variables, inputs, dense, name):
    flags, jflags = CONFIGS[name]
    got = _port(variables, inputs, **flags)
    key = tuple(sorted(jflags.items()))
    if key not in _JAX_OUT:  # one XLA compile of the whole forward: quicker than eager here
        jm = jax_superres(magnification_factor=2, **jflags)
        _JAX_OUT[key] = np.asarray(jax.jit(lambda v, *a: jm.apply(v, *a, train=False))(
            variables, *inputs))
    np.testing.assert_allclose(got, _JAX_OUT[key], atol=1e-4)
    np.testing.assert_allclose(got, dense, atol=1e-5)


@pytest.mark.parametrize("tap44,has,lacks", [
    ("conv2", {"conv0", "blk_conv1", "blk_skip", "blk_conv2_44", "blk_short"},
     {"blk_conv2", "blk_conv1_44", "tap_block", "tap_stem"}),
    (True, {"conv0", "blk_conv1_44", "blk_skip_44", "blk_conv2_44", "blk_short"},
     {"blk_conv1", "blk_skip", "blk_conv2", "tap_block"}),
    ("stem", {"tap_stem", "conv0_b"}, {"conv0", "tap_block", "blk_conv1", "blk_short"}),
    ("block", {"conv0", "tap_block", "down0", "down0_b"},
     {"tap_block1", "down0_s2d", "down1_s2d", "att1_wx", "att1_rc", "blk_conv1"}),
    ("l1", {"conv0", "tap_block", "down0_s2d", "down0_s2d_b", "tap_block1", "down1_s2d", "down1_b",
            "att1_wx", "att1_wx_b", "att1_rc", "att1_rc_b", "att1_bn_a", "att1_bn_c"},
     {"down0", "down0_b", "tap_stem", "blk_conv1"}),
])
def test_each_level_prepares_what_it_uses(variables, tap44, has, lacks):
    k = port_model(variables, s2d=True, tap44=tap44).prepare_s2d_kernels()
    assert has <= set(k) and not lacks & set(k)
    assert "gate0" not in k


def test_use_pallas_prepares_float32_gate_weights(variables):
    """The gates' weights stay float32 when the rest is cast to bf16; the
    bf16 kernel's ``wt`` is their two-part bf16 split, hi + lo within 2**-16
    of each float32 weight."""
    from diffusionremotesensing_tpu_torch.ops.attention_gate import WEIGHTS

    m = port_model(variables, s2d=True, use_pallas=True)
    k = m.prepare_s2d_kernels(torch.bfloat16)
    assert k["conv0"].dtype == torch.bfloat16
    assert {k["gate0"]["wx"].shape, k["gate1"]["wx"].shape} == {(512, 128), (256, 64)}
    assert all(k[f"gate{i}"][n].dtype == torch.float32 for i in (0, 1) for n in WEIGHTS)
    for i in (0, 1):
        w = k[f"gate{i}"]
        assert set(w) == set(WEIGHTS) | {"wt"} and w["wt"].dtype == torch.bfloat16
        cat = torch.cat([w["wg"], w["wx"], w["wr"]])
        err = (w["wt"][0].float() + w["wt"][1].float() - cat).abs()
        assert (err <= 2.0 ** -16 * cat.abs()).all()


def test_stem_configuration_bf16_close_to_dense(variables, inputs):
    """bfloat16: every layer's output is rounded to bf16, at other places
    on the two paths (the fused gates round only their output), so the two
    differ by a few bf16 ulps (2**-8 relative) of the output's scale."""
    x, t, cond = (torch.from_numpy(a) for a in inputs)
    with torch.no_grad():
        want = port_model(variables, s2d=True).to(torch.bfloat16)(x, t, cond)
        got = port_model(variables, **STEM).to(torch.bfloat16)(x, t, cond)
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= 2e-2 * scale


def test_stem_ddim3_sample_matches_block(variables):
    rng = np.random.default_rng(16)
    x_T = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32))
    cond = torch.from_numpy(rng.random((2, 16, 16, 3)).astype(np.float32))
    outs = [make_process(port_model(variables, **flags), "cosine", 50, 32)
            .ddim_sampler(3, clip_x0=True)(x_T, cond).numpy()
            for flags in (dict(s2d=True, tap44="block"), STEM)]
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-5)


def test_l1_prepares_level1_without_skip_and_gate0_only(variables):
    """'l1': ResConvBlock-1's tap weights carry no skip conv (w1 is
    (16Ci, 2*4Co) at Ci=32, Co=64); with use_pallas only gate 0 is fused."""
    k = port_model(variables, **L1_FUSED).prepare_s2d_kernels()
    assert tuple(k["tap_block1"]["w1"].shape) == (16 * 32, 2 * 256)
    assert tuple(k["tap_block"]["w1"].shape) == (16 * 16, 3 * 128)
    assert "gate0" in k and "gate1" not in k


@pytest.mark.parametrize("flags,packed", [
    (PACKED, True),
    (dict(L1, packed_head=True), True),
    (dict(PACKED, fused_att=True), False),
    (dict(PACKED, dec_block=True), False),
    (dict(L1_FUSED, packed_head=True), False),
])
def test_packed_head_runs_only_on_the_unfused_tail(variables, inputs, dense, monkeypatch, flags,
                                                    packed):
    """packed_head replaces the head's two convs on the unfused tail; with
    fused_att or dec_block those convs live in the fused kernels, and the
    flag neither prepares its weights nor calls packed_head."""
    from diffusionremotesensing_tpu_torch.models import unet

    calls = []
    real = unet.packed_head_kernel
    monkeypatch.setattr(unet, "packed_head_kernel", lambda *a: calls.append(1) or real(*a))
    m = port_model(variables, **flags)
    assert ("packed_head" in m.prepare_s2d_kernels()) == packed
    with torch.no_grad():
        got = m(*(torch.from_numpy(a) for a in inputs)).numpy()
    assert len(calls) == int(packed)
    np.testing.assert_allclose(got, dense, atol=1e-5)


def test_packed_head_needs_s2d():
    with pytest.raises(ValueError, match="s2d"):
        port_model(random_jax_variables(seed=11, image_size=32), packed_head=True)


def test_l1_configuration_bf16_close_to_dense(variables, inputs):
    """bfloat16, 'l1' with the fused kernels against dense-s2d: a few bf16
    ulps of the output's scale, as for the stem configuration."""
    x, t, cond = (torch.from_numpy(a) for a in inputs)
    with torch.no_grad():
        want = port_model(variables, s2d=True).to(torch.bfloat16)(x, t, cond)
        got = port_model(variables, **dict(L1_FUSED, packed_head=True)).to(torch.bfloat16)(
            x, t, cond)
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= 2e-2 * scale
