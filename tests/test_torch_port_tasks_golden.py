"""chip_smoke.py's checks of the SAR->NDVI and class-conditional paths:
GOLDEN_SAR and GOLDEN_GEN are what the reference package computes for the
port's init_params(SEED, variant) weights (carried over by the reference's
own importer) at the golden inputs, and the port's CPU forward computes
them in every configuration the golden phase runs; the bounds count the
new widths' bytes and operations; each launch of a path counts in the row
of its shape."""

import os
import sys

import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu.io import import_torch_state_dict
from diffusionremotesensing_tpu.models.unet import (
    residual_attention_unet_generation as jax_generation,
    residual_attention_unet_sar_to_ndvi as jax_sar,
)
from diffusionremotesensing_tpu_torch.convert import init_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402

CASES = {"sar": (jax_sar, "GOLDEN_SAR", "golden_input_sar"),
         "generation": (lambda: jax_generation(num_classes=cs.NUM_CLASSES), "GOLDEN_GEN",
                        "golden_input_gen")}


@pytest.mark.parametrize("variant", list(CASES))
def test_golden_values_are_the_reference_output(variant):
    jax_model, gold, inputs = CASES[variant]
    g, (x, t, cond, mask) = getattr(cs, gold), getattr(cs, inputs)()
    out = np.asarray(jax_model().apply(import_torch_state_dict(init_params(cs.SEED, variant,
                                                                           device="cpu")),
                                       x, t, cond, mask, train=False))
    np.testing.assert_allclose(out.reshape(-1)[::g["stride"]], g["values"], atol=1e-6)
    assert abs(np.abs(out.astype(np.float64)).sum() - g["abs_sum"]) < 1e-3


@pytest.mark.parametrize("name", cs.GOLDEN_TASK_CONFIGS)
@pytest.mark.parametrize("variant", list(CASES))
def test_golden_configurations_agree_on_the_cpu(variant, name):
    """Each configuration of the golden phase computes the golden values on
    the CPU too (its kernels' plain versions), at the phase's tolerance."""
    _, gold, inputs = CASES[variant]
    g = getattr(cs, gold)
    m = cs.FACTORIES[variant](**cs.CONFIGS[name])
    m.load_state_dict(init_params(cs.SEED, variant, device="cpu"))
    with torch.no_grad():
        got = m.eval()(*(None if a is None else torch.from_numpy(a)
                         for a in getattr(cs, inputs)())).numpy()
    np.testing.assert_allclose(got.reshape(-1)[::g["stride"]], g["values"], atol=cs.GOLDEN_TOL)


def test_bounds_of_the_new_widths():
    """The stem at CX4 = 4 reads 8 bytes of x a pixel and does conv0 1 -> 16;
    the bias-only stem reads no cond; the heads at out4 = 4 write 4 channels
    and do a third of the head's work."""
    B, H, bf = 48, 32, 2
    ms, _ = cs.stem_bound(B, H, H, bf, cs.PEAK_BF16, CX4=4)
    assert ms == pytest.approx(cs.stem_flops(B, H, H, CX4=4) / cs.PEAK_BF16 * 1e3)
    assert cs.stem_flops(B, H, H, CX4=12) - cs.stem_flops(B, H, H, CX4=4) == \
        2 * B * (2 * H) ** 2 * 9 * 2 * 16
    # bytes: the bias-only stem moves B*H*W*64 elements fewer
    cheap = lambda **kw: cs.stem_bound(B, H, H, bf, 1e30, **kw)[0]  # noqa: E731
    assert cheap() - cheap(cond=False) == pytest.approx(bf * B * H * H * 64 / cs.PEAK_BYTES * 1e3)
    assert cs.att_flops(B, H, H) - cs.att_flops(B, H, H, out4=4) == 2 * B * H * H * 4 * 9 * 32 * 2
    assert cs.dec_flops(B, H, H) - cs.dec_flops(B, H, H, out4=4) == 2 * B * H * H * 25 * 64 * 2
    assert cs.head_flops(B, H, H, out4=4) * 3 == cs.head_flops(B, H, H)
    for f in (cs.att_bound, cs.dec_bound, cs.head_bound):
        assert f(B, H, H, bf, cs.PEAK_BF16, out4=4)[0] < f(B, H, H, bf, cs.PEAK_BF16)[0]


def test_shape_rows_take_their_paths_launches():
    """A launch on a SAR path counts in the row of the SAR shape, on a
    generation path the stem's in the bias-only row and the rest in the
    kernel's own; every shape row names a kernel of KERNELS."""
    assert cs.row_of("tap_stem_block", "sar") == "tap_stem_block_cx4_4"
    assert cs.row_of("tap_stem_block", "generation") == "tap_stem_block_bias_only"
    assert cs.row_of("tap_stem_block", "superres") == "tap_stem_block"
    assert cs.row_of("att_head_block", "generation") == "att_head_block"
    assert cs.row_of("att_head_block", "sar") == "att_head_block_out4_4"
    assert cs.row_of("fused_attention_gate", "sar") == "fused_attention_gate"
    assert cs.row_of("ancestral_update", "generation") == "ancestral_update"
    assert all(k in cs.KERNELS for k, _ in cs.SHAPE_ROWS.values())
    assert set(cs.GOLDEN_TASK_CONFIGS) <= set(cs.CONFIGS) and set(cs.MODEL_TASK_CONFIGS) <= set(cs.CONFIGS)
