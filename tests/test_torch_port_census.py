"""The port's parameter census (``models/census.py``) against the reference
package's: per-module totals, after the name map, and grand totals for the
three models; the printed format; a state_dict counts as its model."""

import re
import subprocess
import sys

import jax
import pytest

from diffusionremotesensing_tpu.models.census import parameter_census as jax_census
from diffusionremotesensing_tpu.models.unet import (
    init_unet_params,
    residual_attention_unet_generation,
    residual_attention_unet_sar_to_ndvi,
    residual_attention_unet_superres,
)
from diffusionremotesensing_tpu_torch.models import census
from diffusionremotesensing_tpu_torch.models.census import CENSUS_MODELS

JAX_MODELS = {
    "superres (x2)": (lambda: residual_attention_unet_superres(magnification_factor=2), "superres"),
    "SAR->NDVI": (residual_attention_unet_sar_to_ndvi, "sar"),
    "generation (10 classes)": (lambda: residual_attention_unet_generation(num_classes=10),
                                "class"),
}
TOTALS = {"superres (x2)": 4_383_058, "SAR->NDVI": 4_382_238,
          "generation (10 classes)": 4_383_022}


def port_module(jax_name: str, conditioning: str) -> str:
    """The reference's top-level module name -> the port's."""
    enc = {"superres": ("LR_encoder", "conv_upsampled_lr_img"),
           "sar": ("SAR_encoder", "conv_SAR_img")}.get(conditioning, (None, None))
    fixed = {"cond_encoder": enc[0], "conv_cond": enc[1], "bottle_neck": "bottle_neck",
             "conv0": "conv0", "output": "output", "label_emb": "label_emb"}
    if jax_name in fixed:
        return fixed[jax_name]
    m = re.fullmatch(r"(conv_block|down|gating|attention|up_conv|up)(\d+)", jax_name)
    lists = {"conv_block": "conv_blocks", "down": "downs", "gating": "gating_signals",
             "attention": "attention_blocks", "up_conv": "up_convs", "up": "ups"}
    return f"{lists[m.group(1)]}.{m.group(2)}"


@pytest.mark.parametrize("label", list(TOTALS))
def test_census_matches_the_reference(label):
    factory, conditioning = JAX_MODELS[label]
    # shapes only: no initialisation runs
    v = jax.eval_shape(lambda: init_unet_params(factory(), jax.random.PRNGKey(0), image_size=16))
    want = {}
    for name, n in jax_census(v["params"]):
        mod = port_module(name.split(".")[0], conditioning)
        want[mod] = want.get(mod, 0) + n
    model = dict(CENSUS_MODELS)[label]()
    got = census.module_totals(model)
    assert got == want
    assert sum(got.values()) == TOTALS[label]
    assert census.module_totals(model.state_dict()) == got


def test_print_census_format(capsys):
    model = dict(CENSUS_MODELS)["superres (x2)"]()
    assert census.print_census(model) == 4_383_058
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == f"{'TOTAL':>24s}: {4_383_058:>10,d}"
    assert f"{'conv_blocks.0':>24s}: {23_552:>10,d}" in lines
    assert [ln.split(":")[0].strip() for ln in lines[:-1]] == sorted(
        ln.split(":")[0].strip() for ln in lines[:-1])


def test_census_main_prints_the_three_models():
    r = subprocess.run([sys.executable, "-m", "diffusionremotesensing_tpu_torch.models.census"],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    totals = [int(ln.split(":")[1].replace(",", "")) for ln in r.stdout.splitlines()
              if ln.strip().startswith("TOTAL")]
    assert totals == list(TOTALS.values())
    assert [ln for ln in r.stdout.splitlines() if ln.startswith("===")] == [
        f"=== {label} ===" for label in TOTALS]


def test_a_foreign_state_dict_is_refused():
    sd = dict(CENSUS_MODELS)["SAR->NDVI"]().state_dict()
    sd["extra.weight"] = sd["conv0.weight"]
    with pytest.raises(KeyError):
        census.parameter_census(sd)
