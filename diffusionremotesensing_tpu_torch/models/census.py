"""Per-module parameter census (port of
``diffusionremotesensing_tpu/models/census.py``).

    python -m diffusionremotesensing_tpu_torch.models.census

prints the three models' census: super-resolution x2, SAR->NDVI and
class-conditional generation (10 classes). Rows come from
``named_parameters()`` (a BatchNorm registered under two names counts
once), grouped by top-level module; a ModuleList's children are modules of
their own (``conv_blocks.0``), as the reference's ``conv_block0`` is.
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Union

import torch
import torch.nn as nn

from diffusionremotesensing_tpu_torch.models.unet import (
    ResidualAttentionUNet,
    residual_attention_unet_generation,
    residual_attention_unet_sar_to_ndvi,
    residual_attention_unet_superres,
)


def _model_of(state_dict: Dict[str, torch.Tensor]) -> ResidualAttentionUNet:
    """The UNet whose state_dict ``state_dict`` is (its conditioning, channels
    and classes read from the keys and shapes)."""
    image_ch = state_dict["conv0.weight"].shape[1]
    out_dim = state_dict["output.weight"].shape[0]
    if "LR_encoder.conv_out.weight" in state_dict:
        model = residual_attention_unet_superres(image_channels=image_ch, out_dim=out_dim)
    elif "SAR_encoder.conv_out.weight" in state_dict:
        model = residual_attention_unet_sar_to_ndvi(
            sar_channels=state_dict["SAR_encoder.conv_out.weight"].shape[1],
            ndvi_channels=image_ch)
    else:
        emb = state_dict.get("label_emb.weight")
        model = residual_attention_unet_generation(
            image_channels=image_ch, out_dim=out_dim,
            num_classes=None if emb is None else emb.shape[0])
    missing = set(model.state_dict()) ^ set(state_dict)
    if missing:
        raise KeyError(f"not a state_dict of the port's UNet: {sorted(missing)[:5]} ...")
    return model


def parameter_census(model_or_state_dict: Union[nn.Module, Dict[str, torch.Tensor]]
                     ) -> List[Tuple[str, int]]:
    """(dotted name, number of parameters) rows of a model's
    ``named_parameters()``, or of the model a state_dict belongs to."""
    if isinstance(model_or_state_dict, nn.Module):
        return [(n, p.numel()) for n, p in model_or_state_dict.named_parameters()]
    sd = model_or_state_dict
    return [(n, sd[n].numel()) for n, _ in _model_of(sd).named_parameters()]


def module_of(name: str) -> str:
    """The top-level module a parameter belongs to: its first name part, and
    the index after it when that part is a ModuleList (``conv_blocks.0``)."""
    parts = name.split(".")
    return ".".join(parts[:2]) if len(parts) > 2 and parts[1].isdigit() else parts[0]


def module_totals(model_or_state_dict) -> Dict[str, int]:
    """Parameters per top-level module (:func:`module_of`)."""
    out: Dict[str, int] = {}
    for name, n in parameter_census(model_or_state_dict):
        out[module_of(name)] = out.get(module_of(name), 0) + n
    return out


def print_census(model_or_state_dict) -> int:
    """Print per-module totals and the grand total; returns the total."""
    by_module = module_totals(model_or_state_dict)
    for mod, n in sorted(by_module.items()):
        print(f"{mod:>24s}: {n:>10,d}")
    total = sum(by_module.values())
    print(f"{'TOTAL':>24s}: {total:>10,d}")
    return total


CENSUS_MODELS = (
    ("superres (x2)", lambda: residual_attention_unet_superres(magnification_factor=2)),
    ("SAR->NDVI", residual_attention_unet_sar_to_ndvi),
    ("generation (10 classes)", lambda: residual_attention_unet_generation(num_classes=10)),
)


if __name__ == "__main__":
    for label, factory in CENSUS_MODELS:
        print(f"\n=== {label} ===")
        print_census(factory())
