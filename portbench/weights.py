"""A configuration's weights, made on the card from the seed.

Every convolution, ConvTranspose and linear layer's weight and bias is
uniform in +-1/sqrt(fan_in) (torch's default initialisation), drawn as
slices of one ``torch.rand`` call; the label embedding is standard normal
(one ``torch.randn`` call); BatchNorms start as torch's do (scale 1, bias
0, running mean 0, variance 1). The same tensors go to the program
(``load_state_dict``) and to the plain reference.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference.unet import BN_ALIASES, fan_in, param_shapes, trainable


def shapes_of(config: dict):
    return param_shapes(config["conditioning"], config["image_channels"],
                        config.get("num_classes"))


def make(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of ``config``'s UNet drawn from ``seed``, float32
    on ``device``."""
    shapes = shapes_of(config)
    names = trainable(shapes)
    g = torch.Generator(device=device).manual_seed(seed)
    dense = [n for n in names if not _is_bn(shapes, n) and not n.startswith("label_emb")]
    total = sum(math.prod(shapes[n]) for n in dense)
    flat = torch.rand(total, generator=g, device=device).mul_(2.0).sub_(1.0)
    out: Dict[str, torch.Tensor] = {}
    offset = 0
    for n in dense:
        size = math.prod(shapes[n])
        layer = n.rsplit(".", 1)[0]
        bound = 1.0 / math.sqrt(fan_in(n, shapes[f"{layer}.weight"]))
        out[n] = flat[offset:offset + size].view(shapes[n]).mul_(bound)
        offset += size
    if "label_emb.weight" in shapes:
        out["label_emb.weight"] = torch.randn(shapes["label_emb.weight"], generator=g,
                                              device=device)
    state: Dict[str, torch.Tensor] = {}
    for n, shape in shapes.items():
        layer, leaf = n.rsplit(".", 1)
        if n in out:
            state[n] = out[n]
        elif _aliased(n) in state:
            state[n] = state[_aliased(n)]
        elif leaf in ("weight", "running_var"):
            state[n] = torch.ones(shape, device=device)
        elif leaf in ("bias", "running_mean"):
            state[n] = torch.zeros(shape, device=device)
        else:  # num_batches_tracked
            state[n] = torch.zeros(shape, dtype=torch.int64, device=device)
    return state


def _is_bn(shapes, name: str) -> bool:
    return f"{name.rsplit('.', 1)[0]}.running_mean" in shapes


def _aliased(name: str) -> str:
    """The first name of a BatchNorm registered under two (``conv1.1`` is
    ``batch_norm1``), else the name itself."""
    for first, second in BN_ALIASES.items():
        if f".{second}." in name:
            return name.replace(f".{second}.", f".{first}.")
    return name
