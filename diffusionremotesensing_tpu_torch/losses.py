"""Training losses: MSE / MAE / Huber / MSE + VGG19 perceptual (port of
``diffusionremotesensing_tpu/losses.py``).

The reference's selection by name ('MSE' | 'MAE' | 'Huber' |
'MSE+Perceptual_noise'), the last 0.3 * MSE + 0.7 * the MSE of VGG19
features of the predicted and true noise images. Every loss takes
``weights``, a (B,) mask (the loader's ``pad_mask``) that gives wrap-padded
rows no weight, so a padded final batch has its unpadded loss, and
``denom``, the weight total to divide by in place of ``weights.sum()``
(``denom=1`` gives the weighted sum: the share of one rank's rows in a
global batch's loss, which the trainer divides by the global total).

:class:`VGG19Features` is torchvision's ``vgg19().features`` stack with its
layer indices, so that stack's ``state_dict()`` (keys '0.weight', '2.weight',
...) loads into it directly and a whole ``vgg19()`` state_dict loads through
:func:`vgg19_features_state`. Nothing is downloaded: without weights the
trainer refuses the perceptual loss unless told to use random features
(``allow_random_vgg``), which come from a seed.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch
import torch.nn as nn

from diffusionremotesensing_tpu_torch.ops.resize import resize_bicubic

__all__ = ["make_loss_fn", "VGG19Features", "vgg19_features_state", "vgg_perceptual_loss_fn",
           "mse", "mae", "huber"]


def _reduce(per_elem: torch.Tensor, weights: Optional[torch.Tensor],
            denom: Optional[float] = None) -> torch.Tensor:
    """The mean, or with ``weights`` (B,) the weighted mean of the
    per-sample means; with ``denom``, the weighted sum of the per-sample
    means over ``denom`` (weights of 1 when none are given)."""
    if weights is None and denom is None:
        return per_elem.mean()
    per_sample = per_elem.reshape(per_elem.shape[0], -1).mean(1)
    if weights is None:
        return per_sample.sum() / denom
    return (per_sample * weights).sum() / (weights.sum() if denom is None else denom)


def mse(pred, target, weights=None, denom=None):
    return _reduce((pred - target) ** 2, weights, denom)


def mae(pred, target, weights=None, denom=None):
    return _reduce((pred - target).abs(), weights, denom)


def huber(pred, target, delta: float = 1.0, weights=None, denom=None):
    """torch ``nn.HuberLoss(delta=1.0)`` semantics."""
    err = pred - target
    abs_err = err.abs()
    quad = 0.5 * err ** 2
    lin = delta * (abs_err - 0.5 * delta)
    return _reduce(torch.where(abs_err <= delta, quad, lin), weights, denom)


# torchvision's vgg19.features: (width, convs) per block, each block's convs
# with a ReLU after each and a 2x2 max pool at its end
_VGG19_PLAN = ((64, 2), (128, 2), (256, 4), (512, 4), (512, 4))
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class VGG19Features(nn.Sequential):
    """torchvision's ``vgg19().features``: 16 3x3 convs with ReLUs and five
    max pools, at torchvision's indices (convs at 0, 2, 5, 7, 10, ..., 34).
    NCHW. ``seed`` draws torch's default initialisation from a CPU
    generator, the same numbers on every machine."""

    def __init__(self, seed: int = 0):
        layers, ci = [], 3
        for width, n in _VGG19_PLAN:
            for _ in range(n):
                layers += [nn.Conv2d(ci, width, 3, padding=1), nn.ReLU(inplace=False)]
                ci = width
            layers.append(nn.MaxPool2d(2, 2))
        super().__init__(*layers)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for m in self:
                if isinstance(m, nn.Conv2d):
                    bound = 1.0 / m.weight[0].numel() ** 0.5
                    m.weight.copy_(torch.rand(m.weight.shape, generator=gen) * 2 * bound - bound)
                    m.bias.copy_(torch.rand(m.bias.shape, generator=gen) * 2 * bound - bound)
        self.requires_grad_(False)


def vgg19_features_state(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The ``features`` part of a whole torchvision ``vgg19()`` state_dict
    (keys 'features.N.*'), keyed as :class:`VGG19Features` takes it; a
    ``features`` state_dict passes through."""
    if any(k.startswith("features.") for k in state_dict):
        return {k[len("features."):]: v for k, v in state_dict.items()
                if k.startswith("features.")}
    return dict(state_dict)


def vgg_perceptual_loss_fn(vgg: VGG19Features) -> Callable:
    """The VGG19 perceptual MSE of NHWC images: each bicubic-resized to 224
    (align_corners=False) unless its WIDTH is already 224 (the reference's
    quirk: a non-square input of width 224 is not resized), normalised with
    ImageNet's statistics; the (weighted) mean squared difference of the
    final features."""

    def preprocess(img):
        if img.shape[-2] != 224:
            img = resize_bicubic(img, 224, 224)
        mean = torch.tensor(_IMAGENET_MEAN, device=img.device)
        std = torch.tensor(_IMAGENET_STD, device=img.device)
        return ((img - mean) / std).permute(0, 3, 1, 2)

    def loss(pred, target, weights=None, denom=None):
        return _reduce((vgg(preprocess(pred)) - vgg(preprocess(target))) ** 2, weights, denom)

    return loss


def make_loss_fn(name: str, vgg: Optional[VGG19Features] = None) -> Callable:
    """The loss of the reference's CLI name; 'MSE+Perceptual_noise' needs
    ``vgg``."""
    if name == "MSE":
        return mse
    if name == "MAE":
        return mae
    if name == "Huber":
        return huber
    if name == "MSE+Perceptual_noise":
        if vgg is None:
            raise ValueError("MSE+Perceptual_noise needs the VGG19 features (vgg=)")
        perceptual = vgg_perceptual_loss_fn(vgg)

        def combined(pred, target, weights=None, denom=None):
            # CombinedLoss(weight_first=0.3): 0.3 * MSE + 0.7 * perceptual
            return (0.3 * mse(pred, target, weights, denom)
                    + 0.7 * perceptual(pred, target, weights, denom))

        return combined
    raise ValueError("The Loss must be either MSE or MAE or Huber or MSE+Perceptual_noise")
