"""The DownBlur degradation on the device (port of
``diffusionremotesensing_tpu/data/device_degradation.py``): the host decodes
HR images only and ships uint8 batches; the bilinear resize to the training
size, the bicubic downsample and the Gaussian blur of the reference's
``SuperresDownBlurDataset`` run batched on the device, with no PIL.

Each step is a matmul along one axis. The resampling matrices replicate
Pillow's convolution resampling: its weights quantised to 22-bit fixed point
(truncated toward zero, ``_PRECISION = 1 << 22``), the horizontal pass then
the vertical one, each rounded to uint8 with clip8 (floor(v + 0.5) clamped
to [0, 255]) between passes. Pillow's GaussianBlur is three extended box
filters; their band matrices (each with Pillow's edge clamp) are multiplied
into one per axis and the result rounded once, within 2/255 of Pillow (which
rounds its fixed-point accumulator per pass). The matrices are built on the
host in numpy (float64) and cast to float32; the pixel values stay integers
below 2^24, so the float32 products keep them whole up to the weights' own
rounding.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import numpy as np
import torch

__all__ = [
    "pil_resize_weights",
    "pil_gaussian_kernel",
    "blur_band_matrix",
    "make_downblur_transform",
]

_PRECISION = 1 << 22  # Pillow Resample.c PRECISION_BITS = 32 - 8 - 2
_INV255 = float(np.float32(1.0) / np.float32(255.0))  # x / 255 as XLA computes it


def _pil_filter(name: str):
    if name == "bilinear":
        return 1.0, lambda x: np.clip(1.0 - np.abs(x), 0.0, None)
    if name == "bicubic":
        a = -0.5

        def f(x):
            x = np.abs(x)
            return np.where(
                x < 1,
                ((a + 2) * x - (a + 3)) * x * x + 1,
                np.where(x < 2, (((x - 5) * x + 8) * x - 4) * a, 0.0),
            )

        return 2.0, f
    raise ValueError(f"unknown PIL filter {name!r}")


@functools.lru_cache(maxsize=256)
def pil_resize_weights(in_size: int, out_size: int, name: str) -> np.ndarray:
    """(out, in) resampling matrix of PIL's ``Image.resize`` along one axis:
    centre (i + 0.5) * scale, support widened by the scale on a downscale
    (antialiasing), weights normalised then quantised to 22-bit fixed point
    with C's truncation toward zero."""
    support, f = _pil_filter(name)
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    W = np.zeros((out_size, in_size), np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        w = f((np.arange(xmin, xmax) + 0.5 - center) / filterscale)
        w = w / w.sum()
        W[i, xmin:xmax] = np.trunc(w * _PRECISION + np.where(w >= 0, 0.5, -0.5)) / _PRECISION
    return W


def _extended_box_kernel(sigma: float, passes: int = 3) -> np.ndarray:
    """One pass of Pillow's GaussianBlur: an extended box filter whose
    fractional edge weight matches the per-pass variance sigma^2 / passes
    (Gwosdek et al., extended box filtering)."""
    s2 = sigma * sigma / passes
    l = 0  # noqa: E741 (the paper's name)
    while (l + 1) * (l + 2) / 3.0 <= s2:
        l += 1  # noqa: E741
    inner_var = l * (l + 1) * (2 * l + 1) / 3.0
    alpha = (s2 * (2 * l + 1) - inner_var) / (2.0 * (l + 1) ** 2 - 2.0 * s2)
    k = np.concatenate([[alpha], np.ones(2 * l + 1), [alpha]])
    return k / (2 * l + 1 + 2 * alpha)


@functools.lru_cache(maxsize=64)
def pil_gaussian_kernel(sigma: float, passes: int = 3) -> np.ndarray:
    """The three extended box passes convolved into one normalised kernel of
    odd length."""
    k = _extended_box_kernel(sigma, passes)
    c = k
    for _ in range(passes - 1):
        c = np.convolve(c, k)
    return c / c.sum()


@functools.lru_cache(maxsize=256)
def blur_band_matrix(size: int, sigma: float, passes: int = 3) -> np.ndarray:
    """(size, size) matrix of Pillow's GaussianBlur along one axis: the
    product of ``passes`` extended-box band matrices, each with Pillow's edge
    clamp (taps past the edge read the edge pixel). The clamp acts per pass:
    clamping the composed kernel differs near the borders."""
    k = _extended_box_kernel(sigma, passes)
    R = len(k) // 2
    B = np.zeros((size, size), np.float64)
    for i in range(size):
        for d in range(-R, R + 1):
            B[i, min(max(i + d, 0), size - 1)] += k[d + R]
    M = B
    for _ in range(passes - 1):
        M = B @ M
    return M


def _round_u8(x: torch.Tensor) -> torch.Tensor:
    """Pillow's clip8: floor(v + 0.5) clamped to [0, 255]."""
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)


def _resize_u8(x: torch.Tensor, oh: int, ow: int, name: str) -> torch.Tensor:
    """PIL's resize of a uint8-valued float batch (B, H, W, C): the
    horizontal pass, clip8, the vertical pass, clip8."""
    h, w = x.shape[1], x.shape[2]
    if w != ow:
        Ww = torch.from_numpy(pil_resize_weights(w, ow, name)).to(x.device, torch.float32)
        x = _round_u8(torch.einsum("bhwc,Ww->bhWc", x, Ww))
    if h != oh:
        Wh = torch.from_numpy(pil_resize_weights(h, oh, name)).to(x.device, torch.float32)
        x = _round_u8(torch.einsum("bhwc,Hh->bHwc", x, Wh))
    return x


def make_downblur_transform(source_size: int, magnification_factor: int, blur_radius: float,
                            image_size: Optional[int] = None) -> Callable:
    """The batched DownBlur on the batch's device.

    In: ``{'hr_u8': (B, source_size, source_size, C) uint8}`` (and an
    optional 'pad_mask', passed through). Out: ``{'x': the HR image in [0, 1]
    at image_size (default source_size), 'cond': the degraded LR image
    (image_size / magnification_factor) in [0, 1]}``, float32, as
    ``SuperresDownBlurDataset`` makes them up to the blur's tolerance."""
    hr = image_size or source_size
    lr = hr // magnification_factor
    blur = torch.from_numpy(blur_band_matrix(lr, float(blur_radius))).float()

    def transform(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        y = batch["hr_u8"].float()
        if hr != y.shape[1]:
            y = _resize_u8(y, hr, hr, "bilinear")
        x = _resize_u8(y, lr, lr, "bicubic")
        m = blur.to(y.device)
        # the separable blur: the band matrix along H then W, rounded once
        x = torch.einsum("Hh,bhwc->bHwc", m, x)
        x = _round_u8(torch.einsum("Ww,bhwc->bhWc", m, x))
        out = {"x": y * _INV255, "cond": x * _INV255}
        if "pad_mask" in batch:
            out["pad_mask"] = batch["pad_mask"]
        return out

    return transform
