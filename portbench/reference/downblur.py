"""The DownBlur degradation of the flagship recipe, plainly (the LR input
the super-resolution trainer derives from each HR image).

Pillow's bicubic downsample by the magnification (its convolution
resampling: the filter widened by the scale, weights normalised and
quantised to 22-bit fixed point, the horizontal pass then the vertical,
each rounded to uint8), then Pillow's GaussianBlur of the radius (three
extended box filters with edge clamping, here composed into one band
matrix per axis, rounded once). Images are uint8-valued; the outputs are
in [0, 1]. NumPy float64 builds the matrices.
"""

from __future__ import annotations

import numpy as np
import torch

_PRECISION = 1 << 22


def _bicubic(x):
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1, ((a + 2) * x - (a + 3)) * x * x + 1,
                    np.where(x < 2, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    scale = n_in / n_out
    fscale = max(scale, 1.0)
    support = 2.0 * fscale
    m = np.zeros((n_out, n_in))
    for i in range(n_out):
        c = (i + 0.5) * scale
        lo, hi = max(int(c - support + 0.5), 0), min(int(c + support + 0.5), n_in)
        w = _bicubic((np.arange(lo, hi) + 0.5 - c) / fscale)
        w = w / w.sum()
        m[i, lo:hi] = np.trunc(w * _PRECISION + np.where(w >= 0, 0.5, -0.5)) / _PRECISION
    return m


def blur_matrix(n: int, sigma: float, passes: int = 3) -> np.ndarray:
    s2 = sigma * sigma / passes
    r = 0
    while (r + 1) * (r + 2) / 3.0 <= s2:
        r += 1
    alpha = (s2 * (2 * r + 1) - r * (r + 1) * (2 * r + 1) / 3.0) / (2.0 * (r + 1) ** 2 - 2.0 * s2)
    k = np.concatenate([[alpha], np.ones(2 * r + 1), [alpha]]) / (2 * r + 1 + 2 * alpha)
    half = len(k) // 2
    band = np.zeros((n, n))
    for i in range(n):
        for d in range(-half, half + 1):
            band[i, min(max(i + d, 0), n - 1)] += k[d + half]
    m = band
    for _ in range(passes - 1):
        m = band @ m
    return m


def _round(x):
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)


def downblur(hr_u8: torch.Tensor, mag: int, radius: float):
    """(x in [0, 1], LR in [0, 1]) of a uint8 batch (B, H, W, C)."""
    y = hr_u8.float()
    h = y.shape[1]
    rm = torch.from_numpy(resize_matrix(h, h // mag)).float().to(y.device)
    x = _round(torch.einsum("bhwc,Ww->bhWc", y, rm))
    x = _round(torch.einsum("bhwc,Hh->bHwc", x, rm))
    bm = torch.from_numpy(blur_matrix(h // mag, radius)).float().to(y.device)
    x = _round(torch.einsum("Ww,bhwc->bhWc", bm, torch.einsum("Hh,bhwc->bHwc", bm, x)))
    return y / 255.0, x / 255.0
