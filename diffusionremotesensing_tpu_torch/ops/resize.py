"""Torch-parity bicubic upsampling (port of ``diffusionremotesensing_tpu/ops/resize.py``).

The super-resolution condition stem upsamples the encoded LR image with
PyTorch's bicubic kernel (A = -0.75, half-pixel centres, border
replication). The reference package writes it as two dense resampling
matrices applied with einsum; this module keeps the same formulation, so
the two agree to float32 rounding, and the weights are built on the host
with numpy once per size.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_A = -0.75  # torch's cubic convolution alpha


def _cubic_weights(t: np.ndarray) -> np.ndarray:
    """4-tap weights for fractional offset t, taps at floor-1 .. floor+2."""
    A = _A
    w0 = ((A * (t + 1) - 5 * A) * (t + 1) + 8 * A) * (t + 1) - 4 * A
    w1 = ((A + 2) * t - (A + 3)) * t * t + 1
    u = 1.0 - t
    w2 = ((A + 2) * u - (A + 3)) * u * u + 1
    w3 = 1.0 - w0 - w1 - w2
    return np.stack([w0, w1, w2, w3], axis=-1)


@functools.lru_cache(maxsize=64)
def bicubic_resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """Dense (out_size, in_size) resampling matrix, float32."""
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    src_floor = np.floor(src)
    taps = _cubic_weights(src - src_floor)
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for k in range(4):
        idx = np.clip(src_floor.astype(np.int64) + (k - 1), 0, in_size - 1)
        np.add.at(mat, (dst.astype(np.int64), idx), taps[:, k])
    return mat.astype(np.float32)


def resize_bicubic(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bicubic resize of NHWC images to (out_h, out_w), accumulated in float32."""
    _, h, w, _ = x.shape
    wh = torch.from_numpy(bicubic_resize_weights(h, out_h)).to(x.device)
    ww = torch.from_numpy(bicubic_resize_weights(w, out_w)).to(x.device)
    y = torch.einsum("nhwc,Hh->nHwc", x.float(), wh)
    y = torch.einsum("nhwc,Ww->nhWc", y, ww)
    return y.to(x.dtype)


def upsample_bicubic(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Bicubic upsampling of NHWC images by an integer factor."""
    return resize_bicubic(x, x.shape[1] * scale, x.shape[2] * scale)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5."""
    x = np.abs(x)
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


@functools.lru_cache(maxsize=64)
def keys_resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """Dense (out_size, in_size) matrix of ``jax.image.resize``'s 'bicubic'
    (Keys a = -0.5, half-pixel centres, the taps that fall outside the
    input dropped and the rest renormalised; on an upsample the kernel is
    not widened), float32."""
    scale = out_size / in_size
    kernel_scale = max(1.0 / scale, 1.0)
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) / scale - 0.5
    w = _keys_cubic(np.abs(sample[:, None] - np.arange(in_size)[None, :]) / kernel_scale)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[:, None], w, 0.0).astype(np.float32)


def resize_bicubic_keys(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``jax.image.resize(x, ..., 'bicubic')`` of NHWC images, in float32:
    the resampling the reference package's W8A8 calibration and serving use
    for their bicubic proxies (another kernel than :func:`resize_bicubic`'s
    torch one)."""
    _, h, w, _ = x.shape
    wh = torch.from_numpy(keys_resize_weights(h, out_h)).to(x.device)
    ww = torch.from_numpy(keys_resize_weights(w, out_w)).to(x.device)
    y = torch.einsum("nhwc,Hh->nHwc", x.float(), wh)
    return torch.einsum("nhwc,Ww->nhWc", y, ww)
