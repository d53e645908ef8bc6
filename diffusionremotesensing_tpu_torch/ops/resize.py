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
