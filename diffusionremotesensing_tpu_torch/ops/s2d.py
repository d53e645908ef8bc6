"""Space-to-depth execution of the full-resolution level (port of
``diffusionremotesensing_tpu/ops/s2d.py``).

Layout: tap index t = 2*di + dj for pixel offsets (di, dj) in {0,1}^2,

    x[b, 2i+di, 2j+dj, c] == s2d(x)[b, i, j, t*C + c].

The kernel transforms take HWIO kernels, as the reference's do, and return
HWIO kernels; each one's derivation is in the reference module's docstrings.
:func:`hwio_to_oihw` turns a result into the layout ``torch`` convolutions
take, and :func:`conv_nhwc` runs such a convolution on NHWC tensors through
channels-last views (no layout copy).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C), taps (0,0),(0,1),(1,0),(1,1)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """(B, H2, W2, 4C) -> (B, 2*H2, 2*W2, C)."""
    b, h2, w2, c4 = x.shape
    c = c4 // 4
    x = x.reshape(b, h2, w2, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, 2 * h2, 2 * w2, c)


def k3_to_s2d(w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME kernel (3,3,Ci,Co) -> dense s2d kernel (3,3,4Ci,4Co)."""
    ci, co = w.shape[2], w.shape[3]
    ws = w.new_zeros((3, 3, 4 * ci, 4 * co))
    for di in range(2):
        for u in range(3):
            p, qi = divmod(di + u - 1, 2)
            for dj in range(2):
                for v in range(3):
                    q, qj = divmod(dj + v - 1, 2)
                    ti, to = 2 * qi + qj, 2 * di + dj
                    ws[p + 1, q + 1, ti * ci:(ti + 1) * ci, to * co:(to + 1) * co] += w[u, v]
    return ws


def k3_to_s2d44(w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME kernel (3,3,Ci,Co) -> tap-structured (4,4,Ci,4Co):
    window position (r, s) = (di+u, dj+v) carries W[u, v] into output tap
    block 2*di+dj."""
    ci, co = w.shape[2], w.shape[3]
    ws = w.new_zeros((4, 4, ci, 4 * co))
    for di in range(2):
        for dj in range(2):
            t = 2 * di + dj
            for u in range(3):
                for v in range(3):
                    ws[di + u, dj + v, :, t * co:(t + 1) * co] = w[u, v]
    return ws


def k1_to_blockdiag(w: torch.Tensor) -> torch.Tensor:
    """1x1 kernel (1,1,Ci,Co) -> block-diagonal (1,1,4Ci,4Co)."""
    ci, co = w.shape[2], w.shape[3]
    ws = w.new_zeros((1, 1, 4 * ci, 4 * co))
    for t in range(4):
        ws[0, 0, t * ci:(t + 1) * ci, t * co:(t + 1) * co] = w[0, 0]
    return ws


def k3s2_to_s2d(w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 pad-1 kernel (3,3,Ci,Co) -> (2,2,4Ci,Co), applied at
    stride 1 with padding ((1,0),(1,0)) on the s2d input."""
    ci, co = w.shape[2], w.shape[3]
    ws = w.new_zeros((2, 2, 4 * ci, co))
    for u in range(3):
        p, qi = divmod(u - 1, 2)
        for v in range(3):
            q, qj = divmod(v - 1, 2)
            ti = 2 * qi + qj
            ws[p + 1, q + 1, ti * ci:(ti + 1) * ci, :] += w[u, v]
    return ws


def k2s2_to_1x1(w: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 pad-0 kernel (2,2,Ci,Co) -> (1,1,4Ci,Co)."""
    ci, co = w.shape[2], w.shape[3]
    ws = w.new_zeros((1, 1, 4 * ci, co))
    for di in range(2):
        for dj in range(2):
            t = 2 * di + dj
            ws[0, 0, t * ci:(t + 1) * ci, :] = w[di, dj]
    return ws


def kT_to_s2d(k: torch.Tensor) -> torch.Tensor:
    """ConvTranspose2x kernel in the forward-equivalent HWIO layout (3,3,Ci,Co)
    -> (2,2,Ci,4Co), applied at stride 1 with padding ((0,1),(0,1)) on the
    normal-layout input, giving the s2d-layout x2 output."""
    ci, co = k.shape[2], k.shape[3]
    taps = {0: [(0, 1)], 1: [(0, 0), (1, 2)]}
    ws = k.new_zeros((2, 2, ci, 4 * co))
    for di in range(2):
        for dj in range(2):
            t = 2 * di + dj
            for (p, u) in taps[di]:
                for (q, v) in taps[dj]:
                    ws[p, q, :, t * co:(t + 1) * co] += k[u, v]
    return ws


def kdown_to_s2d_out(w2: torch.Tensor) -> torch.Tensor:
    """Down-conv s2d kernel (2,2,4Ci,Co) -> (3,3,4Ci,4Co) emitting the s2d of
    the down conv's output (stride 2, padding ((1,0),(1,0)))."""
    ci4, co = w2.shape[2], w2.shape[3]
    ws = w2.new_zeros((3, 3, ci4, 4 * co))
    for di in range(2):
        for dj in range(2):
            t = 2 * di + dj
            for p in range(2):
                for q in range(2):
                    ws[di + p, dj + q, :, t * co:(t + 1) * co] = w2[p, q]
    return ws


def hwio_to_oihw(w: torch.Tensor) -> torch.Tensor:
    """HWIO kernel -> the OIHW layout of ``torch`` convolutions."""
    return w.permute(3, 2, 0, 1).contiguous()


def conv_nhwc(x, w_oihw, bias=None, padding=0, stride=1):
    """Convolution of an NHWC tensor with an OIHW kernel, returning NHWC.

    ``padding`` is an int (symmetric) or ((top, bottom), (left, right)).
    The convolution runs on the channels-last view of ``x``, so neither the
    input nor the output is copied to another layout."""
    if isinstance(padding, int):
        pad = padding
    else:
        (t, b), (l, r) = padding
        if t == b and l == r:
            pad = (t, l)
        else:
            x = F.pad(x, (0, 0, l, r, t, b))
            pad = 0
    y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, bias, stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def conv_s2d(x, w, padding, dtype=None, strides=(1, 1)):
    """The reference's conv helper: NHWC input, HWIO kernel, explicit padding
    ('VALID', 'SAME' for odd kernels, or ((t, b), (l, r)))."""
    dt = dtype or x.dtype
    if padding == "VALID":
        padding = 0
    elif padding == "SAME":
        padding = ((w.shape[0] - 1) // 2,) * 2, ((w.shape[1] - 1) // 2,) * 2
    return conv_nhwc(x.to(dt), hwio_to_oihw(w.to(dt)), padding=padding, stride=tuple(strides))
