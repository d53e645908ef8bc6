"""A 3x3 SAME convolution with bias for narrow outputs, Co <= 64 (port of
``diffusionremotesensing_tpu/ops/packed_conv.py``).

The reference wrote it for the flagship UNet's level-1 convolutions
(64->64 at 64x64, the ResConvBlock conv2, and 192->64, the up-stage concat
conv) and measured it slower than XLA's convolution there, so its model
never calls it: "not wired into the model" (reference
``ops/packed_conv.py:24-29``). The port keeps it as an op alone, with no
caller in the model, since the port adds no feature the reference lacks.
The reference's V-row lane packing (``pack_conv_weights``) is a device of
the TPU's lane layout: the port takes the HWIO kernel as it is.

:func:`packed_conv` launches the hand-written CUDA kernels of
``csrc/packed_conv.cu`` for CUDA tensors: bfloat16 (any Ci % 16 == 0, Co in
16, 32, 48, 64) runs the persistent wgmma kernel on TMA-fed slabs, float32
the FMA kernel. CPU tensors run :func:`packed_conv_plain`, the same function
in ``torch`` ops. A CUDA tensor the kernels cannot take raises, and so does
a bfloat16 x or k whose start is not 16-byte aligned (TMA reads them).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

import torch
import torch.nn.functional as F

from diffusionremotesensing_tpu_torch.ops import cuda_build

_COUNT_LOCK = threading.Lock()  # launches may come from several threads


def packed_conv_plain(x: torch.Tensor, k: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SAME convolution in ``torch`` ops: x (B,H,W,Ci) NHWC, k (kh,kw,Ci,Co)
    HWIO with odd kh, kw, bias (Co,) or None. The products accumulate in
    float32; the bias, rounded to x's dtype, is added to the float32 sum,
    which is rounded once to x's dtype. Returns (B,H,W,Co)."""
    kh, kw = k.shape[:2]
    y = F.conv2d(x.float().permute(0, 3, 1, 2), k.float().permute(3, 2, 0, 1),
                 padding=(kh // 2, kw // 2)).permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(x.dtype).float()
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load("packed_conv")
    lib.packed_conv_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.packed_conv_launch.restype = ctypes.c_int
    return lib


def _check(x, k, bias):
    """Raise unless the kernel takes these tensors as they are."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"packed_conv takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or k.dim() != 4:
        raise ValueError(f"packed_conv: x must be NHWC and k HWIO, got {tuple(x.shape)}, "
                         f"{tuple(k.shape)}")
    B, H, W, Ci = x.shape
    Co = k.shape[3]
    unit = 16 if x.dtype == torch.bfloat16 else 4  # wgmma's 16-deep steps; 16-byte copies
    if tuple(k.shape[:2]) != (3, 3) or Ci % unit or Co not in (16, 32, 48, 64):
        raise ValueError(f"packed_conv takes a 3x3 kernel, Ci % {unit} == 0 and Co in "
                         f"(16, 32, 48, 64), got {tuple(k.shape)}")
    ops = {"x": (x, (B, H, W, Ci)), "k": (k, (3, 3, Ci, Co))}
    if bias is not None:
        ops["bias"] = (bias, (Co,))
    cuda_build.check_operands("packed_conv", x, ops)
    if x.dtype == torch.bfloat16:
        cuda_build.check_aligned("packed_conv", {"x": x, "k": k})


def packed_conv(x: torch.Tensor, k: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """conv(x, k, SAME) + bias: x (B,H,W,Ci), k (3,3,Ci,Co) HWIO, bias (Co,)
    or None. CUDA tensors launch ``csrc/packed_conv.cu`` (each launch adds
    one to ``packed_conv.launches``); CPU tensors run
    :func:`packed_conv_plain`. Returns (B,H,W,Co) in x's dtype."""
    if x.device.type == "cpu":
        return packed_conv_plain(x, k, bias)
    if x.device.type != "cuda":
        raise ValueError(f"packed_conv runs on cuda or cpu tensors, got {x.device}")
    _check(x, k, bias)
    B, H, W, Ci = x.shape
    Co = k.shape[3]
    is_bf16 = int(x.dtype == torch.bfloat16)
    out = torch.empty((B, H, W, Co), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _library().packed_conv_launch(
            x.data_ptr(), k.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
            B, H, W, Ci, Co, is_bf16, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"packed_conv launch failed with CUDA error {rc}")
    with _COUNT_LOCK:
        packed_conv.launches += 1
    return out


packed_conv.launches = 0
