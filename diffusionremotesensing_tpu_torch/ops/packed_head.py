"""The composed head's two convolutions as one kernel (port of
``diffusionremotesensing_tpu/ops/packed_head.py``).

The s2d tail ends in two convolutions with only ``out4 = 4 * out_dim``
output channels: ``head_up4`` (the head composed through UpConvBlock-2's
ConvTranspose, 4x4 on the 64-channel hh, padding ((1,2),(1,2))) and
``head_at`` (the head's attention branch, 3x3 SAME on the 128-channel
attn_s), both built by ``models.unet.prepare_s2d_kernels``. With
``packed_head=True`` the unfused tail runs them as one call,

    out = conv(hh, head_up4, pad ((1,2),(1,2))) + conv(attn_s, head_at, SAME)

with one float32 accumulator rounded once to hh's dtype, as the reference
kernel does. The reference packs 8 vertically adjacent output pixels into
the TPU's 128 lanes (``kpack_weights``), a device of the TPU's lane layout:
the port takes the unpacked HWIO kernels.

:func:`packed_head` launches the hand-written CUDA kernels of
``csrc/packed_head.cu`` for CUDA tensors and runs :func:`packed_head_plain`,
the same function in ``torch`` ops, for CPU tensors. Which kernel runs
depends on the shape and dtype alone (:func:`wgmma_takes`): bfloat16 at
widths whose weights fit in shared memory beside the slab ring (the served
C1 = 64, C2 = 128 among them) runs the persistent wgmma kernel on TMA-fed
slabs; wider bfloat16 (C2 > 128 at C1 = 64) runs the first design's
WMMA kernel, float32 its FMA kernel. Each launch of either counts once in
``packed_head.launches``. A CUDA tensor the kernels cannot take raises, and
so does an hh or attn_s for the wgmma kernel whose start is not 16-byte
aligned (TMA reads them). The kernels take any image height (the
reference's ``H % 8`` guard is a constraint of its packing).
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch
import torch.nn.functional as F

from diffusionremotesensing_tpu_torch.ops import cuda_build

_COUNT_LOCK = threading.Lock()  # launches may come from several server threads


def _conv_f32(x, w, pad):
    """NHWC x, HWIO w, ((top, bottom), (left, right)) padding, in float32."""
    (t, b), (l, r) = pad
    y = F.conv2d(F.pad(x.float().permute(0, 3, 1, 2), (l, r, t, b)), w.float().permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1)


def packed_head_plain(hh: torch.Tensor, attn_s: torch.Tensor, head_up4: torch.Tensor,
                      head_at: torch.Tensor) -> torch.Tensor:
    """Both convolutions in ``torch`` ops: hh (B,H,W,C1), attn_s (B,H,W,C2),
    head_up4 (4,4,C1,out4) and head_at (3,3,C2,out4) HWIO. Summed in float32
    and rounded once to hh's dtype. Returns (B,H,W,out4)."""
    out = _conv_f32(hh, head_up4, ((1, 2), (1, 2))) + _conv_f32(attn_s, head_at, ((1, 1), (1, 1)))
    return out.to(hh.dtype)


# csrc/packed_head.cu's head_tc_kernel: 64-channel planes, weight pieces of
# 2,048 bytes (one plane's 64 rows of a tap, 16 columns) resident beside
# 1,024 bytes of alignment, 3 plane slots of 50,176 and 6 mbarriers, in the
# 232,448 bytes of shared memory a block may have (tc_bytes)
_TC_FIXED_BYTES = 1024 + 3 * 50176 + 6 * 8
_PIECE_BYTES, _SMEM_MAX = 2048, 232448


def wgmma_takes(c1: int, c2: int, dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether :func:`packed_head` runs the wgmma kernel for hh of c1 and
    attn_s of c2 channels in ``dtype``: bfloat16 whose 16 ceil(c1/64) +
    9 ceil(c2/64) resident weight pieces fit in shared memory. Otherwise the
    first design's kernel runs (WMMA in bfloat16, FMA in float32)."""
    pieces = 16 * -(-c1 // 64) + 9 * -(-c2 // 64)
    return dtype == torch.bfloat16 and _TC_FIXED_BYTES + pieces * _PIECE_BYTES <= _SMEM_MAX


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load("packed_head")
    lib.packed_head_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.packed_head_launch.restype = ctypes.c_int
    return lib


def _check(hh, attn_s, head_up4, head_at):
    """Raise unless the kernel takes these tensors as they are."""
    if hh.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"packed_head takes float32 or bfloat16, got {hh.dtype}")
    if hh.dim() != 4 or attn_s.dim() != 4 or head_up4.dim() != 4:
        raise ValueError(f"packed_head: hh, attn_s must be NHWC, head_up4 HWIO, got "
                         f"{tuple(hh.shape)}, {tuple(attn_s.shape)}, {tuple(head_up4.shape)}")
    B, H, W, C1 = hh.shape
    C2, out4 = attn_s.shape[3], head_up4.shape[3]
    unit = 16 if hh.dtype == torch.bfloat16 else 4  # 16-deep MMA steps; 16-byte copies
    if C1 % unit or C2 % unit or not 1 <= out4 <= 16:
        raise ValueError(f"packed_head needs C1, C2 % {unit} == 0 and out4 <= 16, "
                         f"got {C1}, {C2}, {out4}")
    cuda_build.check_operands("packed_head", hh, {
        "hh": (hh, (B, H, W, C1)), "attn_s": (attn_s, (B, H, W, C2)),
        "head_up4": (head_up4, (4, 4, C1, out4)), "head_at": (head_at, (3, 3, C2, out4))})
    if wgmma_takes(C1, C2, hh.dtype):
        cuda_build.check_aligned("packed_head", {"hh": hh, "attn_s": attn_s})


def packed_head(hh: torch.Tensor, attn_s: torch.Tensor, head_up4: torch.Tensor,
                head_at: torch.Tensor) -> torch.Tensor:
    """conv(hh, head_up4, pad ((1,2),(1,2))) + conv(attn_s, head_at, SAME)
    in one call. CUDA tensors launch ``csrc/packed_head.cu``'s wgmma kernel
    where :func:`wgmma_takes` says so, else its first design's kernel (each
    launch adds one to ``packed_head.launches``); CPU tensors run
    :func:`packed_head_plain`. Returns (B,H,W,out4) in hh's dtype."""
    if hh.device.type == "cpu":
        return packed_head_plain(hh, attn_s, head_up4, head_at)
    if hh.device.type != "cuda":
        raise ValueError(f"packed_head runs on cuda or cpu tensors, got {hh.device}")
    _check(hh, attn_s, head_up4, head_at)
    B, H, W, C1 = hh.shape
    C2, out4 = attn_s.shape[3], head_up4.shape[3]
    is_bf16 = int(hh.dtype == torch.bfloat16)
    out = torch.empty((B, H, W, out4), dtype=hh.dtype, device=hh.device)
    with torch.cuda.device(hh.device):
        rc = _library().packed_head_launch(
            hh.data_ptr(), attn_s.data_ptr(), head_up4.data_ptr(), head_at.data_ptr(),
            out.data_ptr(), B, H, W, C1, C2, out4, is_bf16, int(wgmma_takes(C1, C2, hh.dtype)),
            torch.cuda.current_stream(hh.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"packed_head launch failed with CUDA error {rc}")
    with _COUNT_LOCK:
        packed_head.launches += 1
    return out


packed_head.launches = 0
