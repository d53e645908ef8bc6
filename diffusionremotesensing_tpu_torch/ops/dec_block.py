"""Fused decoder tail (port of ``diffusionremotesensing_tpu/ops/dec_block.py``).

One call computes, on level 1 (the s2d level-0 grid), the stage-1 concat
conv, the UpConvBlock-2 body with its inference BatchNorm folded into the
conv, and the composed head's ``head_up4`` conv:

    h   = conv3x3(concat(xa, xb)) + ba
    hh  = relu(conv3x3(h + te) + bb)
    out = conv4x4(hh, head_up4, pad ((1, 2), (1, 2)))

and returns (h, hh row 0, hh column 0, out), out unpacked as
(B, H, W, out4). h goes on to the gating branch; the two strips feed the
head's boundary fixes, which stay outside as in the reference. The
reference kernel packs 8 head rows into its lanes and guards its VMEM use
and ``H % 8``; neither applies here: the CUDA kernels tile over space and
take every spatial shape, so with ``dec_block=True`` the model always runs
them.

:func:`dec_block` launches ``csrc/dec_block.cu`` for CUDA tensors (counted
as one call: in bfloat16 three wgmma kernels with h and a scratch hh as the
seams, in float32 two FMA kernels with h as the seam) and runs
:func:`dec_block_plain`, the same arithmetic in ``torch`` ops with the same
rounding points, for CPU tensors. A CUDA tensor the kernels cannot take
raises.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from diffusionremotesensing_tpu_torch.ops import cuda_build
from diffusionremotesensing_tpu_torch.ops.s2d import conv_nhwc, hwio_to_oihw

_NPAD = 16            # head columns the kernel computes (out4 zero-padded)
_COUNT_LOCK = threading.Lock()


def build_dec_weights(w_uc1, b_uc1, w_up2, b_up2, bn_up2, k4, eps: float = 1e-5) -> dict:
    """Fold the UpConvBlock-2 BatchNorm and assemble the weights (float32;
    the caller casts to the compute dtype).

    w_uc1 (3,3,Ca+Cb,Cm), b_uc1: the stage-1 concat conv, input channels in
    the concat order [up branch, attention 1]; w_up2 (3,3,Cm,Cm), b_up2 and
    bn_up2: the UpConvBlock-2 conv and its BN dict; k4 (4,4,Cm,out4): the
    composed head_up4 kernel. Returns wa, ba, wb, bb (BN folded), k4 and
    ``k4k``, the kernel's (16*Cm, 16) copy of k4 with zero columns past out4."""
    s = bn_up2["scale"] / torch.sqrt(bn_up2["var"] + eps)
    cm, out4 = k4.shape[2], k4.shape[3]
    k4k = k4.new_zeros((16 * cm, _NPAD))
    k4k[:, :out4] = k4.reshape(16 * cm, out4)
    return {
        "wa": w_uc1,
        "ba": b_uc1,
        "wb": w_up2 * s,
        "bb": (b_up2 - bn_up2["mean"]) * s + bn_up2["bias"],
        "k4": k4,
        "k4k": k4k,
    }


def dec_block_plain(xa: torch.Tensor, xb: torch.Tensor, te: torch.Tensor, w: dict):
    """The tail in ``torch`` ops: xa (B,H,W,Ca), xb (B,H,W,Cb), te (B,Cm) the
    relu'd UpConvBlock-2 time bias, w from :func:`build_dec_weights` in xa's
    dtype. Convolutions in float32; h, h + te, hh and out rounded to xa's
    dtype, as the kernels and the reference round them."""
    dt = xa.dtype
    f = {k: v.float() for k, v in w.items()}
    xc = torch.cat([xa, xb], dim=-1).float()
    h = (conv_nhwc(xc, hwio_to_oihw(f["wa"]), padding=1) + f["ba"]).to(dt)
    hp = (h.float() + te.float()[:, None, None, :]).to(dt)
    hh = torch.relu(conv_nhwc(hp.float(), hwio_to_oihw(f["wb"]), padding=1) + f["bb"]).to(dt)
    out = conv_nhwc(hh.float(), hwio_to_oihw(f["k4"]), padding=((1, 2), (1, 2))).to(dt)
    return h, hh[:, :1].contiguous(), hh[:, :, :1].contiguous(), out


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load("dec_block")
    lib.dec_block_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.dec_block_launch.restype = ctypes.c_int
    return lib


# the widths csrc/dec_block.cu is compiled for: the x2 model's level 1
_CA, _CB, _CM, _OUT4 = 128, 64, 64, 12


def _check(xa, xb, te, w):
    if xa.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dec_block takes float32 or bfloat16, got {xa.dtype}")
    if xa.dim() != 4 or xa.shape[3] != _CA:
        raise ValueError(f"dec_block: xa must be (B, H, W, {_CA}), got {tuple(xa.shape)}")
    if tuple(w["k4"].shape) != (4, 4, _CM, _OUT4):
        raise ValueError(f"dec_block: head_up4 must be (4, 4, {_CM}, {_OUT4}), "
                         f"got {tuple(w['k4'].shape)}")
    B, H, W, _ = xa.shape
    shapes = {"xa": (B, H, W, _CA), "xb": (B, H, W, _CB), "te": (B, _CM),
              "wa": (3, 3, _CA + _CB, _CM), "ba": (_CM,), "wb": (3, 3, _CM, _CM), "bb": (_CM,),
              "k4k": (16 * _CM, _NPAD)}
    tensors = dict(w, xa=xa, xb=xb, te=te)
    cuda_build.check_operands("dec_block", xa, {k: (tensors[k], s) for k, s in shapes.items()})


def dec_block(xa: torch.Tensor, xb: torch.Tensor, te: torch.Tensor, w: dict):
    """Fused decoder tail. CUDA tensors launch ``csrc/dec_block.cu`` (each
    call adds one to ``dec_block.launches``); CPU tensors run
    :func:`dec_block_plain`. Returns (h (B,H,W,Cm), hh row 0 (B,1,W,Cm),
    hh column 0 (B,H,1,Cm), head_up4 contribution (B,H,W,out4)) in xa's
    dtype."""
    if xa.device.type == "cpu":
        return dec_block_plain(xa, xb, te, w)
    if xa.device.type != "cuda":
        raise ValueError(f"dec_block runs on cuda or cpu tensors, got {xa.device}")
    _check(xa, xb, te, w)
    B, H, W, _ = xa.shape
    is_bf16 = int(xa.dtype == torch.bfloat16)
    new = functools.partial(torch.empty, dtype=xa.dtype, device=xa.device)
    outs = (new((B, H, W, _CM)), new((B, 1, W, _CM)), new((B, H, 1, _CM)), new((B, H, W, _OUT4)))
    # bfloat16's head kernel reads hh from device memory; float32 keeps it on chip
    hh = new((B, H, W, _CM)) if is_bf16 else outs[0]
    ins = (ctypes.c_void_p * 8)(*(t.data_ptr() for t in (
        xa, xb, w["wa"], w["ba"], te, w["wb"], w["bb"], w["k4k"])))
    out_ptrs = (ctypes.c_void_p * 5)(*(t.data_ptr() for t in (*outs, hh)))
    with torch.cuda.device(xa.device):
        rc = _library().dec_block_launch(ins, out_ptrs, B, H, W, is_bf16,
                                         torch.cuda.current_stream(xa.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dec_block launch failed with CUDA error {rc}")
    with _COUNT_LOCK:
        dec_block.launches += 1
    return outs


dec_block.launches = 0
