"""Fused stage-2 attention gate and head_at conv (port of
``diffusionremotesensing_tpu/ops/att_block.py``).

One call computes, on the s2d level-0 grid, the gating signal of up stage 2,
the whole additive attention gate on the level-0 skip, and the composed
head's attention-branch conv, with both inference BatchNorms folded into the
weights:

    g      = relu(h @ gw + gb)
    a      = relu(g @ wg + bg + x @ wx + bx)
    psi    = sigmoid(a @ wpsi + bpsi)
    attn_s = (x * psi) @ rc + brc
    out    = conv3x3_SAME(attn_s, head_at)

and returns the head's contribution unpacked, (B, H, W, out4). The
reference kernel packs 8 output rows into its lanes and guards its VMEM use
and ``H % 8``; neither applies here: the CUDA kernel tiles over space and
takes every spatial shape, so with ``fused_att=True`` the model always runs
it.

:func:`att_head_block` launches ``csrc/att_head_block.cu`` for CUDA tensors
and runs :func:`att_head_block_plain`, the same arithmetic in ``torch`` ops
with the same rounding points, for CPU tensors. A CUDA tensor the kernel
cannot take raises. In bfloat16 the call is two launches with attn_s
(B, H, W, 4C) as their seam, a scratch tensor this wrapper allocates; the
kernel multiplies ``rc`` as its four diagonal C x C blocks, which is all
that :func:`build_att_weights` (through ``ops.s2d.k1_to_blockdiag``) puts
in it.
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


def build_att_weights(wgate, bgate, bn_gate, wg, bg, wx1, bx, wpsi, bpsi, rc4, brc, bn_att,
                      wat, eps: float = 1e-5) -> dict:
    """Fold the two inference BatchNorms and assemble the weights (float32;
    the caller casts to the compute dtype).

    wgate (1,1,Ch,C) the gating conv with bgate (C,) and its BN dict;
    wg (1,1,C,C), bg; wx1 (1,1,4C,C) from ``ops.s2d.k2s2_to_1x1``, bx;
    wpsi (1,1,C,1), bpsi (1,); rc4 (1,1,4C,4C) the block-diagonal result
    conv, brc (C,) and its BN dict per original channel; wat (3,3,4C,out4)
    the composed head's attention branch. Returns the matrices of the chain,
    ``at`` (3,3,4C,out4) and ``atk``, the kernel's (9*4C, 16) copy of it
    with zero columns past out4."""
    sg = bn_gate["scale"] / torch.sqrt(bn_gate["var"] + eps)
    sa = (bn_att["scale"] / torch.sqrt(bn_att["var"] + eps)).repeat(4)
    c = bg.shape[0]
    c4, out4 = wat.shape[2], wat.shape[3]
    atk = wat.new_zeros((9 * c4, _NPAD))
    atk[:, :out4] = wat.reshape(9 * c4, out4)
    return {
        "gw": wgate.reshape(-1, c) * sg,
        "gb": (bgate - bn_gate["mean"]) * sg + bn_gate["bias"],
        "wg": wg.reshape(c, c),
        "bg": bg,
        "wx": wx1.reshape(-1, c),
        "bx": bx,
        "wpsi": wpsi.reshape(c, 1),
        "bpsi": bpsi.reshape(1),
        "rc": rc4.reshape(4 * c, 4 * c) * sa,
        "brc": (brc.repeat(4) - bn_att["mean"].repeat(4)) * sa + bn_att["bias"].repeat(4),
        "at": wat,
        "atk": atk,
    }


def att_head_block_plain(x_s2d: torch.Tensor, h: torch.Tensor, w: dict) -> torch.Tensor:
    """The block in ``torch`` ops: x_s2d (B,H,W,4C), h (B,H,W,Ch), w from
    :func:`build_att_weights` in x's dtype. Products in float32; g, a, psi,
    the gated x, attn_s and the output rounded to x's dtype, as the kernel
    and the reference round them."""
    dt = x_s2d.dtype
    f = {k: v.float() for k, v in w.items()}
    x = x_s2d.float()
    g = torch.relu(h.float() @ f["gw"] + f["gb"]).to(dt)
    a = torch.relu(g.float() @ f["wg"] + f["bg"] + x @ f["wx"] + f["bx"]).to(dt)
    psi = torch.sigmoid(a.float() @ f["wpsi"] + f["bpsi"]).to(dt)
    gated = (x * psi.float()).to(dt)
    attn_s = (gated.float() @ f["rc"] + f["brc"]).to(dt)
    return conv_nhwc(attn_s.float(), hwio_to_oihw(f["at"]), padding=1).to(dt)


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load("att_head_block")
    lib.att_head_block_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.att_head_block_launch.restype = ctypes.c_int
    return lib


# the kernel's operands after x and h, in its argument order
_WEIGHTS = ("gw", "gb", "wg", "bg", "wx", "bx", "wpsi", "bpsi", "rc", "brc", "atk")
# the widths csrc/att_head_block.cu is compiled for: level 0 of the models,
# whose head writes 12 channels (3 output channels) or 4 (SAR->NDVI's 1)
_C4, _C, _CH, _OUT4S = 128, 32, 64, (12, 4)


def _check(x_s2d, h, w):
    if x_s2d.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"att_head_block takes float32 or bfloat16, got {x_s2d.dtype}")
    if x_s2d.dim() != 4 or x_s2d.shape[3] != _C4:
        raise ValueError(f"att_head_block: x_s2d must be (B, H, W, {_C4}), got {tuple(x_s2d.shape)}")
    if w["at"].shape[2] != _C4 or w["at"].shape[3] not in _OUT4S:
        raise ValueError(f"att_head_block: head_at must be (3, 3, {_C4}, out4), out4 in "
                         f"{_OUT4S}, got {tuple(w['at'].shape)}")
    B, H, W, _ = x_s2d.shape
    shapes = {"x_s2d": (B, H, W, _C4), "h": (B, H, W, _CH), "gw": (_CH, _C), "gb": (_C,),
              "wg": (_C, _C), "bg": (_C,), "wx": (_C4, _C), "bx": (_C,), "wpsi": (_C, 1),
              "bpsi": (1,), "rc": (_C4, _C4), "brc": (_C4,), "atk": (9 * _C4, _NPAD)}
    tensors = dict(w, x_s2d=x_s2d, h=h)
    cuda_build.check_operands("att_head_block", x_s2d,
                              {k: (tensors[k], s) for k, s in shapes.items()})
    if x_s2d.dtype == torch.bfloat16:  # TMA reads these from 16-byte aligned addresses
        cuda_build.check_aligned("att_head_block",
                                 {k: tensors[k] for k in ("x_s2d", "h", "gw", "wg", "wx", "rc", "atk")})


def att_head_block(x_s2d: torch.Tensor, h: torch.Tensor, w: dict) -> torch.Tensor:
    """Fused gating2 + attention gate 2 + head_at. CUDA tensors launch
    ``csrc/att_head_block.cu`` (each launch adds one to
    ``att_head_block.launches``); CPU tensors run
    :func:`att_head_block_plain`. Returns the head_at contribution
    (B, H, W, out4) in x's dtype."""
    if x_s2d.device.type == "cpu":
        return att_head_block_plain(x_s2d, h, w)
    if x_s2d.device.type != "cuda":
        raise ValueError(f"att_head_block runs on cuda or cpu tensors, got {x_s2d.device}")
    _check(x_s2d, h, w)
    B, H, W, _ = x_s2d.shape
    out4 = w["at"].shape[3]
    is_bf16 = x_s2d.dtype == torch.bfloat16
    out = torch.empty((B, H, W, out4), dtype=x_s2d.dtype, device=x_s2d.device)
    # attn_s between bfloat16's two launches
    attn = torch.empty((B, H, W, _C4), dtype=x_s2d.dtype, device=x_s2d.device) if is_bf16 else None
    ptrs = (ctypes.c_void_p * 13)(x_s2d.data_ptr(), h.data_ptr(), *(w[k].data_ptr() for k in _WEIGHTS))
    with torch.cuda.device(x_s2d.device):
        rc = _library().att_head_block_launch(
            ptrs, out.data_ptr(), attn.data_ptr() if is_bf16 else None, B, H, W, out4, int(is_bf16),
            torch.cuda.current_stream(x_s2d.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"att_head_block launch failed with CUDA error {rc}")
    with _COUNT_LOCK:
        att_head_block.launches += 1
    return out


att_head_block.launches = 0
