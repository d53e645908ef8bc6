"""Fused s2d ResConvBlock-0 (port of ``diffusionremotesensing_tpu/ops/tap_block.py``).

One call computes the whole first ResConvBlock of the UNet in space-to-depth
layout, with the three inference BatchNorms folded into the weights:

    X1  = im2col4x4(x)                              # shared by conv1, skip, shortcut
    Y   = X1 @ [W_conv1' | W_skip | W_short']       # one product, 3*CO4 columns
    h   = relu(Y_c1 + b1') + Y_sk + b_sk + te4      # rounded to x's dtype
    out = relu(im2col4x4(h) @ W2' + b2' + Y_sh + b_sh')

Level 1's block (``tap44='l1'``) has no skip conv: W1 is
``[W_conv1' | W_short']`` (2*CO4 columns), the Y_sk term is absent and b_sk
is zero, as in the reference's ``build_block_weights(..., w_skip=None)``.

:func:`tap_stem_block` (``tap44='stem'``) extends it down through the
stem: x_s2d is the raw s2d model input and the block's input is computed in
the same call,

    h_s = round(im2col4x4(x) @ W0 + round(b0 + cond))

so h_s never reaches device memory. It takes the flat s2d condition
features (B, H2, W2, 4*16) that every other level takes; the reference's
row-slab layout of ``build_cond_slabs`` is a VMEM device and is not carried
over, only its one rounding of bias + cond in the compute dtype.

:func:`tap_block` and :func:`tap_stem_block` launch the hand-written CUDA
kernels ``csrc/tap_block.cu`` and ``csrc/tap_stem_block.cu`` for CUDA
tensors and run :func:`tap_block_plain` / :func:`tap_stem_block_plain`, the
same arithmetic in ``torch`` ops, for CPU tensors. There is no fallback from
a kernel to its plain version: a CUDA tensor the kernel cannot take raises.
In bfloat16 a call is several launches of the kernels in
``csrc/tap_block_sm90.cuh`` (the block's two phases; the stem's conv0
before them), with h (and the stem's h_s) as seams in scratch tensors the
wrapper allocates; it counts as one launch.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from diffusionremotesensing_tpu_torch.ops import cuda_build
from diffusionremotesensing_tpu_torch.ops.s2d import k3_to_s2d44
from diffusionremotesensing_tpu_torch.ops.tap_conv import _ORDER, _w2d, im2col_s2d44, tap_weight

# im2col pieces equal to the unshifted tile; the shortcut's rows of W1 sit on
# exactly these pieces (piece k carries tap block k % 4)
_CENTER_K = [k for k, (r, s) in enumerate(_ORDER) if r in (1, 2) and s in (1, 2)]

_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use
# the (4Ci, 4Co, skip) of the two levels csrc/tap_block_sm90.cuh is compiled for
_TC_LEVELS = ((64, 128, True), (128, 256, False))
_COUNT_LOCK = threading.Lock()  # launches may come from several server threads


def build_block_weights(w_conv1, b_conv1, bn0, w_skip, b_skip, w_conv2, b_conv2, bn1,
                        w_short, b_short, bn2, eps: float = 1e-5):
    """Fold the inference BatchNorms and assemble the kernel's weights.

    Kernels are HWIO: w_conv1/w_skip (3,3,Ci,Co), w_conv2 (3,3,Co,Co),
    w_short (1,1,Ci,Co); each bn is {'scale','bias','mean','var'}. Returns
    {w1 (16Ci, 3*4Co), w2 (16Co, 4Co), b1, bsk, bsh, b2 (each (4Co,))} in the
    inputs' dtype; the caller casts to the compute dtype. With
    ``w_skip=None`` (the blocks of levels 1+, whose skip conv is never
    applied) w1 is (16Ci, 2*4Co), [conv1' | shortcut'], and bsk is zero."""

    def fold(w, b, bn):
        s = bn["scale"] / torch.sqrt(bn["var"] + eps)
        return w * s, (b - bn["mean"]) * s + bn["bias"]

    ci, co = w_conv1.shape[2], w_conv1.shape[3]
    w1f, b1f = fold(w_conv1, b_conv1, bn0)
    w2f, b2f = fold(w_conv2, b_conv2, bn1)
    wshf, bshf = fold(w_short[0, 0], b_short, bn2)  # (Ci, Co)

    w1_short = w_conv1.new_zeros((16 * ci, 4 * co))
    for k in _CENTER_K:
        t = k % 4
        w1_short[k * ci:(k + 1) * ci, t * co:(t + 1) * co] = wshf
    skip = [] if w_skip is None else [_w2d(k3_to_s2d44(w_skip))]
    return {
        "w1": torch.cat([_w2d(k3_to_s2d44(w1f)), *skip, w1_short], dim=1),
        "w2": _w2d(k3_to_s2d44(w2f)),
        "b1": b1f.repeat(4),
        "bsk": (torch.zeros_like(b_conv1) if b_skip is None else b_skip).repeat(4),
        "bsh": bshf.repeat(4),
        "b2": b2f.repeat(4),
    }


def tap_block_plain(x_s2d: torch.Tensor, te4: torch.Tensor, bw: dict) -> torch.Tensor:
    """The block in ``torch`` ops: x_s2d (B,H2,W2,4Ci), te4 (B,4Co) the
    tap-tiled relu'd time bias, bw from :func:`build_block_weights`.
    Products accumulate in float32; h is rounded to x's dtype before conv2."""
    dt = x_s2d.dtype
    co4 = bw["w2"].shape[1]
    f = lambda name: bw[name].float()  # noqa: E731
    y = im2col_s2d44(x_s2d).float() @ f("w1")
    h = torch.relu(y[..., :co4] + f("b1"))
    if _has_skip(bw):
        h = h + y[..., co4:2 * co4]
    h = (h + f("bsk") + te4.float()[:, None, None, :]).to(dt)
    c2 = im2col_s2d44(h).float() @ f("w2") + f("b2")
    return torch.relu(c2 + y[..., -co4:] + f("bsh")).to(dt)


def _has_skip(bw: dict) -> bool:
    """Whether w1 carries the skip conv's columns (level 0) or not (1+)."""
    return bw["w1"].shape[1] == 3 * bw["w2"].shape[1]


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load("tap_block")
    lib.tap_block_launch.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.tap_block_launch.restype = ctypes.c_int
    lib.tap_block_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.tap_block_smem.restype = ctypes.c_size_t
    return lib


def _check(x_s2d, te4, bw):
    """Raise unless the kernel takes these tensors as they are."""
    if x_s2d.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"tap_block takes float32 or bfloat16, got {x_s2d.dtype}")
    if x_s2d.dim() != 4:
        raise ValueError(f"x_s2d must be (B, H2, W2, 4Ci), got {tuple(x_s2d.shape)}")
    B, H2, W2, C4 = x_s2d.shape
    CO4 = bw["w2"].shape[1]
    c4_unit = 32 if x_s2d.dtype == torch.bfloat16 else 8  # 16-byte copies of bf16 pieces
    if C4 % c4_unit or CO4 % 128 or CO4 > 256:
        raise ValueError(f"tap_block needs 4Ci % {c4_unit} == 0 and 4Co in (128, 256), "
                         f"got {C4}, {CO4}")
    n1 = (3 if _has_skip(bw) else 2) * CO4
    want = {"x_s2d": (B, H2, W2, C4), "te4": (B, CO4), "w1": (4 * C4, n1),
            "w2": (4 * CO4, CO4), "b1": (CO4,), "bsk": (CO4,), "bsh": (CO4,), "b2": (CO4,)}
    got = dict(bw, te4=te4, x_s2d=x_s2d)
    cuda_build.check_operands("tap_block", x_s2d, {k: (got[k], s) for k, s in want.items()})
    if x_s2d.dtype == torch.bfloat16 and (C4, CO4, _has_skip(bw)) not in _TC_LEVELS:
        raise ValueError(f"tap_block in bfloat16 takes (4Ci, 4Co, skip) in {_TC_LEVELS}, "
                         f"got {(C4, CO4, _has_skip(bw))}")


def tap_block(x_s2d: torch.Tensor, te4: torch.Tensor, bw: dict) -> torch.Tensor:
    """Fused s2d ResConvBlock (level 0, or level 1 without the skip conv).
    CUDA tensors launch ``csrc/tap_block.cu`` (each call adds one to
    ``tap_block.launches``); CPU tensors run :func:`tap_block_plain`.
    Returns res_s (B,H2,W2,4Co) in x's dtype."""
    if x_s2d.device.type == "cpu":
        return tap_block_plain(x_s2d, te4, bw)
    if x_s2d.device.type != "cuda":
        raise ValueError(f"tap_block runs on cuda or cpu tensors, got {x_s2d.device}")
    _check(x_s2d, te4, bw)
    B, H2, W2, C4 = x_s2d.shape
    CO4 = bw["w2"].shape[1]
    is_bf16 = int(x_s2d.dtype == torch.bfloat16)
    lib = _library()
    smem = lib.tap_block_smem(CO4, is_bf16)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"tap_block: 4Co={CO4} needs {smem} bytes of shared memory")
    out = torch.empty((B, H2, W2, CO4), dtype=x_s2d.dtype, device=x_s2d.device)
    # bfloat16's second launch reads h from device memory; float32 keeps it on chip
    h = torch.empty_like(out) if is_bf16 else None
    with torch.cuda.device(x_s2d.device):
        stream = torch.cuda.current_stream(x_s2d.device).cuda_stream
        rc = lib.tap_block_launch(
            x_s2d.data_ptr(), te4.data_ptr(), bw["w1"].data_ptr(), bw["w2"].data_ptr(),
            bw["b1"].data_ptr(), bw["bsk"].data_ptr(), bw["bsh"].data_ptr(), bw["b2"].data_ptr(),
            out.data_ptr(), h.data_ptr() if is_bf16 else None, B, H2, W2, C4, CO4,
            int(_has_skip(bw)), is_bf16, stream,
        )
    if rc != 0:
        raise RuntimeError(f"tap_block launch failed with CUDA error {rc}")
    with _COUNT_LOCK:
        tap_block.launches += 1
    return out


tap_block.launches = 0


def build_stem_weights(w_conv0: torch.Tensor, bw: dict) -> dict:
    """The weights :func:`tap_stem_block` takes: conv0's HWIO kernel
    (3,3,Cx,C1) as the (16Cx, 4C1) tap matrix ``w0`` beside the block's
    weights from :func:`build_block_weights`."""
    return {"w0": tap_weight(w_conv0), **bw}


def tap_stem_block_plain(x_s2d: torch.Tensor, cond_s2d: torch.Tensor, te4: torch.Tensor,
                         b0: torch.Tensor, sw: dict) -> torch.Tensor:
    """Stem + block in ``torch`` ops: x_s2d (B,H2,W2,4Cx) the s2d model
    input, cond_s2d (B,H2,W2,4C1) the s2d condition features, te4 (B,4Co),
    b0 (4C1,) conv0's tap-tiled bias, sw from :func:`build_stem_weights`, all
    in x's dtype. bias + cond is summed in x's dtype, added to conv0's
    float32 product, and h_s rounded once."""
    dt = x_s2d.dtype
    base = (b0.to(dt) + cond_s2d.to(dt)).float()
    h_s = (im2col_s2d44(x_s2d).float() @ sw["w0"].float() + base).to(dt)
    return tap_block_plain(h_s, te4, sw)


# the widths csrc/tap_stem_block.cu is compiled for: the x2 model's level 0
_STEM_CX4, _STEM_C14, _STEM_CO4 = 12, 64, 128
_STEM_ORDER = ("x_s2d", "cond_s2d", "te4", "w0", "b0", "w1", "w2", "b1", "bsk", "bsh", "b2")


@functools.lru_cache(maxsize=None)
def _stem_library():
    lib = cuda_build.load("tap_stem_block")
    lib.tap_stem_block_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.tap_stem_block_launch.restype = ctypes.c_int
    lib.tap_stem_block_smem.argtypes = [ctypes.c_int]
    lib.tap_stem_block_smem.restype = ctypes.c_size_t
    return lib


def _check_stem(x_s2d, cond_s2d, te4, b0, sw):
    """Raise unless the stem kernel takes these tensors as they are."""
    if x_s2d.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"tap_stem_block takes float32 or bfloat16, got {x_s2d.dtype}")
    if x_s2d.dim() != 4 or x_s2d.shape[3] != _STEM_CX4:
        raise ValueError(f"tap_stem_block: x_s2d must be (B, H2, W2, {_STEM_CX4}), "
                         f"got {tuple(x_s2d.shape)}")
    B, H2, W2, _ = x_s2d.shape
    c14, co4 = _STEM_C14, _STEM_CO4
    want = {"x_s2d": (B, H2, W2, _STEM_CX4), "cond_s2d": (B, H2, W2, c14), "te4": (B, co4),
            "w0": (4 * _STEM_CX4, c14), "b0": (c14,), "w1": (4 * c14, 3 * co4),
            "w2": (4 * co4, co4), "b1": (co4,), "bsk": (co4,), "bsh": (co4,), "b2": (co4,)}
    got = dict(sw, x_s2d=x_s2d, cond_s2d=cond_s2d, te4=te4, b0=b0)
    cuda_build.check_operands("tap_stem_block", x_s2d, {k: (got[k], s) for k, s in want.items()})


def tap_stem_block(x_s2d: torch.Tensor, cond_s2d: torch.Tensor, te4: torch.Tensor,
                   b0: torch.Tensor, sw: dict) -> torch.Tensor:
    """Fused stem + s2d ResConvBlock-0. CUDA tensors launch
    ``csrc/tap_stem_block.cu`` (each call adds one to
    ``tap_stem_block.launches``); CPU tensors run
    :func:`tap_stem_block_plain`. Returns res0_s (B,H2,W2,4Co) in x's dtype."""
    if x_s2d.device.type == "cpu":
        return tap_stem_block_plain(x_s2d, cond_s2d, te4, b0, sw)
    if x_s2d.device.type != "cuda":
        raise ValueError(f"tap_stem_block runs on cuda or cpu tensors, got {x_s2d.device}")
    _check_stem(x_s2d, cond_s2d, te4, b0, sw)
    B, H2, W2, _ = x_s2d.shape
    is_bf16 = int(x_s2d.dtype == torch.bfloat16)
    lib = _stem_library()
    smem = lib.tap_stem_block_smem(is_bf16)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"tap_stem_block needs {smem} bytes of shared memory")
    out = torch.empty((B, H2, W2, _STEM_CO4), dtype=x_s2d.dtype, device=x_s2d.device)
    ops = dict(sw, x_s2d=x_s2d, cond_s2d=cond_s2d, te4=te4, b0=b0)
    ptrs = (ctypes.c_void_p * len(_STEM_ORDER))(*(ops[k].data_ptr() for k in _STEM_ORDER))
    # bfloat16's seams, h_s and h, pass through device memory between its launches
    hs = out.new_empty((B, H2, W2, _STEM_C14)) if is_bf16 else None
    h = torch.empty_like(out) if is_bf16 else None
    with torch.cuda.device(x_s2d.device):
        rc = lib.tap_stem_block_launch(ptrs, out.data_ptr(), hs.data_ptr() if is_bf16 else None,
                                       h.data_ptr() if is_bf16 else None, B, H2, W2, is_bf16,
                                       torch.cuda.current_stream(x_s2d.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tap_stem_block launch failed with CUDA error {rc}")
    with _COUNT_LOCK:
        tap_stem_block.launches += 1
    return out


tap_stem_block.launches = 0
