"""Fused additive attention gate (the port's counterpart of the reference's
``diffusionremotesensing_tpu/ops/pallas_kernels.py:fused_attention_gate``,
which ``use_pallas`` switches every gate to).

One call computes the whole gate of ``models.blocks.AttentionGate`` on x
(B, H, W, C) and the gating signal g (B, H/2, W/2, C), NHWC, in float32
with float32 weights, as the reference's TPU kernel does:

    a   = relu(g @ wg + bg + s2d(x) @ wx + bx)     # w_g 1x1, w_x 2x2 stride 2
    psi = sigmoid(a @ wpsi + bpsi)                 # one value per gating pixel
    r   = (x * up2(psi)) @ wr + br                 # result 1x1 conv
    out = (r - mean) * rsqrt(var + 1e-5) * scale + bias

and rounds only ``out`` to x's dtype. (The port's layer-by-layer gate
rounds every conv's output to the compute dtype; the two agree to that
rounding.)

:func:`fused_attention_gate` launches the hand-written CUDA kernel
``csrc/attention_gate.cu`` for CUDA tensors and runs
:func:`attention_gate_plain` for CPU tensors. A CUDA tensor the kernel
cannot take raises; in particular x and g must be contiguous NHWC, which
the channels-last NCHW tensors of the model's trunk are when permuted.
In bfloat16 the kernel multiplies on the tensor cores with each float32
weight split into two bfloat16 parts, ``hi + lo`` (``wt`` of
:func:`build_gate_weights`), which keeps it within ~2**-18 of the float32
weight.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from types import SimpleNamespace

import torch

from diffusionremotesensing_tpu_torch.ops import cuda_build
from diffusionremotesensing_tpu_torch.ops.s2d import depth_to_space, space_to_depth

_COUNT_LOCK = threading.Lock()
# the kernel's float32 weights, in its argument order (then ``wt``)
WEIGHTS = ("wg", "bg", "wx", "bx", "wpsi", "bpsi", "wr", "br", "scale", "bias", "mean", "var")
_WIDTHS = (32, 64, 128)  # the gate widths csrc/attention_gate.cu is compiled for


@torch.no_grad()
def build_gate_weights(gate) -> dict:
    """The float32 weights of an ``AttentionGate`` module, as the kernel
    takes them: wg, wr (C, C) and wx (4C, C) as [in][out], wx's rows
    tap-major (t*C + c, t = 2 di + dj), wpsi (C,), bpsi (1,), the result
    BatchNorm's scale, bias, mean and var unfolded (the kernel applies
    them); and ``wt`` (2, 6C, C) bfloat16, [wg; wx; wr] split once into
    ``hi = bf16(w)`` and ``lo = bf16(w - hi)``, which the bfloat16 kernel
    multiplies (``hi + lo`` is w to ~2**-18 of |w|)."""
    f = lambda p: p.detach().float().contiguous()  # noqa: E731
    c = gate.w_g[0].out_channels
    bn = gate.result[1]
    w = {
        "wg": f(gate.w_g[0].weight[:, :, 0, 0].t()),
        "bg": f(gate.w_g[0].bias),
        "wx": f(gate.w_x[0].weight.permute(2, 3, 1, 0).reshape(4 * c, c)),
        "bx": f(gate.w_x[0].bias),
        "wpsi": f(gate.psi[0].weight.reshape(c)),
        "bpsi": f(gate.psi[0].bias),
        "wr": f(gate.result[0].weight[:, :, 0, 0].t()),
        "br": f(gate.result[0].bias),
        "scale": f(bn.weight), "bias": f(bn.bias),
        "mean": f(bn.running_mean), "var": f(bn.running_var),
    }
    cat = torch.cat([w["wg"], w["wx"], w["wr"]])
    hi = cat.to(torch.bfloat16)
    w["wt"] = torch.stack([hi, (cat - hi.float()).to(torch.bfloat16)]).contiguous()
    return w


def attention_gate_plain(x: torch.Tensor, g: torch.Tensor, w: dict) -> torch.Tensor:
    """The gate in ``torch`` ops, float32 throughout, the output rounded to
    x's dtype: x (B,H,W,C), g (B,H/2,W/2,C), w from :func:`build_gate_weights`."""
    B, H, W, C = x.shape
    xs = space_to_depth(x.float())                               # (B, H/2, W/2, 4C)
    a = torch.relu((g.float() @ w["wg"] + w["bg"]) + (xs @ w["wx"] + w["bx"]))
    psi = torch.sigmoid(a @ w["wpsi"][:, None] + w["bpsi"])      # (B, H/2, W/2, 1)
    r = (xs * psi).reshape(B, H // 2, W // 2, 4, C) @ w["wr"] + w["br"]
    r = (r - w["mean"]) * torch.rsqrt(w["var"] + 1e-5) * w["scale"] + w["bias"]
    return depth_to_space(r.reshape(B, H // 2, W // 2, 4 * C)).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load("attention_gate")
    lib.attention_gate_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.attention_gate_launch.restype = ctypes.c_int
    return lib


def _check(x, g, w):
    """Raise unless the kernel takes these tensors as they are."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_attention_gate takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or x.shape[3] not in _WIDTHS or x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"fused_attention_gate: x must be (B, H, W, C) with H, W even and C in "
                         f"{_WIDTHS}, got {tuple(x.shape)}")
    B, H, W, C = x.shape
    cuda_build.check_operands("fused_attention_gate", x,
                              {"x": (x, (B, H, W, C)), "g": (g, (B, H // 2, W // 2, C))})
    shapes = {"wg": (C, C), "wx": (4 * C, C), "wr": (C, C), "bpsi": (1,)}
    ref = SimpleNamespace(dtype=torch.float32, device=x.device)  # the weights are float32
    cuda_build.check_operands("fused_attention_gate", ref,
                              {k: (w[k], shapes.get(k, (C,))) for k in WEIGHTS})
    if x.dtype == torch.bfloat16:  # the tensor-core kernel: wt, and TMA's 16-byte starts
        if "wt" not in w:
            raise ValueError("fused_attention_gate: bfloat16 needs w['wt'] from build_gate_weights")
        cuda_build.check_operands("fused_attention_gate", x, {"wt": (w["wt"], (2, 6 * C, C))})
        cuda_build.check_aligned("fused_attention_gate", {"x": x, "g": g, "wt": w["wt"]})


def fused_attention_gate(x: torch.Tensor, g: torch.Tensor, w: dict) -> torch.Tensor:
    """The whole attention gate in one call: x (B,H,W,C) and g (B,H/2,W/2,C)
    NHWC, w from :func:`build_gate_weights`. CUDA tensors launch
    ``csrc/attention_gate.cu`` (each launch adds one to
    ``fused_attention_gate.launches``); CPU tensors run
    :func:`attention_gate_plain`. Returns (B,H,W,C) in x's dtype."""
    if x.device.type == "cpu":
        return attention_gate_plain(x, g, w)
    if x.device.type != "cuda":
        raise ValueError(f"fused_attention_gate runs on cuda or cpu tensors, got {x.device}")
    _check(x, g, w)
    B, H, W, C = x.shape
    out = torch.empty_like(x)
    wt = w["wt"].data_ptr() if x.dtype == torch.bfloat16 else None
    ptrs = (ctypes.c_void_p * (len(WEIGHTS) + 1))(*(w[k].data_ptr() for k in WEIGHTS), wt)
    with torch.cuda.device(x.device):
        rc = _library().attention_gate_launch(
            x.data_ptr(), g.data_ptr(), ptrs, out.data_ptr(), B, H // 2, W // 2, C,
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_attention_gate launch failed with CUDA error {rc}")
    with _COUNT_LOCK:
        fused_attention_gate.launches += 1
    return out


fused_attention_gate.launches = 0
