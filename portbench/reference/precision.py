"""The roundings the reference computes under.

``float32`` leaves every value as it is (IEEE float32: the reference turns
TF32 off). ``fp8`` is the control, the reference computed in float8 e4m3:
each operand and each output of a convolution or linear layer is scaled by
its absolute maximum onto e4m3's range (448), rounded to e4m3 and scaled
back (per-tensor scales; products accumulated in float32), so every
activation between layers is held in fp8. In training the gradient
reaching each such layer's output is rounded to float8 e5m2 (range
57344), the fp8 training recipe's format for gradients (Micikevicius et
al., arXiv:2209.05433), and the forward's roundings pass the gradient
straight through.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

FP8_MAX = 448.0      # float8 e4m3: weights and activations
GRAD_MAX = 57344.0   # float8 e5m2: gradients


class Precision(NamedTuple):
    operand: Callable  # applied to a layer's input and weight
    output: Callable   # applied to a layer's output (its gradient, in training)


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def _fp8_round(x: torch.Tensor, dtype=torch.float8_e4m3fn, top: float = FP8_MAX) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _RoundForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8_round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8_round(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8_round(g, torch.float8_e5m2, GRAD_MAX)


def _fp8_operand(x):
    return _RoundForward.apply(x) if x.requires_grad else _fp8_round(x)


def _fp8_output(y):
    return _RoundBoth.apply(y) if y.requires_grad else _fp8_round(y)


PRECISIONS = {"float32": Precision(_same, _same), "fp8": Precision(_fp8_operand, _fp8_output)}
float32 = PRECISIONS["float32"]


def ieee_float32() -> None:
    """Turn TF32 off for matmuls and cuDNN convolutions: float32 is float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
