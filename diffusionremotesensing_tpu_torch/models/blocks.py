"""UNet building blocks (port of ``diffusionremotesensing_tpu/models/blocks.py``).

BatchNorm follows the explicit ``train`` argument of each block's forward,
as the reference's ``__call__(..., train=...)`` does, never the module's
``training`` flag: ``train=False`` (the default, every served path)
normalises with the running statistics; ``train=True`` with the batch's,
computed in float32 as flax does, and moves the running statistics the flax
way (:func:`bn_train`). Blocks take and return NCHW tensors (channels-last
in memory when the model's NHWC input is permuted into them). Attribute
names follow the reference torch model, so ``state_dict()`` has the keys
that ``diffusionremotesensing_tpu.io.export_torch_state_dict`` emits,
including the BatchNorms registered twice (as an attribute and inside a
Sequential) and the unused per-block skip conv, which is part of the
parameter count.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusionremotesensing_tpu_torch.ops.attention_gate import build_gate_weights, fused_attention_gate
from diffusionremotesensing_tpu_torch.ops.quant import conv_int8


class QConv2d(nn.Conv2d):
    """Conv2d with the W8A8 hook (``ops.quant``): its model names it
    (``site``, the module path) and shares its ``QuantSites``; without a
    quant map or a calibration pass it is ``nn.Conv2d``, bit for bit."""

    quant_sites = None
    site = ""

    def forward(self, x):
        amax = None if self.quant_sites is None else self.quant_sites.amax(self.site, x, rows=2)
        if amax is None:
            return super().forward(x)
        y = conv_int8(x.permute(0, 2, 3, 1), self.weight, amax, stride=self.stride,
                      padding=self.padding).to(x.dtype)
        return (y + self.bias.to(x.dtype)).permute(0, 3, 1, 2)


def TorchConv(in_ch: int, out_ch: int, kernel: int, stride: int = 1, pad=None) -> QConv2d:
    """Conv2d with the reference's padding rule, (kernel - 1) // 2 unless given."""
    return QConv2d(in_ch, out_ch, kernel, stride=stride,
                   padding=(kernel - 1) // 2 if pad is None else pad)


def BatchNorm(features: int) -> nn.BatchNorm2d:
    """BatchNorm2d with torch's defaults (eps 1e-5, momentum 0.1)."""
    return nn.BatchNorm2d(features)


BN_MOMENTUM = 0.9  # flax's momentum: running = 0.9 * running + 0.1 * batch


def _bn_f32(x: torch.Tensor, mean, var, bn: nn.BatchNorm2d) -> torch.Tensor:
    """flax's normalisation, NCHW: (x - mean) * (rsqrt(var + eps) * scale)
    + bias in float32, cast back to x's dtype."""
    mul = torch.rsqrt(var + bn.eps) * bn.weight.float()
    y = (x.float() - mean[:, None, None]) * mul[:, None, None] + bn.bias.float()[:, None, None]
    return y.to(x.dtype)


def bn_eval(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """BatchNorm with running statistics (inference), NCHW; in float32 when
    the BatchNorm's parameters are float32 and x is not (a compute dtype)."""
    if bn.weight.dtype != x.dtype:
        return _bn_f32(x, bn.running_mean.float(), bn.running_var.float(), bn)
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                        False, 0.0, bn.eps)


@torch.no_grad()
def update_running_stats(bn: nn.BatchNorm2d, mean: torch.Tensor, var: torch.Tensor) -> None:
    """running = 0.9 * running + 0.1 * batch, the biased variance (flax's
    update; ``F.batch_norm(training=True)`` would store the unbiased one)."""
    bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean + (1.0 - BN_MOMENTUM) * mean)
    bn.running_var.copy_(BN_MOMENTUM * bn.running_var + (1.0 - BN_MOMENTUM) * var)


_STATS_GROUP = None  # the process group train-mode statistics are reduced over


@contextlib.contextmanager
def global_batch_statistics(group):
    """Within the block, train-mode BatchNorm (:func:`bn_train` and the s2d
    path's, through :func:`batch_moments`) takes its statistics over the
    global batch that ``group``'s ranks hold in equal shares, as the JAX
    package's sharded step does (SyncBN); ``group=None`` keeps them local."""
    global _STATS_GROUP
    prev, _STATS_GROUP = _STATS_GROUP, group
    try:
        yield
    finally:
        _STATS_GROUP = prev


def batch_moments(xf: torch.Tensor, dims):
    """E[x] and E[x^2] of the float32 ``xf`` over ``dims``. Under
    :func:`global_batch_statistics` the per-channel sums are all-reduced over
    the group first, by the autograd-aware collective, so that the backward
    carries each rank's share of the gradient through the global statistics
    to every rank, as the global batch's gradient does."""
    if _STATS_GROUP is None:
        return xf.mean(dims), xf.square().mean(dims)
    from torch.distributed.nn.functional import all_reduce

    sums = torch.stack([xf.sum(dims), xf.square().sum(dims)])
    n = xf.numel() // sums[0].numel() * torch.distributed.get_world_size(_STATS_GROUP)
    sums = all_reduce(sums, group=_STATS_GROUP)
    return sums[0] / n, sums[1] / n


def bn_train(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Train-mode BatchNorm as flax computes it, NCHW: the batch mean and
    biased variance over (N, H, W) in float32 (E[x^2] - E[x]^2, clamped at
    0; :func:`batch_moments`), normalised by :func:`_bn_f32`; the running
    statistics move by :func:`update_running_stats`."""
    mean, mean_sq = batch_moments(x.float(), (0, 2, 3))
    var = torch.clamp(mean_sq - mean.square(), min=0.0)
    update_running_stats(bn, mean, var)
    return _bn_f32(x, mean, var, bn)


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d, train: bool) -> torch.Tensor:
    return bn_train(x, bn) if train else bn_eval(x, bn)


class QConvTranspose2d(nn.ConvTranspose2d):
    """ConvTranspose2d with the W8A8 hook, as :class:`QConv2d`; its int8 path
    is the reference's: the input-dilated forward convolution (dilation 2,
    padding (1, 2)) with the flipped kernel."""

    quant_sites = None
    site = ""

    def forward(self, x, output_size=None):
        amax = None if self.quant_sites is None else self.quant_sites.amax(self.site, x, rows=2)
        if amax is None:
            return super().forward(x, output_size)
        w = self.weight.permute(1, 0, 2, 3).flip(2, 3)  # the forward conv's OIHW kernel
        y = conv_int8(x.permute(0, 2, 3, 1), w, amax, padding=((1, 2), (1, 2)),
                      lhs_dilation=2).to(x.dtype)
        return (y + self.bias.to(x.dtype)).permute(0, 3, 1, 2)


def ConvTranspose2x(features: int) -> QConvTranspose2d:
    """ConvTranspose2d(k=3, s=2, p=1, output_padding=1): H -> 2H. The weight is
    torch's (in, out, kh, kw); the reference package keeps the spatially
    flipped HWIO kernel of the equivalent forward conv instead
    (``convert.from_jax_variables`` flips it)."""
    return QConvTranspose2d(features, features, 3, stride=2, padding=1, output_padding=1)


def sinusoidal_time_embedding(t: torch.Tensor, channels: int = 100) -> torch.Tensor:
    """sin(t * inv_freq) ++ cos(t * inv_freq), inv_freq = 1/10000^(arange(0, C, 2)/C),
    in float32; t is (B,)."""
    t = t.to(torch.float32)[:, None]
    inv_freq = 1.0 / (10000.0 ** (torch.arange(0, channels, 2, dtype=torch.float32,
                                               device=t.device) / channels))
    ang = t * inv_freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def TimeMLP(time_dim: int, features: int) -> nn.Sequential:
    """Linear(time_dim, F) + SiLU + Linear(F, F) (keys time_mlp.0 / time_mlp.2)."""
    return nn.Sequential(nn.Linear(time_dim, features), nn.SiLU(), nn.Linear(features, features))


class ResConvBlock(nn.Module):
    """h = ReLU(BN(conv3x3(x))); h += conv3x3(x_skip) if given;
    h += ReLU(TimeMLP(t)); h = BN(conv3x3(h)); out = ReLU(BN(conv1x1(x)) + h).

    ``skip_name`` is the reference's attribute name of the skip conv
    ('conv_upsampled_lr_img' in the super-resolution model)."""

    def __init__(self, in_ch: int, features: int, time_dim: int = 100,
                 skip_name: str = "conv_upsampled_lr_img"):
        super().__init__()
        self.skip_name = skip_name
        self.time_mlp = TimeMLP(time_dim, features)
        self.batch_norm1 = BatchNorm(features)
        self.batch_norm2 = BatchNorm(features)
        self.shortcut_batch_norm = BatchNorm(features)
        self.conv1 = nn.Sequential(TorchConv(in_ch, features, 3), self.batch_norm1)
        setattr(self, skip_name, TorchConv(in_ch, features, 3))
        self.conv2 = nn.Sequential(TorchConv(features, features, 3), self.batch_norm2)
        self.shortcut_conv = nn.Sequential(TorchConv(in_ch, features, 1), self.shortcut_batch_norm)

    @property
    def skip_conv(self) -> nn.Conv2d:
        return getattr(self, self.skip_name)

    def time_bias(self, t_emb: torch.Tensor) -> torch.Tensor:
        """ReLU(TimeMLP(t_emb)), (B, F)."""
        return torch.relu(self.time_mlp(t_emb))

    def forward(self, x, t_emb, x_skip=None, train: bool = False):
        h = torch.relu(batch_norm(self.conv1[0](x), self.batch_norm1, train))
        if x_skip is not None:
            h = h + self.skip_conv(x_skip)
        h = h + self.time_bias(t_emb)[:, :, None, None]
        h = batch_norm(self.conv2[0](h), self.batch_norm2, train)
        s = batch_norm(self.shortcut_conv[0](x), self.shortcut_batch_norm, train)
        return torch.relu(s + h)


class AttentionGate(nn.Module):
    """Additive attention gate: psi = sigmoid(conv1x1(ReLU(conv1x1(g) +
    conv2x2_s2(x)))), upsampled x2 nearest; out = BN(conv1x1(psi * x)).

    ``use_pallas=True`` (the reference's flag name) runs the whole gate as
    one ``ops.attention_gate.fused_attention_gate`` call, the hand-written
    CUDA kernel on the card, in float32 with only its output rounded; ``w``
    is its weights from ``build_gate_weights(self)``, built per call when not
    given (samplers hoist them with the s2d kernels). Training (``train=True``)
    never runs the kernel, as in the reference."""

    def __init__(self, features: int, use_pallas: bool = False):
        super().__init__()
        self.use_pallas = bool(use_pallas)
        self.w_g = nn.Sequential(TorchConv(features, features, 1))
        self.w_x = nn.Sequential(TorchConv(features, features, 2, stride=2, pad=0))
        self.psi = nn.Sequential(TorchConv(features, 1, 1))
        self.result = nn.Sequential(TorchConv(features, features, 1), BatchNorm(features))

    def forward(self, x, g, w=None, train: bool = False):
        if self.use_pallas and not train:
            # NHWC views of the channels-last trunk tensors: no copy; on the
            # card the wrapper refuses a view that is not contiguous
            out = fused_attention_gate(x.permute(0, 2, 3, 1), g.permute(0, 2, 3, 1),
                                       build_gate_weights(self) if w is None else w)
            return out.permute(0, 3, 1, 2)
        psi = torch.relu(self.w_g(g) + self.w_x(x))
        psi = torch.sigmoid(self.psi(psi))
        psi = psi.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return batch_norm(self.result[0](psi * x), self.result[1], train)


class UpConvBlock(nn.Module):
    """x + ReLU(TimeMLP(t)); conv3x3 + BN + ReLU; ConvTranspose x2 upsample
    (the time bias is added before the conv here, unlike ResConvBlock)."""

    def __init__(self, features: int, time_dim: int = 100):
        super().__init__()
        self.time_mlp = TimeMLP(time_dim, features)
        self.conv = TorchConv(features, features, 3)
        self.batch_norm = BatchNorm(features)
        self.transform = ConvTranspose2x(features)

    def time_bias(self, t_emb: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.time_mlp(t_emb))

    def body(self, x, t_emb, train: bool = False):
        """Everything before the ConvTranspose."""
        x = x + self.time_bias(t_emb)[:, :, None, None]
        return torch.relu(batch_norm(self.conv(x), self.batch_norm, train))

    def forward(self, x, t_emb, train: bool = False):
        return self.transform(self.body(x, t_emb, train))


class GatingSignal(nn.Module):
    """conv1x1 + BN + ReLU channel reduction."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.conv = TorchConv(in_ch, features, 1)
        self.batch_norm = BatchNorm(features)

    def forward(self, x, train: bool = False):
        return torch.relu(batch_norm(self.conv(x), self.batch_norm, train))


class ResidualBlock(nn.Module):
    """conv3x3 + ReLU + conv3x3 with identity residual (condition encoder)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = TorchConv(features, features, 3)
        self.conv2 = TorchConv(features, features, 3)

    def forward(self, x):
        return self.conv2(torch.relu(self.conv1(x))) + x


class RRDB(nn.Module):
    """Condition-image encoder: chained ResidualBlocks + conv out + outer residual."""

    def __init__(self, channels: int, num_blocks: int = 3):
        super().__init__()
        self.blocks = nn.Sequential(*[ResidualBlock(channels) for _ in range(num_blocks)])
        self.conv_out = TorchConv(channels, channels, 3)

    def forward(self, x):
        return self.conv_out(self.blocks(x)) + x
