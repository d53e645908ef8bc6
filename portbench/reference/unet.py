"""The Residual Attention UNet as a plain function of its parameters.

Written from the architecture the configurations name (the reference
repository's ``UNet_model_superres.py`` and the generation script's class
UNet), layer by layer in NCHW float32, with none of the program's kernels,
layouts or folded weights:

* stem: a 3x3 conv to 16 channels, plus for super-resolution the condition
  stem (RRDB: three residual blocks and a conv, with the outer residual;
  PyTorch's bicubic upsample by the magnification; a 3x3 conv);
* three ResConvBlocks 16->32->64->128, each followed by a stride-2 3x3
  conv; ResConvBlock-0 takes the stem's output as its skip input;
* a bottleneck ResConvBlock 128->256;
* three up stages: gating signal (1x1 conv, BatchNorm, ReLU); additive
  attention gate on the skip; UpConvBlock (time bias, 3x3 conv,
  BatchNorm, ReLU, ConvTranspose 3x3 stride 2); concat; 3x3 conv;
* a 1x1 output conv.

The time embedding is sinusoidal (100 channels); the class model adds its
label embedding times the classifier-free guidance mask. BatchNorm uses
the running statistics, or with ``train`` the batch's (biased variance).

:func:`param_shapes` gives every entry of the model's ``state_dict`` (its
names are the reference torch model's, BatchNorms under both of their
names), so that the benchmark makes one set of tensors from the seed and
hands the same to the program and to this function.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from portbench.reference.precision import Precision, float32

DOWN = (16, 32, 64, 128, 256)
UP = (256, 128, 64, 32, 16)
TIME_DIM = 100
BN_EPS = 1e-5


def _conv(shapes, name, cin, cout, k):
    shapes[f"{name}.weight"] = (cout, cin, k, k)
    shapes[f"{name}.bias"] = (cout,)


def _bn(shapes, names, c):
    for n in names:
        shapes[f"{n}.weight"] = (c,)
        shapes[f"{n}.bias"] = (c,)
        shapes[f"{n}.running_mean"] = (c,)
        shapes[f"{n}.running_var"] = (c,)
        shapes[f"{n}.num_batches_tracked"] = ()


def _linear(shapes, name, cin, cout):
    shapes[f"{name}.weight"] = (cout, cin)
    shapes[f"{name}.bias"] = (cout,)


def _res_block(shapes, p, cin, c, skip):
    _linear(shapes, f"{p}.time_mlp.0", TIME_DIM, c)
    _linear(shapes, f"{p}.time_mlp.2", c, c)
    _bn(shapes, [f"{p}.batch_norm1"], c)
    _bn(shapes, [f"{p}.batch_norm2"], c)
    _bn(shapes, [f"{p}.shortcut_batch_norm"], c)
    _conv(shapes, f"{p}.conv1.0", cin, c, 3)
    _bn(shapes, [f"{p}.conv1.1"], c)
    _conv(shapes, f"{p}.{skip}", cin, c, 3)
    _conv(shapes, f"{p}.conv2.0", c, c, 3)
    _bn(shapes, [f"{p}.conv2.1"], c)
    _conv(shapes, f"{p}.shortcut_conv.0", cin, c, 1)
    _bn(shapes, [f"{p}.shortcut_conv.1"], c)


# a BatchNorm registered twice: the second name of each first one
BN_ALIASES = {"batch_norm1": "conv1.1", "batch_norm2": "conv2.1",
              "shortcut_batch_norm": "shortcut_conv.1"}


def param_shapes(conditioning: str, image_channels: int = 3, num_classes: Optional[int] = None,
                 ) -> "OrderedDict[str, tuple]":
    """Every ``state_dict`` entry of the UNet and its shape, in the order
    the reference torch model registers them."""
    s: "OrderedDict[str, tuple]" = OrderedDict()
    skip = "conv_upsampled_lr_img" if conditioning == "superres" else "conv_skip"
    _conv(s, "conv0", image_channels, DOWN[0], 3)
    if conditioning == "superres":
        for i in range(3):
            _conv(s, f"LR_encoder.blocks.{i}.conv1", image_channels, image_channels, 3)
            _conv(s, f"LR_encoder.blocks.{i}.conv2", image_channels, image_channels, 3)
        _conv(s, "LR_encoder.conv_out", image_channels, image_channels, 3)
        _conv(s, "conv_upsampled_lr_img", image_channels, DOWN[0], 3)
    if conditioning == "class":
        s["label_emb.weight"] = (num_classes, TIME_DIM)
    for i in range(3):
        _res_block(s, f"conv_blocks.{i}", DOWN[i], DOWN[i + 1], skip)
    for i in range(3):
        _conv(s, f"downs.{i}", DOWN[i + 1], DOWN[i + 1], 3)
    _res_block(s, "bottle_neck", DOWN[3], DOWN[4], skip)
    for i in range(3):
        _conv(s, f"gating_signals.{i}.conv", UP[i], UP[i + 1], 1)
        _bn(s, [f"gating_signals.{i}.batch_norm"], UP[i + 1])
    for i in range(3):
        c = UP[i + 1]
        _conv(s, f"attention_blocks.{i}.w_g.0", c, c, 1)
        _conv(s, f"attention_blocks.{i}.w_x.0", c, c, 2)
        _conv(s, f"attention_blocks.{i}.psi.0", c, 1, 1)
        _conv(s, f"attention_blocks.{i}.result.0", c, c, 1)
        _bn(s, [f"attention_blocks.{i}.result.1"], c)
    for i in range(3):
        c = UP[i]
        _linear(s, f"ups.{i}.time_mlp.0", TIME_DIM, c)
        _linear(s, f"ups.{i}.time_mlp.2", c, c)
        _conv(s, f"ups.{i}.conv", c, c, 3)
        _bn(s, [f"ups.{i}.batch_norm"], c)
        _conv(s, f"ups.{i}.transform", c, c, 3)  # ConvTranspose: (in, out, kh, kw)
    for i in range(3):
        _conv(s, f"up_convs.{i}", UP[i] + UP[i + 1], UP[i + 1], 3)
    _conv(s, "output", UP[3], image_channels, 1)
    return s


def trainable(shapes) -> list:
    """The names of the learnable parameters among ``shapes``, each once
    (a BatchNorm's second name left out), in registration order."""
    second = {f".{v}." for v in BN_ALIASES.values()}
    return [n for n, shape in shapes.items()
            if not n.endswith(("running_mean", "running_var", "num_batches_tracked"))
            and not any(a in n for a in second)]


def fan_in(name: str, shape: tuple) -> int:
    """The fan-in of a weight or bias by torch's default initialisation
    (a ConvTranspose's weight is (in, out, kh, kw): its fan-in is out*kh*kw)."""
    if len(shape) == 4:
        return shape[1] * shape[2] * shape[3]
    return shape[1] if len(shape) == 2 else 0


def sinusoidal(t: torch.Tensor, channels: int = TIME_DIM) -> torch.Tensor:
    t = t.float()[:, None]
    inv = 1.0 / (10000.0 ** (torch.arange(0, channels, 2, dtype=torch.float32,
                                          device=t.device) / channels))
    return torch.cat([torch.sin(t * inv), torch.cos(t * inv)], dim=-1)


class UNet:
    """The forward of one configuration over a parameter dict ``p`` (the
    names of :func:`param_shapes`), each convolution and linear layer
    rounded as ``q`` says (a ``precision.Precision``)."""

    def __init__(self, p: Dict[str, torch.Tensor], conditioning: str, magnification: int = 2,
                 q: Precision = float32):
        self.p, self.conditioning, self.mag, self.q = p, conditioning, magnification, q
        self.skip = "conv_upsampled_lr_img" if conditioning == "superres" else "conv_skip"

    def conv(self, name, x, stride=1, padding=None):
        w, b = self.p[f"{name}.weight"], self.p[f"{name}.bias"]
        pad = (w.shape[-1] - 1) // 2 if padding is None else padding
        q = self.q
        return q.output(F.conv2d(q.operand(x), q.operand(w), b, stride=stride, padding=pad))

    def linear(self, name, x):
        q = self.q
        return q.output(F.linear(q.operand(x), q.operand(self.p[f"{name}.weight"]),
                                 self.p[f"{name}.bias"]))

    def bn(self, name, x, train):
        if train:
            mean = x.mean((0, 2, 3))
            var = x.var((0, 2, 3), unbiased=False)
        else:
            mean, var = self.p[f"{name}.running_mean"], self.p[f"{name}.running_var"]
        scale = self.p[f"{name}.weight"] / torch.sqrt(var + BN_EPS)
        return (x - mean[:, None, None]) * scale[:, None, None] + self.p[f"{name}.bias"][:, None, None]

    def time_bias(self, name, t_emb):
        return torch.relu(self.linear(f"{name}.time_mlp.2",
                                      F.silu(self.linear(f"{name}.time_mlp.0", t_emb))))

    def res_block(self, n, x, t_emb, x_skip, train):
        h = torch.relu(self.bn(f"{n}.batch_norm1", self.conv(f"{n}.conv1.0", x), train))
        if x_skip is not None:
            h = h + self.conv(f"{n}.{self.skip}", x_skip)
        h = h + self.time_bias(n, t_emb)[:, :, None, None]
        h = self.bn(f"{n}.batch_norm2", self.conv(f"{n}.conv2.0", h), train)
        s = self.bn(f"{n}.shortcut_batch_norm", self.conv(f"{n}.shortcut_conv.0", x), train)
        return torch.relu(s + h)

    def gate(self, i, x, g, train):
        n = f"attention_blocks.{i}"
        psi = torch.relu(self.conv(f"{n}.w_g.0", g) + self.conv(f"{n}.w_x.0", x, stride=2,
                                                                padding=0))
        psi = torch.sigmoid(self.conv(f"{n}.psi.0", psi))
        psi = F.interpolate(psi, scale_factor=2, mode="nearest")
        return self.bn(f"{n}.result.1", self.conv(f"{n}.result.0", psi * x), train)

    def up_block(self, i, x, t_emb, train):
        n = f"ups.{i}"
        x = x + self.time_bias(n, t_emb)[:, :, None, None]
        x = torch.relu(self.bn(f"{n}.batch_norm", self.conv(f"{n}.conv", x), train))
        w, q = self.p[f"{n}.transform.weight"], self.q
        return q.output(F.conv_transpose2d(q.operand(x), q.operand(w), self.p[f"{n}.transform.bias"],
                                           stride=2, padding=1, output_padding=1))

    def encode_cond(self, cond):
        """The super-resolution condition stem of the LR image (B, h, w, C)."""
        c = cond.float().permute(0, 3, 1, 2)
        h = c
        for i in range(3):
            n = f"LR_encoder.blocks.{i}"
            h = self.conv(f"{n}.conv2", torch.relu(self.conv(f"{n}.conv1", h))) + h
        h = self.conv("LR_encoder.conv_out", h) + c
        h = F.interpolate(h, scale_factor=self.mag, mode="bicubic", align_corners=False)
        return self.conv("conv_upsampled_lr_img", h)

    def __call__(self, x, t, cond=None, cond_mask=None, train: bool = False):
        """eps_hat (B, H, W, C) of x (B, H, W, C) at timesteps t (B,)."""
        t_emb = sinusoidal(t)
        if self.conditioning == "class":
            lab = self.p["label_emb.weight"][cond.long()]
            if cond_mask is not None:
                lab = lab * cond_mask.float()[:, None]
            t_emb = t_emb + lab
        h = self.conv("conv0", x.float().permute(0, 3, 1, 2))
        if self.conditioning == "superres":
            h = h + self.encode_cond(cond)
        h = self.res_block("conv_blocks.0", h, t_emb, h, train)
        residuals = [h]
        for i in range(3):
            h = self.conv(f"downs.{i}", h, stride=2)
            if i < 2:
                h = self.res_block(f"conv_blocks.{i + 1}", h, t_emb, None, train)
                residuals.append(h)
        h = self.res_block("bottle_neck", h, t_emb, None, train)
        for i in range(3):
            n = f"gating_signals.{i}"
            g = torch.relu(self.bn(f"{n}.batch_norm", self.conv(f"{n}.conv", h), train))
            attn = self.gate(i, residuals[-(i + 1)], g, train)
            up = self.up_block(i, h, t_emb, train)
            h = self.conv(f"up_convs.{i}", torch.cat([up, attn], dim=1))
        return self.conv("output", h).permute(0, 2, 3, 1)


def forward_macs(shapes, batch: int, hr: int, conditioning: str, magnification: int = 2) -> int:
    """Multiply-adds of one forward of ``batch`` images of ``hr`` x ``hr``:
    each convolution, ConvTranspose and linear layer at its own resolution,
    counted from the layer shapes (used by tests against the hook count)."""
    def conv(name, res, k=None):
        o, i, kh, kw = shapes[f"{name}.weight"]
        return batch * res * res * o * i * kh * kw

    macs = conv("conv0", hr)
    if conditioning == "superres":
        lr = hr // magnification
        macs += sum(conv(f"LR_encoder.blocks.{i}.conv{j}", lr) for i in range(3) for j in (1, 2))
        macs += conv("LR_encoder.conv_out", lr) + conv("conv_upsampled_lr_img", hr)
    res = [hr >> k for k in range(4)]
    for i, n in enumerate(["conv_blocks.0", "conv_blocks.1", "conv_blocks.2", "bottle_neck"]):
        r = res[i]
        skip = "conv_upsampled_lr_img" if conditioning == "superres" else "conv_skip"
        macs += conv(f"{n}.conv1.0", r) + conv(f"{n}.conv2.0", r) + conv(f"{n}.shortcut_conv.0", r)
        if i == 0:
            macs += conv(f"{n}.{skip}", r)
        c = shapes[f"{n}.time_mlp.0.weight"][0]
        macs += batch * (TIME_DIM * c + c * c)
    for i in range(3):
        macs += conv(f"downs.{i}", res[i + 1])
    for i in range(3):
        r_g, r_x = res[3 - i], res[2 - i]
        macs += conv(f"gating_signals.{i}.conv", r_g)
        n = f"attention_blocks.{i}"
        macs += conv(f"{n}.w_g.0", r_g) + conv(f"{n}.w_x.0", r_g) + conv(f"{n}.psi.0", r_g)
        macs += conv(f"{n}.result.0", r_x)
        c = shapes[f"ups.{i}.time_mlp.0.weight"][0]
        macs += batch * (TIME_DIM * c + c * c) + conv(f"ups.{i}.conv", r_g)
        cin, cout, kh, kw = shapes[f"ups.{i}.transform.weight"]
        macs += batch * r_g * r_g * cin * cout * kh * kw
        macs += conv(f"up_convs.{i}", r_x)
    macs += conv("output", hr)
    return macs


def param_count(shapes) -> int:
    return sum(math.prod(shapes[n]) for n in trainable(shapes))
