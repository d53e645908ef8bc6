"""The Residual Attention UNet (port of
``diffusionremotesensing_tpu/models/unet.py``), in its conditionings:

* ``superres``: condition = the LR image: RRDB encode, torch-bicubic
  x``magnification_factor`` upsample, 3x3 conv, added to the stem;
* ``sar``: condition = the SAR image on the output grid (2 channels for 1
  NDVI channel): RRDB encode and 3x3 conv, no upsample;
* ``class``: condition = integer labels: ``label_emb`` (Embedding(num_classes,
  100)) added to the time embedding, multiplied per sample by ``cond_mask``
  (1 conditioned, 0 unconditioned: classifier-free guidance in one call);
* ``none``: unconditioned.

Attribute names follow the reference torch model of each task
(LR_encoder / conv_upsampled_lr_img, SAR_encoder / conv_SAR_img, and the
blocks' unused skip conv under the same name or ``conv_skip``), so its
``state_dict()`` is the reference's.

Skeleton: stem 3x3 conv to 16 channels plus the condition stem; three
ResConvBlocks (16->32->64->128), each followed by a stride-2 3x3 conv;
bottleneck ResConvBlock 128->256; three up stages of [gating signal ->
additive attention gate on the skip -> UpConvBlock x2 -> concat -> 3x3
conv]; 1x1 output conv. The stem output also feeds ResConvBlock-0 as its
skip input.

Two executions of the same function:

* the plain forward, layer by layer as the reference torch model runs it;
* the s2d forward (``s2d=True``): the full-resolution level in
  space-to-depth layout with kernels assembled once by
  :meth:`prepare_s2d_kernels`, the up-stage-2 head composed with the output
  conv and the ConvTranspose (derivations in the reference's
  ``prepare_s2d_kernels``). ResConvBlock-0 runs by ``tap44`` level:
  False, dense s2d convolutions; 'conv2', its conv2 through
  ``ops.tap_conv.tap_conv``; True, also conv1 and the skip conv through one
  ``tap_conv_pair`` call; 'block', the whole block as one
  ``ops.tap_block.tap_block`` call; 'stem', the stem's conv0 + bias + cond
  add and the whole block as one ``tap_stem_block`` call, so its input h_s
  never reaches device memory; 'l1', 'block' plus level 1 in s2d: down0
  emits s2d, ResConvBlock-1 is a second ``tap_block`` call without its skip
  conv, and down1 and attention gate 1 read s2d. The kernels are
  hand-written CUDA on the card, all of them. With
  ``fused_att=True`` gating signal 2, attention gate 2 and the head's
  ``head_at`` conv are one call of ``ops.att_block.att_head_block``; with
  ``dec_block=True`` the stage-1 concat conv, the UpConvBlock-2 body and
  the head's ``head_up4`` conv are one call of ``ops.dec_block.dec_block``
  (CUDA kernels on the card, both). With ``packed_head=True`` and neither
  of those two, the head's ``head_up4`` and ``head_at`` convs are one call
  of ``ops.packed_head.packed_head`` (a CUDA kernel on the card); with
  either of them the flag has no effect, as in the reference, since those
  kernels already hold the head's convs. Unlike the reference, which keeps
  the unfused chain for shapes its TPU kernels cannot hold, the fused
  branches run for every shape when their flag is on.

``use_pallas=True`` (the reference's flag name) runs every attention gate
the forward computes through ``ops.attention_gate.fused_attention_gate``,
one CUDA kernel a gate on the card: all three on the plain forward, gates 0
and 1 on the s2d path (gate 2 there is the s2d gate or ``att_head_block``;
under ``tap44='l1'`` gate 1 is the s2d gate too).

Public tensors are NHWC, as in the reference package: ``forward`` takes x
(B, H, W, image_channels), t (B,), the condition (the LR image (B, H/mag,
W/mag, C), the SAR image (B, H, W, 2), labels (B,) or None) and
``cond_mask`` (B,) or None, and returns float32 (B, H, W, out_dim).
Inference only. The compute dtype is the dtype of the parameters
(``model.to(torch.bfloat16)``); ``prepare_s2d_kernels`` folds in float32
whatever the parameters' dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from diffusionremotesensing_tpu_torch.models.blocks import (
    RRDB,
    AttentionGate,
    GatingSignal,
    ResConvBlock,
    TorchConv,
    UpConvBlock,
    sinusoidal_time_embedding,
)
from diffusionremotesensing_tpu_torch.ops.att_block import att_head_block, build_att_weights
from diffusionremotesensing_tpu_torch.ops.attention_gate import build_gate_weights
from diffusionremotesensing_tpu_torch.ops.dec_block import build_dec_weights
from diffusionremotesensing_tpu_torch.ops.dec_block import dec_block as dec_block_kernel
from diffusionremotesensing_tpu_torch.ops.packed_head import packed_head as packed_head_kernel
from diffusionremotesensing_tpu_torch.ops.resize import upsample_bicubic
from diffusionremotesensing_tpu_torch.ops.s2d import (
    conv_nhwc,
    depth_to_space,
    hwio_to_oihw,
    k1_to_blockdiag,
    k2s2_to_1x1,
    k3_to_s2d,
    k3s2_to_s2d,
    kdown_to_s2d_out,
    kT_to_s2d,
    space_to_depth,
)
from diffusionremotesensing_tpu_torch.ops.tap_block import (
    build_block_weights,
    build_stem_weights,
    tap_block,
    tap_stem_block,
)
from diffusionremotesensing_tpu_torch.ops.tap_conv import tap_conv, tap_conv_pair, tap_weight

TAP44_LEVELS = (False, "conv2", True, "block", "stem", "l1")
CONDITIONINGS = ("superres", "sar", "class", "none")
# the reference torch model's names of the condition encoder, its conv and
# the blocks' (unused) skip conv, per conditioning
_NAMES = {"superres": ("LR_encoder", "conv_upsampled_lr_img", "conv_upsampled_lr_img"),
          "sar": ("SAR_encoder", "conv_SAR_img", "conv_SAR_img"),
          "class": (None, None, "conv_skip"), "none": (None, None, "conv_skip")}

# kernel-dict entries that are HWIO conv kernels (stored OIHW, channels-last)
_CONV_KEYS = ("conv0", "blk_conv1", "blk_skip", "blk_conv2", "blk_short", "down0", "att_wx",
              "att_rc", "head_at", "head_up4", "head_fix_x", "head_fix_y", "down0_s2d",
              "down1_s2d", "att1_wx", "att1_rc")


def _hwio(conv: nn.Conv2d) -> torch.Tensor:
    return conv.weight.detach().float().permute(2, 3, 1, 0)


def _vec(p: torch.Tensor) -> torch.Tensor:
    return p.detach().float()


def _bn_dict(bn: nn.BatchNorm2d) -> dict:
    return {"scale": _vec(bn.weight), "bias": _vec(bn.bias),
            "mean": _vec(bn.running_mean), "var": _vec(bn.running_var)}


def _bn_affine(bn: nn.BatchNorm2d, taps: bool = True):
    """Inference BatchNorm as y = x * a + c, tiled over the 4 s2d taps."""
    a = _vec(bn.weight) / torch.sqrt(_vec(bn.running_var) + bn.eps)
    c = _vec(bn.bias) - _vec(bn.running_mean) * a
    return (a.repeat(4), c.repeat(4)) if taps else (a, c)


class ResidualAttentionUNet(nn.Module):
    """Epsilon-predicting Residual Attention UNet, conditioned as
    ``conditioning`` says (module docstring)."""

    def __init__(
        self,
        conditioning: str = "superres",
        image_channels: int = 3,
        out_dim: int = 3,
        cond_channels: int = 3,
        num_classes: Optional[int] = None,
        magnification_factor: Optional[int] = 2,
        time_emb_dim: int = 100,
        down_channels: Tuple[int, ...] = (16, 32, 64, 128, 256),
        up_channels: Tuple[int, ...] = (256, 128, 64, 32, 16),
        s2d: bool = False,
        tap44: object = False,
        fused_att: bool = False,
        dec_block: bool = False,
        use_pallas: bool = False,
        packed_head: bool = False,
        s2d_train: bool = False,
    ):
        super().__init__()
        if conditioning not in CONDITIONINGS:
            raise ValueError(f"conditioning must be one of {CONDITIONINGS}, got {conditioning!r}")
        if conditioning == "superres" and magnification_factor is None:
            raise ValueError("superres conditioning requires magnification_factor")
        if s2d_train:
            raise NotImplementedError("s2d_train (the s2d training forward) waits for the port "
                                      "of training")
        if not isinstance(tap44, (bool, str)) or tap44 not in TAP44_LEVELS:
            raise ValueError(f"tap44 must be one of {TAP44_LEVELS}, got {tap44!r}")
        if (fused_att or dec_block or packed_head) and not s2d:
            raise ValueError("fused_att, dec_block and packed_head are branches of the s2d path: "
                             "pass s2d=True")
        self.conditioning = conditioning
        self.image_channels = image_channels
        self.out_dim = out_dim
        self.cond_channels = cond_channels
        self.num_classes = num_classes
        self.magnification_factor = magnification_factor
        self.time_emb_dim = time_emb_dim
        self.down_channels = tuple(down_channels)
        self.up_channels = tuple(up_channels)
        self.s2d = s2d
        self.tap44 = tap44
        self.fused_att = bool(fused_att)
        self.dec_block = bool(dec_block)
        self.use_pallas = bool(use_pallas)
        self.packed_head = bool(packed_head)
        dc, uc = self.down_channels, self.up_channels
        n_lv = len(dc) - 2

        enc_name, cond_conv_name, skip_name = _NAMES[conditioning]
        self._enc_name, self._cond_conv_name = enc_name, cond_conv_name
        self.conv0 = TorchConv(image_channels, dc[0], 3)
        if enc_name is not None:
            setattr(self, enc_name, RRDB(cond_channels, num_blocks=3))
            setattr(self, cond_conv_name, TorchConv(cond_channels, dc[0], 3))
        if conditioning == "class" and num_classes is not None:
            self.label_emb = nn.Embedding(num_classes, time_emb_dim)
        self.conv_blocks = nn.ModuleList(
            [ResConvBlock(dc[i], dc[i + 1], time_emb_dim, skip_name) for i in range(n_lv)])
        self.downs = nn.ModuleList(
            [TorchConv(dc[i + 1], dc[i + 1], 3, stride=2) for i in range(n_lv)])
        self.bottle_neck = ResConvBlock(dc[-2], dc[-1], time_emb_dim, skip_name)
        self.gating_signals = nn.ModuleList(
            [GatingSignal(uc[i], uc[i + 1]) for i in range(n_lv)])
        self.attention_blocks = nn.ModuleList(
            [AttentionGate(uc[i + 1], use_pallas=self.use_pallas) for i in range(n_lv)])
        self.ups = nn.ModuleList([UpConvBlock(uc[i], time_emb_dim) for i in range(n_lv)])
        self.up_convs = nn.ModuleList(
            [TorchConv(uc[i] + uc[i + 1], uc[i + 1], 3) for i in range(n_lv)])
        self.output = TorchConv(uc[n_lv], out_dim, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv0.weight.dtype

    @property
    def _packed_tail(self) -> bool:
        """Whether the unfused tail runs its head through packed_head: with
        fused_att or dec_block the head's convs live in those kernels."""
        return self.packed_head and not (self.fused_att or self.dec_block)

    @property
    def image_conditioned(self) -> bool:
        return self._enc_name is not None

    # ------------------------------------------------------------ condition

    def encode_cond(self, cond: torch.Tensor) -> torch.Tensor:
        """Condition stem, NHWC in and out: RRDB encode, bicubic upsample
        (superres only), 3x3 conv. Loop-invariant during sampling: samplers
        call it once."""
        if not self.image_conditioned:
            raise ValueError("encode_cond applies to the image-conditioned variants")
        c = getattr(self, self._enc_name)(cond.to(self.dtype).permute(0, 3, 1, 2))
        if self.conditioning == "superres":
            c = upsample_bicubic(c.permute(0, 2, 3, 1), self.magnification_factor).permute(0, 3, 1, 2)
        return getattr(self, self._cond_conv_name)(c).permute(0, 2, 3, 1)

    def encode_cond_s2d(self, cond: torch.Tensor) -> torch.Tensor:
        """:meth:`encode_cond` in space-to-depth layout (the s2d path's input)."""
        return space_to_depth(self.encode_cond(cond))

    # ------------------------------------------------------------- forward

    def time_embedding(self, t, cond=None, cond_mask=None) -> torch.Tensor:
        """The sinusoidal embedding of t, plus (class conditioning) the label
        embedding of ``cond`` times ``cond_mask``, in the compute dtype."""
        t_emb = sinusoidal_time_embedding(t, self.time_emb_dim)
        if self.conditioning == "class" and self.num_classes is not None and cond is not None:
            lab = self.label_emb(cond.long()).float()
            if cond_mask is not None:
                lab = lab * cond_mask.float()[:, None]
            t_emb = t_emb + lab
        return t_emb.to(self.dtype)

    def forward(self, x, t, cond=None, cond_mask=None, cond_features=None, s2d_kernels=None,
                s2d_io: bool = False):
        t_emb = self.time_embedding(t, cond, cond_mask)
        if self.image_conditioned and cond_features is None:
            if cond is None:
                raise ValueError(f"conditioning={self.conditioning!r} requires a condition image")
            cond_features = self.encode_cond_s2d(cond) if self.s2d else self.encode_cond(cond)
        if self.s2d:
            if s2d_kernels is None:
                s2d_kernels = self.prepare_s2d_kernels()
            return self._forward_s2d(x, t_emb, cond_features, s2d_kernels, s2d_io)

        h = self.conv0(x.to(self.dtype).permute(0, 3, 1, 2))
        if cond_features is not None:
            h = h + cond_features.to(self.dtype).permute(0, 3, 1, 2)
        x_skip = h
        residuals = []
        for i, (block, down) in enumerate(zip(self.conv_blocks, self.downs)):
            h = block(h, t_emb, x_skip if i == 0 else None)
            residuals.append(h)
            h = down(h)
        h = self.bottle_neck(h, t_emb)
        for i in range(len(self.ups)):
            g = self.gating_signals[i](h)
            attn = self.attention_blocks[i](residuals[-(i + 1)], g)
            h = self.up_convs[i](torch.cat([self.ups[i](h, t_emb), attn], dim=1))
        return self.output(h).float().permute(0, 2, 3, 1)

    # ------------------------------------------------------- s2d execution

    def _upconv2_plain_concat_perm(self) -> np.ndarray:
        """Input-channel permutation taking up_conv2's s2d kernel from the
        tap-interleaved concat layout to the plain concat [s2d(up), s2d(attn)]."""
        c_up, c_at = self.up_channels[2], self.up_channels[3]
        c_tot = c_up + c_at
        perm = np.empty((4 * c_tot,), np.int64)
        for t in range(4):
            for c in range(c_tot):
                plain = t * c_up + c if c < c_up else 4 * c_up + t * c_at + (c - c_up)
                perm[plain] = t * c_tot + c
        return perm

    @torch.no_grad()
    def prepare_s2d_kernels(self, dtype: Optional[torch.dtype] = None) -> dict:
        """Every s2d kernel, bias and folded BatchNorm of the s2d path, built
        once from the parameters in float32 and cast to ``dtype`` (default:
        the parameters' dtype). Samplers hoist this out of the step loop."""
        dt = dtype or self.dtype
        blk, att, up = self.conv_blocks[0], self.attention_blocks[2], self.ups[2]
        k = {"conv0_b": _vec(self.conv0.bias).repeat(4)}
        k.update(self._gate_s2d_kernels(2))
        down0 = k3s2_to_s2d(_hwio(self.downs[0]))
        if self.tap44 == "l1":
            # level 1 in s2d: down0 emits the s2d of its output, ResConvBlock-1
            # is a second tap_block without its skip conv, down1 and gate 1
            # read s2d
            blk1 = self.conv_blocks[1]
            k["down0_s2d"] = kdown_to_s2d_out(down0)
            k["down0_s2d_b"] = _vec(self.downs[0].bias).repeat(4)
            k["tap_block1"] = build_block_weights(
                _hwio(blk1.conv1[0]), _vec(blk1.conv1[0].bias), _bn_dict(blk1.batch_norm1),
                None, None,
                _hwio(blk1.conv2[0]), _vec(blk1.conv2[0].bias), _bn_dict(blk1.batch_norm2),
                _hwio(blk1.shortcut_conv[0]), _vec(blk1.shortcut_conv[0].bias),
                _bn_dict(blk1.shortcut_batch_norm),
            )
            k["down1_s2d"] = k3s2_to_s2d(_hwio(self.downs[1]))
            k["down1_b"] = _vec(self.downs[1].bias)
            k.update(self._gate_s2d_kernels(1))
        else:
            k["down0"], k["down0_b"] = down0, _vec(self.downs[0].bias)
        if self.tap44 != "stem":
            k["conv0"] = k3_to_s2d(_hwio(self.conv0))
        if self.tap44 in ("block", "stem", "l1"):
            bw = build_block_weights(
                _hwio(blk.conv1[0]), _vec(blk.conv1[0].bias), _bn_dict(blk.batch_norm1),
                _hwio(blk.skip_conv), _vec(blk.skip_conv.bias),
                _hwio(blk.conv2[0]), _vec(blk.conv2[0].bias), _bn_dict(blk.batch_norm2),
                _hwio(blk.shortcut_conv[0]), _vec(blk.shortcut_conv[0].bias),
                _bn_dict(blk.shortcut_batch_norm),
            )
            if self.tap44 == "stem":
                k["tap_stem"] = build_stem_weights(_hwio(self.conv0), bw)
            else:
                k["tap_block"] = bw
        else:
            # tap44 False, 'conv2' or True: each conv dense or as a tap
            # matrix (ops.tap_conv.tap_weight), built once here
            k.update({
                "blk_b1": _vec(blk.conv1[0].bias).repeat(4),
                "blk_bsk": _vec(blk.skip_conv.bias).repeat(4),
                "blk_b2": _vec(blk.conv2[0].bias).repeat(4),
                "blk_short": k1_to_blockdiag(_hwio(blk.shortcut_conv[0])),
                "blk_bsh": _vec(blk.shortcut_conv[0].bias).repeat(4),
            })
            if self.tap44 is True:
                k["blk_conv1_44"] = tap_weight(_hwio(blk.conv1[0]))
                k["blk_skip_44"] = tap_weight(_hwio(blk.skip_conv))
            else:
                k["blk_conv1"] = k3_to_s2d(_hwio(blk.conv1[0]))
                k["blk_skip"] = k3_to_s2d(_hwio(blk.skip_conv))
            if self.tap44:
                k["blk_conv2_44"] = tap_weight(_hwio(blk.conv2[0]))
            else:
                k["blk_conv2"] = k3_to_s2d(_hwio(blk.conv2[0]))
            k["bn0_a"], k["bn0_c"] = _bn_affine(blk.batch_norm1)
            k["bn1_a"], k["bn1_c"] = _bn_affine(blk.batch_norm2)
            k["bn2_a"], k["bn2_c"] = _bn_affine(blk.shortcut_batch_norm)

        # head composition: up_conv2 feeds only the 1x1 output conv, so the
        # two compose into one 3x3 conv; its up-branch half then composes
        # with up2's ConvTranspose (as the s2d 2x2 kernel K2) into one 4x4
        # conv on hh, with exact boundary strips and a bias frame
        w_up, b_up = _hwio(self.up_convs[2]), _vec(self.up_convs[2].bias)
        w_out, b_out = _hwio(self.output)[0, 0], _vec(self.output.bias)
        head = torch.einsum("uvic,co->uvio", w_up, w_out)
        head_s2d = k3_to_s2d(head)[:, :, torch.from_numpy(self._upconv2_plain_concat_perm()), :]
        n_up = 4 * self.up_channels[2]
        H_up = head_s2d[:, :, :n_up, :]
        k["head_at"] = head_s2d[:, :, n_up:, :]
        # torch ConvTranspose weight (in, out, kh, kw) -> the flipped HWIO
        # kernel of the equivalent input-dilated forward conv
        kT = up.transform.weight.detach().float().permute(2, 3, 0, 1).flip(0, 1)
        K2 = kT_to_s2d(kT)
        K4 = K2.new_zeros((4, 4, K2.shape[2], H_up.shape[3]))
        for dy in range(3):
            for ky in range(2):
                for dx in range(3):
                    for kx in range(2):
                        K4[dy + ky, dx + kx] += K2[ky, kx] @ H_up[dy, dx]
        k["head_up4"] = K4
        k["head_fix_x"] = torch.stack([
            sum(K2[1, kx] @ H_up[0, dx] for dx in range(3) for kx in range(2) if dx + kx == t)
            for t in range(4)])[None]
        k["head_fix_y"] = torch.stack([
            sum(K2[ky, 1] @ H_up[dy, 0] for dy in range(3) for ky in range(2) if dy + ky == t)
            for t in range(4)])[:, None]
        k["head_fix_c"] = K2[1, 1] @ H_up[0, 0]
        b_T = _vec(up.transform.bias).repeat(4)
        k["head_b"] = (b_up @ w_out + b_out).repeat(4)
        if self.fused_att:
            gat = self.gating_signals[2]
            k["att_fused"] = build_att_weights(
                _hwio(gat.conv), _vec(gat.conv.bias), _bn_dict(gat.batch_norm),
                _hwio(att.w_g[0]), _vec(att.w_g[0].bias), k["att_wx"], _vec(att.w_x[0].bias),
                _hwio(att.psi[0]), _vec(att.psi[0].bias), k["att_rc"], _vec(att.result[0].bias),
                _bn_dict(att.result[1]), k["head_at"],
            )
        if self.dec_block:
            k["dec"] = build_dec_weights(
                _hwio(self.up_convs[1]), _vec(self.up_convs[1].bias),
                _hwio(up.conv), _vec(up.conv.bias), _bn_dict(up.batch_norm), k["head_up4"],
            )
        if self._packed_tail:
            # the two head convs as the HWIO kernels packed_head takes
            k["packed_head"] = {"up4": k.pop("head_up4"), "at": k.pop("head_at")}

        dev = self.conv0.weight.device
        out = {}
        for name, v in k.items():
            if isinstance(v, dict):  # a kernel's weights, in the layout it takes
                out[name] = {n: w.to(dev, dt).contiguous() for n, w in v.items()}
            elif name in _CONV_KEYS:
                out[name] = hwio_to_oihw(v).to(dev, dt).contiguous(memory_format=torch.channels_last)
            else:
                out[name] = v.to(dev, dt)
        # the ConvTranspose-bias tap table stays float32: it is reduced into
        # the (small) bias frame, where bf16 would cost visible precision
        out["head_bT_taps"] = torch.einsum("uvmo,m->uvo", H_up, b_T).to(dev)
        if self.use_pallas:
            # the fused gates' weights stay float32, as the gate computes;
            # under 'l1' gate 1 is the s2d gate
            for i in ((0,) if self.tap44 == "l1" else (0, 1)):
                out[f"gate{i}"] = build_gate_weights(self.attention_blocks[i])
        out["frames"] = {}
        return out

    def _bias_frame(self, kern: dict, Hs: int, Ws: int) -> torch.Tensor:
        """The head's bias over the output grid: the ConvTranspose bias reaches
        edge rows/columns through fewer head taps. Cached per shape."""
        frame = kern["frames"].get((Hs, Ws))
        if frame is None:
            taps = kern["head_bT_taps"]
            rows = torch.ones((Hs, 3), device=taps.device)
            rows[0, 0] = rows[Hs - 1, 2] = 0.0
            cols = torch.ones((Ws, 3), device=taps.device)
            cols[0, 0] = cols[Ws - 1, 2] = 0.0
            frame = torch.einsum("yu,xv,uvo->yxo", rows, cols, taps) + kern["head_b"].float()
            kern["frames"][(Hs, Ws)] = frame
        return frame

    def _forward_s2d(self, x, t_emb, cond_s2d, kern, s2d_io):
        dt = self.dtype
        xs = x.to(dt) if s2d_io else space_to_depth(x.to(dt))
        blk = self.conv_blocks[0]
        te4 = blk.time_bias(t_emb).repeat(1, 4)
        if self.tap44 == "stem":
            # conv0 + bias + cond and the whole block in one call; without a
            # condition image the kernel adds the bias alone
            cond_in = None if cond_s2d is None else cond_s2d.to(dt).contiguous()
            res0_s = tap_stem_block(xs.contiguous(), cond_in, te4.contiguous(), kern["conv0_b"],
                                    kern["tap_stem"])
            return self._forward_s2d_tail(res0_s, t_emb, kern, s2d_io)
        h_s = conv_nhwc(xs, kern["conv0"], kern["conv0_b"], padding=1)
        if cond_s2d is not None:
            h_s = h_s + cond_s2d.to(dt)
        if self.tap44 in ("block", "l1"):
            res0_s = tap_block(h_s.contiguous(), te4.contiguous(), kern["tap_block"])
        else:
            if self.tap44 is True:
                c1, sk = tap_conv_pair(h_s.contiguous(), kern["blk_conv1_44"], kern["blk_skip_44"])
                c1, sk = c1 + kern["blk_b1"], sk + kern["blk_bsk"]
            else:
                c1 = conv_nhwc(h_s, kern["blk_conv1"], kern["blk_b1"], padding=1)
                sk = conv_nhwc(h_s, kern["blk_skip"], kern["blk_bsk"], padding=1)
            h = torch.relu(c1 * kern["bn0_a"] + kern["bn0_c"])
            h = h + sk
            h = h + te4[:, None, None, :]
            if self.tap44:  # 'conv2' and True
                h = tap_conv(h.contiguous(), kern["blk_conv2_44"]) + kern["blk_b2"]
            else:
                h = conv_nhwc(h, kern["blk_conv2"], kern["blk_b2"], padding=1)
            h = h * kern["bn1_a"] + kern["bn1_c"]
            s = conv_nhwc(h_s, kern["blk_short"], kern["blk_bsh"])
            res0_s = torch.relu(s * kern["bn2_a"] + kern["bn2_c"] + h)
        return self._forward_s2d_tail(res0_s, t_emb, kern, s2d_io)

    def _gate_s2d_kernels(self, gate: int) -> dict:
        """The s2d kernels of attention gate ``gate`` (2, or 1 under 'l1'),
        keyed 'att_*' for gate 2 and 'att1_*' for gate 1."""
        att, p = self.attention_blocks[gate], "att" if gate == 2 else f"att{gate}"
        k = {f"{p}_wx": k2s2_to_1x1(_hwio(att.w_x[0])), f"{p}_wx_b": _vec(att.w_x[0].bias),
             f"{p}_rc": k1_to_blockdiag(_hwio(att.result[0])),
             f"{p}_rc_b": _vec(att.result[0].bias).repeat(4)}
        k[f"{p}_bn_a"], k[f"{p}_bn_c"] = _bn_affine(att.result[1])
        return k

    def _attention_s2d(self, x_s2d, g, kern, gate: int = 2):
        """Attention gate ``gate`` (2, or 1 under 'l1') with its skip input
        in s2d layout: w_x's 2x2/s2 conv is one 1x1 over the taps, psi's
        nearest upsample a broadcast over the taps, result_conv
        block-diagonal. NHWC in and out."""
        att, p = self.attention_blocks[gate], "att" if gate == 2 else f"att{gate}"
        g1 = conv_nhwc(g, att.w_g[0].weight, att.w_g[0].bias)
        x1 = conv_nhwc(x_s2d, kern[f"{p}_wx"], kern[f"{p}_wx_b"])
        psi = torch.relu(g1 + x1)
        psi = torch.sigmoid(conv_nhwc(psi, att.psi[0].weight, att.psi[0].bias))
        attn_s = conv_nhwc(x_s2d * psi, kern[f"{p}_rc"], kern[f"{p}_rc_b"])
        return attn_s * kern[f"{p}_bn_a"] + kern[f"{p}_bn_c"]

    def _forward_s2d_tail(self, res0_s, t_emb, kern, s2d_io):
        """Everything after ResConvBlock-0: down0 out of s2d, levels 1+
        through the ordinary modules (level 1 in s2d under 'l1'), up stage 2
        and the composed head (through the fused kernels where
        ``dec_block`` / ``fused_att`` / ``packed_head`` ask)."""
        l1 = self.tap44 == "l1"
        if l1:
            # down0 at stride 2 emitting s2d, ResConvBlock-1 as one tap_block
            # call (no skip conv), down1 from s2d back to the normal layout
            h1_s = conv_nhwc(res0_s, kern["down0_s2d"], kern["down0_s2d_b"],
                             padding=((1, 0), (1, 0)), stride=2)
            te1 = self.conv_blocks[1].time_bias(t_emb).repeat(1, 4)
            res1_s = tap_block(h1_s.contiguous(), te1.contiguous(), kern["tap_block1"])
            h = conv_nhwc(res1_s, kern["down1_s2d"], kern["down1_b"], padding=((1, 0), (1, 0)))
            h = h.permute(0, 3, 1, 2)
        else:
            h = conv_nhwc(res0_s, kern["down0"], kern["down0_b"], padding=((1, 0), (1, 0)))
            h = h.permute(0, 3, 1, 2)
            res1 = h = self.conv_blocks[1](h, t_emb)
            h = self.downs[1](h)
        res2 = h = self.conv_blocks[2](h, t_emb)
        h = self.downs[2](h)
        h = self.bottle_neck(h, t_emb)
        attn = self.attention_blocks[0](res2, self.gating_signals[0](h), kern.get("gate0"))
        h = self.up_convs[0](torch.cat([self.ups[0](h, t_emb), attn], dim=1))
        if l1:
            g = self.gating_signals[1](h).permute(0, 2, 3, 1)
            attn = depth_to_space(self._attention_s2d(res1_s, g, kern, gate=1)).permute(0, 3, 1, 2)
        else:
            attn = self.attention_blocks[1](res1, self.gating_signals[1](h), kern.get("gate1"))
        hup = self.ups[1](h, t_emb)
        if self.dec_block:
            # stage-1 concat conv + UpConvBlock-2 body + head_up4 in one call;
            # h comes back NHWC for the gating branch, hh only as its strips
            h, hh_row0, hh_col0, out_s = dec_block_kernel(
                hup.permute(0, 2, 3, 1).contiguous(), attn.permute(0, 2, 3, 1).contiguous(),
                self.ups[2].time_bias(t_emb).contiguous(), kern["dec"])
            h = h.permute(0, 3, 1, 2)
        else:
            h = self.up_convs[1](torch.cat([hup, attn], dim=1))
            hh = self.ups[2].body(h, t_emb).permute(0, 2, 3, 1)
            if not self._packed_tail:
                out_s = conv_nhwc(hh, kern["head_up4"], padding=((1, 2), (1, 2)))
            hh_row0, hh_col0 = hh[:, :1], hh[:, :, :1]

        if self.fused_att:
            # gating2 + attention gate 2 + head_at in one call: attn_s never
            # exists outside the kernel
            out_s = out_s + att_head_block(res0_s.contiguous(),
                                           h.permute(0, 2, 3, 1).contiguous(), kern["att_fused"])
        else:
            attn_s = self._attention_s2d(res0_s, self.gating_signals[2](h).permute(0, 2, 3, 1),
                                         kern)
            if self._packed_tail:
                # head_up4 on hh + head_at on attn_s in one call
                kp = kern["packed_head"]
                out_s = packed_head_kernel(hh.contiguous(), attn_s.contiguous(), kp["up4"],
                                           kp["at"])
            else:
                out_s = out_s + conv_nhwc(attn_s, kern["head_at"], padding=1)
        # boundary corrections: the composed conv sees hh's padding through
        # intermediate row/column -1, which the uncomposed head zeroed
        out_s[:, :1] -= conv_nhwc(hh_row0, kern["head_fix_x"], padding=((0, 0), (1, 2)))
        out_s[:, :, :1] -= conv_nhwc(hh_col0, kern["head_fix_y"], padding=((1, 2), (0, 0)))
        out_s[:, :1, :1] += (hh_row0[:, 0, 0] @ kern["head_fix_c"])[:, None, None]
        out_s = out_s.float() + self._bias_frame(kern, out_s.shape[1], out_s.shape[2])
        return out_s if s2d_io else depth_to_space(out_s)


def residual_attention_unet_superres(image_channels: int = 3, out_dim: int = 3,
                                     magnification_factor: int = 2, s2d: bool = False,
                                     tap44: object = False, fused_att: bool = False,
                                     dec_block: bool = False, use_pallas: bool = False,
                                     packed_head: bool = False,
                                     s2d_train: bool = False) -> ResidualAttentionUNet:
    """Super-resolution UNet conditioned on the LR image (4,383,058 parameters)."""
    return ResidualAttentionUNet(
        conditioning="superres", image_channels=image_channels, out_dim=out_dim,
        cond_channels=image_channels, magnification_factor=magnification_factor,
        s2d=s2d, tap44=tap44, fused_att=fused_att, dec_block=dec_block, use_pallas=use_pallas,
        packed_head=packed_head, s2d_train=s2d_train,
    )


def residual_attention_unet_sar_to_ndvi(sar_channels: int = 2, ndvi_channels: int = 1,
                                        s2d: bool = False, tap44: object = False,
                                        fused_att: bool = False, dec_block: bool = False,
                                        use_pallas: bool = False, packed_head: bool = False,
                                        s2d_train: bool = False) -> ResidualAttentionUNet:
    """SAR->NDVI UNet conditioned on the SAR image (4,382,238 parameters)."""
    return ResidualAttentionUNet(
        conditioning="sar", image_channels=ndvi_channels, out_dim=ndvi_channels,
        cond_channels=sar_channels, magnification_factor=None, s2d=s2d, tap44=tap44,
        fused_att=fused_att, dec_block=dec_block, use_pallas=use_pallas, packed_head=packed_head,
        s2d_train=s2d_train,
    )


def residual_attention_unet_generation(image_channels: int = 3, out_dim: int = 3,
                                       num_classes: Optional[int] = 10, s2d: bool = False,
                                       tap44: object = False, fused_att: bool = False,
                                       dec_block: bool = False, use_pallas: bool = False,
                                       packed_head: bool = False,
                                       s2d_train: bool = False) -> ResidualAttentionUNet:
    """Class-conditional UNet with CFG masking (4,383,022 parameters at 10
    classes); ``num_classes=None`` is unconditional."""
    return ResidualAttentionUNet(
        conditioning="class", image_channels=image_channels, out_dim=out_dim,
        num_classes=num_classes, magnification_factor=None, s2d=s2d, tap44=tap44,
        fused_att=fused_att, dec_block=dec_block, use_pallas=use_pallas, packed_head=packed_head,
        s2d_train=s2d_train,
    )


def param_count(model: nn.Module) -> int:
    """Number of scalar parameters (a module registered twice counts once)."""
    return sum(p.numel() for p in model.parameters())
