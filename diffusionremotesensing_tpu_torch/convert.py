"""Weights for the port: from the reference package's variables, or random.

:func:`from_jax_variables` is this package's own copy of the mapping that
``diffusionremotesensing_tpu/io.py:export_torch_state_dict`` (:338) applies,
taking the variables as nested dicts of numpy arrays, so nothing of JAX is
needed to use it. Conv kernels go from HWIO to OIHW, Dense kernels are
transposed, each BatchNorm is emitted under every name the reference model
registers it by, and the ConvTranspose kernel (kept by the reference package
as the flipped HWIO kernel of the equivalent forward conv) goes to torch's
(in, out, kh, kw) with the spatial flip undone.
"""

from __future__ import annotations

import numpy as np
import torch

from diffusionremotesensing_tpu_torch.models.unet import residual_attention_unet_superres


def from_jax_variables(params, batch_stats) -> dict:
    """Super-resolution UNet variables (nested dicts of arrays) -> a state_dict
    for :class:`~diffusionremotesensing_tpu_torch.models.unet.ResidualAttentionUNet`."""
    out = {}

    def T(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    def put_conv(name, node):
        out[f"{name}.weight"] = T(np.transpose(np.asarray(node["conv"]["kernel"]), (3, 2, 0, 1)))
        out[f"{name}.bias"] = T(node["conv"]["bias"])

    def put_linear(name, node):
        out[f"{name}.weight"] = T(np.asarray(node["linear"]["kernel"]).T)
        out[f"{name}.bias"] = T(node["linear"]["bias"])

    def put_bn(names, p, s):
        for n in names:
            out[f"{n}.weight"] = T(p["scale"])
            out[f"{n}.bias"] = T(p["bias"])
            out[f"{n}.running_mean"] = T(s["mean"])
            out[f"{n}.running_var"] = T(s["var"])
            out[f"{n}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    def put_convtranspose(name, node):
        k = np.asarray(node["kernel"])[::-1, ::-1]
        out[f"{name}.weight"] = T(np.transpose(k, (2, 3, 0, 1)))
        out[f"{name}.bias"] = T(node["bias"])

    def put_resblock(prefix, flax_name):
        p, s = params[flax_name], batch_stats[flax_name]
        put_linear(f"{prefix}.time_mlp.0", p["time_mlp"]["fc1"])
        put_linear(f"{prefix}.time_mlp.2", p["time_mlp"]["fc2"])
        put_conv(f"{prefix}.conv1.0", p["conv1"])
        put_conv(f"{prefix}.conv_upsampled_lr_img", p["conv_skip"])
        put_conv(f"{prefix}.conv2.0", p["conv2"])
        put_conv(f"{prefix}.shortcut_conv.0", p["shortcut_conv"])
        put_bn([f"{prefix}.batch_norm1", f"{prefix}.conv1.1"], p["BatchNorm_0"], s["BatchNorm_0"])
        put_bn([f"{prefix}.batch_norm2", f"{prefix}.conv2.1"], p["BatchNorm_1"], s["BatchNorm_1"])
        put_bn([f"{prefix}.shortcut_batch_norm", f"{prefix}.shortcut_conv.1"],
               p["BatchNorm_2"], s["BatchNorm_2"])

    if "cond_encoder" not in params:
        raise KeyError("expected the super-resolution model's variables (no 'cond_encoder')")
    put_conv("conv0", params["conv0"])
    put_conv("output", params["output"])
    put_conv("conv_upsampled_lr_img", params["conv_cond"])
    for i in range(3):
        blk = params["cond_encoder"][f"block{i}"]
        put_conv(f"LR_encoder.blocks.{i}.conv1", blk["conv1"])
        put_conv(f"LR_encoder.blocks.{i}.conv2", blk["conv2"])
    put_conv("LR_encoder.conv_out", params["cond_encoder"]["conv_out"])
    for i in range(3):
        put_resblock(f"conv_blocks.{i}", f"conv_block{i}")
        put_conv(f"downs.{i}", params[f"down{i}"])
    put_resblock("bottle_neck", "bottle_neck")
    for i in range(3):
        put_conv(f"gating_signals.{i}.conv", params[f"gating{i}"]["conv"])
        put_bn([f"gating_signals.{i}.batch_norm"], params[f"gating{i}"]["BatchNorm_0"],
               batch_stats[f"gating{i}"]["BatchNorm_0"])
        a, sa = params[f"attention{i}"], batch_stats[f"attention{i}"]
        put_conv(f"attention_blocks.{i}.w_g.0", a["w_g"])
        put_conv(f"attention_blocks.{i}.w_x.0", a["w_x"])
        put_conv(f"attention_blocks.{i}.psi.0", a["psi"])
        put_conv(f"attention_blocks.{i}.result.0", a["result_conv"])
        put_bn([f"attention_blocks.{i}.result.1"], a["BatchNorm_0"], sa["BatchNorm_0"])
        u, su = params[f"up{i}"], batch_stats[f"up{i}"]
        put_linear(f"ups.{i}.time_mlp.0", u["time_mlp"]["fc1"])
        put_linear(f"ups.{i}.time_mlp.2", u["time_mlp"]["fc2"])
        put_conv(f"ups.{i}.conv", u["conv"])
        put_bn([f"ups.{i}.batch_norm"], u["BatchNorm_0"], su["BatchNorm_0"])
        put_convtranspose(f"ups.{i}.transform", u["transform"])
        put_conv(f"up_convs.{i}", params[f"up_conv{i}"])
    return out


def init_params(seed: int, device="cuda", magnification_factor: int = 2) -> dict:
    """A random full-width super-resolution state_dict drawn from a CPU
    ``torch.Generator`` seeded with ``seed`` (the same numbers on every
    machine), then moved to ``device``.

    Conv and linear weights and biases follow torch's default
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)); BatchNorms get random but
    well-conditioned affines and running statistics (scale and var near 1),
    so that folding them into the kernels is exercised."""
    gen = torch.Generator().manual_seed(seed)
    model = residual_attention_unet_superres(magnification_factor=magnification_factor)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen) * (hi - lo) + lo

    drawn = {}  # id(module) -> {attribute: tensor}, one draw per module
    for mod in model.modules():
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear)):
            bound = 1.0 / np.sqrt(mod.weight[0].numel())
            drawn[id(mod)] = {"weight": uniform(mod.weight.shape, -bound, bound),
                              "bias": uniform(mod.bias.shape, -bound, bound)}
        elif isinstance(mod, torch.nn.BatchNorm2d):
            c = mod.num_features
            drawn[id(mod)] = {"weight": uniform((c,), 0.8, 1.2),
                              "bias": uniform((c,), -0.1, 0.1),
                              "running_mean": uniform((c,), -0.1, 0.1),
                              "running_var": uniform((c,), 0.5, 1.5),
                              "num_batches_tracked": torch.tensor(0, dtype=torch.long)}
    # a BatchNorm registered under two names appears under both keys
    sd = {}
    for name, mod in model.named_modules(remove_duplicate=False):
        for attr, value in drawn.get(id(mod), {}).items():
            sd[f"{name}.{attr}"] = value
    missing = set(model.state_dict()) - set(sd)
    if missing:
        raise KeyError(f"init_params: no value drawn for {sorted(missing)}")
    return {k: v.to(device) for k, v in sd.items()}
