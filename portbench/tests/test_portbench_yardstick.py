"""The copied operation and bound arithmetic against hand counts and the
forward hooks' count of the program's model at a small shape."""

import json
import os

import pytest
import torch

from portbench import readers, weights, yardstick
from portbench import run as prun


def hook_macs(model, *args, **kw):
    """Multiply-adds of every Conv2d, ConvTranspose2d and Linear call, by
    forward hooks on the meta device (chip_smoke.py's train_flops count)."""
    macs = []

    def count(mod, inputs, out):
        if isinstance(mod, torch.nn.ConvTranspose2d):
            macs.append(inputs[0].numel() * mod.out_channels * mod.weight[0, 0].numel())
        elif isinstance(mod, torch.nn.Conv2d):
            macs.append(out.numel() * mod.weight[0].numel())
        elif isinstance(mod, torch.nn.Linear):
            macs.append(out.numel() * mod.in_features)

    hooks = [m.register_forward_hook(count) for m in model.modules()]
    try:
        with torch.no_grad():
            model(*args, **kw)
    finally:
        for h in hooks:
            h.remove()
    return sum(macs)


@pytest.mark.parametrize("name", ["sr_x2", "gen_eurosat10"])
def test_forward_flops_match_the_hook_count(name):
    from diffusionremotesensing_tpu_torch.models import unet as punet

    config = json.load(open(os.path.join(prun.HERE, "configs", f"{name}.json")))
    b, hr = 3, 32
    if config["conditioning"] == "superres":
        model = punet.residual_attention_unet_superres().to("meta")
        args = (torch.empty(b, hr, hr, 3, device="meta"), torch.empty(b, device="meta"),
                torch.empty(b, hr // 2, hr // 2, 3, device="meta"))
    else:
        model = punet.residual_attention_unet_generation(num_classes=10).to("meta")
        args = (torch.empty(b, hr, hr, 3, device="meta"), torch.empty(b, device="meta"),
                torch.zeros(b, dtype=torch.int64, device="meta"))
    want = 2 * hook_macs(model, *args)
    got = yardstick.forward_flops(weights.shapes_of(config), b, hr, config["conditioning"])
    # the model's forward runs every unused skip conv but ResConvBlock-0's
    # under no hook; the hook count includes exactly what runs
    assert got == want


def test_param_count():
    for name, n in (("sr_x2", 4383058), ("gen_eurosat10", 4383022)):
        config = json.load(open(os.path.join(prun.HERE, "configs", f"{name}.json")))
        from portbench.reference.unet import param_count

        assert param_count(weights.shapes_of(config)) == n == config["num_params"]


def test_bounds_by_hand():
    # a 3x3 conv 16 -> 32 over 2 x 8 x 8 pixels: 2 * 128 * 9 * 16 * 32 FLOPs
    dense, issued = yardstick.block_flops(2, 4, 4, 64, 128)
    ci, co, px = 16, 32, 2 * 8 * 8
    assert dense == 2 * px * (2 * 9 * ci * co + 9 * co * co + ci * co)
    assert issued >= dense  # the tap form's structural zeros are issued, not counted
    ms, by = yardstick.block_bound(2, 4, 4, 64, 128, 2, yardstick.PEAK_BF16)
    flop_ms = dense / yardstick.PEAK_BF16 * 1e3
    assert ms >= flop_ms and by in ("operations", "bytes")
    # at a large batch the block is bound by its operations
    assert yardstick.block_bound(196, 64, 64, 64, 128, 2, yardstick.PEAK_BF16)[1] == "operations"


def test_layer_flops_by_hand():
    # gate: w_g C->C and psi C->1 at the gating pixel, w_x 4C->C and the
    # result conv C->C at its 4 pixels
    assert yardstick.gate_flops(2, 4, 4, 8) == 2 * 2 * 16 * (64 + 8 + 4 * 64 + 4 * 64)
    # stem: conv0 3->16 at full resolution plus ResConvBlock-0
    assert (yardstick.stem_flops(2, 4, 4) - yardstick.block_flops(2, 4, 4, 64, 128)[0]
            == 2 * 2 * 8 * 8 * 9 * 3 * 16)
    # dec: 3x3 (128+64)->64, 3x3 64->64, 25 taps 64->3
    assert yardstick.dec_flops(1, 2, 2) == 2 * 4 * (9 * 192 * 64 + 9 * 64 * 64 + 25 * 64 * 3)


def test_kernel_map_names_every_layer():
    kmap = readers.kernel_map()
    for layer in ("tap_stem_block", "tap_block", "att_head_block", "dec_block",
                  "fused_attention_gate"):
        assert kmap[layer]["names"]
        w = {"batch": 4, "s2d_px": 8, "conditioned": True}
        assert readers._bound_fn(kmap[layer]["bound"])(w) > 0
