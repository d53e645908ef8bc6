"""The plain reference against the program's plain path at a tiny size on
the CPU, float32."""

import json
import os

import numpy as np
import pytest
import torch

from portbench import weights
from portbench import run as prun
from portbench.reference import blend, downblur, sampling
from portbench.reference.unet import UNet


def config(name):
    return json.load(open(os.path.join(prun.HERE, "configs", f"{name}.json")))


def program(name, state, **flags):
    from portbench import common

    return common.program_unet(config(name), flags, state, torch.device("cpu"))


@pytest.mark.parametrize("name,train", [("sr_x2", False), ("sr_x2", True), ("gen_eurosat10", False)])
def test_forward(name, train):
    cfg = config(name)
    state = weights.make(cfg, 11, "cpu")
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 32, 32, 3, generator=g)
    t = torch.tensor([900.0, 3.0])
    if cfg["conditioning"] == "superres":
        cond, mask = torch.rand(2, 16, 16, 3, generator=g), None
    else:
        cond, mask = torch.tensor([4, 9]), torch.tensor([1.0, 0.0])
    with torch.no_grad():
        got = program(name, state)(x, t, cond, mask, train=train)
        want = UNet(state, cfg["conditioning"], cfg.get("magnification_factor") or 1)(
            x, t, cond, mask, train=train)
    assert torch.allclose(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


def test_ddim_with_guidance():
    from diffusionremotesensing_tpu_torch.diffusion import make_process

    cfg = config("gen_eurosat10")
    state = weights.make(cfg, 12, "cpu")
    proc = make_process(program("gen_eurosat10", state), "cosine", 1500, 16)
    x_T = torch.randn(3, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    labels = torch.tensor([0, 5, 9])
    got = proc.ddim_sampler(5, cfg_scale=3.0, clip_x0=True)(x_T, labels)
    net = UNet(state, "class")
    with torch.no_grad():
        want = sampling.ddim(sampling.guided(net, labels, 3.0), x_T,
                             sampling.alpha_hat("cosine", 1500), 5)
    assert torch.allclose(got, want, atol=1e-5)


def test_schedule_and_timesteps():
    from diffusionremotesensing_tpu_torch.diffusion import ddim_timesteps
    from diffusionremotesensing_tpu_torch.schedules import make_schedule

    assert np.array_equal(sampling.alpha_hat("cosine", 1500),
                          make_schedule("cosine", 1500).alpha_hat.numpy())
    assert np.array_equal(sampling.ddim_timesteps(1500, 100), ddim_timesteps(1500, 100))


def test_blend_grid():
    from diffusionremotesensing_tpu_torch.aggregation import gaussian_weights, patchify_coords

    boxes = patchify_coords(256, 256, 64, 32, 2)
    assert [(y0 // 2, x0 // 2) for y0, _, x0, _ in boxes] == blend.windows(256, 64, 32)
    assert np.allclose(blend.gaussian(128), gaussian_weights(128, 128), rtol=1e-6)


def test_downblur():
    from diffusionremotesensing_tpu_torch.data.device_degradation import make_downblur_transform

    hr = torch.randint(0, 256, (2, 32, 32, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(4))
    got = make_downblur_transform(32, 2, 1.2210930724462443)({"hr_u8": hr})
    x, lr = downblur.downblur(hr, 2, 1.2210930724462443)
    assert torch.allclose(got["x"], x, atol=1e-6)
    assert float((got["cond"] - lr).abs().max()) <= 1.0 / 255 + 1e-6
