"""The port's on-device DownBlur (data/device_degradation.py) against the
reference package's: the same resampling and band matrices (exactly), the
same transform output on the same uint8 batch (exactly: both round Pillow's
fixed-point weights the same way in float32), and, as the reference's own
test holds it (tests/test_device_degradation.py), x equal to
SuperresDownBlurDataset's (PIL) within 1e-6 and cond within 2/255, at x2
and x4."""

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from diffusionremotesensing_tpu.data import device_degradation as jdd
from diffusionremotesensing_tpu_torch.data import device_degradation as tdd


@pytest.mark.parametrize("name", ["bilinear", "bicubic"])
@pytest.mark.parametrize("sizes", [(57, 28), (40, 80), (64, 32), (256, 128)])
def test_resize_weights_equal_the_references(name, sizes):
    np.testing.assert_array_equal(tdd.pil_resize_weights(*sizes, name),
                                  jdd.pil_resize_weights(*sizes, name))


@pytest.mark.parametrize("sigma", [0.5, 0.7, 1.5, 2.7])
def test_blur_matrices_equal_the_references(sigma):
    np.testing.assert_array_equal(tdd.blur_band_matrix(40, sigma), jdd.blur_band_matrix(40, sigma))
    np.testing.assert_array_equal(tdd.pil_gaussian_kernel(sigma), jdd.pil_gaussian_kernel(sigma))


@pytest.mark.parametrize("source,mag,blur,size", [(48, 2, 0.5, 32), (32, 2, 0.7, None),
                                                  (64, 4, 1.5, 64), (96, 2, 0.5, None)])
def test_transform_equals_the_references(source, mag, blur, size):
    u8 = (np.random.default_rng(source).random((3, source, source, 3)) * 255).astype(np.uint8)
    mask = np.array([1.0, 1.0, 0.0], np.float32)
    want = jax.tree_util.tree_map(
        np.asarray, jdd.make_downblur_transform(source, mag, blur, size)({"hr_u8": u8,
                                                                          "pad_mask": mask}))
    got = tdd.make_downblur_transform(source, mag, blur, size)(
        {"hr_u8": torch.from_numpy(u8), "pad_mask": torch.from_numpy(mask)})
    assert set(got) == set(want) == {"x", "cond", "pad_mask"}
    hr = size or source
    assert got["x"].shape == (3, hr, hr, 3) and got["cond"].shape == (3, hr // mag, hr // mag, 3)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


@pytest.mark.parametrize("mag", [2, 4])
def test_transform_matches_the_pil_dataset(tmp_path, mag):
    from diffusionremotesensing_tpu.data.datasets import DecodeOnlyDataset, SuperresDownBlurDataset

    d = tmp_path / "imgs"
    d.mkdir()
    rng = np.random.default_rng(7)
    for i in range(4):
        Image.fromarray((rng.random((48, 48, 3)) * 255).astype(np.uint8)).save(d / f"{i}.png")
    host = SuperresDownBlurDataset(str(d), magnification_factor=mag, blur_radius=0.7, image_size=32)
    dec = DecodeOnlyDataset(str(d), image_size=32)
    batch = {"hr_u8": torch.from_numpy(np.stack([dec[i]["hr_u8"] for i in range(4)]))}
    out = tdd.make_downblur_transform(32, mag, 0.7)(batch)
    for i in range(4):
        ref = host[i]
        np.testing.assert_allclose(out["x"][i].numpy(), ref["x"], atol=1e-6)
        assert (np.abs(out["cond"][i].numpy() - ref["cond"]) * 255.0).max() <= 2.0 + 1e-4
