"""The port's schedules, s2d layout and kernel transforms, bicubic resize
and im2col order against the reference package's, on the same numpy
inputs. Transforms are pure data movement and sums of a few float32
terms: compared exactly or at 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu import schedules as jsched
from diffusionremotesensing_tpu.ops import resize as jresize
from diffusionremotesensing_tpu.ops import s2d as js2d
from diffusionremotesensing_tpu.ops import tap_conv as jtap
from diffusionremotesensing_tpu_torch import schedules as tsched
from diffusionremotesensing_tpu_torch.ops import resize as tresize
from diffusionremotesensing_tpu_torch.ops import s2d as ts2d
from diffusionremotesensing_tpu_torch.ops import tap_conv as ttap


@pytest.mark.parametrize("kind,steps", [("cosine", 1500), ("cosine", 20), ("linear", 1000),
                                        ("linear", 7)])
def test_schedule_tables_equal_reference(kind, steps):
    j = jsched.make_schedule(kind, steps)
    t = tsched.make_schedule(kind, steps)
    for name in ("beta", "alpha", "alpha_hat"):
        got, want = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert t.noise_steps == steps


def test_unknown_schedule_raises():
    with pytest.raises(ValueError):
        tsched.make_schedule("sigmoid", 10)


def test_space_to_depth_roundtrip_matches_reference():
    x = np.random.default_rng(0).standard_normal((2, 8, 6, 5)).astype(np.float32)
    got = ts2d.space_to_depth(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(js2d.space_to_depth(jnp.asarray(x))))
    back = ts2d.depth_to_space(torch.from_numpy(got)).numpy()
    np.testing.assert_array_equal(back, x)


@pytest.mark.parametrize("name,shape", [
    ("k3_to_s2d", (3, 3, 4, 6)),
    ("k3_to_s2d44", (3, 3, 4, 6)),
    ("k1_to_blockdiag", (1, 1, 4, 6)),
    ("k3s2_to_s2d", (3, 3, 4, 6)),
    ("k2s2_to_1x1", (2, 2, 4, 6)),
    ("kT_to_s2d", (3, 3, 4, 6)),
    ("kdown_to_s2d_out", (2, 2, 16, 6)),
])
def test_kernel_transform_matches_reference(name, shape):
    w = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    got = getattr(ts2d, name)(torch.from_numpy(w)).numpy()
    want = np.asarray(getattr(js2d, name)(jnp.asarray(w)))
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("padding,strides,kshape", [
    ("SAME", (1, 1), (3, 3, 8, 12)),
    ("VALID", (1, 1), (1, 1, 8, 12)),
    (((1, 0), (1, 0)), (1, 1), (2, 2, 8, 12)),
    (((1, 2), (1, 2)), (1, 1), (4, 4, 8, 12)),
    (((1, 0), (1, 0)), (2, 2), (3, 3, 8, 12)),
])
def test_conv_s2d_matches_reference(padding, strides, kshape):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, 8)).astype(np.float32)
    w = rng.standard_normal(kshape).astype(np.float32)
    got = ts2d.conv_s2d(torch.from_numpy(x), torch.from_numpy(w), padding, strides=strides)
    want = js2d.conv_s2d(jnp.asarray(x), jnp.asarray(w), padding, strides=strides)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("in_size,scale", [(16, 2), (7, 4), (32, 2)])
def test_bicubic_upsample_matches_reference(in_size, scale):
    x = np.random.default_rng(3).random((2, in_size, in_size, 3)).astype(np.float32)
    got = tresize.upsample_bicubic(torch.from_numpy(x), scale).numpy()
    want = np.asarray(jresize.upsample_bicubic(jnp.asarray(x), scale))
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(tresize.bicubic_resize_weights(in_size, in_size * scale),
                                  jresize.bicubic_resize_weights(in_size, in_size * scale))


def test_bicubic_matches_torch_interpolate():
    """The matrix form is torch's own bicubic (A = -0.75, half-pixel)."""
    x = torch.rand(1, 9, 11, 3)
    got = tresize.upsample_bicubic(x, 2)
    want = torch.nn.functional.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="bicubic",
                                           align_corners=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_im2col_order_matches_reference():
    assert ttap._ORDER == jtap._ORDER
    assert ttap._RS == jtap._RS
    w44 = np.random.default_rng(4).standard_normal((4, 4, 3, 8)).astype(np.float32)
    np.testing.assert_array_equal(ttap._w2d(torch.from_numpy(w44)).numpy(),
                                  np.asarray(jtap._w2d(jnp.asarray(w44))))


def test_im2col_matches_reference_tile_im2col():
    x = np.random.default_rng(5).standard_normal((2, 6, 5, 16)).astype(np.float32)
    got = ttap.im2col_s2d44(torch.from_numpy(x)).numpy()
    for b in range(2):
        want = np.asarray(jtap._im2col_s2d44(jnp.asarray(x[b])))
        np.testing.assert_array_equal(got[b], want)


def test_im2col_contracts_to_the_3x3_conv():
    """im2col4x4(x) @ w2d(k3_to_s2d44(w)) is the SAME 3x3 conv in s2d layout."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    w = rng.standard_normal((3, 3, 4, 5)).astype(np.float32)
    xs = ts2d.space_to_depth(torch.from_numpy(x))
    got = ttap.im2col_s2d44(xs) @ ttap._w2d(ts2d.k3_to_s2d44(torch.from_numpy(w)))
    want = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (1, 1), "SAME",
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    np.testing.assert_allclose(got.numpy(), np.asarray(js2d.space_to_depth(want)), atol=1e-5)
