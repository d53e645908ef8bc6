"""Shared inputs for the tests of the PyTorch port (tests/test_torch_port_*.py):
random variables in the reference package's tree layout, drawn with numpy
(jax.eval_shape gives the tree without compiling flax's init), and the
port's model loaded with the same weights through convert.from_jax_variables."""

import jax
import numpy as np

from diffusionremotesensing_tpu.models.unet import (
    init_unet_params,
    residual_attention_unet_superres as jax_superres,
)
from diffusionremotesensing_tpu_torch.convert import from_jax_variables
from diffusionremotesensing_tpu_torch.models.unet import (
    residual_attention_unet_superres as torch_superres,
)


def random_jax_variables(seed: int = 0, image_size: int = 32) -> dict:
    """{'params', 'batch_stats'} of float32 numpy arrays for the x2 model:
    kernels U(+-1/sqrt(fan_in)), biases U(+-0.1), BatchNorm scale/var near 1."""
    model = jax_superres(magnification_factor=2)
    shapes = jax.eval_shape(
        lambda: init_unet_params(model, jax.random.PRNGKey(0), image_size=image_size))
    rng = np.random.default_rng(seed)
    ranges = {"bias": (-0.1, 0.1), "scale": (0.8, 1.2), "mean": (-0.1, 0.1), "var": (0.5, 1.5)}

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            b = 1.0 / np.sqrt(np.prod(leaf.shape[:-1]))
            lo, hi = -b, b
        else:
            lo, hi = ranges[name]
        return rng.uniform(lo, hi, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def port_model(variables: dict, **kwargs):
    """The port's x2 model in eval mode with ``variables`` loaded (strict)."""
    m = torch_superres(magnification_factor=2, **kwargs)
    m.load_state_dict(from_jax_variables(variables["params"], variables["batch_stats"]),
                      strict=True)
    return m.eval()


def model_inputs(seed: int = 0, batch: int = 2, hr: int = 32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, hr, hr, 3)).astype(np.float32)
    t = rng.integers(1, 1500, (batch,)).astype(np.int32)
    cond = rng.random((batch, hr // 2, hr // 2, 3)).astype(np.float32)
    return x, t, cond
