"""The port's losses (losses.py) against the reference package's: MSE, MAE
and Huber with and without pad_mask weights (rtol 1e-6), make_loss_fn's
selection, VGG19Features at torchvision's indices, and the perceptual and
combined losses with the same random VGG19 weights (the reference's flax
init carried over to torch's layout) on the same images, through the
resize to 224 and past it (width 224: the reference's width-only quirk),
rtol 1e-4 (float32 sums over 16 convolutions at 224 x 224)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu import losses as jl
from diffusionremotesensing_tpu_torch import losses as tl

_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34]


def _pair(shape=(3, 8, 8, 3), seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("name", ["mse", "mae", "huber"])
@pytest.mark.parametrize("weighted", [False, True])
def test_pointwise_losses_match_reference(name, weighted):
    a, b = _pair(seed=1)
    a *= 2.0  # errors on both sides of Huber's delta
    w = np.array([1.0, 0.0, 1.0], np.float32) if weighted else None
    want = float(getattr(jl, name)(jnp.asarray(a), jnp.asarray(b),
                                   weights=None if w is None else jnp.asarray(w)))
    got = float(getattr(tl, name)(torch.from_numpy(a), torch.from_numpy(b),
                                  weights=None if w is None else torch.from_numpy(w)))
    assert got == pytest.approx(want, rel=1e-6)


def test_make_loss_fn_selection():
    assert tl.make_loss_fn("MSE") is tl.mse
    assert tl.make_loss_fn("MAE") is tl.mae
    assert tl.make_loss_fn("Huber") is tl.huber
    with pytest.raises(ValueError):
        tl.make_loss_fn("L2")
    with pytest.raises(ValueError, match="VGG19"):
        tl.make_loss_fn("MSE+Perceptual_noise")


def test_vgg19_features_has_torchvisions_indices():
    vgg = tl.VGG19Features(seed=0)
    convs = [i for i, m in enumerate(vgg) if isinstance(m, torch.nn.Conv2d)]
    assert convs == _CONV_IDX and len(vgg) == 37
    assert isinstance(vgg[36], torch.nn.MaxPool2d)
    sd = vgg.state_dict()
    assert set(sd) == {f"{i}.{p}" for i in _CONV_IDX for p in ("weight", "bias")}
    # a whole vgg19() state_dict ('features.N.*' and a classifier) loads too
    full = {f"features.{k}": v for k, v in sd.items()}
    full["classifier.0.weight"] = torch.zeros(1)
    other = tl.VGG19Features(seed=1)
    assert not torch.equal(other[0].weight, vgg[0].weight)
    other.load_state_dict(tl.vgg19_features_state(full), strict=True)
    assert torch.equal(other[34].weight, vgg[34].weight)


@pytest.fixture(scope="module")
def vgg_pair():
    """The reference's random VGG19 (flax init, seed 0) and the port's with
    the same weights."""
    variables = jl.VGG19Features().init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    params = variables["params"]
    names = [f"conv{b + 1}_{c + 1}" for b, (_, n) in enumerate(jl._VGG19_PLAN) for c in range(n)]
    sd = {}
    for idx, name in zip(_CONV_IDX, names):
        sd[f"{idx}.weight"] = torch.from_numpy(
            np.transpose(np.asarray(params[name]["kernel"]), (3, 2, 0, 1)).copy())
        sd[f"{idx}.bias"] = torch.from_numpy(np.array(params[name]["bias"]))
    vgg = tl.VGG19Features()
    vgg.load_state_dict(sd, strict=True)
    return variables, vgg


@pytest.mark.parametrize("shape", [(2, 16, 16, 3), (1, 32, 224, 3)])
def test_perceptual_and_combined_losses_match_reference(vgg_pair, shape):
    variables, vgg = vgg_pair
    a, b = _pair(shape, seed=2)
    w = np.array([1.0, 0.5], np.float32)[: shape[0]]
    jfn = jl.make_loss_fn("MSE+Perceptual_noise", vgg_variables=variables)
    jp = jl.vgg_perceptual_loss_fn(variables)
    tfn = tl.make_loss_fn("MSE+Perceptual_noise", vgg)
    tp = tl.vgg_perceptual_loss_fn(vgg)
    ta, tb, tw = torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(w)
    with torch.no_grad():
        assert float(tp(ta, tb, tw)) == pytest.approx(float(jp(a, b, w)), rel=1e-4)
        assert float(tfn(ta, tb)) == pytest.approx(float(jfn(a, b)), rel=1e-4)
        assert float(tp(ta, ta)) == 0.0
