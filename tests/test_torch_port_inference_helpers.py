"""The port's inference helpers (``diffusionremotesensing_tpu_torch/
superres_and_NDVIgen.py`` and ``imgs_generator.py``) against the reference
package's (the repo-root ``superres_and_NDVIgen.py`` and
``generate_new_imgs/imgs_generator.py``), on the CPU, as
tests/test_inference_helpers.py drives the reference's: init weights written
as a msgpack snapshot under ``models_run/<name>/weights`` of a temporary
working directory, the helpers' T=1500 cut to 5 by wrapping make_process,
the SAR model's 128 px cut to 16.

Both packages sample the same x_T and per-step noise: the reference draws
them from its key (x_T, or the warm start's eps, from the key's first
split; each step's noise along the chain of splits), which the test
replays with the reference's own functions and hands to the port's
samplers in place of torch.randn (tests/test_torch_port_tasks_sampling.py's
way). Float32, within 1e-4 of the largest |output|. The plots write PNGs
whose decoded pixels equal the reference's for the same arrays."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu import diffusion as jdiff
from diffusionremotesensing_tpu.models.unet import (
    residual_attention_unet_generation as jax_generation,
    residual_attention_unet_sar_to_ndvi as jax_sar,
    residual_attention_unet_superres as jax_superres,
)
from diffusionremotesensing_tpu_torch import cli
from diffusionremotesensing_tpu_torch import diffusion as tdiff
from diffusionremotesensing_tpu_torch import imgs_generator as port_gen
from diffusionremotesensing_tpu_torch import superres_and_NDVIgen as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# other test modules put the reference's own code first on sys.path, which
# shadows the repo-root superres_and_NDVIgen: load it from its file
_spec = importlib.util.spec_from_file_location("repo_superres_and_NDVIgen",
                                               os.path.join(REPO, "superres_and_NDVIgen.py"))
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

SR_NAME = "Residual_Attention_UNet_superres_magnification2_LRimgsize8_test"
T, HR = 5, 16
TOL = 1e-4


def _tiny_snapshot(root, model_name, model, image_size, under=("models_run",),
                   name="snapshot.msgpack"):
    """Init weights of the reference model written by the reference's writer
    under root/<under>/<model_name>/weights."""
    from diffusionremotesensing_tpu.io import save_snapshot
    from diffusionremotesensing_tpu.models.unet import init_unet_params

    v = init_unet_params(model, jax.random.PRNGKey(0), image_size=image_size)
    d = os.path.join(str(root), *under, model_name, "weights")
    os.makedirs(d, exist_ok=True)
    save_snapshot(os.path.join(d, name),
                  {"params": v["params"], "batch_stats": v.get("batch_stats", {})}, 0)


@pytest.fixture
def short_T(monkeypatch):
    """Both packages' helpers build their process with T = 5."""
    real_j, real_t = jdiff.make_process, tdiff.make_process
    monkeypatch.setattr(jdiff, "make_process",
                        lambda model, sched, _T, size, **kw: real_j(model, sched, T, size, **kw))
    short = lambda model, sched, _T, size, *a, **kw: real_t(model, sched, T, size, *a, **kw)  # noqa: E731
    monkeypatch.setattr(port, "make_process", short)
    monkeypatch.setattr(port_gen, "make_process", short)


class _Replay:
    """``torch`` as diffusion.py sees it, with ``randn`` handing out the
    reference's draws in order: x_T (or the warm start's eps), then each
    step's noise."""

    def __init__(self, draws):
        self.draws = [np.array(d, np.float32) for d in draws]

    def __getattr__(self, name):
        return getattr(torch, name)

    def randn(self, shape, generator=None, device=None, dtype=None):
        z = self.draws.pop(0)
        assert tuple(z.shape) == tuple(shape)
        return torch.from_numpy(z).to(device=device, dtype=dtype or torch.float32)


def _replay(monkeypatch, first, shape, steps=0, packed_first=False):
    """Hand the port the draws of the reference's ``sample`` under the key
    its helpers default to, PRNGKey(0): ``first`` the shape of x_T (or of
    the warm start, ``packed_first``), then ``steps`` steps' noise of
    ``shape``."""
    key, k_init = jax.random.split(jax.random.PRNGKey(0))
    draws = [jdiff._normal_packed(k_init, first, jnp.float32) if packed_first
             else jax.random.normal(k_init, first)]
    k = key
    for _ in range(steps):
        k, kn = jax.random.split(k)
        draws.append(jdiff._normal_packed(kn, shape, jnp.float32))
    monkeypatch.setattr(tdiff, "torch", _Replay(draws))


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * max(np.abs(want).max(), 1e-6)


def test_the_parsers_are_the_references():
    for name in (SR_NAME, "Residual_Attention_UNet_EMA_imgsize128_SAR_TO_NDVI",
                 "x_magnification4_LRimgsize64_imgsize256"):
        for fn in ("parse_magnification", "parse_lr_imgsize", "parse_imgsize"):
            try:
                want = getattr(ref, fn)(name)
            except IndexError:
                with pytest.raises(IndexError):
                    getattr(port, fn)(name)
                continue
            assert getattr(port, fn)(name) == want
    assert port.parse_magnification is cli.parse_magnification


@pytest.fixture
def sr_dir(tmp_path, monkeypatch):
    _tiny_snapshot(tmp_path, SR_NAME, jax_superres(magnification_factor=2), HR)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_super_resolver_ddim_matches_the_reference(sr_dir, short_T, monkeypatch):
    lr = np.random.default_rng(1).random((8, 8, 3)).astype(np.float32)
    want = ref.super_resolver(lr, model_name=SR_NAME, ddim_steps=3)
    _replay(monkeypatch, (1, HR, HR, 3), (1, HR, HR, 3))
    torch.backends.cudnn.allow_tf32 = True
    got = port.super_resolver(lr, device="cpu", model_name=SR_NAME, ddim_steps=3)
    assert torch.backends.cudnn.allow_tf32 is False  # a float32 model: IEEE float32
    assert got.shape == (HR, HR, 3) and got.min() >= 0.0 and got.max() <= 1.0
    _close(got, want)


def test_super_resolver_start_t_matches_the_reference(sr_dir, short_T, monkeypatch):
    """The ancestral chain from the bicubic warm start at t = 3: the
    bicubic upsample, the warm start's eps and two steps' noise."""
    lr = np.random.default_rng(2).random((8, 8, 3)).astype(np.float32)
    want = ref.super_resolver(lr, model_name=SR_NAME, start_t=3)
    _replay(monkeypatch, (1, HR, HR, 3), (1, HR, HR, 3), steps=2, packed_first=True)
    got = port.super_resolver(lr, device="cpu", model_name=SR_NAME, start_t=3)
    _close(got, want)


def test_sar_to_ndvi_generator_matches_the_reference(tmp_path, short_T, monkeypatch):
    """CHW input in [-1, 1) with negatives (rescaled to [0, 1]), two
    generations on the ancestral chain; out of range raises in both."""
    _tiny_snapshot(tmp_path, port.SAR_MODEL_NAME, jax_sar(), HR)
    monkeypatch.chdir(tmp_path)
    for mod in (ref, port):
        monkeypatch.setattr(mod, "parse_imgsize", lambda _name: HR)
    sar = np.random.default_rng(0).uniform(-0.9, 0.9, (2, HR, HR)).astype(np.float32)
    np.save(tmp_path / "sar.npy", sar)
    want = np.asarray(ref.SAR_to_NDVI_generator(str(tmp_path / "sar.npy"), n_generations=2))
    _replay(monkeypatch, (2, HR, HR, 1), (2, HR, HR, 1), steps=T - 2)
    got = port.SAR_to_NDVI_generator(str(tmp_path / "sar.npy"), device="cpu", n_generations=2)
    assert got.shape == (2, HR, HR, 1)
    _close(got, want)

    np.save(tmp_path / "bad.npy", sar * 2)
    for call in (lambda: ref.SAR_to_NDVI_generator(str(tmp_path / "bad.npy")),
                 lambda: port.SAR_to_NDVI_generator(str(tmp_path / "bad.npy"), device="cpu")):
        with pytest.raises(ValueError, match=r"not in the range \[-1, 1\]"):
            call()


def test_sar_to_ndvi_generator_reads_a_torch_tensor(tmp_path, short_T, monkeypatch):
    """A HWC tensor file already in [0, 1] (no rescale) through torch.load,
    DDIM: the same as the reference."""
    _tiny_snapshot(tmp_path, port.SAR_MODEL_NAME, jax_sar(), HR)
    monkeypatch.chdir(tmp_path)
    for mod in (ref, port):
        monkeypatch.setattr(mod, "parse_imgsize", lambda _name: HR)
    sar = torch.from_numpy(np.random.default_rng(6).random((HR, HR, 2)).astype(np.float32))
    torch.save(sar, tmp_path / "sar.pt")
    want = np.asarray(ref.SAR_to_NDVI_generator(str(tmp_path / "sar.pt"), ddim_steps=2))
    _replay(monkeypatch, (1, HR, HR, 1), (1, HR, HR, 1))
    got = port.SAR_to_NDVI_generator(str(tmp_path / "sar.pt"), device="cpu", ddim_steps=2)
    _close(got, want)


def test_imgs_generator_main_matches_the_reference(tmp_path, short_T, monkeypatch):
    """main from a subdirectory: the snapshot at ../models_run, ten classes
    at 64 px, CFG 3 (DDIM-2 here), the grid saved; the ten images as the
    reference's."""
    spec = importlib.util.spec_from_file_location(
        "repo_imgs_generator", os.path.join(REPO, "generate_new_imgs", "imgs_generator.py"))
    ref_gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_gen)
    _tiny_snapshot(tmp_path, port_gen.MODEL_NAME, jax_generation(num_classes=10), 64,
                   name="snapshot.pt")
    os.makedirs(tmp_path / "run")
    monkeypatch.chdir(tmp_path / "run")
    seen = {}
    real_sample = jdiff.DiffusionProcess.sample

    def record(self, *a, **kw):
        seen["ref"] = np.clip(np.asarray(real_sample(self, *a, **kw)), 0, 1)
        return seen["ref"]

    monkeypatch.setattr(jdiff.DiffusionProcess, "sample", record)
    ref_gen.main(ddim_steps=2)
    grid = tmp_path / "models_run" / port_gen.MODEL_NAME / "results" / "generated_imgs.png"
    assert grid.exists()
    grid.unlink()

    real_generate = port_gen._generate
    monkeypatch.setattr(port_gen, "_generate",
                        lambda *a: seen.setdefault("port", real_generate(*a)))
    _replay(monkeypatch, (10, 64, 64, 3), (10, 64, 64, 3))
    port_gen.main(ddim_steps=2, device="cpu")
    assert grid.exists()
    assert seen["port"].shape == (10, 64, 64, 3)
    _close(seen["port"], seen["ref"])


def _pixels(path):
    import matplotlib.image

    return matplotlib.image.imread(str(path))


@pytest.mark.parametrize("histogram", [True, False])
def test_plot_lr_sr_draws_the_references_pixels(tmp_path, histogram):
    rng = np.random.default_rng(7)
    lr, sr = rng.random((8, 8, 3)), rng.random((16, 16, 3)) * 1.2 - 0.1
    ref.plot_lr_sr(lr, sr, histogram=histogram, save_path=str(tmp_path / "ref.png"))
    port.plot_lr_sr(lr, sr, histogram=histogram, save_path=str(tmp_path / "port.png"))
    a, b = _pixels(tmp_path / "ref.png"), _pixels(tmp_path / "port.png")
    assert a.shape == b.shape and np.array_equal(a, b)


def test_plot_sar_ndvi_draws_the_references_pixels(tmp_path):
    rng = np.random.default_rng(8)
    sar, ndvi, preds = rng.random((16, 16, 2)), rng.random((16, 16, 1)), rng.random((2, 16, 16, 1))
    ref.plot_SAR_NDVI(sar, ndvi, preds, save_path=str(tmp_path / "ref.png"))
    port.plot_SAR_NDVI(sar, ndvi, preds, save_path=str(tmp_path / "port.png"))
    a, b = _pixels(tmp_path / "ref.png"), _pixels(tmp_path / "port.png")
    assert a.shape == b.shape and np.array_equal(a, b)


def test_the_card_is_asked_for_by_default(sr_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for call in (lambda: port.super_resolver(np.zeros((8, 8, 3), np.float32), model_name=SR_NAME),
                 lambda: port.SAR_to_NDVI_generator("sar.npy"),
                 lambda: port_gen.main()):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
