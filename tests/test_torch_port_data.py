"""The port's data modules (diffusionremotesensing_tpu_torch/data/
degradations.py, datasets.py, cifar10.py) against the reference package's:
every degradation entry point bit-equal on three seeds; each dataset's
items on the same files and seed with the same keys and dtypes, exact where
both decode the same way and within 1/255 where the port's numpy bilinear
resize stands in for PIL's (it reads exact here); CIFAR-10 from a pickled
fixture. Where PIL or cv2 is missing the steps that need them raise an
ImportError that names them; importing the modules loads neither."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image, ImageFilter

from diffusionremotesensing_tpu.data import cifar10 as jcifar
from diffusionremotesensing_tpu.data import datasets as jds
from diffusionremotesensing_tpu.data import degradations as jdeg
from diffusionremotesensing_tpu_torch.data import cifar10 as tcifar
from diffusionremotesensing_tpu_torch.data import datasets as tds
from diffusionremotesensing_tpu_torch.data import degradations as tdeg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = [0, 1, 2]


def _img(h, w, seed):
    """A float image in [0, 1] with edges and smooth regions."""
    rng = np.random.default_rng(seed)
    a = np.kron(rng.random((h // 8, w // 8, 3)), np.ones((8, 8, 1)))
    a[h // 4: h // 2, w // 3: w // 2] = rng.random(3)
    return np.clip(a + 0.05 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)


def _equal(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# each entry point, called as (module, rng) -> result; rng-free ones take
# the seed's image only
ENTRY_POINTS = {
    "matlab_imresize": lambda m, s: m.matlab_imresize(_img(48, 40, s), [0.5, 0.25, 1.5][s]),
    "uint2single_single2uint": lambda m, s: m.uint2single(m.single2uint(_img(16, 16, s) * 1.1)),
    "gaussian_kernel": lambda m, s: m._gaussian_kernel(7 + 2 * s, 0.8 + s),
    "anisotropic_kernel": lambda m, s: m._anisotropic_gaussian_kernel(9 + 2 * s, 0.3 * s, 2.0, 5.0),
    "shift_kernel": lambda m, s: m._shift_kernel(m._gaussian_kernel(15, 2.0), 2 + s, s == 1),
    "blur": lambda m, s: m._blur(m._Rng(s), _img(32, 32, s), 2),
    "random_resize": lambda m, s: m._random_resize(m._Rng(s), _img(32, 40, s), 4),
    "gaussian_noise": lambda m, s: m._gaussian_noise(m._Rng(s), _img(32, 32, s)),
    "speckle_noise": lambda m, s: m._speckle_noise(m._Rng(s), _img(32, 32, s)),
    "poisson_noise": lambda m, s: m._poisson_noise(m._Rng(s), _img(32, 32, s)),
    "jpeg_noise": lambda m, s: m._jpeg_noise(m._Rng(s), _img(32, 32, s)),
    "add_sharpening": lambda m, s: m.add_sharpening(_img(64, 64, s), radius=10 + s),
    "paired_random_crop": lambda m, s: m._paired_random_crop(m._Rng(s), _img(32, 32, s),
                                                             _img(64, 64, s), 2, 16),
    "degradation_bsrgan": lambda m, s: m.degradation_bsrgan(_img(96, 96, s), sf=[2, 4, 4][s],
                                                            lq_patchsize=16, rng=s),
    "degradation_bsrgan_plus": lambda m, s: m.degradation_bsrgan_plus(
        _img(96, 96, s), sf=[2, 4, 2][s], lq_patchsize=16, rng=s, use_sharp=s != 1),
    "soft_degradation_bsrgan": lambda m, s: m.soft_degradation_bsrgan(_img(96, 96, s), sf=2,
                                                                      lq_patchsize=16, rng=s),
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_degradations_are_bit_equal_to_the_references(name, seed):
    _equal(ENTRY_POINTS[name](tdeg, seed), ENTRY_POINTS[name](jdeg, seed))


@pytest.mark.parametrize("seed", SEEDS)
def test_rng_streams_and_imread_equal_the_references(seed, tmp_path):
    a, b = tdeg._Rng(seed), jdeg._Rng(seed)
    for draw in ("random", "np_rand"):
        assert getattr(a, draw)() == getattr(b, draw)()
    assert a.sample(range(13), 13) == b.sample(range(13), 13)
    _equal(a.np_normal(0, 1, (3,)), b.np_normal(0, 1, (3,)))
    img = (np.random.default_rng(seed).random((12, 10, 3)) * 255).astype(np.uint8)
    path = str(tmp_path / "x.png")
    Image.fromarray(img if seed else img[..., 0]).save(path)
    for ch in (1, 3):
        _equal(tdeg.imread_uint(path, ch), jdeg.imread_uint(path, ch))


def test_cv2_steps_refuse_without_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    x = _img(96, 96, 0)
    with pytest.raises(ImportError, match="degradation_bsrgan_plus|add_sharpening|_random_resize"):
        tdeg.degradation_bsrgan_plus(x, sf=2, lq_patchsize=16, rng=0)
    with pytest.raises(ImportError, match="imread_uint.*OpenCV.*DecodeOnlyDataset"):
        tdeg.imread_uint("any.png")
    # the numpy steps need no cv2
    _equal(tdeg.matlab_imresize(x, 0.5), jdeg.matlab_imresize(x, 0.5))
    _equal(tdeg._gaussian_noise(tdeg._Rng(1), x), jdeg._gaussian_noise(jdeg._Rng(1), x))


# ------------------------------------------------------------------ datasets


def _save_png(path, arr, **kw):
    Image.fromarray(arr).save(path, **kw)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """Images in each mode PIL writes and a JPEG: RGB at 64 (no resize) and
    at 50 x 70, grey, grey + alpha, RGBA, palette, 16-bit grey, 1-bit."""
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    rgb = (rng.random((64, 64, 3)) * 255).astype(np.uint8)
    _save_png(d / "a_rgb64.png", rgb)
    _save_png(d / "b_rgb.png", (rng.random((50, 70, 3)) * 255).astype(np.uint8))
    _save_png(d / "c_l.png", (rng.random((40, 48)) * 255).astype(np.uint8))
    _save_png(d / "d_la.png", (rng.random((64, 64, 2)) * 255).astype(np.uint8))
    _save_png(d / "e_rgba.png", (rng.random((72, 60, 4)) * 255).astype(np.uint8))
    p = Image.fromarray(rng.integers(0, 12, (64, 64)).astype(np.uint8), "P")
    p.putpalette(list(rng.integers(0, 256, 36)))
    p.save(d / "f_p.png")
    Image.fromarray((rng.random((30, 30)) * 65535).astype(np.uint16)).save(d / "g_i16.png")
    Image.fromarray(rng.random((64, 64)) > 0.5).save(d / "h_1bit.png")
    Image.fromarray(rgb).save(d / "i_rgb.jpg", quality=90)
    return str(d)


def _items_equal(got, want, atol=0.0):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("size", [64, 40])
def test_decode_only_dataset_matches_the_reference(image_dir, size):
    t, j = tds.DecodeOnlyDataset(image_dir, size), jds.DecodeOnlyDataset(image_dir, size)
    assert len(t) == len(j) == 9
    for i in range(len(j)):
        _items_equal(t[i], j[i], atol=1)  # uint8: the bilinear within 1/255


@pytest.mark.parametrize("kw", [dict(), dict(gauss_noise=True, blur_radius="random", seed=3),
                                dict(image_size=64, cache_mb=10.0)])
def test_superres_downblur_dataset_matches_the_reference(image_dir, kw):
    t = tds.SuperresDownBlurDataset(image_dir, 2, **kw)
    j = jds.SuperresDownBlurDataset(image_dir, 2, **kw)
    assert t.blur_radius == j.blur_radius
    for _ in range(2 if kw.get("cache_mb") else 1):  # the second pass from the cache
        for i in range(len(j)):
            _items_equal(t[i], j[i], atol=1 / 255 + 1e-7)


def test_the_resize_reads_exact_against_pil(image_dir):
    for i in range(9):
        g = tds.DecodeOnlyDataset(image_dir, 48)[i]["hr_u8"]
        np.testing.assert_array_equal(g, jds.DecodeOnlyDataset(image_dir, 48)[i]["hr_u8"])


def test_numpy_and_torch_formats_match_the_reference(tmp_path):
    rng = np.random.default_rng(1)
    for sub in ("npy", "pt"):
        (tmp_path / sub).mkdir()
    for n, shape in enumerate([(40, 40, 3), (32, 32), (48, 40, 4), (36, 36, 2)]):
        np.save(tmp_path / "npy" / f"{n}.npy", rng.random(shape).astype(np.float32))
    for n, shape in enumerate([(3, 40, 40), (1, 32, 32)]):
        torch.save(torch.from_numpy(rng.random(shape).astype(np.float32)), tmp_path / "pt" / f"{n}.pt")
    for sub, fmt in (("npy", "numpy"), ("pt", "torch")):
        t = tds.DecodeOnlyDataset(str(tmp_path / sub), 32, data_format=fmt)
        j = jds.DecodeOnlyDataset(str(tmp_path / sub), 32, data_format=fmt)
        for i in range(len(j)):
            _items_equal(t[i], j[i])
    with pytest.raises(TypeError):
        tds._fromarray_rgb_or_l(np.zeros((8, 8, 1), np.uint8))


def test_sar_to_ndvi_dataset_matches_the_reference(tmp_path):
    rng = np.random.default_rng(2)
    for sub in ("sar", "opt"):
        (tmp_path / sub).mkdir()
    for n in range(2):
        torch.save(torch.from_numpy(rng.random((2, 16, 16)).astype(np.float32) * 2 - 1),
                   tmp_path / "sar" / f"{n}.pt")
        torch.save(torch.from_numpy(rng.random((16, 16)).astype(np.float32) * 2 - 1),
                   tmp_path / "opt" / f"{n}.pt")
    np.save(tmp_path / "sar" / "2.npy", rng.random((2, 16, 16)).astype(np.float32))
    np.save(tmp_path / "opt" / "2.npy", rng.random((16, 16)).astype(np.float32))
    _save_png(tmp_path / "sar" / "3.png", (rng.random((16, 16, 2)) * 255).astype(np.uint8))
    _save_png(tmp_path / "opt" / "3.png", (rng.random((16, 16)) * 255).astype(np.uint8))
    t, j = tds.SarToNdviDataset(str(tmp_path)), jds.SarToNdviDataset(str(tmp_path))
    assert len(t) == 4
    for i in range(4):
        _items_equal(t[i], j[i])


def test_image_folder_dataset_matches_the_reference(image_dir, tmp_path):
    for c, names in (("cat", ["a_rgb64.png", "c_l.png", "i_rgb.jpg"]),
                     ("dog", ["e_rgba.png", "f_p.png"])):
        (tmp_path / c).mkdir()
        for n in names:
            os.symlink(os.path.join(image_dir, n), tmp_path / c / n)
    (tmp_path / "dog" / "notes.txt").write_text("not an image")
    for size in (None, 24):
        t, j = tds.ImageFolderDataset(str(tmp_path), size), jds.ImageFolderDataset(str(tmp_path), size)
        assert t.classes == j.classes and t.num_classes == 2 and len(t) == len(j) == 5
        for i in range(len(j)):
            _items_equal(t[i], j[i], atol=1 / 255 + 1e-7)


def test_bsrgan_dataset_matches_the_reference(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for n in range(2):
        _save_png(src / f"{n}.png", (_img(96, 96, n) * 255).astype(np.uint8))
    kw = dict(magnification_factor=2, model_input_size=16, num_crops=2, seed=4)
    t = tds.SuperresBSRGANDataset(str(src), destination_folder=str(tmp_path / "t"), **kw)
    j = jds.SuperresBSRGANDataset(str(src), destination_folder=str(tmp_path / "j"), **kw)
    assert len(t) == len(j) == 4
    for i in range(4):
        _items_equal(t[i], j[i])
    for sub in ("lr/x_0.png", "hr/y_3.png"):
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t" / sub)),
                                      np.asarray(Image.open(tmp_path / "j" / sub)))


def test_pil_steps_refuse_without_pil(image_dir, monkeypatch):
    """Without PIL, PNG files still decode, resize and degrade (to the
    reference's items); a JPEG is refused with a named ImportError."""
    want = [jds.SuperresDownBlurDataset(image_dir, 2, image_size=48)[i] for i in range(8)]
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    d = tds.DecodeOnlyDataset(image_dir, 64)
    assert d[0]["hr_u8"].shape == (64, 64, 3)
    with pytest.raises(ImportError, match="i_rgb.jpg.*Pillow.*PNG files"):
        d[8]
    t = tds.SuperresDownBlurDataset(image_dir, 2, image_size=48)
    for i in range(8):
        _items_equal(t[i], want[i])
    with pytest.raises(ImportError, match="i_rgb.jpg"):
        t[8]


@pytest.mark.parametrize("radius", [0.5, 0.3, 0.77, 1.0, 1.2345, 1.5, 2.0, 3.7])
@pytest.mark.parametrize("shape", [(64, 64, 3), (37, 51, 3), (40, 33), (5, 7, 3)])
def test_gaussian_blur_is_pillows(radius, shape):
    a = (np.random.default_rng(int(radius * 100)).random(shape) * 255).astype(np.uint8)
    want = np.asarray(Image.fromarray(a).filter(ImageFilter.GaussianBlur(radius)))
    np.testing.assert_array_equal(tds.pil_gaussian_blur_u8(a, radius), want)


@pytest.mark.parametrize("mag", [2, 4])
def test_downblur_is_learning_checks_pil_degradation(mag):
    """pil_downblur_u8 is learning_check._degrade_lr (PIL's bicubic and
    GaussianBlur) bit for bit on the eval tiles."""
    from benchmarks import learning_check as lc

    erng = np.random.default_rng(10_000)
    for _ in range(4):
        hr = lc._draw_image(erng, lc.TILE_HR)
        got = tds.pil_downblur_u8(hr, mag, lc.BLUR_RADIUS).astype(np.float32) / 255.0
        np.testing.assert_array_equal(got, lc._degrade_lr(hr, mag))


# ------------------------------------------------------------------- cifar


@pytest.fixture(scope="module")
def cifar_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cifar") / "cifar-10-batches-py"
    d.mkdir()
    rng = np.random.default_rng(3)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        batch = {b"data": rng.integers(0, 256, (3, 3072)).astype(np.uint8),
                 b"labels": [int(v) for v in rng.integers(0, 10, 3)]}
        with open(d / name, "wb") as f:
            pickle.dump(batch, f)
    return str(d.parent)


@pytest.mark.parametrize("train,image_size", [(True, None), (False, 32), (True, 48), (False, 20)])
def test_cifar10_matches_the_reference(cifar_dir, train, image_size):
    t = tcifar.Cifar10Dataset(cifar_dir, train, image_size)
    j = jcifar.Cifar10Dataset(cifar_dir, train, image_size)
    assert len(t) == len(j) == (15 if train else 3) and t.classes == j.classes
    for i in range(len(j)):
        _items_equal(t[i], j[i], atol=1 / 255 + 1e-7)
        assert t[i]["cond"].dtype == np.int32
    with pytest.raises(FileNotFoundError):
        tcifar.Cifar10Dataset(os.path.join(cifar_dir, "missing"))


def test_importing_the_data_modules_loads_no_jax_pil_or_cv2():
    mods = ["png", "utils", "data.datasets", "data.degradations", "data.cifar10", "serving"]
    code = ("import sys\n" + "".join(f"import diffusionremotesensing_tpu_torch.{m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'PIL', 'cv2'))\n"
            + "print(bad); sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
