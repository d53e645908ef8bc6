"""BSRGAN-style blind-SR degradation pipelines (host-side numpy/cv2), port of
``diffusionremotesensing_tpu/data/degradations.py``: the same numpy/scipy
code and the same ``_Rng`` draws, so one seed gives the reference's result
bit for bit. OpenCV is imported only by the steps that call it (file reads,
``resize``, ``GaussianBlur``, colour conversion and the JPEG round trip);
where it is not installed those steps raise an ImportError that names
them. The pure numpy steps (``matlab_imresize``, the blur kernels, the
noises, the crops) need no cv2.

The recipe is BSRGAN's (cszn/BSRGAN, as IceClear/StableSR vendors it): the
same op inventory, parameter ranges, probabilities and pipeline structure,
with all randomness drawn from one ``random.Random``-compatible generator and
the MATLAB-parity bicubic as a weight-matrix resample. These run on the host,
as an eager preprocessing stage (data-dependent shapes, JPEG codecs).

Pipelines (reference parity):
* ``degradation_bsrgan``      — 7-op shuffled (blur x2, two downsamples with
  the final one ordered last, gaussian noise, probabilistic JPEG, ISP hook)
  + final JPEG + random crop.
* ``degradation_bsrgan_plus`` — 13-op (two blur/resize/noise rounds), optional
  global shuffle else local shuffles, optional USM pre-sharpening, resize to
  1/sf + final JPEG + crop. The BSRGAN dataset trains on this one.
* ``soft_degradation_bsrgan`` — 3-op (blur/resize/noise) + resize, no final
  JPEG.
"""

from __future__ import annotations

import functools
import random as _random
from typing import Optional, Tuple

import numpy as np
from scipy import ndimage
from scipy.linalg import orth

__all__ = [
    "cv2_or_raise",
    "matlab_imresize",
    "degradation_bsrgan",
    "degradation_bsrgan_plus",
    "soft_degradation_bsrgan",
    "add_sharpening",
    "imread_uint",
    "uint2single",
    "single2uint",
]

# ------------------------------------------------------------------ image io


def cv2_or_raise(what: str):
    """The ``cv2`` module for ``what``, or an ImportError naming ``what``."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"{what} needs OpenCV (cv2), which is not installed; the BSRGAN pipelines "
            "resize, blur and JPEG-compress through it. Without cv2, train from "
            "data.datasets.DecodeOnlyDataset with data.device_degradation's DownBlur") from e
    return cv2


def imread_uint(path: str, n_channels: int = 3) -> np.ndarray:
    """Read an image file as HWC uint8 RGB (or HW1 grayscale)."""
    cv2 = cv2_or_raise("imread_uint")
    if n_channels == 1:
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        return np.expand_dims(img, axis=2)
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img.ndim == 2:
        return cv2.cvtColor(img, cv2.COLOR_GRAY2RGB)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def uint2single(img: np.ndarray) -> np.ndarray:
    return np.float32(img / 255.0)


def single2uint(img: np.ndarray) -> np.ndarray:
    return np.uint8((img.clip(0, 1) * 255.0).round())


# --------------------------------------------------- MATLAB-parity bicubic


def _matlab_cubic(x: np.ndarray) -> np.ndarray:
    """MATLAB's bicubic kernel (Keys, A=-0.5)."""
    ax = np.abs(x)
    ax2, ax3 = ax**2, ax**3
    return (1.5 * ax3 - 2.5 * ax2 + 1.0) * (ax <= 1) + (
        -0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0
    ) * ((ax > 1) & (ax <= 2))


@functools.lru_cache(maxsize=256)
def _matlab_resize_weights(in_size: int, out_size: int, antialias: bool) -> np.ndarray:
    """(out,in) resampling matrix with MATLAB imresize semantics.

    MATLAB maps u = (dst+1)/scale + 0.5*(1 - 1/scale) (1-based), widens the
    kernel by 1/scale when antialiasing a downscale, normalizes the taps,
    and reflects out-of-range indices at the borders.
    """
    scale = out_size / in_size
    kernel_width = 4.0
    if scale < 1 and antialias:
        kernel_width /= scale
    dst = np.arange(1, out_size + 1, dtype=np.float64)
    u = dst / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    P = int(np.ceil(kernel_width)) + 2
    taps_idx = left[:, None] + np.arange(P)[None, :]  # 1-based positions
    dist = u[:, None] - taps_idx
    if scale < 1 and antialias:
        weights = scale * _matlab_cubic(dist * scale)
    else:
        weights = _matlab_cubic(dist)
    weights /= weights.sum(axis=1, keepdims=True)
    # reflect out-of-bounds indices (MATLAB 'symmetric' boundary)
    idx = taps_idx - 1  # 0-based
    idx = np.where(idx < 0, -idx - 1, idx)
    idx = np.where(idx > in_size - 1, 2 * in_size - 1 - idx, idx)
    idx = np.clip(idx, 0, in_size - 1).astype(np.int64)
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.repeat(np.arange(out_size), P)
    np.add.at(mat, (rows, idx.ravel()), weights.ravel())
    return mat.astype(np.float32)


def matlab_imresize(img: np.ndarray, scale: float, antialias: bool = True) -> np.ndarray:
    """MATLAB-parity bicubic resize of an HWC float image by ``scale``."""
    h, w = img.shape[:2]
    oh, ow = int(np.ceil(h * scale)), int(np.ceil(w * scale))
    wh = _matlab_resize_weights(h, oh, antialias)
    ww = _matlab_resize_weights(w, ow, antialias)
    out = np.einsum("Hh,hwc->Hwc", wh, img.astype(np.float32))
    return np.einsum("Ww,hwc->hWc", ww, out)


# ------------------------------------------------------------------ kernels


def _gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """Isotropic truncated Gaussian (MATLAB fspecial('gaussian') parity)."""
    half = (ksize - 1) / 2
    y, x = np.mgrid[-half : half + 1, -half : half + 1]
    k = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    k[k < np.finfo(k.dtype).eps * k.max()] = 0
    return k / k.sum()


def _anisotropic_gaussian_kernel(ksize: int, theta: float, l1: float, l2: float) -> np.ndarray:
    """Rotated anisotropic Gaussian with eigenvalues (l1, l2)."""
    v = np.array([np.cos(theta), np.sin(theta)])
    V = np.array([[v[0], v[1]], [v[1], -v[0]]])
    D = np.array([[l1, 0], [0, l2]])
    sigma = V @ D @ np.linalg.inv(V)
    inv = np.linalg.inv(sigma)
    half = ksize // 2
    y, x = np.mgrid[-half : half + 1, -half : half + 1]
    coords = np.stack([x, y], axis=-1)
    expo = -0.5 * np.einsum("hwi,ij,hwj->hw", coords, inv, coords)
    k = np.exp(expo)
    return k / k.sum()


def _shift_kernel(k: np.ndarray, sf: int, upper_left: bool = False) -> np.ndarray:
    """Sub-pixel shift of a blur kernel by 0.5*(sf-1) (centers the nearest-
    downsample grid), via bilinear interpolation."""
    shift = 0.5 * (sf - 1)
    s = shift if upper_left else -shift
    return ndimage.shift(k, (s, s), order=1, mode="nearest")


# ------------------------------------------------------------ degrade ops

# cv2.INTER_LINEAR, INTER_CUBIC, INTER_AREA: OpenCV's fixed enum values,
# written out so that drawing one needs no cv2
_CV2_INTERP = (1, 2, 3)


def _blur(rng, img: np.ndarray, sf: int) -> np.ndarray:
    """Random (an)isotropic Gaussian blur; widths scale with sf."""
    ksize = 2 * rng.randint(2, 11) + 3
    if rng.random() < 0.5:
        wd2 = 4.0 + sf
        k = _anisotropic_gaussian_kernel(
            ksize, theta=rng.random() * np.pi, l1=wd2 * rng.random(), l2=wd2 * rng.random()
        )
    else:
        wd = 2.0 + 0.2 * sf
        k = _gaussian_kernel(ksize, wd * rng.random() + 1e-6)
    return ndimage.convolve(img, k[:, :, None], mode="mirror")


def _random_resize(rng, img: np.ndarray, sf: int) -> np.ndarray:
    """Random rescale: 20% up [1,2], 70% down [0.5/sf,1], 10% unchanged."""
    r = rng.np_rand()
    if r > 0.8:
        s = rng.uniform(1, 2)
    elif r < 0.7:
        s = rng.uniform(0.5 / sf, 1)
    else:
        s = 1.0
    img = cv2_or_raise("_random_resize").resize(
        img,
        (int(s * img.shape[1]), int(s * img.shape[0])),
        interpolation=rng.choice(_CV2_INTERP),
    )
    return np.clip(img, 0.0, 1.0)


def _three_mode_noise(rng, img: np.ndarray, level1: int, level2: int, speckle: bool) -> np.ndarray:
    """Color / grayscale / channel-correlated Gaussian noise (the reference's
    add_Gaussian_noise and add_speckle_noise share this structure)."""
    level = rng.randint(level1, level2)
    r = rng.random() if speckle else rng.np_rand()
    h, w = img.shape[:2]
    if r > 0.6:
        noise = rng.np_normal(0, level / 255.0, img.shape)
    elif r < 0.4:
        noise = rng.np_normal(0, level / 255.0, (h, w, 1))
    else:
        L = level2 / 255.0
        D = np.diag(rng.np_uniform(size=3))
        U = orth(rng.np_uniform(size=(3, 3)))
        cov = np.abs(L**2 * (U.T @ D @ U))
        noise = rng.np_multivariate_normal(np.zeros(3), cov, (h, w))
    noise = noise.astype(np.float32)
    img = img + (img * noise if speckle else noise)
    return np.clip(img, 0.0, 1.0)


def _gaussian_noise(rng, img, level1=2, level2=25):
    return _three_mode_noise(rng, img, level1, level2, speckle=False)


def _speckle_noise(rng, img, level1=2, level2=25):
    img = np.clip(img, 0.0, 1.0)
    return _three_mode_noise(rng, img, level1, level2, speckle=True)


def _poisson_noise(rng, img: np.ndarray) -> np.ndarray:
    img = np.clip((img * 255.0).round(), 0, 255) / 255.0
    lam = 10 ** (2 * rng.random() + 2.0)
    if rng.random() < 0.5:
        img = rng.np_poisson(img * lam).astype(np.float32) / lam
    else:
        gray = img[..., :3] @ np.array([0.299, 0.587, 0.114])
        gray = np.clip((gray * 255.0).round(), 0, 255) / 255.0
        img = img + (rng.np_poisson(gray * lam).astype(np.float32) / lam - gray)[..., None]
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def _jpeg_noise(rng, img: np.ndarray) -> np.ndarray:
    quality = rng.randint(30, 95)
    cv2 = cv2_or_raise("_jpeg_noise")
    bgr = cv2.cvtColor(single2uint(img), cv2.COLOR_RGB2BGR)
    _, enc = cv2.imencode(".jpg", bgr, [int(cv2.IMWRITE_JPEG_QUALITY), quality])
    dec = cv2.imdecode(enc, 1)
    return cv2.cvtColor(uint2single(dec), cv2.COLOR_BGR2RGB)


def add_sharpening(img: np.ndarray, weight: float = 0.5, radius: int = 50, threshold: int = 10) -> np.ndarray:
    """Unsharp masking with a soft threshold mask (real-ESRGAN style)."""
    if radius % 2 == 0:
        radius += 1
    cv2 = cv2_or_raise("add_sharpening")
    blur = cv2.GaussianBlur(img, (radius, radius), 0)
    residual = img - blur
    mask = (np.abs(residual) * 255 > threshold).astype(np.float32)
    soft_mask = cv2.GaussianBlur(mask, (radius, radius), 0)
    sharp = np.clip(img + weight * residual, 0, 1)
    return soft_mask * sharp + (1 - soft_mask) * img


def _paired_random_crop(rng, lq, hq, sf, lq_patchsize):
    h, w = lq.shape[:2]
    y = rng.randint(0, h - lq_patchsize)
    x = rng.randint(0, w - lq_patchsize)
    lq = lq[y : y + lq_patchsize, x : x + lq_patchsize, :]
    hq = hq[y * sf : (y + lq_patchsize) * sf, x * sf : (x + lq_patchsize) * sf, :]
    return lq, hq


# --------------------------------------------------------------------- rng


class _Rng:
    """Single seedable source for both python-random- and numpy-style draws.

    Draws are serialized with a lock: neither random.Random nor
    numpy.Generator is thread-safe, and datasets holding one may be read from
    the DataLoader's prefetch threads. (Thread scheduling still makes the
    draw ORDER nondeterministic under num_workers > 0 — see DataLoader.)"""

    def __init__(self, seed: Optional[int] = None):
        import threading

        self.py = _random.Random(seed)
        self.np = np.random.default_rng(seed)
        self._lock = threading.Lock()

    def random(self):
        with self._lock:
            return self.py.random()

    def uniform(self, a, b):
        with self._lock:
            return self.py.uniform(a, b)

    def randint(self, a, b):  # inclusive, like random.randint
        with self._lock:
            return self.py.randint(a, b)

    def choice(self, seq):
        with self._lock:
            return self.py.choice(seq)

    def sample(self, seq, k):
        with self._lock:
            return self.py.sample(seq, k)

    def np_rand(self):
        with self._lock:
            return self.np.random()

    def np_uniform(self, size=None):
        with self._lock:
            return self.np.random(size)

    def np_normal(self, loc, scale, size):
        with self._lock:
            return self.np.normal(loc, scale, size)

    def np_multivariate_normal(self, mean, cov, size):
        with self._lock:
            return self.np.multivariate_normal(mean, cov, size)

    def np_poisson(self, lam):
        with self._lock:
            return self.np.poisson(lam)


def _as_rng(rng_or_seed) -> _Rng:
    if isinstance(rng_or_seed, _Rng):
        return rng_or_seed
    return _Rng(rng_or_seed)


# ---------------------------------------------------------------- pipelines


def _mod_crop(img: np.ndarray, sf: int, lq_patchsize: int) -> np.ndarray:
    h1, w1 = img.shape[:2]
    img = img.copy()[: h1 - h1 % sf, : w1 - w1 % sf, ...]
    h, w = img.shape[:2]
    if h < lq_patchsize * sf or w < lq_patchsize * sf:
        raise ValueError(f"img size ({h1}X{w1}) is too small!")
    return img


def degradation_bsrgan(
    img: np.ndarray, sf: int = 4, lq_patchsize: int = 72, rng=None
) -> Tuple[np.ndarray, np.ndarray]:
    """BSRGAN 7-op shuffled degradation. Returns (lq, hq) float [0,1]."""
    rng = _as_rng(rng)
    jpeg_prob, scale2_prob = 0.9, 0.25
    sf_ori = sf
    img = _mod_crop(img, sf, lq_patchsize)
    hq = img.copy()

    if sf == 4 and rng.random() < scale2_prob:  # pre-halve, then degrade at sf=2
        if rng.np_rand() < 0.5:
            img = cv2_or_raise("degradation_bsrgan").resize(
                img,
                (img.shape[1] // 2, img.shape[0] // 2),
                interpolation=rng.choice(_CV2_INTERP),
            )
        else:
            img = matlab_imresize(img, 1 / 2, antialias=True)
        img = np.clip(img, 0.0, 1.0)
        sf = 2

    order = rng.sample(range(7), 7)
    # the full 1/sf downsample (op 3) must come after the random rescale (op 2)
    i2, i3 = order.index(2), order.index(3)
    if i2 > i3:
        order[i2], order[i3] = order[i3], order[i2]

    a, b = img.shape[1], img.shape[0]
    for op in order:
        if op in (0, 1):
            img = _blur(rng, img, sf)
        elif op == 2:
            a, b = img.shape[1], img.shape[0]
            if rng.random() < 0.75:
                s = rng.uniform(1, 2 * sf)
                img = cv2_or_raise("degradation_bsrgan").resize(
                    img,
                    (int(img.shape[1] / s), int(img.shape[0] / s)),
                    interpolation=rng.choice(_CV2_INTERP),
                )
            else:
                k = _gaussian_kernel(25, rng.uniform(0.1, 0.6 * sf))
                k = _shift_kernel(k, sf)
                k = k / k.sum()
                img = ndimage.convolve(img, k[:, :, None], mode="mirror")
                img = img[0::sf, 0::sf, ...]
            img = np.clip(img, 0.0, 1.0)
        elif op == 3:
            img = cv2_or_raise("degradation_bsrgan").resize(
                img, (int(a / sf), int(b / sf)), interpolation=rng.choice(_CV2_INTERP)
            )
            img = np.clip(img, 0.0, 1.0)
        elif op == 4:
            img = _gaussian_noise(rng, img)
        elif op == 5:
            if rng.random() < jpeg_prob:
                img = _jpeg_noise(rng, img)
        elif op == 6:
            pass  # camera ISP hook: no ISP model in this framework (nor used in ref)

    img = _jpeg_noise(rng, img)
    return _paired_random_crop(rng, img, hq, sf_ori, lq_patchsize)


def degradation_bsrgan_plus(
    img: np.ndarray,
    sf: int = 4,
    shuffle_prob: float = 0.5,
    use_sharp: bool = True,
    lq_patchsize: int = 64,
    rng=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """BSRGAN+ 13-op degradation (the training pipeline). Returns (lq, hq)."""
    rng = _as_rng(rng)
    img = _mod_crop(img, sf, lq_patchsize)
    if use_sharp:
        img = add_sharpening(img)
    hq = img.copy()

    if rng.random() < shuffle_prob:
        order = rng.sample(range(13), 13)
    else:
        order = list(range(13))
        order[2:6] = rng.sample(order[2:6], 4)
        order[9:13] = rng.sample(order[9:13], 4)

    poisson_prob = speckle_prob = 0.1
    for op in order:
        if op in (0, 7):
            img = _blur(rng, img, sf)
        elif op in (1, 8):
            img = _random_resize(rng, img, sf)
        elif op in (2, 9):
            img = _gaussian_noise(rng, img)
        elif op in (3, 10):
            if rng.random() < poisson_prob:
                img = _poisson_noise(rng, img)
        elif op in (4, 11):
            if rng.random() < speckle_prob:
                img = _speckle_noise(rng, img)
        elif op == 6:
            img = _jpeg_noise(rng, img)
        # ops 5 and 12: camera ISP hook (unused, as in the reference)

    img = cv2_or_raise("degradation_bsrgan_plus").resize(
        img,
        (hq.shape[1] // sf, hq.shape[0] // sf),
        interpolation=rng.choice(_CV2_INTERP),
    )
    img = _jpeg_noise(rng, img)
    return _paired_random_crop(rng, img, hq, sf, lq_patchsize)


def soft_degradation_bsrgan(
    img: np.ndarray,
    sf: int = 4,
    shuffle_prob: float = 0.5,
    lq_patchsize: int = 64,
    rng=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Soft 3-op degradation (blur / rescale / gaussian noise), no JPEG."""
    rng = _as_rng(rng)
    img = _mod_crop(img, sf, lq_patchsize)
    hq = img.copy()
    order = rng.sample(range(3), 3)
    for op in order:
        if op == 0:
            img = _blur(rng, img, sf)
        elif op == 1:
            img = _random_resize(rng, img, sf)
        elif op == 2:
            img = _gaussian_noise(rng, img)
    img = cv2_or_raise("soft_degradation_bsrgan").resize(
        img,
        (hq.shape[1] // sf, hq.shape[0] // sf),
        interpolation=rng.choice(_CV2_INTERP),
    )
    return _paired_random_crop(rng, img, hq, sf, lq_patchsize)
