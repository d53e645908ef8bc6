"""Datasets for the three tasks, emitting NHWC float32 dict-items (port of
``diffusionremotesensing_tpu/data/datasets.py``):

* superres:   {'x': hr (H,W,C), 'cond': lr (H/mag, W/mag, C)}
* SAR->NDVI:  {'x': ndvi (H,W,1), 'cond': sar (H,W,2)}
* generation: {'x': img (H,W,C), 'cond': int label}

All image data is float32 in [0, 1] (ToTensor semantics), channel-last.

Images are held as numpy arrays in place of PIL images, with PIL's modes'
meaning: (H, W) uint8 for ``L``, (H, W, 3) for ``RGB``. PNG files and the
``numpy`` and ``torch`` data formats decode without PIL (``png.py``), to
the values PIL gives, and the resizes and the Gaussian blur are Pillow's
own fixed-point arithmetic in numpy (``pil_resize_u8``,
``pil_gaussian_blur_u8``, ``pil_downblur_u8``: bit-equal to Pillow), so
``SuperresDownBlurDataset`` and ``DecodeOnlyDataset`` (followed by
``data.device_degradation.make_downblur_transform``) need no PIL. Other
image formats (JPEG, TIFF, BMP, WebP) and the BSRGAN pipelines' OpenCV
steps import their package when they run, and raise an ImportError that
names the alternative where it is missing.
"""

from __future__ import annotations

import math
import os
import threading
from typing import Optional, Tuple

import numpy as np

from diffusionremotesensing_tpu_torch.data.degradations import (
    _Rng,
    _gaussian_noise,
    degradation_bsrgan_plus,
    imread_uint,
    single2uint,
    soft_degradation_bsrgan,
    uint2single,
)
from diffusionremotesensing_tpu_torch.data.device_degradation import pil_resize_weights
from diffusionremotesensing_tpu_torch.png import encode_png, is_png, read_png
from diffusionremotesensing_tpu_torch.utils import require_pil

_IMG_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".webp"}


def pil_resize_u8(arr: np.ndarray, oh: int, ow: int, name: str = "bilinear") -> np.ndarray:
    """Pillow's ``Image.resize((ow, oh), BILINEAR or BICUBIC)`` of a uint8
    (H, W) or (H, W, C) array: its fixed-point weights (support widened on a
    downscale), the horizontal pass then the vertical, each rounded with
    clip8. The sums are exact in float64, so the result is Pillow's."""
    x = np.asarray(arr, np.float64)
    if x.shape[1] != ow:
        x = np.clip(np.floor(np.einsum("Ww,hw...->hW...", pil_resize_weights(x.shape[1], ow, name),
                                       x) + 0.5), 0, 255)
    if x.shape[0] != oh:
        x = np.clip(np.floor(np.einsum("Hh,hw...->Hw...", pil_resize_weights(x.shape[0], oh, name),
                                       x) + 0.5), 0, 255)
    return x.astype(np.uint8)


def _box_blur_radius(radius: float, passes: int) -> np.float32:
    """Pillow's radius of each box pass for GaussianBlur(radius), computed as
    its C code computes it (float, with double-precision sqrt and floor)."""
    f = np.float32
    sigma2 = f(radius) * f(radius) / f(passes)
    L = f(math.sqrt(12.0 * float(sigma2) + 1.0))
    l = f(math.floor((float(L) - 1.0) / 2.0))  # noqa: E741 (Pillow's name)
    a = (f(2) * l + f(1)) * (l * (l + f(1)) - f(3) * sigma2)
    a = a / (f(6) * (sigma2 - (l + f(1)) * (l + f(1))))
    return f(l + a)


def _box_pass(x: np.ndarray, radius: np.float32) -> np.ndarray:
    """One of Pillow's box passes along axis 1 of a uint8 (H, W, C) array: a
    window of 2r + 1 edge-clamped pixels at 24-bit fixed-point weight ww,
    the two pixels beyond it at the fractional weight fw, rounded."""
    r = int(radius)
    ww = np.int64(np.uint32(np.float32(1 << 24) / (radius * np.float32(2) + np.float32(1))))
    fw = (np.int64(1 << 24) - (2 * r + 1) * ww) // 2
    w = x.shape[1]
    idx = np.arange(w)
    xi = x.astype(np.int64)
    acc = sum(xi[:, np.clip(idx + d, 0, w - 1)] for d in range(-r, r + 1))
    far = xi[:, np.clip(idx - r - 1, 0, w - 1)] + xi[:, np.clip(idx + r + 1, 0, w - 1)]
    return ((acc * ww + far * fw + (1 << 23)) >> 24).astype(np.uint8)


def pil_gaussian_blur_u8(arr: np.ndarray, radius: float, passes: int = 3) -> np.ndarray:
    """Pillow's ``ImageFilter.GaussianBlur(radius)`` of a uint8 (H, W) or
    (H, W, C) array: ``passes`` extended box passes along the rows, then as
    many along the columns, each in Pillow's fixed point and rounded to
    uint8, so the result is Pillow's."""
    x = arr if arr.ndim == 3 else arr[:, :, None]
    r = _box_blur_radius(radius, passes)
    for _ in range(passes):
        x = _box_pass(x, r)
    x = x.transpose(1, 0, 2)
    for _ in range(passes):
        x = _box_pass(x, r)
    x = np.ascontiguousarray(x.transpose(1, 0, 2))
    return x if arr.ndim == 3 else x[:, :, 0]


def pil_downblur_u8(hr: np.ndarray, magnification_factor: int, blur_radius: float) -> np.ndarray:
    """The reference's DownBlur LR of a uint8 HR image, as Pillow makes it:
    the bicubic downsample by the magnification factor, then GaussianBlur."""
    h, w = hr.shape[:2]
    lr = pil_resize_u8(hr, h // magnification_factor, w // magnification_factor, "bicubic")
    return pil_gaussian_blur_u8(lr, blur_radius)


def _msb(s: np.ndarray) -> np.ndarray:
    """16-bit samples as PIL's 8-bit modes hold them: the high byte."""
    return (s >> 8).astype(np.uint8) if s.dtype == np.uint16 else s


def _png_as_opened(data: bytes) -> np.ndarray:
    """``np.asarray(Image.open(png))``: palette indices for a palette image,
    bool for 1-bit grey, uint16 for 16-bit grey, the high byte of the other
    16-bit modes, grey below 8 bits scaled to 0-255."""
    png = read_png(data)
    s = png.samples
    if png.color_type in (0, 3):
        s = s[..., 0]
        if png.color_type == 0 and png.bit_depth == 1:
            return s.astype(bool)
        if png.color_type == 0 and png.bit_depth in (2, 4):
            return (s * (255 // ((1 << png.bit_depth) - 1))).astype(np.uint8)
        return s
    return _msb(s)


def _png_rgb_or_l(data: bytes) -> np.ndarray:
    """The PNG as PIL holds it after ``convert("RGB") if mode not in ("RGB",
    "L")``: (H, W) uint8 for 2-8 bit grey, else (H, W, 3) uint8."""
    png = read_png(data)
    s = png.samples
    if png.color_type == 0:
        g = s[..., 0]
        if png.bit_depth == 16:  # PIL's I;16 -> RGB clamps at 255
            return np.repeat(np.minimum(g, 255).astype(np.uint8)[:, :, None], 3, axis=2)
        if png.bit_depth == 1:
            return np.repeat((g * 255).astype(np.uint8)[:, :, None], 3, axis=2)
        return (g * (255 // ((1 << png.bit_depth) - 1))).astype(np.uint8)
    if png.color_type == 3:
        return png.palette[s[..., 0]]
    s = _msb(s)
    if png.color_type == 4:
        return np.repeat(s[..., :1], 3, axis=2)
    return np.ascontiguousarray(s[..., :3])


def _fromarray_rgb_or_l(arr: np.ndarray) -> np.ndarray:
    """``Image.fromarray(arr)`` then ``convert("RGB")`` unless it is ``L`` or
    ``RGB``: LA repeats its grey, RGBA drops its alpha."""
    if arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] == 3):
        return arr
    if arr.ndim == 3 and arr.shape[2] == 2:
        return np.repeat(arr[..., :1], 3, axis=2)
    if arr.ndim == 3 and arr.shape[2] == 4:
        return np.ascontiguousarray(arr[..., :3])
    raise TypeError(f"Cannot handle this data type: {(1, 1) + arr.shape[2:]}, {arr.dtype.str}")


def _open_rgb_or_l(path: str) -> np.ndarray:
    """An image file as (H, W) grey or (H, W, 3) RGB uint8, PIL's mode
    normalisation: PNG by the port's codec, other formats through PIL."""
    with open(path, "rb") as f:
        data = f.read()
    if is_png(data):
        return _png_rgb_or_l(data)
    Image = require_pil(f"decoding {os.path.basename(path)!r} (not a PNG)", "PNG files")
    y = Image.open(path)
    return np.asarray(y.convert("RGB") if y.mode not in ("RGB", "L") else y)


def _open_as_opened(path: str) -> np.ndarray:
    """``np.asarray(Image.open(path))``: PNG by the port's codec."""
    with open(path, "rb") as f:
        data = f.read()
    if is_png(data):
        return _png_as_opened(data)
    Image = require_pil(f"decoding {os.path.basename(path)!r} (not a PNG)", "PNG files")
    return np.asarray(Image.open(path))


def _to_float_hwc(img: np.ndarray) -> np.ndarray:
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


class DecodedCache:
    """Bounded in-RAM cache of decoded (post-resize) uint8 images.

    Decoded images are immutable and identical across epochs, so caching is
    bit-exact. Thread-safe insert-up-to-budget (the DataLoader fetches on a
    thread pool); no eviction: one epoch touches the same fixed set, so
    items past the byte budget simply stay uncached."""

    def __init__(self, max_mb: float):
        self.max_bytes = int(max_mb * 1e6)
        self._bytes = 0
        self._d: dict = {}
        self._lock = threading.Lock()

    def get(self, key):
        return self._d.get(key)

    def put(self, key, arr: np.ndarray) -> None:
        with self._lock:
            if key in self._d or self._bytes + arr.nbytes > self.max_bytes:
                return
            self._d[key] = arr
            self._bytes += arr.nbytes


def _load_rgb_or_l(path: str, data_format: str) -> np.ndarray:
    """An image in the reference's three accepted formats, as PIL's L or
    RGB mode holds it."""
    if data_format == "PIL":
        return _open_rgb_or_l(path)
    if data_format == "numpy":
        y = np.load(path)
        return _fromarray_rgb_or_l((y * 255).astype(np.uint8))
    if data_format == "torch":
        import torch

        t = torch.load(path)  # CHW float
        return _fromarray_rgb_or_l((t.numpy().transpose(1, 2, 0) * 255).astype(np.uint8).squeeze())
    raise ValueError(f"unknown data_format {data_format!r}")


def _decode_rgb(path: str, data_format: str, image_size=None) -> np.ndarray:
    """Shared decode prologue: load, normalise the mode, optional bilinear
    resize to image_size. Both the host DownBlur dataset and
    DecodeOnlyDataset go through this."""
    y = _load_rgb_or_l(path, data_format)
    if image_size is not None and y.shape[:2] != (image_size, image_size):
        y = pil_resize_u8(y, image_size, image_size, "bilinear")
    return y


class SuperresDownBlurDataset:
    """HR image -> (bicubic downsample / mag, Gaussian blur[, noise]) LR pair.

    Pillow's bilinear resize to image_size, its bicubic downsample by the
    magnification factor and its GaussianBlur, computed in numpy as Pillow
    computes them (``pil_downblur_u8``). ``blur_radius='random'`` draws from
    triangular(0.5, 1.5, mode=1) ONCE and freezes it for the whole dataset,
    as the reference does.
    """

    def __init__(
        self,
        root_dir: str,
        magnification_factor: int,
        blur_radius=0.5,
        gauss_noise: bool = False,
        data_format: str = "PIL",
        image_size: Optional[int] = None,
        seed: int = 0,
        cache_mb: float = 0.0,
        cache: Optional["DecodedCache"] = None,
    ):
        self.root_dir = root_dir
        self.magnification_factor = magnification_factor
        self.gauss_noise = gauss_noise
        self.data_format = data_format
        self.image_size = image_size
        self.filenames = sorted(os.listdir(root_dir))
        self._rng = _Rng(seed)
        # a shared DecodedCache keeps the byte budget global across the
        # train/val datasets (keys include root_dir/size/format)
        self._cache = cache if cache is not None else (
            DecodedCache(cache_mb) if cache_mb > 0 else None
        )
        if blur_radius == "random":
            blur_radius = self._rng.py.triangular(0.5, 1.5, 1)
        self.blur_radius = float(blur_radius)

    def __len__(self) -> int:
        return len(self.filenames)

    def _decoded(self, idx: int) -> np.ndarray:
        """Decoded + resized HR image, via the bit-exact uint8 cache when
        enabled."""
        key = (self.root_dir, idx, self.image_size, self.data_format)
        if self._cache is not None:
            arr = self._cache.get(key)
            if arr is not None:
                return arr.squeeze()
        y = _decode_rgb(
            os.path.join(self.root_dir, self.filenames[idx]), self.data_format, self.image_size
        )
        if self._cache is not None:
            self._cache.put(key, y if y.ndim == 3 else y[:, :, None])
        return y

    def __getitem__(self, idx: int):
        y = self._decoded(idx)
        x_arr = _to_float_hwc(pil_downblur_u8(y, self.magnification_factor, self.blur_radius))
        if self.gauss_noise:
            # 3-mode noise (color/gray/channel-correlated), levels in [2, 10]
            x_arr = _gaussian_noise(self._rng, x_arr, 2, 10).astype(np.float32)
        return {"x": _to_float_hwc(y), "cond": x_arr}


class DecodeOnlyDataset:
    """Host side of the on-device DownBlur path: decode (and, when a source
    image is not already image_size, Pillow's bilinear resize). Yields
    {'hr_u8': (S, S, C) uint8}; pair with
    data.device_degradation.make_downblur_transform. PNG, numpy and torch
    files need no PIL."""

    def __init__(self, root_dir: str, image_size: int, data_format: str = "PIL",
                 cache_mb: float = 0.0, cache: Optional["DecodedCache"] = None):
        self.root_dir = root_dir
        self.image_size = image_size
        self.data_format = data_format
        self.filenames = sorted(os.listdir(root_dir))
        self._cache = cache if cache is not None else (
            DecodedCache(cache_mb) if cache_mb > 0 else None
        )

    def __len__(self) -> int:
        return len(self.filenames)

    def __getitem__(self, idx: int):
        key = (self.root_dir, idx, self.image_size, self.data_format)
        if self._cache is not None:
            arr = self._cache.get(key)
            if arr is not None:
                return {"hr_u8": arr}
        arr = _decode_rgb(
            os.path.join(self.root_dir, self.filenames[idx]), self.data_format, self.image_size
        )
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if self._cache is not None:
            self._cache.put(key, arr)
        return {"hr_u8": arr}


class SuperresBSRGANDataset:
    """Eagerly degrades every file x num_crops with the BSRGAN(+) pipeline and
    holds all (lr, hr) pairs in RAM, shuffled, as the reference's eager
    constructor does. Optionally dumps PNG pairs to ``destination_folder``.
    Reading the files and the pipelines need OpenCV (cv2)."""

    def __init__(
        self,
        root_dir: str,
        magnification_factor: int,
        model_input_size: int,
        num_crops: int = 1,
        degradation_type: str = "BSR_plus",
        destination_folder: Optional[str] = None,
        seed: int = 0,
        num_workers: int = 0,
    ):
        if degradation_type == "BSR_plus":
            pipeline = degradation_bsrgan_plus
        elif degradation_type == "soft_BSR_plus":
            pipeline = soft_degradation_bsrgan
        else:
            raise ValueError("degradation_type must be 'BSR_plus' or 'soft_BSR_plus'")
        filenames = sorted(os.listdir(root_dir))
        # decode each source image once; the pipelines copy their input
        # before mutating
        decoded = {
            name: uint2single(imread_uint(os.path.join(root_dir, name), 3))
            for name in filenames
        }
        jobs = [
            (name, seed + 7919 * (j * num_crops + c + 1))
            for j, name in enumerate(filenames)
            for c in range(num_crops)
        ]

        def degrade(job):
            name, job_seed = job
            lq, hq = pipeline(
                decoded[name], sf=magnification_factor,
                lq_patchsize=model_input_size, rng=job_seed,
            )
            # uint8 quantize round-trip, like the reference's
            # single2uint -> ToTensor
            return uint2single(single2uint(lq)), uint2single(single2uint(hq))

        if num_workers > 0:
            # cv2/scipy release the GIL, so threads scale
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=num_workers) as pool:
                pairs = list(pool.map(degrade, jobs))
        else:
            pairs = [degrade(j) for j in jobs]

        rng = _Rng(seed)
        order = rng.sample(range(len(pairs)), len(pairs))
        self.lr_images = [pairs[i][0] for i in order]
        self.hr_images = [pairs[i][1] for i in order]
        if destination_folder is not None:
            self._save(destination_folder)

    def _save(self, folder: str) -> None:
        os.makedirs(os.path.join(folder, "lr"), exist_ok=True)
        os.makedirs(os.path.join(folder, "hr"), exist_ok=True)
        for i, (lq, hq) in enumerate(zip(self.lr_images, self.hr_images)):
            for sub, img, stem in (("lr", lq, "x"), ("hr", hq, "y")):
                with open(os.path.join(folder, sub, f"{stem}_{i}.png"), "wb") as f:
                    f.write(encode_png(single2uint(img)))

    def __len__(self) -> int:
        return len(self.lr_images)

    def __getitem__(self, idx: int):
        return {"x": self.hr_images[idx], "cond": self.lr_images[idx]}


class SarToNdviDataset:
    """Paired <root>/{sar,opt}/<same-filename> items; inputs in [-1, 1] are
    rescaled to [0, 1]. Supports .pt / .npy / image files."""

    def __init__(self, root_dir: str, data_format: str = "torch"):
        self.sar_path = os.path.join(root_dir, "sar")
        self.opt_path = os.path.join(root_dir, "opt")
        self.filenames = sorted(os.listdir(self.sar_path))
        self.data_format = data_format

    def __len__(self) -> int:
        return len(self.filenames)

    def _load(self, path: str) -> np.ndarray:
        # the file extension wins over the declared data_format
        ext = os.path.splitext(path)[1].lower()
        if ext in (".pt", ".pth") or (ext == "" and self.data_format == "torch"):
            import torch

            t = torch.load(path)
            arr = t.numpy()
            return arr.transpose(1, 2, 0) if arr.ndim == 3 else arr[:, :, None]
        if ext == ".npy" or self.data_format == "numpy":
            arr = np.load(path).astype(np.float32)
            if arr.ndim == 2:  # single-channel 2-D arrays, same as the .pt branch
                return arr[:, :, None]
            return arr.transpose(1, 2, 0) if arr.ndim == 3 and arr.shape[0] <= 4 else arr
        # an image file: map to [-1, 1] first
        return _to_float_hwc(_open_as_opened(path)) * 2.0 - 1.0

    def __getitem__(self, idx: int):
        sar = self._load(os.path.join(self.sar_path, self.filenames[idx]))
        ndvi = self._load(os.path.join(self.opt_path, self.filenames[idx]))
        sar = (np.asarray(sar, np.float32) + 1.0) / 2.0
        ndvi = (np.asarray(ndvi, np.float32) + 1.0) / 2.0
        return {"x": ndvi, "cond": sar}


class ImageFolderDataset:
    """Class-per-subfolder image dataset (torchvision.datasets.ImageFolder
    semantics: classes sorted alphabetically, labels = class index)."""

    def __init__(self, root_dir: str, image_size: Optional[int] = None):
        self.root_dir = root_dir
        self.classes = sorted(
            d for d in os.listdir(root_dir) if os.path.isdir(os.path.join(root_dir, d))
        )
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples: list[Tuple[str, int]] = []
        for c in self.classes:
            cdir = os.path.join(root_dir, c)
            for f in sorted(os.listdir(cdir)):
                if os.path.splitext(f)[1].lower() in _IMG_EXTS:
                    self.samples.append((os.path.join(cdir, f), self.class_to_idx[c]))
        self.image_size = image_size

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int):
        path, label = self.samples[idx]
        img = _open_rgb_or_l(path)
        if img.ndim == 2:  # convert("RGB") of a grey image
            img = np.repeat(img[:, :, None], 3, axis=2)
        if self.image_size is not None:
            img = pil_resize_u8(img, self.image_size, self.image_size, "bilinear")
        return {"x": _to_float_hwc(img), "cond": np.int32(label)}
