"""Device resolution, image metrics, image output and dataset organisation
shared by the port's entry points (port of ``diffusionremotesensing_tpu/
utils.py``'s ``psnr``, ``ssim``, ``save_image``, ``convert_png_to_jpg`` and
``data_organizer_superresolution``).

Images are HWC float numpy arrays in [0, 1]. ``save_image`` writes PNG
through the port's own codec (``png.py``); other formats, and
``convert_png_to_jpg``, need PIL and raise an ImportError where it is not
installed.
"""

from __future__ import annotations

import os
import random
import shutil
from typing import List, Optional, Tuple

import numpy as np
import torch

from diffusionremotesensing_tpu_torch.png import encode_png

__all__ = [
    "resolve_device",
    "psnr",
    "ssim",
    "save_image",
    "convert_png_to_jpg",
    "data_organizer_superresolution",
    "require_pil",
]


def resolve_device(device="cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if it names CUDA and no card is
    visible. There is no fallback to the CPU: a caller that wants the CPU
    asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev


def require_pil(what: str, instead: Optional[str] = None):
    """``PIL.Image`` for ``what``, or an ImportError that names ``what``, the
    missing package and, where there is one, the way that needs no PIL."""
    try:
        from PIL import Image
    except ImportError as e:
        alt = f"; without PIL use {instead}" if instead else ""
        raise ImportError(f"{what} needs Pillow (PIL), which is not installed{alt}") from e
    return Image


def _frame_to_uint8(frame: np.ndarray) -> np.ndarray:
    """HWC float [0,1] (clamped) -> HWC uint8."""
    arr = np.asarray(frame)
    if arr.ndim == 4:  # (1, H, W, C)
        arr = arr[0]
    arr = np.clip(arr, 0.0, 1.0)
    return (arr * 255.0).astype(np.uint8)


def save_image(img: np.ndarray, path: str) -> None:
    """Save an HWC float [0,1] array as an image file: PNG by the port's
    codec, any other extension through PIL."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arr = _frame_to_uint8(img).squeeze()
    if path.lower().endswith(".png"):
        with open(path, "wb") as f:
            f.write(encode_png(arr))
        return
    Image = require_pil(f"save_image({os.path.basename(path)!r})", "a .png path")
    Image.fromarray(arr).save(path)


def convert_png_to_jpg(folder_path: str) -> None:
    """In-place convert all .png files in a folder to .jpg."""
    Image = require_pil("convert_png_to_jpg")
    for name in os.listdir(folder_path):
        if name.lower().endswith(".png"):
            p = os.path.join(folder_path, name)
            img = Image.open(p).convert("RGB")
            img.save(os.path.splitext(p)[0] + ".jpg")
            os.remove(p)


def data_organizer_superresolution(
    main_folder: str,
    split_ratio: Tuple[float, float, float] = (0.8, 0.15, 0.05),
    seed: Optional[int] = None,
) -> None:
    """Recursively collect files under ``main_folder``, shuffle, and move them
    into train_original/val_original/test_original subfolders by ratio."""
    assert abs(sum(split_ratio) - 1.0) < 1e-6
    files: List[str] = []
    split_dirs = {"train_original", "val_original", "test_original"}
    for root, dirs, names in os.walk(main_folder):
        dirs[:] = [d for d in dirs if d not in split_dirs]
        files.extend(os.path.join(root, n) for n in names)
    rng = random.Random(seed)
    rng.shuffle(files)
    n = len(files)
    n_train = int(n * split_ratio[0])
    n_val = int(n * split_ratio[1])
    buckets = {
        "train_original": files[:n_train],
        "val_original": files[n_train : n_train + n_val],
        "test_original": files[n_train + n_val :],
    }
    for sub, paths in buckets.items():
        dst_dir = os.path.join(main_folder, sub)
        os.makedirs(dst_dir, exist_ok=True)
        for p in paths:
            shutil.move(p, os.path.join(dst_dir, os.path.basename(p)))


# ----------------------------------------------------------------- metrics


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """Mean structural similarity (Wang et al.), 7x7 uniform window per
    channel, constants C1=(0.01 R)^2, C2=(0.03 R)^2."""
    from scipy.ndimage import uniform_filter

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    vals = []
    for c in range(a.shape[-1]):
        x, y = a[..., c], b[..., c]
        mx = uniform_filter(x, 7)
        my = uniform_filter(y, 7)
        mxx = uniform_filter(x * x, 7)
        myy = uniform_filter(y * y, 7)
        mxy = uniform_filter(x * y, 7)
        vx = mxx - mx * mx
        vy = myy - my * my
        cxy = mxy - mx * my
        s = ((2 * mx * my + C1) * (2 * cxy + C2)) / ((mx**2 + my**2 + C1) * (vx + vy + C2))
        vals.append(s.mean())
    return float(np.mean(vals))
