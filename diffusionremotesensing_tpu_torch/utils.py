"""Device resolution, image metrics, image and media output and dataset
organisation shared by the port's entry points (port of
``diffusionremotesensing_tpu/utils.py``).

Images are HWC float numpy arrays in [0, 1]. ``save_image`` writes PNG
through the port's own codec (``png.py``); other formats, and
``convert_png_to_jpg``, need PIL. The media writers import their package
when called: ``video_maker`` cv2, ``gif_maker`` imageio and
``save_preview_grid`` matplotlib; each raises an ImportError naming the
writer and the package where it is not installed.

``force_cpu_if_requested`` reads ``DRS_FORCE_CPU=1`` as the caller asking
for the CPU (:func:`default_device`); it is never a fallback.
``ieee_float32`` turns cuDNN's TF32 off for a float32 model, so that the
port's float32 is IEEE float32 on the card as on the CPU. The
reference's ``machine_scoped_cache_dir`` (XLA's compile cache) has no
counterpart: the port's one cache is the kernels' build directory
(``ops/cuda_build.BUILD_DIR``).
"""

from __future__ import annotations

import os
import random
import shutil
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from diffusionremotesensing_tpu_torch.png import encode_png

__all__ = [
    "resolve_device",
    "default_device",
    "ieee_float32",
    "psnr",
    "ssim",
    "save_image",
    "video_maker",
    "gif_maker",
    "save_preview_grid",
    "convert_png_to_jpg",
    "data_organizer_superresolution",
    "require_pil",
    "force_cpu_if_requested",
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


def ieee_float32(dtype: torch.dtype) -> None:
    """For a model computing in float32: turn cuDNN's TF32 off, process-wide
    (torch turns it on by default, and its convolutions then round their
    inputs to 10-bit mantissas on the card). The entry points call it as
    they build a float32 model (``InferenceServer``, ``Trainer``, the
    aggregation launcher, the inference helpers), so that float32 means the
    IEEE float32 the CPU computes; a bfloat16 model leaves the setting as
    it is."""
    if dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False


def force_cpu_if_requested() -> bool:
    """Whether ``DRS_FORCE_CPU`` is set (to anything but '' or '0'): the
    caller asking the entry points that have no ``--device`` flag (the
    trainers) to run on the CPU."""
    return os.environ.get("DRS_FORCE_CPU", "") not in ("", "0")


def default_device() -> str:
    """'cpu' when :func:`force_cpu_if_requested`, else 'cuda' (which
    :func:`resolve_device` refuses where no card is visible)."""
    return "cpu" if force_cpu_if_requested() else "cuda"


def _missing(what: str, package: str, e: ImportError) -> ImportError:
    """The ImportError of a writer whose package is not installed."""
    err = ImportError(f"{what} needs {package}, which is not installed")
    err.__cause__ = e
    return err


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


def video_maker(frames: Sequence[np.ndarray], path: str, fps: int = 100) -> None:
    """Write a denoising trajectory as an mp4 with a 'Frame i' overlay on
    each frame (cv2)."""
    try:
        import cv2
    except ImportError as e:
        raise _missing("video_maker", "OpenCV (cv2)", e)
    first = _frame_to_uint8(frames[0])
    h, w = first.shape[:2]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    try:
        for i, frame in enumerate(frames):
            img = _frame_to_uint8(frame)
            if img.shape[-1] == 1:
                img = np.repeat(img, 3, axis=-1)
            bgr = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
            cv2.putText(bgr, f"Frame {i}", (10, 30), cv2.FONT_HERSHEY_SIMPLEX, 1,
                        (255, 255, 255), 2)
            writer.write(bgr)
    finally:
        writer.release()


def gif_maker(frames: Sequence[np.ndarray], path: str, fps: int = 50) -> None:
    """Write frames as an animated GIF (imageio): the rate as a per-frame
    ``duration`` in milliseconds (imageio's pillow plugin ignores ``fps=``),
    ``loop=0``, an endless loop."""
    try:
        import imageio
    except ImportError as e:
        raise _missing("gif_maker", "imageio", e)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    imageio.mimsave(path, [_frame_to_uint8(f) for f in frames], duration=1000.0 / fps, loop=0)


def save_preview_grid(rows: Iterable[Sequence[np.ndarray]], titles: Sequence[str],
                      path: str) -> None:
    """A matplotlib (Agg) grid of images, one row per item of ``rows`` (its
    images match ``titles``), 5 x 5 inches an image, as the trainers'
    previews."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise _missing("save_preview_grid", "matplotlib", e)
    rows = list(rows)
    ncols = len(titles)
    fig, axs = plt.subplots(len(rows), ncols, figsize=(5 * ncols, 5 * len(rows)), squeeze=False)
    for r, imgs in enumerate(rows):
        for c, (img, title) in enumerate(zip(imgs, titles)):
            arr = np.clip(np.asarray(img), 0, 1)
            axs[r, c].imshow(arr.squeeze(), cmap="gray" if arr.shape[-1] == 1 else None)
            axs[r, c].set_title(title)
            axs[r, c].axis("off")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path)
    plt.close(fig)


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
