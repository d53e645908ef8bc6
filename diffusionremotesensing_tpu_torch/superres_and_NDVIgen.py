"""Inference from a checkpoint: super-resolution and SAR->NDVI (port of the
repo-root ``superres_and_NDVIgen.py``, the reference package's helpers).

As there: the model_name convention ('magnificationN' / 'LRimgsizeN' /
'imgsizeN' parts of the name, parsed by ``cli``'s copies of the parsers),
the snapshot ``models_run/<model_name>/weights/snapshot.pt`` (else
``snapshot.msgpack``) under the working directory, the fixed cosine
schedule of 1500 steps, the DDIM and warm-start options, the SAR input's
range check, and the plots. Images are HWC float numpy arrays in [0, 1].

Where the port differs:

* ``generator`` (a ``torch.Generator`` of the device) takes the place of
  the key; None draws from one seeded 0.
* ``device`` is ``cuda`` unless the caller asks for the CPU
  (``utils.resolve_device``: no fallback where no card is visible). tap44
  is 'block' on the card (``tap_block`` runs ResConvBlock-0) and off on the
  CPU (``cli.resolve_tap44``), where the reference picks its kernel on a
  TPU. The models compute in float32 with cuDNN's TF32 off
  (``utils.ieee_float32``).
* The plots import matplotlib when called (the card's machine has none).

Example:
    sr = super_resolver(lr, model_name="Residual_Attention_UNet_superres_"
                        "magnification2_LRimgsize128_up42", ddim_steps=100)
    ndvi = SAR_to_NDVI_generator("sar.npy", n_generations=2, ddim_steps=100)
    plot_lr_sr(lr, sr, save_path="sr.png")
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from diffusionremotesensing_tpu_torch.cli import (
    parse_imgsize,
    parse_lr_imgsize,
    parse_magnification,
    resolve_tap44,
)
from diffusionremotesensing_tpu_torch.diffusion import make_process
from diffusionremotesensing_tpu_torch.io import load_snapshot
from diffusionremotesensing_tpu_torch.models.unet import (
    residual_attention_unet_sar_to_ndvi,
    residual_attention_unet_superres,
)
from diffusionremotesensing_tpu_torch.ops.resize import upsample_bicubic
from diffusionremotesensing_tpu_torch.utils import ieee_float32, resolve_device

__all__ = ["parse_magnification", "parse_lr_imgsize", "parse_imgsize", "super_resolver",
           "SAR_to_NDVI_generator", "plot_lr_sr", "plot_SAR_NDVI"]

NOISE_SCHEDULE, NOISE_STEPS = "cosine", 1500
SAR_MODEL_NAME = "Residual_Attention_UNet_EMA_imgsize128_SAR_TO_NDVI"


def snapshot_path(model_name: str) -> str:
    """``models_run/<model_name>/weights/snapshot.pt``, or its
    ``snapshot.msgpack`` where only that exists."""
    path = os.path.join("models_run", model_name, "weights", "snapshot.pt")
    alt = path.replace("snapshot.pt", "snapshot.msgpack")
    return alt if not os.path.exists(path) and os.path.exists(alt) else path


def _loaded(model, path: str, device: torch.device):
    """``model`` with the snapshot's weights, on ``device``, for inference
    in IEEE float32."""
    state, _ = load_snapshot(path)
    model.load_state_dict(state, strict=True)
    model = model.to(device).eval()
    ieee_float32(model.dtype)
    return model


def _generator(generator: Optional[torch.Generator], device: torch.device) -> torch.Generator:
    return generator if generator is not None else torch.Generator(device=device).manual_seed(0)


def super_resolver(lr_img: np.ndarray, device="cuda", model_name: str = "",
                   generator: Optional[torch.Generator] = None, s2d: bool = True,
                   ddim_steps: Optional[int] = None, ddim_clip_x0: bool = True,
                   start_t: Optional[int] = None) -> np.ndarray:
    """Super-resolve one LR image (H, W, C) with the named checkpoint.

    ``model_name`` holds 'magnificationN' and 'LRimgsizeN' parts, e.g.
    'Residual_Attention_UNet_superres_magnification2_LRimgsize128_up42_...'.
    Returns the (H * mag, W * mag, C) image clipped to [0, 1].
    ``ddim_steps`` runs DDIM with that many model calls (per-step x0
    clamping with ``ddim_clip_x0``); None, the 1499-step ancestral chain.
    ``start_t`` starts the chain from the bicubic upsample of ``lr_img``
    q-sampled to that timestep."""
    device = resolve_device(device)
    magnification_factor = parse_magnification(model_name)
    image_size = parse_lr_imgsize(model_name) * magnification_factor
    lr_img = np.asarray(lr_img, np.float32)
    input_channels = lr_img.shape[-1]
    print(f"HR Image size: {image_size}, LR Image size: {image_size // magnification_factor} "
          f"Magnification factor: {magnification_factor}, Channels: {input_channels}")
    model = residual_attention_unet_superres(
        image_channels=input_channels, out_dim=input_channels,
        magnification_factor=magnification_factor, s2d=s2d,
        tap44=resolve_tap44(None, device) if s2d else False)
    model = _loaded(model, snapshot_path(model_name), device)
    proc = make_process(model, NOISE_SCHEDULE, NOISE_STEPS, image_size)
    init = None
    if start_t is not None:
        init = upsample_bicubic(torch.from_numpy(lr_img[None]), magnification_factor)[0].numpy()
    out = proc.sample(1, cond=lr_img, ddim_steps=ddim_steps, ddim_clip_x0=ddim_clip_x0,
                      start_t=start_t, init=init, generator=_generator(generator, device))
    return np.clip(out[0].float().cpu().numpy(), 0.0, 1.0)


def SAR_to_NDVI_generator(SAR_img_path: str, device="cuda", n_generations: int = 1,
                          generator: Optional[torch.Generator] = None, s2d: bool = True,
                          ddim_steps: Optional[int] = None,
                          ddim_clip_x0: bool = True) -> np.ndarray:
    """NDVI image(s) (n_generations, H, W, 1) from the SAR image in
    ``SAR_img_path`` (a ``.npy`` file, else a tensor ``torch.load`` reads;
    HWC or CHW, values in [-1, 1]: negative ones rescaled to [0, 1]) with the
    'Residual_Attention_UNet_EMA_imgsize128_SAR_TO_NDVI' checkpoint.
    ``ddim_steps`` and ``ddim_clip_x0`` as in :func:`super_resolver`."""
    device = resolve_device(device)
    SAR_channels, NDVI_channels = 2, 1
    image_size = parse_imgsize(SAR_MODEL_NAME)
    print(f"Image size: {image_size}, SAR channels: {SAR_channels}, NDVI channels: {NDVI_channels}")
    if SAR_img_path.endswith(".npy"):
        sar = np.load(SAR_img_path).astype(np.float32)
    else:
        sar = torch.load(SAR_img_path, map_location="cpu").numpy().astype(np.float32)
    if sar.ndim == 3 and sar.shape[0] == SAR_channels:
        sar = sar.transpose(1, 2, 0)  # CHW -> HWC
    if sar.min() < 0 and sar.min() > -1:
        sar = (sar + 1) / 2
    elif sar.min() < -1 or sar.max() > 1:
        raise ValueError("SAR image values are not in the range [-1, 1]")
    model = residual_attention_unet_sar_to_ndvi(
        sar_channels=SAR_channels, ndvi_channels=NDVI_channels, s2d=s2d,
        tap44=resolve_tap44(None, device) if s2d else False)
    model = _loaded(model, snapshot_path(SAR_MODEL_NAME), device)
    proc = make_process(model, NOISE_SCHEDULE, NOISE_STEPS, image_size)
    out = proc.sample(n_generations, cond=sar, ddim_steps=ddim_steps, ddim_clip_x0=ddim_clip_x0,
                      generator=_generator(generator, device))
    return out.float().cpu().numpy()


def plot_lr_sr(lr_img, sr_img, histogram: bool = True, save_path: Optional[str] = None):
    """LR beside SR (with ``histogram``, their histograms below), saved to
    ``save_path`` at 300 dpi."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    title_font = {"family": "sans-serif", "weight": "bold", "size": 15}
    lr, sr = np.asarray(lr_img), np.asarray(sr_img)
    fig, axs = plt.subplots(2 if histogram else 1, 2, figsize=(15, 10))
    axs = axs.ravel()
    axs[0].imshow(np.clip(lr, 0, 1))
    axs[0].set_title("low resolution image", fontdict=title_font)
    axs[1].imshow(np.clip(sr, 0, 1))
    axs[1].set_title("super resolution image", fontdict=title_font)
    if histogram:
        axs[2].hist(lr.flatten(), bins=100)
        axs[2].set_title("lr image histogram", fontdict=title_font)
        axs[3].hist(sr.flatten(), bins=100)
        axs[3].set_title("sr image histogram", fontdict=title_font)
    if save_path is not None:
        plt.savefig(save_path, dpi=300, bbox_inches="tight", pad_inches=0)
    plt.close(fig)


def plot_SAR_NDVI(SAR_img, NDVI_img, NDVI_pred_img, save_path: Optional[str] = None):
    """SAR (its first channel), the NDVI ground truth and each NDVI
    prediction in one row, saved to ``save_path`` at 300 dpi."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    preds = np.asarray(NDVI_pred_img)
    n = preds.shape[0]
    fig, axs = plt.subplots(1, 2 + n, figsize=(5 * (2 + n), 10))
    title_font = {"family": "sans-serif", "weight": "bold", "size": 8}
    axs = np.atleast_1d(axs).ravel()
    axs[0].imshow(np.asarray(SAR_img)[..., 0], cmap="gray")
    axs[0].set_title("SAR image", fontdict=title_font)
    axs[1].imshow(np.asarray(NDVI_img).squeeze(), cmap="RdYlGn")
    axs[1].set_title("NDVI ground truth", fontdict=title_font)
    for i in range(n):
        axs[2 + i].imshow(preds[i].squeeze(), cmap="RdYlGn")
        axs[2 + i].set_title(f"NDVI prediction {i}", fontdict=title_font)
    if save_path is not None:
        plt.savefig(save_path, dpi=300, bbox_inches="tight", pad_inches=0)
    plt.close(fig)
