"""One image per class from the generation checkpoint, in a 2x5 grid (port
of ``generate_new_imgs/imgs_generator.py``).

Run from a directory beside ``models_run`` (the reference runs its script
from ``generate_new_imgs/``), with the repo root on the path:

    cd generate_new_imgs
    PYTHONPATH=.. python -m diffusionremotesensing_tpu_torch.imgs_generator

As there: the snapshot
``../models_run/Residual_Attention_UNet_generation_sentinel_data_crops/weights/snapshot.pt``,
the ten EuroSAT classes sorted, 64 x 64 images, cosine T=1500, one batched
call at classifier-free guidance 3, and the grid saved to
``../models_run/<name>/results/generated_imgs`` (PNG). ``device`` and
``generator`` as in ``superres_and_NDVIgen``: the card unless the caller
asks for the CPU, noise from a generator seeded 0 unless one is given;
tap44 'block' on the card. The sampling (:func:`_generate`) needs no
matplotlib; only the grid does.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from diffusionremotesensing_tpu_torch.cli import resolve_tap44
from diffusionremotesensing_tpu_torch.diffusion import make_process
from diffusionremotesensing_tpu_torch.io import load_snapshot
from diffusionremotesensing_tpu_torch.models.unet import residual_attention_unet_generation
from diffusionremotesensing_tpu_torch.utils import ieee_float32, resolve_device

MODEL_NAME = "Residual_Attention_UNet_generation_sentinel_data_crops"
CLASSES = sorted(["Highway", "River", "HerbaceousVegetation", "Residential", "AnnualCrop",
                  "Pasture", "Forest", "PermanentCrop", "Industrial", "SeaLake"])
NOISE_SCHEDULE, NOISE_STEPS, IMAGE_SIZE, INPUT_CHANNELS, CFG_SCALE = "cosine", 1500, 64, 3, 3.0


def _generate(s2d: bool = True, ddim_steps: Optional[int] = None, ddim_clip_x0: bool = True,
              device="cuda", generator: Optional[torch.Generator] = None) -> np.ndarray:
    """The ten images (10, 64, 64, 3), class i from ``CLASSES[i]``, clipped
    to [0, 1]: the sampling step of :func:`main`."""
    device = resolve_device(device)
    model = residual_attention_unet_generation(
        image_channels=INPUT_CHANNELS, out_dim=INPUT_CHANNELS, num_classes=len(CLASSES),
        s2d=s2d, tap44=resolve_tap44(None, device) if s2d else False)
    state, _ = load_snapshot(os.path.join("..", "models_run", MODEL_NAME, "weights",
                                          "snapshot.pt"))
    model.load_state_dict(state, strict=True)
    model = model.to(device).eval()
    ieee_float32(model.dtype)
    proc = make_process(model, NOISE_SCHEDULE, NOISE_STEPS, IMAGE_SIZE)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    out = proc.sample(len(CLASSES), cond=np.arange(len(CLASSES)), cfg_scale=CFG_SCALE,
                      ddim_steps=ddim_steps, ddim_clip_x0=ddim_clip_x0, generator=generator)
    return np.clip(out.float().cpu().numpy(), 0.0, 1.0)


def main(s2d: bool = True, ddim_steps: Optional[int] = None, ddim_clip_x0: bool = True,
         device="cuda", generator: Optional[torch.Generator] = None) -> None:
    """Generate one image per class (:func:`_generate`) and save the 2x5
    grid. ``ddim_steps``: DDIM with that many model calls; None, the
    1499-step ancestral chain."""
    preds = _generate(s2d, ddim_steps, ddim_clip_x0, device, generator)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    save_path = os.path.join("..", "models_run", MODEL_NAME, "results", "generated_imgs")
    os.makedirs(os.path.dirname(save_path), exist_ok=True)
    fig, axs = plt.subplots(2, 5, figsize=(15, 6))
    axs = axs.ravel()
    for i, class_ in enumerate(CLASSES):
        axs[i].imshow(preds[i])
        axs[i].axis("off")
        axs[i].set_title(class_, fontsize=12)
    plt.savefig(save_path, dpi=300, bbox_inches="tight", pad_inches=0)
    plt.close(fig)


if __name__ == "__main__":
    main()
