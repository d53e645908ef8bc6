"""What the drivers share: the program's UNet built from a configuration
and the seed's weights, the reference's comparisons, and the timing of a
window of units."""

from __future__ import annotations

import time
from typing import Callable, Dict, List

import numpy as np
import torch

from portbench.reference import precision
from portbench.reference.sampling import alpha_hat
from portbench.reference.unet import UNet

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def program_unet(config: dict, flags: dict, state: Dict[str, torch.Tensor], device, **extra):
    """The program's UNet of ``config`` built with the model ``flags`` (s2d,
    tap44, fused_att, ...), holding ``state``, on ``device``."""
    from diffusionremotesensing_tpu_torch.models import unet as punet

    if config["conditioning"] == "superres":
        model = punet.residual_attention_unet_superres(
            image_channels=config["image_channels"], out_dim=config["image_channels"],
            magnification_factor=config["magnification_factor"], **flags, **extra)
    elif config["conditioning"] == "class":
        model = punet.residual_attention_unet_generation(
            image_channels=config["image_channels"], out_dim=config["image_channels"],
            num_classes=config["num_classes"], **flags, **extra)
    else:
        raise ValueError(f"no driver serves conditioning {config['conditioning']!r}")
    model.load_state_dict(state, strict=True)
    return model.to(device).eval()


def reference_unet(config: dict, state: Dict[str, torch.Tensor], q: str = "float32") -> UNet:
    precision.ieee_float32()
    return UNet(state, config["conditioning"], config.get("magnification_factor") or 1,
                precision.PRECISIONS[q])


def schedule(config: dict) -> np.ndarray:
    return alpha_hat(config["noise_schedule"], config["noise_steps"])


def mean_abs_gap(got: np.ndarray, want: np.ndarray) -> float:
    """The mean absolute difference of two image sets in [0, 1]."""
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).mean())


def timed_units(issue: Callable[[int], None], finish: Callable[[], None], seconds: float) -> dict:
    """Run ``issue(i)`` for i = 0, 1, ... while ``seconds`` have not elapsed
    since the first, then ``finish()`` (which waits for the card): the window
    ends when the last unit begun inside it has completed, and is counted."""
    t0 = time.perf_counter()
    i = 0
    while True:
        issue(i)
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    finish()
    return {"units": i, "seconds": time.perf_counter() - t0}


def sample_indices(seed: int, n: int, k: int, salt: int) -> List[int]:
    """k of range(n) drawn from the seed (sorted)."""
    rng = np.random.default_rng([seed, salt])
    return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()
