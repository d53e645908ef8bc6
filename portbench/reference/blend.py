"""Aggregation sampling's patch grid and Gaussian blend, plainly.

The LR tile is cut into patch x patch windows every ``stride`` pixels,
the last row and column of windows moved in to end at the border, each
window once. Each super-resolved window is weighted by the separable
Gaussian of the reference repository (variance 0.01 of the squared
window width; centres (w - 1) / 2 across and h / 2 down) and the canvas
is the weighted sum over the summed weights, clamped to [0, 1].
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np


def windows(size: int, patch: int, stride: int) -> List[Tuple[int, int]]:
    """(y0, x0) of each LR window of a square tile, row by row."""
    out, seen = [], set()
    for y in range(0, size + 1, stride):
        for x in range(0, size + 1, stride):
            box = (min(y, size - patch), min(x, size - patch))
            if box not in seen:
                seen.add(box)
                out.append(box)
    return out


def gaussian(size: int) -> np.ndarray:
    var = 0.01
    i = np.arange(size, dtype=np.float64)
    gx = np.exp(-((i - (size - 1) / 2) ** 2) / size ** 2 / (2 * var)) / math.sqrt(2 * math.pi * var)
    gy = np.exp(-((i - size / 2) ** 2) / size ** 2 / (2 * var)) / math.sqrt(2 * math.pi * var)
    return np.outer(gy, gx)


def blend(patches: np.ndarray, size: int, patch: int, stride: int, mag: int) -> np.ndarray:
    """The (size*mag, size*mag, C) tile from its windows' super-resolved
    patches (P, patch*mag, patch*mag, C), in :func:`windows` order."""
    hr = patch * mag
    w = gaussian(hr)[:, :, None]
    canvas = np.zeros((size * mag, size * mag, patches.shape[-1]))
    total = np.zeros((size * mag, size * mag, 1))
    for (y0, x0), p in zip(windows(size, patch, stride), patches):
        canvas[y0 * mag:y0 * mag + hr, x0 * mag:x0 * mag + hr] += p * w
        total[y0 * mag:y0 * mag + hr, x0 * mag:x0 * mag + hr] += w
    return np.clip(canvas / total, 0.0, 1.0)
