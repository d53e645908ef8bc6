"""CIFAR10 from a local copy (port of ``diffusionremotesensing_tpu/data/
cifar10.py``): it reads the standard ``cifar-10-batches-py`` pickled-batch
layout from a directory and downloads nothing. Point ``root_dir`` at the
directory or its parent.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

from diffusionremotesensing_tpu_torch.data.datasets import pil_resize_u8

CIFAR10_CLASSES = [
    "airplane", "automobile", "bird", "cat", "deer",
    "dog", "frog", "horse", "ship", "truck",
]


class Cifar10Dataset:
    """{'x': (32,32,3) float [0,1], 'cond': int label} items; with
    ``image_size`` the image is resized by Pillow's bilinear resampling
    (``pil_resize_u8``, no PIL needed)."""

    def __init__(self, root_dir: str, train: bool = True, image_size: Optional[int] = None):
        d = root_dir
        if os.path.isdir(os.path.join(d, "cifar-10-batches-py")):
            d = os.path.join(d, "cifar-10-batches-py")
        names = (
            [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
        )
        data, labels = [], []
        for name in names:
            path = os.path.join(d, name)
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"CIFAR10 batch {path} not found: download "
                    "cifar-10-python.tar.gz on a networked machine and extract it here"
                )
            with open(path, "rb") as f:
                batch = pickle.load(f, encoding="bytes")
            data.append(batch[b"data"])
            labels.extend(batch[b"labels"])
        arr = np.concatenate(data).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        self.images = arr.astype(np.float32) / 255.0
        self.labels = np.asarray(labels, np.int32)
        self.classes = CIFAR10_CLASSES
        self.num_classes = 10
        self.image_size = image_size

    def __len__(self) -> int:
        return len(self.labels)

    def __getitem__(self, idx: int):
        img = self.images[idx]
        if self.image_size is not None and self.image_size != 32:
            u8 = pil_resize_u8((img * 255).astype(np.uint8), self.image_size, self.image_size)
            img = np.asarray(u8, np.float32) / 255.0
        return {"x": img, "cond": self.labels[idx]}
