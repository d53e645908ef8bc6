"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes plain ``extern "C"`` launchers (no PyTorch
headers), so one ``nvcc`` call takes seconds. Sources build at first use
into ``build/`` inside this package (listed in ``.gitignore``); the library
name carries a hash of the source and of the shared headers
(``csrc/*.cuh``), so an edited source is rebuilt and a stale library is
never loaded. :func:`check_operands` holds the tensors a wrapper hands to a
kernel to the shapes, type, device and layout the kernel takes, and
:func:`check_aligned` to the 16-byte start a TMA copy needs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


@dataclass
class Built:
    """A loaded library, the seconds its build took (0.0 when an up-to-date
    library was found) and the compiler's output (``-Xptxas -v`` reports
    registers, shared memory and spills per kernel)."""

    lib: ctypes.CDLL
    seconds: float
    log: str


_LOADED: dict = {}
_LOCKS: dict = {}  # one per source: different sources build in parallel
_LOCK = threading.Lock()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH)")
    return found


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(".cuh"))
    for src in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, src), "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build(name: str) -> Built:
    """Build ``csrc/<name>.cu`` where needed, load it, and return it.
    Calls for different sources may run at once (one ``nvcc`` each)."""
    with _LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name in _LOADED:
            return _LOADED[name]
        path = _lib_path(name)
        if os.path.exists(path):
            _LOADED[name] = Built(ctypes.CDLL(path), 0.0, "up to date")
            return _LOADED[name]
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        r = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")],
                           capture_output=True, text=True)
        log = r.stdout + r.stderr
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu (exit {r.returncode}):\n{log}")
        os.replace(tmp, path)
        _LOADED[name] = Built(ctypes.CDLL(path), time.perf_counter() - t0, log)
        return _LOADED[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    return build(name).lib


def check_operands(kernel: str, ref: torch.Tensor, operands: dict) -> None:
    """Raise unless every operand ``name: (tensor, shape)`` has that shape,
    ``ref``'s dtype and device, and is contiguous: what a kernel of this
    package takes as it is."""
    for name, (t, shape) in operands.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if t.dtype != ref.dtype or t.device != ref.device:
            raise ValueError(f"{kernel}: {name} is {t.dtype} on {t.device}, "
                             f"expected {ref.dtype} on {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")


def check_aligned(kernel: str, tensors: dict) -> None:
    """Raise unless every tensor ``name: tensor`` starts on a 16-byte
    boundary, as a TMA copy's global address must."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} is not 16-byte aligned (TMA reads it)")
