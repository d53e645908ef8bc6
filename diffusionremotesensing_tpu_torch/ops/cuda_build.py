"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes plain ``extern "C"`` launchers (no PyTorch
headers), so one ``nvcc`` call takes seconds. Sources build at first use
into ``build/`` inside this package (listed in ``.gitignore``); the library
name carries a hash of the source, so an edited source is rebuilt and a
stale library is never loaded.
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
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build(name: str) -> Built:
    """Build ``csrc/<name>.cu`` where needed, load it, and return it."""
    with _LOCK:
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
