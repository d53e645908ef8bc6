"""Tracing, per-step timing and structured metrics (port of
``diffusionremotesensing_tpu/profiling.py``).

* :func:`trace`: ``torch.profiler`` over a block, its timeline written as a
  Chrome/Perfetto trace into a directory;
* :func:`annotate`: a named region in that timeline (``record_function``);
* :class:`StepTimer`: steps/s with the first ``warmup`` steps left out (on
  the card, synchronise before each ``tick``: kernels run asynchronously);
* :class:`MetricsLogger`: an append-only JSONL file of per-epoch scalars.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional

import torch

__all__ = ["trace", "StepTimer", "MetricsLogger", "annotate"]


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Profile the block's CPU and CUDA activity into
    ``log_dir/trace.json`` (nothing when ``log_dir`` is empty)."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named region in the profiler's timeline."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Steps/s with the first ``warmup`` steps excluded."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.count = 0
        self._t0: Optional[float] = None

    def tick(self) -> None:
        self.count += 1
        if self.count == self.warmup:
            self._t0 = time.perf_counter()

    @property
    def steps_per_sec(self) -> float:
        if self._t0 is None or self.count <= self.warmup:
            return 0.0
        return (self.count - self.warmup) / (time.perf_counter() - self._t0)


class MetricsLogger:
    """Append-only JSONL metrics file (a no-op without a path)."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        else:
            self._fh = None

    def log(self, **metrics: Any) -> None:
        if self._fh is None:
            return
        metrics.setdefault("ts", time.time())
        self._fh.write(json.dumps(_to_plain(metrics)) + "\n")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def _to_plain(tree: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        try:
            out[k] = float(v) if hasattr(v, "__float__") and not isinstance(v, (int, bool)) else v
        except (TypeError, ValueError):
            out[k] = str(v)
    return out
