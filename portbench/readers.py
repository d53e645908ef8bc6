"""The per-layer metrics' arithmetic. Each file ``metrics/<name>.py`` binds
one of these to its name as ``read(ctx)``; a reader with nothing to read
returns None and the metric is left out of the result line.

``ctx`` holds the cell's ``config`` and ``traffic``, its window ``run``
(units, work, seconds), its ``work`` (the model's dense FLOPs over the
window, the forwards, their batch and shape, the batch fill) and, in a
traced run, its ``trace`` (``trace.read``).
"""

from __future__ import annotations

import glob
import importlib
import json
import os

from portbench import yardstick

HERE = os.path.dirname(os.path.abspath(__file__))


def mfu(ctx):
    """The whole step's share of the card's dense bf16 peak, %: the model's
    dense FLOPs (the work asked for: no pad rows) over the traced window's
    seconds on the host's clock. The profiler slows the host, so where the
    host paces the card this reads below an untraced window's share."""
    return 100.0 * ctx["work"]["model_flops"] / ctx["run"]["seconds"] / yardstick.PEAK_BF16


def device_idle(ctx):
    """The share of the traced window in which no operation ran on the card, %."""
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def kernel_map() -> dict:
    """layer -> (profiler name fragments, bound function), merged from every
    ``kernels/*.json`` (a later file adds names to a layer)."""
    layers: dict = {}
    for path in sorted(glob.glob(os.path.join(HERE, "kernels", "*.json"))):
        with open(path) as f:
            spec = json.load(f)
        entry = layers.setdefault(spec["layer"], {"names": [], "bound": None})
        entry["names"] += spec.get("names", [])
        entry["bound"] = spec.get("bound", entry["bound"])
    return layers


def _bound_fn(ref: str):
    mod, fn = ref.split(":")
    return getattr(importlib.import_module(mod), fn)


def kernel_roofline(ctx):
    """The hand kernels' share of their roofline, %: the summed least times
    of the traffic's ``hand_layers`` at the cell's shapes, once per forward,
    over the device time of the kernels that implement them."""
    tr = ctx.get("trace")
    layers = ctx["traffic"].get("hand_layers", [])
    if not tr or not layers:
        return None
    kmap = kernel_map()
    names = [n for layer in layers for n in kmap[layer]["names"]]
    spent = sum(k["seconds"] for name, k in tr["kernels"].items() if any(n in name for n in names))
    if spent <= 0:
        return None
    w = ctx["work"]
    bound_ms = sum(_bound_fn(kmap[layer]["bound"])(w) for layer in layers)
    return 100.0 * w["forwards"] * bound_ms * 1e-3 / spent


def kernel_share(ctx, fragments):
    """The share of the card's kernel time spent in kernels whose names hold
    one of ``fragments``, %."""
    tr = ctx.get("trace")
    if not tr:
        return None
    total = sum(k["seconds"] for k in tr["kernels"].values())
    part = sum(k["seconds"] for name, k in tr["kernels"].items()
               if any(f in name for f in fragments))
    return 100.0 * part / total if total > 0 else None


def launches_per_forward(ctx):
    """Kernels launched on the card per UNet forward (a sampler step), count."""
    tr = ctx.get("trace")
    if not tr or not ctx["work"]["forwards"]:
        return None
    return sum(k["launches"] for k in tr["kernels"].values()) / ctx["work"]["forwards"]


def batch_fill(ctx):
    """Requests per micro-batch over its size, %."""
    fill = ctx["work"].get("batch_fill")
    return None if fill is None else 100.0 * fill
