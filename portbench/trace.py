"""The device trace of a traced run (``--trace 1``), read from
``torch.profiler`` (CUPTI): the seconds in which an operation ran on the
card within the window, the device time of each kernel by name, and the
longest idle gaps named by what the host was doing then. Only the CUDA
activity is recorded (kernels, copies and the CUDA runtime calls that
issued them): recording every host operator as well slowed the tiles
cell's host by a third and read its idle share that much too high."""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch


@contextmanager
def profiled(out: dict):
    """Trace the block; on exit ``out`` holds the reading (:func:`read`)."""
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.__enter__()
    t0 = time.time_ns()
    try:
        yield
        torch.cuda.synchronize()
    finally:
        t1 = time.time_ns()
        prof.__exit__(None, None, None)
    out.update(read(prof.profiler.kineto_results.events(), t0, t1))


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def read(events, t0: int, t1: int) -> dict:
    """busy_s, window_s, per-kernel device seconds and launches, and the
    breakdown (the ten kernels with most device time, the ten longest idle
    gaps by the innermost host operation under way when each began)."""
    device, host = [], []
    kernels = defaultdict(lambda: [0.0, 0])
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.is_user_annotation() or not e.correlation_id():
                continue  # a host span's shadow on the card's timeline, not work
            lo, hi = max(s, t0), min(s + d, t1)
            if hi > lo:
                device.append((lo, hi))
                k = kernels[e.name()]
                k[0] += (hi - lo) * 1e-9
                k[1] += 1
        elif d > 0:
            host.append((s, s + d, e.name()))
    busy = _union(device)
    busy_ns = sum(e - s for s, e in busy)
    gaps = []
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    for s, e in zip(edges[::2], edges[1::2]):
        if e > s:
            gaps.append((e - s, s))
    gaps.sort(reverse=True)
    host.sort()
    named = []
    for length, start in gaps[:10]:
        under = [h for h in host if h[0] <= start < h[1]]
        name = min(under, key=lambda h: h[1] - h[0])[2] if under else "host_idle"
        named.append([name, length * 1e-9])
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return {"busy_s": busy_ns * 1e-9, "window_s": (t1 - t0) * 1e-9,
            "kernels": {n: {"seconds": v[0], "launches": v[1]} for n, v in kernels.items()},
            "breakdown": {"device_ops": [[n[:64], v[0]] for n, v in top], "idle_gaps": named}}
