"""The per-layer metrics read from the program's own spans
(``diffusionremotesensing_tpu_torch.profiling``). The program records spans
while a profiler session is active, so in a traced run (``--trace 1``)
``profiling.spans()`` holds the traced window's spans alone: set-up and the
check run with the profiler off. Each file ``metrics/<name>.py`` binds one
of these as ``read(ctx)``; each returns None where no span of its kind was
recorded, as with a program that records none."""

from __future__ import annotations

import numpy as np

# aggregation's host work with no sampler work queued behind it
SERIAL = ("aggregation.prepare", "aggregation.copy_out", "aggregation.blend",
          "aggregation.finish")


def recorded(*names) -> list:
    """(name, seconds, attrs, parent) of each ended span of ``names``."""
    from diffusionremotesensing_tpu_torch import profiling

    read = getattr(profiling, "spans", None)
    if read is None:
        return []
    return [(s.name, (s.end - s.start) * 1e-9, s.attrs, s.parent) for s in read()
            if s.name in names and s.end is not None]


def queue_wait_p95(ctx):
    """95th percentile of the requests' waits in the batcher's queue
    (``serve.queue``: from submit to the worker taking the request), s."""
    waits = [s for _, s, _, _ in recorded("serve.queue")]
    return float(np.percentile(waits, 95)) if waits else None


def batch_run_s(ctx):
    """Median micro-batch (``serve.batch``: from the worker taking its first
    request to the answers on the host), s."""
    runs = [s for _, s, _, _ in recorded("serve.batch")]
    return float(np.median(runs)) if runs else None


def serial_share(ctx):
    """The summed seconds of aggregation's prepare, copy out, blend and
    finish over the window's seconds, %."""
    parts = recorded(*SERIAL)
    if not parts:
        return None
    return 100.0 * sum(s for _, s, _, _ in parts) / ctx["run"]["seconds"]


def host_issue_ms(ctx):
    """Median, over the sampler calls, of the host's time to issue the
    call's first step (``sampler.step`` 0: nothing of the call is queued
    yet, so a full launch queue cannot hold it), ms."""
    first = [s for _, s, a, _ in recorded("sampler.step") if a.get("step") == 0]
    return 1e3 * float(np.median(first)) if first else None
