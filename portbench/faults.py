"""Faults planted in the program underneath a run, for the limits' upper
readings (``control.py --fault``) and the tests that see ``correct`` come
out false. Each is a context manager that patches the program and undoes
the patch on exit.

* ``answer_altered``: every answer replaced by its neighbour's where it is
  produced (a chunk's patches, a call's images, a micro-batch's requests);
* ``state_unchanged``: the optimizer step leaves the parameters as they were;
* ``half_batch``: the loss is the mean over the first half of the batch.
"""

from __future__ import annotations

import contextlib

import torch


def _rolled(out):
    return torch.roll(out, 1, 0) if torch.is_tensor(out) else out[1:] + out[:1]


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def answer_altered(driver: str):
    if driver == "tiles":
        from diffusionremotesensing_tpu_torch.aggregation import AggregationSampler

        chunks = AggregationSampler._sampled_chunks

        def altered(self, *a, **kw):
            for start, out in chunks(self, *a, **kw):
                yield start, _rolled(out)
        return _patched(AggregationSampler, "_sampled_chunks", altered)
    if driver == "bulk":
        from diffusionremotesensing_tpu_torch.diffusion import DiffusionProcess

        sample = DiffusionProcess.sample
        return _patched(DiffusionProcess, "sample",
                        lambda self, *a, **kw: _rolled(sample(self, *a, **kw)))
    if driver == "serve":
        from diffusionremotesensing_tpu_torch.serving import InferenceServer

        run_batch = InferenceServer._run_batch
        return _patched(InferenceServer, "_run_batch",
                        lambda self, conds: _rolled(run_batch(self, conds)))
    raise ValueError(f"no answer to alter in a {driver!r} cell")


def state_unchanged(driver: str):
    return _patched(torch.optim.Adam, "step", lambda self, closure=None: None)


def half_batch(driver: str):
    from diffusionremotesensing_tpu_torch import train as ptrain

    make = ptrain.make_loss_fn

    def half(name, vgg=None):
        loss = make(name, vgg)
        return lambda pred, target, **kw: loss(pred[: len(pred) // 2], target[: len(pred) // 2])
    return _patched(ptrain, "make_loss_fn", half)


FAULTS = {"answer_altered": answer_altered, "state_unchanged": state_unchanged,
          "half_batch": half_batch}
# the faults each kind of cell can have
CELL_FAULTS = {"tiles": ["answer_altered"], "bulk": ["answer_altered"],
               "serve": ["answer_altered"], "train": ["state_unchanged", "half_batch"]}
