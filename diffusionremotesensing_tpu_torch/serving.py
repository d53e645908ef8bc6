"""Micro-batching inference server, super-resolution task (port of
``diffusionremotesensing_tpu/serving.py:39-303``).

Requests queue up and are micro-batched to ``max_batch`` (padded with
wrap-around to a fixed shape), then denoised in one sampler call;
``infer_tile`` runs whole-scene tiled super-resolution through aggregation
sampling. Each sampler call draws its noise from a ``torch.Generator`` of
its own, seeded from the server's seed and a request counter. The HTTP
front end and the PNG codec of the reference package are not ported yet.

Example:
    server = InferenceServer(model, "cosine", 1500, image_size=128,
                             ddim_steps=100, dtype=torch.bfloat16)
    # or from a trained snapshot, flax msgpack or the reference's torch file:
    server = InferenceServer.from_snapshot("snapshot.pt", "cosine", 1500, 128,
                                           model_flags=dict(s2d=True, tap44="block"),
                                           ddim_steps=100, dtype=torch.bfloat16)
    out = server.infer_batch([lr_img])          # list of (128, 128, 3)
    sr = server.infer_tile(lr_tile)             # (2H, 2W, 3)
    server.shutdown()
"""

from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from diffusionremotesensing_tpu_torch.aggregation import AggregationSampler
from diffusionremotesensing_tpu_torch.diffusion import make_process
from diffusionremotesensing_tpu_torch.io import load_snapshot
from diffusionremotesensing_tpu_torch.models.unet import residual_attention_unet_superres
from diffusionremotesensing_tpu_torch.utils import resolve_device


class MicroBatcher:
    """Collects requests into micro-batches: waits up to ``max_wait_ms`` for
    the batch to fill, then hands up to ``max_batch`` items to ``run_batch``
    on its worker thread."""

    def __init__(self, run_batch, max_batch: int = 8, max_wait_ms: float = 10.0):
        self._run_batch = run_batch
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def submit(self, item) -> "queue.Queue":
        done: "queue.Queue" = queue.Queue(maxsize=1)
        if self._stop.is_set():
            done.put(RuntimeError("server is shut down"))
            return done
        self._q.put((item, done))
        return done

    def infer(self, item, timeout: Optional[float] = None):
        result = self.submit(item).get(timeout=timeout)
        if isinstance(result, Exception):
            raise result
        return result

    def _loop(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.max_wait
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                outs = self._run_batch([b[0] for b in batch])
                for (_, done), out in zip(batch, outs):
                    done.put(out)
            except Exception as e:  # noqa: BLE001 - the worker must outlive a failed batch
                for _, done in batch:
                    done.put(e)

    def shutdown(self):
        self._stop.set()
        self._worker.join(timeout=5)
        while True:  # fail requests still queued so their waiters return
            try:
                _, done = self._q.get_nowait()
            except queue.Empty:
                break
            done.put(RuntimeError("server is shut down"))


class InferenceServer:
    """Super-resolution diffusion inference with micro-batching.

    ``model`` is a super-resolution ``ResidualAttentionUNet`` whose weights
    are loaded, served as its factory built it (``s2d``, ``tap44``,
    ``fused_att``, ``dec_block``); it is moved to ``device`` (``cuda`` unless
    the caller asks for the CPU) and computes in ``dtype`` (default: its
    parameters' dtype).
    ``ddim_steps=None`` serves the reference's ancestral DDPM chain."""

    def __init__(self, model, noise_schedule: str, noise_steps: int, image_size: int,
                 task: str = "superres", max_batch: int = 8, max_wait_ms: float = 10.0,
                 ddim_steps: Optional[int] = None, ddim_clip_x0: bool = True, seed: int = 0,
                 dtype: Optional[torch.dtype] = None, device="cuda"):
        if task != "superres":
            raise NotImplementedError(f"task={task!r} is not ported yet")
        self.device = resolve_device(device)
        self.task = task
        self.image_size = image_size
        self.model = model.to(self.device)
        self.max_batch = max_batch
        self.process = make_process(self.model, noise_schedule, noise_steps, image_size, dtype)
        self._ddim_steps = ddim_steps
        self._ddim_clip_x0 = ddim_clip_x0
        if ddim_steps is not None:
            self._sampler = self.process.ddim_sampler(ddim_steps, clip_x0=ddim_clip_x0)
        else:
            self._sampler = self.process.sampler()
        self._seeds = np.random.SeedSequence(seed)
        self._lock = threading.Lock()
        self._tile_lock = threading.Lock()
        self._agg: Optional[AggregationSampler] = None
        self.batches_run = 0  # micro-batches the sampler has run
        s = image_size // model.magnification_factor
        self.expected_cond_shape = (s, s, model.cond_channels)
        self.batcher = MicroBatcher(self._run_batch, max_batch, max_wait_ms)

    @classmethod
    def from_snapshot(cls, path: str, noise_schedule: str, noise_steps: int, image_size: int,
                      magnification_factor: int = 2, model_flags: Optional[dict] = None,
                      **kwargs) -> "InferenceServer":
        """A server of the weights in the snapshot at ``path`` (either format
        :func:`~diffusionremotesensing_tpu_torch.io.load_snapshot` reads): the
        super-resolution UNet built with ``magnification_factor`` and
        ``model_flags`` (``s2d``, ``tap44``, ``fused_att``, ``dec_block``,
        ``use_pallas``, ``packed_head``), the weights loaded strictly, then
        served as the constructor serves a model; ``kwargs`` go to it
        (``device`` is ``cuda`` unless the caller asks for the CPU)."""
        model = residual_attention_unet_superres(magnification_factor=magnification_factor,
                                                 **(model_flags or {}))
        state, _ = load_snapshot(path)
        model.load_state_dict(state, strict=True)
        return cls(model.eval(), noise_schedule, noise_steps, image_size, **kwargs)

    def validate(self, cond) -> Optional[str]:
        """An error message for an invalid request, else None."""
        shape = tuple(np.asarray(cond).shape)
        if shape != self.expected_cond_shape:
            return f"input shape {shape} != expected {self.expected_cond_shape}"
        return None

    def _next_generator(self) -> torch.Generator:
        with self._lock:
            seed = int(self._seeds.spawn(1)[0].generate_state(1, np.uint64)[0] >> 1)
        return torch.Generator(device=self.device).manual_seed(seed)

    def _run_batch(self, conds: List[np.ndarray]) -> List[np.ndarray]:
        n = len(conds)
        idx = list(range(n)) + [i % n for i in range(self.max_batch - n)]
        cond = torch.from_numpy(np.stack([np.asarray(conds[i], np.float32) for i in idx]))
        cond = cond.to(self.device)
        gen = self._next_generator()
        x_T = torch.randn((self.max_batch, self.image_size, self.image_size,
                           self.model.image_channels), generator=gen, device=self.device)
        out = self._sampler(x_T, cond, generator=gen).clamp(0.0, 1.0).cpu().numpy()
        with self._lock:
            self.batches_run += 1
        return [out[i] for i in range(n)]

    def infer_batch(self, conds: List[np.ndarray], timeout: Optional[float] = 600) -> List[np.ndarray]:
        """Submit every condition image and collect the results (they may
        share one micro-batch)."""
        for c in conds:
            err = self.validate(c)
            if err is not None:
                raise ValueError(err)
        handles = [self.batcher.submit(c) for c in conds]
        outs = []
        for h in handles:
            r = h.get(timeout=timeout)
            if isinstance(r, Exception):
                raise r
            outs.append(r)
        return outs

    def infer_tile(self, lr_img: np.ndarray) -> np.ndarray:
        """Tiled super-resolution of an LR image of any size >= one patch,
        through aggregation sampling (patch = the model's LR size, stride
        half of it). Tile requests run one at a time."""
        p = self.expected_cond_shape[0]
        img = np.asarray(lr_img, np.float32)
        if img.ndim != 3 or img.shape[2] != self.model.cond_channels or min(img.shape[:2]) < p:
            raise ValueError(
                f"tile must be (H>={p}, W>={p}, {self.model.cond_channels}), got {tuple(img.shape)}")
        with self._tile_lock:
            if self._agg is None:
                self._agg = AggregationSampler(
                    self.process, patch_size=p, stride=p // 2,
                    magnification_factor=self.model.magnification_factor,
                    ddim_steps=self._ddim_steps, ddim_clip_x0=self._ddim_clip_x0)
            return self._agg(img, generator=self._next_generator(), device=self.device)

    def warmup(self):
        """Run one request before accepting traffic."""
        s = self.expected_cond_shape
        self.infer_batch([np.zeros(s, np.float32)])

    def shutdown(self):
        """Stop the micro-batching worker; queued requests fail."""
        self.batcher.shutdown()
