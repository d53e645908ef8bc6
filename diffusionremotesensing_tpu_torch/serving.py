"""Micro-batching inference server (port of
``diffusionremotesensing_tpu/serving.py:39-303``), for the three tasks:
``superres`` (condition = the LR image), ``sar`` (the SAR image, 2
channels, on the output grid; NDVI out) and ``generation`` (an integer
label; classifier-free guidance at scale 3 on both samplers, as the
reference).

Requests queue up and are micro-batched to ``max_batch`` (padded with
wrap-around to a fixed shape), then denoised in one sampler call;
``infer_tile`` runs whole-scene tiled super-resolution through aggregation
sampling. ``start_t`` (super-resolution only) starts each request from its
bicubic upsample q-sampled to t = start_t. Each sampler call draws its
noise from a ``torch.Generator`` of its own, seeded from the server's seed
and a request counter. ``serve`` / ``make_http_server`` put a stdlib HTTP
front end on it (base64 PNG images through the port's own codec,
``png.py``; no PIL).

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
    # the other tasks: SAR (64, 64, 2) -> NDVI (64, 64, 1); a label -> (32, 32, 3)
    ndvi = InferenceServer.from_snapshot("snapshot_sar.pt", "cosine", 1000, 64, task="sar")
    gen = InferenceServer.from_snapshot("snapshot_gen.pt", "cosine", 1000, 32,
                                        task="generation", num_classes=4)
    imgs = gen.infer_batch([0, 3])
    # over HTTP: GET /healthz; POST /superres, /sar_to_ndvi or /generate
    # ({"image": base64 PNG} or {"label": n}) and /superres_tile
    server.serve(host="0.0.0.0", port=8000)
"""

from __future__ import annotations

import base64
import itertools
import json
import queue
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from diffusionremotesensing_tpu_torch import profiling
from diffusionremotesensing_tpu_torch.aggregation import AggregationSampler
from diffusionremotesensing_tpu_torch.diffusion import make_process, warm_start_state
from diffusionremotesensing_tpu_torch.io import load_snapshot
from diffusionremotesensing_tpu_torch.models.unet import (
    residual_attention_unet_generation,
    residual_attention_unet_sar_to_ndvi,
    residual_attention_unet_superres,
)
from diffusionremotesensing_tpu_torch.ops.resize import upsample_bicubic
from diffusionremotesensing_tpu_torch.png import decode_png, encode_png, is_png
from diffusionremotesensing_tpu_torch.utils import ieee_float32, require_pil, resolve_device

# the model's conditioning each task serves
TASKS = {"superres": "superres", "sar": "sar", "generation": "class"}
CFG_SCALE = 3.0  # the generation task's guidance, as the reference serves it


class MicroBatcher:
    """Collects requests into micro-batches: waits up to ``max_wait_ms`` for
    the batch to fill, then hands up to ``max_batch`` items to ``run_batch``
    on its worker thread. While spans are recorded (``profiling``), each
    request's wait is a ``serve.queue`` span and each batch, from taking its
    first request to ``run_batch``'s return, a ``serve.batch`` span."""

    def __init__(self, run_batch, max_batch: int = 8, max_wait_ms: float = 10.0):
        self._run_batch = run_batch
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self._q: "queue.Queue" = queue.Queue()
        self._requests = itertools.count()  # the ids of the requests' queue spans
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def submit(self, item) -> "queue.Queue":
        done: "queue.Queue" = queue.Queue(maxsize=1)
        if self._stop.is_set():
            done.put(RuntimeError("server is shut down"))
            return done
        self._q.put((item, done, profiling.begin("serve.queue", request=next(self._requests))))
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
            try:
                # each request's queue span ends as the batch takes it
                with profiling.annotate("serve.batch", max_batch=self.max_batch) as span:
                    first[2].finish(span)
                    deadline = time.monotonic() + self.max_wait
                    while len(batch) < self.max_batch:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        try:
                            batch.append(self._q.get(timeout=remaining))
                        except queue.Empty:
                            break
                        batch[-1][2].finish(span)
                    span["rows"] = len(batch)
                    outs = self._run_batch([b[0] for b in batch])
                for (_, done, _), out in zip(batch, outs):
                    done.put(out)
            except Exception as e:  # noqa: BLE001 - the worker must outlive a failed batch
                for _, done, _ in batch:
                    done.put(e)

    def shutdown(self):
        self._stop.set()
        self._worker.join(timeout=5)
        while True:  # fail requests still queued so their waiters return
            try:
                _, done, _ = self._q.get_nowait()
            except queue.Empty:
                break
            done.put(RuntimeError("server is shut down"))


class InferenceServer:
    """Diffusion inference with micro-batching for ``task`` ('superres',
    'sar' or 'generation').

    ``model`` is a ``ResidualAttentionUNet`` of the task's conditioning
    whose weights are loaded, served as its factory built it (``s2d``,
    ``tap44``, ``fused_att``, ``dec_block``, ``use_pallas``,
    ``packed_head``); it is moved to ``device`` (``cuda`` unless the caller
    asks for the CPU) and computes in ``dtype`` (default: its parameters'
    dtype). ``ddim_steps=None`` serves the reference's ancestral DDPM chain,
    with ``fused_update=True`` (a port option, as AggregationSampler's) each
    step's update one ``ancestral_update`` call. ``start_t`` (superres only)
    truncates the chain to a warm start from the bicubic upsample. ``mesh``
    (``parallel.make_mesh``, the CLI's ``--data_parallel``) replicates the
    model onto the mesh's devices and splits each micro-batch and each
    tile's chunks over them, collective-free; ``max_batch`` divides over
    the mesh size. A float32 server turns cuDNN's TF32 off
    (``utils.ieee_float32``): its float32 is IEEE float32."""

    def __init__(self, model, noise_schedule: str, noise_steps: int, image_size: int,
                 task: str = "superres", max_batch: int = 8, max_wait_ms: float = 10.0,
                 ddim_steps: Optional[int] = None, ddim_clip_x0: bool = True, seed: int = 0,
                 dtype: Optional[torch.dtype] = None, device="cuda",
                 start_t: Optional[int] = None, fused_update: bool = False, mesh=None):
        if task not in TASKS:
            raise ValueError(f"task must be one of {tuple(TASKS)}, got {task!r}")
        if model.conditioning != TASKS[task]:
            raise ValueError(f"task={task!r} serves a {TASKS[task]!r}-conditioned model, "
                             f"got conditioning={model.conditioning!r}")
        if start_t is not None and task != "superres":
            # the warm start is the bicubic upsample of the LR condition:
            # only super-resolution has that cheap reconstruction
            raise ValueError("start_t (truncated warm-start sampling) is only available for "
                             "task='superres'")
        if fused_update and ddim_steps is not None:
            raise ValueError("fused_update applies only to DDPM ancestral sampling; "
                             "it has no effect under ddim_steps: drop one of the two")
        if mesh is not None and max_batch % mesh.size:
            raise ValueError(f"max_batch ({max_batch}) must be divisible by the mesh size "
                             f"({mesh.size}) so every device gets an equal micro-batch shard")
        self.device = resolve_device(mesh.device if mesh is not None else device)
        self.mesh = mesh
        self.task = task
        self.image_size = image_size
        self.model = model.to(self.device)
        self.max_batch = max_batch
        self.process = make_process(self.model, noise_schedule, noise_steps, image_size, dtype)
        ieee_float32(self.process.dtype)
        self._ddim_steps = ddim_steps
        self._ddim_clip_x0 = ddim_clip_x0
        self._start_t = start_t
        self._fused_update = fused_update
        cfg = CFG_SCALE if task == "generation" else None
        if ddim_steps is not None:
            self._sampler = self.process.ddim_sampler(ddim_steps, cfg_scale=cfg,
                                                      clip_x0=ddim_clip_x0, start_t=start_t,
                                                      mesh=mesh)
        else:
            self._sampler = self.process.sampler(cfg, start_t=start_t, fused_update=fused_update,
                                                 mesh=mesh)
        self._seeds = np.random.SeedSequence(seed)
        self._lock = threading.Lock()
        self._tile_lock = threading.Lock()
        self._agg: Optional[AggregationSampler] = None
        self.batches_run = 0  # micro-batches the sampler has run
        # the fixed shape every request must match, checked per request so
        # that one bad input fails alone
        if task == "superres":
            s = image_size // model.magnification_factor
            self.expected_cond_shape = (s, s, model.cond_channels)
        elif task == "sar":
            self.expected_cond_shape = (image_size, image_size, model.cond_channels)
        else:
            self.expected_cond_shape = ()
        self.num_classes = model.num_classes
        self.batcher = MicroBatcher(self._run_batch, max_batch, max_wait_ms)

    @classmethod
    def from_snapshot(cls, path: str, noise_schedule: str, noise_steps: int, image_size: int,
                      task: str = "superres", magnification_factor: int = 2,
                      num_classes: Optional[int] = 10, model_flags: Optional[dict] = None,
                      **kwargs) -> "InferenceServer":
        """A server of the weights in the snapshot at ``path`` (either format
        :func:`~diffusionremotesensing_tpu_torch.io.load_snapshot` reads): the
        UNet of ``task`` (super-resolution at ``magnification_factor``,
        SAR->NDVI, or generation with ``num_classes``) built with
        ``model_flags`` (``s2d``, ``tap44``, ``fused_att``, ``dec_block``,
        ``use_pallas``, ``packed_head``), the weights loaded strictly, then
        served as the constructor serves a model; ``kwargs`` go to it
        (``device`` is ``cuda`` unless the caller asks for the CPU)."""
        flags = model_flags or {}
        if task == "superres":
            model = residual_attention_unet_superres(magnification_factor=magnification_factor,
                                                     **flags)
        elif task == "sar":
            model = residual_attention_unet_sar_to_ndvi(**flags)
        elif task == "generation":
            model = residual_attention_unet_generation(num_classes=num_classes, **flags)
        else:
            raise ValueError(f"task must be one of {tuple(TASKS)}, got {task!r}")
        state, _ = load_snapshot(path)
        model.load_state_dict(state, strict=True)
        return cls(model.eval(), noise_schedule, noise_steps, image_size, task=task, **kwargs)

    def validate(self, cond) -> Optional[str]:
        """An error message for an invalid request, else None."""
        if self.task == "generation":
            arr = np.asarray(cond)
            if arr.shape != () or not np.issubdtype(arr.dtype, np.integer):
                return f"a generation request is one integer label, got {cond!r}"
            label = int(arr)
            if self.num_classes is not None and not 0 <= label < self.num_classes:
                return f"label {label} out of range [0, {self.num_classes})"
            return None
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
        with profiling.annotate("serve.prepare"):
            idx = list(range(n)) + [i % n for i in range(self.max_batch - n)]
            if self.task == "generation":
                cond = torch.tensor([int(conds[i]) for i in idx], dtype=torch.int64)
            else:
                cond = torch.from_numpy(np.stack([np.asarray(conds[i], np.float32) for i in idx]))
            cond = cond.to(self.device)
            gen = self._next_generator()
            if self._start_t is not None:
                init = upsample_bicubic(cond, self.model.magnification_factor)
                x_T = warm_start_state(self.process.schedule, init, self._start_t, gen)
            else:
                x_T = torch.randn((self.max_batch, self.image_size, self.image_size,
                                   self.model.image_channels), generator=gen, device=self.device)
        out = self._sampler(x_T, cond, generator=gen)
        with profiling.annotate("serve.copy_out"):
            out = out.clamp(0.0, 1.0).cpu().numpy()
        with self._lock:
            self.batches_run += 1
        return [out[i] for i in range(n)]

    def infer_batch(self, conds: List[np.ndarray], timeout: Optional[float] = 600) -> List[np.ndarray]:
        """Submit every condition (image or label) and collect the results
        (they may share one micro-batch). An invalid request raises
        ValueError before any is submitted."""
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
        half of it). Tile requests run one at a time. Super-resolution only."""
        return self.infer_tiles([lr_img])[0]

    def infer_tiles(self, lr_imgs: List[np.ndarray]) -> List[np.ndarray]:
        """``infer_tile`` of several LR images in one call: their patches are
        denoised together, so a sampler chunk holds patches of several
        tiles; ``infer_tile(img)`` is ``infer_tiles([img])[0]``."""
        if self.task != "superres":
            raise ValueError("infer_tile is only available for task='superres'")
        p = self.expected_cond_shape[0]
        imgs = [np.asarray(img, np.float32) for img in lr_imgs]
        for img in imgs:
            if img.ndim != 3 or img.shape[2] != self.model.cond_channels or min(img.shape[:2]) < p:
                raise ValueError(f"tile must be (H>={p}, W>={p}, {self.model.cond_channels}), "
                                 f"got {tuple(img.shape)}")
        with self._tile_lock:
            if self._agg is None:
                self._agg = AggregationSampler(
                    self.process, patch_size=p, stride=p // 2,
                    magnification_factor=self.model.magnification_factor,
                    ddim_steps=self._ddim_steps, ddim_clip_x0=self._ddim_clip_x0,
                    fused_update=self._fused_update, start_t=self._start_t, mesh=self.mesh)
            return self._agg.sample_tiles(imgs, generator=self._next_generator(),
                                          device=self.device)

    def warmup(self):
        """Run one request before accepting traffic."""
        if self.task == "generation":
            self.infer_batch([0])
        else:
            self.infer_batch([np.zeros(self.expected_cond_shape, np.float32)])

    def shutdown(self):
        """Stop the micro-batching worker; queued requests fail."""
        self.batcher.shutdown()

    # ----------------------------------------------------------- HTTP layer

    def serve(self, host: str = "0.0.0.0", port: int = 8000, warmup: bool = True):
        """Blocking stdlib HTTP server (threaded; requests micro-batch)."""
        server = self.make_http_server(host, port, warmup=warmup)
        print(f"serving {self.task} on {host}:{port}")
        server.serve_forever()

    def make_http_server(self, host: str = "127.0.0.1", port: int = 0, warmup: bool = False):
        """A ``ThreadingHTTPServer`` (not yet serving): GET /healthz; POST
        the task's path (/superres, /sar_to_ndvi, /generate) with
        {"image": base64 PNG} or {"label": n}, and /superres_tile. 400 for a
        missing field, a bad shape or label, 404 for a path the task does
        not serve, 500 with "Type: message"; answers {"image": base64 PNG}."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        if warmup:
            self.warmup()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _reply(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, {"status": "ok", "task": outer.task})
                else:
                    self._reply(404, {"error": "unknown path"})

            _PATH_TASK = {"/superres": "superres", "/sar_to_ndvi": "sar", "/generate": "generation"}

            def do_POST(self):
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(length) or b"{}")
                    if self.path == "/superres_tile":
                        if outer.task != "superres":
                            self._reply(404, {"error": "tile endpoint requires task=superres"})
                            return
                        if "image" not in req:
                            self._reply(400, {"error": "missing required field 'image'"})
                            return
                        try:
                            out = outer.infer_tile(_decode_image(req["image"]))
                        except ValueError as e:
                            self._reply(400, {"error": str(e)})
                            return
                        self._reply(200, {"image": _encode_image(out)})
                        return
                    if self._PATH_TASK.get(self.path) != outer.task:
                        self._reply(404, {"error": f"path {self.path} not served by task {outer.task}"})
                        return
                    field = "label" if outer.task == "generation" else "image"
                    if field not in req:
                        self._reply(400, {"error": f"missing required field {field!r}"})
                        return
                    if outer.task == "generation":
                        # int() refuses lists, None and non-numeric strings;
                        # np.int32 refuses what overflows it: client errors
                        try:
                            cond = np.int32(int(req["label"]))
                        except (TypeError, ValueError, OverflowError):
                            self._reply(400, {"error": "field 'label' must be an integer"})
                            return
                    else:
                        cond = _decode_image(req["image"])
                    err = outer.validate(cond)
                    if err is not None:
                        self._reply(400, {"error": err})
                        return
                    out = outer.batcher.infer(cond, timeout=600)
                    self._reply(200, {"image": _encode_image(out)})
                except Exception as e:  # noqa: BLE001 - the client gets the error
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        return ThreadingHTTPServer((host, port), Handler)


def _decode_image(b64: str) -> np.ndarray:
    """base64 image -> (H, W, C) float32 in [0, 1]: PNG by the port's codec
    (16-bit samples over 65535), any other format through PIL."""
    data = base64.b64decode(b64)
    if is_png(data):
        arr = decode_png(data)
        arr = arr.astype(np.float32) / (65535.0 if arr.dtype == np.uint16 else 255.0)
    else:
        import io

        Image = require_pil("decoding a non-PNG request image", "PNG images")
        arr = np.asarray(Image.open(io.BytesIO(data)), np.float32) / 255.0
    return arr[:, :, None] if arr.ndim == 2 else arr


def _encode_image(arr: np.ndarray) -> str:
    """(H, W, C) float in [0, 1] -> base64 8-bit PNG (one channel as grey)."""
    return base64.b64encode(
        encode_png((np.clip(arr, 0, 1) * 255).astype(np.uint8).squeeze())).decode()
