"""Aggregation sampling: tiled super-resolution of large images (port of
``diffusionremotesensing_tpu/aggregation.py``).

The LR image is cut into overlapping patches, the patch set is denoised as
a batch axis in chunks of ``batch_size`` per replica, and the
super-resolved patches are blended into the canvas with Gaussian weights as
each chunk comes back. With a ``mesh`` (``parallel.make_mesh``) the patch
axis of each chunk is split over its replicas, collective-free within a
process (``diffusion``'s split samplers), the last chunk padded to a
multiple of the mesh size by wrapping around the patch list, as in the JAX
package. The noise of a chunk is drawn for its real patches alone (the pad
rows repeat it), so a tile does not depend on the mesh it was split over.
Reference semantics kept: the edge-clamped, de-duplicated patch grid; the
Gaussian weights' var = 0.01 and asymmetric midpoints (x: (w-1)/2,
y: h/2); the canvas sum(w*patch)/sum(w), clamped to [0, 1].
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from diffusionremotesensing_tpu_torch import profiling
from diffusionremotesensing_tpu_torch.diffusion import DiffusionProcess, warm_start_state
from diffusionremotesensing_tpu_torch.ops.resize import upsample_bicubic


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """x's rows repeated, wrapping around, to n rows."""
    return x if x.shape[0] == n else x[torch.arange(n, device=x.device) % x.shape[0]]


def patchify_coords(height: int, width: int, patch_size: int, stride: Optional[int],
                    magnification_factor: int = 1) -> List[Tuple[int, int, int, int]]:
    """Overlapping patch grid as de-duplicated HR boxes (y0, y1, x0, x1)."""
    if stride is None:
        stride = patch_size
    if stride > patch_size:
        raise ValueError("stride must be <= patch_size")
    infos, seen = [], set()
    for y in range(0, height + 1, stride):
        for x in range(0, width + 1, stride):
            y0 = min(y, height - patch_size)
            x0 = min(x, width - patch_size)
            box = (y0 * magnification_factor, (y0 + patch_size) * magnification_factor,
                   x0 * magnification_factor, (x0 + patch_size) * magnification_factor)
            if box not in seen:
                seen.add(box)
                infos.append(box)
    return infos


def gaussian_weights(tile_width: int, tile_height: int) -> np.ndarray:
    """(h, w) Gaussian blend mask with the reference's midpoints and var."""
    var = 0.01
    mx = (tile_width - 1) / 2
    x = np.arange(tile_width, dtype=np.float64)
    x_probs = np.exp(-((x - mx) ** 2) / (tile_width ** 2) / (2 * var)) / math.sqrt(2 * math.pi * var)
    my = tile_height / 2
    y = np.arange(tile_height, dtype=np.float64)
    y_probs = np.exp(-((y - my) ** 2) / (tile_height ** 2) / (2 * var)) / math.sqrt(2 * math.pi * var)
    return np.outer(y_probs, x_probs).astype(np.float32)


_SQUARE_SIZES = (64, 128, 256, 512, 1024, 2048, 4096, 8192, 10000)


def squarify_sizes(width: int, height: int) -> int:
    """Nearest canonical square size for non-square inputs."""
    target = max(width, height)
    return min(_SQUARE_SIZES, key=lambda s: abs(s - target))


class AggregationSampler:
    """Chunked tiled super-resolution through a :class:`DiffusionProcess`
    (whose image_size is patch_size * magnification_factor). DDPM sampling
    (``ddim_steps=None``) takes ``fused_update=True`` to run each step's
    update as one ``ancestral_update`` kernel call; DDIM takes ``ddim_eta``
    and ``ddim_spacing`` ('linear' or 'quadratic'). ``start_t`` starts each
    patch from its bicubic upsample q-sampled to t = start_t and runs only
    the steps below it (DDIM squeezes its subsequence into [1, start_t]).
    ``mesh`` splits each chunk over its replicas; ``batch_size`` is then
    per replica, as in the JAX package."""

    MAX_IN_FLIGHT = 4  # chunks enqueued on the device before the oldest is gathered

    def __init__(self, process: DiffusionProcess, patch_size: int, stride: int,
                 magnification_factor: int, batch_size: int = 48,
                 ddim_steps: Optional[int] = None, ddim_clip_x0: bool = True,
                 fused_update: bool = False, start_t: Optional[int] = None,
                 ddim_eta: float = 0.0, ddim_spacing: str = "linear", mesh=None):
        if stride > patch_size:
            raise ValueError("stride must be <= patch_size")
        if fused_update and ddim_steps is not None:
            # the fused kernel is the ancestral update: under DDIM the flag
            # would select nothing, so the combination is refused
            raise ValueError("fused_update applies only to DDPM ancestral sampling; "
                             "it has no effect under ddim_steps: drop one of the two")
        self.process = process
        self.patch_size = patch_size
        self.stride = stride
        self.mag = magnification_factor
        self.batch_size = batch_size
        self.ddim_steps = ddim_steps
        self.ddim_clip_x0 = ddim_clip_x0
        self.ddim_eta = ddim_eta
        self.ddim_spacing = ddim_spacing
        self.fused_update = fused_update
        self.start_t = start_t
        self.mesh = mesh
        self.n_devices = 1 if mesh is None else mesh.size
        hr = patch_size * magnification_factor
        self.weight = gaussian_weights(hr, hr)

    def chunk_plan(self, n: int) -> List[Tuple[int, int]]:
        """(start, size) of each chunk: full chunks of batch_size x the mesh
        size, then the remainder padded to a multiple of the mesh size (its
        own size on one device)."""
        chunk = self.batch_size * self.n_devices
        plan = [(s, chunk) for s in range(0, (n // chunk) * chunk, chunk)]
        if n % chunk:
            plan.append(((n // chunk) * chunk, -(-(n % chunk) // self.n_devices) * self.n_devices))
        return plan

    def _sampler(self):
        kw = {} if self.mesh is None else {"mesh": self.mesh}
        if self.ddim_steps is not None:
            return self.process.ddim_sampler(self.ddim_steps, eta=self.ddim_eta,
                                             tau_spacing=self.ddim_spacing,
                                             clip_x0=self.ddim_clip_x0, start_t=self.start_t, **kw)
        return self.process.sampler(fused_update=self.fused_update, start_t=self.start_t, **kw)

    def extract_patches(self, img_lr: np.ndarray):
        """(H, W, C) LR in [0, 1] -> (the patches (P, p, p, C), their HR
        boxes), the patch set ``__call__`` denoises."""
        img_lr = np.asarray(img_lr, np.float32)
        h, w = img_lr.shape[:2]
        boxes = patchify_coords(h, w, self.patch_size, self.stride, self.mag)
        mag = self.mag
        patches = np.stack([img_lr[y0 // mag:y1 // mag, x0 // mag:x1 // mag]
                            for (y0, y1, x0, x1) in boxes])
        return patches, boxes

    def _sampled_chunks(self, n: int, block_fn, generator, device):
        """Denoise ``n`` patches chunk by chunk (``chunk_plan``); yields
        ``(start, out)``, the chunk's real patches' (k, hr, hr, C) output on
        the device. ``block_fn(idx)`` gives the LR patches of the patch
        indices ``idx`` (a padded chunk's wrap around); up to MAX_IN_FLIGHT
        chunks are enqueued before the oldest is yielded."""
        sampler = self._sampler()
        hr = self.patch_size * self.mag
        pending = []
        for chunk, (start, size) in enumerate(self.chunk_plan(n)):
            k = min(size, n - start)
            with profiling.annotate("aggregation.issue", chunk=chunk, rows=k):
                cond = torch.from_numpy(block_fn(np.arange(start, start + size) % n)).to(device)
                c = cond.shape[-1]
                if self.start_t is not None:
                    # warm start: each patch's bicubic upsample q-sampled to start_t
                    init = upsample_bicubic(cond, self.mag)
                    eps = torch.randn((k,) + tuple(init.shape[1:]), generator=generator,
                                      device=device)
                    x_T = warm_start_state(self.process.schedule, init, self.start_t,
                                           noise=_pad_rows(eps, size))
                else:
                    x_T = _pad_rows(torch.randn((k, hr, hr, c), generator=generator,
                                                device=device), size)
                kw = {}
                if k < size and not self.fused_update:
                    # the pad rows repeat the real patches' noise
                    kw["noise_fn"] = lambda i, shape, k=k: _pad_rows(
                        torch.randn((k,) + tuple(shape[1:]), generator=generator, device=device),
                        shape[0])
                pending.append((start, k, sampler(x_T, cond, generator=generator, **kw)))
            if len(pending) >= self.MAX_IN_FLIGHT:
                s, k, out = pending.pop(0)
                yield s, out[:k]
        for s, k, out in pending:
            yield s, out[:k]

    def sample_patches(self, patches: np.ndarray, generator: Optional[torch.Generator] = None,
                       device="cuda") -> np.ndarray:
        """Denoise (P, p, p, C) LR patches -> (P, hr, hr, C), chunked as
        ``__call__`` chunks them and drawing the same noise in the same
        order from ``generator``."""
        patches = np.asarray(patches, np.float32)
        outs = [out.cpu().numpy() for _, out in self._sampled_chunks(
            len(patches), lambda idx: patches[idx], generator, device)]
        return np.concatenate(outs, axis=0)

    def sample_tiles(self, imgs: List[np.ndarray], generator: Optional[torch.Generator] = None,
                     device="cuda") -> List[np.ndarray]:
        """Several (H, W, C) LR images in [0, 1] at once -> their (H*mag,
        W*mag, C) super-resolutions in [0, 1]: the patches of every image
        denoised together in chunks of ``batch_size`` (one image's patches
        are drawn as ``__call__`` draws them), each chunk blended into its
        images' canvases as it is gathered."""
        with profiling.annotate("aggregation.call", tiles=len(imgs)):
            return self._sample_tiles(imgs, generator, device)

    def _sample_tiles(self, imgs, generator, device):
        with profiling.annotate("aggregation.prepare"):
            imgs = [np.asarray(img, np.float32) for img in imgs]
            mag = self.mag
            index = [(k, box) for k, img in enumerate(imgs)
                     for box in patchify_coords(img.shape[0], img.shape[1], self.patch_size,
                                                self.stride, mag)]
            canvases = [np.zeros((img.shape[0] * mag, img.shape[1] * mag, img.shape[2]),
                                 np.float32) for img in imgs]
            counts = [np.zeros(c.shape[:2] + (1,), np.float32) for c in canvases]
            wmask = self.weight[:, :, None]

        def block(idx):
            return np.stack([imgs[k][y0 // mag:y1 // mag, x0 // mag:x1 // mag]
                             for k, (y0, y1, x0, x1) in (index[i] for i in idx)])

        per_chunk = self.batch_size * self.n_devices
        for start, out in self._sampled_chunks(len(index), block, generator, device):
            chunk, rows = start // per_chunk, len(out)
            with profiling.annotate("aggregation.wait", chunk=chunk, rows=rows) as span:
                if span and out.is_cuda:  # recording: the copy below then times the copy alone
                    torch.cuda.current_stream(out.device).synchronize()
            with profiling.annotate("aggregation.copy_out", chunk=chunk, rows=rows):
                patches = out.cpu().numpy()
            with profiling.annotate("aggregation.blend", chunk=chunk, rows=rows):
                for patch, (k, (y0, y1, x0, x1)) in zip(patches, index[start:start + len(out)]):
                    canvases[k][y0:y1, x0:x1] += patch * wmask
                    counts[k][y0:y1, x0:x1] += wmask
        with profiling.annotate("aggregation.finish"):
            if not all((n != 0).all() for n in counts):
                raise RuntimeError("patch grid left output pixels uncovered")
            return [np.clip(c / n, 0.0, 1.0) for c, n in zip(canvases, counts)]

    def __call__(self, img_lr: np.ndarray, generator: Optional[torch.Generator] = None,
                 device="cuda") -> np.ndarray:
        """(H, W, C) LR in [0, 1] -> (H*mag, W*mag, C) in [0, 1]. Patches are
        extracted one chunk at a time and each chunk is blended as it is
        gathered; up to MAX_IN_FLIGHT chunks are enqueued ahead."""
        return self.sample_tiles([img_lr], generator, device)[0]
