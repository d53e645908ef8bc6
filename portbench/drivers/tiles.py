"""Scene super-resolution through ``AggregationSampler.sample_tiles``.

Each unit is one call over ``tiles_per_call`` LR tiles of ``tile_lr`` px
(the patches of every tile denoised together in chunks of ``batch_size``,
``AggregationSampler.MAX_IN_FLIGHT`` chunks ahead, each chunk blended into
its tiles as it is gathered), the tiles cycling through a pool drawn from
the seed. The sampler is the aggregation launcher's (patch, stride, DDIM
with x0 clamping) over the model the traffic's ``model_flags`` build, in
the configuration's compute dtype on float32 parameters.

``correct``: after the window, ``check_tiles`` tiles drawn from the seed
among those completed are made again by the plain reference from the same
LR tile and the same x_T (the generator state the call began with,
replayed chunk by chunk) and blended; ``tile_mae`` is the largest of their
mean absolute gaps over the pixels. With random weights the x0 clamp holds
most pixels at 0 or 1, so a forward that is a little wrong barely moves
that: ``eps_gap`` judges the forward itself, before any clamp. The
benchmark keeps the first model output of every call (chunk 0 at the
first DDIM step, the hand kernels at the timed batch); for one call drawn
from the seed the reference computes it again from the same x_T, t and LR
patches, and ``eps_gap`` is the norm of the difference over the norm of
the reference's output.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import common, weights, yardstick
from portbench.reference import blend, sampling


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.state = weights.make(config, seed, device)
        rng = np.random.default_rng([seed, 1])
        n, s, c = traffic["pool"], traffic["tile_lr"], config["image_channels"]
        self.pool = rng.random((n, s, s, c), dtype=np.float32)
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def setup(self):
        from diffusionremotesensing_tpu_torch.aggregation import AggregationSampler
        from diffusionremotesensing_tpu_torch.diffusion import make_process

        cfg, tr = self.config, self.traffic
        model = common.program_unet(cfg, tr["model_flags"], self.state, self.device)
        self.patch = tr["patch_size"]
        self.hr = self.patch * cfg["magnification_factor"]
        self.process = make_process(model, cfg["noise_schedule"], cfg["noise_steps"], self.hr,
                                    dtype=common.DTYPES[cfg["compute_dtype"]])
        self.sampler = AggregationSampler(
            self.process, patch_size=self.patch, stride=tr["stride"],
            magnification_factor=cfg["magnification_factor"], batch_size=tr["batch_size"],
            ddim_steps=tr["ddim_steps"], ddim_clip_x0=True)
        self.calls = []  # (generator state, pool indices, outputs, first model output)
        net = self.process.net
        forward = net.forward
        self._first = []  # the armed call's first model output

        def recorded(*a, **kw):
            out = forward(*a, **kw)
            if not self._first:
                self._first.append(out.detach().clone())
            return out

        net.forward = recorded
        # one chunk of the window's shape
        warm = max(1, tr["batch_size"] // self.patches_per_tile())
        self.sampler.sample_tiles([self.pool[i] for i in range(warm)], generator=self.gen,
                                  device=self.device)
        common.sync()

    def patches_per_tile(self) -> int:
        return len(blend.windows(self.traffic["tile_lr"], self.patch, self.traffic["stride"]))

    def _call(self, i):
        tr = self.traffic
        k = tr["tiles_per_call"]
        idx = [(i * k + j) % len(self.pool) for j in range(k)]
        state = self.gen.get_state()
        self._first.clear()
        outs = self.sampler.sample_tiles([self.pool[j] for j in idx], generator=self.gen,
                                         device=self.device)
        self.calls.append((state, idx, outs, self._first[0]))

    def window(self, seconds: float) -> dict:
        r = common.timed_units(self._call, common.sync, seconds)
        tiles = r["units"] * self.traffic["tiles_per_call"]
        r.update(work=tiles, attempted=tiles, failed=0)
        return r

    def end_to_end(self, r) -> dict:
        return {"tiles_per_s": (r["work"] / r["seconds"], "tiles/s")}

    def context(self, r) -> dict:
        tr, cfg = self.traffic, self.config
        n_patches = r["work"] * self.patches_per_tile()
        forwards = r["units"] * tr["ddim_steps"] * (-(-tr["tiles_per_call"] * self.patches_per_tile()
                                                       // tr["batch_size"]))
        flops = tr["ddim_steps"] * yardstick.forward_flops(
            weights.shapes_of(cfg), n_patches, self.hr, cfg["conditioning"],
            cfg["magnification_factor"])
        return {"model_flops": flops, "forwards": forwards, "batch": tr["batch_size"],
                "s2d_px": self.hr // 2, "conditioned": True}

    def free(self):
        self.sampler = self.process = None

    def check(self, control: str = None) -> dict:
        """The numbers compared; with ``control`` (a reference precision) the
        reference at that precision stands in the program's place."""
        tr, cfg = self.traffic, self.config
        done = [(c, j) for c in range(len(self.calls)) for j in range(tr["tiles_per_call"])]
        picks = [done[i] for i in common.sample_indices(self.seed, len(done), tr["check_tiles"], 2)]
        net = common.reference_unet(cfg, self.state)
        low = None if control is None else common.reference_unet(cfg, self.state, control)
        ah = common.schedule(cfg)
        gaps = []
        for c, j in picks:
            state, idx, outs = self.calls[c][:3]
            x_T, cond = self._inputs(state, idx, j)
            want = self._reference(net, cond, x_T, ah)
            got = outs[j] if control is None else self._reference(low, cond, x_T, ah)
            gaps.append(common.mean_abs_gap(got, want))
        # the first model output of a call drawn from the seed: its chunk 0
        (c,) = common.sample_indices(self.seed, len(self.calls), 1, 3)
        state, idx, _, first = self.calls[c]
        n = first.shape[0]
        x_T, cond = self._inputs(state, idx, 0, n)
        t = torch.full((n,), float(sampling.ddim_timesteps(len(ah), tr["ddim_steps"])[0]),
                       device=self.device)
        with torch.no_grad():
            want = net(x_T, t, cond).double()
            got = (self._layout(first).double() if control is None
                   else low(x_T, t, cond).double())
        eps_gap = float((got - want).norm() / want.norm())
        return {"tile_mae": max(gaps), "eps_gap": eps_gap}

    def _inputs(self, state, idx, j, n=None):
        """x_T and the LR patches of ``n`` patches (a tile's, by default) from
        the call's tile j on, the call's draws replayed chunk by chunk from
        its generator ``state``."""
        tr, cfg = self.traffic, self.config
        ppt, b = self.patches_per_tile(), tr["batch_size"]
        n = n or ppt
        first = j * ppt
        g = torch.Generator(device=self.device)
        g.set_state(state)
        total = tr["tiles_per_call"] * ppt
        for start in range(0, total, b):
            k = min(b, total - start)
            z = torch.randn((k, self.hr, self.hr, cfg["image_channels"]), generator=g,
                            device=self.device)
            if start <= first < start + k:
                x_T = z[first - start:first - start + n]
                break
        boxes = blend.windows(tr["tile_lr"], self.patch, tr["stride"])
        p = self.patch
        cond = np.stack([self.pool[idx[q // ppt]][y:y + p, x:x + p]
                         for q in range(first, first + n) for y, x in [boxes[q % ppt]]])
        return x_T, torch.from_numpy(cond).to(self.device)

    def _layout(self, out):
        """The program's model output (B, H, W, C), from its space-to-depth
        layout (B, H/2, W/2, 4C: sub-pixels (0,0), (0,1), (1,0), (1,1)) where
        it runs so."""
        b, h, w, c4 = out.shape
        if h == self.hr:
            return out
        c = c4 // 4
        return out.reshape(b, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, c)

    def _reference(self, net, cond, x_T, ah):
        tr = self.traffic
        with torch.no_grad():
            x0 = sampling.ddim(lambda x, t: net(x, t, cond), x_T, ah, tr["ddim_steps"])
        return blend.blend(x0.cpu().numpy(), tr["tile_lr"], self.patch, tr["stride"],
                           self.config["magnification_factor"])
