"""Bulk class-conditional synthesis: ``DiffusionProcess.sample`` with DDIM
and classifier-free guidance.

Each unit is one call for ``images_per_call`` labels cycling through the
configuration's classes (the model batch is twice that under guidance),
brought to the host clamped to [0, 1], as the generation script takes
its images. The model is what the traffic's ``model_flags`` build, in the
configuration's compute dtype on float32 parameters.

``correct``: after the window, ``check_images`` images drawn from the seed
among those completed are made again by the plain reference from the same
label and the same x_T (the generator state its call began with); the
number compared is the mean absolute gap over their pixels.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import common, weights, yardstick
from portbench.reference import sampling


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.state = weights.make(config, seed, device)
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.labels = np.arange(traffic["images_per_call"]) % config["num_classes"]

    def setup(self):
        from diffusionremotesensing_tpu_torch.diffusion import make_process

        cfg, tr = self.config, self.traffic
        model = common.program_unet(cfg, tr["model_flags"], self.state, self.device)
        self.size = tr["image_size"]
        self.process = make_process(model, cfg["noise_schedule"], cfg["noise_steps"], self.size,
                                    dtype=common.DTYPES[cfg["compute_dtype"]])
        self.calls = []  # (generator state, images)
        self._sample()
        common.sync()

    def _sample(self):
        out = self.process.sample(len(self.labels), cond=self.labels, cfg_scale=self.traffic["cfg_scale"],
                                  ddim_steps=self.traffic["ddim_steps"], ddim_clip_x0=True,
                                  generator=self.gen)
        return out.clamp(0.0, 1.0).cpu().numpy()

    def _call(self, i):
        state = self.gen.get_state()
        self.calls.append((state, self._sample()))

    def window(self, seconds: float) -> dict:
        r = common.timed_units(self._call, common.sync, seconds)
        n = r["units"] * len(self.labels)
        r.update(work=n, attempted=n, failed=0)
        return r

    def end_to_end(self, r) -> dict:
        return {"sampled_images_per_s": (r["work"] / r["seconds"], "images/s")}

    def context(self, r) -> dict:
        tr, cfg = self.traffic, self.config
        batch = 2 * len(self.labels)  # guidance: the conditioned and the unconditioned half
        flops = r["units"] * tr["ddim_steps"] * yardstick.forward_flops(
            weights.shapes_of(cfg), batch, self.size, cfg["conditioning"])
        return {"model_flops": flops, "forwards": r["units"] * tr["ddim_steps"], "batch": batch,
                "s2d_px": self.size // 2, "conditioned": False}

    def free(self):
        self.process = None

    def check(self, control: str = None) -> dict:
        """The numbers compared; with ``control`` (a reference precision) the
        reference at that precision stands in the program's place."""
        tr, cfg = self.traffic, self.config
        n = len(self.labels)
        done = [(c, j) for c in range(len(self.calls)) for j in range(n)]
        picks = [done[i] for i in common.sample_indices(self.seed, len(done), tr["check_images"], 2)]
        net = common.reference_unet(cfg, self.state)
        ah = common.schedule(cfg)
        x_T, labels, got = [], [], []
        for c, j in picks:
            state, imgs = self.calls[c]
            g = torch.Generator(device=self.device)
            g.set_state(state)
            z = torch.randn((n, self.size, self.size, cfg["image_channels"]), generator=g,
                            device=self.device)
            x_T.append(z[j])
            labels.append(int(self.labels[j]))
            got.append(imgs[j])
        lab = torch.tensor(labels, device=self.device)

        def reference(net):
            with torch.no_grad():
                return sampling.ddim(sampling.guided(net, lab, tr["cfg_scale"]), torch.stack(x_T),
                                     ah, tr["ddim_steps"]).clamp(0.0, 1.0).cpu().numpy()
        want = reference(net)
        got = np.stack(got) if control is None else reference(
            common.reference_unet(cfg, self.state, control))
        return {"image_mae": common.mean_abs_gap(got, want)}
