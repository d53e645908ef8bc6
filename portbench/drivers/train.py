"""The flagship super-resolution recipe through ``Trainer.train_step``.

A pool of ``pool`` HR uint8 images of ``hr`` px, drawn from the seed,
lives on the card; each step takes ``batch`` of them (rows drawn from the
seed), runs the trainer's batch transform (the DownBlur on the device),
and one ``train_step`` with t and the noise drawn on the card from the
seed. Steps are dispatched ahead: nothing inside the window waits for the
card, and the losses are read once it has closed. The trainer's step
counter starts at the EMA's warm-up (2000 steps), as nearly every step of
a real run is past it: every step of the window and of the check runs the
EMA's decay, not its warm-up copy. Adam's moments start fresh.

``correct``: set-up builds the trainer and takes its first three steps
through the window's own call and feed, on rows that all differ, and
keeps what the check reads: each step's loss, each leaf's gradient norm
as Adam got it (its first moment after one step over 1 - beta1), and each
leaf's change and its EMA's change after the three. The plain reference
follows the same three steps from the same weights and inputs after the
window. Compared: each step's loss gap over the reference's loss; the
gradient by the median leaf, the changes by the worst leaf: the gap of
norms over the reference's norm of that leaf or of the median leaf,
whichever is larger (the worst leaf's gradient gap is the round-off of
the leaves with the smallest gradients, in the program and in the
control alike, and swings from seed to seed)
(leaves whose reference gradient is under a thousandth of the median
leaf's, as a convolution's bias before a batch-statistic BatchNorm, have
a gradient of round-off alone, move by it under Adam, and are left out).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import common, weights, yardstick
from portbench.reference import precision
from portbench.reference import train as rtrain
from portbench.reference.unet import trainable

CHECK_STEPS = 3


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.state0 = weights.make(config, seed, device)
        g = torch.Generator(device=device).manual_seed(seed + 1)
        hr, c = traffic["hr"], config["image_channels"]
        self.pool = torch.randint(0, 256, (traffic["pool"], hr, hr, c), generator=g,
                                  device=device, dtype=torch.uint8)
        self.gen = g
        self.ah = common.schedule(config)

    def _feed(self, i):
        """Step i's batch, t and noise, drawn on the card (rows of the first
        pool // batch steps all differ)."""
        b = self.traffic["batch"]
        n = self.pool.shape[0]
        rows = (torch.arange(b, device=self.device) + i * b) % n
        t = torch.randint(1, self.config["noise_steps"], (b,), generator=self.gen,
                          device=self.device)
        noise = torch.randn((b, self.traffic["hr"], self.traffic["hr"],
                             self.config["image_channels"]), generator=self.gen,
                            device=self.device)
        return {"hr_u8": self.pool[rows]}, t, noise

    def setup(self):
        from diffusionremotesensing_tpu_torch.data.device_degradation import make_downblur_transform
        from diffusionremotesensing_tpu_torch.train import Trainer

        cfg, tr = self.config, self.traffic
        model = common.program_unet(cfg, tr["model_flags"], self.state0, self.device,
                                    compute_dtype=common.DTYPES[cfg["compute_dtype"]])
        transform = make_downblur_transform(tr["hr"], cfg["magnification_factor"],
                                            cfg["train"]["blur_radius"])
        self.trainer = Trainer(model, cfg["noise_schedule"], cfg["noise_steps"], tr["hr"],
                               lr=cfg["train"]["lr"], loss=cfg["train"]["loss"],
                               ema_smoothing=cfg["train"]["ema_smoothing"],
                               batch_transform=transform, seed=self.seed, device=self.device)
        self.ts = self.trainer.init_state()
        self.ts.step = cfg["train"]["ema_warmup_steps"]
        names = trainable(weights.shapes_of(cfg))
        params = dict(self.ts.model.named_parameters())
        self.names = [n for n in names if n in params]
        p0 = {n: params[n].detach().clone() for n in self.names}
        self.feed0, losses = [], []
        for i in range(CHECK_STEPS):
            self.feed0.append(self._feed(i))
            losses.append(self._step(*self.feed0[-1]))
            if i == 0:
                opt = self.ts.optimizer
                # a leaf Adam holds no moment for got no gradient: norm 0
                m1 = [opt.state[params[n]].get("exp_avg", torch.zeros(())) for n in self.names]
                self.grad_norms = torch.stack([m.norm().to(self.device) for m in m1]) / (
                    1 - rtrain.BETAS[0])
        self.losses = torch.stack(losses).cpu().numpy()
        ema = dict(zip([n for n, _ in self.ts.model.named_parameters()], self.ts.ema_params))
        self.change = torch.stack([(params[n].detach() - p0[n]).norm() for n in self.names])
        self.ema_change = torch.stack([(ema[n] - p0[n]).norm() for n in self.names])
        self.grad_norms, self.change, self.ema_change = (
            x.cpu().numpy() for x in (self.grad_norms, self.change, self.ema_change))
        self.step_no = CHECK_STEPS
        common.sync()

    def _step(self, batch, t, noise):
        b = self.trainer.batch_transform(batch)
        return self.trainer.train_step(self.ts, b, t=t, noise=noise)

    def _unit(self, i):
        self.window_losses.append(self._step(*self._feed(self.step_no)))
        self.step_no += 1

    def window(self, seconds: float) -> dict:
        self.window_losses = []
        r = common.timed_units(self._unit, common.sync, seconds)
        losses = torch.stack(self.window_losses).cpu().numpy()
        n = r["units"] * self.traffic["batch"]
        r.update(work=n, attempted=r["units"], failed=int((~np.isfinite(losses)).sum()))
        return r

    def end_to_end(self, r) -> dict:
        return {"train_images_per_s": (r["work"] / r["seconds"], "images/s")}

    def context(self, r) -> dict:
        cfg, tr = self.config, self.traffic
        flops = 3 * r["units"] * yardstick.forward_flops(
            weights.shapes_of(cfg), tr["batch"], tr["hr"], cfg["conditioning"],
            cfg["magnification_factor"])
        return {"model_flops": flops, "forwards": r["units"], "batch": tr["batch"]}

    def free(self):
        self.trainer = self.ts = None

    def _reference(self, q):
        cfg = self.config
        feed = [{"hr_u8": b["hr_u8"], "t": t, "noise": z} for b, t, z in self.feed0]
        losses, grads, params, ema = rtrain.steps(
            self.state0, weights.shapes_of(cfg), feed, self.ah, cfg["train"]["lr"],
            cfg["magnification_factor"], cfg["train"]["blur_radius"], precision.PRECISIONS[q],
            step0=cfg["train"]["ema_warmup_steps"], beta=cfg["train"]["ema_beta"])
        return (np.array(losses), np.array([float(grads[n].norm()) for n in self.names]),
                np.array([float((params[n] - self.state0[n]).norm()) for n in self.names]),
                np.array([float((ema[n] - self.state0[n]).norm()) for n in self.names]))

    def check(self, control: str = None) -> dict:
        """The numbers compared; with ``control`` (a reference precision) the
        reference at that precision stands in the program's place."""
        precision.ieee_float32()
        ref_l, ref_g, ref_c, ref_e = self._reference("float32")
        got_l, got_g, got_c, got_e = ((self.losses, self.grad_norms, self.change, self.ema_change)
                                      if control is None else self._reference(control))
        moved = ref_g >= 1e-3 * np.median(ref_g)
        return {"loss_gap": float(np.max(np.abs(got_l - ref_l) / np.abs(ref_l))),
                "grad_gap_median": median_leaf(got_g[moved], ref_g[moved]),
                "change_gap": worst_leaf(got_c[moved], ref_c[moved]),
                "ema_gap": worst_leaf(got_e[moved], ref_e[moved])}


def _leaf_gaps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    return np.abs(got - want) / np.maximum(want, np.median(want))


def worst_leaf(got: np.ndarray, want: np.ndarray) -> float:
    """max over leaves of |got - want| / max(want, median(want))."""
    return float(np.max(_leaf_gaps(got, want)))


def median_leaf(got: np.ndarray, want: np.ndarray) -> float:
    """The median over leaves of |got - want| / max(want, median(want))."""
    return float(np.median(_leaf_gaps(got, want)))
