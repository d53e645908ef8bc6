"""Micro-batched serving: ``InferenceServer``'s ``MicroBatcher`` in process.

Open-loop Poisson arrivals at ``rate`` requests/s for the window, drawn
from the seed: round(rate x seconds) arrival times uniform over the
window and sorted (a Poisson process given its count), so every seed
offers the same number of requests; each request is one LR patch (``lr``
px) from a pool drawn
from the seed, submitted when it is due, and timed from when it was due
to when its micro-batch's answers reached the host. The server is the
serve launcher's on the card (its compute dtype, DDIM with x0 clamping,
``max_batch``, ``max_wait_ms``, the model the traffic's ``model_flags``
build) with the seed as its sampler seed. The benchmark records, around
the batcher's call into the sampler, which requests formed each
micro-batch and when it ended: that is how the batch fill is read.

``correct``: after every request has been answered, ``check_requests``
requests drawn from the seed are made again by the plain reference from
their LR patch and their x_T (their micro-batch's generator, seeded as
the server seeds it, and their row); the number compared is the mean
absolute gap over their pixels.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from portbench import common, weights, yardstick
from portbench.reference import sampling


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.state = weights.make(config, seed, device)
        rng = np.random.default_rng([seed, 1])
        s, c = traffic["lr"], config["image_channels"]
        self.pool = rng.random((traffic["pool"], s, s, c), dtype=np.float32)
        self.rng = np.random.default_rng([seed, 3])
        self.server_seed = seed

    def setup(self):
        from diffusionremotesensing_tpu_torch.serving import InferenceServer

        cfg, tr = self.config, self.traffic
        model = common.program_unet(cfg, tr["model_flags"], self.state, self.device)
        self.hr = tr["lr"] * cfg["magnification_factor"]
        self.server = InferenceServer(
            model, cfg["noise_schedule"], cfg["noise_steps"], self.hr, task="superres",
            max_batch=tr["max_batch"], max_wait_ms=tr["max_wait_ms"],
            ddim_steps=tr["ddim_steps"], ddim_clip_x0=True, seed=self.server_seed,
            dtype=common.DTYPES[cfg["compute_dtype"]], device=self.device)
        self.batches = []  # (the requests' ids, time the answers reached the host)
        self._lock = threading.Lock()
        run = self.server.batcher._run_batch

        def recorded(items):
            outs = run([x for _, x in items])
            with self._lock:
                self.batches.append(([i for i, _ in items], time.perf_counter()))
            return outs

        self.server.batcher._run_batch = recorded
        self.server.batcher.infer((-1, self.pool[0]), timeout=600)  # the window's one shape
        common.sync()

    def window(self, seconds: float) -> dict:
        tr = self.traffic
        due = np.sort(self.rng.uniform(0.0, seconds, size=int(round(tr["rate"] * seconds))))
        which = self.rng.integers(0, len(self.pool), size=len(due))
        handles = []
        t0 = time.perf_counter()
        late = 0.0
        for i, (d, k) in enumerate(zip(due, which)):
            wait = t0 + d - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            else:
                late = max(late, -wait)
            handles.append(self.server.batcher.submit((i, self.pool[k])))
        self.outputs, failed = {}, 0
        for i, h in enumerate(handles):
            r = h.get(timeout=600)
            if isinstance(r, Exception):
                failed += 1
            else:
                self.outputs[i] = r
        with self._lock:
            ended = {i: t for ids, t in self.batches for i in ids}
            fills = [len(ids) for ids, _ in self.batches if ids and ids[0] >= 0]
        lat = np.array([ended[i] - (t0 + d) for i, d in enumerate(due) if i in ended])
        self.which = which
        return {"units": len(due), "work": len(due), "attempted": len(due), "failed": failed,
                "seconds": max(ended.values()) - t0, "latency": lat, "late_s": late,
                "fills": fills}

    def end_to_end(self, r) -> dict:
        return {"request_p95_s": (float(np.percentile(r["latency"], 95)), "s")}

    def context(self, r) -> dict:
        cfg, tr = self.config, self.traffic
        n = len(r["fills"])
        # the model's work is the requests' rows; the pad rows up to
        # max_batch are the kernels' (kernel_roofline's batch), not the model's
        flops = tr["ddim_steps"] * yardstick.forward_flops(
            weights.shapes_of(cfg), sum(r["fills"]), self.hr, cfg["conditioning"],
            cfg["magnification_factor"])
        return {"model_flops": flops, "forwards": n * tr["ddim_steps"], "batch": tr["max_batch"],
                "s2d_px": self.hr // 2, "conditioned": True,
                "batch_fill": float(np.mean(r["fills"])) / tr["max_batch"] if n else None}

    def free(self):
        self.server.shutdown()
        self.server = None

    def check(self, control: str = None) -> dict:
        """The numbers compared; with ``control`` (a reference precision) the
        reference at that precision stands in the program's place."""
        tr, cfg = self.traffic, self.config
        picks = common.sample_indices(self.seed, len(self.outputs), tr["check_requests"], 2)
        ids = sorted(self.outputs)
        picks = [ids[i] for i in picks]
        order = {}  # request -> (its micro-batch's number among the server's calls, row)
        for k, (members, _) in enumerate(self.batches):
            for row, i in enumerate(members):
                order[i] = (k, row)
        x_T = []
        for i in picks:
            k, row = order[i]
            seed = int(np.random.SeedSequence(self.server_seed, spawn_key=(k,))
                       .generate_state(1, np.uint64)[0] >> 1)
            g = torch.Generator(device=self.device).manual_seed(seed)
            z = torch.randn((tr["max_batch"], self.hr, self.hr, cfg["image_channels"]),
                            generator=g, device=self.device)
            x_T.append(z[row])
        cond = torch.from_numpy(np.stack([self.pool[self.which[i]] for i in picks])).to(self.device)

        def reference(q):
            net = common.reference_unet(cfg, self.state, q)
            with torch.no_grad():
                return sampling.ddim(lambda x, t: net(x, t, cond), torch.stack(x_T),
                                     common.schedule(cfg), tr["ddim_steps"]).clamp(0.0, 1.0)
        want = reference("float32").cpu().numpy()
        got = (np.stack([self.outputs[i] for i in picks]) if control is None
               else reference(control).cpu().numpy())
        return {"request_mae": common.mean_abs_gap(got, want)}
