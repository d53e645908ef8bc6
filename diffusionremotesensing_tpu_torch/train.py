"""The training engine: one train step, one host loop, all three tasks (port
of ``diffusionremotesensing_tpu/train.py``).

What a step computes, as the reference does:

* t ~ U[1, T), noise ~ N(0, I), x_t = q_sample(x0, t, noise);
* the model's training forward (``train=True``: batch-statistic
  BatchNorms, running statistics moved the flax way, no hand kernel), the
  loss of its eps prediction against the noise (``pad_mask`` weighting
  wrap-padded rows out), the gradients by autograd;
* Adam (``torch.optim.Adam``, betas (0.9, 0.999), eps 1e-8, constant lr:
  optax's ``adam`` update), every parameter given a gradient (the unused
  skip convs a zero one, as the reference's autodiff gives them);
* the EMA of the parameters (beta 0.995 after a 2000-step warm-up copy,
  ``ema_smoothing``), which snapshots, validation and previews use.

The loop: class-conditional label dropout (with probability
``label_dropout`` the whole batch is trained unconditioned; drawn on the
host from ``numpy.random.default_rng(seed)``, train batches only); a
snapshot every ``check_preds_epoch`` epochs without a validation loader, else
on each validation improvement, with early stopping after ``patience``
epochs without one; ``epochs_run`` resume from the snapshot, which restarts
Adam's moments (the reference does not checkpoint them); SIGTERM and SIGINT
snapshot and stop at the next batch boundary. ``steps_per_dispatch`` K moves
K stacked batches to the device at once and then takes their K steps in the
same order as K = 1 would, flushing early when the batch's fields or shapes
change. ``batch_transform`` runs on the device batch (the on-device
DownBlur, ``data.device_degradation``).

t and the noise come from a ``torch.Generator`` on the trainer's device
seeded with ``seed`` (another stream than the reference's keys);
``train_step`` takes them explicitly too.

Data parallelism (``mesh=parallel.make_mesh()``, one process per device,
started by torchrun; ``parallel.sharding``): every rank starts from rank
0's weights, loads its shard and steps on its slice of the global batch.
Each rank draws t and the noise for the whole global batch from the
generator every rank seeds alike and takes its rows, BatchNorm takes the
global batch's statistics, and each rank's gradient of its rows' weighted
loss sum is summed over the group with the loss sum and the valid count
(``pad_mask``'s) and divided by that count: the step of the global batch
in one process, which the JAX package's sharded step computes. Adam and
the EMA then run alike on every rank. Only rank 0 writes snapshots and
metrics; a stop requested on any rank stops every rank after the same
epoch (an all-reduce of the flags at one point of each epoch); previews
sample alike on every rank from rank 0's noise. A (data, model) mesh
(``parallel.tensor``) trains over its data axis.

Snapshots: ``checkpoint_backend='msgpack'`` (the default) writes the
reference package's msgpack file on rank 0, in the loop's thread;
``'orbax'`` writes an Orbax checkpoint directory (``io.OrbaxSnapshotter``,
``tensorstore``) in a background thread, which the next snapshot, the end
of ``train`` (``finalize_snapshots``) or a resume waits for. Under a group
every rank enters each Orbax save and rank 0 alone writes;
``finalize_snapshots`` ends with a barrier of the group, so that no rank
leaves ``train`` before rank 0's step has committed.

Float32 is IEEE float32: a trainer of a float32 model turns cuDNN's TF32
off (``utils.ieee_float32``), which torch leaves on by default.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import signal
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from diffusionremotesensing_tpu_torch.diffusion import make_process, q_sample, sample_timesteps
from diffusionremotesensing_tpu_torch.ema import EMA_BETA, EMA_WARMUP_STEPS, ema_update
from diffusionremotesensing_tpu_torch.io import (
    OrbaxSnapshotter,
    load_snapshot,
    require_tensorstore,
    save_snapshot,
)
from diffusionremotesensing_tpu_torch.losses import VGG19Features, make_loss_fn
from diffusionremotesensing_tpu_torch.models.blocks import global_batch_statistics
from diffusionremotesensing_tpu_torch.parallel.sharding import is_main_process, replicated_sharding
from diffusionremotesensing_tpu_torch.parallel.tensor import sum_split_grads
from diffusionremotesensing_tpu_torch.profiling import MetricsLogger
from diffusionremotesensing_tpu_torch.schedules import Schedule, make_schedule
from diffusionremotesensing_tpu_torch.utils import ieee_float32, resolve_device

__all__ = ["TrainState", "Trainer"]


@dataclasses.dataclass
class TrainState:
    """The online model (parameters and BatchNorm running statistics), its
    optimizer, the EMA of its parameters (aligned with
    ``model.parameters()``; None when EMA is off) and the optimizer steps
    taken."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    ema_params: Optional[List[torch.Tensor]]
    step: int = 0


class Trainer:
    """A UNet bound to a schedule, a loss and Adam, with its train,
    validation and sample steps and the epoch loop (module docstring).

    ``model`` is a ``ResidualAttentionUNet``; it trains in its compute dtype
    (``compute_dtype``) with ``s2d_train`` as it says, on ``device``
    (``cuda`` unless the caller asks for the CPU), or with ``mesh`` (a
    ``parallel.Mesh`` of this process's one device, or a (data, model)
    mesh of ``parallel.tensor``) on the mesh's device, data-parallel over
    its group. Batches are dicts of
    NHWC arrays: 'x' the clean target, optionally 'cond' (image or labels),
    'cond_mask' and 'pad_mask', or 'hr_u8' for ``batch_transform``.
    ``vgg`` is the perceptual loss's ``losses.VGG19Features`` (its weights
    loaded by the caller). A trainer of a float32 model turns cuDNN's TF32
    off (``utils.ieee_float32``)."""

    def __init__(
        self,
        model,
        noise_schedule: str,
        noise_steps: int,
        image_size: int,
        snapshot_path: Optional[str] = None,
        lr: float = 3e-4,
        loss: str = "MSE",
        ema_smoothing: bool = False,
        label_dropout: float = 0.0,
        mesh=None,
        beta_start: float = 1e-4,
        beta_end: float = 0.02,
        seed: int = 0,
        metrics_path: Optional[str] = None,
        vgg: Optional[VGG19Features] = None,
        allow_random_vgg: bool = False,
        batch_transform: Optional[Callable] = None,
        checkpoint_backend: str = "msgpack",
        steps_per_dispatch: int = 1,
        device="cuda",
    ):
        self.mesh = getattr(mesh, "data", mesh)  # a (data, model) mesh: its data axis
        if self.mesh is not None and len(self.mesh.devices) != 1:
            raise ValueError(
                f"a trainer runs one process per device, got a mesh of {len(self.mesh.devices)} "
                "devices in this process: start one process a device (torchrun "
                "--nproc_per_node=N) and give each make_mesh(), its own device")
        self._group = None if self.mesh is None else self.mesh.group
        if checkpoint_backend not in ("msgpack", "orbax"):
            raise ValueError(f"unknown checkpoint_backend {checkpoint_backend!r}")
        if checkpoint_backend == "orbax":
            require_tensorstore()  # the named ImportError before any step
        self.checkpoint_backend = checkpoint_backend
        self._orbax: Optional[OrbaxSnapshotter] = None  # made at the first save
        if steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got {steps_per_dispatch}")
        self.device = resolve_device(self.mesh.device if self.mesh is not None else device)
        self.model = model.to(self.device, memory_format=torch.channels_last)
        ieee_float32(model.dtype)
        self.noise_schedule, self.beta_start, self.beta_end = noise_schedule, beta_start, beta_end
        self.noise_steps = noise_steps
        self.image_size = image_size
        self.snapshot_path = snapshot_path
        self.lr = lr
        self.ema_smoothing = ema_smoothing
        self.label_dropout = label_dropout
        self.loss_name = loss
        self.batch_transform = batch_transform
        self.steps_per_dispatch = int(steps_per_dispatch)
        self.epochs_run = 0
        self._rng = np.random.default_rng(seed)  # label dropout
        self.generator = torch.Generator(device=self.device).manual_seed(seed)  # t and noise
        # on the device: q_sample indexes it by t there
        self.schedule = Schedule(*(a.to(self.device) for a in make_schedule(
            noise_schedule, noise_steps, beta_start, beta_end)))
        if loss == "MSE+Perceptual_noise" and vgg is None:
            # the reference's perceptual term uses torchvision's pretrained
            # VGG19; training against random features is another loss, so
            # it runs only when asked for
            if not allow_random_vgg:
                raise ValueError(
                    "MSE+Perceptual_noise requires pretrained VGG19 weights (pass "
                    "vgg=losses.VGG19Features() with torchvision's vgg19 features loaded, "
                    "losses.vgg19_features_state(torch.load(<vgg19.pth>))). To knowingly "
                    "train against a fixed randomly-initialized VGG19 instead (a "
                    "random-projection perceptual loss, NOT the reference semantics), pass "
                    "allow_random_vgg=True.")
            print("WARNING: MSE+Perceptual_noise with allow_random_vgg: a fixed randomly-"
                  "initialized VGG19 (random-projection perceptual loss), NOT the reference's "
                  "pretrained features.")
            vgg = VGG19Features(seed)
        self.loss_fn = make_loss_fn(loss, None if vgg is None else vgg.to(self.device))
        self.metrics = MetricsLogger(metrics_path if is_main_process() else None)
        self._stop_requested = False

    # ------------------------------------------------------------------ state

    def _optimizer(self, model) -> torch.optim.Adam:
        return torch.optim.Adam(model.parameters(), lr=self.lr, betas=(0.9, 0.999), eps=1e-8)

    def _ema_copy(self, model) -> Optional[List[torch.Tensor]]:
        if not self.ema_smoothing:
            return None
        return [p.detach().clone() for p in model.parameters()]

    def init_state(self, variables: Optional[Dict[str, torch.Tensor]] = None) -> TrainState:
        """The state before the first step: ``variables`` (a state_dict, e.g.
        ``convert.init_params`` or ``io.load_snapshot``'s) loaded strictly
        into the model when given, fresh Adam moments, the EMA a copy of
        the parameters."""
        if variables is not None:
            self.model.load_state_dict(variables, strict=True)
        self._broadcast_weights(self.model)
        return TrainState(self.model, self._optimizer(self.model), self._ema_copy(self.model))

    def _broadcast_weights(self, model) -> None:
        """Under a group: every rank takes rank 0's parameters and BatchNorm
        statistics."""
        if self._group is None:
            return
        group, src = replicated_sharding(self.mesh)
        with torch.no_grad():
            for v in model.state_dict().values():
                dist.broadcast(v, src=src, group=group)

    def maybe_resume(self, state: TrainState) -> TrainState:
        """Resume from the snapshot when it exists (a msgpack or torch file,
        or an Orbax directory's latest committed step): its weights and
        BatchNorm statistics, ``epochs_run``; Adam's moments restart and the
        EMA is a copy of the loaded parameters."""
        if self._orbax is not None:
            self._orbax.wait_until_finished()
        if self.snapshot_path and os.path.exists(self.snapshot_path):
            variables, epochs_run = load_snapshot(self.snapshot_path)
            state.model.load_state_dict(variables, strict=True)
            self._broadcast_weights(state.model)
            state.optimizer = self._optimizer(state.model)
            state.ema_params = self._ema_copy(state.model)
            self.epochs_run = epochs_run
            if is_main_process():
                print(f"Resuming training from snapshot at Epoch {epochs_run}")
        return state

    def ema_model(self, state: TrainState) -> torch.nn.Module:
        """The weights to serve: a copy of the model holding the EMA
        parameters and the online BatchNorm statistics (the model itself
        when EMA is off)."""
        if state.ema_params is None:
            return state.model
        m = copy.deepcopy(state.model)
        with torch.no_grad():
            torch._foreach_copy_([p for p in m.parameters()], state.ema_params)
        return m

    def save_snapshot(self, state: TrainState, epoch: int) -> None:
        """The EMA parameters (the online ones without EMA) with the online
        BatchNorm statistics, in the backend's format: msgpack written by
        rank 0 alone, or the next step of the Orbax directory, which every
        rank enters and rank 0 alone writes, in the background."""
        if not self.snapshot_path:
            return
        main = is_main_process()
        if self.checkpoint_backend == "orbax":
            if self._orbax is None:
                self._orbax = OrbaxSnapshotter(self.snapshot_path, primary=main)
            # every rank counts the step; rank 0 alone copies and writes
            self._orbax.save(self.ema_model(state) if main else None, epoch)
        elif main:
            save_snapshot(self.snapshot_path, self.ema_model(state), epoch)
        if main:
            print(f"Epoch {epoch} | Training snapshot saved at {self.snapshot_path}")

    def finalize_snapshots(self) -> None:
        """Wait until the Orbax write in flight has committed (raising its
        error, if it had one); under a group, then a barrier of the group.
        ``train`` calls it at its end; safe to call any time (under a group,
        on every rank)."""
        try:
            if self._orbax is not None:
                self._orbax.wait_until_finished()
        finally:
            if self._group is not None and self.checkpoint_backend == "orbax":
                dist.barrier(group=self._group)

    # ------------------------------------------------------------------ steps

    def _draw(self, x0: torch.Tensor, t: Optional[torch.Tensor],
              noise: Optional[torch.Tensor]):
        """t and the noise of the batch x0 where not given: drawn for the
        global batch (the ranks' equal shares in rank order) and this rank's
        rows taken, so that every rank's generator stays in step."""
        b = x0.shape[0]
        n, lo = (b * self.mesh.world, b * self.mesh.rank) if self._group is not None else (b, 0)
        if t is None:
            t = sample_timesteps(self.generator, n, self.noise_steps, self.device)[lo:lo + b]
        if noise is None:
            noise = torch.randn((n,) + tuple(x0.shape[1:]), generator=self.generator,
                                device=self.device)[lo:lo + b]
        return t, noise

    def _reduce_share(self, share: torch.Tensor, weights: Optional[torch.Tensor], rows: int,
                      grads: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """Under a group: the global batch's loss from this rank's ``share``
        (its rows' weighted loss sum) over the summed valid count, and with
        ``grads`` (this rank's gradients of its share) the global gradient
        in place, in one all-reduce."""
        count = (weights.sum() if weights is not None
                 else torch.tensor(float(rows), device=share.device))
        parts = [g.reshape(-1) for g in grads or []]
        flat = torch.cat(parts + [share.detach().reshape(1).float(), count.reshape(1).float()])
        dist.all_reduce(flat, group=self._group)
        total = flat[-1]
        if grads:
            torch._foreach_copy_(grads, [g.view_as(p) for g, p in zip(
                torch.split(flat[:-2] / total, [g.numel() for g in grads]), grads)])
        return flat[-2] / total

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                   t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One optimizer step on a device batch (this rank's rows of the
        global batch under a group); t and the noise drawn from the
        trainer's generator unless given (then this rank's rows). Returns the
        loss (of the global batch; a device scalar, reading it waits for the
        step)."""
        model = state.model
        x0 = batch["x"]
        t, noise = self._draw(x0, t, noise)
        x_t = q_sample(self.schedule, x0, t, noise)
        state.optimizer.zero_grad(set_to_none=True)
        with global_batch_statistics(self._group):
            out = model(x_t, t, batch.get("cond"), batch.get("cond_mask"), train=True)
        params = list(model.parameters())
        weights = batch.get("pad_mask")
        # under a group: this rank's weighted loss sum, divided by the global
        # count once the gradients are summed
        loss = self.loss_fn(out, noise, weights=weights,
                            **({} if self._group is None else {"denom": 1.0}))
        loss.backward()
        for p in params:
            if p.grad is None:  # a skip conv the forward does not use
                p.grad = torch.zeros_like(p)
        sum_split_grads(model)
        if self._group is not None:
            loss = self._reduce_share(loss, weights, x0.shape[0], [p.grad for p in params])
        state.optimizer.step()
        if state.ema_params is not None:
            ema_update(state.ema_params, params, state.step, EMA_BETA, EMA_WARMUP_STEPS)
        state.step += 1
        return loss.detach()

    @torch.no_grad()
    def val_step(self, model: torch.nn.Module, batch: Dict[str, torch.Tensor],
                 t: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The loss of ``model`` (``ema_model(state)``) on a device batch (of
        the global batch under a group), BatchNorms on their running
        statistics."""
        x0 = batch["x"]
        t, noise = self._draw(x0, t, noise)
        out = model(q_sample(self.schedule, x0, t, noise), t, batch.get("cond"),
                    batch.get("cond_mask"), train=False)
        weights = batch.get("pad_mask")
        if self._group is None:
            return self.loss_fn(out, noise, weights=weights)
        return self._reduce_share(self.loss_fn(out, noise, weights=weights, denom=1.0), weights,
                                  x0.shape[0])

    def _prep_batch(self, batch: Dict[str, np.ndarray], train: bool = True,
                    device: bool = True) -> Dict:
        """Host batch -> device batch, with the label dropout of train
        batches (the reference's generation validation loop also drops, in
        code it never runs: its validation loader is None) and then the
        batch transform. ``device=False``: the host part only."""
        out = dict(batch)
        if train and self.label_dropout > 0 and "cond" in out:
            n = out["x"].shape[0]
            drop = self._rng.random() < self.label_dropout
            out["cond_mask"] = np.full((n,), 0.0 if drop else 1.0, np.float32)
        if not device:
            return out
        return self._to_device(out)

    def _to_device(self, host: Dict) -> Dict[str, torch.Tensor]:
        out = {k: torch.as_tensor(np.asarray(v)).to(self.device) for k, v in host.items()}
        if self.batch_transform is not None and "hr_u8" in out:
            out = self.batch_transform(out)
        return out

    # ------------------------------------------------------------------ loop

    def train(self, state: TrainState, epochs: int, train_loader, val_loader=None,
              check_preds_epoch: int = 20, patience: int = 10, verbose: bool = True,
              on_preview: Optional[Callable[[TrainState, int], None]] = None) -> TrainState:
        """The reference's epoch loop (module docstring). On SIGTERM or
        SIGINT it finishes the batch in hand (under a group: the epoch, as
        every step is a collective every rank enters), snapshots and
        returns."""
        self._stop_requested = False
        multiproc = self._group is not None
        main = is_main_process()

        def _on_signal(signum, frame):
            self._stop_requested = True
            # os.write, not print: the handler may interrupt a print that
            # holds stdout's lock
            os.write(2, f"signal {signum}: will snapshot and stop at the next "
                        f"{'epoch' if multiproc else 'batch'} boundary\n".encode())

        def _stop_agreed() -> bool:
            # under a group every rank reaches this point once an epoch and
            # takes the MAX of the flags: one rank's stop stops them all
            # after the same epoch (its local flag alone would send it into
            # the snapshot while the others enter the next step)
            if not multiproc:
                return self._stop_requested
            flag = torch.tensor([float(self._stop_requested)], device=self.device)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self._group)
            return bool(flag.item())

        old_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old_handlers[sig] = signal.signal(sig, _on_signal)
            except ValueError:  # not the main thread
                pass

        best_loss = float("inf")
        epochs_without_improving = 0
        interrupted = False
        spd = self.steps_per_dispatch
        try:
            for epoch in range(self.epochs_run, epochs):
                if hasattr(train_loader, "set_epoch"):
                    train_loader.set_epoch(epoch)
                t0 = time.time()
                losses: List[torch.Tensor] = []
                epoch_cut_short = False
                pend: list = []
                pend_sig: dict = {}

                def _flush():
                    # the pending batches as one stacked transfer a field,
                    # then their steps in order
                    if not pend:
                        return
                    stacked = self._to_device_stacked(pend)
                    for i in range(len(pend)):
                        b = {k: v[i] for k, v in stacked.items()}
                        if self.batch_transform is not None and "hr_u8" in b:
                            b = self.batch_transform(b)
                        losses.append(self.train_step(state, b))
                    pend.clear()

                for batch in train_loader:
                    if self._stop_requested and not multiproc:
                        interrupted = epoch_cut_short = True
                        break
                    if spd > 1:
                        prepped = self._prep_batch(batch, device=False)
                        sig = {k: np.shape(v) for k, v in prepped.items()}
                        if pend and sig != pend_sig:
                            _flush()  # pad_mask appeared, or a short final batch
                        pend_sig = sig
                        pend.append(prepped)
                        if len(pend) == spd:
                            _flush()
                        continue
                    losses.append(self.train_step(state, self._prep_batch(batch)))
                _flush()
                running = float(torch.stack(losses).mean()) if losses else 0.0
                sps = len(losses) / max(time.time() - t0, 1e-9)
                if verbose and main:
                    tag = " [partial epoch]" if epoch_cut_short else ""
                    print(f"Epoch {epoch}: Running Train ({self.loss_name}) {running:.6f}  "
                          f"[{sps:.2f} steps/s]{tag}")
                extra = {"partial": True} if epoch_cut_short else {}
                self.metrics.log(epoch=epoch, train_loss=running, steps_per_sec=sps,
                                 step=state.step, **extra)

                if _stop_agreed():
                    interrupted = True
                    self.save_snapshot(state, epoch)
                    if verbose and main:
                        print(f"Epoch {epoch}: interrupted — snapshot saved, stopping")
                    break

                if epoch % check_preds_epoch == 0:
                    # every rank: a preview samples on every rank alike
                    # (its writes are the caller's, rank-0-gated)
                    if val_loader is None:
                        self.save_snapshot(state, epoch)
                    if on_preview is not None:
                        on_preview(state, epoch)

                if val_loader is not None:
                    model = self.ema_model(state)
                    val_losses = [self.val_step(model, self._prep_batch(b, train=False))
                                  for b in val_loader]
                    running_val = float(torch.stack(val_losses).mean()) if val_losses else 0.0
                    if verbose and main:
                        print(f"Epoch {epoch}: Running Val loss ({self.loss_name}) "
                              f"{running_val:.6f}")
                    self.metrics.log(epoch=epoch, val_loss=running_val)
                    if running_val < best_loss:
                        best_loss = running_val
                        epochs_without_improving = 0
                        self.save_snapshot(state, epoch)
                    else:
                        epochs_without_improving += 1
                    if epochs_without_improving >= patience:
                        if main:
                            print("Early stopping! Training stopped")
                        break
                if verbose and main:
                    print("Epochs without improving: ", epochs_without_improving)
        finally:
            for sig, h in old_handlers.items():
                signal.signal(sig, h)
            self._stop_requested = False
            self.finalize_snapshots()
        if interrupted and verbose and main:
            print("Training stopped by signal; snapshot is durable — rerun to resume")
        return state

    def _to_device_stacked(self, prepped: list) -> Dict[str, torch.Tensor]:
        """K host-prepped batches as (K, B, ...) device tensors."""
        return {k: torch.as_tensor(np.stack([np.asarray(p[k]) for p in prepped])).to(self.device)
                for k in prepped[0]}

    # ------------------------------------------------------------------ infer

    def sample(self, state: TrainState, n: int, cond=None, cfg_scale: Optional[float] = None,
               capture_frames: bool = False, generator: Optional[torch.Generator] = None,
               **kwargs):
        """Sample n images with the EMA weights (the online ones without EMA)
        through the ancestral chain (``DiffusionProcess.sample``; ``kwargs``
        such as ``ddim_steps`` go to it), in the model's compute dtype;
        noise from ``generator``, else the trainer's. Under a group every
        rank calls it at the same point and gets rank 0's images."""
        process = make_process(self.ema_model(state), self.noise_schedule, self.noise_steps,
                               self.image_size, beta_start=self.beta_start,
                               beta_end=self.beta_end)
        return process.sample(n, cond, cfg_scale=cfg_scale, capture_frames=capture_frames,
                              generator=generator if generator is not None else self.generator,
                              mesh=self.mesh, **kwargs)
