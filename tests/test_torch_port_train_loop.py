"""The port's training loop (train.Trainer.train) and what surrounds it, on
the full-width class-conditional model at HR 16 on the CPU: snapshot and
resume (Adam's moments restart), the EMA snapshot, early stopping, SIGTERM,
label dropout drawing the reference Trainer's sequence, a port snapshot read
by the reference package's io.load_snapshot, steps_per_dispatch against one
step a batch, the on-device DownBlur as batch_transform, sampling with the
EMA weights, the refusals, and profiling's logger and timer."""

import json
import os
import signal
import sys

import jax
import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu import io as dio
from diffusionremotesensing_tpu.models.unet import residual_attention_unet_generation as jax_gen
from diffusionremotesensing_tpu.train import Trainer as JaxTrainer
from diffusionremotesensing_tpu_torch.convert import from_jax_variables
from diffusionremotesensing_tpu_torch.data.device_degradation import make_downblur_transform
from diffusionremotesensing_tpu_torch.data.loader import DataLoader
from diffusionremotesensing_tpu_torch.io import load_snapshot
from diffusionremotesensing_tpu_torch.models.unet import (
    residual_attention_unet_generation,
    residual_attention_unet_superres,
)
from diffusionremotesensing_tpu_torch.profiling import MetricsLogger, StepTimer
from diffusionremotesensing_tpu_torch.parallel.sharding import make_mesh
from diffusionremotesensing_tpu_torch.train import Trainer
from tests.torch_port_helpers import GEN_CLASSES, random_jax_variables

HR = 16


class SyntheticGenDataset:
    """In-memory class-conditional images (label = brightness level)."""

    def __init__(self, n=8, size=HR, num_classes=2, seed=0):
        rng = np.random.default_rng(seed)
        self.items = []
        for i in range(n):
            label = i % num_classes
            img = np.clip(0.25 + 0.5 * label + 0.05 * rng.standard_normal((size, size, 3)), 0, 1)
            self.items.append({"x": img.astype(np.float32), "cond": np.int64(label)})

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _variables():
    v = random_jax_variables(seed=3, image_size=HR, variant="generation")
    return from_jax_variables(v["params"], v["batch_stats"])


def _trainer(tmp_path, ema=False, **kw):
    kw.setdefault("label_dropout", 0.1)
    tr = Trainer(residual_attention_unet_generation(num_classes=GEN_CLASSES), "linear", 20, HR,
                 snapshot_path=os.path.join(tmp_path, "snapshot.msgpack"), lr=1e-3,
                 ema_smoothing=ema, device="cpu", **kw)
    return tr, tr.init_state(_variables())


def test_snapshot_and_resume(tmp_path):
    tr, state = _trainer(tmp_path)
    state = tr.train(state, epochs=2, train_loader=DataLoader(SyntheticGenDataset(), 8),
                     check_preds_epoch=1, verbose=False)
    assert state.step == 2 and os.path.exists(tr.snapshot_path)
    tr2, state2 = _trainer(tmp_path)
    state2 = tr2.maybe_resume(state2)
    assert tr2.epochs_run == 1  # the last snapshot was at epoch 1
    saved, _ = load_snapshot(tr.snapshot_path)
    got = state2.model.state_dict()
    assert all(torch.equal(got[k], saved[k]) for k in saved if "num_batches" not in k)
    assert state2.optimizer.state == {}  # Adam's moments restart
    # a resumed run trains from the snapshot's epoch on: epochs 1 and 2
    state2 = tr2.train(state2, epochs=3, train_loader=DataLoader(SyntheticGenDataset(), 8),
                       check_preds_epoch=1, verbose=False)
    assert state2.step == 2


def test_ema_snapshot_holds_the_ema_weights(tmp_path):
    tr, state = _trainer(tmp_path, ema=True)
    state = tr.train(state, epochs=1, train_loader=DataLoader(SyntheticGenDataset(), 4),
                     check_preds_epoch=1, verbose=False)
    saved, _ = load_snapshot(tr.snapshot_path)
    ema = tr.ema_model(state).state_dict()
    assert all(torch.equal(ema[k], saved[k]) for k in saved if "num_batches" not in k)
    # in the warm-up the EMA is the online weights; the BatchNorm statistics
    # are the online model's
    online = state.model.state_dict()
    assert all(torch.equal(ema[k], online[k]) for k in online)


def test_early_stopping(tmp_path):
    tr, state = _trainer(tmp_path, metrics_path=os.path.join(tmp_path, "m.jsonl"))
    loader = DataLoader(SyntheticGenDataset(n=4), 4)
    tr.train(state, epochs=50, train_loader=loader, val_loader=loader, check_preds_epoch=100,
             patience=1, verbose=False)
    with open(os.path.join(tmp_path, "m.jsonl")) as f:
        epochs = {json.loads(line)["epoch"] for line in f}
    assert len(epochs) < 50 and os.path.exists(tr.snapshot_path)


class _SignalAfter:
    """A loader that sends the process SIGTERM after its first batch."""

    def __init__(self, loader):
        self.loader = loader

    def __iter__(self):
        for i, batch in enumerate(self.loader):
            if i == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch


def test_sigterm_snapshots_and_stops_at_a_batch_boundary(tmp_path):
    tr, state = _trainer(tmp_path, metrics_path=os.path.join(tmp_path, "m.jsonl"))
    before = signal.getsignal(signal.SIGTERM)
    loader = _SignalAfter(DataLoader(SyntheticGenDataset(n=12), 4))
    state = tr.train(state, epochs=5, train_loader=loader, check_preds_epoch=100, verbose=False)
    assert state.step == 1  # the batch in hand when the signal came, then stop
    assert os.path.exists(tr.snapshot_path)
    assert signal.getsignal(signal.SIGTERM) is before
    with open(os.path.join(tmp_path, "m.jsonl")) as f:
        assert json.loads(f.readline())["partial"] is True


def test_label_dropout_draws_the_reference_sequence(tmp_path):
    """Per train batch, the whole batch's mask: the same draws as the
    reference Trainer from the same seed; validation batches draw none."""
    batch = {"x": np.zeros((3, HR, HR, 3), np.float32), "cond": np.zeros(3, np.int64)}
    ref = JaxTrainer(jax_gen(num_classes=GEN_CLASSES), "linear", 20, HR, label_dropout=0.4,
                     seed=7)
    tr, _ = _trainer(tmp_path, label_dropout=0.4, seed=7)
    got, want = [], []
    for i in range(40):
        train = i % 5 != 4
        got.append(tr._prep_batch(batch, train=train, device=False).get("cond_mask"))
        want.append(ref._prep_batch(batch, train=train, device=False).get("cond_mask"))
    assert any(m is not None and m[0] == 0.0 for m in got)
    for g, w in zip(got, want):
        assert (g is None and w is None) or np.array_equal(g, w)


def test_port_snapshot_loads_in_the_reference(tmp_path):
    tr, state = _trainer(tmp_path, ema=True)
    tr.train_step(state, tr._prep_batch(next(iter(DataLoader(SyntheticGenDataset(), 8)))))
    tr.save_snapshot(state, 3)
    model_state, epochs = dio.load_snapshot(tr.snapshot_path)
    assert epochs == 3
    got = from_jax_variables(jax.tree_util.tree_map(np.asarray, model_state["params"]),
                             jax.tree_util.tree_map(np.asarray, model_state["batch_stats"]))
    want = tr.ema_model(state).state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want if "num_batches" not in k)


def test_steps_per_dispatch_matches_one_step_a_batch(tmp_path):
    """K = 3 over 10 items in batches of 4 padded to a multiple of 4 (the
    final batch brings pad_mask: a changed field set flushes early): the
    same steps in the same order, so the same weights."""
    ds = SyntheticGenDataset(n=10)
    out = []
    for k in (1, 3):
        tr, state = _trainer(tmp_path, steps_per_dispatch=k)
        state = tr.train(state, epochs=1, train_loader=DataLoader(ds, 4, pad_to_multiple=4),
                         check_preds_epoch=100, verbose=False)
        assert state.step == 3
        out.append(state.model.state_dict())
    assert all(torch.allclose(out[0][k].float(), out[1][k].float(), rtol=0, atol=1e-6)
               for k in out[0])


class _U8Dataset:
    def __init__(self, n=8, size=24):
        rng = np.random.default_rng(1)
        self.items = [(rng.random((size, size, 3)) * 255).astype(np.uint8) for _ in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return {"hr_u8": self.items[i]}


def test_trainer_runs_the_device_downblur(tmp_path):
    """One epoch through batch_transform: uint8 HR images in, the DownBlur
    on the device makes x and cond."""
    tr = Trainer(residual_attention_unet_superres(magnification_factor=2), "linear", 10, HR,
                 lr=1e-3, device="cpu", batch_transform=make_downblur_transform(24, 2, 0.5, HR))
    state = tr.train(tr.init_state(), epochs=1, train_loader=DataLoader(_U8Dataset(), 4),
                     verbose=False)
    assert state.step == 2
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    b = tr._prep_batch(next(iter(DataLoader(_U8Dataset(), 4))))
    assert b["x"].shape == (4, HR, HR, 3) and b["cond"].shape == (4, HR // 2, HR // 2, 3)


def test_sample_with_the_ema_weights(tmp_path):
    tr, state = _trainer(tmp_path, ema=True)
    tr.train_step(state, tr._prep_batch(next(iter(DataLoader(SyntheticGenDataset(), 4)))))
    out = tr.sample(state, 2, cond=1, cfg_scale=3.0, generator=torch.Generator().manual_seed(0))
    assert out.shape == (2, HR, HR, 3) and torch.isfinite(out).all()


def test_refusals(tmp_path):
    model = residual_attention_unet_generation(num_classes=GEN_CLASSES)
    args = (model, "linear", 20, HR)
    with pytest.raises(ValueError, match="one process per device"):
        Trainer(*args, mesh=make_mesh(["cpu", "cpu"]), device="cpu")
    # the Orbax backend is ported: refused only where tensorstore is missing
    assert Trainer(*args, checkpoint_backend="orbax", device="cpu").checkpoint_backend == "orbax"
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "tensorstore", None)
        with pytest.raises(ImportError, match="tensorstore"):
            Trainer(*args, checkpoint_backend="orbax", device="cpu")
    with pytest.raises(ValueError, match="checkpoint_backend"):
        Trainer(*args, checkpoint_backend="zip", device="cpu")
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        Trainer(*args, steps_per_dispatch=0, device="cpu")
    with pytest.raises(ValueError, match="VGG19"):
        Trainer(*args, loss="MSE+Perceptual_noise", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):  # no fallback to the CPU
            Trainer(*args)


def test_metrics_logger_and_step_timer(tmp_path):
    path = os.path.join(tmp_path, "sub", "m.jsonl")
    log = MetricsLogger(path)
    log.log(epoch=0, loss=torch.tensor(0.5), tag="a")
    log.close()
    with open(path) as f:
        row = json.loads(f.readline())
    assert row["epoch"] == 0 and row["loss"] == 0.5 and row["tag"] == "a" and "ts" in row
    timer = StepTimer(warmup=2)
    for _ in range(5):
        timer.tick()
    assert timer.count == 5 and timer.steps_per_sec > 0
    MetricsLogger(None).log(epoch=1)  # no path: nothing written


def test_trace_writes_a_timeline(tmp_path):
    from diffusionremotesensing_tpu_torch.profiling import annotate, trace

    with trace(str(tmp_path / "tr")):
        with annotate("port_region"):
            torch.ones(8).sum()
    with open(tmp_path / "tr" / "trace.json") as f:
        assert "port_region" in f.read()
    with trace(None):  # no directory: nothing traced
        pass
