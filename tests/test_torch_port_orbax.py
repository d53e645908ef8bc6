"""The port's Orbax checkpoint backend (io.OrbaxSnapshotter,
io.load_snapshot_orbax; tensorstore, no orbax) on the CPU: a directory the
port writes is read by the reference package's load_snapshot bitwise, and
one the reference's OrbaxSnapshotter writes is read by the port bitwise;
the layout is the reference writer's; save returns before the write is
done and copies the weights first; keep-one and commit-then-delete, also
when the write is cut short; the step numbering of a resumed snapshotter;
Trainer(checkpoint_backend='orbax') and the command line train and resume;
a missing tensorstore raises a named ImportError. The full-width x2 model's
init_params weights (17.5 MB) are made once for the module."""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

ts = pytest.importorskip("tensorstore")

import jax  # noqa: E402

from diffusionremotesensing_tpu import io as jio  # noqa: E402
from diffusionremotesensing_tpu_torch import cli  # noqa: E402
from diffusionremotesensing_tpu_torch import io as tio  # noqa: E402
from diffusionremotesensing_tpu_torch.convert import from_jax_variables, init_params  # noqa: E402
from diffusionremotesensing_tpu_torch.data.loader import DataLoader  # noqa: E402
from diffusionremotesensing_tpu_torch.models.unet import (  # noqa: E402
    residual_attention_unet_superres,
)
from diffusionremotesensing_tpu_torch.png import encode_png  # noqa: E402
from diffusionremotesensing_tpu_torch.train import Trainer  # noqa: E402

HR = 16


@pytest.fixture(scope="module")
def model():
    m = residual_attention_unet_superres(magnification_factor=2)
    m.load_state_dict(init_params(0, device="cpu"))
    return m


@pytest.fixture(scope="module")
def variables(model):
    return tio.to_jax_variables(model.state_dict())


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): v})
    return out


def _equal_trees(a, b):
    fa, fb = _flat(a), _flat(b)
    return fa.keys() == fb.keys() and all(
        np.asarray(fa[k]).dtype == np.asarray(fb[k]).dtype
        and np.array_equal(np.asarray(fa[k]), np.asarray(fb[k])) for k in fa)


def _equal_states(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _save(path, model, epochs):
    s = tio.OrbaxSnapshotter(path)
    s.save(model, epochs)
    s.wait_until_finished()
    return s


def test_the_port_writes_what_the_reference_reads(tmp_path, model, variables):
    path = str(tmp_path / "ckpt")
    _save(path, model, 7)
    state, epochs = jio.load_snapshot(path)
    assert epochs == 7
    params, stats = variables
    assert _equal_trees(jax.tree_util.tree_map(np.asarray, dict(state["params"])), params)
    assert _equal_trees(jax.tree_util.tree_map(np.asarray, dict(state["batch_stats"])), stats)


def test_the_layout_is_the_reference_writers(tmp_path, model):
    path = str(tmp_path / "ckpt")
    _save(path, model, 3)
    assert os.listdir(path) == ["0"]
    with open(os.path.join(path, "0", "_CHECKPOINT_METADATA")) as f:
        assert json.load(f)["item_handlers"] == {"default": tio._ORBAX_HANDLER}
    with open(os.path.join(path, "0", "default", "_METADATA")) as f:
        meta = json.load(f)
    assert meta["use_ocdbt"] is True and meta["use_zarr3"] is False
    epochs = meta["tree_metadata"][str(("EPOCHS_RUN",))]["value_metadata"]
    assert epochs["value_type"] == "scalar"
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": "file://" + os.path.join(path, "0", "default") + "/"}).result()
    zarrays = {k.decode()[:-len("/.zarray")]: json.loads(kv.read(k).result().value)
               for k in kv.list().result() if k.endswith(b"/.zarray")}
    assert len(zarrays) == len(meta["tree_metadata"])
    for key, z in zarrays.items():
        assert z["zarr_format"] == 2 and z["compressor"] == {"id": "zstd", "level": 1}
        assert z["chunks"] == z["shape"], key  # one chunk
        assert z["dtype"] == ("<i8" if key == "EPOCHS_RUN" else "<f4"), key
    assert zarrays["EPOCHS_RUN"]["shape"] == []
    assert "MODEL_STATE.params.conv0.conv.kernel" in zarrays


def test_the_port_reads_what_the_reference_writes(tmp_path, variables):
    path = str(tmp_path / "ckpt")
    params, stats = variables
    writer = jio.OrbaxSnapshotter(path)
    writer.save({"params": params, "batch_stats": stats}, 4)
    writer.wait_until_finished()
    writer.save({"params": params, "batch_stats": stats}, 5)
    writer.wait_until_finished()
    writer.close()
    state, epochs = tio.load_snapshot(path)
    assert epochs == 5
    assert _equal_states(state, from_jax_variables(params, stats))
    # the port's snapshotter goes on after the reference's steps
    assert tio.OrbaxSnapshotter(path)._next_step == tio.committed_steps(path)[-1] + 1


def test_two_saves_keep_one_step(tmp_path, model):
    path = str(tmp_path / "ckpt")
    s = _save(path, model, 1)
    s.save(model, 2)
    s.close()
    assert os.listdir(path) == ["1"]
    assert tio.load_snapshot(path)[1] == 2


def test_a_write_cut_short_leaves_the_previous_step(tmp_path, model, monkeypatch):
    """The writer raises between the array writes and the rename: the step
    before stays committed and loadable, the error surfaces at
    wait_until_finished, and the next save writes over the leftovers."""
    path = str(tmp_path / "ckpt")
    s = _save(path, model, 1)

    def fail(p, obj):
        raise OSError("disk gone")

    monkeypatch.setattr(tio, "_write_json", fail)
    s.save(model, 2)
    with pytest.raises(OSError, match="disk gone"):
        s.wait_until_finished()
    assert tio.committed_steps(path) == [0]
    assert sorted(os.listdir(path)) == ["0", "1" + tio.ORBAX_TMP_SUFFIX]
    assert tio.load_snapshot(path)[1] == 1
    assert jio.load_snapshot(path)[1] == 1
    monkeypatch.undo()
    s2 = tio.OrbaxSnapshotter(path)
    assert s2._next_step == 1
    s2.save(model, 3)
    s2.close()
    assert os.listdir(path) == ["1"] and tio.load_snapshot(path)[1] == 3


def test_save_returns_before_the_write_and_copies_the_weights(tmp_path, monkeypatch):
    """The write waits on an event: save has returned before it, and the
    weights changed after save returned are not what is written; a second
    save waits for the write in flight."""
    path = str(tmp_path / "ckpt")
    m = residual_attention_unet_superres(magnification_factor=2)
    want = {k: v.clone() for k, v in m.state_dict().items()}
    release, real = threading.Event(), tio.write_orbax_step
    monkeypatch.setattr(tio, "write_orbax_step", lambda *a: (release.wait(60), real(*a)))
    s = tio.OrbaxSnapshotter(path)
    s.save(m, 9)
    assert tio.committed_steps(path) == []
    with torch.no_grad():
        for p in m.parameters():
            p.add_(1.0)
    release.set()
    s.wait_until_finished()
    state, epochs = tio.load_snapshot(path)
    assert epochs == 9
    assert all(torch.equal(state[k], want[k]) for k in state if "num_batches" not in k)

    release.clear()
    s.save(m, 10)
    second = threading.Thread(target=s.save, args=(m, 11))
    second.start()
    second.join(0.5)
    assert second.is_alive()  # waits for the write in flight
    release.set()
    second.join(60)
    s.close()
    assert tio.committed_steps(path) == [2] and tio.load_snapshot(path)[1] == 11


def test_an_empty_directory_has_no_step(tmp_path):
    with pytest.raises(FileNotFoundError, match="no committed orbax checkpoint"):
        tio.load_snapshot_orbax(str(tmp_path))


class _Pairs:
    def __init__(self, n=4):
        rng = np.random.default_rng(1)
        self.items = [{"x": rng.random((HR, HR, 3)).astype(np.float32),
                       "cond": rng.random((HR // 2, HR // 2, 3)).astype(np.float32)}
                      for _ in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _trainer(path, model_state):
    m = residual_attention_unet_superres(magnification_factor=2)
    tr = Trainer(m, "linear", 20, HR, snapshot_path=path, checkpoint_backend="orbax",
                 device="cpu", seed=2)
    return tr, tr.init_state(model_state)


def test_the_trainer_saves_and_resumes(tmp_path, model):
    path = str(tmp_path / "ckpt")
    tr, state = _trainer(path, model.state_dict())
    state = tr.train(state, epochs=2, train_loader=DataLoader(_Pairs(), 4), check_preds_epoch=1,
                     verbose=False)
    assert state.step == 2
    assert tio.committed_steps(path) == [1] and not tr._orbax._thread  # finalized
    tr2, state2 = _trainer(path, model.state_dict())
    state2 = tr2.maybe_resume(state2)
    assert tr2.epochs_run == 1
    got, want = state2.model.state_dict(), state.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want if "num_batches" not in k)
    # the resumed trainer numbers its next save after the committed step
    tr2.save_snapshot(state2, 1)
    tr2.finalize_snapshots()
    assert tio.committed_steps(path) == [2]


def test_the_command_line_trains_and_resumes(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DRS_FORCE_CPU", "1")
    rng = np.random.default_rng(4)
    for split in ("train_original", "val_original"):
        os.makedirs(tmp_path / "data" / split)
        for i in range(3):
            with open(tmp_path / "data" / split / f"{i}.png", "wb") as f:
                f.write(encode_png((rng.random((16, 16, 3)) * 255).astype(np.uint8)))
    argv = ["superres", "--model_name", "m", "--dataset_path", "data", "--magnification_factor",
            "2", "--epochs", "1", "--batch_size", "2", "--noise_steps", "4",
            "--check_preds_epoch", "1", "--loss", "MSE", "--image_size", "16",
            "--checkpoint_backend", "orbax"]
    cli.main(argv)
    snap = tmp_path / "models_run" / "m" / "weights" / "snapshot.pt"
    assert snap.is_dir() and tio.committed_steps(str(snap)) == [0]
    assert jio.load_snapshot(str(snap))[1] == 0
    capsys.readouterr()
    cli.main([*argv, "--epochs", "2"])
    assert "Resuming training from snapshot at Epoch 0" in capsys.readouterr().out
    assert tio.committed_steps(str(snap)) == [1]


def test_a_missing_tensorstore_is_named(tmp_path, monkeypatch, model):
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    for call in (lambda: tio.OrbaxSnapshotter(str(tmp_path / "a")),
                 lambda: tio.load_snapshot_orbax(str(tmp_path)),
                 lambda: Trainer(residual_attention_unet_superres(magnification_factor=2),
                                 "linear", 20, HR, checkpoint_backend="orbax", device="cpu")):
        with pytest.raises(ImportError, match="Orbax checkpoint backend needs the 'tensorstore'"):
            call()
