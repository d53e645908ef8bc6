"""io.py of the port against the reference package and flax: its msgpack
reader and writer against flax's msgpack_restore / msgpack_serialize (the
in-repo snapshots bitwise, and every width of the format), the port's model
loaded from the in-repo x2 and x4 snapshots against the JAX model on the
same variables (float32 on the CPU, atol 1e-4), a reference torch
snapshot.pt (with and without DDP's ``module.`` prefix) against the msgpack
route, save_snapshot's file read back by the reference package's
load_snapshot, and InferenceServer.from_snapshot on the CPU."""

import functools
import os

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from diffusionremotesensing_tpu.io import (
    export_torch_state_dict,
    import_torch_state_dict,
    load_snapshot as jax_load_snapshot,
)
from diffusionremotesensing_tpu.models.unet import residual_attention_unet_superres as jax_superres
from diffusionremotesensing_tpu_torch import io
from diffusionremotesensing_tpu_torch.models.unet import (
    residual_attention_unet_superres as torch_superres,
)
from diffusionremotesensing_tpu_torch.serving import InferenceServer

ARTIFACTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "benchmarks", "gate_artifacts")
SNAPSHOTS = {"x2": ("snapshot_x2.pt", 2), "x4": ("snapshot_x4.pt", 4)}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _assert_trees_bitwise_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (np.ndarray, jnp.ndarray)):
            w = np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert g.tobytes() == w.tobytes(), k
        else:
            assert type(g) is type(w) and g == w, k


@functools.lru_cache(maxsize=None)
def _snapshot(name):
    """One in-repo snapshot, read once: its path, magnification, bytes,
    flax's tree and the port reader's tree."""
    fname, factor = SNAPSHOTS[name]
    path = os.path.join(ARTIFACTS, fname)
    with open(path, "rb") as f:
        data = f.read()
    return {"name": name, "path": path, "factor": factor, "data": data,
            "flax": serialization.msgpack_restore(data), "port": io.msgpack_restore(data)}


@pytest.fixture(params=sorted(SNAPSHOTS))
def snapshot(request):
    return _snapshot(request.param)


def test_reader_matches_flax_on_the_snapshots(snapshot):
    _assert_trees_bitwise_equal(snapshot["port"], snapshot["flax"])
    assert sorted(snapshot["port"]["MODEL_STATE"]) == ["batch_stats", "params"]
    if snapshot["name"] == "x2":
        assert snapshot["port"]["EPOCHS_RUN"] == 1946


def test_writer_rewrites_the_snapshots_byte_for_byte(snapshot):
    """flax's tree through the port's writer: the file's own bytes, which are
    also what flax's msgpack_serialize writes."""
    assert io.packb(snapshot["flax"]) == snapshot["data"]
    assert serialization.msgpack_serialize(snapshot["flax"]) == snapshot["data"]


def _every_width():
    rng = np.random.default_rng(0)
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1, -1, -32, -33,
            -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]
    return {
        "ints": ints, "floats": [0.0, -1.5, 1e300, float("inf")], "flags": [True, False, None],
        "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 65536, "é中"],
        "bins": [b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 65536],
        "lists": [[], list(range(15)), list(range(16)), list(range(65536))],
        "maps": {"small": {str(i): i for i in range(15)}, "map16": {str(i): i for i in range(16)},
                 "map32": {str(i): i for i in range(65536)}},
        "arrays": {"f32": rng.standard_normal((3, 4)).astype(np.float32),
                   "f64": rng.standard_normal(5), "i8": np.arange(-3, 3, dtype=np.int8),
                   "u16": np.arange(7, dtype=np.uint16), "bool": np.array([True, False]),
                   "empty": np.zeros((0, 3), np.float32), "scalar0d": np.array(2.5, np.float32),
                   "big": rng.standard_normal(70000).astype(np.float32)},
        "npscalars": [np.float32(1.25), np.int64(-7), np.bool_(True)],
        "complex": 1.5 - 2.0j,
    }


def test_msgpack_every_width_matches_msgpack_and_flax():
    """Each kind at each of its widths (fix, 8, 16 and 32 bits; ints to 64),
    flax's three extension types, as msgpack-python writes them with flax's
    hook: the port reads them back as flax does. The port's writer, on the
    kinds a snapshot holds (maps, str, int, bin, arrays), writes
    msgpack-python's bytes, and refuses the others."""
    tree = _every_width()
    want = msgpack.packb(tree, default=serialization._msgpack_ext_pack, strict_types=True)
    restored = io.unpackb(want)
    flax_restored = serialization.msgpack_restore(want)
    assert restored["ints"] == tree["ints"] and restored["strs"] == tree["strs"]
    assert restored["bins"] == tree["bins"] and restored["lists"] == tree["lists"]
    assert restored["maps"] == tree["maps"] and restored["flags"] == tree["flags"]
    assert restored["floats"] == tree["floats"] and restored["complex"] == tree["complex"]
    for k, a in tree["arrays"].items():
        got = restored["arrays"][k]
        assert got.dtype == a.dtype and got.shape == a.shape and got.tobytes() == a.tobytes()
        assert np.array_equal(got, flax_restored["arrays"][k])
    for got, want_s in zip(restored["npscalars"], tree["npscalars"]):
        assert type(got) is type(want_s) and got == want_s
    writable = {"maps": tree["maps"], "arrays": tree["arrays"],
                **{kind: dict(zip(map(str, range(len(tree[kind]))), tree[kind]))
                   for kind in ("ints", "strs", "bins")}}
    assert io.packb(writable) == msgpack.packb(
        writable, default=serialization._msgpack_ext_pack, strict_types=True)
    for v in (1.5, True, None, [1], np.float32(1.25), 1.5 - 2.0j):
        with pytest.raises(TypeError):
            io.packb({"a": v})


def test_reader_takes_bfloat16_and_chunked_arrays(monkeypatch):
    """A bfloat16 leaf (numpy has no bfloat16) widens to float32 exactly; an
    array flax split into chunks comes back whole."""
    vals = np.array([1.0, -2.5, 3.140625, 1e-3], np.float32)
    data = serialization.msgpack_serialize({"w": jnp.asarray(vals, jnp.bfloat16)})
    got = io.msgpack_restore(data)["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(
        got, np.asarray(jnp.asarray(vals, jnp.bfloat16).astype(jnp.float32)))
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    big = np.arange(100, dtype=np.float32).reshape(4, 25)
    data = serialization.msgpack_serialize({"a": {"big": big}, "n": 3})
    assert b"__msgpack_chunked_array__" in data
    got = io.msgpack_restore(data)
    np.testing.assert_array_equal(got["a"]["big"], big)
    assert got["n"] == 3
    with pytest.raises(ValueError):
        io.unpackb(data + b"\x00")  # bytes after the object


def _inputs(factor, hr=64):
    rng = np.random.default_rng(21)
    x = rng.standard_normal((1, hr, hr, 3)).astype(np.float32)
    t = np.array([600], np.int32)
    cond = rng.random((1, hr // factor, hr // factor, 3)).astype(np.float32)
    return x, t, cond


@pytest.mark.parametrize("s2d", [False, True], ids=["dense", "s2d"])
def test_loaded_model_matches_jax(snapshot, s2d):
    """The port's model built with the snapshot's magnification and loaded
    by load_snapshot, against the JAX model on the variables the reference
    package's load_snapshot returns: B=1, HR 64, float32, atol 1e-4."""
    state, epochs = io.load_snapshot(snapshot["path"])
    assert epochs == snapshot["port"]["EPOCHS_RUN"]
    model = torch_superres(magnification_factor=snapshot["factor"], s2d=s2d)
    model.load_state_dict(state, strict=True)
    jstate, _ = jax_load_snapshot(snapshot["path"])
    x, t, cond = _inputs(snapshot["factor"])
    want = np.asarray(jax_superres(magnification_factor=snapshot["factor"], s2d=s2d).apply(
        {"params": jstate["params"], "batch_stats": jstate["batch_stats"]}, x, t, cond,
        train=False))
    with torch.no_grad():
        got = model.eval()(*(torch.from_numpy(a) for a in (x, t, cond))).numpy()
    assert got.shape == want.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("prefix", ["", "module."], ids=["plain", "ddp"])
def test_torch_snapshot_loads_like_the_msgpack(tmp_path, prefix):
    """A reference snapshot.pt written from the JAX package's
    export_torch_state_dict (strict reference names, each BatchNorm under
    both of its names): to_jax_variables gives the reference importer's tree
    bitwise, and load_snapshot the msgpack route's state_dict."""
    snapshot = _snapshot("x2")
    variables = {k: snapshot["flax"]["MODEL_STATE"][k] for k in ("params", "batch_stats")}
    sd = {prefix + k: v for k, v in export_torch_state_dict(variables).items()}
    path = tmp_path / "snapshot.pt"
    torch.save({"MODEL_STATE": sd, "EPOCHS_RUN": 17}, path)
    params, stats = io.to_jax_variables(sd)
    want = import_torch_state_dict(sd)
    _assert_trees_bitwise_equal(params, want["params"])
    _assert_trees_bitwise_equal(stats, want["batch_stats"])
    got, epochs = io.load_snapshot(str(path))
    ref, _ = io.load_snapshot(snapshot["path"])
    assert epochs == 17 and got.keys() == ref.keys()
    assert all(torch.equal(got[k], ref[k]) for k in ref)


def test_save_snapshot_reads_back_in_jax(snapshot, tmp_path):
    """The port's model with the snapshot's weights, saved by save_snapshot:
    the reference package's load_snapshot reads the same variables bitwise,
    and the file is the original's bytes."""
    state, epochs = io.load_snapshot(snapshot["path"])
    model = torch_superres(magnification_factor=snapshot["factor"])
    model.load_state_dict(state, strict=True)
    path = str(tmp_path / "sub" / "snapshot.msgpack")
    io.save_snapshot(path, model, epochs)
    assert os.listdir(tmp_path / "sub") == ["snapshot.msgpack"]  # no temporary left behind
    jstate, jepochs = jax_load_snapshot(path)
    assert jepochs == epochs
    _assert_trees_bitwise_equal({k: jstate[k] for k in ("params", "batch_stats")},
                                snapshot["flax"]["MODEL_STATE"])
    with open(path, "rb") as f:
        assert f.read() == snapshot["data"]


def test_server_from_snapshot_on_the_cpu():
    """InferenceServer.from_snapshot builds the model with the flags given,
    loads the weights strictly and serves a micro-batch."""
    path = os.path.join(ARTIFACTS, SNAPSHOTS["x2"][0])
    server = InferenceServer.from_snapshot(path, "cosine", 1500, 32,
                                           model_flags=dict(s2d=True, tap44="block"),
                                           ddim_steps=2, max_batch=1, device="cpu")
    try:
        assert server.model.s2d and server.model.tap44 == "block"
        state, _ = io.load_snapshot(path)
        assert all(torch.equal(v, state[k]) for k, v in server.model.state_dict().items())
        lr = np.random.default_rng(22).random((16, 16, 3)).astype(np.float32)
        out = server.infer_batch([lr])[0]
        assert out.shape == (32, 32, 3) and np.isfinite(out).all()
        assert out.min() >= 0.0 and out.max() <= 1.0
    finally:
        server.shutdown()


def test_orbax_directory_is_refused(tmp_path):
    """A directory is read as an Orbax checkpoint: one without a committed
    step is refused as the reference package refuses it; a step still being
    written is not one."""
    with pytest.raises(FileNotFoundError, match="no committed orbax checkpoint"):
        io.load_snapshot(str(tmp_path))
    os.makedirs(tmp_path / ("0" + io.ORBAX_TMP_SUFFIX))
    with pytest.raises(FileNotFoundError, match="no committed orbax checkpoint"):
        io.load_snapshot(str(tmp_path))
