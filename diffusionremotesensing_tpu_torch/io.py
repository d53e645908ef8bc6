"""Snapshot load and save (port of ``diffusionremotesensing_tpu/io.py``).

A snapshot holds the model's weights and the epochs run, in any of the
three formats the reference package reads:

* its own, flax's msgpack (``flax.serialization.msgpack_serialize`` of
  ``{'EPOCHS_RUN': int, 'MODEL_STATE': {'batch_stats': ..., 'params': ...}}``),
  one file, which :func:`save_snapshot` writes and :func:`load_snapshot`
  reads with a msgpack reader and writer of the standard library's own (the
  card's machine has neither ``msgpack`` nor ``flax``);
* the reference's torch ``snapshot.pt`` (``{'MODEL_STATE': state_dict,
  'EPOCHS_RUN': int}``, optionally with DDP's ``module.`` prefix), read with
  ``torch.load`` and mapped through :func:`to_jax_variables`, the port's copy
  of ``import_torch_state_dict``;
* an Orbax checkpoint directory, as the reference package's
  ``OrbaxSnapshotter`` writes it: one step directory a save,
  ``<path>/<step>/``, holding ``_CHECKPOINT_METADATA`` (JSON),
  ``default/_METADATA`` (the tree's metadata, JSON) and an OCDBT key-value
  store in ``default/`` whose arrays are zarr v2, one zstd-1 chunk each,
  keyed by their dotted path (``MODEL_STATE.params.conv0.conv.kernel``;
  ``EPOCHS_RUN`` a 0-d int64). :class:`OrbaxSnapshotter` writes it in a
  background thread and :func:`load_snapshot_orbax` reads its latest
  committed step, both through ``tensorstore`` (imported inside them: it
  is needed only by this format) and neither through ``orbax`` nor JAX.

Either way :func:`load_snapshot` returns a state_dict for
:class:`~diffusionremotesensing_tpu_torch.models.unet.ResidualAttentionUNet`
of the snapshot's model (super-resolution, SAR->NDVI or class-conditional,
read from its variables), through
:func:`~diffusionremotesensing_tpu_torch.convert.from_jax_variables`.

Example:
    state, epochs = load_snapshot("snapshot_x2.pt")
    model = residual_attention_unet_superres(magnification_factor=2, s2d=True)
    model.load_state_dict(state)
    save_snapshot("copy.msgpack", model, epochs)
    writer = OrbaxSnapshotter("ckpt")       # a directory
    writer.save(model, epochs)              # returns before the write is done
    writer.wait_until_finished()
    state, epochs = load_snapshot("ckpt")
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import tempfile
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from diffusionremotesensing_tpu_torch.convert import from_jax_variables

# flax's msgpack extension types (flax/serialization.py: _MsgpackExtType)
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
_TORCH_HEADS = (b"PK", b"\x80\x02", b"\x80\x04", b"\x80\x05")  # torch zip, legacy pickle


# ---------------------------------------------------------------- msgpack

class _Reader:
    """msgpack decoding of ``data`` from ``pos``: maps, arrays, str, bin,
    ext, ints, floats, bool and nil, each at every width the format has.
    ``raw`` keeps str as bytes (flax decodes an ndarray's inner tuple so)."""

    def __init__(self, data: bytes, raw: bool = False):
        self.data, self.pos, self.raw = memoryview(data), 0, raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: data ends inside an object")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def num(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.num("b")
        return _unpack_ext(code, bytes(self.take(n)))

    def obj(self):
        t = self.num("B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map_(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.obj() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.str_(t & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        scalars = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                   0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if t in scalars:
            return self.num(scalars[t])
        sizes = {0xC4: "B", 0xC5: "H", 0xC6: "I", 0xC7: "B", 0xC8: "H", 0xC9: "I",
                 0xD9: "B", 0xDA: "H", 0xDB: "I", 0xDC: "H", 0xDD: "I", 0xDE: "H", 0xDF: "I"}
        if t in sizes:
            n = self.num(sizes[t])
            if t <= 0xC6:
                return bytes(self.take(n))
            if t <= 0xC9:
                return self.ext(n)
            if t <= 0xDB:
                return self.str_(n)
            if t <= 0xDD:
                return [self.obj() for _ in range(n)]
            return self.map_(n)
        if 0xD4 <= t <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (t - 0xD4))
        raise ValueError(f"msgpack: byte 0x{t:02x} at {self.pos - 1} starts no object")

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def unpackb(data: bytes, raw: bool = False):
    """The one msgpack object in ``data``."""
    r = _Reader(data, raw)
    out = r.obj()
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} bytes after the object")
    return out


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    """flax's ndarray encoding: msgpack (shape, dtype name, C-order bytes).
    bfloat16, which numpy lacks, is widened to float32 exactly."""
    shape, name, buf = unpackb(data, raw=True)
    if name == b"bfloat16":
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(name.decode())).reshape(shape)


def _unpack_ext(code: int, data: bytes):
    """flax's extension types; any other code comes back as (code, data)."""
    if code == EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    if code == EXT_COMPLEX:
        re, im = unpackb(data)
        return complex(re, im)
    return code, data


class _Writer:
    """msgpack encoding of what :func:`save_snapshot` writes, as
    msgpack-python's ``packb(use_bin_type=True)`` emits it, every value in
    its shortest form: dicts, str, int, bytes, tuples (an ndarray's header)
    and numpy arrays as flax's extension type 1. Any other type raises
    TypeError."""

    def __init__(self):
        self.out = bytearray()

    def head(self, n: int, fix: int, code16: int, code32: int):
        """A map's or an array's header: fix | n below 16 entries."""
        if n < 16:
            self.out.append(fix | n)
        elif n < 1 << 16:
            self.out += struct.pack(">BH", code16, n)
        else:
            self.out += struct.pack(">BI", code32, n)

    def sized(self, n: int, codes: Tuple[int, int, int]):
        for code, fmt, top in zip(codes, "BHI", (1 << 8, 1 << 16, 1 << 32)):
            if n < top:
                self.out += struct.pack(">B" + fmt, code, n)
                return
        raise ValueError(f"msgpack: an object of {n} bytes is too long")

    def int_(self, v: int):
        if 0 <= v < 0x80 or -0x20 <= v < 0:
            self.out += struct.pack(">b" if v < 0 else ">B", v)
            return
        for code, fmt, lo, hi in ((0xCC, "B", 0, 0xFF), (0xD0, "b", -0x80, -1),
                                  (0xCD, "H", 0, 0xFFFF), (0xD1, "h", -0x8000, -1),
                                  (0xCE, "I", 0, 0xFFFFFFFF), (0xD2, "i", -0x80000000, -1),
                                  (0xCF, "Q", 0, (1 << 64) - 1), (0xD3, "q", -(1 << 63), -1)):
            if lo <= v <= hi:
                self.out += struct.pack(">B" + fmt, code, v)
                return
        raise OverflowError(f"msgpack: integer {v} takes more than 64 bits")

    def ext(self, code: int, data: bytes):
        n = len(data)
        if n in (1, 2, 4, 8, 16):
            self.out += struct.pack(">Bb", 0xD4 + n.bit_length() - 1, code)
        else:
            self.sized(n, (0xC7, 0xC8, 0xC9))
            self.out += struct.pack(">b", code)
        self.out += data

    def obj(self, v):
        if type(v) is int:
            self.int_(v)
        elif type(v) is str:
            b = v.encode("utf-8")
            if len(b) < 32:
                self.out.append(0xA0 | len(b))
            else:
                self.sized(len(b), (0xD9, 0xDA, 0xDB))
            self.out += b
        elif type(v) is bytes:
            self.sized(len(v), (0xC4, 0xC5, 0xC6))
            self.out += v
        elif type(v) is tuple:
            self.head(len(v), 0x90, 0xDC, 0xDD)
            for e in v:
                self.obj(e)
        elif type(v) is dict:
            self.head(len(v), 0x80, 0xDE, 0xDF)
            for k, e in v.items():
                self.obj(k)
                self.obj(e)
        elif isinstance(v, np.ndarray):
            self.ext(EXT_NDARRAY, _ndarray_to_bytes(v))
        else:
            raise TypeError(f"msgpack: cannot encode {type(v).__name__}")


def packb(obj) -> bytes:
    """``obj`` as msgpack bytes (see :class:`_Writer`): what flax's
    ``msgpack_serialize`` writes for a tree of dicts, ints, strings and
    numpy arrays. flax splits an array past 2**30 bytes into chunks, this
    writes it whole; the model's largest holds 2.4 MB."""
    w = _Writer()
    w.obj(obj)
    return bytes(w.out)


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("msgpack: object and structured dtypes are not serialisable")
    return packb((arr.shape, arr.dtype.name, arr.tobytes("C")))


def msgpack_restore(data: bytes):
    """flax's ``msgpack_restore``: the tree, with arrays that flax split
    into chunks (past 2**30 bytes) joined again."""
    return _unchunk(unpackb(data))


def _unchunk(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            chunks = tree["chunks"]
            flat = np.concatenate([chunks[str(i)] for i in range(len(chunks))])
            return flat.reshape(tuple(tree["shape"][str(i)] for i in range(len(tree["shape"]))))
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


# ------------------------------------------------- torch state_dict -> flax

def _conv_kernel(w: np.ndarray) -> np.ndarray:
    """torch OIHW conv weight -> flax HWIO."""
    return np.transpose(w, (2, 3, 1, 0))


def _convtranspose_kernel(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose2d IOHW weight -> the HWIO kernel of the equivalent
    forward (input-dilated) conv: spatial taps flipped."""
    return np.transpose(w[:, :, ::-1, ::-1], (2, 3, 0, 1))


def _assign(tree: dict, path, value):
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


_BN_LEAVES = {"weight": (0, "scale"), "bias": (0, "bias"), "running_mean": (1, "mean"),
              "running_var": (1, "var")}  # num_batches_tracked: dropped


def to_jax_variables(state_dict) -> Tuple[dict, dict]:
    """A reference torch state_dict (any of its three model classes,
    optionally under DDP's ``module.`` prefix) -> ``(params, batch_stats)``,
    nested dicts of numpy arrays in the reference package's flax layout:
    the port's copy of ``import_torch_state_dict``, and the inverse of
    :func:`~diffusionremotesensing_tpu_torch.convert.from_jax_variables`."""
    trees = ({}, {})  # params, batch_stats

    def bn(path, leaf, v):
        if leaf in _BN_LEAVES:
            which, name = _BN_LEAVES[leaf]
            _assign(trees[which], path + (name,), v)

    def conv(path, leaf, v, transpose=False):
        if leaf == "weight":
            _assign(trees[0], path + (("kernel",) if transpose else ("conv", "kernel")),
                    _convtranspose_kernel(v) if transpose else _conv_kernel(v))
        elif leaf == "bias":
            _assign(trees[0], path + (("bias",) if transpose else ("conv", "bias")), v)

    def linear(path, leaf, v):
        _assign(trees[0], path + ("linear", "kernel" if leaf == "weight" else "bias"),
                v.T if leaf == "weight" else v)

    def time_mlp(path, idx, leaf, v):
        linear(path + ("time_mlp", "fc1" if idx == "0" else "fc2"), leaf, v)

    def resblock(name, parts, v):
        child = parts[0]
        if child == "time_mlp":
            time_mlp((name,), parts[1], parts[2], v)
        elif child in ("conv1", "conv2", "shortcut_conv"):
            # [conv, BN(, relu)]: index 1 is the BatchNorm the reference also
            # registers as batch_norm1/2 / shortcut_batch_norm
            if parts[1] == "0":
                conv((name, child), parts[2], v)
            else:
                idx = {"conv1": 0, "conv2": 1, "shortcut_conv": 2}[child]
                bn((name, f"BatchNorm_{idx}"), parts[2], v)
        elif child in ("conv_upsampled_lr_img", "conv_SAR_img", "conv_skip"):
            conv((name, "conv_skip"), parts[1], v)
        elif child in ("batch_norm1", "batch_norm2", "shortcut_batch_norm"):
            idx = {"batch_norm1": 0, "batch_norm2": 1, "shortcut_batch_norm": 2}[child]
            bn((name, f"BatchNorm_{idx}"), parts[1], v)

    for key, tensor in state_dict.items():
        v = tensor.detach().to("cpu", torch.float32).numpy() if torch.is_tensor(tensor) \
            else np.asarray(tensor)
        parts = key.replace("module.", "").split(".")
        head = parts[0]
        if head in ("conv0", "output"):
            conv((head,), parts[1], v)
        elif head in ("conv_upsampled_lr_img", "conv_SAR_img"):
            conv(("conv_cond",), parts[1], v)
        elif head in ("LR_encoder", "SAR_encoder"):
            if parts[1] == "blocks":
                conv(("cond_encoder", f"block{parts[2]}", parts[3]), parts[4], v)
            elif parts[1] == "conv_out":
                conv(("cond_encoder", "conv_out"), parts[2], v)
        elif head == "label_emb":
            _assign(trees[0], ("label_emb", "embedding"), v)
        elif head == "conv_blocks":
            resblock(f"conv_block{parts[1]}", parts[2:], v)
        elif head == "bottle_neck":
            resblock("bottle_neck", parts[1:], v)
        elif head == "downs":
            conv((f"down{parts[1]}",), parts[2], v)
        elif head == "gating_signals":
            if parts[2] == "conv":
                conv((f"gating{parts[1]}", "conv"), parts[3], v)
            elif parts[2] == "batch_norm":
                bn((f"gating{parts[1]}", "BatchNorm_0"), parts[3], v)
        elif head == "attention_blocks":
            name, sub = f"attention{parts[1]}", parts[2]
            if sub in ("w_g", "w_x", "psi"):
                conv((name, sub), parts[4], v)
            elif sub == "result":
                if parts[3] == "0":
                    conv((name, "result_conv"), parts[4], v)
                else:
                    bn((name, "BatchNorm_0"), parts[4], v)
        elif head == "ups":
            name, sub = f"up{parts[1]}", parts[2]
            if sub == "time_mlp":
                time_mlp((name,), parts[3], parts[4], v)
            elif sub == "conv":
                conv((name, "conv"), parts[3], v)
            elif sub == "batch_norm":
                bn((name, "BatchNorm_0"), parts[3], v)
            elif sub == "transform":
                conv((name, "transform"), parts[3], v, transpose=True)
        elif head == "up_convs":
            conv((f"up_conv{parts[1]}",), parts[2], v)
        else:
            raise KeyError(f"Unrecognized torch checkpoint key: {key}")
    return trees


# --------------------------------------------------------------- snapshots

def load_snapshot(path: str) -> Tuple[Dict[str, torch.Tensor], int]:
    """(state_dict, epochs_run) of the snapshot at ``path``: a reference
    torch ``snapshot.pt`` (recognised by its first bytes), the reference
    package's flax msgpack, or an Orbax checkpoint directory
    (:func:`load_snapshot_orbax`). The state_dict is float32 on the CPU."""
    if os.path.isdir(path):  # Orbax checkpoints are directories
        return load_snapshot_orbax(path)
    with open(path, "rb") as f:
        head = f.read(2)
        if head not in _TORCH_HEADS:
            payload = msgpack_restore(head + f.read())
    if head in _TORCH_HEADS:
        snap = torch.load(path, map_location="cpu", weights_only=True)
        params, stats = to_jax_variables(snap["MODEL_STATE"])
        epochs = snap.get("EPOCHS_RUN", 0)
    else:
        state = payload["MODEL_STATE"]
        params, stats = state["params"], state.get("batch_stats", {})
        epochs = payload["EPOCHS_RUN"]
    return from_jax_variables(params, stats), int(epochs)


def _sorted(tree):
    """The tree with every dict's keys in order, as the reference package's
    ``tree_map`` leaves them before it serialises."""
    return {k: _sorted(tree[k]) for k in sorted(tree)} if isinstance(tree, dict) else tree


def save_snapshot(path: str, model: torch.nn.Module, epochs_run: int) -> None:
    """Write ``model``'s weights and ``epochs_run`` to ``path`` in the
    reference package's msgpack format (its ``load_snapshot`` reads it),
    atomically: a temporary file in the same directory, then a rename. The
    weights are stored in float32."""
    params, stats = to_jax_variables(model.state_dict())
    data = packb(_sorted({"MODEL_STATE": {"params": params, "batch_stats": stats},
                                      "EPOCHS_RUN": int(epochs_run)}))
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


# ------------------------------------------------------------------- Orbax

# orbax's suffix of a step directory still being written: its readers, and
# this module's, skip such a directory
ORBAX_TMP_SUFFIX = ".orbax-checkpoint-tmp"
# the item handler the reference package's writer records, by which orbax
# restores the step without being told how
_ORBAX_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
                  "StandardCheckpointHandler")
# the OCDBT store's settings as orbax makes them
_OCDBT_CONFIG = {"compression": {"id": "zstd"}, "max_decoded_node_bytes": 100_000_000,
                 "max_inline_value_bytes": 1024, "version_tree_arity_log2": 4}
_KEY_TYPE_DICT = 2  # orbax's tree metadata: a dict key


def require_tensorstore():
    """The ``tensorstore`` module, or an ImportError that names it and the
    backend that needs it."""
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError("the Orbax checkpoint backend needs the 'tensorstore' package, which "
                          "is not installed; the msgpack backend needs nothing more") from e
    return tensorstore


def _ocdbt(item_dir: str, key: str, **config) -> dict:
    """The kvstore spec of array ``key`` in the OCDBT store at ``item_dir``
    (``config``: a new store's settings)."""
    return {"driver": "ocdbt", "base": "file://" + os.path.abspath(item_dir) + "/",
            "path": key + "/", **config}


def _leaves(tree, prefix=()):
    """(path, leaf) of a tree of dicts, keys in sorted order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def committed_steps(path: str):
    """The step numbers of an Orbax checkpoint directory whose write has
    committed, ascending (a step still being written, or cut short, lies in
    a directory with ``ORBAX_TMP_SUFFIX`` and is not one)."""
    if not os.path.isdir(path):
        return []
    return sorted(int(n) for n in os.listdir(path)
                  if n.isdigit() and os.path.isdir(os.path.join(path, n)))


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def _write_orbax_item(item_dir: str, payload: dict) -> dict:
    """Every leaf of ``payload`` (numpy arrays; an int is a scalar) as a
    zarr v2 array of one zstd-1 chunk in a new OCDBT store at ``item_dir``,
    committed as one transaction; returns the tree metadata."""
    ts = require_tensorstore()
    os.makedirs(item_dir)
    leaves = list(_leaves(payload))
    # one atomic transaction over a cache that holds all of it: one OCDBT
    # commit of ~2 files. A cache of tensorstore's default size (0) writes
    # each array back as it goes: 20x the files and the bytes, 10x the time.
    nbytes = sum(np.asarray(v).nbytes for _, v in leaves)
    ctx = ts.Context({"cache_pool": {"total_bytes_limit": 2 * nbytes + (64 << 20)}})
    txn = ts.Transaction(atomic=True)
    writes, tree_metadata = [], {}
    for path, value in leaves:
        arr = np.asarray(value)
        key = ".".join(path)
        meta = {"shape": list(arr.shape), "chunks": list(arr.shape), "dtype": arr.dtype.str,
                "compressor": {"id": "zstd", "level": 1}, "fill_value": None, "filters": None,
                "order": "C", "dimension_separator": ".", "zarr_format": 2}
        store = ts.open({"driver": "zarr", "kvstore": _ocdbt(item_dir, key, config=_OCDBT_CONFIG),
                         "metadata": meta,
                         "store_data_equal_to_fill_value": True},
                        create=True, transaction=txn, context=ctx).result()
        writes.append(store.write(arr))
        tree_metadata[str(path)] = {
            "key_metadata": [{"key": k, "key_type": _KEY_TYPE_DICT} for k in path],
            "value_metadata": {"value_type": "np.ndarray" if isinstance(value, np.ndarray)
                               else "scalar", "skip_deserialize": False}}
    for w in writes:
        w.result()
    txn.commit_async().result()
    return tree_metadata


def write_orbax_step(step_dir: str, payload: dict) -> None:
    """Write ``payload`` as one Orbax step at ``step_dir``: into the sibling
    ``step_dir + ORBAX_TMP_SUFFIX`` first (the leftovers of a write cut short
    there are removed), renamed to ``step_dir`` once every array and both
    metadata files are written."""
    tmp = step_dir + ORBAX_TMP_SUFFIX
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    init_ns = time.time_ns()
    tree_metadata = _write_orbax_item(os.path.join(tmp, "default"), payload)
    _write_json(os.path.join(tmp, "default", "_METADATA"),
                {"tree_metadata": tree_metadata, "use_ocdbt": True, "use_zarr3": False,
                 "store_array_data_equal_to_fill_value": True, "custom_metadata": None})
    _write_json(os.path.join(tmp, "_CHECKPOINT_METADATA"),
                {"item_handlers": {"default": _ORBAX_HANDLER}, "metrics": {},
                 "performance_metrics": {}, "init_timestamp_nsecs": init_ns,
                 "commit_timestamp_nsecs": time.time_ns(), "custom_metadata": {}})
    os.rename(tmp, step_dir)


def _copied(tree):
    """The tree with every leaf a float32 copy of its own: the numpy arrays
    of a model on the CPU are views of its tensors, which training goes on
    to change."""
    return {k: _copied(v) if isinstance(v, dict) else np.array(v, np.float32, order="C")
            for k, v in tree.items()}


class OrbaxSnapshotter:
    """The reference package's ``OrbaxSnapshotter`` without orbax: one
    logical snapshot, a directory at ``path`` with one step directory a
    save, whose latest committed step :func:`load_snapshot` reads.

    ``save`` copies the weights to host memory (float32 numpy, the tree
    :func:`save_snapshot` writes) and returns; a background thread writes
    the step (:func:`write_orbax_step`: temporary directory, then rename)
    and only then deletes the steps before it, so that a write cut short
    leaves the last committed one. At most one write is in flight: ``save``
    first waits for the one before. An error of the writer is raised by the
    next ``save``, ``wait_until_finished`` or ``close``.

    The step is a save counter, one past the latest committed step when
    the snapshotter is made, never the epoch (which rides in the payload):
    a resumed run saves again the epoch it restarted from. Under a process
    group every rank calls ``save`` alike and only ``primary`` writes (the
    weights are replicated); the caller's barrier after
    ``wait_until_finished`` keeps the others until the step is committed."""

    def __init__(self, path: str, primary: bool = True):
        require_tensorstore()  # the named ImportError before any training
        self.path = os.path.abspath(path)
        self.primary = primary
        steps = committed_steps(self.path)
        self._next_step = steps[-1] + 1 if steps else 0
        self._thread = None
        self._error = None

    def save(self, model: Optional[torch.nn.Module], epochs_run: int) -> None:
        """Copy ``model``'s weights and start writing them with ``epochs_run``
        as the next step; returns before the write is done. A rank that is
        not ``primary`` only counts the step (``model`` may be None)."""
        self.wait_until_finished()
        step = self._next_step
        self._next_step += 1
        if not self.primary:
            return
        params, stats = to_jax_variables(model.state_dict())
        payload = {"MODEL_STATE": {"params": _copied(params), "batch_stats": _copied(stats)},
                   "EPOCHS_RUN": np.int64(epochs_run)}
        self._thread = threading.Thread(target=self._write, args=(step, payload),
                                        name=f"orbax-step-{step}")
        self._thread.start()

    def _write(self, step: int, payload: dict) -> None:
        try:
            write_orbax_step(os.path.join(self.path, str(step)), payload)
            for old in committed_steps(self.path):
                if old < step:
                    shutil.rmtree(os.path.join(self.path, str(old)))
        except Exception as e:  # raised again on the caller's thread
            self._error = e

    def wait_until_finished(self) -> None:
        """Wait for the write in flight; raise its error, if it had one."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if err is not None:
            raise err

    def close(self) -> None:
        self.wait_until_finished()


def load_snapshot_orbax(path: str) -> Tuple[Dict[str, torch.Tensor], int]:
    """(state_dict, epochs_run) of the latest committed step of the Orbax
    checkpoint directory ``path`` (written by :class:`OrbaxSnapshotter` or
    by the reference package's), as :func:`load_snapshot` returns them."""
    ts = require_tensorstore()
    steps = committed_steps(path)
    if not steps:
        raise FileNotFoundError(f"no committed orbax checkpoint under {path}")
    item_dir = os.path.join(path, str(steps[-1]), "default")
    with open(os.path.join(item_dir, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt") or meta.get("use_zarr3"):
        raise ValueError(f"{item_dir}: an Orbax item of zarr v2 arrays in an OCDBT store is "
                         f"read, found use_ocdbt={meta.get('use_ocdbt')}, "
                         f"use_zarr3={meta.get('use_zarr3')}")
    reads = []
    for entry in meta["tree_metadata"].values():
        keys = tuple(k["key"] for k in entry["key_metadata"])
        store = ts.open({"driver": "zarr", "kvstore": _ocdbt(item_dir, ".".join(keys))},
                        open=True, read=True).result()
        reads.append((keys, store.read()))
    tree: dict = {}
    for keys, r in reads:
        _assign(tree, keys, r.result())
    state = tree["MODEL_STATE"]
    return (from_jax_variables(state["params"], state.get("batch_stats", {})),
            int(tree["EPOCHS_RUN"]))
