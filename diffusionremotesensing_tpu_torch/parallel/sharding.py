"""Data parallelism (port of ``diffusionremotesensing_tpu/parallel/sharding.py``).

The JAX package's one device mesh covers two different things, which are
two mechanisms here, both named by one :class:`Mesh`:

* **Training: one process per device over ``torch.distributed``**, as the
  reference ran DDP over NCCL: ``torchrun --nproc_per_node=N`` starts the
  processes, :func:`initialize_distributed` joins them (NCCL for CUDA
  devices, gloo for the CPU, named explicitly), each rank loads its shard of
  the dataset and trains on its slice of the global batch. The trainer
  broadcasts the parameters from rank 0, sums the gradients over the group,
  and train-mode BatchNorm reduces its statistics over the global batch
  (``models.blocks.global_batch_statistics``): the JAX package's sharded
  step computes them over the global batch too (SyncBN semantics; the
  reference's DDP kept them per replica).
* **Aggregation and serving: one process over a list of local devices,
  without collectives**, as the JAX versions are collective-free. The
  model is replicated onto each device, the patch or request axis is split
  over the replicas, each launches on its own device's current stream, and
  the outputs are gathered on the host. ``make_mesh([cuda:0, cuda:0])``
  drives the split on one card with two replicas. Under a process group of
  more than one rank aggregation also splits the patch axis over the ranks
  and ``all_gather`` gives every rank the whole tile.

``Mesh.size`` counts the replicas of the whole mesh, ranks times local
devices, as ``mesh.devices.size`` does in the JAX package.
:func:`is_main_process` is the reference's rank-0 guard for writes.

:func:`spatial_sharding` names the other placement of the JAX package's
mesh: one image's height split into equal bands over the mesh's devices
(local devices in one process, or one device a rank of a process group),
each band a replica of the model that exchanges halo rows with its
neighbours (``parallel.halo``). The samplers take it beside ``mesh=``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "initialize_distributed", "process_device", "local_devices", "make_mesh",
           "batch_sharding", "shard_batch", "split_rows", "replicated_sharding",
           "global_replicated", "all_gather_rows", "is_main_process", "SpatialSharding",
           "spatial_sharding"]

# the backend of each device type; there is no other choice and no fallback
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-axis data-parallel mesh: ``devices``, this process's replicas (one
    per entry; an entry may repeat), and ``group``, the process group whose
    ranks split the batch with it (None: this process alone)."""

    devices: Tuple[torch.device, ...]
    group: Any = None

    @property
    def world(self) -> int:
        """Ranks of the group (1 without one)."""
        return dist.get_world_size(self.group) if self.group is not None else 1

    @property
    def rank(self) -> int:
        """This process's rank in the group (0 without one)."""
        return dist.get_rank(self.group) if self.group is not None else 0

    @property
    def size(self) -> int:
        """Replicas of the whole mesh: ranks x local devices."""
        return self.world * len(self.devices)

    @property
    def device(self) -> torch.device:
        """This process's first device, where its collectives run."""
        return self.devices[0]


def process_device(kind: str = "cuda") -> torch.device:
    """This process's device of type ``kind``: ``cuda:LOCAL_RANK`` (torchrun's
    local rank, 0 without one) or the CPU."""
    if kind == "cuda":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return torch.device(kind)


def initialize_distributed(device_type: str = "cuda", init_method: str = "env://") -> bool:
    """Join the process group torchrun describes (``WORLD_SIZE``, ``RANK``,
    and ``MASTER_ADDR``/``MASTER_PORT`` for ``init_method`` env://, or a
    ``file://`` store): the backend is ``BACKENDS[device_type]`` (NCCL for
    CUDA, gloo for the CPU); a CUDA process first binds its
    local rank's card. A no-op in one process (no ``WORLD_SIZE`` above 1)
    and when the group exists. Returns whether a group of more than one
    rank is up."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    if device_type == "cuda":
        torch.cuda.set_device(process_device("cuda"))
    dist.init_process_group(BACKENDS[device_type], init_method=init_method,
                            rank=int(os.environ["RANK"]), world_size=world)
    return True


def local_devices(kind: str = "cuda") -> List[torch.device]:
    """The replicas a mesh over ``kind`` holds in this process: in a process
    group its own device (:func:`process_device`), else every card
    (``cuda``) or the CPU once."""
    if _in_group() or kind != "cuda":
        return [process_device(kind)]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A 1-axis mesh over ``devices`` (default :func:`local_devices` of the
    card, or of the CPU where there is none) and, when this process is in a
    process group (of any size), the world group: the trainer then takes
    its collective path, a world of one included."""
    if devices is None:
        devices = local_devices("cuda" if torch.cuda.is_available() else "cpu")
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("make_mesh: no devices")
    return Mesh(devices, dist.group.WORLD if _in_group() else None)


def split_rows(n: int, parts: int) -> List[Tuple[int, int]]:
    """[lo, hi) of each of ``parts`` equal slices of n rows."""
    if n % parts:
        raise ValueError(f"{n} rows do not split into {parts} equal parts: pad the batch to a "
                         f"multiple of the mesh size")
    k = n // parts
    return [(i * k, (i + 1) * k) for i in range(parts)]


@dataclasses.dataclass(frozen=True)
class SpatialSharding:
    """One image's height split over ``mesh``: band i of ``mesh.size`` holds
    rows :meth:`band_rows` ``(H)[i]`` of every image-like tensor of a
    sampler call (x_T, the condition image, the state, the noise); band i
    lives on rank i // len(devices), local device i % len(devices)."""

    mesh: Mesh

    @property
    def bands(self) -> int:
        return self.mesh.size

    def band_rows(self, height: int) -> List[Tuple[int, int]]:
        """[lo, hi) of each band's rows of an image of ``height`` rows; raises
        unless the height is a multiple of 8 x the mesh size (the UNet's
        three stride-2 stages: every band starts on an even row at each of
        levels 0-2 and holds whole rows at 1/8)."""
        n = self.bands
        if height % (8 * n):
            raise ValueError(f"spatial sharding: the image height {height} must be a multiple of "
                             f"8 x the mesh size ({8 * n}): the UNet downsamples by 8 and every "
                             "band must start on an even row of each level")
        return split_rows(height, n)

    def local_bands(self) -> List[int]:
        """The bands this process holds, one a local device."""
        m = self.mesh
        if m.world > 1 and len(m.devices) > 1:
            raise NotImplementedError("spatial sharding over a process group takes one device a "
                                      "rank (ROADMAP Queue 1: spatial partitioning, what stays "
                                      "out)")
        local = len(m.devices)
        return list(range(m.rank * local, (m.rank + 1) * local))


def spatial_sharding(mesh: Mesh) -> SpatialSharding:
    """Split the image HEIGHT of a sampler call over ``mesh``: the JAX
    package's ``spatial_sharding`` (its ``P(None, axis)`` on NHWC tensors),
    where XLA writes the convolutions' halo exchanges; here each band runs
    the model on its rows and ``parallel.halo`` exchanges the halos. Pass it
    as ``spatial=`` to ``DiffusionProcess.sampler``, ``ddim_sampler`` or
    ``sample``. The height must be a multiple of 8 x ``mesh.size``."""
    return SpatialSharding(mesh)


def batch_sharding(mesh: Optional[Mesh]) -> Tuple[int, int]:
    """(shards, this process's shard) of a batch over the mesh's ranks:
    (1, 0) without a group."""
    return (1, 0) if mesh is None else (mesh.world, mesh.rank)


def _take(x, lo: int, hi: int, axis: int):
    if torch.is_tensor(x) or isinstance(x, np.ndarray):
        if x.ndim <= axis:
            return x  # a scalar or a per-batch value: replicated
        idx = (slice(None),) * axis + (slice(lo, hi),)
        return x[idx]
    if isinstance(x, dict):
        return {k: _take(v, lo, hi, axis) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_take(v, lo, hi, axis) for v in x)
    return x


def shard_batch(batch, mesh: Optional[Mesh], batch_axis: int = 0):
    """This rank's slice of a global batch (a tensor, array, or a dict /
    list of them) along ``batch_axis`` (1 for the (K, B, ...) stacks of
    ``steps_per_dispatch > 1``); its rows divide evenly over the ranks.
    Leaves with no such axis are replicated. Without a mesh or a group the
    batch itself."""
    if mesh is None or mesh.world == 1:
        return batch

    def rows(x):
        if torch.is_tensor(x) or isinstance(x, np.ndarray):
            return x.shape[batch_axis] if x.ndim > batch_axis else None
        if isinstance(x, dict):
            x = list(x.values())
        if isinstance(x, (list, tuple)):
            return next((r for r in map(rows, x) if r is not None), None)
        return None

    n = rows(batch)
    if n is None:
        return batch
    lo, hi = split_rows(n, mesh.world)[mesh.rank]
    return _take(batch, lo, hi, batch_axis)


def replicated_sharding(mesh: Mesh) -> Tuple[Any, int]:
    """(group, global rank of its rank 0): the source every rank's copy of a
    replicated value comes from."""
    src = dist.get_global_rank(mesh.group, 0) if mesh.group is not None else 0
    return mesh.group, src


def global_replicated(x, mesh: Optional[Mesh]):
    """``x`` as rank 0 of the mesh's group holds it, on every rank: a tensor
    (returned on its own device) or a ``torch.Generator`` (its state set to
    rank 0's in place). Without a group, ``x`` itself."""
    if mesh is None or mesh.group is None:
        return x
    group, src = replicated_sharding(mesh)
    if isinstance(x, torch.Generator):
        state = x.get_state().to(mesh.device)
        dist.broadcast(state, src=src, group=group)
        x.set_state(state.cpu())
        return x
    t = x.detach().to(mesh.device).contiguous().clone()
    dist.broadcast(t, src=src, group=group)
    return t.to(x.device)


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated in rank order along
    the first axis, on every rank (through the host under gloo, whose
    all-gather takes CPU tensors)."""
    if mesh.group is None:
        return x
    via = mesh.device if dist.get_backend(mesh.group) == "nccl" else torch.device("cpu")
    t = x.to(via).contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.world)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts).to(x.device)


def is_main_process() -> bool:
    """The rank-0 guard for snapshot, metric and preview writes (the
    reference's ``self.device == 0``): True in one process."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
