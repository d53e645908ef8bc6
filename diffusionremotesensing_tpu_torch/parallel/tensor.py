"""Tensor-parallel training over a 2-axis (data, model) mesh (port of
``diffusionremotesensing_tpu/parallel/tensor.py``).

At 4.4M parameters the model needs no tensor parallelism for memory: the
default replicates the parameters and splits the batch
(``parallel.sharding``). This module is for wider UNets and to exercise two
axes: the widest convolutions (and dense layers) are split on their output
channels over the ``model`` axis, everything else stays replicated.

The world's ranks form an ``n_data x n_model`` grid, rank = d * n_model + m:
the ``model`` groups are the rows (the ranks that share a batch and split a
layer's output channels), the ``data`` groups the columns (the ranks that
hold the same channels of different batches). A split layer keeps its
whole weight on every rank, as a replicated parameter does, so snapshots,
the EMA and resuming see the model as it is; each rank convolves its slice
of the output channels and an all-gather along channels (autograd-aware)
gives every rank the whole output, as XLA's sharding propagation does for
the JAX package. Backward: each rank takes its slice of the gathered
output's gradient, the input's gradient is summed over the model group,
and after the backward the split weights' gradients (each rank's slice,
zero elsewhere) are summed over it (:func:`sum_split_grads`, which the
trainer calls), so Adam moves every rank's copy alike. Training only, as
in the JAX package: the hand kernels are gated off under ``train=True``.

Usage:
    mesh = make_mesh_2d(n_data, n_model)
    shard_params_tensor_parallel(model, mesh, min_features=128)
    trainer = Trainer(model, ..., mesh=mesh)   # data-parallel over mesh.data
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from diffusionremotesensing_tpu_torch.parallel.sharding import Mesh, process_device

__all__ = ["Mesh2D", "make_mesh_2d", "shard_params_tensor_parallel", "split_layers",
           "sum_split_grads"]


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """A (data, model) mesh of the world's ranks: ``data`` the data-parallel
    mesh of this rank's column (its group over ``n_data`` ranks), and
    ``model_group`` this rank's row of ``n_model`` ranks."""

    data: Mesh
    model_group: Any
    n_data: int
    n_model: int

    @property
    def model_rank(self) -> int:
        return dist.get_rank(self.model_group)


def make_mesh_2d(n_data: int, n_model: int, devices: Optional[Sequence] = None) -> Mesh2D:
    """The (data, model) mesh over the world's first ``n_data * n_model``
    ranks (every rank of the world calls it, as ``new_group`` asks): this
    rank's device (``devices[0]``, default its :func:`process_device` of the
    card or the CPU), its data group and its model group."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs {n_data * n_model} ranks, "
                         f"the world has {world}")
    rows = [list(range(d * n_model, (d + 1) * n_model)) for d in range(n_data)]
    cols = [list(range(m, world, n_model)) for m in range(n_model)]
    model_group = data_group = None
    for r in rows:
        g = dist.new_group(r)
        if rank in r:
            model_group = g
    for c in cols:
        g = dist.new_group(c)
        if rank in c:
            data_group = g
    if devices is None:
        devices = [process_device("cuda" if torch.cuda.is_available() else "cpu")]
    data = Mesh(tuple(torch.device(d) for d in devices), data_group if n_data > 1 else None)
    return Mesh2D(data, model_group, n_data, n_model)


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over the group; backward: this rank's slice
    of the output's gradient (every rank holds the same whole gradient)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.rank, ctx.size = dim, dist.get_rank(group), x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size).contiguous(), None, None


class _SumGrad(torch.autograd.Function):
    """The identity; backward: the gradient summed over the group (each
    rank's slice of a split layer contributes its part of the input's)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


_GROUPS: dict = {}  # the model groups split layers name by key (a module copy keeps the key)


def _conv_forward(self, x):
    lo, hi, g = self.tp_slice[0], self.tp_slice[1], _GROUPS[self.tp_slice[2]]
    y = F.conv2d(_SumGrad.apply(x, g), self.weight[lo:hi], self.bias[lo:hi], self.stride,
                 self.padding, self.dilation, self.groups)
    return _Gather.apply(y, 1, g)


def _conv_transpose_forward(self, x, output_size=None):
    lo, hi, g = self.tp_slice[0], self.tp_slice[1], _GROUPS[self.tp_slice[2]]
    y = F.conv_transpose2d(_SumGrad.apply(x, g), self.weight[:, lo:hi], self.bias[lo:hi],
                           self.stride, self.padding, self.output_padding, self.groups,
                           self.dilation)
    return _Gather.apply(y, 1, g)


def _linear_forward(self, x):
    lo, hi, g = self.tp_slice[0], self.tp_slice[1], _GROUPS[self.tp_slice[2]]
    y = F.linear(_SumGrad.apply(x, g), self.weight[lo:hi], self.bias[lo:hi])
    return _Gather.apply(y, -1, g)


_SPLIT_CLASSES: dict = {}


def _split_class(cls):
    """``cls`` with the split forward: output channels ``tp_slice`` [lo, hi)
    of the weight, gathered over the model group."""
    if cls not in _SPLIT_CLASSES:
        fwd = (_conv_transpose_forward if issubclass(cls, nn.ConvTranspose2d)
               else _conv_forward if issubclass(cls, nn.Conv2d) else _linear_forward)
        _SPLIT_CLASSES[cls] = type(f"Split{cls.__name__}", (cls,), {"forward": fwd})
    return _SPLIT_CLASSES[cls]


def _out_features(module: nn.Module) -> Optional[int]:
    if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)):
        return module.out_channels
    if isinstance(module, nn.Linear):
        return module.out_features
    return None


def split_layers(model: nn.Module) -> List[nn.Module]:
    """The layers of ``model`` split over a model group."""
    return [m for m in model.modules() if getattr(m, "tp_slice", None) is not None]


def sum_split_grads(model: nn.Module) -> None:
    """Sum the split layers' weight gradients over their model group, once
    the backward is done (each rank holds its slice's, zero elsewhere), so
    that the optimizer moves every rank's copy alike. A no-op without
    split layers."""
    layers = split_layers(model)
    if not layers:
        return
    grads = [p.grad for m in layers for p in (m.weight, m.bias) if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=_GROUPS[layers[0].tp_slice[2]])
    torch._foreach_copy_(grads, [f.view_as(g) for f, g in zip(
        torch.split(flat, [g.numel() for g in grads]), grads)])


def shard_params_tensor_parallel(model: nn.Module, mesh: Mesh2D,
                                 min_features: int = 128) -> nn.Module:
    """Split every convolution, transposed convolution and dense layer of
    ``model`` with ``out >= min_features`` and ``out % n_model == 0`` (and a
    bias) on its output channels over the mesh's model group (module
    docstring); the rest stays replicated. Returns the model."""
    n = mesh.n_model
    if n == 1:
        return model
    r = mesh.model_rank
    key = len(_GROUPS)
    _GROUPS[key] = mesh.model_group
    for m in model.modules():
        out = _out_features(m)
        if out is not None and out >= min_features and out % n == 0 and m.bias is not None:
            k = out // n
            m.__class__ = _split_class(type(m))
            m.tp_slice = (r * k, (r + 1) * k, key)
    return model
