"""One rank of the port's 2-process gloo group, for
tests/test_torch_port_parallel_ranks.py.

Started by that file's module fixture with ``torch.multiprocessing``
(spawn) as two processes on the CPU, each joining the group through
``parallel.initialize_distributed`` on a ``file://`` store in the test's
temporary directory. Each runs every scenario once and saves what it saw to
``rank<r>.pt`` there; the tests assert on those files:

* ``steps``: ``Trainer.train_step`` on this rank's half of the global batch
  of each case in ``inputs.pt`` (the reference's weights, batch, t and
  noise), with its loss, gradients, parameters and BatchNorm statistics;
* ``loop``: ``Trainer.train`` over the rank's loader shard, with a stop
  requested on rank 1 alone in epoch 1, a preview each epoch drawn from a
  generator seeded by the rank, and the snapshot and metrics paths of the
  rank's own directory; the loader's shard indices;
* ``dispatch``: one epoch with ``steps_per_dispatch`` 1 and 2;
* ``tensor``: a train step over a (1, 2) (data, model) mesh and the
  replicated step on the same inputs;
* ``tile``: an aggregation tile split over the ranks (an all-gather
  assembles each chunk) and the same tile in the rank alone;
* ``orbax``: ``Trainer(checkpoint_backend='orbax')`` saves on both ranks
  into one directory and returns from ``finalize_snapshots``; the steps
  committed there as each rank sees them just after.

:func:`run_spatial` is the rank of tests/test_torch_port_spatial.py's
2-process group: one image's height split over the ranks
(``spatial_sharding``), saved to ``spatial<r>.pt``.

Imports only torch, numpy and the port (no JAX), so that a spawned rank
starts quickly.
"""

import os


class _Items:
    """n items of a 16 px x2 super-resolution set, drawn from numpy."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        import numpy as np

        r = np.random.default_rng(500 + i)
        return {"x": r.random((16, 16, 3)).astype(np.float32),
                "cond": r.random((8, 8, 3)).astype(np.float32)}


class _StopOnRank1:
    """A loader that requests a stop on rank 1 alone during epoch 1."""

    def __init__(self, loader, trainer, rank):
        self.loader, self.trainer, self.rank, self.epoch = loader, trainer, rank, 0

    def set_epoch(self, epoch):
        self.epoch = epoch
        self.loader.set_epoch(epoch)

    def __iter__(self):
        for i, b in enumerate(self.loader):
            if self.rank == 1 and self.epoch == 1 and i == 0:
                self.trainer._stop_requested = True
            yield b


def _model(flags=None):
    from diffusionremotesensing_tpu_torch.models.unet import residual_attention_unet_superres

    return residual_attention_unet_superres(magnification_factor=2, **(flags or {}))


def _trainer(model, mesh, **kw):
    from diffusionremotesensing_tpu_torch.train import Trainer

    return Trainer(model, "cosine", kw.pop("noise_steps", 1500), 16, lr=3e-4, mesh=mesh,
                   device="cpu", **kw)


def _snapshot(model):
    return ({n: p.detach().clone() for n, p in model.named_parameters()},
            {n: p.grad.clone() for n, p in model.named_parameters()},
            {k: v.clone() for k, v in model.state_dict().items() if "running" in k})


def _steps(rank, inputs, mesh):
    import torch

    from diffusionremotesensing_tpu_torch.parallel.sharding import shard_batch

    out = {}
    for name, case in inputs["cases"].items():
        tr = _trainer(_model(case["flags"]), mesh, ema_smoothing=True)
        state = tr.init_state(inputs["variables"])
        batch = shard_batch({k: torch.from_numpy(v) for k, v in case["batch"].items()}, mesh)
        t, noise = shard_batch((torch.from_numpy(case["t"]).long(),
                                torch.from_numpy(case["noise"])), mesh)
        loss = tr.train_step(state, batch, t, noise)
        params, grads, stats = _snapshot(state.model)
        out[name] = dict(loss=float(loss), params=params, grads=grads, stats=stats)
    return out


def _loop(rank, inputs, mesh, workdir):
    import numpy as np
    import torch

    from diffusionremotesensing_tpu_torch import cli
    from diffusionremotesensing_tpu_torch.data.loader import DataLoader

    n_shards, shard = cli._process_shard()
    shard_idx = DataLoader(_Items(9), 2, shuffle=True, num_shards=n_shards,
                           shard_index=shard)._shard_indices().tolist()
    own = os.path.join(workdir, f"rank{rank}")
    tr = _trainer(_model(), mesh, noise_steps=10, seed=0,
                  snapshot_path=os.path.join(own, "snapshot.pt"),
                  metrics_path=os.path.join(own, "metrics.jsonl"))
    state = tr.init_state(inputs["variables"])
    previews, epochs = [], []
    cond = np.random.default_rng(7).random((8, 8, 3)).astype(np.float32)

    def on_preview(st, epoch):
        previews.append(tr.sample(st, 2, cond, ddim_steps=2,
                                  generator=torch.Generator().manual_seed(100 + rank)))

    loader = DataLoader(_Items(8), 2, shuffle=True, num_shards=n_shards, shard_index=shard)
    stopper = _StopOnRank1(loader, tr, rank)
    seen = []
    orig = tr.train_step

    def counted(st, b, *a):
        seen.append(stopper.epoch)
        return orig(st, b, *a)

    tr.train_step = counted
    tr.train(state, epochs=4, train_loader=stopper, check_preds_epoch=1, on_preview=on_preview,
             verbose=False)
    epochs = sorted(set(seen))
    return dict(shard_idx=shard_idx, previews=[p.clone() for p in previews], epochs=epochs,
                loop_steps=len(seen), loop_params=_snapshot(state.model)[0])


def _dispatch(rank, inputs, mesh):
    from diffusionremotesensing_tpu_torch.data.loader import DataLoader

    out = {}
    for spd in (1, 2):
        tr = _trainer(_model(), mesh, noise_steps=10, seed=1, steps_per_dispatch=spd)
        state = tr.init_state(inputs["variables"])
        loader = DataLoader(_Items(8), 2, shuffle=True, num_shards=mesh.world,
                            shard_index=mesh.rank)
        tr.train(state, epochs=1, train_loader=loader, check_preds_epoch=100, verbose=False)
        out[f"spd{spd}"] = _snapshot(state.model)[0]
    return out


def _tensor(rank, inputs):
    import torch

    from diffusionremotesensing_tpu_torch.parallel.tensor import (
        make_mesh_2d,
        shard_params_tensor_parallel,
        split_layers,
    )

    case = inputs["cases"]["dense_pad"]
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    t, noise = torch.from_numpy(case["t"]).long(), torch.from_numpy(case["noise"])
    mesh2 = make_mesh_2d(1, 2, ["cpu"])
    tp_model = shard_params_tensor_parallel(_model(), mesh2, min_features=128)
    tr = _trainer(tp_model, mesh2)
    state = tr.init_state(inputs["variables"])
    loss_tp = tr.train_step(state, batch, t, noise)
    ref = _trainer(_model(), None)
    ref_state = ref.init_state(inputs["variables"])
    loss_ref = ref.train_step(ref_state, batch, t, noise)
    p_tp, g_tp, s_tp = _snapshot(state.model)
    p_ref, g_ref, s_ref = _snapshot(ref_state.model)
    return dict(tp=dict(loss=float(loss_tp), params=p_tp, grads=g_tp, stats=s_tp,
                        split=len(split_layers(tp_model))),
                tp_ref=dict(loss=float(loss_ref), params=p_ref, grads=g_ref, stats=s_ref))


def _tile(rank, mesh):
    """A 16 x 16 LR tile (9 patches of 8) through AggregationSampler split
    over the two ranks (2 patches a rank a chunk) and in this process
    alone, float32 DDIM-3 on the UNet with torch's default weights."""
    import numpy as np
    import torch

    from diffusionremotesensing_tpu_torch.aggregation import AggregationSampler
    from diffusionremotesensing_tpu_torch.diffusion import make_process

    torch.manual_seed(0)
    proc = make_process(_model().eval(), "cosine", 20, 16)
    lr = np.random.default_rng(9).random((16, 16, 3)).astype(np.float32)
    tiles = [AggregationSampler(proc, 8, 4, 2, batch_size=bs, ddim_steps=3, mesh=m)(
        lr, generator=torch.Generator().manual_seed(4), device="cpu")
        for m, bs in ((mesh, 2), (None, 4))]
    return dict(tile_split=tiles[0], tile_one=tiles[1])


def _orbax(rank, inputs, mesh, workdir):
    from diffusionremotesensing_tpu_torch.io import committed_steps

    path = os.path.join(workdir, "orbax_ckpt")
    tr = _trainer(_model(), mesh, snapshot_path=path, checkpoint_backend="orbax")
    state = tr.init_state(inputs["variables"])
    tr.save_snapshot(state, 3)
    tr.finalize_snapshots()
    return dict(orbax_finalized=True, orbax_steps=committed_steps(path))


def run(rank, world, workdir):
    """Rank ``rank`` of ``world``: join the group, run every scenario, save
    ``rank<rank>.pt``."""
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank))
    import torch

    torch.set_num_threads(2)
    from diffusionremotesensing_tpu_torch.parallel.sharding import (
        initialize_distributed,
        make_mesh,
    )

    assert initialize_distributed("cpu", init_method="file://" + os.path.join(workdir, "store"))
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    mesh = make_mesh(["cpu"])
    out = dict(world=mesh.world, rank=mesh.rank, size=mesh.size)
    out["steps"] = _steps(rank, inputs, mesh)
    out.update(_loop(rank, inputs, mesh, workdir))
    out["dispatch"] = _dispatch(rank, inputs, mesh)
    out.update(_tensor(rank, inputs))
    out.update(_tile(rank, mesh))
    out.update(_orbax(rank, inputs, mesh, workdir))
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def run_spatial(rank, world, workdir):
    """Rank ``rank`` of ``world`` for tests/test_torch_port_spatial.py: join
    the group, sample the image of ``spatial_inputs.pt`` (the weights, x_T,
    cond, the model's flags and the generator's seed) with its height
    split over the ranks (``spatial_sharding``: one band a rank, halos by
    ``batch_isend_irecv`` under gloo), DDPM and DDIM, calibrate the int8
    scales on (x_T, t, cond) split the same way (the ranks' maxima merged
    by ``all_reduce(MAX)``), and save what this rank got to
    ``spatial<r>.pt``."""
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank))
    import torch

    torch.set_num_threads(1)
    from diffusionremotesensing_tpu_torch.diffusion import make_process
    from diffusionremotesensing_tpu_torch.ops.quant import calibrate
    from diffusionremotesensing_tpu_torch.parallel.sharding import (
        initialize_distributed,
        make_mesh,
        spatial_sharding,
    )

    assert initialize_distributed("cpu", init_method="file://" + os.path.join(workdir, "store"))
    inputs = torch.load(os.path.join(workdir, "spatial_inputs.pt"), weights_only=False)
    model = _model(inputs["flags"])
    model.load_state_dict(inputs["state"])
    proc = make_process(model.eval(), "linear", inputs["steps"], inputs["x_T"].shape[1])
    spatial = spatial_sharding(make_mesh(["cpu"]))
    gen = lambda: torch.Generator().manual_seed(inputs["seed"])  # noqa: E731
    out = {"ddpm": proc.sampler(spatial=spatial)(inputs["x_T"], inputs["cond"], generator=gen()),
           "ddim": proc.ddim_sampler(3, spatial=spatial)(inputs["x_T"], inputs["cond"],
                                                         generator=gen()),
           "calib": calibrate(proc.net, [(inputs["x_T"], inputs["t"], inputs["cond"])],
                              spatial=spatial),
           "bands": spatial.bands, "local": spatial.local_bands()}
    torch.save(out, os.path.join(workdir, f"spatial{rank}.pt"))
    torch.distributed.destroy_process_group()
