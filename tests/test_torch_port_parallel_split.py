"""The port's collective-free split over a device mesh, in one process
(``parallel.sharding``, ``AggregationSampler(mesh=)``,
``InferenceServer(mesh=)``, the CLI's --multiple_gpus and --data_parallel),
on the CPU with a mesh of two replicas, ``make_mesh(["cpu", "cpu"])``, as
one card drives it with ``[cuda:0, cuda:0]``.

A tile or a micro-batch split over the two replicas equals the one-device
run bit for bit in float32 on the same generator: DDPM, DDIM-100 with
clip_x0, DDIM with eta > 0, the start_t warm start and the fused update's
plain version (each replica at its first Philox quad), each on a tile of 9
patches whose last chunk is padded to the mesh size. There the eps model is
a row-wise stand-in (tests/test_aggregation.py's oracle idea): the UNet's
time MLP is a GEMM whose float32 result on the CPU depends on the rows it
is given (a batch of 6 against two of 3 differ by ~5e-7 in one Linear),
so the real UNet's split run is held to 1e-5 of the one-device run
instead. A ``max_batch`` the mesh does not divide raises."""

import copy
import os

import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu_torch import cli
from diffusionremotesensing_tpu_torch.aggregation import AggregationSampler
from diffusionremotesensing_tpu_torch.diffusion import DiffusionProcess, make_process
from diffusionremotesensing_tpu_torch.io import save_snapshot
from diffusionremotesensing_tpu_torch.models.unet import residual_attention_unet_superres
from diffusionremotesensing_tpu_torch.ops import quant as tq
from diffusionremotesensing_tpu_torch.parallel import sharding
from diffusionremotesensing_tpu_torch.png import decode_png, encode_png
from diffusionremotesensing_tpu_torch.serving import InferenceServer

MESH = sharding.make_mesh(["cpu", "cpu"])
T = 200


def _oracle_apply(self, x, t, cond, cond_features=None, aux=None, cond_mask=None):
    """A row-wise eps: each row's value depends on that row alone."""
    return torch.tanh(0.7 * x - cond_features + t[:, None, None, None] * 1e-3)


def _oracle_encode(self, cond):
    return cond.repeat_interleave(2, 1).repeat_interleave(2, 2)


@pytest.fixture
def oracle(monkeypatch):
    monkeypatch.setattr(DiffusionProcess, "apply_fn", _oracle_apply)
    monkeypatch.setattr(DiffusionProcess, "encode_cond_fn", _oracle_encode)


@pytest.fixture(scope="module")
def model():
    with torch.random.fork_rng():
        torch.manual_seed(0)
        return residual_attention_unet_superres(magnification_factor=2).eval()


def _tile(seed=0):
    return np.random.default_rng(seed).random((16, 16, 3)).astype(np.float32)


PATHS = {
    "ddpm": {},
    "ddim100_clip": {"ddim_steps": 100, "ddim_clip_x0": True},
    "ddim_eta": {"ddim_steps": 10, "ddim_eta": 0.5},
    "start_t": {"start_t": 60},
    "fused": {"fused_update": True},
}


@pytest.mark.parametrize("path", list(PATHS))
def test_split_tile_equals_one_device(oracle, model, path):
    """9 patches, 2 a replica: chunks of 4, 4 and 1 (padded to 2 on the
    mesh); the one-device run takes chunks of 4 and the remainder alone."""
    proc = make_process(model, "cosine", T, 16)
    kw = PATHS[path]
    one = AggregationSampler(proc, 8, 4, 2, batch_size=4, **kw)
    split = AggregationSampler(proc, 8, 4, 2, batch_size=2, mesh=MESH, **kw)
    assert split.chunk_plan(9) == [(0, 4), (4, 4), (8, 2)]
    assert one.chunk_plan(9) == [(0, 4), (4, 4), (8, 1)]
    want = one(_tile(), generator=torch.Generator().manual_seed(3), device="cpu")
    got = split(_tile(), generator=torch.Generator().manual_seed(3), device="cpu")
    assert np.array_equal(got, want)


def test_split_tile_of_the_real_unet(model):
    proc = make_process(model, "cosine", T, 16)
    one = AggregationSampler(proc, 8, 4, 2, batch_size=4, ddim_steps=3)
    split = AggregationSampler(proc, 8, 4, 2, batch_size=2, ddim_steps=3, mesh=MESH)
    want = one(_tile(1), generator=torch.Generator().manual_seed(4), device="cpu")
    got = split(_tile(1), generator=torch.Generator().manual_seed(4), device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_replica_copies_follow_the_quant_map():
    """The mesh's second replica is a copy of the net (a device listed
    twice holds two replicas, as a second card holds one), built before any
    quant map is attached. Each map attached to the process's net afterwards
    reaches the copy: the split tile equals, bit for bit, that of a process
    whose replicas were built after the map was attached, with no map, with
    one tile's map and with another's."""
    with torch.random.fork_rng():
        torch.manual_seed(2)
        net = residual_attention_unet_superres(magnification_factor=2, s2d=True).eval()
    proc = make_process(net, "cosine", 20, 16)
    early = AggregationSampler(proc, 8, 4, 2, batch_size=2, ddim_steps=3, mesh=MESH)
    early._sampler()  # builds the sampler and with it the replicas
    rep = proc.replica("cpu", 1)
    assert rep is not proc and rep.net is not proc.net and proc.replica("cpu") is proc
    assert rep.net.quant_sites is proc.net.quant_sites
    lrs = [_tile(7), _tile(8)]
    outs = []
    for qlr in (None, *lrs):
        qmap = None if qlr is None else tq.quantize_superres_tile(
            proc.net, proc.schedule.alpha_hat, qlr, 8, 2, torch.Generator().manual_seed(21))
        tq.attach(proc.net, qmap)
        fresh = make_process(tq.attach(copy.deepcopy(net), qmap), "cosine", 20, 16)
        late = AggregationSampler(fresh, 8, 4, 2, batch_size=2, ddim_steps=3, mesh=MESH)
        got, want = (s(lrs[0], generator=torch.Generator().manual_seed(9), device="cpu")
                     for s in (early, late))
        assert np.array_equal(got, want)
        outs.append(got)
    assert not np.array_equal(outs[0], outs[1]) and not np.array_equal(outs[1], outs[2])


@pytest.mark.parametrize("kw", [{}, {"fused_update": True}, {"ddim_steps": 100}],
                         ids=["ddpm", "fused", "ddim100"])
def test_split_server_equals_one_device(oracle, model, kw):
    """A micro-batch of 3 requests (padded to max_batch 4) and a tile, on
    servers of the same seed."""
    conds = [np.random.default_rng(i).random((8, 8, 3)).astype(np.float32) for i in range(3)]
    outs = []
    for mesh in (None, MESH):
        server = InferenceServer(model, "cosine", T, 16, max_batch=4, seed=5, device="cpu",
                                 mesh=mesh, **kw)
        try:
            outs.append((server.infer_batch(conds), server.infer_tile(_tile(2))))
        finally:
            server.shutdown()
    (batch1, tile1), (batch2, tile2) = outs
    assert all(np.array_equal(a, b) for a, b in zip(batch1, batch2))
    assert np.array_equal(tile1, tile2)


def test_max_batch_must_divide_over_the_mesh(model):
    with pytest.raises(ValueError, match="divisible by the mesh size"):
        InferenceServer(model, "cosine", T, 16, max_batch=3, device="cpu", mesh=MESH)


def test_fused_split_needs_whole_quads(oracle, model):
    """A replica whose rows start inside a Philox quad is refused: 2 rows of
    6 elements split after the first."""
    proc = make_process(model, "cosine", T, 16)
    sampler = proc.sampler(fused_update=True, mesh=MESH)
    with pytest.raises(ValueError, match="quad"):
        sampler(torch.zeros(2, 1, 2, 3), torch.zeros(2, 1, 1, 3),
                generator=torch.Generator().manual_seed(0))


def test_shard_batch_takes_this_ranks_rows():
    """Rank 1 of 2: the second half of each leaf along the batch axis (axis
    1 for the (K, B, ...) stacks of steps_per_dispatch > 1); a leaf
    without that axis is replicated."""
    from types import SimpleNamespace

    rank1 = SimpleNamespace(world=2, rank=1)
    x = np.arange(24).reshape(2, 4, 3)
    got = sharding.shard_batch({"x": x[0], "mask": np.arange(4), "n": 3}, rank1)
    assert np.array_equal(got["x"], x[0, 2:]) and np.array_equal(got["mask"], [2, 3])
    assert got["n"] == 3
    got = sharding.shard_batch({"x": x, "t": np.arange(2)}, rank1, batch_axis=1)
    assert np.array_equal(got["x"], x[:, 2:]) and np.array_equal(got["t"], np.arange(2))
    assert sharding.batch_sharding(rank1) == (2, 1)


def test_mesh_in_one_process():
    """Without a group: the replicas alone; a batch is not sharded over
    ranks; the process is the main one; no group is joined."""
    assert (MESH.world, MESH.rank, MESH.size, MESH.group) == (1, 0, 2, None)
    assert sharding.make_mesh().devices == (torch.device("cpu"),)
    assert sharding.batch_sharding(MESH) == (1, 0)
    x = {"x": np.arange(4), "n": 3}
    assert sharding.shard_batch(x, MESH) is x
    assert sharding.split_rows(6, 3) == [(0, 2), (2, 4), (4, 6)]
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        sharding.split_rows(5, 2)
    assert sharding.is_main_process()
    assert sharding.initialize_distributed("cpu") is False
    assert sharding.global_replicated(x["x"], MESH) is x["x"]


@pytest.fixture(scope="module")
def snapshot_dir(tmp_path_factory, model):
    root = tmp_path_factory.mktemp("parallel_cli")
    save_snapshot(str(root / "models_run" / "x2" / "weights" / "snapshot.pt"), model, 3)
    return root


def test_aggregation_multiple_gpus_equals_one_device(snapshot_dir, monkeypatch):
    """--multiple_gpus in one process on the CPU: a mesh of this process's
    one CPU device, the same tile as without the flag."""
    monkeypatch.chdir(snapshot_dir)
    img = (np.random.default_rng(6).random((16, 16, 3)) * 255).astype(np.uint8)
    with open("lr.png", "wb") as f:
        f.write(encode_png(img))
    args = ["aggregation", "--model_name", "x2", "--magnification_factor", "2", "--device", "cpu",
            "--patch_size", "8", "--stride", "4", "--noise_steps", "20", "--ddim_steps", "2",
            "--img_lr_path", "lr.png"]
    cli.main([*args, "--destination_path", "one.png"])
    cli.main([*args, "--destination_path", "mesh.png", "--multiple_gpus"])
    tiles = []
    for name in ("one.png", "mesh.png"):
        with open(name, "rb") as f:
            tiles.append(decode_png(f.read()))
    assert tiles[0].shape == (32, 32, 3) and np.array_equal(tiles[0], tiles[1])
    mesh = cli._make_mesh_if(True, torch.device("cpu"))
    assert mesh.devices == (torch.device("cpu"),) and mesh.group is None
    assert cli._make_mesh_if(False, torch.device("cpu")) is None
    assert cli._process_shard() == (1, 0)


def test_serve_data_parallel_builds_a_meshed_server(snapshot_dir):
    snap = str(snapshot_dir / "models_run" / "x2" / "weights" / "snapshot.pt")
    args = ["serve", "--task", "superres", "--model_input_size", "16",
            "--magnification_factor", "2", "--device", "cpu", "--noise_steps", "20",
            "--ddim_steps", "2", "--seed", "7", "--max_batch", "2", "--snapshot_path", snap]
    servers = [cli.build_server(cli.parse_args(args + extra)) for extra in ([], ["--data_parallel"])]
    try:
        assert servers[0].mesh is None
        assert servers[1].mesh.devices == (torch.device("cpu"),)
        lr = np.random.default_rng(8).random((8, 8, 3)).astype(np.float32)
        a, b = (s.infer_batch([lr])[0] for s in servers)
    finally:
        for s in servers:
            s.shutdown()
    assert np.array_equal(a, b)
    assert os.path.exists(snap)
