"""The port's data parallelism across two processes (``parallel/``,
``train.Trainer(mesh=...)``): two ranks of a gloo group on the CPU, started
once for the whole file (tests/torch_port_mp_worker.py; a ``file://``
store in the fixture's temporary directory), each running every scenario.

* One train step of the global batch split over the 2 ranks against the
  reference package's step sharded over a 2-device mesh of conftest's
  virtual CPU devices (tests/test_sharding.py's construction), from the
  same weights, batch, t and noise: dense with a padded last row
  (``pad_mask`` [1, 1, 1, 0]: the ranks hold 2 and 1 valid rows) and
  ``s2d_train``, EMA on, full width at HR 16, float32. The reference's
  gradients are read from its Adam state (mu = 0.1 g), as
  tests/test_torch_port_train.py does. Loss within 5e-7 (relative),
  gradients within 1e-6 of the largest, BatchNorm running statistics
  within 2e-7, parameters after Adam within 1e-6 where the gradient is
  live and within 2 lr everywhere (Adam's first step turns the float32
  noise of the zero-gradient biases before a BatchNorm into steps of up to
  lr, in both packages).
* The ranks agree: the same loss, gradients and parameters after the step;
  only rank 0 writes the snapshot and the metrics; a stop requested on
  rank 1 alone stops both after the same epoch; the loader's shards
  partition the dataset; ``steps_per_dispatch=2`` gives one step a batch's
  parameters; a preview drawn from generators seeded by the rank is the
  same image on both.
* A (1, 2) tensor-parallel step (``parallel.tensor``) equals the
  replicated step.
* An aggregation tile split over the ranks equals the tile of one process
  within 1e-5 (float32 DDIM; the UNet's time MLP is a GEMM whose result
  depends on the rows it is given), on both ranks alike.
* An Orbax snapshot (``checkpoint_backend='orbax'``) saved on both ranks:
  each returns from ``finalize_snapshots`` and sees rank 0's step
  committed there, and the directory loads (the port's counterpart of
  tests/test_multiprocess.py's collective Orbax save).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu import diffusion as jdiff
from diffusionremotesensing_tpu.parallel.sharding import make_mesh as jax_make_mesh
from diffusionremotesensing_tpu.parallel.sharding import shard_batch as jax_shard_batch
from diffusionremotesensing_tpu.train import Trainer as JaxTrainer
from diffusionremotesensing_tpu_torch.convert import from_jax_variables
from diffusionremotesensing_tpu_torch.io import load_snapshot
from tests import torch_port_mp_worker
from tests.torch_port_helpers import JAX_MODELS, random_jax_variables

HR, B, T, LR = 16, 4, 1500, 3e-4
CASES = {"dense_pad": {}, "s2d": {"s2d_train": True}}
SPAWN_TIMEOUT = 300  # seconds for both ranks to run every scenario


def _batch(name):
    rng = np.random.default_rng(0)
    batch = {"x": rng.random((B, HR, HR, 3)).astype(np.float32),
             "cond": rng.random((B, HR // 2, HR // 2, 3)).astype(np.float32)}
    if name == "dense_pad":
        batch["pad_mask"] = np.array([1, 1, 1, 0], np.float32)
    return batch


def _reference(name, variables):
    """The reference Trainer's step sharded over 2 virtual devices: loss,
    gradients, parameters and statistics under the port's names, and the
    t and noise its key drew."""
    mesh = jax_make_mesh(jax.devices()[:2])
    tr = JaxTrainer(JAX_MODELS["superres"](**CASES[name]), "cosine", T, HR, lr=LR,
                    ema_smoothing=True, mesh=mesh)
    state = tr.replicate_state(tr.init_state(jax.tree_util.tree_map(jnp.asarray, variables)))
    batch = _batch(name)
    key = jax.random.PRNGKey(11)
    new, loss = tr._build_train_step()(state, jax_shard_batch(batch, mesh), key)
    k_t, k_noise = jax.random.split(key)
    numpy = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    stats = numpy(new.batch_stats)
    grads = jax.tree_util.tree_map(lambda m: np.asarray(m) / np.float32(0.1), new.opt_state[0].mu)
    return dict(loss=float(loss), grads=from_jax_variables(grads, stats),
                params=from_jax_variables(numpy(new.params), stats), batch=batch,
                t=np.array(jdiff.sample_timesteps(k_t, B, T)),
                noise=np.array(jdiff._normal_packed(k_noise, batch["x"].shape, jnp.float32)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference steps, then both ranks' results (one spawn)."""
    work = tmp_path_factory.mktemp("ranks")
    variables = random_jax_variables(seed=3, image_size=HR, variant="superres")
    refs = {name: _reference(name, variables) for name in CASES}
    torch.save({"variables": from_jax_variables(variables["params"], variables["batch_stats"]),
                "cases": {name: dict(flags=CASES[name], batch=r["batch"], t=r["t"],
                                     noise=r["noise"]) for name, r in refs.items()}},
               str(work / "inputs.pt"))
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=torch_port_mp_worker.run, args=(r, 2, str(work)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=SPAWN_TIMEOUT)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join()
    assert not any(alive), f"a rank did not finish within {SPAWN_TIMEOUT} s"
    assert [p.exitcode for p in procs] == [0, 0]
    ranks = [torch.load(str(work / f"rank{r}.pt"), weights_only=False) for r in range(2)]
    return refs, ranks, work


def test_each_rank_joined_the_group(run):
    _, ranks, _ = run
    assert [(r["world"], r["rank"], r["size"]) for r in ranks] == [(2, 0, 2), (2, 1, 2)]


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_equals_the_reference_sharded_step(run, case):
    refs, ranks, _ = run
    ref, got = refs[case], ranks[0]["steps"][case]
    assert got["loss"] == pytest.approx(ref["loss"], rel=5e-7)
    gmax = max(float(ref["grads"][n].abs().max()) for n in got["grads"])
    for n, g in got["grads"].items():
        assert float((g - ref["grads"][n]).abs().max()) <= 1e-6 * gmax, n
        d = (got["params"][n] - ref["params"][n]).abs()
        assert float(d.max()) <= 2 * LR, n
        live = ref["grads"][n].abs() > 1e-5 * gmax
        if live.any():
            assert float(d[live].max()) <= 1e-6, n
    for k, v in got["stats"].items():
        torch.testing.assert_close(v, ref["params"][k], rtol=0, atol=2e-7, msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_agree_after_the_step(run, case):
    _, ranks, _ = run
    a, b = ranks[0]["steps"][case], ranks[1]["steps"][case]
    assert a["loss"] == b["loss"]
    for tree in ("params", "grads", "stats"):
        for n in a[tree]:
            assert torch.equal(a[tree][n], b[tree][n]), (tree, n)


def test_only_rank0_writes(run):
    _, _, work = run
    assert os.path.exists(work / "rank0" / "snapshot.pt")
    assert os.path.exists(work / "rank0" / "metrics.jsonl")
    assert not os.path.exists(work / "rank1")


def test_a_stop_on_one_rank_stops_both_after_the_same_epoch(run):
    """Rank 1 alone requests the stop in epoch 1 of 4: both ranks finish
    epoch 1 (every step a collective they both enter) and stop; rank 0's
    snapshot is epoch 1's."""
    _, ranks, work = run
    assert [r["epochs"] for r in ranks] == [[0, 1], [0, 1]]
    assert ranks[0]["loop_steps"] == ranks[1]["loop_steps"] == 4
    assert load_snapshot(str(work / "rank0" / "snapshot.pt"))[1] == 1
    for n, p in ranks[0]["loop_params"].items():
        assert torch.equal(p, ranks[1]["loop_params"][n]), n


def test_loader_shards_partition_the_dataset(run):
    """9 items over 2 ranks (cli._process_shard under the group): equal
    shards of 5, the pad a wrap-around repeat, every item in one."""
    _, ranks, _ = run
    a, b = (r["shard_idx"] for r in ranks)
    assert len(a) == len(b) == 5
    assert sorted(set(a) | set(b)) == list(range(9))


def test_steps_per_dispatch_under_the_group(run):
    _, ranks, _ = run
    for r in ranks:
        for n, p in r["dispatch"]["spd1"].items():
            assert torch.equal(p, r["dispatch"]["spd2"][n]), n


def test_preview_is_identical_on_every_rank(run):
    """The preview of epoch 0 (the stop comes before epoch 1's), drawn from
    a generator seeded by the rank: rank 0's generator state, x_T and
    condition on both."""
    _, ranks, _ = run
    assert len(ranks[0]["previews"]) == len(ranks[1]["previews"]) == 1
    assert torch.equal(ranks[0]["previews"][0], ranks[1]["previews"][0])
    assert ranks[0]["previews"][0].shape == (2, HR, HR, 3)


def test_tensor_parallel_step_equals_the_replicated_step(run):
    """A (1, 2) mesh: the layers of 128 or more output channels split over
    the 2 ranks; loss, gradients, statistics and the updated parameters as
    the replicated step's."""
    _, ranks, _ = run
    for r in ranks:
        tp, ref = r["tp"], r["tp_ref"]
        assert tp["split"] > 0
        assert tp["loss"] == pytest.approx(ref["loss"], rel=1e-6)
        gmax = max(float(g.abs().max()) for g in ref["grads"].values())
        for n, g in tp["grads"].items():
            assert float((g - ref["grads"][n]).abs().max()) <= 1e-6 * gmax, n
            live = ref["grads"][n].abs() > 1e-5 * gmax
            d = (tp["params"][n] - ref["params"][n]).abs()
            assert float(d.max()) <= 2 * LR, n
            if live.any():
                assert float(d[live].max()) <= 1e-6, n
        for k, v in tp["stats"].items():
            torch.testing.assert_close(v, ref["stats"][k], rtol=0, atol=2e-7, msg=k)
    for n, p in ranks[0]["tp"]["params"].items():
        assert torch.equal(p, ranks[1]["tp"]["params"][n]), n


def test_aggregation_tile_split_over_the_ranks(run):
    _, ranks, _ = run
    for r in ranks:
        assert r["tile_split"].shape == (32, 32, 3)
        np.testing.assert_allclose(r["tile_split"], r["tile_one"], rtol=0, atol=1e-5)
    assert np.array_equal(ranks[0]["tile_split"], ranks[1]["tile_split"])


def test_orbax_save_on_both_ranks_commits_before_either_returns(run):
    """Every rank enters the save and finalize_snapshots; rank 0 alone
    writes, and the barrier that ends finalize_snapshots keeps rank 1 until
    the step has committed: both ranks see step 0 just after."""
    _, ranks, work = run
    assert [r["orbax_finalized"] for r in ranks] == [True, True]
    assert [r["orbax_steps"] for r in ranks] == [[0], [0]]
    state, epochs = load_snapshot(str(work / "orbax_ckpt"))
    assert epochs == 3
    want = torch.load(str(work / "inputs.pt"), weights_only=False)["variables"]
    assert all(torch.equal(state[k], want[k]) for k in want if "num_batches" not in k)
