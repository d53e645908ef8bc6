"""The port's aggregation sampling and server (diffusionremotesensing_tpu_torch/
aggregation.py, serving.py) against the reference package's: the patch
grid, blend weights and chunking exactly, the streamed blend through a
deterministic stand-in sampler (float32, atol 1e-6), and the server on the
CPU at a tiny size."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu import aggregation as jagg
from diffusionremotesensing_tpu_torch import aggregation as tagg
from diffusionremotesensing_tpu_torch.convert import init_params
from diffusionremotesensing_tpu_torch.models.unet import residual_attention_unet_superres
from diffusionremotesensing_tpu_torch.ops.tap_block import tap_block
from diffusionremotesensing_tpu_torch.serving import InferenceServer, MicroBatcher


@pytest.mark.parametrize("h,w,patch,stride,mag", [
    (256, 256, 64, 32, 2), (64, 64, 16, 8, 2), (50, 70, 16, 8, 4), (32, 32, 32, 32, 2)])
def test_patch_grid_matches_reference(h, w, patch, stride, mag):
    assert tagg.patchify_coords(h, w, patch, stride, mag) == jagg.patchify_coords(h, w, patch, stride, mag)


def test_main_path_tile_is_49_patches():
    assert len(tagg.patchify_coords(256, 256, 64, 32, 2)) == 49


@pytest.mark.parametrize("tw,th", [(128, 128), (32, 48)])
def test_gaussian_weights_match_reference(tw, th):
    np.testing.assert_array_equal(tagg.gaussian_weights(tw, th), jagg.gaussian_weights(tw, th))


@pytest.mark.parametrize("w,h", [(100, 300), (5000, 4000), (64, 64)])
def test_squarify_matches_reference(w, h):
    assert tagg.squarify_sizes(w, h) == jagg.squarify_sizes(w, h)


@pytest.mark.parametrize("n,batch", [(49, 48), (96, 48), (7, 3), (2, 5)])
def test_chunk_plan_matches_reference(n, batch):
    j = jagg.AggregationSampler(None, 16, 8, 2, batch_size=batch)
    t = tagg.AggregationSampler(None, 16, 8, 2, batch_size=batch)
    assert t.chunk_plan(n) == j._chunk_plan(n)


class _JaxStandIn:
    """A process whose sampler maps each LR patch to a fixed HR image."""

    def sampler(self, **_):
        return lambda variables, key, x_T, cond: (
            jnp.repeat(jnp.repeat(cond, 2, axis=1), 2, axis=2) * 0.8 + 0.1)

    def ddim_sampler(self, *a, **k):
        return self.sampler()


class _TorchStandIn:
    def sampler(self, fused_update=False, start_t=None):
        return lambda x_T, cond, generator=None: (
            cond.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) * 0.8 + 0.1)

    def ddim_sampler(self, *a, **k):
        return self.sampler()


def test_streamed_blend_matches_reference():
    lr = np.random.default_rng(0).random((40, 56, 3)).astype(np.float32)
    want = jagg.AggregationSampler(_JaxStandIn(), 16, 8, 2, batch_size=5)(
        None, lr, key=jax.random.PRNGKey(0))
    got = tagg.AggregationSampler(_TorchStandIn(), 16, 8, 2, batch_size=5)(lr, device="cpu")
    assert got.shape == (80, 112, 3)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)


def test_microbatcher_batches_and_orders():
    calls = []

    def run_batch(items):
        calls.append(len(items))
        return [i * 2 for i in items]

    mb = MicroBatcher(run_batch, max_batch=4, max_wait_ms=50)
    handles = [mb.submit(i) for i in range(6)]
    assert [h.get(timeout=5) for h in handles] == [0, 2, 4, 6, 8, 10]
    assert sum(calls) == 6 and max(calls) <= 4
    mb.shutdown()
    assert isinstance(mb.submit(1).get(timeout=5), RuntimeError)


def test_microbatcher_propagates_errors():
    def run_batch(items):
        raise RuntimeError("boom")

    mb = MicroBatcher(run_batch, max_batch=2, max_wait_ms=10)
    assert isinstance(mb.submit(1).get(timeout=5), RuntimeError)
    mb.shutdown()


@pytest.fixture(scope="module")
def model():
    m = residual_attention_unet_superres(magnification_factor=2, s2d=True, tap44="block")
    m.load_state_dict(init_params(1, device="cpu"))
    return m


def test_server_batch_and_tile_on_cpu(model):
    server = InferenceServer(model, "cosine", 20, image_size=16, ddim_steps=3, max_batch=4,
                             dtype=torch.bfloat16, device="cpu")
    try:
        rng = np.random.default_rng(1)
        lrs = [rng.random((8, 8, 3)).astype(np.float32) for _ in range(3)]
        results = [None] * 3

        def one(i):
            results[i] = server.infer_batch([lrs[i]])[0]

        threads = [threading.Thread(target=one, args=(i,)) for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        for r in results:
            assert r.shape == (16, 16, 3) and 0.0 <= r.min() and r.max() <= 1.0
        before = tap_block.launches
        tile = server.infer_tile(rng.random((20, 12, 3)).astype(np.float32))
        assert tile.shape == (40, 24, 3) and np.isfinite(tile).all()
        assert 0.0 <= tile.min() and tile.max() <= 1.0
        assert tap_block.launches == before  # CPU tensors never launch the kernel
    finally:
        server.shutdown()


def test_server_ddpm_tile_is_seeded(model):
    """The ancestral chain on a tiny tile; the same seed gives the same image."""
    outs = []
    for _ in range(2):
        server = InferenceServer(model, "cosine", 5, image_size=16, seed=3, device="cpu")
        try:
            outs.append(server.infer_tile(np.full((8, 16, 3), 0.5, np.float32)))
        finally:
            server.shutdown()
    assert outs[0].shape == (16, 32, 3)
    np.testing.assert_array_equal(outs[0], outs[1])


def test_server_validates_requests(model):
    server = InferenceServer(model, "cosine", 5, image_size=16, device="cpu")
    try:
        assert server.validate(np.zeros((8, 8, 3))) is None
        with pytest.raises(ValueError):
            server.infer_batch([np.zeros((9, 8, 3), np.float32)])
        with pytest.raises(ValueError):
            server.infer_tile(np.zeros((4, 40, 3), np.float32))
    finally:
        server.shutdown()
    # the generation task is served, but not from a super-resolution model
    with pytest.raises(ValueError, match="conditioning"):
        InferenceServer(model, "cosine", 5, image_size=16, task="generation", device="cpu")


def test_cuda_without_a_card_raises(model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceServer(model, "cosine", 5, image_size=16)
