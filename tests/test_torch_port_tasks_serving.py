"""The port's server for the SAR->NDVI and generation tasks, and
super-resolution's warm start, on the CPU at a tiny size: requests are
answered, each bad request (a SAR image of the wrong shape, a label out of
range or not an integer) fails alone, start_t is refused for the tasks
without a cheap reconstruction, and the in-repo trained snapshots
(benchmarks/gate_artifacts/snapshot_sar.pt, snapshot_gen.pt) load through
InferenceServer.from_snapshot into a model whose forward is the reference
package's on the same snapshot (float32, atol 1e-4 of max |output|)."""

import os
import threading

import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu.io import load_snapshot as jax_load_snapshot
from diffusionremotesensing_tpu.models.unet import (
    residual_attention_unet_generation as jax_generation,
    residual_attention_unet_sar_to_ndvi as jax_sar,
)
from diffusionremotesensing_tpu_torch.aggregation import AggregationSampler
from diffusionremotesensing_tpu_torch.convert import init_params
from diffusionremotesensing_tpu_torch.models.unet import (
    residual_attention_unet_generation,
    residual_attention_unet_sar_to_ndvi,
    residual_attention_unet_superres,
)
from diffusionremotesensing_tpu_torch.serving import InferenceServer

ARTIFACTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "benchmarks", "gate_artifacts")
HR = 16
STEM = dict(s2d=True, tap44="stem", fused_att=True, dec_block=True, use_pallas=True)


@pytest.fixture(scope="module")
def sar_model():
    m = residual_attention_unet_sar_to_ndvi(**STEM)
    m.load_state_dict(init_params(2, "sar", device="cpu"))
    return m


@pytest.fixture(scope="module")
def gen_model():
    m = residual_attention_unet_generation(num_classes=10, **STEM)
    m.load_state_dict(init_params(2, "generation", device="cpu"))
    return m


def _concurrent(server, conds):
    """Each condition as its own request, all at once: the answers, or the
    exception each request raised."""
    results = [None] * len(conds)

    def one(i):
        try:
            results[i] = server.infer_batch([conds[i]])[0]
        except ValueError as e:
            results[i] = e

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(conds))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    return results


def test_sar_server_answers_and_refuses_a_bad_shape_alone(sar_model):
    server = InferenceServer(sar_model, "cosine", 20, HR, task="sar", ddim_steps=3, max_batch=4,
                             device="cpu")
    try:
        assert server.expected_cond_shape == (HR, HR, 2)
        rng = np.random.default_rng(0)
        good = [rng.random((HR, HR, 2)).astype(np.float32) for _ in range(3)]
        out = _concurrent(server, good[:2] + [np.zeros((HR // 2, HR // 2, 2), np.float32)] + good[2:])
        assert isinstance(out[2], ValueError) and "shape" in str(out[2])
        for r in out[:2] + out[3:]:
            assert r.shape == (HR, HR, 1) and np.isfinite(r).all() and 0 <= r.min() and r.max() <= 1
        with pytest.raises(ValueError, match="superres"):
            server.infer_tile(np.zeros((HR, HR, 2), np.float32))
    finally:
        server.shutdown()


def test_generation_server_answers_with_cfg_and_refuses_bad_labels(gen_model):
    server = InferenceServer(gen_model, "cosine", 20, HR, task="generation", ddim_steps=3,
                             max_batch=4, device="cpu")
    try:
        assert server.expected_cond_shape == () and server.num_classes == 10
        # classifier-free guidance at scale 3, as the reference serves it
        assert any(k[0] == "ddim" and k[3] == 3.0 for k in server.process._samplers)
        out = _concurrent(server, [0, 9, 10, -1, 2.5, np.int32(4)])
        for bad in out[2:5]:
            assert isinstance(bad, ValueError)
        for r in out[:2] + out[5:]:
            assert r.shape == (HR, HR, 3) and np.isfinite(r).all() and 0 <= r.min() and r.max() <= 1
    finally:
        server.shutdown()
    ddpm = InferenceServer(gen_model, "cosine", 5, HR, task="generation", device="cpu")
    try:
        assert ddpm.infer_batch([1])[0].shape == (HR, HR, 3)
        assert ("ddpm", 3.0, False, False, None) in ddpm.process._samplers
    finally:
        ddpm.shutdown()


@pytest.mark.parametrize("task", ["sar", "generation"])
def test_start_t_is_refused_for_the_other_tasks(task, sar_model, gen_model):
    model = sar_model if task == "sar" else gen_model
    with pytest.raises(ValueError, match="start_t"):
        InferenceServer(model, "cosine", 20, HR, task=task, start_t=10, device="cpu")


def test_superres_start_t_serves_requests_and_tiles():
    m = residual_attention_unet_superres(magnification_factor=2, s2d=True, tap44="block")
    m.load_state_dict(init_params(1, device="cpu"))
    server = InferenceServer(m, "cosine", 20, HR, ddim_steps=3, start_t=8, max_batch=2,
                             device="cpu")
    try:
        assert ("ddim", 3, 0.0, None, "linear", True, 8, False) in server.process._samplers
        out = server.infer_batch([np.full((HR // 2, HR // 2, 3), 0.5, np.float32)])[0]
        assert out.shape == (HR, HR, 3) and np.isfinite(out).all()
        tile = server.infer_tile(np.random.default_rng(3).random((12, 20, 3)).astype(np.float32))
        assert tile.shape == (24, 40, 3) and 0 <= tile.min() and tile.max() <= 1
    finally:
        server.shutdown()
    # the aggregation sampler alone, DDPM truncated at start_t
    agg = AggregationSampler(server.process, patch_size=HR // 2, stride=HR // 4,
                             magnification_factor=2, start_t=4)
    out = agg(np.full((HR // 2, HR // 2, 3), 0.5, np.float32),
              generator=torch.Generator().manual_seed(0), device="cpu")
    assert out.shape == (HR, HR, 3) and np.isfinite(out).all()


@pytest.mark.parametrize("task,snapshot", [("sar", "snapshot_sar.pt"), ("generation", "snapshot_gen.pt")])
def test_trained_snapshot_forward_matches_reference(task, snapshot):
    path = os.path.join(ARTIFACTS, snapshot)
    num_classes = 4 if task == "generation" else None
    server = InferenceServer.from_snapshot(path, "cosine", 1500, HR, task=task,
                                           num_classes=num_classes, model_flags=STEM,
                                           ddim_steps=3, device="cpu")
    try:
        rng = np.random.default_rng(5)
        c = 1 if task == "sar" else 3
        x = rng.standard_normal((2, HR, HR, c)).astype(np.float32)
        t = np.array([20, 900], np.float32)
        if task == "sar":
            cond, mask = rng.random((2, HR, HR, 2)).astype(np.float32), None
            jm = jax_sar()
        else:
            cond, mask = np.array([1, 3], np.int64), np.array([1.0, 0.0], np.float32)
            jm = jax_generation(num_classes=num_classes)
        variables, _ = jax_load_snapshot(path)
        want = np.asarray(jm.apply(variables, x, t, cond, mask, train=False))
        with torch.no_grad():
            got = server.model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond),
                               None if mask is None else torch.from_numpy(mask)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    finally:
        server.shutdown()
