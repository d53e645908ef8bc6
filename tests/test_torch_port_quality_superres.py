"""Quality gates of the port's super-resolution on the in-repo trained
snapshots, on the CPU (marked slow: minutes of CPU time; pass --runslow):
InferenceServer.from_snapshot(...).infer_tile at DDIM-100 with per-step x0
clamping on the four held-out eval tiles of benchmarks/learning_check.py
(HR 256 from default_rng(10_000), LR by its _degrade_lr), scored by the
port's own psnr/ssim against the reference's scores of the same snapshot
and data (evals/x2_ddim100.json, evals/x4_ddim100.json): the mean within
1 dB and 0.01 SSIM, and every tile above bicubic in PSNR and SSIM.

* x2 (snapshot_x2.pt): HR patch 128, LR patch 64, stride 32, 9 patches.
* x4 (snapshot_x4.pt): HR patch 128, LR patch 32, stride 16, 9 patches.

The port computes in float32 in s2d execution (tap44='block'), where the
reference's evaluation ran bfloat16; its noise comes from a torch
generator, not the reference's keys. Two more tests give both the same
noise, DDIM-100 the same x_T and T=1500 the same x_T and per-step noise,
and find the same patches: a gap between their scores is the noise draw."""

import json
import os

import numpy as np
import pytest
import torch

from benchmarks import learning_check as lc
from diffusionremotesensing_tpu_torch.aggregation import AggregationSampler
from diffusionremotesensing_tpu_torch.ops.resize import upsample_bicubic
from diffusionremotesensing_tpu_torch.serving import InferenceServer
from diffusionremotesensing_tpu_torch.utils import psnr, ssim

pytestmark = pytest.mark.slow

ARTIFACTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "benchmarks", "gate_artifacts")
FLAGS = dict(s2d=True, tap44="block")
PSNR_TOL, SSIM_TOL = 1.0, 0.01


@pytest.mark.parametrize("mag,snapshot,reference", [
    (2, "snapshot_x2.pt", "x2_ddim100.json"), (4, "snapshot_x4.pt", "x4_ddim100.json")])
def test_superres_snapshot_ddim100_within_1db_of_reference(mag, snapshot, reference):
    with open(os.path.join(ARTIFACTS, "evals", reference)) as f:
        ref = json.load(f)
    erng = np.random.default_rng(0 + 10_000)  # learning_check.prepare's eval tiles
    tiles = [lc._draw_image(erng, lc.TILE_HR) for _ in range(4)]
    server = InferenceServer.from_snapshot(os.path.join(ARTIFACTS, snapshot), "cosine", 1500,
                                           lc.HR, magnification_factor=mag, model_flags=FLAGS,
                                           ddim_steps=100, device="cpu")
    rows = []
    try:
        assert server.expected_cond_shape[0] == ref["patch_size"]
        for hr_u8 in tiles:
            hr = hr_u8.astype(np.float32) / 255.0
            lr = lc._degrade_lr(hr_u8, mag)
            sr = server.infer_tile(lr)
            bic = upsample_bicubic(torch.from_numpy(lr)[None], mag)[0].clamp(0, 1).numpy()
            rows.append({"sr_psnr_db": psnr(sr, hr), "sr_ssim": ssim(sr, hr),
                         "bicubic_psnr_db": psnr(bic, hr), "bicubic_ssim": ssim(bic, hr)})
    finally:
        server.shutdown()
    mean = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
    print(json.dumps({"magnification": mag, "tiles": rows, "mean": mean,
                      "reference_mean_sr_psnr_db": ref["mean_sr_psnr_db"],
                      "reference_mean_sr_ssim": ref["mean_sr_ssim"],
                      "reference_mean_bicubic_psnr_db": ref["mean_bicubic_psnr_db"]}))
    for r in rows:
        assert r["sr_psnr_db"] > r["bicubic_psnr_db"] and r["sr_ssim"] > r["bicubic_ssim"]
    assert abs(mean["sr_psnr_db"] - ref["mean_sr_psnr_db"]) <= PSNR_TOL
    assert abs(mean["sr_ssim"] - ref["mean_sr_ssim"]) <= SSIM_TOL


def test_superres_snapshot_ddim100_equals_the_reference_on_the_same_noise():
    """DDIM with eta 0 is a function of x_T: given the same x_T, the port's
    and the reference's DDIM-100 on the trained x2 snapshot (float32, tile 0's
    9 patches) agree to 1e-4, so a gap between their scores on the eval
    tiles is the draw of x_T, not the port."""
    import jax
    import jax.numpy as jnp

    from diffusionremotesensing_tpu.diffusion import make_process as jax_make_process
    from diffusionremotesensing_tpu.io import load_snapshot as jax_load_snapshot
    from diffusionremotesensing_tpu.models.unet import residual_attention_unet_superres as jax_sr

    path = os.path.join(ARTIFACTS, "snapshot_x2.pt")
    erng = np.random.default_rng(0 + 10_000)
    lr = lc._degrade_lr(lc._draw_image(erng, lc.TILE_HR), 2)
    server = InferenceServer.from_snapshot(path, "cosine", 1500, lc.HR, model_flags=FLAGS,
                                           ddim_steps=100, device="cpu")
    try:
        patches, _ = AggregationSampler(server.process, 64, 32, 2).extract_patches(lr)
        x_T = np.random.default_rng(0).standard_normal((len(patches), 128, 128, 3)).astype(np.float32)
        with torch.no_grad():
            got = server.process.ddim_sampler(100, clip_x0=True)(
                torch.from_numpy(x_T), torch.from_numpy(patches)).numpy()
    finally:
        server.shutdown()
    state, _ = jax_load_snapshot(path)
    variables = {"params": state["params"], "batch_stats": state.get("batch_stats", {})}
    proc = jax_make_process(jax_sr(magnification_factor=2, s2d=True), "cosine", 1500, lc.HR)
    want = np.asarray(proc.ddim_sampler(100, 0.0, clip_x0=True)(
        variables, jax.random.PRNGKey(0), jnp.asarray(x_T), jnp.asarray(patches)))
    assert np.abs(got - want).max() <= 1e-4


def _x2_eval(mag=2):
    erng = np.random.default_rng(0 + 10_000)
    tiles = [lc._draw_image(erng, lc.TILE_HR) for _ in range(4)]
    return tiles, [lc._degrade_lr(t, mag) for t in tiles]


def test_superres_x2_ddim100_spread_over_draws_matches_the_reference_package():
    """One draw of the four eval tiles is a noisy score: the port's
    DDIM-100 mean over server seeds 0-3 and the reference package's over
    key sets 100, 200 and 300 (float32 both), each draw printed; the two
    packages' means of their draws within 0.5 dB of each other."""
    import jax

    from diffusionremotesensing_tpu.aggregation import AggregationSampler as JaxAgg
    from diffusionremotesensing_tpu.diffusion import make_process as jax_make_process
    from diffusionremotesensing_tpu.io import load_snapshot as jax_load_snapshot
    from diffusionremotesensing_tpu.models.unet import residual_attention_unet_superres as jax_sr

    path = os.path.join(ARTIFACTS, "snapshot_x2.pt")
    tiles, lrs = _x2_eval()
    hrs = [t.astype(np.float32) / 255.0 for t in tiles]
    port = []
    for seed in range(4):
        server = InferenceServer.from_snapshot(path, "cosine", 1500, lc.HR, model_flags=FLAGS,
                                               ddim_steps=100, device="cpu", seed=seed)
        try:
            port.append(float(np.mean([psnr(server.infer_tile(lr), hr)
                                       for lr, hr in zip(lrs, hrs)])))
        finally:
            server.shutdown()
    state, _ = jax_load_snapshot(path)
    variables = {"params": state["params"], "batch_stats": state.get("batch_stats", {})}
    agg = JaxAgg(jax_make_process(jax_sr(magnification_factor=2, s2d=True), "cosine", 1500, lc.HR),
                 patch_size=64, stride=32, magnification_factor=2, ddim_steps=100)
    ref = [float(np.mean([psnr(np.asarray(agg(variables, lr, key=jax.random.PRNGKey(base + i))), hr)
                          for i, (lr, hr) in enumerate(zip(lrs, hrs))]))
           for base in (100, 200, 300)]
    print(json.dumps({"port_draw_means_db": port, "reference_package_draw_means_db": ref}))
    assert abs(np.mean(port) - np.mean(ref)) <= 0.5


def test_superres_x2_ddpm1500_equals_the_reference_on_the_same_noise():
    """The T=1500 ancestral chain on the trained x2 snapshot (float32, tile
    0's 9 patches): the reference's own DDPM sampler from a key, and the
    port's given the same x_T and, through noise_fn, the noise that key's
    split chain draws step after step. The two chains' patches agree to
    1e-4 and score the same against the HR tile within 1e-4 dB (read:
    1.5e-6 and 2e-6 dB), so a gap between a T=1500 score and the
    reference's is the draw, not the port."""
    import jax
    import jax.numpy as jnp

    from diffusionremotesensing_tpu import diffusion as jdiff
    from diffusionremotesensing_tpu.io import load_snapshot as jax_load_snapshot
    from diffusionremotesensing_tpu.models.unet import residual_attention_unet_superres as jax_sr

    path = os.path.join(ARTIFACTS, "snapshot_x2.pt")
    tiles, lrs = _x2_eval()
    hr = tiles[0].astype(np.float32) / 255.0
    key = jax.random.PRNGKey(0)
    server = InferenceServer.from_snapshot(path, "cosine", 1500, lc.HR, model_flags=FLAGS,
                                           device="cpu")
    try:
        patches, boxes = AggregationSampler(server.process, 64, 32, 2).extract_patches(lrs[0])
        x_T = np.random.default_rng(0).standard_normal((len(patches), 128, 128, 3)).astype(np.float32)
        chain = {"k": key}
        split = jax.jit(jax.random.split)
        draw = jax.jit(lambda k: jdiff._normal_packed(k, x_T.shape, jnp.float32))
        asked = []

        def noise_fn(i, shape):
            # the reference's step i: k, k_noise = split(k); z from k_noise
            asked.append(i)
            assert tuple(shape) == x_T.shape
            chain["k"], kn = split(chain["k"])
            return torch.from_numpy(np.array(draw(kn)))

        with torch.no_grad():
            got = server.process.sampler()(torch.from_numpy(x_T), torch.from_numpy(patches),
                                           noise_fn=noise_fn).numpy()
    finally:
        server.shutdown()
    assert asked == list(range(1499, 1, -1))
    state, _ = jax_load_snapshot(path)
    variables = {"params": state["params"], "batch_stats": state.get("batch_stats", {})}
    proc = jdiff.make_process(jax_sr(magnification_factor=2, s2d=True), "cosine", 1500, lc.HR)
    want = np.asarray(proc.sampler()(variables, key, jnp.asarray(x_T), jnp.asarray(patches)))
    crops = np.stack([hr[y0:y1, x0:x1] for (y0, y1, x0, x1) in boxes])
    scores = {k: psnr(np.clip(v, 0.0, 1.0), crops) for k, v in (("port", got), ("reference", want))}
    err = float(np.abs(got - want).max())
    print(json.dumps({"tile0_patches_ddpm1500_psnr_db": scores, "max_abs_diff": err}))
    assert err <= 1e-4
    assert abs(scores["port"] - scores["reference"]) <= 1e-4


# W8A8 on the trained x2 snapshot: the two packages' int8 DDIM-100 patches
# on the reference's scales and the same x_T. An activation within float32
# rounding of a quantization boundary rounds the other way in one package,
# and the 100 steps carry that on: the patches read up to 0.0704 apart
# (0.061-0.070 a tile; the float32 chains 3.0e-6), the tiles' PSNR up to
# 0.086 dB and SSIM 0.00063 apart; held to INT8_AGREE_TOL and
# INT8_AGREE_PSNR_TOL / INT8_AGREE_SSIM_TOL. Each package's int8-minus-float
# gap over the four eval tiles is printed (the reference's -0.9817 dB /
# -0.0551 SSIM, the port's on its own calibration -1.0411 / -0.0582), and
# the port's is held to the reference's within the card's gate,
# INT8_GAP_PSNR_TOL dB / INT8_GAP_SSIM_TOL
INT8_AGREE_TOL = 0.1
INT8_AGREE_PSNR_TOL, INT8_AGREE_SSIM_TOL = 0.15, 0.002
INT8_GAP_PSNR_TOL, INT8_GAP_SSIM_TOL = 0.5, 0.005


def _blend(sampler, out, boxes, shape):
    """AggregationSampler's canvas of denoised patches: sum(w * patch) / sum(w),
    clamped to [0, 1]."""
    canvas, count = np.zeros(shape, np.float32), np.zeros(shape[:2] + (1,), np.float32)
    w = sampler.weight[:, :, None]
    for patch, (y0, y1, x0, x1) in zip(out, boxes):
        canvas[y0:y1, x0:x1] += patch * w
        count[y0:y1, x0:x1] += w
    return np.clip(canvas / count, 0.0, 1.0)


def test_superres_x2_int8_ddim100_against_the_reference_package():
    """quantize_superres_tile + DDIM-100 on the x2 snapshot over the four
    eval tiles, float32, dense s2d (the reference's default: every s2d conv
    site quantizable), each tile's 9 patches from one x_T in both packages:
    the reference's int8 patches, the port's on the reference's scales
    (convert.from_jax_quant) within INT8_AGREE_TOL of them and their tiles'
    scores within INT8_AGREE_PSNR_TOL / INT8_AGREE_SSIM_TOL; the float
    patches of both; the port's int8 on its own calibration (its generator
    seeded 21, where the reference folds PRNGKey(21)). Prints each
    package's int8-minus-float PSNR/SSIM gap, the number the card's cli
    phase is held to."""
    import jax
    import jax.numpy as jnp

    from diffusionremotesensing_tpu.diffusion import make_process as jax_make_process
    from diffusionremotesensing_tpu.io import load_snapshot as jax_load_snapshot
    from diffusionremotesensing_tpu.models.unet import residual_attention_unet_superres as jax_sr
    from diffusionremotesensing_tpu.ops import quant as jq
    from diffusionremotesensing_tpu_torch.convert import from_jax_quant
    from diffusionremotesensing_tpu_torch.ops import quant as tq

    path = os.path.join(ARTIFACTS, "snapshot_x2.pt")
    tiles, lrs = _x2_eval()
    state, _ = jax_load_snapshot(path)
    variables = {"params": state["params"], "batch_stats": state.get("batch_stats", {})}
    jmodel = jax_sr(magnification_factor=2, s2d=True)
    jproc = jax_make_process(jmodel, "cosine", 1500, lc.HR)
    jddim = jproc.ddim_sampler(100, 0.0, clip_x0=True)
    server = InferenceServer.from_snapshot(path, "cosine", 1500, lc.HR,
                                           model_flags=dict(s2d=True), ddim_steps=100,
                                           device="cpu")
    proc = server.process
    sampler = AggregationSampler(proc, 64, 32, 2)
    ddim = proc.ddim_sampler(100, clip_x0=True)
    rows, errs, sites = [], [], []
    try:
        for k, (hr_u8, lr) in enumerate(zip(tiles, lrs)):
            hr = hr_u8.astype(np.float32) / 255.0
            patches, boxes = sampler.extract_patches(lr)
            x_T = np.random.default_rng(100 + k).standard_normal(
                (len(patches), 128, 128, 3)).astype(np.float32)
            vq = jq.quantize_superres_tile(jmodel, variables, jproc.schedule.alpha_hat, lr, 64, 2,
                                           jax.random.PRNGKey(21))
            out = {}
            for name, vs in (("ref_float", variables), ("ref_int8", vq)):
                out[name] = np.asarray(jddim(vs, jax.random.PRNGKey(0), jnp.asarray(x_T),
                                             jnp.asarray(patches)))
            own = tq.quantize_superres_tile(proc.net, proc.schedule.alpha_hat, lr, 64, 2,
                                            torch.Generator().manual_seed(21))
            sites.append(len(own))
            for name, qmap in (("port_float", None),
                               ("port_int8_ref_scales", from_jax_quant(vq["quant"], "superres")),
                               ("port_int8", own)):
                tq.attach(proc.net, qmap)
                with torch.no_grad():
                    out[name] = ddim(torch.from_numpy(x_T), torch.from_numpy(patches)).numpy()
            tq.attach(proc.net, None)
            errs.append({"int8_ref_scales": float(np.abs(out["port_int8_ref_scales"]
                                                         - out["ref_int8"]).max()),
                         "float": float(np.abs(out["port_float"] - out["ref_float"]).max())})
            srs = {n: _blend(sampler, o, boxes, hr.shape) for n, o in out.items()}
            rows.append({n: {"psnr_db": psnr(s, hr), "ssim": ssim(s, hr)} for n, s in srs.items()})
    finally:
        tq.attach(proc.net, None)
        server.shutdown()
    mean = {n: {m: float(np.mean([r[n][m] for r in rows])) for m in ("psnr_db", "ssim")}
            for n in rows[0]}
    gap = {"reference": {m: mean["ref_int8"][m] - mean["ref_float"][m] for m in ("psnr_db", "ssim")},
           "port": {m: mean["port_int8"][m] - mean["port_float"][m] for m in ("psnr_db", "ssim")}}
    print(json.dumps({"int8_ddim100_x2": {"mean": mean, "int8_minus_float": gap,
                                          "max_abs_diff": errs, "port_sites": sites,
                                          "tiles": rows}}))
    assert max(e["float"] for e in errs) <= 1e-4
    assert max(e["int8_ref_scales"] for e in errs) <= INT8_AGREE_TOL
    for r in rows:
        assert abs(r["port_int8_ref_scales"]["psnr_db"] - r["ref_int8"]["psnr_db"]) <= INT8_AGREE_PSNR_TOL
        assert abs(r["port_int8_ref_scales"]["ssim"] - r["ref_int8"]["ssim"]) <= INT8_AGREE_SSIM_TOL
    assert gap["port"]["psnr_db"] >= gap["reference"]["psnr_db"] - INT8_GAP_PSNR_TOL
    assert gap["port"]["ssim"] >= gap["reference"]["ssim"] - INT8_GAP_SSIM_TOL
