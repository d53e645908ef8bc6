"""Quality gates of the port on the in-repo trained snapshots, on the CPU
(marked slow: minutes of CPU time; pass --runslow): the port's DDIM-100
with per-step x0 clamping on the procedural eval data that
benchmarks/learning_check.py draws with numpy, scored by its own helpers.

* SAR->NDVI (snapshot_sar.pt): the 8 eval pairs of prepare_sar (_sar_pair
  from seed + 10000): the port beats the per-pixel linear baseline and its
  PSNR is within 1 dB of the reference's on the same snapshot and data
  (evals/sar_ddim100_clip.json, 41.69 dB).
* generation (snapshot_gen.pt, 4 classes, 32 px): CFG 3 samples classified
  by pattern at accuracy >= 0.9 and, at CFG 1, a within-class colour
  diversity at least half the data's (evaluate_gen's `passes` rule; the
  reference scored 0.969 and 1.119).

The port computes in float32 in s2d execution (tap44='block'), where the
reference's evaluation ran bfloat16; its noise comes from a torch
generator, not the reference's keys. Scores are the port's own psnr/ssim
(equal to the reference's, tests/test_torch_port_utils.py)."""

import json
import os

import numpy as np
import pytest
import torch

from benchmarks import learning_check as lc
from diffusionremotesensing_tpu_torch.serving import InferenceServer
from diffusionremotesensing_tpu_torch.utils import psnr, ssim

pytestmark = pytest.mark.slow

ARTIFACTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "benchmarks", "gate_artifacts")
FLAGS = dict(s2d=True, tap44="block")


def _evals(name):
    with open(os.path.join(ARTIFACTS, "evals", name)) as f:
        return json.load(f)


def test_sar_snapshot_ddim100_beats_linear_within_1db_of_reference():
    erng = np.random.default_rng(0 + 10_000)  # prepare_sar's eval pairs
    pairs = [lc._sar_pair(erng, lc.SAR_SIZE) for _ in range(8)]
    sar = np.stack([p[0] for p in pairs]).transpose(0, 2, 3, 1).astype(np.float32)
    gt = np.stack([p[1] for p in pairs]).transpose(0, 2, 3, 1).astype(np.float32)
    server = InferenceServer.from_snapshot(os.path.join(ARTIFACTS, "snapshot_sar.pt"), "cosine",
                                           1500, lc.SAR_SIZE, task="sar", model_flags=FLAGS,
                                           ddim_steps=100, device="cpu")
    try:
        g = torch.Generator().manual_seed(5)
        x_T = torch.randn((len(sar), lc.SAR_SIZE, lc.SAR_SIZE, 1), generator=g)
        pred = server.process.ddim_sampler(100, clip_x0=True)(x_T, torch.from_numpy(sar))
        pred = pred.clamp(0.0, 1.0).numpy()
    finally:
        server.shutdown()
    X = np.stack([sar[..., 0].ravel(), sar[..., 1].ravel(), np.ones(gt.size)], axis=1)
    w, *_ = np.linalg.lstsq(X, gt.ravel(), rcond=None)
    lin = np.clip((X @ w).reshape(gt.shape), 0.0, 1.0)
    ref = _evals("sar_ddim100_clip.json")
    got = {"sar_psnr_db": psnr(pred, gt), "sar_ssim": ssim(pred, gt),
           "linear_baseline_psnr_db": psnr(lin, gt), "reference_psnr_db": ref["sar_psnr_db"]}
    print(json.dumps(got))
    assert got["sar_psnr_db"] > got["linear_baseline_psnr_db"]
    assert abs(got["sar_psnr_db"] - ref["sar_psnr_db"]) <= 1.0


def test_gen_snapshot_ddim100_cfg3_passes_evaluate_gens_rule():
    n_per_class, classes = 32, lc.GEN_CLASSES
    labels = np.repeat(np.arange(len(classes)), n_per_class)
    server = InferenceServer.from_snapshot(os.path.join(ARTIFACTS, "snapshot_gen.pt"), "cosine",
                                           1500, lc.GEN_SIZE, task="generation",
                                           num_classes=len(classes), model_flags=FLAGS,
                                           ddim_steps=100, device="cpu")
    try:
        kw = dict(ddim_steps=100, ddim_clip_x0=True)
        imgs = server.process.sample(len(labels), cond=labels, cfg_scale=3.0,
                                     generator=torch.Generator().manual_seed(11), **kw)
        imgs_nc = server.process.sample(len(labels), cond=labels, cfg_scale=1.0,
                                        generator=torch.Generator().manual_seed(13), **kw)
    finally:
        server.shutdown()
    imgs, imgs_nc = (np.clip(a.numpy(), 0.0, 1.0) for a in (imgs, imgs_nc))
    acc = float((lc.classify_by_pattern(imgs) == labels).mean())
    rng = np.random.default_rng(23)  # evaluate_gen's reference images
    ref_imgs = [lc._gen_image(rng, name).astype(np.float32) / 255.0
                for name in classes for _ in range(n_per_class)]
    div_data = lc._color_diversity(np.stack(ref_imgs), labels, len(classes))
    ratio = lc._color_diversity(imgs_nc, labels, len(classes)) / max(div_data, 1e-9)
    ref = _evals("gen_ddim100_clip.json")
    print(json.dumps({"accuracy": acc, "diversity_ratio_cfg1": ratio,
                      "reference_accuracy": ref["accuracy"],
                      "reference_diversity_ratio_cfg1": ref["diversity_ratio_cfg1"]}))
    assert acc >= 0.9 and ratio >= 0.5
