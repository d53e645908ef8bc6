#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main paths on one CUDA card.

    python3 chip_smoke.py [--profile]

Six paths of x2 super-resolution at full width and depth (random weights
from init_params(SEED), cosine T=1500, bfloat16, s2d execution of level 0):

* unfused: tap44='block', whose one kernel is tap_block;
* fused:   tap44='block', fused_att=True, dec_block=True: tap_block,
           att_head_block and dec_block;
* stem:    tap44='stem', fused_att=True, dec_block=True, use_pallas=True:
           tap_stem_block, fused_attention_gate (gates 0 and 1),
           att_head_block and dec_block (ancestral_update runs on the
           quality phase's, the tasks' and the cli phase's T=1500 chains);
* tap:     tap44=True: tap_conv_pair (conv1 and skip) and tap_conv (conv2);
* packed:  tap44='block', packed_head=True: tap_block and packed_head (the
           head's head_up4 and head_at convs on the unfused tail);
* l1:      tap44='l1': tap_block twice a forward, ResConvBlock-0 and, at
           level 1 in s2d without its skip conv, ResConvBlock-1.

And the other two tasks (random weights from init_params(SEED, variant),
64x64 images, bfloat16, s2d):

* sar:        the SAR->NDVI model (1 NDVI channel, 2 SAR channels) in the
              stem configuration, the most fused: tap_stem_block at CX4 = 4,
              the gates, att_head_block and dec_block at out4 = 4, and
              ancestral_update; sar_packed: tap44='block' with packed_head
              at out4 = 4;
* generation: the class-conditional model (10 classes), stem configuration,
              classifier-free guidance at scale 3 (one model call on twice
              the batch): tap_stem_block without a condition tensor, the
              rest at the x2 widths;
* x2_start_t: x2 with start_t=250, the bicubic warm start.

And trained weights: the repo's x2 snapshot, served in the stem
configuration at DDIM-100 and T=1500 with and without fused_update, scored
on the eval tiles of benchmarks/learning_check.py (the quality phase), and
driven through the port's command line (the cli phase):

* cli: `python -m diffusionremotesensing_tpu_torch.cli` in-process
       (cli.main): aggregation with --tap44 stem --fused_att --dec_block
       (float32): tap_stem_block, att_head_block and dec_block, and with
       --fused_update ancestral_update; serve (bfloat16) the same three.

packed_conv is on no path: the JAX model never calls its TPU kernel, so the
port has no caller either. It is held against its plain version and timed
in the kernel phase, and its launches in the kernels line are that phase's.

Phases, each printing one line with its name, seconds and result:

1. device  - require a CUDA card; print its name and nvidia-smi's name and
             power limit.
2. build   - nvcc every CUDA source of the port (csrc/*.cu), one process
             per source, all started together; print each one's ptxas lines.
3. kernel  - hold each kernel against its plain version on the card at the
             main path's shapes (B=48 and the B=1 remainder chunk, 64x64 s2d
             pixels; the gates at gates 0 and 1's shapes, and gate 2's of
             the plain forward; tap_block also at level 1's, 32x32 s2d
             pixels, 4Ci=128, 4Co=256, no skip; packed_conv at 64->64 and
             192->64, 64x64 pixels) in bfloat16 and float32; time the kernel,
             the plain version and the port's unfused ops for the same
             function (the yardstick, which the kernel paths never call);
             in bfloat16 at B=48, REPEAT_CALLS calls of each kernel equal
             bitwise to its first (a race shows as a difference).
             tap_block (both levels), tap_stem_block, att_head_block, the
             gate (at C = 32, 64 and 128), packed_conv (64->64, 192->64 and
             32->48) and packed_head (at C2 = 128, and at C2 = 144, which
             its shape dispatch sends to the first design's kernel) also on
             ragged images at B=2, which no tile divides; in bfloat16 each
             launch's device time (torch.profiler) of those, and two seam
             probes:
             level 0's phase A at 1.5x the batch (a recomputed halo's
             cost) beside h's bytes at the HBM rate, and att_head_block's
             gate kernel at 1.27x the batch beside attn_s's bytes. The
             gates' yardstick (cuDNN's layer-by-layer gate) is read three
             more times, with the spread.
             ancestral_update also: its generator's words equal the plain
             Philox's, the given bits mode, the moments of its noise, the
             last step exact, the second half of the chunk at its quad
             offset (one replica's share of a split chunk) bitwise the
             whole chunk's half and against the plain version; and,
             since a call issues slower than the card runs it, its and
             its library's device ms with the host's issue
             taken out (torch.profiler, and 20 calls queued behind a sleep
             kernel between two events), each call on inputs and an output
             out of the L2 as the sampler finds them, and the host's us to
             issue a call.
             The shapes of the other two models (SHAPE_ROWS): the stem at
             CX4 = 4 and without a condition tensor, att_head_block,
             dec_block and packed_head at out4 = 4, at B=48 on 32 x 32 s2d
             pixels and on a ragged B=2 image, bfloat16 and float32, with
             their times, bounds and library times.
4. golden  - the full-width UNet on the card in float32 (plain forward, with
             and without use_pallas; s2d at every tap44 level; the fused,
             stem, packed and l1 configurations) against values the JAX reference
             package computed for the same weights and input (GOLDEN below),
             with the launches each forward makes; the SAR->NDVI and
             class-conditional models (labels and a CFG mask) likewise in
             the plain, dense-s2d, stem, fused and packed configurations
             against GOLDEN_SAR and GOLDEN_GEN.
5. model   - the full-width UNet forward at B=48, HR 128: tap44 'block',
             'conv2' and True and the fused, stem, packed, l1 and l1_fused
             configurations each against the dense-s2d path, in bfloat16 and
             float32; and one DDIM-100 tile each of the fused, stem and l1
             configurations against the unfused one in float32. The
             SAR->NDVI and class-conditional models at B=48 on 64x64 images
             in the block, stem, fused and packed configurations against
             dense-s2d, bfloat16 and float32.
6. serve   - each path with every launch count set to 0 just before it and
             read just after. Unfused: an InferenceServer answers 4
             concurrent 64x64 requests at DDIM-100 and 2 tiles of 256x256
             at DDIM-100. Fused, stem, tap, packed and l1: 4 requests and 1
             DDIM-100 tile (their T=1500 tiles were cut to keep the
             script's time, packed's once the quality phase came, the
             others' once the cli phase came: the quality phase's T=1500
             passes run the unfused sampler and the fused update).
             x2_start_t: 1 DDIM-100 request from the warm start at 250. SAR
             (stem): 8 concurrent DDIM-100 requests (max_batch 8) and 1 on
             the T=1500 chain with fused_update; SAR packed: 8 DDIM-100
             requests. Generation (stem, CFG 3): 8 concurrent labels at
             DDIM-100, one DiffusionProcess.sample call at eta 0.5 on the
             quadratic subsequence, 1 label on the T=1500 chain with
             fused_update. A bad SAR shape and a label out of range are
             refused. Checks shapes, finiteness, range and the exact
             launches of every kernel.
7. checkpoint - save_snapshot of the init_params(SEED) model (flax's
             msgpack, written by the port's own writer) into a temporary
             directory, load_snapshot back (the weights equal), and
             InferenceServer.from_snapshot: one bfloat16 forward bitwise
             equal to the original model's, one served micro-batch. Which
             of tensorstore, zstandard and orbax are installed (read from
             their metadata, none imported), and with tensorstore the
             Orbax step: the train phase's flagship recipe 3 steps, then
             Trainer.save_snapshot with checkpoint_backend='orbax'
             (returns before the write) and finalize_snapshots, each on
             the host clock beside the msgpack backend's save of the same
             state; a second save leaves one step directory and no
             temporary one; a new Trainer resumes from the directory with
             the weights and BatchNorm statistics bitwise and the epochs
             (without tensorstore one line says so and the phase goes on).
8. quality - the repo's trained x2 snapshot
             (benchmarks/gate_artifacts/snapshot_x2.pt, read by the port's
             io) served by InferenceServer.from_snapshot in the stem
             configuration, bfloat16, on the four eval tiles of
             benchmarks/learning_check.py (drawn here with numpy), their
             LR learning_check's (Pillow's bicubic and blur at 0.5, bit-equal
             without PIL: data.datasets.pil_downblur_u8; the on-device
             DownBlur's largest difference from it is reported):
             DDIM-100, T=1500 and T=1500 with fused_update, QUALITY_DRAWS
             (9) super-resolutions of each tile, the first
             through infer_tile a tile at a time (9 patches, one chunk), the
             rest through infer_tiles (chunks of 48 patches of several
             tiles). One JSON line a pass: the first draw's per-tile and
             mean PSNR/SSIM (the port's utils), the mean over all draws,
             each draw's mean PSNR, bicubic's, the seconds and the exact
             launches (100 or 1499 forwards a chunk, 1499 ancestral_update a
             chunk on the fused pass). Fails unless every tile of every draw
             beats bicubic in PSNR and SSIM, each pass's mean is within 1 dB
             and 0.01 SSIM of the reference's score of the same snapshot and
             tiles (evals/x2_ddim100.json, x2_ddpm_full.json) and the fused
             pass within 0.5 dB and 0.005 of the unfused one.
9. cli     - the port's command line in-process (cli.main), in a
             temporary directory whose models_run/x2/weights/snapshot.pt
             links the x2 snapshot, on the quality phase's four eval LR
             tiles written as PNG by png.py. Aggregation in directory mode
             at DDIM-100 with CLI_FLAGS: every output 256x256x3, within
             TILE_TOL (plus the PNG's 1/255) of AggregationSampler on the
             same weights and image i's generator
             (cli.aggregation_generator), above bicubic, exactly 100
             launches of tap_stem_block, att_head_block and dec_block a
             chunk; one tile with --fused_update --start_t 250, 250
             ancestral_update launches. --quant int8 on the four tiles (the
             calibrated sites printed), the int32 accumulators of an s2d
             site and a ConvTranspose site at B=48 bitwise equal to the
             exact plain product, and the paired quality gap: INT8_DRAWS
             draws a tile through sample_tiles, int8 on each tile's own
             calibration and unquantized on the same draws; the int8 mean
             minus the unquantized may not fall more than 0.5 dB / 0.005
             below the reference package's own gap (INT8_REF_GAP). Serve:
             build_server from serve's flags, one HTTP round trip on an
             ephemeral port equal to a twin server's infer_batch with the
             same seed, exact launches; again with --quant int8 (finite,
             above bicubic). The three models' census totals; which of
             matplotlib, cv2 and imageio import, and with matplotlib the
             superres trainer for one epoch of the train phase's 32 images
             as PNG files (previews written, no hand kernel launched).
10. helpers - the port's inference helpers (superres_and_NDVIgen,
             imgs_generator) from the in-repo snapshots in a temporary
             working directory laid out as models_run/<name>/weights,
             float32, DDIM-100, tap44 'block' (tap_block, 100 launches a
             call, exact): super_resolver on the x2 snapshot (a model name
             of LR 128) for one eval tile's LR, (256, 256, 3) in [0, 1],
             its PSNR and bicubic's; SAR_to_NDVI_generator on the SAR
             snapshot at its name's 128 px, two generations from a .npy of
             learning_check's SAR pair in [-1, 1] (the rescale taken);
             imgs_generator's sampling step (its main without the grid:
             the card has no matplotlib) on init_params(SEED,
             'generation') weights of ten classes written by save_snapshot
             to ../models_run, ten images in [0, 1]. The first two are
             held to make_process(...).sample of the same model and
             generator (bitwise expected, 1e-6 of max |out| allowed).
             First, with torch's TF32 defaults restored, a float32
             InferenceServer turns cuDNN's TF32 off and its forward equals
             the TF32-off reading within MODEL_TOL.
11. task_quality - the trained SAR->NDVI and generation snapshots
             (snapshot_sar.pt, snapshot_gen.pt: 4 classes, 32 px) served
             by InferenceServer.from_snapshot in the 'stem' configuration,
             bfloat16, DDIM-100 with x0 clamping: the stem at CX4 = 4 and
             bias-only, the heads at out4 = 4, CFG, on trained weights,
             exact launches. SAR on learning_check's 8 eval pairs: PSNR
             within 1 dB of the reference's (evals/sar_ddim100_clip.json)
             and above the per-pixel linear baseline; generation, 32
             images a class: CFG-3 accuracy by pattern >= 0.9 and the
             CFG-1 diversity ratio >= 0.5 (evaluate_gen's rule); each
             score beside the reference's.
12. train  - training, where no hand kernel runs (the JAX model gates every
             Pallas kernel off under train=True): the flagship recipe at
             full width (x2, init_params(SEED), HR 256, batch 32, uint8
             images from default_rng(SEED) through the on-device DownBlur
             at blur radius 0.5, cosine T=1500, MSE, EMA, lr 3e-4, bfloat16
             compute on float32 parameters), dense and s2d_train, with the
             model built with every kernel flag ('stem'): 3 warm-up steps
             and 20 timed, one JSON line each (steps/s, ms a step, peak
             memory, the final loss, nvidia-smi's name and power limit);
             every launch count 0 after them. Before them the data step:
             the first 32 of those images written as PNG files by the port's
             codec, read back through DecodeOnlyDataset and the DataLoader,
             the DownBlur on the card, bit-equal to the in-memory batch. One
             float32 step (HR 32,
             batch 4) on the card and on its host's CPU from the same
             weights, batch, t and noise, dense and s2d_train: the loss,
             every gradient, the parameters after Adam and the running
             statistics at the CPU tests' tolerances (STEP_*). Learning:
             one fixed batch (HR 64, batch 16, float32) for 60 steps, the
             last 10 steps' mean loss below half the first 10's. The
             trained snapshot (Trainer.save_snapshot) served from
             InferenceServer.from_snapshot in the 'stem' configuration: one
             DDIM-100 micro-batch of 8, finite, with the exact launches of
             the stem, gate, attention-head and decoder kernels.
13. parallel - data parallelism (parallel/): torch.distributed's NCCL
             availability and version printed; (a) a world-1 group
             (NCCL, or gloo by a printed choice where the card's torch has
             no NCCL) runs 3 + 5 steps of the train phase's flagship recipe
             through Trainer(mesh=make_mesh()), each loss within
             STEP_LOSS_RTOL of the same steps without a mesh, ms a step of
             both; (b) the quality phase's x2 snapshot ('stem', float32) on one
             eval tile (9 patches) through AggregationSampler on one device
             and over make_mesh([cuda:0, cuda:0]) (two replicas, the
             second a copy of the net, 5 patches each after the pad), DDIM-100 and the fused update's T=1500
             chain, each within TILE_TOL of the one device's, each replica
             launching what the one device launches; (c) two processes
             on the card in a gloo group over CUDA tensors (NCCL takes
             one rank a card): one float32 step,
             each rank its half of the STEP_* batch, against one process's
             (loss, statistics, gradient in L2, parameters), and the
             DDIM-100 tile split over the ranks against (b)'s one-device
             tile.
14. spatial - spatial partitioning (parallel.sharding.spatial_sharding,
             parallel.halo): one whole x2 image (LR 256 -> HR 512, B = 1, one
             512-px image of learning_check's kind) through the x2 snapshot
             in the 'stem' configuration (tap_stem_block, the gates,
             att_head_block and dec_block), its height split into bands on
             the one card, each band a replica with its halos exchanged by
             hand: (a) float32 DDIM-100 on one device and over
             make_mesh([cuda:0] * k), k = 2 and 4, each split within
             TILE_TOL of one device, the seam rows' difference read on its
             own; (b) each split's launches k times one device's, exactly
             (each band launches what one device does); (c) the fused
             ancestral_update chain warm-started at start_t=250 (250
             launches a band) split in 2 against one device, and the
             update's band layout on the card: two bands of a B = 2 state
             bitwise the whole state's rows, the whole image as its band
             bitwise today's stream, a band's words bitwise the plain
             Philox's; (d) bfloat16 DDIM-100 split in 2: finite, its
             distance from one device printed; (e) two processes on the card
             in a gloo group over CUDA tensors, one band a rank, halos by
             batch_isend_irecv: the DDIM-100 image against (a)'s one-device
             image within TILE_TOL; and the configurations whose kernels
             run inside a chain on an extended band, the same snapshot:
             (f) tap44=True (tap_conv_pair, tap_conv), 'conv2' (tap_conv),
             'l1' (tap_block twice a forward) and 'block' with packed_head,
             float32 DDIM-SPATIAL_LEVEL_STEPS on one device and split in 2
             and 4, each within TILE_TOL (seams on their own) with launches
             exactly k times one device's; (g) 'l1' in bfloat16 split in 2:
             finite, its distance printed; (h) int8 on 'l1':
             quantize_for_sampling on the image split in 2 against one
             device's, every scale within INT8_SCALE_RTOL, the quantized
             DDIM-SPATIAL_INT8_STEPS sampler split in 2 against one
             device's (distance printed), and one site's int32
             accumulators on band 1's quantized input bitwise the plain
             int32 product's; (i) tap_conv, tap_conv_pair, tap_block at
             level 1 and packed_head against their plain versions at the
             row counts the bands give at HR 512 (first, inner and last
             band, k = 2 and 4, parallel.halo.HALOS), float32 and bfloat16.
             The seconds of each run.
15. profile - only with --profile: where one sampler step's time goes, for
             one UNet forward of the unfused, fused, stem, tap, packed and l1
             configurations at B=48 and B=1: device ms, host ms to issue it
             (one forward queued alone behind a sleep kernel), wall ms, and
             the top kernels by device time from torch.profiler with every
             hand-written kernel; and where one training step's time goes
             (the train phase's recipe, dense and s2d_train): wall and
             device ms, the busy share, the top kernels.

Then a JSON line with each kernel's numbers (its launches summed over the
serve phase's paths, the quality phase's passes, the cli phase's runs, the
helpers' calls, the task_quality phase's samplers, the parallel phase's
split tiles and the spatial phase's runs,
packed_conv's the
kernel phase's; its times at B=48 in
its main path's dtype), a row of its own for each shape of SHAPE_ROWS
(launched by the SAR->NDVI or generation paths), and last
{"ok": true, "device": {...}}. Any failure raises: the script exits non-zero
and prints no result. It needs one card, builds everything it runs from the
sources beside it, and imports nothing of JAX.
"""

import argparse
import base64
import contextlib
import importlib
import importlib.metadata
import importlib.util
import io
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from diffusionremotesensing_tpu_torch import cli  # noqa: E402
from diffusionremotesensing_tpu_torch.aggregation import (  # noqa: E402
    AggregationSampler,
    patchify_coords,
)
from diffusionremotesensing_tpu_torch.convert import init_params  # noqa: E402
from diffusionremotesensing_tpu_torch.data.datasets import (  # noqa: E402
    DecodeOnlyDataset,
    pil_downblur_u8,
)
from diffusionremotesensing_tpu_torch.data.device_degradation import (  # noqa: E402
    make_downblur_transform,
)
from diffusionremotesensing_tpu_torch.data.loader import DataLoader  # noqa: E402
from diffusionremotesensing_tpu_torch.diffusion import (  # noqa: E402
    ddim_timesteps,
    ddpm_step,
    make_process,
)
from diffusionremotesensing_tpu_torch.io import load_snapshot, save_snapshot  # noqa: E402
from diffusionremotesensing_tpu_torch.models.blocks import bn_eval  # noqa: E402
from diffusionremotesensing_tpu_torch.models.census import CENSUS_MODELS, module_totals  # noqa: E402
from diffusionremotesensing_tpu_torch.models.unet import (  # noqa: E402
    residual_attention_unet_generation,
    residual_attention_unet_sar_to_ndvi,
    residual_attention_unet_superres,
)
from diffusionremotesensing_tpu_torch.ops import cuda_build, quant  # noqa: E402
from diffusionremotesensing_tpu_torch.ops.att_block import (  # noqa: E402
    att_head_block,
    att_head_block_plain,
)
from diffusionremotesensing_tpu_torch.ops.attention_gate import (  # noqa: E402
    attention_gate_plain,
    build_gate_weights,
    fused_attention_gate,
)
from diffusionremotesensing_tpu_torch.ops.dec_block import dec_block, dec_block_plain  # noqa: E402
from diffusionremotesensing_tpu_torch.ops.fused_update import (  # noqa: E402
    ancestral_update,
    ancestral_update_plain,
    draw_seed,
    philox_bits,
    philox_bits_plain,
    update_coefs,
)
from diffusionremotesensing_tpu_torch.ops.packed_conv import (  # noqa: E402
    packed_conv,
    packed_conv_plain,
)
from diffusionremotesensing_tpu_torch.ops.packed_head import (  # noqa: E402
    packed_head,
    packed_head_plain,
    wgmma_takes,
)
from diffusionremotesensing_tpu_torch.ops.s2d import (  # noqa: E402
    conv_nhwc,
    hwio_to_oihw,
    k1_to_blockdiag,
    k3_to_s2d,
    space_to_depth,
)
from diffusionremotesensing_tpu_torch.ops.tap_block import (  # noqa: E402
    tap_block,
    tap_block_plain,
    tap_stem_block,
    tap_stem_block_plain,
)
from diffusionremotesensing_tpu_torch.ops.resize import upsample_bicubic  # noqa: E402
from diffusionremotesensing_tpu_torch.parallel.halo import band_row_counts  # noqa: E402
from diffusionremotesensing_tpu_torch.parallel.sharding import (  # noqa: E402
    make_mesh,
    process_device,
    shard_batch,
    spatial_sharding,
)
from diffusionremotesensing_tpu_torch.ops.tap_conv import (  # noqa: E402
    tap_conv,
    tap_conv_pair,
    tap_conv_pair_plain,
    tap_conv_plain,
)
from diffusionremotesensing_tpu_torch.png import decode_png, encode_png  # noqa: E402
from diffusionremotesensing_tpu_torch.schedules import make_schedule  # noqa: E402
from diffusionremotesensing_tpu_torch.serving import InferenceServer  # noqa: E402
from diffusionremotesensing_tpu_torch.train import Trainer  # noqa: E402
from diffusionremotesensing_tpu_torch.utils import psnr, ssim  # noqa: E402

SEED = 0
T_STEPS = 1500
DDIM_STEPS = 100
HR = 128                      # HR patch edge of the main path (LR 64)
TASK_HR = 64                  # the SAR->NDVI and generation paths' image edge
NUM_CLASSES = 10              # the generation model's classes
CFG = 3.0                     # the generation task's guidance
TILE_LR = 256                 # LR tile edge
B_FLAG = 48                   # patches per chunk on the main path
N_CHUNKS = 2                  # a tile's 49 patches: one chunk of 48 and the remainder of 1
PEAK_BF16 = 989e12            # H100 SXM dense bf16 tensor FLOP/s
PEAK_F32 = 67e12              # H100 SXM float32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 bytes/s
FUSED = dict(fused_att=True, dec_block=True)
# the model configurations the phases build, by name
CONFIGS = {
    "plain": {},
    "plain_gates": dict(use_pallas=True),
    "dense": dict(s2d=True),
    "conv2": dict(s2d=True, tap44="conv2"),
    "tap": dict(s2d=True, tap44=True),
    "block": dict(s2d=True, tap44="block"),
    "stem_level": dict(s2d=True, tap44="stem"),
    "fused": dict(s2d=True, tap44="block", **FUSED),
    "stem": dict(s2d=True, tap44="stem", use_pallas=True, **FUSED),
    "packed": dict(s2d=True, tap44="block", packed_head=True),
    "l1": dict(s2d=True, tap44="l1"),
    "l1_fused": dict(s2d=True, tap44="l1", use_pallas=True, **FUSED),
}

# the factory of each of the repo's three models, by init_params' variant
FACTORIES = {
    "superres": lambda **f: residual_attention_unet_superres(magnification_factor=2, **f),
    "sar": residual_attention_unet_sar_to_ndvi,
    "generation": lambda **f: residual_attention_unet_generation(num_classes=NUM_CLASSES, **f),
}

# Every kernel of the paths: its wrapper, source, the TPU kernel it
# replaces, and the dtype its main path runs it in (the sampler's state,
# which ancestral_update updates, is float32).
KERNELS = {
    "tap_block": (tap_block, "tap_block.cu", "diffusionremotesensing_tpu/ops/tap_block.py:427",
                  torch.bfloat16),
    "att_head_block": (att_head_block, "att_head_block.cu",
                       "diffusionremotesensing_tpu/ops/att_block.py:155", torch.bfloat16),
    "dec_block": (dec_block, "dec_block.cu", "diffusionremotesensing_tpu/ops/dec_block.py:178",
                  torch.bfloat16),
    "ancestral_update": (ancestral_update, "ancestral_update.cu",
                         "diffusionremotesensing_tpu/ops/fused_update.py:115", torch.float32),
    "tap_stem_block": (tap_stem_block, "tap_stem_block.cu",
                       "diffusionremotesensing_tpu/ops/tap_block.py:367", torch.bfloat16),
    "tap_conv": (tap_conv, "tap_conv.cu", "diffusionremotesensing_tpu/ops/tap_conv.py:126",
                 torch.bfloat16),
    "tap_conv_pair": (tap_conv_pair, "tap_conv.cu",
                      "diffusionremotesensing_tpu/ops/tap_conv.py:156", torch.bfloat16),
    "fused_attention_gate": (fused_attention_gate, "attention_gate.cu",
                             "diffusionremotesensing_tpu/ops/pallas_kernels.py:94", torch.bfloat16),
    "packed_head": (packed_head, "packed_head.cu",
                    "diffusionremotesensing_tpu/ops/packed_head.py:133", torch.bfloat16),
    "packed_conv": (packed_conv, "packed_conv.cu",
                    "diffusionremotesensing_tpu/ops/packed_conv.py:90", torch.bfloat16),
}

# Rows of the kernels line for the shapes the other two models give a
# kernel: the SAR->NDVI model's stem at CX4 = 4 (1 NDVI channel) and heads
# at out4 = 4, the class-conditional model's stem without a condition
# tensor. Each row: its kernel and the variant whose paths launch it at that
# shape; every other launch counts in the kernel's own row.
SHAPE_ROWS = {
    "tap_stem_block_cx4_4": ("tap_stem_block", "sar"),
    "tap_stem_block_bias_only": ("tap_stem_block", "generation"),
    "att_head_block_out4_4": ("att_head_block", "sar"),
    "dec_block_out4_4": ("dec_block", "sar"),
    "packed_head_out4_4": ("packed_head", "sar"),
}


def row_of(kernel, variant):
    """The kernels line's row that a launch of `kernel` on a path of
    `variant` counts in."""
    return next((r for r, kv in SHAPE_ROWS.items() if kv == (kernel, variant)), kernel)


# Tolerances, max |kernel - plain| <= tol * max(1, max |plain|):
# bfloat16: both versions round their intermediates and outputs to bf16
# after float32 sums taken in different orders, so a value at a rounding
# boundary may land one ulp (2**-8 relative) apart, and such a flip moves
# what follows by less; 1e-2 is 2.5 ulps at the top of the range.
# float32: float32 sums of up to 1728 products in different orders.
KERNEL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# calls of each bfloat16 kernel at B=48 held bitwise equal to its first: a
# race that changes a rare call (a ring slot released before its reads were
# done) shows here, where one comparison with the plain version may miss it
REPEAT_CALLS = 1000
# ancestral_update, float32: one product and two sums an element, and a
# normal from the card's log/sqrt/sincospi against torch's log/cos/sin of
# 2 pi u2, a few ulps of |z| < 5.7 apart: 1e-5
UPDATE_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
# whole UNet, kernel paths against the dense-s2d path: float32 as above
# (TF32 off); bfloat16 rounds every layer's output, ~25 layers deep, and
# read 1.5e-3 at this shape on an H100, so 1e-2 leaves ~7x headroom.
MODEL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# a DDIM-100 tile, fused against unfused, float32: 100 forwards whose
# float32 differences (~1e-7 each) pass through the clamped x0 predictions
TILE_TOL = 1e-3
# the noise of one flagship state (2,359,296 draws): the standard errors of
# its mean and standard deviation are 6.5e-4 and 4.6e-4
Z_MOMENT_TOL = 5e-3
# |correlation| of its cos and sin partners, of neighbouring quads and of two
# steps, over 589,824 pairs or more: standard error 1.3e-3
Z_CORR_TOL = 0.02
GOLDEN_TOL = 1e-4
# the train phase: the flagship recipe (README.md's quick start,
# train_diffusion_superres.py's defaults): x2 super-resolution, HR 256,
# batch 32, the on-device DownBlur at blur radius 0.5, cosine T=1500, MSE,
# EMA, lr 3e-4, bfloat16 compute on float32 parameters; 3 warm-up and 20
# timed steps, dense and s2d_train
TRAIN_HR, TRAIN_B, TRAIN_BLUR, TRAIN_LR = 256, 32, 0.5, 3e-4
TRAIN_WARMUP, TRAIN_STEPS = 3, 20
# one float32 step on the card and on its host's CPU (HR 32, batch 4), held
# at the CPU tests' tolerances against the JAX reference
# (tests/test_torch_port_train.py): loss rtol 1e-5; every gradient within
# 1e-5 of the largest; the parameters after Adam within 1e-6 where the
# gradient exceeds 1e-5 of the largest, and everywhere within 2 lr (Adam's
# first step moves a parameter whose gradient is float32 noise by up to lr
# either way: the biases of convolutions that feed a train-mode BatchNorm,
# zero in exact arithmetic); the running statistics within 1e-6
STEP_HR, STEP_B = 32, 4
STEP_LOSS_RTOL, STEP_GRAD_TOL, STEP_PARAM_TOL, STEP_STATS_TOL = 1e-5, 1e-5, 1e-6, 1e-6
# learning: one fixed batch (HR 64, batch 16, float32, lr 3e-4) for 60
# steps; the mean loss of the last 10 must fall below half the first 10's
# (on a CPU, four seeds: 0.17-0.19 of it)
LEARN_HR, LEARN_B, LEARN_STEPS, LEARN_RATIO = 64, 16, 60, 0.5
# the quality phase: the repo's trained x2 snapshot served in the 'stem'
# configuration, bfloat16, on the eval tiles of benchmarks/learning_check.py
# (4 HR tiles of 256 px from default_rng(10_000), patch 64, stride 32: 9
# patches a tile), their LR learning_check's (Pillow's bicubic and blur at
# 0.5, computed without PIL, bit-equal: the card has no PIL), scored
# by the port's psnr/ssim against the reference's scores of the same
# snapshot (evals/*.json): each pass within 1 dB and 0.01 SSIM of them and
# above bicubic on every tile; the fused update's T=1500 pass within 0.5 dB
# and 0.005 SSIM of the unfused one's
ARTIFACTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmarks",
                         "gate_artifacts")
QUALITY_SNAPSHOT = os.path.join(ARTIFACTS, "snapshot_x2.pt")
EVAL_SEED, EVAL_TILES, EVAL_TILE_HR, EVAL_BLUR = 10_000, 4, 256, 0.5
# draws a tile: the mean of one draw of the four tiles spreads ~0.5 dB (9
# before the parallel phase came; 6 keeps the script's time: at 8 the
# quality phase took 260 s of a 551 s script on a slow host)
QUALITY_DRAWS = 6
QUALITY_PSNR_TOL, QUALITY_SSIM_TOL = 1.0, 0.01
FUSED_PSNR_TOL, FUSED_SSIM_TOL = 0.5, 0.005
# the train phase's data step: its first TRAIN_B images as PNG files
DATA_IMAGES = 32
# the cli phase: the port's command line in-process (cli.main), from the x2
# snapshot, on the quality phase's eval tiles written as PNG. Its aggregation
# runs float32 (the reference's Aggregation_Sampling has no dtype flag) with
# these kernel flags, serve bfloat16 (serve's default)
CLI_FLAGS = ["--magnification_factor", "2", "--tap44", "stem", "--fused_att", "--dec_block"]
CLI_MODEL = dict(s2d=True, tap44="stem", fused_att=True, dec_block=True)
CLI_START_T = 250  # the fused-update tile's warm start: 250 ancestral steps
# the int8 quality gap: INT8_DRAWS draws a tile through sample_tiles, each
# tile on its own calibration, int8 and unquantized on the same draws; the
# gap (int8 mean minus unquantized) may not fall more than the tolerances
# below the reference package's own gap on these tiles (CPU, float32, dense
# s2d, which quantizes ResConvBlock-0's convs too, one x_T a tile:
# tests/test_torch_port_quality_superres.py, slow)
INT8_DRAWS = 4
INT8_REF_GAP = {"psnr_db": -0.9816937237514338, "ssim": -0.055083131881240255}
INT8_GAP_PSNR_TOL, INT8_GAP_SSIM_TOL = 0.5, 0.005
# the sites whose int32 accumulators are held bitwise against the exact
# product at B=48: an s2d site and a ConvTranspose site
INT8_SITES = ("s2d.down0", "ups.1.transform")
CALIB_PROBES = 6  # quant.sampling_probes' default timesteps at T=1500
CENSUS_TOTALS = (4_383_058, 4_382_238, 4_383_022)
MEDIA_PACKAGES = ("matplotlib", "cv2", "imageio")
# the checkpoint phase's Orbax step: the packages the Orbax backend could
# use, by their distributions' names (tensorstore is the one it needs; the
# probe imports none of them), and the flagship recipe's steps before the
# saves
CHECKPOINT_PACKAGES = {"tensorstore": "tensorstore", "zstandard": "zstandard",
                       "orbax": "orbax-checkpoint"}
ORBAX_STEPS = 3
# the helpers phase: super_resolver on the x2 snapshot under a model name
# of LR 128 (one eval tile's LR), SAR_to_NDVI_generator on the SAR snapshot
# at its name's 128 px, imgs_generator's sampling step, each at DDIM-100 in
# float32 and held to the direct sampler of the same model and generator
# (the same calls: bitwise expected; 1e-6 of max |out| allowed)
SAR_SNAPSHOT = os.path.join(ARTIFACTS, "snapshot_sar.pt")
GEN_SNAPSHOT = os.path.join(ARTIFACTS, "snapshot_gen.pt")
HELPER_SR_NAME = "Residual_Attention_UNet_superres_magnification2_LRimgsize128_x2_snapshot"
HELPER_DDIM_STEPS, HELPER_TOL = 100, 1e-6
# the task_quality phase: the SAR->NDVI and generation snapshots in bf16,
# 'stem', DDIM-100 with x0 clamping, held to the CPU gates
# (tests/test_torch_port_tasks_quality.py): SAR on 8 eval pairs within 1 dB
# of the reference's PSNR (evals/sar_ddim100_clip.json) and above the
# linear baseline; generation 32 images a class, CFG-3 accuracy >= 0.9 and
# the CFG-1 diversity ratio >= 0.5 (learning_check.evaluate_gen's `passes`)
SAR_EVAL_PAIRS, SAR_PSNR_TOL = 8, 1.0
GEN_PER_CLASS, GEN_ACCURACY, GEN_DIVERSITY = 32, 0.9, 0.5
PROFILE_N = 4  # forwards per profile reading, each issued alone behind a sleep kernel
SLEEP_CYCLES = 200_000_000  # the sleep window, ~0.1 s: many times a forward's issue time
L2_BYTES = 50 * 2**20  # the H100's L2 cache
# the golden phase's configurations (each computes the same function) and
# the model phase's, each held against the dense-s2d path
GOLDEN_CONFIGS = ("plain", "plain_gates", "dense", "conv2", "tap", "block", "stem_level", "fused",
                  "stem", "packed", "l1", "l1_fused")
MODEL_CONFIGS = ("block", "conv2", "tap", "fused", "stem", "packed", "l1", "l1_fused")
# the same for the SAR->NDVI and class-conditional models
GOLDEN_TASK_CONFIGS = ("plain", "dense", "stem", "fused", "packed")
MODEL_TASK_CONFIGS = ("block", "stem", "fused", "packed")

# Values the JAX reference package computes for init_params(SEED) and
# golden_input() (tests/test_torch_port_imports.py recomputes them):
# the float32 output flattened and read at every 97th element, and the sum
# of |output|.
GOLDEN = {
    "stride": 97,
    "values": [
        0.05096697434782982, 0.14409835636615753, 0.014462698251008987, 0.04780956357717514,
        0.13677376508712769, -0.0037570204585790634, 0.10057226568460464, 0.1761390119791031,
        -0.015248360112309456, 0.11522963643074036, 0.12124008685350418, 0.009030509740114212,
        0.10207726061344147, 0.15788507461547852, 0.03325726091861725, 0.0809665396809578,
        0.13191251456737518, 0.020354028791189194, 0.07536162436008453, 0.1566077470779419,
        -0.021193502470850945, 0.05217009782791138, 0.1133221834897995, 0.014033039100468159,
        0.1344250738620758, 0.1590011715888977, -0.0014126794412732124, 0.09311191737651825,
        0.14676780998706818, -0.001918606460094452, 0.11543634533882141, 0.19701945781707764,
    ],
    "abs_sum": 258.037885354599,
}


def golden_input():
    rng = np.random.default_rng(1234)
    x = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    t = np.array([737], np.float32)
    cond = rng.random((1, 16, 16, 3)).astype(np.float32)
    return x, t, cond


# The same for the other two models, init_params(SEED, 'sar') and
# init_params(SEED, 'generation') (10 classes), at golden_input_sar() and
# golden_input_gen() (labels 3 and 7, the first conditioned and the second
# not: a CFG mask of one then zero); tests/test_torch_port_tasks_golden.py
# recomputes them.
GOLDEN_SAR = {
    "stride": 32,
    "values": [
        -0.08082113415002823, -0.09024404734373093, -0.08351443707942963, -0.1022171601653099,
        -0.07773865759372711, -0.0860668271780014, -0.09367258846759796, -0.10591389983892441,
        -0.07952424883842468, -0.101496621966362, -0.10113723576068878, -0.08970658481121063,
        -0.07623894512653351, -0.08920907229185104, -0.07238925993442535, -0.09362895786762238,
        -0.0801212415099144, -0.11779342591762543, -0.1027318462729454, -0.10561255365610123,
        -0.07619034498929977, -0.0868787169456482, -0.10034725069999695, -0.10343057662248611,
        -0.07942439615726471, -0.11764967441558838, -0.09930508583784103, -0.10606514662504196,
        -0.09175124019384384, -0.091483473777771, -0.0915476456284523, -0.12473545968532562,
    ],
    "abs_sum": 115.0649543441832,
}

GOLDEN_GEN = {
    "stride": 193,
    "values": [
        -0.03152883052825928, -0.06115374714136124, 0.07139529287815094, -0.013647245243191719,
        -0.034696634858846664, 0.050166644155979156, 0.004855532199144363, -0.03276154771447182,
        0.08893303573131561, -0.0015250183641910553, -0.032744601368904114, 0.03932797163724899,
        -0.005334245041012764, -0.04391435533761978, 0.0467202253639698, 0.027721039950847626,
        -0.07958410680294037, 0.06992971152067184, -0.007391652092337608, -0.054666146636009216,
        0.05420319363474846, -0.0036522112786769867, -0.055597297847270966, 0.03962154686450958,
        -0.00587923638522625, -0.037116117775440216, 0.0460541695356369, 0.009369708597660065,
        -0.04824984818696976, 0.07289192080497742, -0.00039009563624858856, -0.07701659202575684,
    ],
    "abs_sum": 243.21942048612982,
}


def golden_input_sar():
    """A 32x32 NDVI state, t and its 2-channel SAR condition; no mask."""
    rng = np.random.default_rng(4321)
    x = rng.standard_normal((1, 32, 32, 1)).astype(np.float32)
    t = np.array([737], np.float32)
    cond = rng.random((1, 32, 32, 2)).astype(np.float32)
    return x, t, cond, None


def golden_input_gen():
    """Two 32x32 RGB states, t, labels 3 and 7 and the CFG mask [1, 0]."""
    rng = np.random.default_rng(5678)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    t = np.array([737, 737], np.float32)
    return x, t, np.array([3, 7], np.int64), np.array([1.0, 0.0], np.float32)


def check(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def phase(name, fn):
    t0 = time.perf_counter()
    try:
        summary = fn()
    except BaseException as e:
        print(f"[{name}] {time.perf_counter() - t0:.1f}s FAILED: {type(e).__name__}: {e}",
              flush=True)
        raise
    print(f"[{name}] {time.perf_counter() - t0:.1f}s ok {summary}", flush=True)


def time_ms(fn, reps=20, warmup=3):
    """Mean device time of fn() in ms over `reps` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def launch_ms(fn, reps=20):
    """Device ms per call of each kernel that fn() launches, by its short
    name (`tap_tc_kernel<0, 0>`), from torch.profiler (empty if it sees no
    device time)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if getattr(ev, "self_device_time_total", 0) > 0:
            m = re.search(r"(\w+)(<[^()]*>)?\(", ev.key)
            out[m.group(1) + (m.group(2) or "") if m else ev.key[:60]] = \
                ev.self_device_time_total / 1e3 / reps
    return out



def sleep_held(fn, calls=1, cycles=SLEEP_CYCLES):
    """One reading of `calls` calls of fn() queued behind a sleep kernel,
    which holds the device while the host issues them; they then run back
    to back. Returns the device ms they take (events before and after
    them), the host ms it took to issue them, and the sleep's cycles: a
    window that ended before the calls were all issued is read again,
    twice as long."""
    while True:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        issue_ms = (time.perf_counter() - t0) * 1e3
        if not start.query():
            torch.cuda.synchronize()
            return start.elapsed_time(end), issue_ms, cycles
        check(cycles < 16 * SLEEP_CYCLES, f"sleep_held: the issue outlasted {cycles} cycles")
        cycles *= 2


def cold(fn, *inputs):
    """A call of fn on copies of `inputs` that finds them, and the output it
    writes, out of the L2, as the sampler's update finds its state after a
    forward: it cycles through enough copies (at least 3) that twice the L2
    passes between two uses of one, and each copy keeps its last output
    until its next turn, so the outputs cycle too."""
    per = sum(t.numel() * t.element_size() for t in inputs[:1] + inputs)  # an output like the first
    sets = [[tuple(t.clone() for t in inputs), None]
            for _ in range(max(3, -(-2 * L2_BYTES // per)))]
    turn = itertools.cycle(sets)

    def call():
        s = next(turn)
        s[1] = fn(*s[0])
    return call


def device_readings(fn, reps=20):
    """fn()'s device ms per call read two ways, with the host's issue taken
    out: torch.profiler's, summed over the kernels it launches
    (`device_ms`), and by events around `reps` calls queued behind a sleep
    kernel (`held_ms`); and the host's microseconds to issue one call
    (`host_us`). For a call that issues slower than the card runs it, where
    time_ms reads the host's issue rate."""
    fn()
    held, issue_ms, _ = sleep_held(fn, reps)
    return {"device_ms": sum(launch_ms(fn, reps).values()), "held_ms": held / reps,
            "host_us": 1e3 * issue_ms / reps}

def model_with(name, device, dtype=torch.float32, variant="superres"):
    """The full-width model `variant` ('superres', 'sar', 'generation') of
    configuration `name` (CONFIGS) with the init_params(SEED, variant)
    weights."""
    m = FACTORIES[variant](**CONFIGS[name])
    m.load_state_dict(init_params(SEED, variant, device="cpu"))
    return m.to(device=device, dtype=dtype, memory_format=torch.channels_last).eval()


def per_forward(name):
    """The launches of each kernel in one UNet forward of configuration
    `name`: the level's ResConvBlock-0 kernels ('l1' also ResConvBlock-1's),
    the fused decoder tail's, packed_head on the unfused tail, and with
    use_pallas every gate the forward runs through the fused gate (gates 0
    and 1 on the s2d path, gate 0 alone under 'l1', all three on the plain
    one)."""
    f = CONFIGS[name]
    level = f.get("tap44", False)
    fused_att, dec = f.get("fused_att", False), f.get("dec_block", False)
    gates = (2 - (level == "l1") if f.get("s2d") else 3) if f.get("use_pallas") else 0
    return {"tap_block": int(level == "block") + 2 * (level == "l1"),
            "att_head_block": int(fused_att), "dec_block": int(dec), "ancestral_update": 0,
            "tap_stem_block": int(level == "stem"),
            "tap_conv": int(level is True or level == "conv2"), "tap_conv_pair": int(level is True),
            "fused_attention_gate": gates,
            "packed_head": int(f.get("packed_head", False) and not (fused_att or dec)),
            "packed_conv": 0}


def zero_counts():
    for wrapper, *_ in KERNELS.values():
        wrapper.launches = 0


def read_counts():
    return {name: k[0].launches for name, k in KERNELS.items()}


# ----------------------------------------------------------- the yardsticks:
# the port's unfused ops for the function each kernel computes (never called
# by the fused path)

def block_dense_s2d(h_s, te4, k):
    """ResConvBlock-0 as cuDNN convolutions on the dense s2d kernels (the
    port's tap44=False path, written out here)."""
    h = torch.relu(conv_nhwc(h_s, k["blk_conv1"], k["blk_b1"], padding=1) * k["bn0_a"] + k["bn0_c"])
    h = h + conv_nhwc(h_s, k["blk_skip"], k["blk_bsk"], padding=1) + te4[:, None, None, :]
    h = conv_nhwc(h, k["blk_conv2"], k["blk_b2"], padding=1) * k["bn1_a"] + k["bn1_c"]
    s = conv_nhwc(h_s, k["blk_short"], k["blk_bsh"]) * k["bn2_a"] + k["bn2_c"]
    return torch.relu(s + h)


@torch.no_grad()
def block1_dense_kernels(m, dt):
    """ResConvBlock-1's dense s2d kernels (level 1 in s2d: 4Ci=128, 4Co=256,
    no skip conv) and folded BatchNorms, for block1_dense_s2d."""
    blk = m.conv_blocks[1]

    def conv(c, to_s2d):
        w = to_s2d(c.weight.float().permute(2, 3, 1, 0))
        return hwio_to_oihw(w).to(dt).contiguous(memory_format=torch.channels_last)

    def affine(bn):
        a = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
        return a.repeat(4).to(dt), (bn.bias.float() - bn.running_mean.float() * a).repeat(4).to(dt)

    k = {"c1": conv(blk.conv1[0], k3_to_s2d), "b1": blk.conv1[0].bias.repeat(4).to(dt),
         "c2": conv(blk.conv2[0], k3_to_s2d), "b2": blk.conv2[0].bias.repeat(4).to(dt),
         "sh": conv(blk.shortcut_conv[0], k1_to_blockdiag),
         "bsh": blk.shortcut_conv[0].bias.repeat(4).to(dt)}
    for name, bn in (("bn0", blk.batch_norm1), ("bn1", blk.batch_norm2),
                     ("bn2", blk.shortcut_batch_norm)):
        k[f"{name}_a"], k[f"{name}_c"] = affine(bn)
    return k


def block1_dense_s2d(x, te4, k):
    """ResConvBlock-1 in s2d as cuDNN convolutions on the dense s2d kernels
    (block_dense_s2d without the skip conv)."""
    h = torch.relu(conv_nhwc(x, k["c1"], k["b1"], padding=1) * k["bn0_a"] + k["bn0_c"])
    h = conv_nhwc(h + te4[:, None, None, :], k["c2"], k["b2"], padding=1) * k["bn1_a"] + k["bn1_c"]
    s = conv_nhwc(x, k["sh"], k["bsh"]) * k["bn2_a"] + k["bn2_c"]
    return torch.relu(s + h)


def head_unfused(hh, attn_s, k):
    """head_up4 on hh plus head_at on attn_s as two cuDNN convolutions, as
    the packed_head=False tail runs them."""
    return (conv_nhwc(hh, k["head_up4"], padding=((1, 2), (1, 2)))
            + conv_nhwc(attn_s, k["head_at"], padding=1))


def stem_dense_s2d(xs, cond, te4, k):
    """conv0 + bias (+ cond, unless None) and ResConvBlock-0 as cuDNN
    convolutions on the dense s2d kernels (the tap44=False path, written
    out here)."""
    h_s = conv_nhwc(xs, k["conv0"], k["conv0_b"], padding=1)
    return block_dense_s2d(h_s if cond is None else h_s + cond, te4, k)


def gates_unfused(m, pairs):
    """Attention gates 0 and 1 (x, g NHWC) as the port's layer-by-layer
    AttentionGate modules run them (use_pallas=False)."""
    return tuple(m.attention_blocks[i](x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2))
                 for i, (x, g) in enumerate(pairs))


def att_unfused(m, x, h, k):
    """Gating signal 2, attention gate 2 and head_at as the fused_att=False
    path runs them."""
    g = m.gating_signals[2](h.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return conv_nhwc(m._attention_s2d(x, g, k), k["head_at"], padding=1)


def dec_unfused(m, xa, xb, te, k):
    """The concat conv, the UpConvBlock-2 body and head_up4 as the
    dec_block=False path runs them."""
    h = m.up_convs[1](torch.cat([xa, xb], dim=-1).permute(0, 3, 1, 2))
    up = m.ups[2]
    hh = torch.relu(bn_eval(up.conv(h + te[:, :, None, None]), up.batch_norm)).permute(0, 2, 3, 1)
    return (h.permute(0, 2, 3, 1), hh[:, :1], hh[:, :, :1],
            conv_nhwc(hh, k["head_up4"], padding=((1, 2), (1, 2))))


def update_unfused(schedule, x, eps, i, gen):
    """The unfused step: noise drawn in the original layout, moved to s2d,
    then ddpm_step."""
    b, h2, w2, c4 = x.shape
    z = torch.randn((b, 2 * h2, 2 * w2, c4 // 4), generator=gen, device=x.device, dtype=x.dtype)
    return ddpm_step(schedule, x, eps, i, space_to_depth(z))


# ------------------------------------------------------------------ bounds

def block_flops(B, H2, W2, C4, CO4, skip=True):
    """(dense, issued) FLOPs of one tap_block call. Dense is the block's own
    work at full resolution (2*H2 x 2*W2 pixels, Ci = C4/4 in, Co = CO4/4
    out): conv1 and (with `skip`, level 0) the skip conv 3x3 Ci->Co, conv2
    3x3 Co->Co, shortcut 1x1 Ci->Co. Issued is the size of the products the
    bfloat16 kernel runs: the tap im2col of x against conv1's (and skip's)
    columns of W1, the tap im2col of h against W2, and the centre rows of
    the shortcut (4 of its 16 row blocks), structural zeros of the tap form
    included."""
    ci, co, n1 = C4 // 4, CO4 // 4, 3 if skip else 2
    dense = 2 * B * (2 * H2) * (2 * W2) * ((n1 - 1) * 9 * ci * co + 9 * co * co + ci * co)
    issued = 2 * B * H2 * W2 * (4 * C4 * (n1 - 1) * CO4 + 4 * CO4 * CO4 + C4 * CO4)
    return dense, issued


def _bound(flops, nbytes, peak):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def block_bound(B, H2, W2, C4, CO4, itemsize, peak, skip=True):
    """Least time (ms) for one tap_block call: bytes each read or written
    once, the block's dense operations at the card's peak for the input type."""
    flops, _ = block_flops(B, H2, W2, C4, CO4, skip)
    nbytes = itemsize * (B * H2 * W2 * C4 + B * CO4 + 4 * C4 * (3 if skip else 2) * CO4
                         + 4 * CO4 * CO4 + 4 * CO4 + B * H2 * W2 * CO4)
    return _bound(flops, nbytes, peak)


def att_flops(B, H, W, c4=128, c=32, ch=64, out4=12):
    """Dense FLOPs of one att_head_block call over B x H x W s2d pixels,
    counted from the model's layers at their own resolution, as block_flops
    counts: the gating conv ch->c, w_g c->c and psi c->1 at H x W; w_x, the
    2x2 stride-2 conv C->c (C = c4/4) reading the 2H x 2W skip; the result
    conv C->C and the composed head_at, a 3x3 conv C->out4/4, at 2H x 2W.
    The s2d forms the kernel runs (the block-diagonal rc, the 3x3 head_at
    over all 4 sub-pixels) carry structural zeros, not counted."""
    cf, o = c4 // 4, out4 // 4
    macs = ch * c + c * c + c + 4 * cf * c + 4 * cf * cf + 4 * 9 * cf * o
    return 2 * B * H * W * macs


def att_issued_flops(B, H, W):
    """FLOPs the bfloat16 att_head_block issues over B x H x W s2d pixels:
    its gate kernel's h @ gw, g @ wg, x @ wx and rc's four diagonal 32 x 32
    blocks, and the head's 9 x 128 x 16 (16 columns for 12)."""
    return 2 * B * H * W * (64 * 32 + 32 * 32 + 128 * 32 + 4 * 32 * 32 + 9 * 128 * 16)


def att_bound(B, H, W, itemsize, peak, c4=128, c=32, ch=64, out4=12):
    """Least time (ms) for one att_head_block call: x and h read and the head
    contribution written once, the weights as the kernel takes them once;
    att_flops at the card's peak for the input type."""
    weights = ch * c + c * c + c4 * c + c + c4 * c4 + 9 * c4 * out4 + 3 * c + 1 + c4
    return _bound(att_flops(B, H, W, c4, c, ch, out4),
                  itemsize * (B * H * W * (c4 + ch + out4) + weights), peak)


def dec_flops(B, H, W, ca=128, cb=64, cm=64, out4=12):
    """Dense FLOPs of one dec_block call over B x H x W pixels: the 3x3
    concat conv (ca+cb)->cm and the 3x3 conv cm->cm at H x W, and the
    composed head_up4 (UpConvBlock-2's 3x3 stride-2 ConvTranspose, then the
    head's 3x3 conv to out4/4 channels). Through it a full-resolution pixel
    of even row reaches 3 rows of hh and one of odd row 2, so the four
    sub-pixels reach 9 + 6 + 6 + 4 = 25 of the 4x4 s2d kernel's 64 taps of
    each channel pair; the other taps are structural zeros, not counted."""
    macs = 9 * (ca + cb) * cm + 9 * cm * cm + 25 * cm * (out4 // 4)
    return 2 * B * H * W * macs


def dec_bound(B, H, W, itemsize, peak, ca=128, cb=64, cm=64, out4=12):
    """Least time (ms) for one dec_block call: xa, xb, te read and h, the two
    hh strips and the head contribution written once, the weights as the
    kernel takes them once; dec_flops at the card's peak for the input type."""
    acts = B * H * W * (ca + cb + cm + out4) + B * cm + B * (H + W) * cm
    weights = 9 * (ca + cb) * cm + 9 * cm * cm + 16 * cm * out4 + 2 * cm
    return _bound(dec_flops(B, H, W, ca, cb, cm, out4), itemsize * (acts + weights), peak)


def head_flops(B, H, W, c1=64, c2=128, out4=12):
    """Dense FLOPs of one packed_head call over B x H x W s2d pixels:
    head_up4 as dec_flops counts it (25 nonzero taps of each channel pair),
    head_at as att_flops counts it (the composed 3x3 conv C->out4/4 at each
    of the 4 full-resolution pixels of an s2d pixel, C = c2/4); the s2d
    forms' structural zeros are not counted."""
    o = out4 // 4
    return 2 * B * H * W * (25 * c1 * o + 4 * 9 * (c2 // 4) * o)


def head_bound(B, H, W, itemsize, peak, c1=64, c2=128, out4=12):
    """Least time (ms) for one packed_head call: hh and attn_s read and out
    written once, the two HWIO kernels read once; head_flops at the card's
    peak for the input type."""
    nbytes = itemsize * (B * H * W * (c1 + c2 + out4) + 16 * c1 * out4 + 9 * c2 * out4)
    return _bound(head_flops(B, H, W, c1, c2, out4), nbytes, peak)


def pconv_flops(B, H, W, ci, co):
    """FLOPs of one packed_conv call: a 3x3 conv ci->co over B x H x W."""
    return 2 * B * H * W * 9 * ci * co


def pconv_bound(B, H, W, ci, co, itemsize, peak):
    """Least time (ms) for one packed_conv call with bias: x read, out written,
    the kernel and bias read once; pconv_flops at the card's peak."""
    nbytes = itemsize * (B * H * W * (ci + co) + 9 * ci * co + co)
    return _bound(pconv_flops(B, H, W, ci, co), nbytes, peak)


def conv_flops(B, H2, W2, C4, CO4):
    """Dense FLOPs of one tap_conv call: the model's 3x3 conv C4/4 -> CO4/4
    at full resolution (2*H2 x 2*W2), as block_flops counts; the 4x4 tap
    form's structural zeros are not counted."""
    return 2 * B * (2 * H2) * (2 * W2) * 9 * (C4 // 4) * (CO4 // 4)


def conv_bound(B, H2, W2, C4, CO4, itemsize, peak, n=1):
    """Least time (ms) for tap_conv (n=1) or tap_conv_pair (n=2): x read, the
    n outputs written and the n tap weight matrices read once; n dense convs
    at the card's peak for the input type."""
    nbytes = itemsize * (B * H2 * W2 * (C4 + n * CO4) + n * 4 * C4 * CO4)
    return _bound(n * conv_flops(B, H2, W2, C4, CO4), nbytes, peak)


def stem_flops(B, H2, W2, CX4=12, C14=64, CO4=128):
    """Dense FLOPs of one tap_stem_block call: conv0, the 3x3 conv
    CX4/4 -> C14/4 at full resolution, plus the block's (block_flops)."""
    conv0 = 2 * B * (2 * H2) * (2 * W2) * 9 * (CX4 // 4) * (C14 // 4)
    return conv0 + block_flops(B, H2, W2, C14, CO4)[0]


def stem_bound(B, H2, W2, itemsize, peak, CX4=12, C14=64, CO4=128, cond=True):
    """Least time (ms) for one tap_stem_block call: x, cond (unless
    cond=False, the bias-only stem) and te4 read and res0_s written once,
    the weights as the kernel takes them once; stem_flops at the card's
    peak for the input type."""
    weights = 4 * CX4 * C14 + C14 + 4 * C14 * 3 * CO4 + 4 * CO4 * CO4 + 4 * CO4
    nbytes = itemsize * (B * H2 * W2 * (CX4 + C14 * cond + CO4) + B * CO4 + weights)
    return _bound(stem_flops(B, H2, W2, CX4, C14, CO4), nbytes, peak)


def gate_flops(B, Hg, Wg, C):
    """FLOPs of one fused_attention_gate call over B x Hg x Wg gating
    pixels, the gate's layers at their own resolution: w_g C->C and psi
    C->1 at the gating grid, w_x (2x2 stride 2, 4C->C a gating pixel) and
    the result conv C->C at each of the 4 pixels of x above it."""
    return 2 * B * Hg * Wg * (C * C + C + 4 * C * C + 4 * C * C)


def gate_issued_flops(B, Hg, Wg, C):
    """FLOPs the bfloat16 gate kernel issues over B x Hg x Wg gating pixels:
    g @ Wg, the four taps' x_t @ Wx_t and x_t @ Wr, each for the hi and the
    lo part of the float32 weights."""
    return 2 * 2 * B * Hg * Wg * (C * C + 4 * C * C + 4 * C * C)


def gate_bound(B, gates, itemsize, peak):
    """Least time (ms) for the fused_attention_gate calls of `gates`, a list
    of (Hg, Wg, C): x and g read and out written once in the input type, the
    float32 weights read once; gate_flops at the card's peak for the input
    type (the kernel computes in float32: at 67 TFLOP/s the same products
    take longer than the bound)."""
    flops = sum(gate_flops(B, hg, wg, c) for hg, wg, c in gates)
    nbytes = sum(itemsize * B * hg * wg * 9 * c + 4 * (6 * c * c + 8 * c + 1) for hg, wg, c in gates)
    return _bound(flops, nbytes, peak)


def update_bound(n, itemsize):
    """Least time (ms) for one ancestral_update call over n elements: x and
    eps read and x' written once; its 5 float operations an element (the
    generator's integer work and the transcendentals not counted) at the
    float32 peak."""
    return _bound(5 * n, 3 * n * itemsize + 16, PEAK_F32)


def profile_forward(proc, batch, dev):
    """Device, host and wall ms of one UNet forward at `batch`, and the top
    kernels by device time with every hand-written one (empty if
    torch.profiler sees no device time)."""
    g = torch.Generator(device=dev).manual_seed(batch)
    x = torch.randn((batch, HR // 2, HR // 2, 12), generator=g, device=dev)  # s2d state
    t = torch.full((batch,), 750.0, device=dev)
    feats = proc.encode_cond_fn(torch.rand((batch, HR // 2, HR // 2, 3), generator=g, device=dev))

    def fn():
        proc.apply_fn(x, t, None, feats, proc.kernels)

    wall_ms = time_ms(fn, reps=PROFILE_N)  # host and device overlapping, as in the sampler
    # device time alone: one forward a window (four tap forwards filled the
    # launch queue, and the host then waited out the sleep)
    device, host = [], []
    cycles = SLEEP_CYCLES
    for _ in range(PROFILE_N):
        d, h, cycles = sleep_held(fn, cycles=cycles)
        device.append(d)
        host.append(h)
    host_ms, device_ms = sum(host) / PROFILE_N, sum(device) / PROFILE_N
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(PROFILE_N):
            fn()
        torch.cuda.synchronize()
    kernels = sorted(({"name": ev.key[:80], "ms_per_forward": ev.self_device_time_total / 1e3 / PROFILE_N,
                       "calls": ev.count // PROFILE_N}
                      for ev in prof.key_averages() if getattr(ev, "self_device_time_total", 0) > 0),
                     key=lambda r: -r["ms_per_forward"])
    # the top 12, and every hand-written kernel (csrc/*.cu: anonymous
    # namespaces; a template's name starts with its return type) below them
    hand = ("void (anonymous namespace)::", "(anonymous namespace)::")
    shown = kernels[:12] + [k for k in kernels[12:] if k["name"].startswith(hand)]
    return {"batch": batch, "device_ms": device_ms, "host_ms": host_ms, "wall_ms": wall_ms,
            "sleep_cycles": cycles, "kernels": shown}


def kernel_name(mangled):
    """`dec_tc_kernel<1>` from an Itanium-mangled kernel name: the first
    length-prefixed identifier that names a kernel (the anonymous namespace
    before it is one too, `_GLOBAL__N_1` or `_INTERNAL_...`), and its
    integer template arguments."""
    i = 0
    while True:
        m = re.compile(r"\d+").search(mangled, i)
        if m is None:
            return mangled
        ident = mangled[m.end():m.end() + int(m.group())]
        i = m.end() + max(len(ident), 1)
        if ident.endswith("kernel"):
            break
    targs = re.match(r"I((?:L[a-z]+\d+E)+)E", mangled[i:])
    args = re.findall(r"L[a-z]+(\d+)E", targs.group(1)) if targs else []
    return ident + (f"<{', '.join(args)}>" if args else "")


def ptxas_summary(log):
    """One entry per kernel of an `nvcc -Xptxas -v` log: its name, registers
    and spill bytes."""
    out, current, spills = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            current = kernel_name(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spills = f"spills {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", ln)
        if m and current:
            out.append(f"{current} {m.group(1)} regs, {spills}")
            current = None
    return out


def repeat_differ(fn, calls):
    """How many of `calls` calls of fn() give an output that differs
    bitwise from the first call's (every kernel here is deterministic: a
    difference is a race)."""
    def outs():
        got = fn()
        return [got] if isinstance(got, torch.Tensor) else list(got)
    first = outs()
    differ = torch.zeros((), dtype=torch.int64, device=first[0].device)
    for _ in range(calls):
        differ += torch.stack([(g != f).any() for g, f in zip(outs(), first)]).any()
    return int(differ)


def max_err(got, want, dt, what, tol=KERNEL_TOL):
    """max |got - want| over the outputs, each held to tol[dt] of its scale."""
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        check(g.shape == w.shape, f"{what}: shape {tuple(g.shape)} != {tuple(w.shape)}")
        check(torch.isfinite(g).all().item(), f"{what}: non-finite output")
        err = (g - w).abs().max().item()
        scale = max(1.0, w.abs().max().item())
        check(err <= tol[dt] * scale, f"{what}: max|err| {err} > {tol[dt]} * {scale}")
        worst = max(worst, err)
    return worst


def train_flops(hr, batch):
    """One training step's operations at HR `hr` and `batch`: the
    multiply-adds of every convolution, ConvTranspose and linear layer of
    the x2 model's training forward, counted by forward hooks on a
    meta-device model (shapes only, no arithmetic), x2 for FLOPs and x3
    for the forward and the backward's two products (the input's and the
    weights' gradients)."""
    model = FACTORIES["superres"]().to("meta")
    macs = []

    def count(mod, inputs, out):
        if isinstance(mod, torch.nn.ConvTranspose2d):
            macs.append(inputs[0].numel() * mod.out_channels * mod.weight[0, 0].numel())
        elif isinstance(mod, torch.nn.Conv2d):
            macs.append(out.numel() * mod.weight[0].numel())
        elif isinstance(mod, torch.nn.Linear):
            macs.append(out.numel() * mod.in_features)

    hooks = [m.register_forward_hook(count) for m in model.modules()]
    try:
        with torch.no_grad():
            model(torch.empty(batch, hr, hr, 3, device="meta"), torch.empty(batch, device="meta"),
                  torch.empty(batch, hr // 2, hr // 2, 3, device="meta"), train=True)
    finally:
        for h in hooks:
            h.remove()
    return 2 * 3 * sum(macs)


def train_bound(hr, batch, params):
    """The least time of one training step: its operations (train_flops) at
    the bf16 peak against its bytes at HBM's rate (the uint8 batch read
    once; the float32 parameters, Adam's two moments and the EMA each read
    and written once)."""
    return _bound(train_flops(hr, batch), batch * hr * hr * 3 + 8 * 4 * params, PEAK_BF16)


class _U8Images:
    """n HR uint8 images drawn once from default_rng(seed), indexed round and
    round: a dataset of `length` items for the DataLoader."""

    def __init__(self, n, size, length, seed):
        self.pool = (np.random.default_rng(seed).random((n, size, size, 3)) * 255).astype(np.uint8)
        self.length = length

    def __len__(self):
        return self.length

    def __getitem__(self, i):
        return {"hr_u8": self.pool[i % len(self.pool)]}


def _train_throughput(dev, s2d_train, tmp):
    """The flagship recipe's steps at full width (TRAIN_*): Trainer.train
    over a DataLoader of uint8 images with the on-device DownBlur, the model
    built with every kernel flag (the 'stem' configuration), none of which
    may launch in training. An epoch of 3 warm-up steps, then one of 20
    timed (host clock, after a synchronize); the final loss is the timed
    epoch's mean train loss, as the loop logs it."""
    model = FACTORIES["superres"](**CONFIGS["stem"], s2d_train=s2d_train,
                                  compute_dtype=torch.bfloat16)
    metrics = os.path.join(tmp, f"metrics_{int(s2d_train)}.jsonl")
    tr = Trainer(model, "cosine", T_STEPS, TRAIN_HR, lr=TRAIN_LR, loss="MSE", ema_smoothing=True,
                 seed=SEED, device=dev, metrics_path=metrics,
                 batch_transform=make_downblur_transform(TRAIN_HR, 2, TRAIN_BLUR))
    state = tr.init_state(init_params(SEED, device="cpu"))

    def loader(steps):
        return DataLoader(_U8Images(2 * TRAIN_B, TRAIN_HR, steps * TRAIN_B, SEED), TRAIN_B,
                          shuffle=False)

    zero_counts()
    state = tr.train(state, 1, loader(TRAIN_WARMUP), check_preds_epoch=10**9, verbose=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = tr.train(state, 1, loader(TRAIN_STEPS), check_preds_epoch=10**9, verbose=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    check(all(n == 0 for n in counts.values()),
          f"train: hand kernels launched in training: {counts}")
    check(state.step == TRAIN_WARMUP + TRAIN_STEPS, f"train: {state.step} steps taken")
    tr.metrics.close()
    with open(metrics) as f:
        loss = json.loads(f.read().splitlines()[-1])["train_loss"]
    check(np.isfinite(loss) and all(torch.isfinite(p).all() for p in state.model.parameters()),
          f"train: loss {loss} or the parameters not finite")
    bound, by = train_bound(TRAIN_HR, TRAIN_B, sum(p.numel() for p in state.model.parameters()))
    return {"train": "s2d_train" if s2d_train else "dense", "hr": TRAIN_HR, "batch": TRAIN_B,
            "compute_dtype": "bfloat16", "steps": TRAIN_STEPS,
            "steps_per_s": TRAIN_STEPS / secs, "ms_per_step": 1e3 * secs / TRAIN_STEPS,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(), "final_loss": loss,
            "tflop_per_step": train_flops(TRAIN_HR, TRAIN_B) / 1e12, "bound_ms": bound,
            "bound_by": by}


def _step_on(device, s2d_train, sd, batch, t, noise):
    """One float32 train step (STEP_*) on `device` from state_dict `sd`: the
    model after it and the loss."""
    tr = Trainer(FACTORIES["superres"](s2d_train=s2d_train), "cosine", T_STEPS, STEP_HR,
                 lr=TRAIN_LR, ema_smoothing=True, seed=SEED, device=device)
    state = tr.init_state(sd)
    on = {k: v.to(device) for k, v in batch.items()}
    loss = float(tr.train_step(state, on, t.to(device), noise.to(device)))
    return state.model, loss


def _step_inputs():
    """The STEP_* batch, t and noise (CPU tensors), drawn from SEED + 7."""
    rng = np.random.default_rng(SEED + 7)
    batch = {"x": torch.from_numpy(rng.random((STEP_B, STEP_HR, STEP_HR, 3)).astype(np.float32)),
             "cond": torch.from_numpy(
                 rng.random((STEP_B, STEP_HR // 2, STEP_HR // 2, 3)).astype(np.float32))}
    t = torch.from_numpy(rng.integers(1, T_STEPS, STEP_B))
    noise = torch.from_numpy(rng.standard_normal((STEP_B, STEP_HR, STEP_HR, 3)).astype(np.float32))
    return batch, t, noise


def _compare_steps(s2d_train):
    """The card's float32 step against its host CPU's, from the same
    weights, batch, t and noise, at the CPU tests' tolerances (STEP_*)."""
    batch, t, noise = _step_inputs()
    sd = init_params(SEED, device="cpu")
    card, loss_card = _step_on(torch.device("cuda"), s2d_train, sd, batch, t, noise)
    host, loss_host = _step_on(torch.device("cpu"), s2d_train, sd, batch, t, noise)
    check(abs(loss_card - loss_host) <= STEP_LOSS_RTOL * abs(loss_host),
          f"train step: loss {loss_card} on the card, {loss_host} on the CPU")
    cp, hp = dict(card.named_parameters()), dict(host.named_parameters())
    gmax = max(float(p.grad.abs().max()) for p in hp.values())
    err = {"loss_rel": abs(loss_card - loss_host) / abs(loss_host), "grad": 0.0, "param_live": 0.0,
           "param": 0.0, "stats": 0.0}
    for n, p in hp.items():
        g = cp[n].grad.cpu()
        err["grad"] = max(err["grad"], float((g - p.grad).abs().max()) / gmax)
        d = (cp[n].detach().cpu() - p.detach()).abs()
        err["param"] = max(err["param"], float(d.max()))
        live = p.grad.abs() > 1e-5 * gmax
        if live.any():
            err["param_live"] = max(err["param_live"], float(d[live].max()))
    csd, hsd = card.state_dict(), host.state_dict()
    err["stats"] = max(float((csd[k].cpu() - hsd[k]).abs().max()) for k in hsd if "running" in k)
    check(err["grad"] <= STEP_GRAD_TOL and err["param_live"] <= STEP_PARAM_TOL
          and err["param"] <= 2 * TRAIN_LR and err["stats"] <= STEP_STATS_TOL,
          f"train step (s2d_train={s2d_train}): the card's differs from the CPU's: {err}")
    return err


def _learn_and_serve(dev, tmp):
    """Fit one fixed batch (LEARN_*) and check the loss fell; save the
    snapshot through Trainer.save_snapshot and serve one DDIM-100 micro-batch
    of 8 from it (InferenceServer.from_snapshot, the 'stem' configuration),
    with the exact launches of its kernels."""
    path = os.path.join(tmp, "snapshot.msgpack")
    tr = Trainer(FACTORIES["superres"](), "cosine", T_STEPS, LEARN_HR, snapshot_path=path,
                 lr=TRAIN_LR, ema_smoothing=True, seed=SEED, device=dev,
                 batch_transform=make_downblur_transform(LEARN_HR // 4, 2, TRAIN_BLUR, LEARN_HR))
    state = tr.init_state(init_params(SEED, device="cpu"))
    # smooth images: 16 x 16 uint8 noise, bilinear-upsampled to 64 by the transform
    batch = tr._prep_batch({"hr_u8": _U8Images(LEARN_B, LEARN_HR // 4, LEARN_B, SEED + 1).pool})
    losses = torch.stack([tr.train_step(state, batch) for _ in range(LEARN_STEPS)]).tolist()
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    check(np.isfinite(losses).all() and last < LEARN_RATIO * first,
          f"learning: the last 10 steps' loss {last} is not below {LEARN_RATIO} x the first 10's "
          f"{first}")
    tr.save_snapshot(state, 1)
    server = InferenceServer.from_snapshot(path, "cosine", T_STEPS, HR, model_flags=CONFIGS["stem"],
                                           ddim_steps=DDIM_STEPS, dtype=torch.bfloat16,
                                           max_batch=8, device="cuda")
    try:
        lrs = [np.random.default_rng(SEED + 9 + i).random((HR // 2, HR // 2, 3)).astype(np.float32)
               for i in range(8)]
        torch.cuda.synchronize()
        zero_counts()
        outs = server.infer_batch(lrs)
        counts = read_counts()
    finally:
        server.shutdown()
    check(all(o.shape == (HR, HR, 3) and np.isfinite(o).all() for o in outs),
          "train: served outputs from the trained snapshot misshapen or not finite")
    want = {k: n * server.batches_run * DDIM_STEPS for k, n in per_forward("stem").items()}
    check(counts == want and server.batches_run == 1,
          f"train: serving the trained snapshot launched {counts} in {server.batches_run} "
          f"micro-batches, expected {want} in 1")
    return {"learn_first10": first, "learn_last10": last, "learn_ratio": last / first,
            "served_micro_batches": server.batches_run,
            "served_launches": {k: v for k, v in counts.items() if v}}


def profile_train_step(dev, s2d_train, reps=5):
    """Where one training step's time goes at the flagship shape (TRAIN_*,
    one fixed batch already on the device): wall ms a step (host clock over
    `reps` steps, synchronized), device ms a step (torch.profiler's kernel
    time summed), the device's busy share (device / wall), and the top
    kernel families by device time, each with its share of the step's."""
    tr = Trainer(FACTORIES["superres"](s2d_train=s2d_train, compute_dtype=torch.bfloat16),
                 "cosine", T_STEPS, TRAIN_HR, lr=TRAIN_LR, ema_smoothing=True, seed=SEED,
                 device=dev, batch_transform=make_downblur_transform(TRAIN_HR, 2, TRAIN_BLUR))
    state = tr.init_state(init_params(SEED, device="cpu"))
    batch = tr._prep_batch({"hr_u8": _U8Images(TRAIN_B, TRAIN_HR, TRAIN_B, SEED).pool})
    for _ in range(2):
        tr.train_step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        tr.train_step(state, batch)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / reps
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            tr.train_step(state, batch)
        torch.cuda.synchronize()
    kernels = {}  # device ms a step by kernel family (the name before its template arguments)
    for ev in prof.key_averages():
        ms = getattr(ev, "self_device_time_total", 0) / 1e3 / reps
        if ms > 0:
            name = re.split(r"[<(]", re.sub(r"^void ", "", ev.key))[0].split("::")[-1][:60]
            kernels[name] = kernels.get(name, 0.0) + ms
    device = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"train_step": "s2d_train" if s2d_train else "dense", "wall_ms": wall,
            "device_ms": device, "busy_share": device / wall,
            "top_kernels": [[name, ms, ms / device] for name, ms in top]}


def draw_image(rng, size):
    """One eval image of benchmarks/learning_check.py (`_draw_image`, kept
    here so that the script needs nothing of benchmarks/): a blocky
    low-frequency field, sharp rectangles and 1-2 px lines, uint8."""
    small = rng.random((8, 8, 3)).astype(np.float32)
    reps = size // 8
    img = np.kron(small, np.ones((reps, reps, 1), np.float32))
    for _ in range(rng.integers(6, 12)):
        h = int(rng.integers(size // 16, size // 3))
        w = int(rng.integers(size // 16, size // 3))
        y = int(rng.integers(0, size - h))
        x = int(rng.integers(0, size - w))
        color = rng.random(3).astype(np.float32)
        img[y : y + h, x : x + w] = color
    for _ in range(rng.integers(4, 8)):
        t = int(rng.integers(1, 3))
        c = rng.random(3).astype(np.float32)
        if rng.random() < 0.5:
            y = int(rng.integers(0, size - t))
            img[y : y + t, :] = c
        else:
            x = int(rng.integers(0, size - t))
            img[:, x : x + t] = c
    return (img * 255).astype(np.uint8)


def eval_tiles():
    """learning_check's four held-out HR tiles (256 px, default_rng(10_000))."""
    rng = np.random.default_rng(EVAL_SEED)
    return [draw_image(rng, EVAL_TILE_HR) for _ in range(EVAL_TILES)]


def eval_lrs(tiles, dev):
    """The eval tiles' LR as learning_check._degrade_lr makes it (Pillow's
    bicubic and GaussianBlur, computed bit-equal without PIL by
    data.datasets.pil_downblur_u8), and its largest difference from the
    DownBlur on the card (data.device_degradation, the training path's;
    within 2/255 of Pillow's)."""
    exact = [pil_downblur_u8(t, 2, EVAL_BLUR).astype(np.float32) / 255.0 for t in tiles]
    dev_lr = make_downblur_transform(EVAL_TILE_HR, 2, EVAL_BLUR)(
        {"hr_u8": torch.from_numpy(np.stack(tiles)).to(dev)})["cond"].cpu().numpy()
    return exact, float(np.abs(dev_lr - np.stack(exact)).max())


def _reference_scores(name):
    with open(os.path.join(ARTIFACTS, "evals", name)) as f:
        return json.load(f)


def _scores(sr, hr, bic):
    return {"sr_psnr_db": psnr(sr, hr), "sr_ssim": ssim(sr, hr),
            "bicubic_psnr_db": psnr(bic, hr), "bicubic_ssim": ssim(bic, hr)}


def _score_pass(dev, name, kwargs, ref_name, hrs, lrs, bics, draws):
    """One pass of the quality phase: the x2 snapshot served by
    InferenceServer.from_snapshot in the 'stem' configuration (bf16) with
    `kwargs`; `draws` super-resolutions of each eval tile, the first
    through infer_tile a tile at a time, the others through infer_tiles
    (all at once: chunks of 48 patches of several tiles), each with noise of
    its own; every one scored against its HR, and their mean against the
    reference's score. The launches of the pass, exact."""
    ref = _reference_scores(ref_name)
    server = InferenceServer.from_snapshot(QUALITY_SNAPSHOT, "cosine", T_STEPS, HR,
                                           model_flags=CONFIGS["stem"], dtype=torch.bfloat16,
                                           device=dev, **kwargs)
    rows, secs = [], {"infer_tile": []}
    try:
        torch.cuda.synchronize()
        zero_counts()
        for hr, lr, bic in zip(hrs, lrs, bics):
            t0 = time.perf_counter()
            sr = server.infer_tile(lr)
            secs["infer_tile"].append(time.perf_counter() - t0)
            check(sr.shape == hr.shape and np.isfinite(sr).all(), f"quality {name}: bad tile")
            rows.append(_scores(sr, hr, bic))
        if draws > 1:
            t0 = time.perf_counter()
            srs = server.infer_tiles([lr for _ in range(draws - 1) for lr in lrs])
            secs[f"infer_tiles_{draws - 1}_draws"] = time.perf_counter() - t0
            for i, sr in enumerate(srs):
                j = i % len(hrs)
                check(sr.shape == hrs[j].shape and np.isfinite(sr).all(), f"quality {name}: bad tile")
                rows.append(_scores(sr, hrs[j], bics[j]))
        counts = read_counts()
    finally:
        server.shutdown()
    steps = DDIM_STEPS if "ddim_steps" in kwargs else T_STEPS - 1
    per_tile = len(patchify_coords(EVAL_TILE_HR // 2, EVAL_TILE_HR // 2, HR // 2, HR // 4))
    chunks = len(hrs) * -(-per_tile // B_FLAG) + -(-(draws - 1) * len(hrs) * per_tile // B_FLAG)
    want = {k: n * chunks * steps for k, n in per_forward("stem").items()}
    if kwargs.get("fused_update"):
        want["ancestral_update"] = chunks * steps
    check(counts == want, f"quality {name}: launches {counts}, expected {want}")
    mean = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
    for i, r in enumerate(rows):
        check(r["sr_psnr_db"] > r["bicubic_psnr_db"] and r["sr_ssim"] > r["bicubic_ssim"],
              f"quality {name}: tile {i % len(hrs)} of draw {i // len(hrs)} does not beat "
              f"bicubic: {r}")
    dp, ds = mean["sr_psnr_db"] - ref["mean_sr_psnr_db"], mean["sr_ssim"] - ref["mean_sr_ssim"]
    check(abs(dp) <= QUALITY_PSNR_TOL and abs(ds) <= QUALITY_SSIM_TOL,
          f"quality {name}: mean {mean['sr_psnr_db']} dB / SSIM {mean['sr_ssim']}, the "
          f"reference's {ref['mean_sr_psnr_db']} / {ref['mean_sr_ssim']} ({ref_name})")
    n = len(hrs)
    draw_means = [float(np.mean([r["sr_psnr_db"] for r in rows[d * n:(d + 1) * n]]))
                  for d in range(draws)]
    return {"pass": name, "sampler": "DDIM-100 clip_x0" if "ddim_steps" in kwargs else
            "DDPM T=1500" + (" fused_update" if kwargs.get("fused_update") else ""),
            "draws": draws, "tiles_first_draw": rows[:n],
            "mean_first_draw": {k: float(np.mean([r[k] for r in rows[:n]])) for k in rows[0]},
            "mean": mean, "draw_mean_psnr_db": draw_means,
            "draw_mean_psnr_sd_db": float(np.std(draw_means, ddof=1)) if draws > 1 else None,
            "reference": ref_name, "reference_mean_sr_psnr_db": ref["mean_sr_psnr_db"],
            "reference_mean_sr_ssim": ref["mean_sr_ssim"], "psnr_minus_reference_db": dp,
            "ssim_minus_reference": ds, "seconds": secs, "chunks": chunks,
            "launches": {k: v for k, v in counts.items() if v}}


def quality_phase(dev, card, draws):
    """The repo's trained x2 snapshot (QUALITY_SNAPSHOT, read by the port's
    io) on learning_check's eval tiles, their LR learning_check's, computed
    without PIL (eval_lrs; the on-card DownBlur's largest difference from it
    is reported): DDIM-100, T=1500 unfused and T=1500 with the fused update,
    `draws` draws a tile, one JSON line each (with `card`), and the
    fused-unfused gap. Returns the lines and the phase's launches."""
    check(os.path.exists(QUALITY_SNAPSHOT), f"quality: {QUALITY_SNAPSHOT} is missing")
    tiles = np.stack(eval_tiles())
    lrs, downblur_diff = eval_lrs(tiles, dev)
    hrs = list(tiles.astype(np.float32) / 255.0)
    bics = list(upsample_bicubic(torch.from_numpy(np.stack(lrs)), 2).clamp(0.0, 1.0).numpy())
    passes = [("ddim100", {"ddim_steps": DDIM_STEPS}, "x2_ddim100.json"),
              ("ddpm1500", {}, "x2_ddpm_full.json"),
              ("ddpm1500_fused_update", {"fused_update": True}, "x2_ddpm_full.json")]
    results, launches = [], dict.fromkeys(KERNELS, 0)
    for name, kwargs, ref in passes:
        r = _score_pass(dev, name, kwargs, ref, hrs, lrs, bics, draws)
        for k, n in r["launches"].items():
            launches[k] += n
        results.append(r)
    unfused, fused = results[1]["mean"], results[2]["mean"]
    gap = {"psnr_db": fused["sr_psnr_db"] - unfused["sr_psnr_db"],
           "ssim": fused["sr_ssim"] - unfused["sr_ssim"]}
    check(abs(gap["psnr_db"]) <= FUSED_PSNR_TOL and abs(gap["ssim"]) <= FUSED_SSIM_TOL,
          f"quality: fused update against unfused at T=1500: {gap}")
    lines = [json.dumps({**r, "card": card}) for r in results]
    lines.append(json.dumps({"fused_minus_unfused": gap, "draws": draws,
                             "lr_max_abs_diff_device_downblur": downblur_diff, "card": card}))
    return "\n".join(lines), launches


def _data_step(dev, tmp):
    """The first DATA_IMAGES of the train phase's uint8 images written as
    PNG files (the port's codec), read back through DecodeOnlyDataset and
    the DataLoader, the DownBlur on the card: the batch equals the one the
    in-memory images give, bit for bit."""
    images = _U8Images(2 * TRAIN_B, TRAIN_HR, DATA_IMAGES, SEED)
    folder = os.path.join(tmp, "png")
    os.makedirs(folder)
    t0 = time.perf_counter()
    for i in range(DATA_IMAGES):
        with open(os.path.join(folder, f"{i:04d}.png"), "wb") as f:
            f.write(encode_png(images[i]["hr_u8"]))
    write_s = time.perf_counter() - t0
    transform = make_downblur_transform(TRAIN_HR, 2, TRAIN_BLUR)

    def first_batch(dataset):
        host = next(iter(DataLoader(dataset, DATA_IMAGES, shuffle=False)))
        return transform({"hr_u8": torch.from_numpy(host["hr_u8"]).to(dev)})

    t0 = time.perf_counter()
    got = first_batch(DecodeOnlyDataset(folder, TRAIN_HR))
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    want = first_batch(images)
    check(got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want),
          "train data: the batch from PNG files differs from the in-memory batch")
    return {"data_png_images": DATA_IMAGES, "data_png_write_s": write_s,
            "data_png_read_and_downblur_s": read_s, "data_batch_bit_equal": True}


def train_phase(dev, card):
    """The train phase: the data step (PNG files through DecodeOnlyDataset,
    bit-equal to the in-memory batch), the full-width throughput runs, dense
    and s2d_train (one JSON line each, with `card`, nvidia-smi's name and
    power limit), the card's step against the CPU's, the learning check and
    serving from the trained snapshot."""
    with tempfile.TemporaryDirectory() as d:
        data = _data_step(dev, d)
        lines = [json.dumps({**_train_throughput(dev, s, d), "card": card}) for s in (False, True)]
        torch.cuda.empty_cache()
        steps = {("s2d_train" if s else "dense"): _compare_steps(s) for s in (False, True)}
        served = _learn_and_serve(dev, d)
    lines.append(json.dumps({"card_vs_cpu_step": steps, **served, **data}))
    return "\n".join(lines)


# ------------------------------------------------- the Orbax step, the helpers, the task scores

def checkpoint_packages():
    """{package: version, or None where it is not installed} of the
    packages the Orbax backend could use (CHECKPOINT_PACKAGES), read from
    the installed distributions' metadata: nothing is imported (orbax
    would import JAX)."""
    out = {}
    for name, dist in CHECKPOINT_PACKAGES.items():
        if importlib.util.find_spec(name) is None:
            out[name] = None
            continue
        try:
            out[name] = importlib.metadata.version(dist)
        except importlib.metadata.PackageNotFoundError:
            out[name] = "installed, version unknown"
    return out


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path) for f in fs)


def _orbax_step(dev, tmp):
    """The Orbax backend on the card: the train phase's flagship recipe
    (TRAIN_*) ORBAX_STEPS steps, then Trainer.save_snapshot with
    checkpoint_backend='orbax' (which returns before the write is done) and
    finalize_snapshots, each timed on the host clock beside the msgpack
    backend's save of the same state; a second save keeps one step
    directory and no temporary one; a new Trainer resumes from the
    directory with the saved weights and BatchNorm statistics bitwise and
    the epochs. Where tensorstore is missing it says so and returns the
    probe alone."""
    found = checkpoint_packages()
    out = {"packages": found}
    if found["tensorstore"] is None:
        print(f"[checkpoint] the Orbax step does not run: tensorstore is not installed on this "
              f"machine (probe: {json.dumps(found)})", flush=True)
        out["orbax"] = "not run: tensorstore is not installed"
        return out
    path = os.path.join(tmp, "orbax_ckpt")
    recipe = dict(lr=TRAIN_LR, loss="MSE", ema_smoothing=True, seed=SEED, device=dev,
                  batch_transform=make_downblur_transform(TRAIN_HR, 2, TRAIN_BLUR))

    def trainer(backend, snapshot):
        return Trainer(FACTORIES["superres"](compute_dtype=torch.bfloat16), "cosine", T_STEPS,
                       TRAIN_HR, snapshot_path=snapshot, checkpoint_backend=backend, **recipe)

    tr = trainer("orbax", path)
    state = tr.init_state(init_params(SEED, device="cpu"))
    batch = tr._prep_batch({"hr_u8": _U8Images(TRAIN_B, TRAIN_HR, TRAIN_B, SEED).pool})
    for _ in range(ORBAX_STEPS):
        tr.train_step(state, batch)
    torch.cuda.synchronize()
    saved = {k: v.detach().cpu().clone() for k, v in tr.ema_model(state).state_dict().items()
             if "num_batches" not in k}

    def host_ms(fn):
        t0 = time.perf_counter()
        fn()
        return 1e3 * (time.perf_counter() - t0)

    ms = {"orbax_save_ms": host_ms(lambda: tr.save_snapshot(state, ORBAX_STEPS)),
          "orbax_finalize_ms": host_ms(tr.finalize_snapshots)}
    first_steps = sorted(os.listdir(path))
    msgpack_path = os.path.join(tmp, "orbax_cmp.msgpack")
    tr_msgpack = trainer("msgpack", msgpack_path)
    ms["msgpack_save_ms"] = host_ms(lambda: tr_msgpack.save_snapshot(state, ORBAX_STEPS))
    ms["orbax_save2_ms"] = host_ms(lambda: tr.save_snapshot(state, ORBAX_STEPS))
    ms["orbax_finalize2_ms"] = host_ms(tr.finalize_snapshots)
    left = sorted(os.listdir(path))
    check(first_steps == ["0"] and left == ["1"],
          f"checkpoint orbax: step directories {first_steps} after one save, {left} after two "
          "(keep-one, no temporary directory)")
    nbytes = _dir_bytes(path)
    tr2 = trainer("orbax", path)
    state2 = tr2.maybe_resume(tr2.init_state(init_params(SEED + 1, device="cpu")))
    got = state2.model.state_dict()
    check(tr2.epochs_run == ORBAX_STEPS and all(torch.equal(got[k].cpu(), v)
                                                for k, v in saved.items()),
          f"checkpoint orbax: the resumed trainer's epochs ({tr2.epochs_run}) or weights and "
          "BatchNorm statistics differ from the saved ones")
    out["orbax"] = {"train_steps": ORBAX_STEPS, "hr": TRAIN_HR, "batch": TRAIN_B, **ms,
                    "orbax_directory_bytes": nbytes,
                    "msgpack_bytes": os.path.getsize(msgpack_path),
                    "float32_weight_bytes": sum(v.numel() * 4 for v in saved.values()),
                    "steps_after_two_saves": left, "resumed_epochs_run": tr2.epochs_run,
                    "resumed_bitwise_equal": True}
    return out


def _tf32_check(dev):
    """torch's defaults restored (cuDNN TF32 on, matmul TF32 off): a float32
    InferenceServer turns cuDNN's TF32 off, and its forward (the dense-s2d
    configuration: cuDNN convolutions) equals the reading taken with TF32
    off within MODEL_TOL; the TF32 reading's distance is printed."""
    x, t, cond = (torch.from_numpy(a).to(dev) for a in golden_input())
    m = model_with("dense", dev)

    def forward(model):
        with torch.inference_mode():
            return model(x, t, cond)

    torch.backends.cudnn.allow_tf32 = False
    off = forward(m)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    on = forward(m)
    server = InferenceServer(m, "cosine", T_STEPS, HR, ddim_steps=DDIM_STEPS, device="cuda")
    try:
        left_on = torch.backends.cudnn.allow_tf32
        served = forward(server.process.net)
    finally:
        server.shutdown()
        torch.backends.cudnn.allow_tf32 = False
    scale = max(1.0, float(off.abs().max()))
    err, tf32_err = (float((a - off).abs().max()) for a in (served, on))
    check(left_on is False, "tf32: a float32 InferenceServer left cuDNN's TF32 on")
    check(err <= MODEL_TOL[torch.float32] * scale,
          f"tf32: the float32 server's forward is {err} from the TF32-off reading")
    return {"float32_server_sets_cudnn_tf32": left_on, "max_abs_err_vs_tf32_off": err,
            "tf32_on_max_abs_err": tf32_err, "scale": scale}


def _helper_launches(counts, forwards, variant, what):
    want = {k: n * forwards for k, n in per_forward("block").items()}
    check(counts == want, f"helpers {what}: launches {counts}, expected {want}")
    return {row_of(k, variant): n for k, n in counts.items() if n}


def _max_rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def helpers_phase(dev, card):
    """The port's inference helpers from the in-repo snapshots, in a
    temporary working directory laid out as models_run/<name>/weights
    (module docstring, helpers). Returns the JSON lines and the launches of
    the helpers' own calls."""
    from diffusionremotesensing_tpu_torch import imgs_generator
    from diffusionremotesensing_tpu_torch import superres_and_NDVIgen as helpers

    sar_size = helpers.parse_imgsize(helpers.SAR_MODEL_NAME)
    level = cli.resolve_tap44(None, dev)  # the helpers' tap44 on this device: 'block' on a card

    for snap in (QUALITY_SNAPSHOT, SAR_SNAPSHOT):
        check(os.path.exists(snap), f"helpers: {snap} is missing")
    results = {"tf32": _tf32_check(dev)}
    launches = dict.fromkeys(list(KERNELS) + list(SHAPE_ROWS), 0)
    home = os.getcwd()
    with tempfile.TemporaryDirectory() as d:
        for name, snap in ((HELPER_SR_NAME, QUALITY_SNAPSHOT),
                           (helpers.SAR_MODEL_NAME, SAR_SNAPSHOT)):
            os.makedirs(os.path.join(d, "models_run", name, "weights"))
            os.symlink(snap, os.path.join(d, "models_run", name, "weights", "snapshot.pt"))
        os.chdir(d)
        try:
            # super_resolver: one eval tile's LR 128 -> 256
            hr = eval_tiles()[0]
            lr = pil_downblur_u8(hr, 2, EVAL_BLUR).astype(np.float32) / 255.0
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            sr = helpers.super_resolver(lr, device="cuda", model_name=HELPER_SR_NAME,
                                        generator=torch.Generator(device=dev).manual_seed(SEED),
                                        ddim_steps=HELPER_DDIM_STEPS)
            secs = time.perf_counter() - t0
            sr_launch = _helper_launches(read_counts(), HELPER_DDIM_STEPS, "superres",
                                         "super_resolver")
            check(sr.shape == (2 * lr.shape[0], 2 * lr.shape[1], 3) and np.isfinite(sr).all()
                  and sr.min() >= 0.0 and sr.max() <= 1.0,
                  f"helpers super_resolver: output {sr.shape} out of range")
            model = residual_attention_unet_superres(magnification_factor=2, s2d=True, tap44=level)
            model.load_state_dict(load_snapshot(QUALITY_SNAPSHOT)[0])
            proc = make_process(model.to(dev).eval(), "cosine", T_STEPS, 2 * lr.shape[0])
            direct = np.clip(proc.sample(1, cond=lr, ddim_steps=HELPER_DDIM_STEPS,
                                         generator=torch.Generator(device=dev).manual_seed(SEED))
                             [0].cpu().numpy(), 0.0, 1.0)
            sr_diff = _max_rel(sr, direct)
            check(sr_diff <= HELPER_TOL, f"helpers super_resolver: {sr_diff} of max |out| from "
                                         "the direct sampler")
            hr_f = hr.astype(np.float32) / 255.0
            bic = upsample_bicubic(torch.from_numpy(lr[None]), 2)[0].clamp(0, 1).numpy()
            results["super_resolver"] = {
                "snapshot": os.path.basename(QUALITY_SNAPSHOT), "model_name": HELPER_SR_NAME,
                "lr": list(lr.shape), "ddim_steps": HELPER_DDIM_STEPS, "seconds": secs,
                "max_rel_diff_vs_direct_sampler": sr_diff, "bitwise": bool(np.array_equal(sr, direct)),
                "psnr_db": psnr(sr, hr_f), "bicubic_psnr_db": psnr(bic, hr_f), "launches": sr_launch}

            # SAR_to_NDVI_generator: a learning_check SAR pair at 128 px, as
            # prepare_sar writes it ([-1, 1], CHW)
            sar, ndvi = _sar_pair(np.random.default_rng(SEED + 11), sar_size)
            np.save("sar.npy", (sar * 2 - 1).astype(np.float32))
            raw = np.load("sar.npy").astype(np.float32)
            check(-1.0 < raw.min() < 0.0, "helpers: the SAR input misses the rescale")
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            gen = helpers.SAR_to_NDVI_generator(
                "sar.npy", device="cuda", n_generations=2,
                generator=torch.Generator(device=dev).manual_seed(SEED),
                ddim_steps=HELPER_DDIM_STEPS)
            secs = time.perf_counter() - t0
            sar_launch = _helper_launches(read_counts(), HELPER_DDIM_STEPS, "sar",
                                          "SAR_to_NDVI_generator")
            check(gen.shape == (2, sar_size, sar_size, 1) and np.isfinite(gen).all(),
                  f"helpers SAR_to_NDVI_generator: output {gen.shape} or not finite")
            m_sar = residual_attention_unet_sar_to_ndvi(s2d=True, tap44=level)
            m_sar.load_state_dict(load_snapshot(SAR_SNAPSHOT)[0])
            cond = (raw.transpose(1, 2, 0) + 1) / 2
            direct = make_process(m_sar.to(dev).eval(), "cosine", T_STEPS, sar_size).sample(
                2, cond=cond, ddim_steps=HELPER_DDIM_STEPS,
                generator=torch.Generator(device=dev).manual_seed(SEED)).cpu().numpy()
            sar_diff = _max_rel(gen, direct)
            check(sar_diff <= HELPER_TOL, f"helpers SAR_to_NDVI_generator: {sar_diff} of max "
                                          "|out| from the direct sampler")
            results["SAR_to_NDVI_generator"] = {
                "snapshot": os.path.basename(SAR_SNAPSHOT), "size": sar_size,
                "n_generations": 2, "ddim_steps": HELPER_DDIM_STEPS, "seconds": secs,
                "max_rel_diff_vs_direct_sampler": sar_diff,
                "bitwise": bool(np.array_equal(gen, direct)),
                "psnr_db_vs_pair_ndvi": [psnr(np.clip(g, 0, 1), ndvi.transpose(1, 2, 0))
                                         for g in gen],
                "launches": sar_launch}

            # imgs_generator's sampling step, init_params weights of ten
            # classes written by the port's save_snapshot to ../models_run
            gen_model = residual_attention_unet_generation(num_classes=len(imgs_generator.CLASSES))
            gen_model.load_state_dict(init_params(SEED, "generation", device="cpu"))
            save_snapshot(os.path.join(d, "models_run", imgs_generator.MODEL_NAME, "weights",
                                       "snapshot.pt"), gen_model, 0)
            os.makedirs(os.path.join(d, "gen"))
            os.chdir(os.path.join(d, "gen"))
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            imgs = imgs_generator._generate(
                ddim_steps=HELPER_DDIM_STEPS, device="cuda",
                generator=torch.Generator(device=dev).manual_seed(SEED))
            secs = time.perf_counter() - t0
            gen_launch = _helper_launches(read_counts(), HELPER_DDIM_STEPS, "generation",
                                          "imgs_generator")
            check(imgs.shape == (len(imgs_generator.CLASSES), imgs_generator.IMAGE_SIZE,
                                 imgs_generator.IMAGE_SIZE, 3)
                  and np.isfinite(imgs).all() and imgs.min() >= 0.0 and imgs.max() <= 1.0,
                  f"helpers imgs_generator: images {imgs.shape} out of range")
            results["imgs_generator"] = {"weights": f"init_params({SEED}, 'generation')",
                                         "images": list(imgs.shape), "cfg": imgs_generator.CFG_SCALE,
                                         "ddim_steps": HELPER_DDIM_STEPS, "seconds": secs,
                                         "launches": gen_launch}
        finally:
            os.chdir(home)
    for part in (sr_launch, sar_launch, gen_launch):
        for k, n in part.items():
            launches[k] += n
    return json.dumps({**results, "card": card}), launches


# learning_check's SAR->NDVI and generation evaluation (benchmarks/
# learning_check.py: _structure, _sar_pair, _class_pattern, _gen_image,
# classify_by_pattern, _color_diversity), kept here so that the script
# needs nothing of benchmarks/
SAR_SIZE, GEN_SIZE = 64, 32
GEN_CLASSES = ["checker", "diag", "stripes_h", "stripes_v"]


def _sar_pair(rng, size):
    a, b = (draw_image(rng, size).astype(np.float32).mean(axis=2) / 255.0 for _ in range(2))
    ndvi = np.clip(0.5 + 0.5 * np.tanh(3.0 * (a - b)) + 0.3 * (a * b - 0.25), 0.0, 1.0)
    return np.stack([a, b]), ndvi[None]


def _class_pattern(name, size=GEN_SIZE):
    y, x = np.mgrid[0:size, 0:size]
    if name == "stripes_h":
        return ((y // 4) % 2).astype(np.float32)
    if name == "stripes_v":
        return ((x // 4) % 2).astype(np.float32)
    if name == "checker":
        return (((y // 4) + (x // 4)) % 2).astype(np.float32)
    return (((x + y) // 6) % 2).astype(np.float32)  # diag


def _gen_image(rng, name):
    p = _class_pattern(name)[:, :, None]
    c1, c2 = rng.random(3).astype(np.float32), rng.random(3).astype(np.float32)
    while np.abs(c1 - c2).mean() < 0.25:
        c2 = rng.random(3).astype(np.float32)
    img = p * c1 + (1 - p) * c2 + 0.03 * rng.standard_normal((GEN_SIZE, GEN_SIZE, 3))
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def classify_by_pattern(imgs):
    pats = np.stack([_class_pattern(c) for c in GEN_CLASSES])
    pats = pats - pats.mean(axis=(1, 2), keepdims=True)
    pats /= np.linalg.norm(pats, axis=(1, 2), keepdims=True) + 1e-9
    g = imgs.mean(axis=3)
    g = g - g.mean(axis=(1, 2), keepdims=True)
    g /= np.linalg.norm(g, axis=(1, 2), keepdims=True) + 1e-9
    return np.abs(np.einsum("bhw,chw->bc", g, pats)).argmax(axis=1)


def _color_diversity(imgs, labels, n_classes):
    return float(np.mean([imgs[labels == c].mean(axis=(1, 2)).std(axis=0).mean()
                          for c in range(n_classes)]))


def task_quality_phase(dev, card):
    """The trained SAR->NDVI and generation snapshots on the card, bf16, the
    'stem' configuration, DDIM-100 with x0 clamping, through
    InferenceServer.from_snapshot, scored as
    tests/test_torch_port_tasks_quality.py scores them on the CPU (module
    docstring, task_quality). Returns the JSON lines and the launches."""
    for snap in (SAR_SNAPSHOT, GEN_SNAPSHOT):
        check(os.path.exists(snap), f"task_quality: {snap} is missing")
    launches = dict.fromkeys(list(KERNELS) + list(SHAPE_ROWS), 0)
    lines = []

    def serve(path, size, **kw):
        return InferenceServer.from_snapshot(path, "cosine", T_STEPS, size,
                                             model_flags=CONFIGS["stem"], ddim_steps=DDIM_STEPS,
                                             dtype=torch.bfloat16, device="cuda", **kw)

    def counted(variant, forwards, what):
        counts = read_counts()
        want = {k: n * forwards for k, n in per_forward("stem").items()}
        check(counts == want, f"task_quality {what}: launches {counts}, expected {want}")
        for k, n in counts.items():
            launches[row_of(k, variant)] += n
        return {row_of(k, variant): n for k, n in counts.items() if n}

    # SAR->NDVI: prepare_sar's 8 eval pairs (seed 0 + 10000)
    erng = np.random.default_rng(10_000)
    pairs = [_sar_pair(erng, SAR_SIZE) for _ in range(SAR_EVAL_PAIRS)]
    sar = np.stack([p[0] for p in pairs]).transpose(0, 2, 3, 1).astype(np.float32)
    gt = np.stack([p[1] for p in pairs]).transpose(0, 2, 3, 1).astype(np.float32)
    server = serve(SAR_SNAPSHOT, SAR_SIZE, task="sar")
    try:
        g = torch.Generator(device=dev).manual_seed(5)
        x_T = torch.randn((len(sar), SAR_SIZE, SAR_SIZE, 1), generator=g, device=dev)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        pred = server.process.ddim_sampler(DDIM_STEPS, clip_x0=True)(
            x_T, torch.from_numpy(sar).to(dev)).float().clamp(0.0, 1.0).cpu().numpy()
        secs = time.perf_counter() - t0
        sar_launch = counted("sar", DDIM_STEPS, "sar")
    finally:
        server.shutdown()
    X = np.stack([sar[..., 0].ravel(), sar[..., 1].ravel(), np.ones(gt.size)], axis=1)
    w, *_ = np.linalg.lstsq(X, gt.ravel(), rcond=None)
    lin = np.clip((X @ w).reshape(gt.shape), 0.0, 1.0)
    ref = _reference_scores("sar_ddim100_clip.json")
    got = {"sar_psnr_db": psnr(pred, gt), "sar_ssim": ssim(pred, gt),
           "linear_baseline_psnr_db": psnr(lin, gt)}
    check(np.isfinite(pred).all() and got["sar_psnr_db"] > got["linear_baseline_psnr_db"]
          and abs(got["sar_psnr_db"] - ref["sar_psnr_db"]) <= SAR_PSNR_TOL,
          f"task_quality sar: {got}, the reference's {ref['sar_psnr_db']} dB")
    lines.append(json.dumps({"task": "sar", "snapshot": os.path.basename(SAR_SNAPSHOT),
                             "config": "stem", "dtype": "bfloat16", "pairs": len(sar), **got,
                             "reference_sar_psnr_db": ref["sar_psnr_db"],
                             "reference_sar_ssim": ref["sar_ssim"], "seconds": secs,
                             "launches": sar_launch, "card": card}))

    # generation: 32 images a class at CFG 3 (accuracy) and CFG 1 (diversity)
    labels = np.repeat(np.arange(len(GEN_CLASSES)), GEN_PER_CLASS)
    server = serve(GEN_SNAPSHOT, GEN_SIZE, task="generation", num_classes=len(GEN_CLASSES))
    try:
        kw = dict(ddim_steps=DDIM_STEPS, ddim_clip_x0=True)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        imgs, imgs_nc = (server.process.sample(
            len(labels), cond=labels, cfg_scale=cfg,
            generator=torch.Generator(device=dev).manual_seed(seed), **kw).float().clamp(0.0, 1.0)
            .cpu().numpy() for cfg, seed in ((CFG, 11), (1.0, 13)))
        secs = time.perf_counter() - t0
        gen_launch = counted("generation", 2 * DDIM_STEPS, "generation")
    finally:
        server.shutdown()
    acc = float((classify_by_pattern(imgs) == labels).mean())
    rng = np.random.default_rng(23)
    ref_imgs = np.stack([_gen_image(rng, n).astype(np.float32) / 255.0
                         for n in GEN_CLASSES for _ in range(GEN_PER_CLASS)])
    ratio = (_color_diversity(imgs_nc, labels, len(GEN_CLASSES))
             / max(_color_diversity(ref_imgs, labels, len(GEN_CLASSES)), 1e-9))
    ref = _reference_scores("gen_ddim100_clip.json")
    check(np.isfinite(imgs).all() and acc >= GEN_ACCURACY and ratio >= GEN_DIVERSITY,
          f"task_quality generation: accuracy {acc} (>= {GEN_ACCURACY}), CFG-1 diversity ratio "
          f"{ratio} (>= {GEN_DIVERSITY}); the reference's {ref['accuracy']}, "
          f"{ref['diversity_ratio_cfg1']}")
    lines.append(json.dumps({"task": "generation", "snapshot": os.path.basename(GEN_SNAPSHOT),
                             "config": "stem", "dtype": "bfloat16", "images": len(labels),
                             "accuracy_cfg3": acc, "diversity_ratio_cfg1": ratio,
                             "reference_accuracy": ref["accuracy"],
                             "reference_diversity_ratio_cfg1": ref["diversity_ratio_cfg1"],
                             "seconds": secs, "launches": gen_launch, "card": card}))
    return "\n".join(lines), launches


def _run_cli(argv):
    """cli.main(argv) with every launch count set to 0 just before and read
    just after; its standard output echoed. Returns (seconds, output,
    launches)."""
    buf = io.StringIO()
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    torch.cuda.synchronize()
    secs, counts = time.perf_counter() - t0, read_counts()
    print(buf.getvalue(), end="", flush=True)
    return secs, buf.getvalue(), counts


def _read_png(path):
    with open(path, "rb") as f:
        return decode_png(f.read()).astype(np.float32) / 255.0


def _cli_launches(forwards, fused_update=0, calibrations=0):
    """The launches of `forwards` forwards of the cli's configuration, and
    of `calibrations` int8 calibrations: CALIB_PROBES forwards each, and as
    many again on the dense-s2d branch (tap44 off: no tap_stem_block)."""
    want = dict.fromkeys(KERNELS, 0)
    want["tap_stem_block"] = forwards + calibrations * CALIB_PROBES
    want["att_head_block"] = want["dec_block"] = forwards + 2 * calibrations * CALIB_PROBES
    want["ancestral_update"] = fused_update
    return want


def _int8_accumulators(proc, lr, dev):
    """One B=48 forward of `proc` with its quant map attached: the int32
    accumulators of INT8_SITES as the card computed them (torch._int_mm)
    against the exact plain product of the same int8 operands
    (quant.int8_matmul_plain); they must be equal bitwise."""
    captured, current = {}, {}
    sites, real_acc = proc.net.quant_sites, quant.conv_int8_acc

    def amax(name, x, rows, top=False):
        a = type(sites).amax(sites, name, x, rows, top)
        current["name"] = name if a is not None else None
        return a

    def acc(xq, wq, stride=1, padding=0, lhs_dilation=1, matmul=quant.int8_matmul):
        out = real_acc(xq, wq, stride, padding, lhs_dilation, matmul)
        if current.get("name") in INT8_SITES and current["name"] not in captured:
            captured[current["name"]] = (xq, wq, stride, padding, lhs_dilation, out)
        return out

    patches, _ = AggregationSampler(proc, HR // 2, HR // 4, 2).extract_patches(lr)
    cond = torch.from_numpy(np.resize(patches, (B_FLAG,) + patches.shape[1:])).to(dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((B_FLAG, HR // 2, HR // 2, 12), generator=g, device=dev)  # s2d state
    sites.amax, quant.conv_int8_acc = amax, acc
    try:
        with torch.inference_mode():
            proc.apply_fn(x, torch.full((B_FLAG,), 500.0, device=dev), cond,
                          proc.encode_cond_fn(cond), proc.kernels)
    finally:
        del sites.amax
        quant.conv_int8_acc = real_acc
    check(set(captured) == set(INT8_SITES), f"cli int8: sites reached {sorted(captured)}")
    out = {}
    for name, (xq, wq, stride, padding, dil, got) in captured.items():
        plain = real_acc(xq.cpu(), wq.cpu(), stride, padding, dil, quant.int8_matmul_plain)
        check(got.dtype == torch.int32 and torch.equal(got.cpu(), plain),
              f"cli int8: {name}'s accumulators differ from the exact product")
        out[name] = {"M": int(got.numel() // got.shape[-1]), "K": int(wq[0].numel()),
                     "N": int(wq.shape[0]), "bitwise_equal": True}
    return out


def _cli_media(dev, tmp):
    """Which media packages import; with matplotlib, the superres trainer
    (cli.main) for one epoch of the train phase's 32 images as PNG files,
    its previews written, no hand kernel launched."""
    found = {}
    for name in MEDIA_PACKAGES:
        try:
            importlib.import_module(name)
            found[name] = True
        except Exception:  # noqa: BLE001 - absent or broken: either way not usable
            found[name] = False
    out = {"media_packages": found}
    if not found["matplotlib"]:
        return out
    images = _U8Images(2 * TRAIN_B, TRAIN_HR, DATA_IMAGES, SEED)
    for i in range(DATA_IMAGES):
        split = "train_original" if i < 3 * DATA_IMAGES // 4 else "val_original"
        os.makedirs(os.path.join(tmp, "data", split), exist_ok=True)
        with open(os.path.join(tmp, "data", split, f"{i:04d}.png"), "wb") as f:
            f.write(encode_png(images[i]["hr_u8"]))
    secs, text, counts = _run_cli(
        ["superres", "--model_name", "cli_sr", "--dataset_path", "data", "--image_size",
         str(TRAIN_HR), "--magnification_factor", "2", "--epochs", "1", "--batch_size", "8",
         "--loss", "MSE", "--Blur_radius", str(TRAIN_BLUR)])
    results = os.path.join(tmp, "models_run", "cli_sr", "results")
    check(os.path.exists(os.path.join(tmp, "models_run", "cli_sr", "weights", "snapshot.pt"))
          and sorted(os.listdir(results)) == ["superres_0_epoch.png", "superres_results.png"],
          "cli superres: no snapshot or previews")
    check(not any(counts.values()), f"cli superres: hand kernels launched {counts}")
    out["superres_train_one_epoch_s"] = secs
    return out


def cli_phase(dev, card):
    """The cli phase (module docstring): aggregation, int8, serve, census and
    the media packages. Returns the JSON lines and the main-path launches."""
    check(os.path.exists(QUALITY_SNAPSHOT), f"cli: {QUALITY_SNAPSHOT} is missing")
    tiles = np.stack(eval_tiles())
    lrs = [pil_downblur_u8(t, 2, EVAL_BLUR) for t in tiles]
    lrf = [lr.astype(np.float32) / 255.0 for lr in lrs]
    hrs = list(tiles.astype(np.float32) / 255.0)
    bics = list(upsample_bicubic(torch.from_numpy(np.stack(lrf)), 2).clamp(0.0, 1.0).numpy())
    launches, lines = dict.fromkeys(KERNELS, 0), []
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            weights = os.path.join(tmp, "models_run", "x2", "weights")
            os.makedirs(weights)
            os.symlink(QUALITY_SNAPSHOT, os.path.join(weights, "snapshot.pt"))
            os.makedirs("lr")
            for k, lr in enumerate(lrs):
                with open(os.path.join("lr", f"tile{k}.png"), "wb") as f:
                    f.write(encode_png(lr))
            base = ["aggregation", "--model_name", "x2", *CLI_FLAGS]

            # 1. aggregation, directory mode, DDIM-100: each tile against the
            # sampler on the same weights and image i's generator
            secs, _, counts = _run_cli([*base, "--ddim_steps", str(DDIM_STEPS), "--img_lr_dir",
                                        "lr", "--destination_dir", "sr"])
            check(counts == _cli_launches(len(lrs) * DDIM_STEPS),
                  f"cli aggregation: launches {counts}")
            for k, n in counts.items():
                launches[k] += n
            model = residual_attention_unet_superres(magnification_factor=2, **CLI_MODEL)
            model.load_state_dict(load_snapshot(QUALITY_SNAPSHOT)[0])
            proc = make_process(model.to(dev).eval(), "cosine", T_STEPS, HR)
            sampler = AggregationSampler(proc, HR // 2, HR // 4, 2, ddim_steps=DDIM_STEPS)
            agg = {"seconds": secs, "tiles": []}
            for k in range(len(lrs)):
                got = _read_png(os.path.join("sr", f"tile{k}.png"))
                want = sampler(lrf[k], generator=cli.aggregation_generator(dev, k), device=dev)
                err = float(np.abs(got - want).max())
                check(got.shape == hrs[k].shape and err <= 1 / 255 + TILE_TOL,
                      f"cli aggregation: tile {k} {got.shape}, {err} from the sampler's")
                row = _scores(got, hrs[k], bics[k])
                check(row["sr_psnr_db"] > row["bicubic_psnr_db"],
                      f"cli aggregation: tile {k} does not beat bicubic: {row}")
                agg["tiles"].append({**row, "max_abs_diff_from_sampler": err})

            # the ancestral chain with the fused update, warm-started at 250
            secs, _, counts = _run_cli([*base, "--fused_update", "--start_t", str(CLI_START_T),
                                        "--img_lr_path", os.path.join("lr", "tile0.png"),
                                        "--destination_path", "fused.png"])
            check(counts == _cli_launches(CLI_START_T, CLI_START_T),
                  f"cli aggregation fused_update: launches {counts}")
            for k, n in counts.items():
                launches[k] += n
            fused = _read_png("fused.png")
            check(fused.shape == hrs[0].shape and np.isfinite(fused).all(),
                  "cli aggregation fused_update: bad tile")
            agg["fused_update_start_t"] = {"seconds": secs, **_scores(fused, hrs[0], bics[0])}
            lines.append(json.dumps({"cli_aggregation": agg, "card": card}))

            # 2. int8: the cli on the four tiles, the accumulators at B=48, the
            # paired quality gap over INT8_DRAWS draws a tile
            secs, text, counts = _run_cli([*base, "--ddim_steps", str(DDIM_STEPS), "--quant",
                                           "int8", "--img_lr_dir", "lr", "--destination_dir",
                                           "sr_int8"])
            check(counts == _cli_launches(len(lrs) * DDIM_STEPS, calibrations=len(lrs)),
                  f"cli int8: launches {counts}")
            for k, n in counts.items():
                launches[k] += n
            n_sites = [int(m) for m in re.findall(r"int8 quantized execution: (\d+) conv-site", text)]
            check(len(n_sites) == len(lrs) and min(n_sites) > 0, f"cli int8: sites {n_sites}")
            cli_int8 = []
            for k in range(len(lrs)):
                got = _read_png(os.path.join("sr_int8", f"tile{k}.png"))
                check(got.shape == hrs[k].shape and np.isfinite(got).all(), f"cli int8: tile {k}")
                cli_int8.append(_scores(got, hrs[k], bics[k]))
            qgen = torch.Generator(device=dev)
            t0 = time.perf_counter()
            qmap = quant.quantize_superres_tile(proc.net, proc.schedule.alpha_hat, lrf[0], HR // 2,
                                                2, qgen.manual_seed(21))
            torch.cuda.synchronize()
            quant.attach(proc.net, qmap)
            calib_s = time.perf_counter() - t0
            acc = _int8_accumulators(proc, lrf[0], dev)
            rows = {"int8": [], "float": []}
            secs_q = {"int8": 0.0, "float": 0.0, "calibration": calib_s}
            for k in range(len(lrs)):
                t0 = time.perf_counter()
                qmap = quant.quantize_superres_tile(proc.net, proc.schedule.alpha_hat, lrf[k],
                                                    HR // 2, 2, qgen.manual_seed(21))
                torch.cuda.synchronize()
                secs_q["calibration"] += time.perf_counter() - t0
                for name, q in (("int8", qmap), ("float", None)):
                    quant.attach(proc.net, q)
                    t0 = time.perf_counter()
                    srs = sampler.sample_tiles([lrf[k]] * INT8_DRAWS, device=dev,
                                               generator=qgen.manual_seed(1000 + k))
                    secs_q[name] += time.perf_counter() - t0
                    for sr in srs:
                        check(np.isfinite(sr).all(), f"cli int8: {name} draw of tile {k}")
                        rows[name].append(_scores(sr, hrs[k], bics[k]))
            quant.attach(proc.net, None)
            mean = {n: {"psnr_db": float(np.mean([r["sr_psnr_db"] for r in rs])),
                        "ssim": float(np.mean([r["sr_ssim"] for r in rs]))}
                    for n, rs in rows.items()}
            gap = {m: mean["int8"][m] - mean["float"][m] for m in ("psnr_db", "ssim")}
            print(json.dumps({"int8_mean": mean["int8"], "float_mean": mean["float"],
                              "int8_minus_float": gap, "reference_gap": INT8_REF_GAP}), flush=True)
            check(gap["psnr_db"] >= INT8_REF_GAP["psnr_db"] - INT8_GAP_PSNR_TOL
                  and gap["ssim"] >= INT8_REF_GAP["ssim"] - INT8_GAP_SSIM_TOL,
                  f"cli int8: gap {gap} against the reference's {INT8_REF_GAP}")
            n_tiles = len(lrs) * INT8_DRAWS
            lines.append(json.dumps({"cli_int8": {
                "cli_seconds": secs, "sites": n_sites, "cli_tiles": cli_int8,
                "accumulators_b48": acc, "draws": INT8_DRAWS, "mean": mean,
                "int8_minus_float": gap, "reference_gap": INT8_REF_GAP,
                "calibration_s_per_tile": secs_q["calibration"] / (len(lrs) + 1),
                "ddim100_s_per_tile": {"int8": secs_q["int8"] / n_tiles,
                                       "float": secs_q["float"] / n_tiles}}, "card": card}))

            # 3. serve: one HTTP round trip through build_server, equal to a
            # twin server's infer_batch with the same seed; then --quant int8
            serve_argv = ["serve", "--snapshot_path", QUALITY_SNAPSHOT, "--task", "superres",
                          "--model_input_size", str(HR), "--magnification_factor", "2",
                          "--ddim_steps", str(DDIM_STEPS), "--seed", "0", "--tap44", "stem",
                          "--fused_att", "--dec_block"]
            lr_req, hr_req = lrs[0][:HR // 2, :HR // 2], hrs[0][:HR, :HR]
            bic_req = bics[0][:HR, :HR]
            torch.cuda.synchronize()
            zero_counts()
            server = cli.build_server(cli.parse_args(serve_argv))
            http = server.make_http_server("127.0.0.1", 0)
            th = threading.Thread(target=http.serve_forever, daemon=True)
            th.start()
            try:
                body = json.dumps({"image": base64.b64encode(encode_png(lr_req)).decode()}).encode()
                req = urllib.request.Request(f"http://127.0.0.1:{http.server_port}/superres",
                                             body, {"Content-Type": "application/json"})
                t0 = time.perf_counter()
                with urllib.request.urlopen(req, timeout=600) as r:
                    answer = json.loads(r.read())
                http_s = time.perf_counter() - t0
            finally:
                http.shutdown()
                http.server_close()
                server.shutdown()
            counts = read_counts()
            check(counts == _cli_launches(DDIM_STEPS), f"cli serve: launches {counts}")
            for k, n in counts.items():
                launches[k] += n
            got = decode_png(base64.b64decode(answer["image"])).astype(np.float32) / 255.0
            twin = cli.build_server(cli.parse_args(serve_argv))
            try:
                want = twin.infer_batch([lr_req.astype(np.float32) / 255.0])[0]
            finally:
                twin.shutdown()
            err = float(np.abs(got - want).max())
            check(got.shape == (HR, HR, 3) and err <= 1 / 255 + TILE_TOL,
                  f"cli serve: HTTP answer {got.shape}, {err} from infer_batch's")
            serve_q = cli.build_server(cli.parse_args([*serve_argv, "--quant", "int8"]))
            try:
                out_q = serve_q.infer_batch([lr_req.astype(np.float32) / 255.0])[0]
            finally:
                serve_q.shutdown()
            sq = _scores(out_q, hr_req, bic_req)
            check(out_q.shape == (HR, HR, 3) and np.isfinite(out_q).all()
                  and sq["sr_psnr_db"] > sq["bicubic_psnr_db"], f"cli serve int8: {sq}")
            serve = {"http_round_trip_s": http_s, "max_abs_diff_from_infer_batch": err,
                     "http": _scores(got, hr_req, bic_req), "int8": sq,
                     "int8_sites": len(serve_q.process.net.quant_sites.scales)}

            # 4. census, 5. media packages
            census = {label: sum(module_totals(f()).values()) for label, f in CENSUS_MODELS}
            check(tuple(census.values()) == CENSUS_TOTALS, f"cli census: {census}")
            media = _cli_media(dev, tmp)
            lines.append(json.dumps({"cli_serve": serve, "census": census, **media, "card": card}))
        finally:
            os.chdir(cwd)
    return "\n".join(lines), launches


# ------------------------------------------------------------ parallel phase

PAR_WARMUP, PAR_STEPS = 3, 5  # flagship steps of the world-1 group: warm-up, then timed
PAR_RANK_TIMEOUT = 300  # seconds for the two ranks of (c), start-up included
# (c)'s step against one process's: the whole gradient's relative L2 error.
# A channel constant over the batch has an E[x^2] - E[x]^2 made of rounding
# noise, near BatchNorm's eps, and its gradient follows that noise: summing
# the statistics over two halves instead of the whole moves single
# gradient entries by up to 3e-4 of the largest and the whole gradient by
# 4e-4 in L2 on the CPU (the same happens in one process), while the loss
# does not move; max-abs entry bounds (STEP_GRAD_TOL) do not hold there
PAR_GRAD_RL2 = 5e-3


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _par_train(dev, backend):
    """(a) The flagship recipe (HR 256, batch 32, bfloat16, the train phase's
    images and DownBlur), PAR_WARMUP + PAR_STEPS steps through
    Trainer(mesh=make_mesh()) in a world-1 group on `backend`, and the same
    steps without a mesh: every step's loss and the timed steps' ms."""
    dist = torch.distributed
    dist.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh()
        check(mesh.group is not None and mesh.devices == (process_device(dev.type),),
              f"parallel: make_mesh() in a world-1 group gave {mesh}")
        losses, ms = {}, {}
        for name, m in (("mesh", mesh), ("no_mesh", None)):
            model = FACTORIES["superres"](**CONFIGS["stem"], compute_dtype=torch.bfloat16)
            tr = Trainer(model, "cosine", T_STEPS, TRAIN_HR, lr=TRAIN_LR, loss="MSE",
                         ema_smoothing=True, seed=SEED, device=dev, mesh=m,
                         batch_transform=make_downblur_transform(TRAIN_HR, 2, TRAIN_BLUR))
            state = tr.init_state(init_params(SEED, device="cpu"))
            images = _U8Images(2 * TRAIN_B, TRAIN_HR, (PAR_WARMUP + PAR_STEPS) * TRAIN_B, SEED)
            out = []
            for i, b in enumerate(DataLoader(images, TRAIN_B, shuffle=False)):
                if i == PAR_WARMUP:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                out.append(tr.train_step(state, tr._prep_batch(b)))
            torch.cuda.synchronize()
            ms[name] = 1e3 * (time.perf_counter() - t0) / PAR_STEPS
            losses[name] = torch.stack(out).tolist()
            del tr, state, model
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["mesh"], losses["no_mesh"])]
    check(np.isfinite(losses["mesh"]).all() and max(rel) <= STEP_LOSS_RTOL,
          f"parallel (a): losses {losses['mesh']} with the world-1 group, "
          f"{losses['no_mesh']} without")
    return {"world1_backend": backend, "steps": PAR_WARMUP + PAR_STEPS, "losses": losses,
            "loss_rel_diff": rel, "ms_per_step": ms}


def _par_process(dev):
    """The quality phase's x2 snapshot in the 'stem' configuration, float32
    (the kernels' float32 versions), as the serve phase compares tiles: a
    bf16 tile at 5 patches a replica against 9 on one device differs by
    ~7e-3 after DDIM-100 on an H100, the roundings of differently tiled
    batches carried over 100 steps."""
    sd, _ = load_snapshot(QUALITY_SNAPSHOT)
    m = FACTORIES["superres"](**CONFIGS["stem"])
    m.load_state_dict(sd, strict=True)
    return make_process(m.to(dev).eval(), "cosine", T_STEPS, HR)


def _par_split(dev, lr):
    """(b) One eval tile (9 patches) through AggregationSampler on one device
    (chunks of 48) and over make_mesh([cuda:0, cuda:0]) (24 a replica: the
    9 patches padded to 10, 5 a replica; the second replica a copy of the
    net, as on a second card), DDIM-100 and the fused-update
    T=1500 chain: the tiles within TILE_TOL, each replica launching what
    the one device launches (the counts twice the one device's), the
    seconds of each run. Returns the JSON fields, the mesh runs' launches
    and the one-device DDIM-100 tile."""
    proc = _par_process(dev)
    mesh = make_mesh([process_device(dev.type)] * 2)
    check(mesh.size == 2 and mesh.group is None, f"parallel: the one-card mesh is {mesh}")
    res, launches, tiles = {}, dict.fromkeys(KERNELS, 0), {}
    for name, kw in (("ddim100", {"ddim_steps": DDIM_STEPS}),
                     ("ddpm1500_fused_update", {"fused_update": True})):
        runs = {}
        for run, m, bs in (("one", None, B_FLAG), ("split", mesh, B_FLAG // 2)):
            agg = AggregationSampler(proc, HR // 2, HR // 4, 2, batch_size=bs, mesh=m, **kw)
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            out = agg(lr, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
            torch.cuda.synchronize()
            runs[run] = (out, time.perf_counter() - t0, read_counts())
        (one, s_one, c_one), (split, s_split, c_split) = runs["one"], runs["split"]
        err = float(np.abs(split - one).max())
        check(split.shape == one.shape and np.isfinite(split).all() and err <= TILE_TOL,
              f"parallel (b) {name}: the split tile differs from the one-device tile by {err}")
        check(c_split == {k: 2 * v for k, v in c_one.items()} and any(c_one.values()),
              f"parallel (b) {name}: launches {c_split} split, {c_one} on one device")
        for k, v in c_split.items():
            launches[k] += v
        tiles[name] = one
        rep = proc.replica(mesh.devices[1], 1)
        check(rep is not proc and rep.net is not proc.net
              and rep.net.quant_sites is proc.net.quant_sites,
              "parallel (b): the second replica is not a copy of the net sharing its quant sites")
        res[name] = {"max_abs_diff": err, "seconds_one_device": s_one, "seconds_split": s_split,
                     "launches_one_device": {k: v for k, v in c_one.items() if v},
                     "launches_split": {k: v for k, v in c_split.items() if v}}
    return res, launches, tiles["ddim100"]


def _par_rank(rank, port, path, dev):
    """(c) Rank `rank` of a 2-process gloo group on `dev` (the card: cuda:0
    for both): one train step on its half of the inputs' global batch and
    the inputs' tile split over the ranks; rank 0 saves both."""
    dev = process_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist = torch.distributed
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2)
    try:
        inputs = torch.load(path, weights_only=False)
        mesh = make_mesh([dev])
        tr = Trainer(FACTORIES["superres"](), "cosine", T_STEPS, STEP_HR, lr=TRAIN_LR,
                     ema_smoothing=True, seed=SEED, mesh=mesh)
        state = tr.init_state(init_params(SEED, device="cpu"))
        batch = shard_batch({k: v.to(dev) for k, v in inputs["batch"].items()}, mesh)
        t, noise = shard_batch((inputs["t"].to(dev), inputs["noise"].to(dev)), mesh)
        loss = float(tr.train_step(state, batch, t, noise))
        agg = AggregationSampler(_par_process(dev), HR // 2, HR // 4, 2, batch_size=B_FLAG // 2,
                                 mesh=mesh, ddim_steps=DDIM_STEPS)
        tile = agg(inputs["lr"], generator=torch.Generator(device=dev).manual_seed(SEED),
                   device=dev)
        if rank == 0:
            torch.save({"loss": loss, "model": {k: v.cpu() for k, v in
                                                state.model.state_dict().items()},
                        "grads": {n: p.grad.cpu() for n, p in state.model.named_parameters()},
                        "tile": tile}, path + ".rank0")
    finally:
        dist.destroy_process_group()


def _par_group(dev, lr, tile_one):
    """(c) Two processes on the one card, a gloo group over CUDA tensors
    (NCCL takes one rank a card): one float32 DDP step (the train phase's
    STEP_* inputs, each rank its half) against the one-process step on the
    whole batch (the loss and statistics at the STEP_* tolerances, the
    gradient within PAR_GRAD_RL2 in L2, the parameters after Adam within 2
    lr), and one DDIM-100 tile split over the ranks against (b)'s
    one-device tile within TILE_TOL."""
    batch, t, noise = _step_inputs()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "inputs.pt")
        torch.save({"batch": batch, "t": t, "noise": noise, "lr": lr}, path)
        port = _free_port()
        ctx = torch.multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_par_rank, args=(r, port, path, dev.type)) for r in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=PAR_RANK_TIMEOUT)
        secs = time.perf_counter() - t0
        hung = [p.is_alive() for p in procs]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        check(not any(hung) and all(p.exitcode == 0 for p in procs),
              f"parallel (c): ranks hung {hung}, exit codes {[p.exitcode for p in procs]}")
        got = torch.load(path + ".rank0", weights_only=False)
    one, loss = _step_on(dev, False, init_params(SEED, device="cpu"), batch, t, noise)
    hp = dict(one.named_parameters())
    gmax = max(float(p.grad.abs().max()) for p in hp.values())
    err = {"loss_rel": abs(got["loss"] - loss) / abs(loss), "grad_max": 0.0, "param": 0.0}
    sq = norm = 0.0
    for n, p in hp.items():
        g = p.grad.cpu()
        err["grad_max"] = max(err["grad_max"], float((got["grads"][n] - g).abs().max()) / gmax)
        sq += float(((got["grads"][n] - g).double() ** 2).sum())
        norm += float((g.double() ** 2).sum())
        err["param"] = max(err["param"], float((got["model"][n] - p.detach().cpu()).abs().max()))
    err["grad_rel_l2"] = (sq / norm) ** 0.5
    hsd = one.state_dict()
    err["stats"] = max(float((got["model"][k] - hsd[k].cpu()).abs().max())
                       for k in hsd if "running" in k)
    err["tile"] = float(np.abs(got["tile"] - tile_one).max())
    check(err["loss_rel"] <= STEP_LOSS_RTOL and err["grad_rel_l2"] <= PAR_GRAD_RL2
          and err["param"] <= 2 * TRAIN_LR and err["stats"] <= STEP_STATS_TOL
          and err["tile"] <= TILE_TOL,
          f"parallel (c): the 2-rank group differs from one process: {err}")
    return {"ranks": 2, "backend": "gloo", "seconds_with_startup": secs, "vs_one_process": err}


def parallel_phase(dev, card):
    """The parallel phase: (a) the world-1 group's flagship steps, (b) the
    one-card split of a tile, (c) a 2-rank gloo group on the one card; one
    JSON line (with `card`). Returns it and (b)'s launches."""
    nccl = torch.distributed.is_nccl_available()
    version = ".".join(map(str, torch.cuda.nccl.version())) if nccl else None
    backend = "nccl" if nccl else "gloo"
    print(f"parallel: torch.distributed.is_nccl_available() = {nccl}, NCCL {version}; "
          f"the world-1 group runs on {backend}" + ("" if nccl else " (chosen: no NCCL)"),
          flush=True)
    lr = eval_lrs(np.stack(eval_tiles()[:1]), dev)[0][0]
    train = _par_train(dev, backend)
    split, launches, tile_one = _par_split(dev, lr)
    group = _par_group(dev, lr, tile_one)
    return json.dumps({"nccl_available": nccl, "nccl_version": version, "world1": train,
                       "split_one_card": split, "group_two_ranks": group,
                       "card": card}), launches


# ------------------------------------------------------------- spatial phase

SPATIAL_HR = 512       # one whole x2 image: LR 256 -> HR 512, B = 1
SPATIAL_BANDS = (2, 4)  # bands of the float32 DDIM-100 split, all on the one card
SPATIAL_START_T = 250   # the fused chain's warm start: 250 ancestral_update launches a band
SPATIAL_SEAM = 3        # rows each side of a seam whose difference is read on its own
# (f): the configurations whose kernels run inside a chain on an extended
# band, at half (a)'s DDIM steps to keep the phase's time (4 configurations x
# 1 + 2 + 4 bands)
SPATIAL_LEVELS = ("tap", "conv2", "l1", "packed")
SPATIAL_LEVEL_STEPS = 50
SPATIAL_INT8_STEPS = 20  # (h): the quantized sampler's DDIM steps
# (h): each scale of the split calibration against one device's, relative:
# the max |x| of one activation computed by cuDNN at the bands' shapes and
# the whole image's (TF32 off), a few float32 ulps apart
INT8_SCALE_RTOL = 1e-5
INT8_BAND_SITE = "s2d.down0s"  # (h): the site whose accumulators band 1 gives


def _sp_inputs(dev):
    """One 512-px image of learning_check's kind (draw_image, default_rng(SEED +
    7)), its LR as the eval tiles' (Pillow's bicubic and blur, bit-equal
    without PIL), and x_T from a seeded generator on the card."""
    hr = draw_image(np.random.default_rng(SEED + 7), SPATIAL_HR)
    lr = torch.from_numpy(pil_downblur_u8(hr, 2, EVAL_BLUR).astype(np.float32) / 255.0)[None]
    x_T = torch.randn((1, SPATIAL_HR, SPATIAL_HR, 3),
                      generator=torch.Generator(device=dev).manual_seed(SEED + 8), device=dev)
    return x_T, lr.to(dev)


def _sp_process(dev, dtype=torch.float32, config="stem"):
    """The quality phase's x2 snapshot at HR 512 in configuration `config`
    (CONFIGS; 'stem': tap_stem_block, the gates, att_head_block,
    dec_block), computing in `dtype`."""
    sd, _ = load_snapshot(QUALITY_SNAPSHOT)
    m = FACTORIES["superres"](**CONFIGS[config])
    m.load_state_dict(sd, strict=True)
    return make_process(m.to(dev).eval(), "cosine", T_STEPS, SPATIAL_HR, dtype=dtype)


def _sp_seam_rows(k):
    rows = set()
    for j in range(1, k):
        b = j * SPATIAL_HR // k
        rows.update(range(b - SPATIAL_SEAM, b + SPATIAL_SEAM))
    return sorted(rows)


def _sp_run(fn, *args, **kw):
    """fn(*args, **kw) with every launch count 0 just before: (output on the
    host, seconds, launches)."""
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out.float().cpu().numpy(), time.perf_counter() - t0, read_counts()


def _sp_update_bands(dev):
    """The band layout of ancestral_update on the card: a (2, 256, 256, 12)
    float32 state (the x2 image's s2d state at B = 2) updated in two bands of
    rows, each at its quads, bitwise the whole state's update; the whole
    image as its own band bitwise today's stream; a band's generator words
    bitwise the plain Philox's."""
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    shape = (2, SPATIAL_HR // 2, SPATIAL_HR // 2, 12)
    x = torch.randn(shape, generator=g, device=dev)
    eps = torch.randn(shape, generator=g, device=dev)
    seed, step = draw_seed(g, dev), 700
    coefs = update_coefs(make_schedule("cosine", T_STEPS), step)
    row, item = shape[2] * shape[3] // 4, shape[1] * shape[2] * shape[3] // 4
    whole = ancestral_update(x, eps, coefs, seed, step)
    cut = 3 * shape[1] // 8  # a band boundary off the middle
    parts = [ancestral_update(x[:, a:b].contiguous(), eps[:, a:b].contiguous(), coefs, seed, step,
                              quad0=a * row, item_quads=item) for a, b in ((0, cut), (cut, shape[1]))]
    as_band = ancestral_update(x, eps, coefs, seed, step, item_quads=item)
    n = 2 * (shape[1] - cut) * shape[2] * shape[3]
    words = philox_bits(seed, step, n, cut * row, item, (shape[1] - cut) * row)
    plain = philox_bits_plain(seed.cpu(), step, n, cut * row, item, (shape[1] - cut) * row)
    check(torch.equal(torch.cat(parts, 1), whole), "spatial: ancestral_update's two bands differ "
                                                    "from the whole state's rows")
    check(torch.equal(as_band, whole), "spatial: ancestral_update with the whole image as its "
                                       "band is not today's stream")
    check(torch.equal(words.cpu(), plain), "spatial: a band's generator words are not the plain "
                                           "Philox's")
    err = float((parts[1] - ancestral_update_plain(
        x[:, cut:].contiguous(), eps[:, cut:].contiguous(), coefs, seed, step, quad0=cut * row,
        item_quads=item)).abs().max())
    check(err <= UPDATE_TOL[torch.float32] * max(1.0, float(whole.abs().max())),
          f"spatial: a band's update differs from the plain version's by {err}")
    return {"bands_bitwise_whole": True, "whole_as_band_bitwise": True,
            "band_words_bitwise_plain": True, "band_vs_plain_max_abs": err}


def _sp_rank(rank, port, path, dev):
    """(e) Rank `rank` of a 2-process gloo group on the one card: the DDIM-100
    image with its height split over the ranks (one band a rank, halos by
    batch_isend_irecv through host copies); rank 0 saves it."""
    dev = process_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist = torch.distributed
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2)
    try:
        inputs = torch.load(path, weights_only=False)
        spatial = spatial_sharding(make_mesh([dev]))
        proc = _sp_process(dev)
        out = proc.ddim_sampler(DDIM_STEPS, clip_x0=True, spatial=spatial)(
            inputs["x_T"].to(dev), inputs["lr"].to(dev))
        if rank == 0:
            torch.save({"image": out.cpu(), "bands": spatial.bands,
                        "local": spatial.local_bands()}, path + ".rank0")
    finally:
        dist.destroy_process_group()


def _sp_group(dev, x_T, lr, one):
    """(e) Two processes on the card in a gloo group over CUDA tensors: the
    DDIM-100 image split over the ranks against (a)'s one-device image."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "inputs.pt")
        torch.save({"x_T": x_T.cpu(), "lr": lr.cpu()}, path)
        port = _free_port()
        ctx = torch.multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_sp_rank, args=(r, port, path, dev.type)) for r in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=PAR_RANK_TIMEOUT)
        secs = time.perf_counter() - t0
        hung = [p.is_alive() for p in procs]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        check(not any(hung) and all(p.exitcode == 0 for p in procs),
              f"spatial (e): ranks hung {hung}, exit codes {[p.exitcode for p in procs]}")
        got = torch.load(path + ".rank0", weights_only=False)
    image = got["image"].numpy()
    err = float(np.abs(image - one).max())
    seam = float(np.abs(image[:, _sp_seam_rows(2)] - one[:, _sp_seam_rows(2)]).max())
    check(got["bands"] == 2 and got["local"] == [0] and np.isfinite(image).all()
          and err <= TILE_TOL,
          f"spatial (e): the 2-rank image differs from one device's by {err} (seams {seam})")
    return {"ranks": 2, "backend": "gloo", "seconds_with_startup": secs, "max_abs_diff": err,
            "seam_max_abs_diff": seam}


def _sp_splits(proc, name, steps, x_T, lr, dev, bands, tally, what):
    """float32 DDIM-`steps` of `proc` (configuration `name`) on one device
    and split in k bands over [cuda:0] * k for each k of `bands`: each split
    within TILE_TOL of one device, the seam rows read on their own; one
    device's launches per_forward(name) x steps, each split's exactly k
    times them. Returns (the record, one device's image)."""
    one, s_one, c_one = _sp_run(proc.ddim_sampler(steps, clip_x0=True), x_T, lr)
    want = {k: n * steps for k, n in per_forward(name).items()}
    check(c_one == want, f"spatial {what} {name}: one device launched {c_one}, expected {want}")
    tally(c_one)
    rec = {"ddim_steps": steps, "one_device": {"seconds": s_one, "launches": _nonzero(c_one)}}
    for k in bands:
        spatial = spatial_sharding(make_mesh([process_device(dev.type)] * k))
        out, secs, counts = _sp_run(proc.ddim_sampler(steps, clip_x0=True, spatial=spatial),
                                    x_T, lr)
        err = float(np.abs(out - one).max())
        seam = float(np.abs(out[:, _sp_seam_rows(k)] - one[:, _sp_seam_rows(k)]).max())
        check(out.shape == one.shape and np.isfinite(out).all() and err <= TILE_TOL,
              f"spatial {what} {name}, {k} bands: differs from one device by {err} (seams {seam})")
        check(counts == {n: k * v for n, v in c_one.items()},
              f"spatial {what} {name}, {k} bands: launches {counts}, one device {c_one}")
        tally(counts)
        rec[f"bands_{k}"] = {
            "seconds": secs, "max_abs_diff": err, "seam_max_abs_diff": seam,
            "launches": _nonzero(counts), "launches_per_band_equal_one_device": True}
    return rec, one


def _sp_bf16(dev, config, steps, x_T, lr, tally, what):
    """bfloat16 DDIM-`steps` of the snapshot in `config`, one device and
    split in 2: the split finite with launches 2 x one device's; its
    distance from one device's image."""
    proc16 = _sp_process(dev, torch.bfloat16, config)
    spatial2 = spatial_sharding(make_mesh([process_device(dev.type)] * 2))
    b_one, bs_one, bc_one = _sp_run(proc16.ddim_sampler(steps, clip_x0=True), x_T, lr)
    b_two, bs_two, bc_two = _sp_run(
        proc16.ddim_sampler(steps, clip_x0=True, spatial=spatial2), x_T, lr)
    check(np.isfinite(b_two).all() and bc_two == {name: 2 * v for name, v in bc_one.items()},
          f"spatial {what}: bf16 {config} split finite {np.isfinite(b_two).all()}, launches "
          f"{bc_two}, one device {bc_one}")
    tally(bc_one)
    tally(bc_two)
    del proc16
    torch.cuda.empty_cache()
    return {"config": config, "ddim_steps": steps, "seconds_one_device": bs_one,
            "seconds_split": bs_two, "max_abs_diff": float(np.abs(b_two - b_one).max()),
            "seam_max_abs_diff": float(np.abs(b_two[:, _sp_seam_rows(2)]
                                              - b_one[:, _sp_seam_rows(2)]).max()),
            "launches_split": _nonzero(bc_two)}


def _sp_band_accumulators(proc, x_T, lr, spatial):
    """(h) One quantized forward split over `spatial` (a DDIM-1 call):
    INT8_BAND_SITE's int32 accumulators on band 1's quantized input (its
    extended rows) as the card computed them (torch._int_mm), against the
    exact plain product of the same int8 operands: equal bitwise."""
    sites, real_acc = proc.net.quant_sites, quant.conv_int8_acc
    current, captured = threading.local(), {}

    def amax(name, x, rows, top=False):
        current.name = name
        return type(sites).amax(sites, name, x, rows, top)

    def acc(xq, wq, stride=1, padding=0, lhs_dilation=1, matmul=quant.int8_matmul):
        out = real_acc(xq, wq, stride, padding, lhs_dilation, matmul)
        if (getattr(current, "name", None) == INT8_BAND_SITE
                and threading.current_thread().name == "band-1"):
            captured.setdefault("band1", (xq, wq, stride, padding, lhs_dilation, out))
        return out

    sites.amax, quant.conv_int8_acc = amax, acc
    try:
        proc.ddim_sampler(1, clip_x0=True, spatial=spatial)(x_T, lr)
        torch.cuda.synchronize()
    finally:
        del sites.amax
        quant.conv_int8_acc = real_acc
    check("band1" in captured, f"spatial (h): band 1 never reached {INT8_BAND_SITE}")
    xq, wq, stride, padding, dil, got = captured["band1"]
    plain = real_acc(xq.cpu(), wq.cpu(), stride, padding, dil, quant.int8_matmul_plain)
    check(got.dtype == torch.int32 and torch.equal(got.cpu(), plain),
          f"spatial (h): {INT8_BAND_SITE}'s accumulators on band 1 differ from the exact product")
    return {"site": INT8_BAND_SITE, "band": 1, "input_rows": int(xq.shape[1]),
            "M": int(got.numel() // got.shape[-1]), "K": int(wq[0].numel()),
            "N": int(wq.shape[0]), "bitwise_equal": True}


def _sp_int8(proc, x_T, lr, dev, tally):
    """(h) W8A8 on `proc` ('l1', float32): quantize_for_sampling on the image
    one device and split in 2 (CALIB_PROBES probes, the tap44 level and the
    dense branch), every scale within INT8_SCALE_RTOL and the calibration's
    launches 2 x; the quantized DDIM-SPATIAL_INT8_STEPS sampler split in 2
    against one device's (finite, launches 2 x, distance recorded); one
    site's accumulators on a band bitwise. The quant map is detached
    after."""
    spatial2 = spatial_sharding(make_mesh([process_device(dev.type)] * 2))
    x0 = upsample_bicubic(lr, 2)
    maps, secs, calib_counts = [], [], []
    for sp in (None, spatial2):
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        maps.append(quant.quantize_for_sampling(
            proc.net, proc.schedule.alpha_hat, x0, lr,
            torch.Generator(device=dev).manual_seed(SEED + 11), spatial=sp))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        calib_counts.append(read_counts())
    check(set(maps[0]) == set(maps[1]) and INT8_BAND_SITE in maps[0],
          f"spatial (h): the split calibrated {sorted(set(maps[1]) ^ set(maps[0]))} apart")
    rel = {k: abs(float(maps[1][k]) - float(v)) / float(v) for k, v in maps[0].items()}
    worst = max(rel, key=rel.get)
    check(rel[worst] <= INT8_SCALE_RTOL,
          f"spatial (h): scale {worst} split {float(maps[1][worst])}, one device "
          f"{float(maps[0][worst])}")
    check(calib_counts[1] == {n: 2 * v for n, v in calib_counts[0].items()},
          f"spatial (h): calibration launches {calib_counts[1]} split, {calib_counts[0]} one")
    tally(calib_counts[0])
    tally(calib_counts[1])
    quant.attach(proc.net, maps[0])
    try:
        one, s_one, c_one = _sp_run(proc.ddim_sampler(SPATIAL_INT8_STEPS, clip_x0=True), x_T, lr)
        two, s_two, c_two = _sp_run(
            proc.ddim_sampler(SPATIAL_INT8_STEPS, clip_x0=True, spatial=spatial2), x_T, lr)
        check(np.isfinite(two).all() and c_two == {n: 2 * v for n, v in c_one.items()},
              f"spatial (h): int8 split finite {np.isfinite(two).all()}, launches {c_two}, one "
              f"device {c_one}")
        tally(c_one)
        tally(c_two)
        accumulators = _sp_band_accumulators(proc, x_T, lr, spatial2)
    finally:
        quant.attach(proc.net, None)
    d = np.abs(two - one)
    return {"config": "l1", "sites": len(maps[0]), "scale_max_rel_diff": rel[worst],
            "scale_worst_site": worst, "calibration_seconds_one_device": secs[0],
            "calibration_seconds_split": secs[1], "ddim_steps": SPATIAL_INT8_STEPS,
            "seconds_one_device": s_one, "seconds_split": s_two,
            "max_abs_diff": float(d.max()),
            "seam_max_abs_diff": float(d[:, _sp_seam_rows(2)].max()),
            "share_beyond_1e-6": float((d > 1e-6).mean()),
            "launches_split": _nonzero(c_two), "accumulators": accumulators}


def _sp_band_kernels(dev):
    """(i) tap_conv, tap_conv_pair, tap_block at level 1 and packed_head
    against their plain versions at the shapes the bands of the 512-px
    image give them (k = 2 and 4: the stem chain's rows of the 256-row s2d
    grid, the level-1 chain's of the 128-row one, the head's), B = 1, in
    float32 and bfloat16, KERNEL_TOL."""
    shapes = {site: sorted(set().union(*(band_row_counts(site, rows, k) for k in SPATIAL_BANDS)))
              for site, rows in (("stem_s2d", SPATIAL_HR // 2), ("block_s2d", SPATIAL_HR // 4),
                                 ("head", SPATIAL_HR // 2))}
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    out = {"rows": shapes}
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        kt = model_with("tap", dev).prepare_s2d_kernels(dt)
        kp = model_with("packed", dev).prepare_s2d_kernels(dt)["packed_head"]
        kl1 = model_with("l1", dev).prepare_s2d_kernels(dt)["tap_block1"]

        def randn(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dt)

        errs = {k: {} for k in ("tap_conv", "tap_conv_pair", "tap_block_l1", "packed_head")}
        w = SPATIAL_HR // 2
        for r in shapes["stem_s2d"]:
            h, x = randn(1, r, w, 128), randn(1, r, w, 64)
            errs["tap_conv"][r] = max_err([tap_conv(h, kt["blk_conv2_44"])],
                                          [tap_conv_plain(h, kt["blk_conv2_44"])], dt,
                                          f"spatial (i) tap_conv {r} rows {dt}")
            errs["tap_conv_pair"][r] = max_err(
                list(tap_conv_pair(x, kt["blk_conv1_44"], kt["blk_skip_44"])),
                list(tap_conv_pair_plain(x, kt["blk_conv1_44"], kt["blk_skip_44"])), dt,
                f"spatial (i) tap_conv_pair {r} rows {dt}")
        for r in shapes["block_s2d"]:
            x1, te1 = randn(1, r, w // 2, 128), torch.relu(randn(1, 256))
            errs["tap_block_l1"][r] = max_err([tap_block(x1, te1, kl1)],
                                              [tap_block_plain(x1, te1, kl1)], dt,
                                              f"spatial (i) tap_block level 1 {r} rows {dt}")
        for r in shapes["head"]:
            hh, at = randn(1, r, w, 64), randn(1, r, w, 128)
            errs["packed_head"][r] = max_err([packed_head(hh, at, kp["up4"], kp["at"])],
                                             [packed_head_plain(hh, at, kp["up4"], kp["at"])], dt,
                                             f"spatial (i) packed_head {r} rows {dt}")
        torch.cuda.synchronize()
        out[name] = errs
    return out


def spatial_phase(dev, card):
    """The spatial phase: one whole x2 image (LR 256 -> HR 512, B = 1, the x2
    snapshot, 'stem', float32) with its height split into bands over
    [cuda:0] * k: (a) DDIM-100 split in 2 and 4 against one device within
    TILE_TOL, the seam rows read on their own; (b) the launches of every
    split k times one device's, exactly (each band launches what one device
    does); (c) the fused ancestral_update chain warm-started at
    SPATIAL_START_T split in 2 against one device; the update's band layout
    on the card, bitwise; (d) bfloat16 DDIM-100 split in 2: finite, its
    distance from one device's; (f) the SPATIAL_LEVELS configurations as (a)
    and (b) at SPATIAL_LEVEL_STEPS; (g) 'l1' in bfloat16 as (d); (h) int8 on
    'l1' (_sp_int8); (i) the four kernels of (f) at the bands' shapes; (e)
    two processes, gloo. One JSON line (with `card`); returns it and the
    phase's launches."""
    x_T, lr = _sp_inputs(dev)
    proc = _sp_process(dev)
    res, launches = {"hr": SPATIAL_HR, "batch": 1, "config": "stem"}, dict.fromkeys(KERNELS, 0)

    def tally(counts):
        for k, v in counts.items():
            launches[k] += v

    # (a) + (b): float32 DDIM-100, one device and split
    res["ddim100_float32"], one = _sp_splits(proc, "stem", DDIM_STEPS, x_T, lr, dev,
                                             SPATIAL_BANDS, tally, "(a)")
    # (c) the fused update's chain from the warm start, one device and 2 bands
    ah = float(proc.schedule.alpha_hat[SPATIAL_START_T])
    init = upsample_bicubic(lr, 2)
    x_w = (ah ** 0.5) * init + ((1.0 - ah) ** 0.5) * x_T
    gen = lambda: torch.Generator(device=dev).manual_seed(SEED + 10)  # noqa: E731
    f_one, fs_one, fc_one = _sp_run(
        proc.sampler(fused_update=True, start_t=SPATIAL_START_T), x_w, lr, generator=gen())
    spatial2 = spatial_sharding(make_mesh([process_device(dev.type)] * 2))
    f_two, fs_two, fc_two = _sp_run(
        proc.sampler(fused_update=True, start_t=SPATIAL_START_T, spatial=spatial2), x_w, lr,
        generator=gen())
    err = float(np.abs(f_two - f_one).max())
    check(np.isfinite(f_two).all() and err <= TILE_TOL,
          f"spatial (c): the fused chain split in 2 differs from one device by {err}")
    check(fc_one["ancestral_update"] == SPATIAL_START_T
          and fc_two == {name: 2 * v for name, v in fc_one.items()},
          f"spatial (c): launches {fc_two} split, {fc_one} on one device")
    tally(fc_one)
    tally(fc_two)
    res["fused_update_start_t250"] = {
        "seconds_one_device": fs_one, "seconds_bands_2": fs_two, "max_abs_diff": err,
        "seam_max_abs_diff": float(np.abs(f_two[:, _sp_seam_rows(2)]
                                          - f_one[:, _sp_seam_rows(2)]).max()),
        "launches_bands_2": _nonzero(fc_two), "band_layout": _sp_update_bands(dev)}
    # (d) bfloat16: the split finite, its distance from one device's
    res["ddim100_bfloat16_bands_2"] = _sp_bf16(dev, "stem", DDIM_STEPS, x_T, lr, tally, "(d)")
    # (f) the configurations whose kernels run inside a chain on an extended
    # band; (h) int8 on the 'l1' one
    res["levels_float32"] = {}
    for name in SPATIAL_LEVELS:
        proc_l = _sp_process(dev, config=name)
        res["levels_float32"][name], _ = _sp_splits(proc_l, name, SPATIAL_LEVEL_STEPS, x_T, lr,
                                                    dev, SPATIAL_BANDS, tally, "(f)")
        if name == "l1":
            res["int8_l1_bands_2"] = _sp_int8(proc_l, x_T, lr, dev, tally)
        del proc_l
        torch.cuda.empty_cache()
    # (g) one of them in bfloat16
    res["l1_bfloat16_bands_2"] = _sp_bf16(dev, "l1", SPATIAL_LEVEL_STEPS, x_T, lr, tally, "(g)")
    # (i) the four kernels at the bands' shapes
    res["band_shape_kernels"] = _sp_band_kernels(dev)
    # (e) two processes
    res["group_two_ranks"] = _sp_group(dev, x_T, lr, one)
    res["card"] = card
    return json.dumps(res), launches


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}



def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true", help="also run the profile phase")
    args = ap.parse_args()
    state = {}
    dev = torch.device("cuda")

    def device():
        check(torch.cuda.is_available(), "torch.cuda.is_available() is False: no CUDA card")
        # float32 comparisons below mean full float32: no TF32 anywhere
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        state["kind"] = torch.cuda.get_device_name(0)
        state["count"] = torch.cuda.device_count()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
        print(smi[0], flush=True)
        state["smi"] = smi[0]
        return (f"{state['kind']}, {state['count']} visible, torch {torch.__version__}, "
                f"CUDA {torch.version.cuda}")

    def build():
        sources = sorted({k[1][:-3] for k in KERNELS.values()})
        with ThreadPoolExecutor(len(sources)) as ex:
            built = dict(zip(sources, ex.map(cuda_build.build, sources)))
        return "\n".join(f"{name}: {b.seconds:.1f}s; " + " | ".join(ptxas_summary(b.log))
                         for name, b in built.items())

    def kernel():
        rows = {name: [] for name in KERNELS}
        sch = make_schedule("cosine", T_STEPS)
        packed_conv.launches = 0  # packed_conv's launches are this phase's
        for dt in (torch.bfloat16, torch.float32):
            peak = PEAK_BF16 if dt == torch.bfloat16 else PEAK_F32
            kf = model_with("fused", dev).prepare_s2d_kernels(dt)
            kt = model_with("tap", dev).prepare_s2d_kernels(dt)
            kp = model_with("packed", dev).prepare_s2d_kernels(dt)["packed_head"]
            m_l1 = model_with("l1", dev)
            kl1, kd1 = m_l1.prepare_s2d_kernels(dt)["tap_block1"], block1_dense_kernels(m_l1, dt)
            m_stem = model_with("stem", dev)
            ks = m_stem.prepare_s2d_kernels(dt)
            w_gate2 = build_gate_weights(m_stem.attention_blocks[2])  # the plain forward's gate 2
            mu = model_with("dense", dev, dt)  # the unfused modules, for the yardsticks
            kd = mu.prepare_s2d_kernels()
            # conv1 and skip as one cuDNN convolution: the pair's yardstick
            w_pair = torch.cat([kd["blk_conv1"], kd["blk_skip"]]).contiguous(
                memory_format=torch.channels_last)
            for B in (B_FLAG, 1):
                g = torch.Generator(device=dev).manual_seed(B)

                def randn(*shape):
                    return torch.randn(shape, generator=g, device=dev).to(dt)

                s = HR // 2
                x, te4 = randn(B, s, s, 64), torch.relu(randn(B, 128))
                xs, hs = randn(B, s, s, 128), randn(B, s, s, 64)
                xa, xb, te = randn(B, s, s, 128), randn(B, s, s, 64), torch.relu(randn(B, 64))
                xu, eu = randn(B, s, s, 12), randn(B, s, s, 12)
                x0, cond = randn(B, s, s, 12), randn(B, s, s, 64)
                h2 = randn(B, s, s, 128)
                # gates 0 and 1 of the s2d path: x at levels 2 and 1, g at half of it
                gates = [(randn(B, s // 2, s // 2, 128), randn(B, s // 4, s // 4, 128)),
                         (randn(B, s, s, 64), randn(B, s // 2, s // 2, 64))]
                gw = [ks["gate0"], ks["gate1"]]
                # level 1 in s2d: 32x32 s2d pixels, 4Ci=128 in, 4Co=256 out
                x1, te1 = randn(B, s // 2, s // 2, 128), torch.relu(randn(B, 256))
                hh, at = randn(B, s, s, 64), randn(B, s, s, 128)
                # packed_conv at its docstring's level-1 shapes, with bias
                convs = {ci: (randn(B, s, s, ci), (0.05 * randn(3, 3, ci, 64)).contiguous(),
                              randn(64)) for ci in (64, 192)}
                w_convs = {ci: hwio_to_oihw(k).contiguous(memory_format=torch.channels_last)
                           for ci, (_, k, _) in convs.items()}
                seed, step = draw_seed(g, dev), 750
                coefs = update_coefs(sch, step)
                calls = {
                    "tap_block": (lambda: tap_block(x, te4, kf["tap_block"]),
                                  lambda: tap_block_plain(x, te4, kf["tap_block"]),
                                  lambda: block_dense_s2d(x, te4, kd),
                                  lambda: block_bound(B, s, s, 64, 128, x.element_size(), peak)),
                    "att_head_block": (lambda: att_head_block(xs, hs, kf["att_fused"]),
                                       lambda: att_head_block_plain(xs, hs, kf["att_fused"]),
                                       lambda: att_unfused(mu, xs, hs, kd),
                                       lambda: att_bound(B, s, s, xs.element_size(), peak)),
                    "dec_block": (lambda: dec_block(xa, xb, te, kf["dec"]),
                                  lambda: dec_block_plain(xa, xb, te, kf["dec"]),
                                  lambda: dec_unfused(mu, xa, xb, te, kd),
                                  lambda: dec_bound(B, s, s, xa.element_size(), peak)),
                    "ancestral_update": (lambda: ancestral_update(xu, eu, coefs, seed, step),
                                         lambda: ancestral_update_plain(xu, eu, coefs, seed, step),
                                         lambda: update_unfused(sch, xu, eu, step, g),
                                         lambda: update_bound(xu.numel(), xu.element_size())),
                    "tap_stem_block": (
                        lambda: tap_stem_block(x0, cond, te4, ks["conv0_b"], ks["tap_stem"]),
                        lambda: tap_stem_block_plain(x0, cond, te4, ks["conv0_b"], ks["tap_stem"]),
                        lambda: stem_dense_s2d(x0, cond, te4, kd),
                        lambda: stem_bound(B, s, s, x0.element_size(), peak)),
                    "tap_conv": (lambda: tap_conv(h2, kt["blk_conv2_44"]),
                                 lambda: tap_conv_plain(h2, kt["blk_conv2_44"]),
                                 lambda: conv_nhwc(h2, kd["blk_conv2"], padding=1),
                                 lambda: conv_bound(B, s, s, 128, 128, h2.element_size(), peak)),
                    "tap_conv_pair": (
                        lambda: tap_conv_pair(x, kt["blk_conv1_44"], kt["blk_skip_44"]),
                        lambda: tap_conv_pair_plain(x, kt["blk_conv1_44"], kt["blk_skip_44"]),
                        lambda: conv_nhwc(x, w_pair, padding=1),
                        lambda: conv_bound(B, s, s, 64, 128, x.element_size(), peak, n=2)),
                    # one forward's two launches: gates 0 and 1
                    "fused_attention_gate": (
                        lambda: tuple(fused_attention_gate(a, b, w) for (a, b), w in zip(gates, gw)),
                        lambda: tuple(attention_gate_plain(a, b, w) for (a, b), w in zip(gates, gw)),
                        lambda: gates_unfused(mu, gates),
                        lambda: gate_bound(B, [(s // 4, s // 4, 128), (s // 2, s // 2, 64)],
                                           x.element_size(), peak)),
                    "packed_head": (lambda: packed_head(hh, at, kp["up4"], kp["at"]),
                                    lambda: packed_head_plain(hh, at, kp["up4"], kp["at"]),
                                    lambda: head_unfused(hh, at, kd),
                                    lambda: head_bound(B, s, s, hh.element_size(), peak)),
                    "packed_conv": (lambda: packed_conv(*convs[64]),
                                    lambda: packed_conv_plain(*convs[64]),
                                    lambda: conv_nhwc(convs[64][0], w_convs[64], convs[64][2],
                                                      padding=1),
                                    lambda: pconv_bound(B, s, s, 64, 64, hh.element_size(), peak)),
                }
                for name, (fn, plain, library, bound) in calls.items():
                    got, want = fn(), plain()
                    torch.cuda.synchronize()
                    single = isinstance(got, torch.Tensor)
                    err = max_err([got] if single else got, [want] if single else want, dt,
                                  f"{name} {dt} B={B}",
                                  UPDATE_TOL if name == "ancestral_update" else KERNEL_TOL)
                    row = {"dtype": str(dt).split(".")[-1], "B": B, "max_abs_err": err,
                           "ms": time_ms(fn)}
                    if B == B_FLAG and dt == torch.bfloat16:
                        differ = repeat_differ(fn, REPEAT_CALLS)
                        check(differ == 0, f"{name} {dt} B={B}: {differ} of {REPEAT_CALLS} calls "
                                           "differ bitwise from the first (a race)")
                        row["repeat_calls_bitwise_equal"] = REPEAT_CALLS
                    if B == B_FLAG:
                        row["plain_ms"] = time_ms(plain, reps=5)
                        row["library_ms"] = time_ms(library)
                        row["bound_ms"], row["bound_by"] = bound()
                    rows[name].append(row)
                # ancestral_update moves its bytes in less time than the host
                # takes to issue a call, so its `ms` (time_ms) reads the
                # host's issue rate: its device time, and its library's, read
                # with the issue taken out and the L2 cold
                up_row = rows["ancestral_update"][-1]
                up_row.update(device_readings(cold(
                    lambda xc, ec: ancestral_update(xc, ec, coefs, seed, step), xu, eu)))
                up_row.update({f"library_{k}": v for k, v in device_readings(cold(
                    lambda xc, ec: update_unfused(sch, xc, ec, step, g), xu, eu)).items()})
                gate_row = rows["fused_attention_gate"][-1]
                # the plain forward's gate 2 (C=32, x 2s x 2s), checked here
                x2, g2 = randn(B, 2 * s, 2 * s, 32), randn(B, s, s, 32)
                gate_row["gate2_max_abs_err"] = max_err(
                    [fused_attention_gate(x2, g2, w_gate2)], [attention_gate_plain(x2, g2, w_gate2)],
                    dt, f"fused_attention_gate gate 2 {dt} B={B}")
                gate_row["gate2_ms"] = time_ms(lambda: fused_attention_gate(x2, g2, w_gate2))
                # tap_block at level 1's shape (no skip conv), against the
                # cuDNN dense-s2d level-1 block
                tb_row = rows["tap_block"][-1]
                tb_row["l1_max_abs_err"] = max_err(
                    [tap_block(x1, te1, kl1)], [tap_block_plain(x1, te1, kl1)], dt,
                    f"tap_block level 1 {dt} B={B}")
                tb_row["l1_ms"] = time_ms(lambda: tap_block(x1, te1, kl1))
                # packed_conv 192->64 (the up-stage concat conv's shape)
                pc_row = rows["packed_conv"][-1]
                pc_row["c192_max_abs_err"] = max_err(
                    [packed_conv(*convs[192])], [packed_conv_plain(*convs[192])], dt,
                    f"packed_conv 192->64 {dt} B={B}")
                pc_row["c192_ms"] = time_ms(lambda: packed_conv(*convs[192]))
                if dt == torch.bfloat16:
                    # the device time of each launch of the wgmma kernels (at
                    # B=1 time_ms reads the host's issue rate, not the card)
                    pc_row["launch_ms"] = launch_ms(lambda: packed_conv(*convs[64]))
                    pc_row["c192_launch_ms"] = launch_ms(lambda: packed_conv(*convs[192]))
                    rows["packed_head"][-1]["launch_ms"] = launch_ms(
                        lambda: packed_head(hh, at, kp["up4"], kp["at"]))
                    rows["att_head_block"][-1]["launch_ms"] = launch_ms(
                        lambda: att_head_block(xs, hs, kf["att_fused"]))
                    gate_row["launch_ms"] = launch_ms(
                        lambda: tuple(fused_attention_gate(a, b, w) for (a, b), w in zip(gates, gw)))
                    tb_row["launch_ms"] = launch_ms(lambda: tap_block(x, te4, kf["tap_block"]))
                    tb_row["l1_launch_ms"] = launch_ms(lambda: tap_block(x1, te1, kl1))
                    rows["tap_stem_block"][-1]["launch_ms"] = launch_ms(
                        lambda: tap_stem_block(x0, cond, te4, ks["conv0_b"], ks["tap_stem"]))
                if B == B_FLAG and dt == torch.bfloat16:
                    # the seam probe: phase A over 1.5x the pixels (B=72),
                    # what a recomputed 10 x 34 halo costs in 64-pixel
                    # M-tiles, beside h's bytes written and read once at
                    # the HBM rate
                    bp = 3 * B // 2
                    xp, tp = randn(bp, s, s, 64), torch.relu(randn(bp, 128))
                    h_bytes = B * s * s * 128 * x.element_size()
                    tb_row["seam_probe"] = {
                        "B": bp, "launch_ms": launch_ms(lambda: tap_block(xp, tp, kf["tap_block"])),
                        "h_bytes": h_bytes, "h_write_read_ms_at_peak": 2e3 * h_bytes / PEAK_BYTES}
                    rows["tap_stem_block"][-1]["issued_gflop"] = (
                        block_flops(B, s, s, 64, 128)[1] + 2 * B * s * s * 48 * 64) / 1e9
                    # att_head_block's seam probe: its gate kernel at B=61,
                    # the (16 + 2)^2 / 16^2 = 1.27x pixels that a fused
                    # kernel's recomputed halo at 16 x 16 tiles would cost,
                    # beside attn_s's bytes written and read once at the HBM
                    # rate
                    ba = round(B * 18 * 18 / 256)
                    xq, hq = randn(ba, s, s, 128), randn(ba, s, s, 64)
                    attn_bytes = B * s * s * 128 * xs.element_size()
                    att_row = rows["att_head_block"][-1]
                    att_row["seam_probe"] = {
                        "B": ba, "launch_ms": launch_ms(lambda: att_head_block(xq, hq, kf["att_fused"])),
                        "attn_bytes": attn_bytes,
                        "attn_write_read_ms_at_peak": 2e3 * attn_bytes / PEAK_BYTES}
                    att_row["issued_gflop"] = att_issued_flops(B, s, s) / 1e9
                    gate_row["issued_gflop"] = (gate_issued_flops(B, s // 4, s // 4, 128)
                                                + gate_issued_flops(B, s // 2, s // 2, 64)) / 1e9
                    # cuDNN's layer-by-layer gates moved between calls (0.54-
                    # 1.35 ms on an H100 80GB HBM3): three more readings, and
                    # the spread of all four
                    reads = [time_ms(lambda: gates_unfused(mu, gates)) for _ in range(3)]
                    gate_row["library_ms_reads"] = [gate_row["library_ms"]] + reads
                    gate_row["library_ms_spread"] = max(reads + [gate_row["library_ms"]]) - min(
                        reads + [gate_row["library_ms"]])
                    tb_row["l1_issued_gflop"] = block_flops(B, s // 2, s // 2, 128, 256, False)[1] / 1e9
                if B == B_FLAG:
                    # both tap blocks and the stem on ragged images (tiles
                    # cut at the right and bottom edges), B=2
                    xr, ter = randn(2, 20, 36, 64), torch.relu(randn(2, 128))
                    x1r, te1r = randn(2, 12, 20, 128), torch.relu(randn(2, 256))
                    x0r, condr = randn(2, 20, 36, 12), randn(2, 20, 36, 64)
                    tb_row["ragged_max_abs_err"] = max_err(
                        [tap_block(xr, ter, kf["tap_block"])],
                        [tap_block_plain(xr, ter, kf["tap_block"])], dt, f"tap_block ragged {dt}")
                    tb_row["l1_ragged_max_abs_err"] = max_err(
                        [tap_block(x1r, te1r, kl1)], [tap_block_plain(x1r, te1r, kl1)], dt,
                        f"tap_block level 1 ragged {dt}")
                    rows["tap_stem_block"][-1]["ragged_max_abs_err"] = max_err(
                        [tap_stem_block(x0r, condr, ter, ks["conv0_b"], ks["tap_stem"])],
                        [tap_stem_block_plain(x0r, condr, ter, ks["conv0_b"], ks["tap_stem"])], dt,
                        f"tap_stem_block ragged {dt}")
                    # att_head_block on 20 x 36 (ragged M-tiles and 8 x 32
                    # tiles), the gate on a 10 x 18 gating grid (ragged 4 x 16
                    # items) at each width
                    xar, har = randn(2, 20, 36, 128), randn(2, 20, 36, 64)
                    rows["att_head_block"][-1]["ragged_max_abs_err"] = max_err(
                        [att_head_block(xar, har, kf["att_fused"])],
                        [att_head_block_plain(xar, har, kf["att_fused"])], dt,
                        f"att_head_block ragged {dt}")
                    for c, wc in ((32, w_gate2), (64, ks["gate1"]), (128, ks["gate0"])):
                        xgr, ggr = randn(2, 20, 36, c), randn(2, 10, 18, c)
                        gate_row[f"ragged_c{c}_max_abs_err"] = max_err(
                            [fused_attention_gate(xgr, ggr, wc)], [attention_gate_plain(xgr, ggr, wc)],
                            dt, f"fused_attention_gate ragged C={c} {dt}")
                    # packed_conv on 20 x 36 (ragged 8 x 32 tiles) at 64->64,
                    # 192->64 and Ci = 32 / Co = 48 (N = 64, K's columns
                    # 48-63 landing as zeros)
                    for ci, co in ((64, 64), (192, 64), (32, 48)):
                        pr = (randn(2, 20, 36, ci), (0.05 * randn(3, 3, ci, co)).contiguous(),
                              randn(co))
                        pc_row[f"ragged_{ci}_{co}_max_abs_err"] = max_err(
                            [packed_conv(*pr)], [packed_conv_plain(*pr)], dt,
                            f"packed_conv ragged {ci}->{co} {dt}")
                    # packed_head on 20 x 36 at the served widths, and at
                    # C2 = 144, which the shape dispatch (wgmma_takes) sends
                    # to the first design's kernel
                    ph_row = rows["packed_head"][-1]
                    ph_row["route"] = "wgmma" if wgmma_takes(64, 128, dt) else "first design"
                    for c2 in (128, 144):
                        k4r, k3r = ((kp["up4"], kp["at"]) if c2 == 128 else
                                    ((0.05 * randn(4, 4, 64, 12)).contiguous(),
                                     (0.05 * randn(3, 3, c2, 12)).contiguous()))
                        hr, ar = randn(2, 20, 36, 64), randn(2, 20, 36, c2)
                        ph_row[f"ragged_c2_{c2}_max_abs_err"] = max_err(
                            [packed_head(hr, ar, k4r, k3r)], [packed_head_plain(hr, ar, k4r, k3r)],
                            dt, f"packed_head ragged C2={c2} {dt}")
                        ph_row[f"ragged_c2_{c2}_route"] = (
                            "wgmma" if wgmma_takes(64, c2, dt) else "first design")
                    tb_row["l1_plain_ms"] = time_ms(lambda: tap_block_plain(x1, te1, kl1), reps=5)
                    tb_row["l1_library_ms"] = time_ms(lambda: block1_dense_s2d(x1, te1, kd1))
                    tb_row["l1_bound_ms"], tb_row["l1_bound_by"] = block_bound(
                        B, s // 2, s // 2, 128, 256, x1.element_size(), peak, skip=False)
                    tb_row["l1_dense_gflop"] = block_flops(B, s // 2, s // 2, 128, 256, False)[0] / 1e9
                    pc_row["c192_plain_ms"] = time_ms(lambda: packed_conv_plain(*convs[192]), reps=5)
                    pc_row["c192_library_ms"] = time_ms(
                        lambda: conv_nhwc(convs[192][0], w_convs[192], convs[192][2], padding=1))
                    pc_row["c192_bound_ms"], pc_row["c192_bound_by"] = pconv_bound(
                        B, s, s, 192, 64, hh.element_size(), peak)
                    pc_row["dense_gflop"] = pconv_flops(B, s, s, 64, 64) / 1e9
                    pc_row["c192_dense_gflop"] = pconv_flops(B, s, s, 192, 64) / 1e9
                    rows["packed_head"][-1]["dense_gflop"] = head_flops(B, s, s) / 1e9
                    for i, ((a, b), w) in enumerate(zip(gates, gw)):
                        gate_row[f"gate{i}_ms"] = time_ms(lambda: fused_attention_gate(a, b, w))
                        gate_row[f"gate{i}_library_ms"] = time_ms(
                            lambda: mu.attention_blocks[i](a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)))
                    rows["tap_block"][-1].update(zip(
                        ("dense_gflop", "issued_gflop"),
                        (f / 1e9 for f in block_flops(B, s, s, 64, 128))))
                    rows["att_head_block"][-1]["dense_gflop"] = att_flops(B, s, s) / 1e9
                    rows["dec_block"][-1]["dense_gflop"] = dec_flops(B, s, s) / 1e9
                    rows["tap_stem_block"][-1]["dense_gflop"] = stem_flops(B, s, s) / 1e9
                    rows["tap_conv"][-1]["dense_gflop"] = conv_flops(B, s, s, 128, 128) / 1e9
                    rows["tap_conv_pair"][-1]["dense_gflop"] = 2 * conv_flops(B, s, s, 64, 128) / 1e9
                    gate_row["dense_gflop"] = (gate_flops(B, s // 4, s // 4, 128)
                                               + gate_flops(B, s // 2, s // 2, 64)) / 1e9
                if B == B_FLAG and dt == torch.float32:
                    rows["ancestral_update"][-1].update(
                        check_update(sch, xu, eu, seed, step, g))
        rows.update(task_kernels())
        state["kernel_rows"] = rows
        state["packed_conv_launches"] = packed_conv.launches
        return json.dumps(rows)

    def task_kernels():
        """The shapes the SAR->NDVI and class-conditional models give the
        kernels (SHAPE_ROWS), each against its plain version at B=48 on
        their 64-px images (32 x 32 s2d pixels) and on a ragged B=2 image
        (20 x 36), bfloat16 and float32; at B=48 also the kernel's, the plain
        version's and the library's times and the bound, and in bfloat16
        each launch's device time and the kernel's and library's device ms
        (device_readings)."""
        rows = {name: [] for name in SHAPE_ROWS}
        for dt in (torch.bfloat16, torch.float32):
            peak = PEAK_BF16 if dt == torch.bfloat16 else PEAK_F32
            k_sar = model_with("stem", dev, variant="sar").prepare_s2d_kernels(dt)
            kp_sar = model_with("packed", dev, variant="sar").prepare_s2d_kernels(dt)["packed_head"]
            k_gen = model_with("stem", dev, variant="generation").prepare_s2d_kernels(dt)
            mu_sar = model_with("dense", dev, dt, variant="sar")
            mu_gen = model_with("dense", dev, dt, variant="generation")
            kd_sar, kd_gen = mu_sar.prepare_s2d_kernels(), mu_gen.prepare_s2d_kernels()
            s = TASK_HR // 2
            for B, (H, W) in ((B_FLAG, (s, s)), (2, (20, 36))):
                g = torch.Generator(device=dev).manual_seed(100 + B)

                def randn(*shape):
                    return torch.randn(shape, generator=g, device=dev).to(dt)

                xs4, cond, te4 = randn(B, H, W, 4), randn(B, H, W, 64), torch.relu(randn(B, 128))
                xs12 = randn(B, H, W, 12)
                xa, hs = randn(B, H, W, 128), randn(B, H, W, 64)
                xb, te = randn(B, H, W, 64), torch.relu(randn(B, 64))
                hh, at = randn(B, H, W, 64), randn(B, H, W, 128)
                n = xs4.element_size()
                calls = {
                    "tap_stem_block_cx4_4": (
                        lambda: tap_stem_block(xs4, cond, te4, k_sar["conv0_b"], k_sar["tap_stem"]),
                        lambda: tap_stem_block_plain(xs4, cond, te4, k_sar["conv0_b"],
                                                     k_sar["tap_stem"]),
                        lambda: stem_dense_s2d(xs4, cond, te4, kd_sar),
                        lambda: stem_bound(B, H, W, n, peak, CX4=4)),
                    "tap_stem_block_bias_only": (
                        lambda: tap_stem_block(xs12, None, te4, k_gen["conv0_b"], k_gen["tap_stem"]),
                        lambda: tap_stem_block_plain(xs12, None, te4, k_gen["conv0_b"],
                                                     k_gen["tap_stem"]),
                        lambda: stem_dense_s2d(xs12, None, te4, kd_gen),
                        lambda: stem_bound(B, H, W, n, peak, CX4=12, cond=False)),
                    "att_head_block_out4_4": (
                        lambda: att_head_block(xa, hs, k_sar["att_fused"]),
                        lambda: att_head_block_plain(xa, hs, k_sar["att_fused"]),
                        lambda: att_unfused(mu_sar, xa, hs, kd_sar),
                        lambda: att_bound(B, H, W, n, peak, out4=4)),
                    "dec_block_out4_4": (
                        lambda: dec_block(xa, xb, te, k_sar["dec"]),
                        lambda: dec_block_plain(xa, xb, te, k_sar["dec"]),
                        lambda: dec_unfused(mu_sar, xa, xb, te, kd_sar),
                        lambda: dec_bound(B, H, W, n, peak, out4=4)),
                    "packed_head_out4_4": (
                        lambda: packed_head(hh, at, kp_sar["up4"], kp_sar["at"]),
                        lambda: packed_head_plain(hh, at, kp_sar["up4"], kp_sar["at"]),
                        lambda: head_unfused(hh, at, kd_sar),
                        lambda: head_bound(B, H, W, n, peak, out4=4)),
                }
                for name, (fn, plain, library, bound) in calls.items():
                    got, want = fn(), plain()
                    torch.cuda.synchronize()
                    single = isinstance(got, torch.Tensor)
                    err = max_err([got] if single else got, [want] if single else want, dt,
                                  f"{name} {dt} B={B} {H}x{W}")
                    row = {"dtype": str(dt).split(".")[-1], "B": B, "H": H, "W": W,
                           "max_abs_err": err}
                    if B == B_FLAG:
                        row.update(ms=time_ms(fn), plain_ms=time_ms(plain, reps=5),
                                   library_ms=time_ms(library))
                        row["bound_ms"], row["bound_by"] = bound()
                        if dt == torch.bfloat16:
                            # at a quarter of the x2 pixels a call issues
                            # about as slowly as the card runs it: the
                            # device time of each launch, and the kernel's and
                            # the library's device ms with the issue taken out
                            row["launch_ms"] = launch_ms(fn)
                            row.update(device_readings(fn))
                            row.update({f"library_{k}": v
                                        for k, v in device_readings(library).items()})
                    rows[name].append(row)
            del mu_sar, mu_gen
        return rows

    def check_update(sch, x, eps, seed, step, g):
        """The generator and the noise of ancestral_update at the flagship
        state, float32: its words, the bits mode, the scalar tail and an
        unaligned base pointer, the moments and correlations of its noise,
        the last step."""
        n = x.numel()
        check(torch.equal(philox_bits(seed, step, n), philox_bits_plain(seed, step, n)),
              "ancestral_update: the kernel's Philox words differ from the plain version's")
        bits = torch.randint(-2**31, 2**31, (2, *x.shape), generator=g, device=dev,
                             dtype=torch.int64).to(torch.int32)
        coefs = update_coefs(sch, step)
        res = {"bits_equal": True, "bits_mode_err": max_err(
            [ancestral_update(x, eps, coefs, None, step, bits)],
            [ancestral_update_plain(x, eps, coefs, None, step, bits)],
            torch.float32, "ancestral_update bits mode", UPDATE_TOL)}
        # n % 4 = 3: wide quads then the scalar tail; one element off a
        # quad's 16 bytes: every quad scalar
        for key, (xv, ev) in {"tail_err": (x.reshape(-1)[:n - 1], eps.reshape(-1)[:n - 1]),
                              "offset_err": (x.reshape(-1)[1:], eps.reshape(-1)[1:])}.items():
            res[key] = max_err([ancestral_update(xv, ev, coefs, seed, step)],
                               [ancestral_update_plain(xv, ev, coefs, seed, step)],
                               torch.float32, f"ancestral_update {key}", UPDATE_TOL)
        # one replica's half of a split chunk, at its first quad: the whole
        # chunk's noise there, bit for bit, and the plain version's
        half, per = x.shape[0] // 2, x[0].numel()
        q0 = half * per // 4
        part = ancestral_update(x[half:], eps[half:], coefs, seed, step, quad0=q0)
        check(torch.equal(part, ancestral_update(x, eps, coefs, seed, step)[half:]),
              "ancestral_update: the half at its quad offset differs from the whole's half")
        check(torch.equal(philox_bits(seed, step, n - half * per, q0),
                          philox_bits_plain(seed, step, n - half * per, q0)),
              "ancestral_update: the kernel's Philox words at a quad offset differ")
        res["quad_offset_err"] = max_err(
            [part], [ancestral_update_plain(x[half:], eps[half:], coefs, seed, step, quad0=q0)],
            torch.float32, "ancestral_update quad offset", UPDATE_TOL)
        res["quad_offset_split_equal"] = True
        zero = torch.zeros_like(x)

        def noise(i):
            return ancestral_update(zero, zero, (0.0, 0.0, 1.0), seed, i).double().reshape(-1)

        def corr(a, b):
            return abs(torch.corrcoef(torch.stack([a, b]))[0, 1].item())

        z = noise(step)
        res["z_mean"], res["z_std"] = z.mean().item(), z.std().item()
        check(abs(res["z_mean"]) < Z_MOMENT_TOL and abs(res["z_std"] - 1.0) < Z_MOMENT_TOL,
              f"ancestral_update noise: mean {res['z_mean']}, std {res['z_std']}")
        q = z.reshape(-1, 4)
        res["z_corr"] = {
            "partners": corr(torch.cat([q[:, 0], q[:, 2]]), torch.cat([q[:, 1], q[:, 3]])),
            "partners_squared": corr(torch.cat([q[:, 0], q[:, 2]]) ** 2,
                                     torch.cat([q[:, 1], q[:, 3]]) ** 2),
            "pairs_of_a_quad": corr(q[:, 0], q[:, 2]),
            "neighbour_quads": max(corr(q[:-1, lane], q[1:, lane]) for lane in range(4)),
            "steps": corr(z, noise(step - 1))}
        check(max(res["z_corr"].values()) < Z_CORR_TOL,
              f"ancestral_update noise correlations {res['z_corr']}")
        ca, cb, cn = update_coefs(sch, 1)
        check(cn == 0.0 and torch.equal(ancestral_update(x, eps, (ca, cb, cn), seed, 1),
                                         ca * x - cb * eps),
              "ancestral_update at i == 1 is not ca*x - cb*eps")
        res["last_step_exact"] = True
        return res

    def golden():
        check(len(GOLDEN["values"]) > 0, "GOLDEN values missing")
        x, t, cond = (torch.from_numpy(a).to(dev) for a in golden_input())
        want = np.asarray(GOLDEN["values"], np.float64)
        errs = {}
        for name in GOLDEN_CONFIGS:
            before = read_counts()
            with torch.inference_mode():
                out = model_with(name, dev)(x, t, cond).cpu().numpy()
            out = out.astype(np.float64)
            ran = {k: v - before[k] for k, v in read_counts().items()}
            check(ran == per_forward(name), f"golden {name}: launches {ran}, expected {per_forward(name)}")
            got = out.reshape(-1)[::GOLDEN["stride"]]
            err = float(np.abs(got - want).max())
            abs_sum_err = abs(float(np.abs(out).sum()) - GOLDEN["abs_sum"]) / out.size
            check(err <= GOLDEN_TOL and abs_sum_err <= GOLDEN_TOL,
                  f"golden {name}: max|err| {err}, mean |abs| err {abs_sum_err}")
            errs[name] = err
        # the SAR->NDVI and class-conditional models (the latter with labels
        # and a CFG mask) against their own golden values
        for variant, gold, inputs in (("sar", GOLDEN_SAR, golden_input_sar),
                                      ("generation", GOLDEN_GEN, golden_input_gen)):
            x, t, cond, mask = (None if a is None else torch.from_numpy(a).to(dev)
                                for a in inputs())
            want = np.asarray(gold["values"], np.float64)
            for name in GOLDEN_TASK_CONFIGS:
                before = read_counts()
                with torch.inference_mode():
                    out = model_with(name, dev, variant=variant)(x, t, cond, mask)
                out = out.cpu().numpy().astype(np.float64)
                ran = {k: v - before[k] for k, v in read_counts().items()}
                check(ran == per_forward(name),
                      f"golden {variant} {name}: launches {ran}, expected {per_forward(name)}")
                err = float(np.abs(out.reshape(-1)[::gold["stride"]] - want).max())
                abs_sum_err = abs(float(np.abs(out).sum()) - gold["abs_sum"]) / out.size
                check(err <= GOLDEN_TOL and abs_sum_err <= GOLDEN_TOL,
                      f"golden {variant} {name}: max|err| {err}, mean |abs| err {abs_sum_err}")
                errs[f"{variant}_{name}"] = err
        return json.dumps(errs)

    def model():
        res = {}
        for dt in (torch.bfloat16, torch.float32):
            g = torch.Generator(device=dev).manual_seed(7)
            x = torch.randn((B_FLAG, HR, HR, 3), generator=g, device=dev)
            t = torch.randint(1, T_STEPS, (B_FLAG,), generator=g, device=dev).float()
            cond = torch.rand((B_FLAG, HR // 2, HR // 2, 3), generator=g, device=dev)
            outs = {}
            for name in ("dense",) + MODEL_CONFIGS:
                m = model_with(name, dev, dt)
                with torch.inference_mode():
                    outs[name] = m(x, t, cond, s2d_kernels=m.prepare_s2d_kernels())
                del m
            torch.cuda.synchronize()
            dense = outs["dense"]
            scale = max(1.0, dense.abs().max().item())
            r = {"scale": scale}
            for name in MODEL_CONFIGS:
                a = outs[name]
                check(a.shape == (B_FLAG, HR, HR, 3) and torch.isfinite(a).all().item(),
                      f"model {name} {dt}: bad output {tuple(a.shape)}")
                err = (a - dense).abs().max().item()
                check(err <= MODEL_TOL[dt] * scale,
                      f"model {dt}: max|{name} - dense| {err} > {MODEL_TOL[dt]} * {scale}")
                r[f"max_abs_diff_{name}"] = err
            res[str(dt).split(".")[-1]] = r
        # one DDIM-100 tile each, the fused and stem configurations against
        # the unfused one, float32, same noise
        tile = np.random.default_rng(SEED + 1).random((TILE_LR, TILE_LR, 3)).astype(np.float32)
        tiles = {}
        for name in ("block", "fused", "stem", "l1"):
            proc = make_process(model_with(name, dev), "cosine", T_STEPS, HR)
            agg = AggregationSampler(proc, patch_size=HR // 2, stride=HR // 4,
                                     magnification_factor=2, ddim_steps=DDIM_STEPS)
            tiles[name] = agg(tile, generator=torch.Generator(device=dev).manual_seed(3),
                              device=dev)
        for name in ("fused", "stem", "l1"):
            tile_err = float(np.abs(tiles[name] - tiles["block"]).max())
            check(tile_err <= TILE_TOL, f"DDIM-100 tile, {name} vs unfused: max|diff| {tile_err}")
            res[f"tile_ddim100_float32_max_abs_diff_{name}"] = tile_err
        # the SAR->NDVI and class-conditional models at B=48 on their 64-px
        # images (labels with half the CFG mask zero), each configuration
        # against dense-s2d
        for variant in ("sar", "generation"):
            for dt in (torch.bfloat16, torch.float32):
                g = torch.Generator(device=dev).manual_seed(8)
                c = 1 if variant == "sar" else 3
                x = torch.randn((B_FLAG, TASK_HR, TASK_HR, c), generator=g, device=dev)
                t = torch.randint(1, T_STEPS, (B_FLAG,), generator=g, device=dev).float()
                if variant == "sar":
                    cond, mask = torch.rand((B_FLAG, TASK_HR, TASK_HR, 2), generator=g, device=dev), None
                else:
                    cond = torch.randint(0, NUM_CLASSES, (B_FLAG,), generator=g, device=dev)
                    mask = (torch.arange(B_FLAG, device=dev) < B_FLAG // 2).float()
                outs = {}
                for name in ("dense",) + MODEL_TASK_CONFIGS:
                    m = model_with(name, dev, dt, variant)
                    with torch.inference_mode():
                        outs[name] = m(x, t, cond, mask, s2d_kernels=m.prepare_s2d_kernels())
                    del m
                torch.cuda.synchronize()
                dense = outs["dense"]
                scale = max(1.0, dense.abs().max().item())
                r = {"scale": scale}
                for name in MODEL_TASK_CONFIGS:
                    a = outs[name]
                    check(a.shape == (B_FLAG, TASK_HR, TASK_HR, c) and torch.isfinite(a).all().item(),
                          f"model {variant} {name} {dt}: bad output {tuple(a.shape)}")
                    err = (a - dense).abs().max().item()
                    check(err <= MODEL_TOL[dt] * scale,
                          f"model {variant} {dt}: max|{name} - dense| {err} > {MODEL_TOL[dt]} * {scale}")
                    r[f"max_abs_diff_{name}"] = err
                res[f"{variant}_{str(dt).split('.')[-1]}"] = r
        return json.dumps(res)

    def serve():
        rng = np.random.default_rng(SEED)
        lrs = [rng.random((HR // 2, HR // 2, 3)).astype(np.float32) for _ in range(4)]
        tile = rng.random((TILE_LR, TILE_LR, 3)).astype(np.float32)
        outputs = []

        def requests(server, secs):
            results = [None] * 4

            def one(i):
                results[i] = server.infer_batch([lrs[i]])[0]

            t0 = time.perf_counter()
            threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            secs["batch_4_requests_ddim100"] = time.perf_counter() - t0
            for r in results:
                check(r is not None and r.shape == (HR, HR, 3), "batch request unanswered or misshapen")
            outputs.extend(results)

        def timed(secs, key, fn):
            t0 = time.perf_counter()
            outputs.append(fn(tile))
            secs[key] = time.perf_counter() - t0

        def run_path(name, ddim_tiles):
            """4 concurrent DDIM-100 requests and `ddim_tiles` DDIM-100
            tiles. Every count is set to 0 just before and read just after,
            and must be exact."""
            ddim = InferenceServer(model_with(name, dev), "cosine", T_STEPS, HR,
                                   ddim_steps=DDIM_STEPS, dtype=torch.bfloat16, device="cuda")
            secs = {}
            try:
                torch.cuda.synchronize()
                zero_counts()
                requests(ddim, secs)
                for i in range(ddim_tiles):
                    timed(secs, f"tile_ddim100_{i}" if ddim_tiles > 1 else "tile_ddim100",
                          ddim.infer_tile)
                counts, batches = read_counts(), ddim.batches_run
            finally:
                ddim.shutdown()
            forwards = batches * DDIM_STEPS + N_CHUNKS * ddim_tiles * DDIM_STEPS
            want = {k: n * forwards for k, n in per_forward(name).items()}
            check(counts == want, f"{name} path: launches {counts}, expected {want}")
            return {"config": name, "variant": "superres", "micro_batches": batches,
                    "launches": counts, "seconds": secs}

        def concurrent(server, conds, secs, key, shape):
            """Every condition as its own request, all at once; each answer
            must come back with `shape`."""
            results = [None] * len(conds)

            def one(i):
                results[i] = server.infer_batch([conds[i]])[0]

            t0 = time.perf_counter()
            threads = [threading.Thread(target=one, args=(i,)) for i in range(len(conds))]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            secs[key] = time.perf_counter() - t0
            for r in results:
                check(r is not None and r.shape == shape, f"{key}: request unanswered or misshapen")
            outputs.extend(results)

        def refused(server, cond, what):
            try:
                server.infer_batch([cond])
            except ValueError as e:
                return str(e)
            raise RuntimeError(f"{what} was not refused")

        def task_path(variant, name, ddpm_fused, extra=None):
            """The SAR->NDVI or generation task served from a model of
            configuration `name`: 8 concurrent requests at DDIM-100 (max_batch
            8; generation with CFG 3, a model batch of 16), `extra(server,
            secs)` (a sampler call beyond the servers, returning its model
            forwards), and with `ddpm_fused` one request on a second server
            of the ancestral T=1500 chain with fused_update. Counts set to 0
            just before, exact just after; then a bad request refused."""
            model = model_with(name, dev, variant=variant)
            task = "sar" if variant == "sar" else "generation"
            c = 1 if variant == "sar" else 3
            mk = lambda **kw: InferenceServer(model, "cosine", T_STEPS, TASK_HR, task=task,  # noqa: E731
                                              max_batch=8, dtype=torch.bfloat16, device="cuda", **kw)
            ddim = mk(ddim_steps=DDIM_STEPS)
            servers, secs, more = [ddim], {}, 0
            rng_t = np.random.default_rng(SEED + 3)
            conds = ([rng_t.random((TASK_HR, TASK_HR, 2)).astype(np.float32) for _ in range(8)]
                     if task == "sar" else [int(v) for v in rng_t.integers(0, NUM_CLASSES, 8)])
            try:
                if ddpm_fused:
                    servers.append(mk(fused_update=True))
                torch.cuda.synchronize()
                zero_counts()
                concurrent(ddim, conds, secs, "batch_8_requests_ddim100", (TASK_HR, TASK_HR, c))
                if extra is not None:
                    more = extra(ddim, secs)
                if ddpm_fused:
                    t0 = time.perf_counter()
                    outputs.append(servers[1].infer_batch([conds[0]])[0])
                    secs["micro_batch_ddpm1500_fused_update"] = time.perf_counter() - t0
                counts = read_counts()
                bad = (refused(ddim, np.zeros((TASK_HR // 2, TASK_HR, 2), np.float32), "a bad SAR shape")
                       if task == "sar" else refused(ddim, NUM_CLASSES, "a label out of range"))
            finally:
                for server in servers:
                    server.shutdown()
            ddpm_batches = servers[1].batches_run if ddpm_fused else 0
            forwards = ddim.batches_run * DDIM_STEPS + more + ddpm_batches * (T_STEPS - 1)
            want = {k: n * forwards for k, n in per_forward(name).items()}
            want["ancestral_update"] = ddpm_batches * (T_STEPS - 1)
            check(counts == want, f"{variant} {name} path: launches {counts}, expected {want}")
            return {"config": name, "variant": variant, "micro_batches": ddim.batches_run,
                    "ddpm_micro_batches": ddpm_batches, "launches": counts, "seconds": secs,
                    "refused": bad}

        def eta_quadratic(server, secs):
            """One generation call through DiffusionProcess.sample: DDIM-100
            at eta 0.5 on the quadratic subsequence, CFG 3; its forwards."""
            labels = np.arange(8) % NUM_CLASSES
            t0 = time.perf_counter()
            out = server.process.sample(8, cond=labels, cfg_scale=CFG, ddim_steps=DDIM_STEPS,
                                        ddim_eta=0.5, ddim_spacing="quadratic",
                                        generator=torch.Generator(device=dev).manual_seed(9))
            out = out.clamp(0.0, 1.0).cpu().numpy()
            secs["sample_ddim100_eta05_quadratic"] = time.perf_counter() - t0
            outputs.extend(list(out))
            return len(ddim_timesteps(T_STEPS, DDIM_STEPS, "quadratic"))

        def start_t_path():
            """x2 with start_t=250: one DDIM-100 micro-batch from the bicubic
            warm start (DDIM's subsequence squeezed into [1, 250])."""
            server = InferenceServer(model_with("block", dev), "cosine", T_STEPS, HR,
                                     ddim_steps=DDIM_STEPS, start_t=250, dtype=torch.bfloat16,
                                     device="cuda")
            secs = {}
            try:
                torch.cuda.synchronize()
                zero_counts()
                t0 = time.perf_counter()
                outputs.append(server.infer_batch([lrs[0]])[0])
                secs["micro_batch_ddim100_start_t250"] = time.perf_counter() - t0
                counts = read_counts()
            finally:
                server.shutdown()
            forwards = server.batches_run * len(ddim_timesteps(T_STEPS, DDIM_STEPS, start_t=250))
            want = {k: n * forwards for k, n in per_forward("block").items()}
            check(counts == want, f"start_t path: launches {counts}, expected {want}")
            return {"config": "block", "variant": "superres", "start_t": 250,
                    "micro_batches": server.batches_run, "launches": counts, "seconds": secs}

        # the T=1500 tiles of these paths were cut to keep the script's
        # time (packed's once the quality phase came, the others' once the
        # cli phase came): the quality phase's T=1500 passes run the
        # unfused sampler and the fused update on 48-patch chunks
        paths = {"unfused": run_path("block", 2),
                 "fused": run_path("fused", 1),
                 "stem": run_path("stem", 1),
                 "tap": run_path("tap", 1),
                 "packed": run_path("packed", 1),
                 "l1": run_path("l1", 1),
                 "x2_start_t": start_t_path(),
                 "sar": task_path("sar", "stem", True),
                 "sar_packed": task_path("sar", "packed", False),
                 "generation": task_path("generation", "stem", True, eta_quadratic)}
        for out in outputs:
            check(out.shape in ((HR, HR, 3), (2 * TILE_LR, 2 * TILE_LR, 3), (TASK_HR, TASK_HR, 1),
                                (TASK_HR, TASK_HR, 3)), f"shape {out.shape}")
            check(np.isfinite(out).all() and out.min() >= 0.0 and out.max() <= 1.0, "output range")
        launches = dict.fromkeys(list(KERNELS) + list(SHAPE_ROWS), 0)
        for p in paths.values():
            for k, n in p["launches"].items():
                launches[row_of(k, p["variant"])] += n
        state["launches"] = launches
        return json.dumps(paths)

    def checkpoint():
        """The Orbax step (_orbax_step: the package probe, and with
        tensorstore a flagship trainer's Orbax saves, keep-one and resume);
        save_snapshot of init_params(SEED)'s model into a temporary
        directory, load_snapshot back (the same weights), a server from it:
        one bfloat16 forward bitwise equal to the original model's, and one
        served micro-batch."""
        src = model_with("block", dev)
        with tempfile.TemporaryDirectory() as d:
            orbax = _orbax_step(dev, d)
            path = os.path.join(d, "snapshot.msgpack")
            save_snapshot(path, src, 7)
            size = os.path.getsize(path)
            state, epochs = load_snapshot(path)
            check(epochs == 7, f"checkpoint: EPOCHS_RUN {epochs} != 7")
            want = init_params(SEED, device="cpu")
            check(state.keys() == want.keys() and all(torch.equal(state[k], want[k]) for k in want),
                  "checkpoint: the weights loaded back differ from the weights saved")
            server = InferenceServer.from_snapshot(path, "cosine", T_STEPS, HR,
                                                   model_flags=CONFIGS["block"],
                                                   ddim_steps=DDIM_STEPS, dtype=torch.bfloat16,
                                                   device="cuda")
        try:
            g = torch.Generator(device=dev).manual_seed(5)
            x = torch.randn((2, HR // 2, HR // 2, 12), generator=g, device=dev)  # s2d state
            t = torch.full((2,), 750.0, device=dev)
            cond = torch.rand((2, HR // 2, HR // 2, 3), generator=g, device=dev)
            procs = {"original": make_process(src, "cosine", T_STEPS, HR, dtype=torch.bfloat16),
                     "loaded": server.process}
            with torch.inference_mode():
                outs = {k: [p.apply_fn(x, t, None, p.encode_cond_fn(cond), p.kernels)
                            for _ in range(2)] for k, p in procs.items()}
            a, b = outs["original"], outs["loaded"]
            check(torch.equal(a[0], a[1]), "checkpoint: two bf16 forwards of one model differ")
            check(torch.equal(a[0], b[0]) and torch.equal(b[0], b[1]),
                  "checkpoint: the loaded model's bf16 forward is not the original's")
            lr = np.random.default_rng(SEED + 2).random((HR // 2, HR // 2, 3)).astype(np.float32)
            out = server.infer_batch([lr])[0]
            check(out.shape == (HR, HR, 3) and np.isfinite(out).all() and out.min() >= 0.0
                  and out.max() <= 1.0, f"checkpoint: served output {out.shape} out of range")
        finally:
            server.shutdown()
        return json.dumps({"snapshot_bytes": size, "epochs_run": epochs,
                           "forward_bitwise_equal": True, "micro_batches": server.batches_run,
                           **orbax})

    def quality():
        lines, launches = quality_phase(dev, state["smi"], QUALITY_DRAWS)
        for k, n in launches.items():
            state["launches"][row_of(k, "superres")] += n
        return lines

    def cli_():
        lines, launches = cli_phase(dev, state["smi"])
        for k, n in launches.items():
            state["launches"][row_of(k, "superres")] += n
        return lines

    def profile():
        lines = []
        for name in ("block", "fused", "stem", "tap", "packed", "l1"):
            proc = make_process(model_with(name, dev), "cosine", T_STEPS, HR, dtype=torch.bfloat16)
            with torch.inference_mode():
                lines += [json.dumps({"config": name, **profile_forward(proc, b, dev)})
                          for b in (B_FLAG, 1)]
        lines += [json.dumps(profile_train_step(dev, s)) for s in (False, True)]
        return "\n".join(lines)

    phase("device", device)
    phase("build", build)
    phase("kernel", kernel)
    phase("golden", golden)
    phase("model", model)
    phase("serve", serve)
    phase("checkpoint", checkpoint)
    phase("quality", quality)
    phase("cli", cli_)

    def helpers():
        line, launches = helpers_phase(dev, state["smi"])
        for k, n in launches.items():
            state["launches"][k] += n
        return line

    phase("helpers", helpers)

    def task_quality():
        lines, launches = task_quality_phase(dev, state["smi"])
        for k, n in launches.items():
            state["launches"][k] += n
        return lines

    phase("task_quality", task_quality)
    phase("train", lambda: train_phase(dev, state["smi"]))

    def parallel():
        line, launches = parallel_phase(dev, state["smi"])
        for k, n in launches.items():
            state["launches"][row_of(k, "superres")] += n
        return line

    phase("parallel", parallel)

    def spatial():
        line, launches = spatial_phase(dev, state["smi"])
        for k, n in launches.items():
            state["launches"][row_of(k, "superres")] += n
        return line

    phase("spatial", spatial)
    if args.profile:
        phase("profile", profile)

    # packed_conv is on no path: its launches are the kernel phase's
    state["launches"]["packed_conv"] = state["packed_conv_launches"]
    kernels = []
    for name in list(KERNELS) + list(SHAPE_ROWS):
        _, src, replaces, dt = KERNELS[SHAPE_ROWS[name][0] if name in SHAPE_ROWS else name]
        flag = next(r for r in state["kernel_rows"][name]
                    if r["dtype"] == str(dt).split(".")[-1] and r["B"] == B_FLAG)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"diffusionremotesensing_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": state["launches"][name],
            "max_abs_err": flag["max_abs_err"],
            "ms": flag["ms"],
            "plain_ms": flag["plain_ms"],
            "bound_ms": flag["bound_ms"],
            "bound_by": flag["bound_by"],
            "library_ms": flag["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": state["kind"],
                                             "count": state["count"]}}), flush=True)


if __name__ == "__main__":
    main()
