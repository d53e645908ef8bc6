"""The port's command line (port of ``diffusionremotesensing_tpu/cli.py`` and
of the reference package's entry-point scripts):

    python -m diffusionremotesensing_tpu_torch.cli COMMAND [flags]

with COMMAND one of ``superres`` (the reference's
train_diffusion_superres.py), ``sar_to_ndvi`` (train_diffusion_SAR_TO_NDVI.py),
``generation`` (generate_new_imgs/train_diffusion_generation.py),
``aggregation`` (Aggregation_Sampling.py) and ``serve`` (serve.py).

Each subcommand takes its script's flags, letter for letter and with the
same defaults (this module keeps its own copy of the parsers: the scripts
import JAX), derives the same paths (``models_run/<model_name>/weights``;
``generation`` keeps its script's ``../`` paths, as it is run from a
subdirectory), and runs the port's launcher: :func:`launch_superres`,
:func:`launch_sar_to_ndvi`, :func:`launch_generation`,
:func:`launch_aggregation` or :func:`launch_serving` (:func:`build_server`
builds the server without blocking). ``main(argv)`` runs in-process.

Where the port differs from the reference package:

* **Devices.** ``--device`` (aggregation, serve) defaults to ``cuda`` and
  goes through ``utils.resolve_device``, which raises where no card is
  visible: there is no fallback to another device. The trainers, which have
  no ``--device`` flag, run on the card unless ``DRS_FORCE_CPU=1`` asks for
  the CPU (``utils.default_device``).
* **``--tap44 auto``** is ``'block'`` on the card and off on the CPU (the
  reference: its kernel on a TPU, off elsewhere); ``off``, ``conv2``,
  ``full``, ``block``, ``stem`` and ``l1`` are the model's ``tap44`` levels
  False, 'conv2', True, 'block', 'stem' and 'l1'. No kernel flag is demoted
  on another device: on the CPU every kernel's plain version runs.
* **LR images** load through the port's PNG codec (other formats through
  PIL); a non-square image is squarified by Pillow's bicubic resize
  (``data.datasets.pil_resize_u8``, bit-equal), after a grey image is read
  and before it is made RGB, as PIL's resize then ``convert("RGB")`` do (an
  RGBA image loses its alpha before the resize, where Pillow resamples it
  premultiplied).
* **Noise.** The aggregation launcher draws image i's noise from
  :func:`aggregation_generator` (a ``torch.Generator`` on the device seeded
  with i; a single image is image 0); W8A8 calibration draws from a
  generator seeded 21 (aggregation) or 33 (serve), where the reference
  folds the keys of the same numbers.
* **Data parallelism** (``parallel/``). ``--multiple_gpus`` on the
  trainers runs one process per device as the reference's DDP did: start
  them with ``torchrun --nproc_per_node=N -m diffusionremotesensing_tpu_torch.cli
  superres --multiple_gpus ...``; each joins the group (NCCL on the card,
  gloo with ``DRS_FORCE_CPU=1``), loads its shard (``_process_shard``) and
  trains on its device, and rank 0 alone writes (``is_main_process``). On
  ``aggregation`` it splits each chunk's patches over the mesh: the cards of
  this process, or the ranks of a torchrun group, whose tiles rank 0 writes.
  ``--data_parallel`` on ``serve`` splits every micro-batch over the cards of
  the process (``--device``'s type), collective-free.
* **Snapshots.** ``--checkpoint_backend orbax`` writes the reference
  package's Orbax checkpoint directory through ``tensorstore``
  (``io.OrbaxSnapshotter``; no orbax, no JAX), in the background; msgpack
  (the default) needs no package beyond torch and numpy.
* **Float32** is IEEE float32: the aggregation launcher, the trainers of a
  float32 model and a float32 server turn cuDNN's TF32 off
  (``utils.ieee_float32``); bfloat16 runs are left as they are.
* ``DRS_TRAIN_SEED`` seeds the trainers' initial weights (torch's default
  initialisation drawn under that seed) and their noise, as in the
  reference.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from diffusionremotesensing_tpu_torch.parallel.sharding import is_main_process
from diffusionremotesensing_tpu_torch.utils import default_device, ieee_float32, resolve_device

# --tap44 spellings -> the model's tap44 level (models.unet.TAP44_LEVELS)
TAP44_SPELLINGS = {"off": False, "conv2": "conv2", "full": True, "block": "block",
                   "stem": "stem", "l1": "l1"}
TAP44_CHOICES = ["auto", *TAP44_SPELLINGS]


def str2bool(v: str) -> bool:
    """The reference CLI's boolean convention."""
    return str(v).lower() in ("yes", "true", "t", "1")


# the model_name registry convention (superres_and_NDVIgen.py:20-30)
def parse_magnification(model_name: str) -> int:
    return int([p[13:] for p in model_name.split("_") if p.startswith("magnification")][0])


def parse_lr_imgsize(model_name: str) -> int:
    return int([p[9:] for p in model_name.split("_") if p.startswith("LRimgsize")][0])


def parse_imgsize(model_name: str) -> int:
    return int([p[7:] for p in model_name.split("_") if p.startswith("imgsize")][0])


def resolve_tap44(name: Optional[str], device: torch.device):
    """A ``--tap44`` spelling -> the model's tap44 level; 'auto' (or none)
    is 'block' on a CUDA device and off elsewhere."""
    if not name or name == "auto":
        return "block" if device.type == "cuda" else False
    if name not in TAP44_SPELLINGS:
        raise ValueError(f"unknown tap44 level {name!r}; valid: {', '.join(TAP44_CHOICES)}")
    return TAP44_SPELLINGS[name]


def _process_shard():
    """(number of dataset shards, this process's shard): the process group's
    (world size, rank), (1, 0) in one process (DistributedSampler parity:
    each rank loads a disjoint shard)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _make_mesh_if(multiple: bool, device: torch.device):
    """--multiple_gpus: join torchrun's group when there is one (NCCL for the
    card, gloo for the CPU) and return the mesh of this process's devices
    of ``device``'s type; else None."""
    if not multiple:
        return None
    from diffusionremotesensing_tpu_torch.parallel.sharding import (
        initialize_distributed,
        local_devices,
        make_mesh,
    )

    initialize_distributed(device.type)
    return make_mesh(local_devices(device.type))


def _check_unet_type(name: Optional[str]) -> None:
    """Only the Residual Attention UNet exists (the reference's two MultiHead
    variants are unfinished there)."""
    known = "residual attention unet"
    if (name or known).lower() != known:
        raise ValueError("The UNet type must be Residual Attention UNet (MultiHead variants "
                         "are work-in-progress in the reference and not implemented)")
    print("Using Residual Attention UNet")


def _train_seed(default: int = 0) -> int:
    """DRS_TRAIN_SEED overrides the training seed (initial weights, the
    trainer's noise and shuffle streams)."""
    return int(os.environ.get("DRS_TRAIN_SEED", default))


def _model_dtype(args) -> Optional[torch.dtype]:
    """--compute_dtype -> the model's compute dtype (parameters stay float32)."""
    return torch.bfloat16 if getattr(args, "compute_dtype", "float32") == "bfloat16" else None


def _seeded(factory, seed: int):
    """``factory()`` with torch's default initialisation drawn under ``seed``
    (the global generator's state is restored after)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return factory()


def _decode_cache(args):
    """One DecodedCache shared by the train and validation datasets, so that
    --decode_cache_mb bounds the total."""
    mb = getattr(args, "decode_cache_mb", 0.0)
    if not mb:
        return None
    from diffusionremotesensing_tpu_torch.data.datasets import DecodedCache

    return DecodedCache(mb)


def _load_vgg(args):
    """--vgg19_weights: torchvision's vgg19 (or its ``features``) state_dict."""
    path = getattr(args, "vgg19_weights", None)
    if not path:
        return None
    from diffusionremotesensing_tpu_torch.losses import VGG19Features, vgg19_features_state

    state = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    vgg = VGG19Features()
    vgg.load_state_dict(vgg19_features_state(state))
    return vgg


def _check_train_flags(args) -> None:
    if getattr(args, "checkpoint_backend", "msgpack") == "orbax":
        from diffusionremotesensing_tpu_torch.io import require_tensorstore

        require_tensorstore()  # before any data is read
    # before the loaders: the group gives each rank its shard
    args.mesh = _make_mesh_if(args.multiple_gpus, resolve_device(default_device()))


def _build_trainer(model, args, image_size, label_dropout=0.0, batch_transform=None):
    from diffusionremotesensing_tpu_torch.train import Trainer

    return Trainer(
        model,
        noise_schedule=args.noise_schedule,
        noise_steps=args.noise_steps,
        image_size=image_size,
        snapshot_path=os.path.join(args.snapshot_folder_path, args.snapshot_name),
        lr=args.lr,
        loss=args.loss,
        ema_smoothing=args.ema_smoothing,
        label_dropout=label_dropout,
        vgg=_load_vgg(args),
        allow_random_vgg=getattr(args, "allow_random_vgg", False),
        batch_transform=batch_transform,
        checkpoint_backend=getattr(args, "checkpoint_backend", "msgpack"),
        steps_per_dispatch=getattr(args, "steps_per_dispatch", 1),
        seed=_train_seed(),
        mesh=getattr(args, "mesh", None),
        device=resolve_device(default_device()),
    )


def _to_numpy(x):
    return x.detach().float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _export_denoising_video(frames, results_dir: str) -> None:
    """The first sample's denoising trajectory as video_denoising.mp4 (fps 100)."""
    from diffusionremotesensing_tpu_torch.utils import video_maker

    if not is_main_process():
        return
    video_maker([f[0] for f in _to_numpy(frames)],
                os.path.join(results_dir, "video_denoising.mp4"), fps=100)


def _sample(trainer, state, n, cond, generate_video, results_dir, **kw):
    """The final figure's samples (and, with --generate_video, the video)."""
    if generate_video:
        out, frames = trainer.sample(state, n=n, cond=cond, capture_frames=True, **kw)
        _export_denoising_video(frames, results_dir)
        return _to_numpy(out)
    return _to_numpy(trainer.sample(state, n=n, cond=cond, **kw))


def _results_dir(model_name: str, snapshot_folder_path: Optional[str] = None) -> str:
    """models_run/<name>/results beside the weights folder."""
    if snapshot_folder_path:
        d = os.path.join(os.path.dirname(snapshot_folder_path), "results")
    else:
        d = os.path.join(os.curdir, "models_run", model_name, "results")
    os.makedirs(d, exist_ok=True)
    return d


def _train(trainer, state, args, train_loader, val_loader, on_preview):
    from diffusionremotesensing_tpu_torch.profiling import trace

    with trace(getattr(args, "profile_dir", None)):
        return trainer.train(state, epochs=args.epochs, train_loader=train_loader,
                             val_loader=val_loader, check_preds_epoch=args.check_preds_epoch,
                             patience=args.patience, on_preview=on_preview)


def _loader(ds, args):
    from diffusionremotesensing_tpu_torch.data.loader import DataLoader

    n_shards, shard_idx = _process_shard()
    return DataLoader(ds, args.batch_size, shuffle=True, num_workers=getattr(args, "num_workers", 0),
                      num_shards=n_shards, shard_index=shard_idx)


# --------------------------------------------------------------- superres


def launch_superres(args) -> None:
    """train_diffusion_superres: DownBlur, DownBlurNoise or BSRGAN pairs,
    previews every check_preds_epoch epochs and a final figure."""
    _check_unet_type(getattr(args, "UNet_type", None))
    _check_train_flags(args)
    from diffusionremotesensing_tpu_torch.data.datasets import (
        SuperresBSRGANDataset,
        SuperresDownBlurDataset,
    )
    from diffusionremotesensing_tpu_torch.models.unet import (
        param_count,
        residual_attention_unet_superres,
    )
    from diffusionremotesensing_tpu_torch.utils import save_preview_grid

    blur_radius = args.Blur_radius
    if str(blur_radius).lower() != "random":
        blur_radius = float(blur_radius)
        print("Using a blur radius of ", blur_radius)
    else:
        print("Using random blur radius from a triangular distribution")
    print(f"Using {args.Degradation_type} degradation")
    print("Using EMA smoothing" if args.ema_smoothing else "Not using EMA smoothing")

    os.makedirs(args.snapshot_folder_path, exist_ok=True)
    results_dir = _results_dir(args.model_name, args.snapshot_folder_path)
    deg = args.Degradation_type.lower()
    train_path = f"{args.dataset_path}/train_original"
    valid_path = f"{args.dataset_path}/val_original"
    batch_transform = None
    if deg in ("downblur", "downblurnoise"):
        if args.image_size % args.magnification_factor != 0:
            raise ValueError("The image size must be a multiple of the magnification factor")
        noise = deg == "downblurnoise"
        cache = _decode_cache(args)
        if getattr(args, "device_degradation", False):
            # the host decodes; the DownBlur runs batched on the device
            if noise:
                raise ValueError("--device_degradation supports Degradation_type DownBlur "
                                 "(DownBlurNoise draws per-item host RNG)")
            from diffusionremotesensing_tpu_torch.data.datasets import DecodeOnlyDataset
            from diffusionremotesensing_tpu_torch.data.degradations import _Rng
            from diffusionremotesensing_tpu_torch.data.device_degradation import (
                make_downblur_transform,
            )

            if str(blur_radius).lower() == "random":
                # the draw SuperresDownBlurDataset(seed=0) freezes
                blur_radius = _Rng(0).py.triangular(0.5, 1.5, 1)
            train_ds = DecodeOnlyDataset(train_path, args.image_size, cache=cache)
            val_ds = DecodeOnlyDataset(valid_path, args.image_size, cache=cache)
            batch_transform = make_downblur_transform(args.image_size, args.magnification_factor,
                                                      float(blur_radius))
        else:
            train_ds = SuperresDownBlurDataset(train_path, args.magnification_factor, blur_radius,
                                               noise, "PIL", args.image_size, cache=cache)
            val_ds = SuperresDownBlurDataset(valid_path, args.magnification_factor, blur_radius,
                                             noise, "PIL", args.image_size, cache=cache)
    elif deg == "bsrgan":
        kw = dict(num_crops=args.num_crops, degradation_type="BSR_plus",
                  num_workers=getattr(args, "num_workers", 0))
        train_ds = SuperresBSRGANDataset(
            train_path, args.magnification_factor, args.image_size,
            destination_folder=os.path.join(args.dataset_path + "_Dataset", "train"), **kw)
        val_ds = SuperresBSRGANDataset(
            valid_path, args.magnification_factor, args.image_size,
            destination_folder=os.path.join(args.dataset_path + "_Dataset", "val"), **kw)
    else:
        raise ValueError("The degradation type must be either BSRGAN or DownBlur or DownBlurNoise")

    # in BSRGAN mode image_size is the LR patch size, so the HR patches are
    # image_size * magnification_factor
    hr_size = args.image_size * args.magnification_factor if deg == "bsrgan" else args.image_size
    train_loader, val_loader = _loader(train_ds, args), _loader(val_ds, args)

    s2d_train = getattr(args, "s2d_train", False)
    model = _seeded(lambda: residual_attention_unet_superres(
        image_channels=args.inp_out_channels, out_dim=args.inp_out_channels,
        magnification_factor=args.magnification_factor, compute_dtype=_model_dtype(args),
        s2d=s2d_train, s2d_train=s2d_train), _train_seed())
    trainer = _build_trainer(model, args, hr_size, batch_transform=batch_transform)
    state = trainer.maybe_resume(trainer.init_state())
    print("Num params: ", param_count(state.model))

    def _xy_items(ds, n):
        """The first n (x, cond) pairs; with the on-device DownBlur the
        dataset yields uint8 images and the transform derives both."""
        items = [ds[i] for i in range(min(n, len(ds)))]
        if batch_transform is not None and "hr_u8" in items[0]:
            hr = torch.from_numpy(np.stack([it["hr_u8"] for it in items])).to(trainer.device)
            out = batch_transform({"hr_u8": hr})
            return [{"x": _to_numpy(out["x"][i]), "cond": _to_numpy(out["cond"][i])}
                    for i in range(len(items))]
        return items

    titles = ["Low resolution image", "High resolution image", "Super resolution image"]

    def on_preview(st, epoch):
        items = _xy_items(val_ds, 5)
        sr = _to_numpy(trainer.sample(st, n=len(items), cond=np.stack([it["cond"] for it in items])))
        if is_main_process():
            save_preview_grid([(it["cond"], it["x"], s) for it, s in zip(items, sr)], titles,
                              os.path.join(results_dir, f"superres_{epoch}_epoch.png"))

    state = _train(trainer, state, args, train_loader, val_loader, on_preview)
    items = _xy_items(train_ds, 5)
    sr = _sample(trainer, state, len(items), np.stack([it["cond"] for it in items]),
                 args.generate_video, results_dir)
    if is_main_process():
        save_preview_grid([(it["cond"], it["x"], s) for it, s in zip(items, sr)], titles,
                          os.path.join(results_dir, "superres_results.png"))


# -------------------------------------------------------------- SAR->NDVI


def launch_sar_to_ndvi(args) -> None:
    """train_diffusion_SAR_TO_NDVI: <dataset>/{train,valid}/{sar,opt} pairs."""
    _check_unet_type(getattr(args, "UNet_type", None))
    _check_train_flags(args)
    from diffusionremotesensing_tpu_torch.data.datasets import SarToNdviDataset
    from diffusionremotesensing_tpu_torch.models.unet import (
        param_count,
        residual_attention_unet_sar_to_ndvi,
    )
    from diffusionremotesensing_tpu_torch.utils import save_preview_grid

    os.makedirs(args.snapshot_folder_path, exist_ok=True)
    results_dir = _results_dir(args.model_name, args.snapshot_folder_path)
    train_ds = SarToNdviDataset(os.path.join(args.dataset_path, "train"))
    val_ds = SarToNdviDataset(os.path.join(args.dataset_path, "valid"))
    model = _seeded(lambda: residual_attention_unet_sar_to_ndvi(
        sar_channels=args.SAR_channels, ndvi_channels=args.NDVI_channels,
        compute_dtype=_model_dtype(args)), _train_seed())
    trainer = _build_trainer(model, args, args.image_size)
    state = trainer.maybe_resume(trainer.init_state())
    print("Num params: ", param_count(state.model))

    def on_preview(st, epoch):
        items = [val_ds[i] for i in range(min(5, len(val_ds)))]
        pred = _to_numpy(trainer.sample(st, n=len(items),
                                        cond=np.stack([it["cond"] for it in items])))
        if is_main_process():
            save_preview_grid([(it["cond"][..., :1], it["x"], p) for it, p in zip(items, pred)],
                              ["SAR image", "NDVI ground truth", "NDVI predicted"],
                              os.path.join(results_dir, f"SAR_TO_NDVI_{epoch}_epoch.png"))

    state = _train(trainer, state, args, _loader(train_ds, args), _loader(val_ds, args),
                   on_preview)
    items = [train_ds[i] for i in range(min(5, len(train_ds)))]
    pred = _sample(trainer, state, len(items), np.stack([it["cond"] for it in items]),
                   args.generate_video, results_dir)
    if is_main_process():
        save_preview_grid([(it["cond"][..., :1], it["x"], p) for it, p in zip(items, pred)],
                          ["SAR image", "NDVI image", "NDVI pred image"],
                          os.path.join(results_dir, "SAR_TO_NDVI_results.png"))


# -------------------------------------------------------------- generation


def launch_generation(args) -> None:
    """train_diffusion_generation: class-conditional training with CFG label
    dropout 0.1 on a class-per-folder dataset at ../<dataset_path>, or
    CIFAR10 (the name 'cifar10': a local copy under ./Cifar10, 32 px); no
    validation loader."""
    _check_unet_type(getattr(args, "UNet_type", None))
    _check_train_flags(args)
    from diffusionremotesensing_tpu_torch.data.datasets import ImageFolderDataset
    from diffusionremotesensing_tpu_torch.models.unet import (
        param_count,
        residual_attention_unet_generation,
    )
    from diffusionremotesensing_tpu_torch.utils import save_preview_grid

    os.makedirs(args.snapshot_folder_path, exist_ok=True)
    results_dir = _results_dir(args.model_name, args.snapshot_folder_path)
    if args.dataset_path.lower() == "cifar10":
        from diffusionremotesensing_tpu_torch.data.cifar10 import Cifar10Dataset

        train_ds = Cifar10Dataset("./Cifar10", train=True)
        args.image_size = 32
    else:
        train_ds = ImageFolderDataset(os.path.join("..", args.dataset_path), args.image_size)
    num_classes = train_ds.num_classes
    model = _seeded(lambda: residual_attention_unet_generation(
        image_channels=args.inp_out_channels, out_dim=args.inp_out_channels,
        num_classes=num_classes, compute_dtype=_model_dtype(args)), _train_seed())
    trainer = _build_trainer(model, args, args.image_size, label_dropout=0.1)
    state = trainer.maybe_resume(trainer.init_state())
    print("Num params: ", param_count(state.model))

    def on_preview(st, epoch):
        # num_classes rows of 5 samples, one batched call
        labels = np.repeat(np.arange(num_classes, dtype=np.int32), 5)
        imgs = _to_numpy(trainer.sample(st, n=num_classes * 5, cond=labels, cfg_scale=3.0))
        if is_main_process():
            save_preview_grid([imgs[i * 5:(i + 1) * 5] for i in range(num_classes)],
                              [f"Class sample {j}" for j in range(5)],
                              os.path.join(results_dir, f"generation_{epoch}_epoch.png"))

    state = _train(trainer, state, args, _loader(train_ds, args), None, on_preview)
    imgs = _sample(trainer, state, num_classes, np.arange(num_classes, dtype=np.int32),
                   args.generate_video, results_dir, cfg_scale=3.0)
    if is_main_process():
        save_preview_grid([[img] for img in imgs], ["generated"],
                          os.path.join(results_dir, "generation_results.png"))


# -------------------------------------------------------------- aggregation


def aggregation_generator(device, index: int) -> torch.Generator:
    """The noise of the aggregation launcher's image ``index`` (0 for a
    single image): a generator on ``device`` seeded with ``index``."""
    return torch.Generator(device=device).manual_seed(index)


def load_lr_image(path: str) -> np.ndarray:
    """An LR image as (H, W, 3) float32 in [0, 1], squarified to the nearest
    canonical size by Pillow's bicubic resize when it is not square."""
    from diffusionremotesensing_tpu_torch.aggregation import squarify_sizes
    from diffusionremotesensing_tpu_torch.data.datasets import _open_rgb_or_l, pil_resize_u8

    img = _open_rgb_or_l(path)
    h, w = img.shape[:2]
    if w != h:
        s = squarify_sizes(w, h)
        print(f"The image must be square but it is {w, h}! It will be resized to {s}x{s}")
        img = pil_resize_u8(img, s, s, "bicubic")
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    return img.astype(np.float32) / 255.0


def aggregation_outputs(img_dir: str, dest_dir: str):
    """Directory mode's (inputs, outputs): every image under ``img_dir`` in
    name order, each written as PNG under ``dest_dir`` by its stem, or by its
    whole base name where two inputs share a stem (scene1.jpg, scene1.png)."""
    exts = (".png", ".jpg", ".jpeg", ".tif", ".tiff", ".bmp")
    paths = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir)
                   if f.lower().endswith(exts))
    if not paths:
        raise FileNotFoundError(f"no images with {exts} under {img_dir}")
    stems = [os.path.splitext(os.path.basename(p))[0] for p in paths]
    return paths, [os.path.join(dest_dir, (s if stems.count(s) == 1 else os.path.basename(p))
                                + ".png") for p, s in zip(paths, stems)]


def launch_aggregation(args) -> None:
    """Aggregation_Sampling: load the LR image (or every image of
    --img_lr_dir), squarify it if needed, super-resolve it by tiling, save
    it as PNG. The model computes in float32 with cuDNN's TF32 off."""
    from diffusionremotesensing_tpu_torch.aggregation import AggregationSampler
    from diffusionremotesensing_tpu_torch.diffusion import make_process
    from diffusionremotesensing_tpu_torch.io import load_snapshot
    from diffusionremotesensing_tpu_torch.models.unet import residual_attention_unet_superres
    from diffusionremotesensing_tpu_torch.ops.quant import attach, quantize_superres_tile
    from diffusionremotesensing_tpu_torch.utils import save_image

    device = resolve_device(args.device)
    mesh = _make_mesh_if(getattr(args, "multiple_gpus", False), device)
    if mesh is not None:
        device = mesh.device
    s2d = getattr(args, "s2d", True)
    model = residual_attention_unet_superres(
        image_channels=args.inp_out_channels, out_dim=args.inp_out_channels,
        magnification_factor=args.magnification_factor, s2d=s2d,
        tap44=resolve_tap44(getattr(args, "tap44", "auto"), device) if s2d else False,
        fused_att=bool(getattr(args, "fused_att", False)) and s2d,
        dec_block=bool(getattr(args, "dec_block", False)) and s2d)
    print(f"You are using {args.UNet_type} model")
    state, _ = load_snapshot(os.path.join(args.snapshot_folder_path, args.snapshot_name))
    model.load_state_dict(state, strict=True)
    model = model.to(device).eval()
    ieee_float32(model.dtype)

    img_dir = getattr(args, "img_lr_dir", None)
    if img_dir:
        dest_dir = getattr(args, "destination_dir", None) or args.destination_path
        if not dest_dir:
            raise ValueError("--img_lr_dir needs --destination_dir (or --destination_path) "
                             "for the outputs")
        os.makedirs(dest_dir, exist_ok=True)
        paths, dest_names = aggregation_outputs(img_dir, dest_dir)
    else:
        paths, dest_names = [args.img_lr_path], [args.destination_path]

    proc = make_process(model, args.noise_schedule, args.noise_steps,
                        args.patch_size * args.magnification_factor)
    sampler = AggregationSampler(
        proc, patch_size=args.patch_size, stride=args.stride,
        magnification_factor=args.magnification_factor,
        batch_size=getattr(args, "batch_size", 48), ddim_steps=getattr(args, "ddim_steps", None),
        ddim_eta=getattr(args, "ddim_eta", 0.0), ddim_spacing=getattr(args, "ddim_spacing", "linear"),
        ddim_clip_x0=getattr(args, "ddim_clip_x0", True),
        fused_update=getattr(args, "fused_update", False), start_t=getattr(args, "start_t", None),
        mesh=mesh)
    for i, (path, dest) in enumerate(zip(paths, dest_names)):
        arr = load_lr_image(path)
        attach(proc.net, None)
        if getattr(args, "quant", "none") == "int8":
            qmap = quantize_superres_tile(proc.net, proc.schedule.alpha_hat, arr, args.patch_size,
                                          args.magnification_factor,
                                          torch.Generator(device=device).manual_seed(21))
            attach(proc.net, qmap)
            print(f"int8 quantized execution: {len(qmap)} conv-site scales calibrated "
                  f"on this tile (sites engage per execution branch)")
        out = sampler(arr, generator=aggregation_generator(device, i), device=device)
        if not is_main_process():
            continue
        save_image(out, dest)
        if img_dir:
            print(f"[{i + 1}/{len(paths)}] {path} -> {dest}")


# ------------------------------------------------------------------ serving


def build_server(args):
    """An ``InferenceServer`` from serve's flags: the models_run registry and
    model_name size parsing, the kernel and DDIM flags, the snapshot, and
    with --quant int8 the W8A8 calibration before any traffic. Does not
    serve (:func:`launch_serving` does)."""
    from diffusionremotesensing_tpu_torch.io import load_snapshot
    from diffusionremotesensing_tpu_torch.models.unet import (
        residual_attention_unet_generation,
        residual_attention_unet_sar_to_ndvi,
        residual_attention_unet_superres,
    )
    from diffusionremotesensing_tpu_torch.ops.quant import attach
    from diffusionremotesensing_tpu_torch.serving import InferenceServer

    device = resolve_device(args.device)
    mesh = None
    if getattr(args, "data_parallel", False):
        from diffusionremotesensing_tpu_torch.parallel.sharding import local_devices, make_mesh

        # the mesh over every device of the committed type (a --device cpu
        # run does not mesh the cards it opted out of)
        mesh = make_mesh(local_devices(device.type))
    s2d = getattr(args, "s2d", True)
    kw = dict(s2d=s2d,
              tap44=resolve_tap44(getattr(args, "tap44", "auto"), device) if s2d else False,
              fused_att=bool(getattr(args, "fused_att", False)) and s2d,
              dec_block=bool(getattr(args, "dec_block", False)) and s2d)
    name = args.model_name or ""

    def _parse(fn, what, flag):
        try:
            return fn(name)
        except (IndexError, ValueError):
            raise SystemExit(f"cannot derive {what} from model_name {name!r}; pass {flag} or use "
                             "the registry naming convention (magnificationN, LRimgsizeN, "
                             "imgsizeN parts)")

    if args.task == "superres":
        mag = args.magnification_factor or _parse(parse_magnification, "the magnification",
                                                  "--magnification_factor")
        image_size = args.model_input_size or mag * _parse(parse_lr_imgsize, "the LR input size",
                                                           "--model_input_size")
        model = residual_attention_unet_superres(image_channels=args.inp_out_channels,
                                                 out_dim=args.inp_out_channels,
                                                 magnification_factor=mag, **kw)
    elif args.task == "sar_to_ndvi":
        image_size = args.model_input_size or _parse(parse_imgsize, "the image size",
                                                     "--model_input_size")
        model = residual_attention_unet_sar_to_ndvi(**kw)
    else:
        image_size = args.model_input_size or _parse(parse_imgsize, "the image size",
                                                     "--model_input_size")
        model = residual_attention_unet_generation(image_channels=args.inp_out_channels,
                                                   out_dim=args.inp_out_channels,
                                                   num_classes=args.num_classes, **kw)
    snapshot_path = getattr(args, "snapshot_path", None) or os.path.join(
        "models_run", name, "weights", args.snapshot_name)
    state, _ = load_snapshot(snapshot_path)
    model.load_state_dict(state, strict=True)
    seed = getattr(args, "seed", None)
    if seed is None:
        # fresh entropy per process: restarted servers and replicas must not
        # replay one noise sequence
        seed = int.from_bytes(os.urandom(4), "little")
    task = {"superres": "superres", "sar_to_ndvi": "sar", "generation": "generation"}[args.task]
    server = InferenceServer(
        model.eval(), args.noise_schedule, args.noise_steps, image_size, task=task,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        ddim_steps=getattr(args, "ddim_steps", None),
        ddim_clip_x0=getattr(args, "ddim_clip_x0", True), seed=seed, dtype=_model_dtype(args),
        device=device, start_t=getattr(args, "start_t", None), mesh=mesh)
    if getattr(args, "quant", "none") == "int8":
        qmap = quantize_serving(args, server.process, image_size)
        attach(server.process.net, qmap)
        print(f"int8 quantized serving: {len(qmap)} conv-site scales attached "
              f"(a site engages when its execution branch runs)")
    return server


def quantize_serving(args, process, image_size: int):
    """--quant int8 for serve: the W8A8 quant map of ``process``'s net,
    calibrated before traffic on --quant_calib_image (a representative input,
    resized by Pillow's bicubic) or else a smooth synthetic proxy (an 8x8
    uniform field upsampled bicubically: the probe sets activation ranges,
    not content). Generation calibrates half its probes conditioned and half
    unconditioned, as the served guidance runs both."""
    from diffusionremotesensing_tpu_torch.ops.quant import quantize_for_sampling
    from diffusionremotesensing_tpu_torch.ops.resize import resize_bicubic_keys

    net, dev = process.net, process.device
    gen = torch.Generator(device=dev).manual_seed(33)
    cond_mask = None
    if args.task == "generation":
        n = max(2, min(4, getattr(args, "num_classes", 2)))
        cond = torch.arange(n, device=dev) % (net.num_classes or 1)
        cond_mask = (torch.arange(n, device=dev) < (n + 1) // 2).float()
        x0 = torch.full((n, image_size, image_size, net.image_channels), 0.5, device=dev)
    else:
        cs = image_size // (net.magnification_factor or 1) if args.task == "superres" else image_size
        calib = getattr(args, "quant_calib_image", None)
        if calib:
            from diffusionremotesensing_tpu_torch.data.datasets import pil_resize_u8

            img = (load_lr_image(calib) * 255.0).astype(np.uint8)
            img = pil_resize_u8(img, cs, cs, "bicubic").astype(np.float32) / 255.0
            cond = torch.from_numpy(img)[None, ..., :net.cond_channels].to(dev)
        else:
            small = torch.rand((1, 8, 8, net.cond_channels), generator=gen, device=dev)
            cond = resize_bicubic_keys(small, cs, cs)
        if args.task == "superres":
            x0 = resize_bicubic_keys(cond, image_size, image_size)[..., :net.image_channels]
        else:
            x0 = torch.full((1, image_size, image_size, net.image_channels), 0.5, device=dev)
    return quantize_for_sampling(net, process.schedule.alpha_hat, x0, cond, gen,
                                 cond_mask=cond_mask)


def launch_serving(args) -> None:
    """serve: build the server and block on the HTTP loop."""
    server = build_server(args)
    server.serve(host=args.host, port=args.port)


# ------------------------------------------------------------------ parsers


def _bool(p, flag, default, help=None):
    p.add_argument(flag, type=str2bool, nargs="?", const=True, default=default, help=help)


def _train_head(p, generation=False):
    """The flags the three training scripts open with."""
    p.add_argument("--epochs", type=int, default=501)
    p.add_argument("--batch_size", type=int, default=32)
    if generation:
        p.add_argument("--image_size", type=int, default=None)
    else:
        p.add_argument("--image_size", type=int)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--check_preds_epoch", type=int, default=20)
    p.add_argument("--noise_schedule", type=str, default="cosine")
    p.add_argument("--snapshot_name", type=str, default="snapshot.pt")
    p.add_argument("--model_name", type=str)
    p.add_argument("--noise_steps", type=int, default=200)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--dataset_path", type=str, default=None)


def _train_engine(p):
    """The engine flags the three training scripts share."""
    p.add_argument("--compute_dtype", type=str, default="float32", choices=["float32", "bfloat16"],
                   help="compute dtype of training (parameters stay float32)")
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="train steps per host-to-device transfer (K stacked batches, the same "
                        "update sequence as K = 1)")
    p.add_argument("--num_workers", type=int, default=0,
                   help="data-loading threads (0 = synchronous)")
    p.add_argument("--checkpoint_backend", type=str, default="msgpack",
                   choices=["msgpack", "orbax"],
                   help="snapshot writer: msgpack (one file) or orbax (a checkpoint "
                        "directory written in the background; needs tensorstore)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="capture a torch.profiler trace of training into this directory")


def _train_vgg(p):
    p.add_argument("--vgg19_weights", type=str, default=None,
                   help="torch state_dict of torchvision's vgg19 features (the pretrained "
                        "weights of MSE+Perceptual_noise)")
    _bool(p, "--allow_random_vgg", False,
          help="allow MSE+Perceptual_noise with a fixed random VGG19 (not the reference's "
               "pretrained features)")


def _superres_flags(p):
    _train_head(p)
    p.add_argument("--inp_out_channels", type=int, default=3)
    _bool(p, "--generate_video", False)
    p.add_argument("--loss", type=str)
    p.add_argument("--magnification_factor", type=int)
    p.add_argument("--UNet_type", type=str, default="Residual Attention UNet")
    p.add_argument("--Degradation_type", type=str, default="DownBlur")
    p.add_argument("--num_crops", type=int, default=1)
    _bool(p, "--multiple_gpus", False)
    _bool(p, "--ema_smoothing", False)
    p.add_argument("--Blur_radius", type=str, default="random")
    _train_engine(p)
    _bool(p, "--s2d_train", False,
          help="space-to-depth execution of the training forward (gradients equal to float "
               "tolerance)")
    _bool(p, "--device_degradation", False,
          help="run the DownBlur degradation batched on the device (the host decodes only)")
    p.add_argument("--decode_cache_mb", type=float, default=512.0,
                   help="RAM (MB) for caching decoded training images across epochs; 0 disables")
    _train_vgg(p)


def _sar_flags(p):
    _train_head(p)
    p.add_argument("--SAR_channels", type=int, default=2)
    p.add_argument("--NDVI_channels", type=int, default=1)
    _bool(p, "--generate_video", False)
    p.add_argument("--loss", type=str)
    p.add_argument("--UNet_type", type=str, default="Residual Attention UNet")
    _bool(p, "--multiple_gpus", False)
    _bool(p, "--ema_smoothing", False)
    _train_engine(p)
    _train_vgg(p)


def _generation_flags(p):
    _train_head(p, generation=True)
    p.add_argument("--inp_out_channels", type=int, default=3)
    _bool(p, "--generate_video", False)
    p.add_argument("--loss", type=str)
    p.add_argument("--UNet_type", type=str, default="Residual Attention UNet")
    _bool(p, "--multiple_gpus", False)
    _bool(p, "--ema_smoothing", False)
    _train_engine(p)
    _train_vgg(p)


def _kernel_flags(p):
    """--tap44, --fused_att and --dec_block: the hand-written kernels of the
    s2d path."""
    p.add_argument("--tap44", type=str, default="auto", choices=TAP44_CHOICES,
                   help="ResConvBlock-0's kernels on the s2d path (auto = the tap_block kernel "
                        "on the card, off on the CPU)")
    _bool(p, "--fused_att", False,
          help="stage-2 attention gate + head_at as one att_head_block kernel")
    _bool(p, "--dec_block", False,
          help="decoder tail (concat conv, UpConvBlock-2 body, head_up4) as one dec_block kernel")


def _aggregation_flags(p):
    p.add_argument("--noise_schedule", type=str, default="cosine")
    p.add_argument("--snapshot_name", type=str, default="snapshot.pt")
    p.add_argument("--noise_steps", type=int, default=1500)
    p.add_argument("--model_input_size", type=int, default=512)
    p.add_argument("--model_name", type=str)
    p.add_argument("--UNet_type", type=str)
    p.add_argument("--Degradation_type", type=str)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--magnification_factor", type=int)
    p.add_argument("--inp_out_channels", type=int, default=3)
    p.add_argument("--patch_size", type=int, default=64)
    p.add_argument("--stride", type=int, default=32)
    p.add_argument("--destination_path", type=str)
    p.add_argument("--img_lr_path", type=str)
    p.add_argument("--img_lr_dir", type=str, default=None,
                   help="super-resolve every image in this folder in one process; outputs go "
                        "under --destination_dir as PNG")
    p.add_argument("--destination_dir", type=str, default=None,
                   help="output folder for --img_lr_dir (else --destination_path, as a folder)")
    p.add_argument("--batch_size", type=int, default=48, help="patches denoised per chunk")
    p.add_argument("--ddim_steps", type=int, default=None,
                   help="DDIM with this many steps instead of the full DDPM chain")
    p.add_argument("--ddim_eta", type=float, default=0.0)
    p.add_argument("--ddim_spacing", type=str, default="linear", choices=["linear", "quadratic"],
                   help="DDIM timestep subsequence spacing")
    _bool(p, "--ddim_clip_x0", True,
          help="clamp the per-step DDIM x0 prediction to [0, 1] (--ddim_clip_x0 false disables)")
    p.add_argument("--start_t", type=int, default=None,
                   help="truncated warm-start sampling from each patch's q-sampled bicubic "
                        "upsample at this timestep")
    _bool(p, "--s2d", True, help="space-to-depth execution of level 0 (exact math)")
    _kernel_flags(p)
    _bool(p, "--fused_update", False,
          help="each DDPM step's update and noise as one ancestral_update kernel (another "
               "noise stream; DDPM only)")
    _bool(p, "--multiple_gpus", False,
          help="split each chunk's patches over this process's cards, or over torchrun's ranks")
    p.add_argument("--quant", type=str, default="none", choices=["none", "int8"],
                   help="W8A8 static-calibration int8 execution (ops/quant.py), calibrated on "
                        "each tile's patches; not fp-equivalent, default off")


def _serve_flags(p):
    p.add_argument("--task", type=str, default="superres",
                   choices=["superres", "sar_to_ndvi", "generation"])
    p.add_argument("--model_name", type=str, default=None,
                   help="models_run registry name; sizes parse from its magnificationN / "
                        "LRimgsizeN / imgsizeN parts unless given below")
    p.add_argument("--snapshot_name", type=str, default="snapshot.pt")
    p.add_argument("--snapshot_path", type=str, default=None,
                   help="explicit checkpoint path (instead of models_run/<model_name>/weights)")
    p.add_argument("--noise_schedule", type=str, default="cosine")
    p.add_argument("--noise_steps", type=int, default=1500)
    p.add_argument("--model_input_size", type=int, default=None,
                   help="model input size (the HR size for superres)")
    p.add_argument("--magnification_factor", type=int, default=None)
    p.add_argument("--inp_out_channels", type=int, default=3)
    p.add_argument("--num_classes", type=int, default=10)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_batch", type=int, default=8, help="micro-batch size")
    p.add_argument("--max_wait_ms", type=float, default=10.0,
                   help="the longest a request waits for batch-mates")
    p.add_argument("--ddim_steps", type=int, default=None,
                   help="DDIM with this many steps instead of the full DDPM chain")
    _bool(p, "--ddim_clip_x0", True, help="clamp the per-step DDIM x0 prediction to [0, 1]")
    p.add_argument("--start_t", type=int, default=None,
                   help="superres only: truncated warm-start sampling at this timestep")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="sampler compute dtype (parameters stay float32)")
    _bool(p, "--s2d", True, help="space-to-depth execution of level 0 (exact math)")
    p.add_argument("--quant", type=str, default="none", choices=["none", "int8"],
                   help="W8A8 static-calibration int8 execution (not fp-equivalent)")
    p.add_argument("--quant_calib_image", type=str, default=None,
                   help="representative input image for --quant int8's calibration")
    _bool(p, "--data_parallel", False,
          help="split each micro-batch over every card of this process (--device's type)")
    p.add_argument("--seed", type=int, default=None,
                   help="sampler seed; default fresh entropy per process")
    _kernel_flags(p)


_FLAGS = {"superres": (_superres_flags, "super-resolution training"),
          "sar_to_ndvi": (_sar_flags, "SAR -> NDVI training"),
          "generation": (_generation_flags, "class-conditional generation training"),
          "aggregation": (_aggregation_flags, "tiled super-resolution of LR images"),
          "serve": (_serve_flags, "micro-batched HTTP inference server")}
_LAUNCHERS = {"superres": launch_superres, "sar_to_ndvi": launch_sar_to_ndvi,
              "generation": launch_generation, "aggregation": launch_aggregation,
              "serve": launch_serving}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m diffusionremotesensing_tpu_torch.cli",
                                 description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="command", required=True)
    for name, (add, what) in _FLAGS.items():
        add(sub.add_parser(name, description=what, help=what))
    return ap


def subcommand_parser(name: str) -> argparse.ArgumentParser:
    """The parser of one subcommand (its flags, for tests and --help)."""
    return build_parser()._subparsers._group_actions[0].choices[name]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    """Parse argv and derive what each script derives after parsing."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.command in ("superres", "sar_to_ndvi", "generation", "aggregation"):
        if not args.model_name:
            subcommand_parser(args.command).error("--model_name is required")
        # generation keeps its script's paths, relative to generate_new_imgs/
        root = ".." if args.command == "generation" else os.curdir
        args.snapshot_folder_path = os.path.join(root, "models_run", args.model_name, "weights")
    elif not args.model_name and not args.snapshot_path:
        subcommand_parser("serve").error("pass --model_name (registry) or --snapshot_path")
    return args


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    _LAUNCHERS[args.command](args)


if __name__ == "__main__":
    main(sys.argv[1:])
