"""The port's command line (``diffusionremotesensing_tpu_torch/cli.py``) on
the CPU, in-process through ``cli.main``: each subcommand's flags and
defaults are its reference script's (read from the scripts' source with
ast, never imported); aggregation on a small PNG equals AggregationSampler,
directory mode too; serve answers over HTTP what infer_batch answers; the
three trainers run an epoch, write a snapshot and resume; and what is not
ported, or not present, raises. The parallel flags (--multiple_gpus,
--data_parallel) are held in tests/test_torch_port_parallel_split.py."""

import ast
import base64
import json
import os
import sys
import urllib.request

import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu.models.unet import TAP44_LEVELS as JAX_TAP44_LEVELS
from diffusionremotesensing_tpu_torch import cli
from diffusionremotesensing_tpu_torch.aggregation import AggregationSampler
from diffusionremotesensing_tpu_torch.diffusion import make_process
from diffusionremotesensing_tpu_torch.io import load_snapshot, save_snapshot
from diffusionremotesensing_tpu_torch.models.unet import residual_attention_unet_superres
from diffusionremotesensing_tpu_torch.png import decode_png, encode_png
from diffusionremotesensing_tpu_torch.serving import InferenceServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = {"superres": "train_diffusion_superres.py",
           "sar_to_ndvi": "train_diffusion_SAR_TO_NDVI.py",
           "generation": os.path.join("generate_new_imgs", "train_diffusion_generation.py"),
           "aggregation": "Aggregation_Sampling.py",
           "serve": "serve.py"}


def script_flags(path):
    """{flag: {default, type, choices, nargs, const}} of every
    parser.add_argument call in a script's source."""
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            spec = {"default": ast.literal_eval(kw["default"]) if "default" in kw else None,
                    "type": kw["type"].id if "type" in kw else None,
                    "choices": ast.literal_eval(kw["choices"]) if "choices" in kw else None,
                    "nargs": ast.literal_eval(kw["nargs"]) if "nargs" in kw else None,
                    "const": ast.literal_eval(kw["const"]) if "const" in kw else None}
            out[ast.literal_eval(node.args[0])] = spec
    return out


def port_flags(command):
    out = {}
    for a in cli.subcommand_parser(command)._actions:
        if a.option_strings == ["-h", "--help"]:
            continue
        out[a.option_strings[0]] = {"default": a.default,
                                    "type": a.type.__name__ if a.type else None,
                                    "choices": a.choices, "nargs": a.nargs, "const": a.const}
    return out


@pytest.mark.parametrize("command", list(SCRIPTS))
def test_flags_are_the_reference_scripts(command, capsys):
    want = script_flags(SCRIPTS[command])
    assert len(want) > 10
    assert port_flags(command) == want
    with pytest.raises(SystemExit) as e:
        cli.main([command, "--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert all(flag in out for flag in want)


def test_tap44_spellings_are_the_references():
    assert cli.TAP44_SPELLINGS == JAX_TAP44_LEVELS
    assert cli.resolve_tap44("auto", torch.device("cpu")) is False
    assert cli.resolve_tap44("auto", torch.device("cuda")) == "block"
    assert cli.resolve_tap44("full", torch.device("cpu")) is True
    with pytest.raises(ValueError):
        cli.resolve_tap44("fast", torch.device("cpu"))


def test_model_name_parsing_is_the_references():
    name = "superres_magnification4_LRimgsize64_imgsize256"
    assert (cli.parse_magnification(name), cli.parse_lr_imgsize(name),
            cli.parse_imgsize(name)) == (4, 64, 256)


def _png(path, rng, size=16, channels=3):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    img = (rng.random((size, size, channels)) * 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png(img.squeeze()))
    return img


@pytest.fixture(scope="module")
def snapshot_dir(tmp_path_factory):
    """models_run/x2/weights/snapshot.pt of a full-width x2 model (torch's
    default init, seeded), written by the port's own writer."""
    root = tmp_path_factory.mktemp("cli")
    with torch.random.fork_rng():
        torch.manual_seed(0)
        m = residual_attention_unet_superres(magnification_factor=2)
    save_snapshot(str(root / "models_run" / "x2" / "weights" / "snapshot.pt"), m, 3)
    return root


AGG = ["--model_name", "x2", "--magnification_factor", "2", "--device", "cpu",
       "--patch_size", "8", "--stride", "4", "--noise_steps", "20", "--ddim_steps", "3"]


def _sampler_tile(root, lr_u8, index, **flags):
    state, _ = load_snapshot(str(root / "models_run" / "x2" / "weights" / "snapshot.pt"))
    m = residual_attention_unet_superres(magnification_factor=2, s2d=True, **flags)
    m.load_state_dict(state)
    sampler = AggregationSampler(make_process(m.eval(), "cosine", 20, 16), patch_size=8, stride=4,
                                 magnification_factor=2, ddim_steps=3)
    out = sampler(lr_u8.astype(np.float32) / 255.0,
                  generator=cli.aggregation_generator("cpu", index), device="cpu")
    return (np.clip(out, 0, 1) * 255.0).astype(np.uint8)


def test_aggregation_equals_the_sampler(snapshot_dir, monkeypatch):
    monkeypatch.chdir(snapshot_dir)
    lr = _png(str(snapshot_dir / "single" / "lr.png"), np.random.default_rng(0))
    cli.main(["aggregation", *AGG, "--img_lr_path", "single/lr.png",
              "--destination_path", "single/sr.png", "--tap44", "stem", "--fused_att",
              "--dec_block"])
    with open(snapshot_dir / "single" / "sr.png", "rb") as f:
        got = decode_png(f.read())
    assert got.shape == (32, 32, 3)
    want = _sampler_tile(snapshot_dir, lr, 0, tap44="stem", fused_att=True, dec_block=True)
    assert np.array_equal(got, want)


def test_aggregation_directory_mode(snapshot_dir, monkeypatch):
    """Every image of the folder, image i's noise from generator i, outputs
    named by stem, or by the whole base name where stems collide."""
    monkeypatch.chdir(snapshot_dir)
    rng = np.random.default_rng(1)
    lrs = {n: _png(str(snapshot_dir / "dir" / n), rng) for n in ("b.png", "scene.PNG", "scene.png")}
    cli.main(["aggregation", *AGG, "--img_lr_dir", "dir", "--destination_dir", "out"])
    assert sorted(os.listdir(snapshot_dir / "out")) == ["b.png", "scene.PNG.png", "scene.png.png"]
    for i, name in enumerate(sorted(lrs)):  # the launcher's order
        out = {"b.png": "b.png"}.get(name, name + ".png")
        with open(snapshot_dir / "out" / out, "rb") as f:
            got = decode_png(f.read())
        want = _sampler_tile(snapshot_dir, lrs[name], i)
        assert np.array_equal(got, want), name
    with pytest.raises(ValueError, match="destination"):
        cli.main(["aggregation", *AGG, "--img_lr_dir", "dir"])


def test_aggregation_int8_gives_a_tile(snapshot_dir, monkeypatch, capsys):
    monkeypatch.chdir(snapshot_dir)
    _png(str(snapshot_dir / "q" / "lr.png"), np.random.default_rng(2))
    cli.main(["aggregation", *AGG, "--img_lr_path", "q/lr.png", "--destination_path", "q/sr.png",
              "--quant", "int8"])
    assert "conv-site scales calibrated" in capsys.readouterr().out
    with open(snapshot_dir / "q" / "sr.png", "rb") as f:
        assert decode_png(f.read()).shape == (32, 32, 3)


SERVE = ["serve", "--task", "superres", "--model_input_size", "16", "--magnification_factor", "2",
         "--device", "cpu", "--noise_steps", "20", "--ddim_steps", "3", "--seed", "7",
         "--max_batch", "2", "--compute_dtype", "float32"]


def test_serve_answers_what_infer_batch_answers(snapshot_dir):
    snap = str(snapshot_dir / "models_run" / "x2" / "weights" / "snapshot.pt")
    lr = np.random.default_rng(3).random((8, 8, 3)).astype(np.float32)
    args = cli.parse_args([*SERVE, "--snapshot_path", snap])
    server, twin = cli.build_server(args), cli.build_server(args)
    http = server.make_http_server("127.0.0.1", 0)
    import threading

    t = threading.Thread(target=http.serve_forever, daemon=True)
    t.start()
    try:
        body = json.dumps({"image": base64.b64encode(
            encode_png((lr * 255).astype(np.uint8))).decode()}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{http.server_port}/superres", body,
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            got = decode_png(base64.b64decode(json.loads(r.read())["image"]))
        want = twin.infer_batch([(lr * 255).astype(np.uint8).astype(np.float32) / 255.0])[0]
    finally:
        http.shutdown()
        server.shutdown()
        twin.shutdown()
    assert isinstance(server, InferenceServer) and got.shape == (16, 16, 3)
    assert np.array_equal(got, (np.clip(want, 0, 1) * 255).astype(np.uint8))


def test_serve_int8_calibrates_before_traffic(snapshot_dir, capsys):
    snap = str(snapshot_dir / "models_run" / "x2" / "weights" / "snapshot.pt")
    server = cli.build_server(cli.parse_args([*SERVE, "--snapshot_path", snap, "--quant", "int8"]))
    try:
        assert server.process.net.quant_sites.scales
        out = server.infer_batch([np.full((8, 8, 3), 0.5, np.float32)])[0]
    finally:
        server.shutdown()
    assert "int8 quantized serving" in capsys.readouterr().out
    assert out.shape == (16, 16, 3) and np.isfinite(out).all()


def test_serve_needs_a_snapshot():
    with pytest.raises(SystemExit):
        cli.parse_args(["serve", "--device", "cpu"])


def test_what_is_not_ported_or_present_raises(snapshot_dir, monkeypatch):
    monkeypatch.chdir(snapshot_dir)
    snap = str(snapshot_dir / "models_run" / "x2" / "weights" / "snapshot.pt")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["aggregation", "--model_name", "x2", "--magnification_factor", "2",
                      "--img_lr_path", "x.png", "--destination_path", "y.png"])
        with pytest.raises(RuntimeError, match="cuda"):
            cli.build_server(cli.parse_args(["serve", "--snapshot_path", snap]))
    monkeypatch.setenv("DRS_FORCE_CPU", "1")
    # the Orbax backend is ported; without tensorstore it raises, naming
    # it, before any data is read (test_torch_port_orbax.py trains with it)
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="Orbax checkpoint backend needs the 'tensorstore'"):
        cli.main(["sar_to_ndvi", "--model_name", "m", "--checkpoint_backend", "orbax"])


TRAIN = ["--epochs", "1", "--batch_size", "2", "--noise_steps", "4", "--check_preds_epoch", "1",
         "--loss", "MSE", "--image_size", "16"]


def _train_twice(argv, capsys):
    """Run a trainer for one epoch, then again for two: the rerun resumes."""
    cli.main(argv)
    first = capsys.readouterr().out
    cli.main([*argv, "--epochs", "2"])
    return first, capsys.readouterr().out


def test_superres_trains_and_resumes(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DRS_FORCE_CPU", "1")
    rng = np.random.default_rng(4)
    for split in ("train_original", "val_original"):
        for i in range(3):
            _png(str(tmp_path / "data" / split / f"{i}.png"), rng)
    first, second = _train_twice(
        ["superres", *TRAIN, "--model_name", "sr", "--dataset_path", "data",
         "--magnification_factor", "2", "--Blur_radius", "0.5", "--decode_cache_mb", "0"], capsys)
    assert "Num params:  4383058" in first
    assert os.path.exists("models_run/sr/weights/snapshot.pt")
    assert os.path.exists("models_run/sr/results/superres_0_epoch.png")
    assert os.path.exists("models_run/sr/results/superres_results.png")
    assert "Resuming training from snapshot at Epoch 0" in second
    assert "Epoch 1: Running Train (MSE)" in second


def test_sar_to_ndvi_trains_and_resumes(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DRS_FORCE_CPU", "1")
    rng = np.random.default_rng(5)
    for split in ("train", "valid"):
        for sub, c in (("sar", 2), ("opt", 1)):
            os.makedirs(tmp_path / "sar" / split / sub)
            for i in range(2):
                np.save(tmp_path / "sar" / split / sub / f"{i}.npy",
                        rng.uniform(-1, 1, (c, 16, 16)).astype(np.float32))
    first, second = _train_twice(["sar_to_ndvi", *TRAIN, "--model_name", "s", "--dataset_path",
                                  "sar"], capsys)
    assert "Num params:  4382238" in first
    assert os.path.exists("models_run/s/results/SAR_TO_NDVI_results.png")
    assert "Resuming training from snapshot at Epoch 0" in second


def test_generation_trains_and_resumes(tmp_path, monkeypatch, capsys):
    """Run from a subdirectory, as its script is: the data and models_run
    are one level up."""
    rng = np.random.default_rng(6)
    for cls in ("a", "b"):
        for i in range(2):
            _png(str(tmp_path / "classes" / cls / f"{i}.png"), rng)
    (tmp_path / "generate_new_imgs").mkdir()
    monkeypatch.chdir(tmp_path / "generate_new_imgs")
    monkeypatch.setenv("DRS_FORCE_CPU", "1")
    first, second = _train_twice(["generation", *TRAIN, "--model_name", "g", "--dataset_path",
                                  "classes"], capsys)
    assert "Num params:  4382222" in first  # 2 classes: 8 label-embedding rows fewer than 10
    assert os.path.exists(tmp_path / "models_run" / "g" / "results" / "generation_results.png")
    assert os.path.exists(tmp_path / "models_run" / "g" / "weights" / "snapshot.pt")
    assert "Resuming training from snapshot at Epoch 0" in second
    if not os.path.isdir("Cifar10"):  # the name 'cifar10' reads a local copy only
        with pytest.raises(FileNotFoundError, match="CIFAR10"):
            cli.main(["generation", *TRAIN, "--model_name", "c", "--dataset_path", "cifar10"])


@pytest.mark.parametrize("entry", ["aggregation", "serve_float32", "serve_bfloat16", "trainer",
                                   "trainer_bfloat16"])
def test_float32_entry_points_turn_tf32_off(entry, snapshot_dir, monkeypatch):
    """Each entry point that builds a float32 model sets cuDNN's TF32 off
    (torch's default is on), so that the port's float32 is IEEE float32
    on the card as on the CPU; a bfloat16 one leaves the setting as it is."""
    from diffusionremotesensing_tpu_torch.train import Trainer

    snap = str(snapshot_dir / "models_run" / "x2" / "weights" / "snapshot.pt")
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        if entry == "aggregation":
            monkeypatch.chdir(snapshot_dir)
            _png(str(snapshot_dir / "tf32" / "lr.png"), np.random.default_rng(5))
            cli.main(["aggregation", *AGG, "--img_lr_path", "tf32/lr.png",
                      "--destination_path", "tf32/sr.png"])
        elif entry.startswith("serve"):
            dtype = entry.split("_")[1]
            cli.build_server(cli.parse_args([*SERVE, "--snapshot_path", snap, "--compute_dtype",
                                             dtype])).shutdown()
        else:
            dtype = torch.bfloat16 if entry.endswith("bfloat16") else None
            Trainer(residual_attention_unet_superres(magnification_factor=2, compute_dtype=dtype),
                    "linear", 20, 16, device="cpu")
        assert torch.backends.cudnn.allow_tf32 is entry.endswith("bfloat16")
    finally:
        torch.backends.cudnn.allow_tf32 = before
