"""Guards of the PyTorch port: it and chip_smoke.py import nothing of JAX,
flax, msgpack, PIL, cv2, imageio, matplotlib or the reference package (the
card's machine has none of the first five, and the last two are not known
to be there) but inside the functions LAZY lists; chip_smoke.py fails
without a card and alone; and its golden values are what the reference
package computes."""

import ast
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu.io import import_torch_state_dict
from diffusionremotesensing_tpu.models.unet import residual_attention_unet_superres as jax_superres
from diffusionremotesensing_tpu_torch.convert import init_params
from diffusionremotesensing_tpu_torch.models.unet import residual_attention_unet_superres

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "diffusionremotesensing_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "PIL", "cv2", "imageio",
             "matplotlib", "diffusionremotesensing_tpu"}


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


# the port's modules that import PIL or cv2 inside the functions that cannot
# work without them (each raises a named ImportError where it is missing),
# and the packages each may import so
LAZY = {os.path.join("diffusionremotesensing_tpu_torch", "utils.py"): {"PIL", "cv2", "imageio",
                                                                      "matplotlib"},
        os.path.join("diffusionremotesensing_tpu_torch", "data", "degradations.py"): {"cv2"},
        os.path.join("diffusionremotesensing_tpu_torch", "io.py"): {"tensorstore"},
        os.path.join("diffusionremotesensing_tpu_torch", "superres_and_NDVIgen.py"): {"matplotlib"},
        os.path.join("diffusionremotesensing_tpu_torch", "imgs_generator.py"): {"matplotlib"}}
# packages the port may import only lazily, where LAZY lists them, though
# they are not forbidden: the Orbax backend's
LAZY_ONLY = {"tensorstore"}


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_nothing_forbidden(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    lazy = LAZY.get(os.path.relpath(path, REPO), set())
    in_functions = {id(n) for fn in ast.walk(tree)
                    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                    for n in ast.walk(fn)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in lazy and id(node) in in_functions:
                continue
            assert top not in FORBIDDEN, f"{path} imports {name}"


def test_lazy_only_packages_are_imported_inside_functions_of_lazy():
    """tensorstore is imported by no port module and not by chip_smoke.py
    but inside the functions of the modules LAZY lists it for."""
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        lazy = LAZY.get(os.path.relpath(path, REPO), set())
        in_functions = {id(n) for fn in ast.walk(tree)
                        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                        for n in ast.walk(fn)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in LAZY_ONLY or (top in lazy and id(node) in in_functions), (
                    f"{path} imports {name}")


def test_lazy_imports_are_where_they_are_listed():
    """Each module LAZY names does import its package lazily somewhere."""
    for rel, pkgs in LAZY.items():
        with open(os.path.join(REPO, rel)) as f:
            text = f.read()
        for pkg in pkgs:
            assert f"import {pkg}" in text or f"from {pkg} import" in text, (rel, pkg)


def test_importing_the_port_loads_nothing_forbidden():
    """In a fresh interpreter, every module of the port and chip_smoke.py,
    then sys.modules holds none of the forbidden packages."""
    mods = ["chip_smoke"] + sorted(
        os.path.relpath(p, REPO)[:-3].replace(os.sep, ".") for p in _port_sources()
        if p.startswith(PORT))
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n" % (FORBIDDEN,)
            + "print(bad); sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_reading_and_writing_a_snapshot_loads_nothing_forbidden(tmp_path):
    """The port's checkpoint I/O reads an in-repo flax snapshot and writes
    one with its own msgpack code: in a fresh interpreter, neither msgpack,
    flax nor JAX is loaded."""
    snap = os.path.join(REPO, "benchmarks", "gate_artifacts", "snapshot_x2.pt")
    code = ("import sys\n"
            "from diffusionremotesensing_tpu_torch.io import load_snapshot, save_snapshot\n"
            "from diffusionremotesensing_tpu_torch.models.unet import "
            "residual_attention_unet_superres\n"
            f"state, epochs = load_snapshot({snap!r})\n"
            "m = residual_attention_unet_superres(magnification_factor=2)\n"
            "m.load_state_dict(state)\n"
            f"save_snapshot({str(tmp_path / 'out.msgpack')!r}, m, epochs)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n" % (FORBIDDEN,)
            + "print(epochs, bad); sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0 and r.stdout.startswith("1946 []"), r.stdout + r.stderr
    assert (tmp_path / "out.msgpack").stat().st_size == os.path.getsize(snap)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"kernels"' not in r.stdout
    assert "[device]" in r.stdout and "FAILED" in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300, env={**os.environ, "PYTHONPATH": ""})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_golden_values_are_the_reference_output():
    """GOLDEN in chip_smoke.py: the reference package's float32 output for
    the port's init_params(SEED) weights (carried over by the reference's
    own importer) at golden_input(); the port's CPU forward agrees too."""
    sys.path.insert(0, REPO)
    import chip_smoke

    sd = init_params(chip_smoke.SEED, device="cpu")
    x, t, cond = chip_smoke.golden_input()
    out = np.asarray(jax_superres(magnification_factor=2).apply(
        import_torch_state_dict(sd), x, t, cond, train=False))
    g = chip_smoke.GOLDEN
    np.testing.assert_allclose(out.reshape(-1)[::g["stride"]], g["values"], atol=1e-6)
    assert abs(np.abs(out.astype(np.float64)).sum() - g["abs_sum"]) < 1e-3

    m = residual_attention_unet_superres(magnification_factor=2, s2d=True, tap44="block")
    m.load_state_dict(sd)
    with torch.no_grad():
        got = m.eval()(*(torch.from_numpy(a) for a in (x, t, cond))).numpy()
    np.testing.assert_allclose(got.reshape(-1)[::g["stride"]], g["values"], atol=chip_smoke.GOLDEN_TOL)


def test_chip_smoke_bound_counts_the_blocks_dense_work():
    """bound_ms counts ResConvBlock-0's own convolutions at 128x128, not the
    structural zeros that the tap formulation's products carry."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from diffusionremotesensing_tpu_torch.models.blocks import ResConvBlock

    macs = sum(m.out_channels * m.in_channels * m.kernel_size[0] * m.kernel_size[1]
               for m in ResConvBlock(16, 32).modules() if isinstance(m, torch.nn.Conv2d))
    dense, issued = chip_smoke.block_flops(48, 64, 64, 64, 128)
    assert dense == 2 * 48 * 128 * 128 * macs
    assert issued > dense
    ms, by = chip_smoke.block_bound(48, 64, 64, 64, 128, 2, chip_smoke.PEAK_BF16)
    assert by == "operations" and ms == pytest.approx(dense / chip_smoke.PEAK_BF16 * 1e3)


def test_the_fused_path_modules_are_guarded():
    """The import guards above walk the whole package: the modules of the
    fused path are among what they check."""
    checked = {os.path.relpath(p, PORT) for p in _port_sources() if p.startswith(PORT)}
    for mod in ("ops/fused_update.py", "ops/att_block.py", "ops/dec_block.py", "diffusion.py",
                "aggregation.py", "models/unet.py"):
        assert mod.replace("/", os.sep) in checked


def test_the_spatial_modules_are_guarded():
    """The import guards walk parallel/halo.py (the halo exchanges) and
    parallel/sharding.py (spatial_sharding); importing the halo module in a
    fresh interpreter loads nothing forbidden."""
    checked = {os.path.relpath(p, PORT) for p in _port_sources() if p.startswith(PORT)}
    for mod in ("parallel/halo.py", "parallel/sharding.py"):
        assert mod.replace("/", os.sep) in checked
    code = ("import sys\n"
            "from diffusionremotesensing_tpu_torch.parallel.halo import HALOS, Band, site\n"
            "from diffusionremotesensing_tpu_torch.parallel.sharding import spatial_sharding\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n" % (FORBIDDEN,)
            + "print(bad); sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_chip_smoke_checks_every_cuda_source():
    """chip_smoke.py builds, checks and counts a kernel for every CUDA
    source of the port."""
    sys.path.insert(0, REPO)
    import chip_smoke

    sources = {n for n in os.listdir(os.path.join(PORT, "csrc")) if n.endswith(".cu")}
    assert {k[1] for k in chip_smoke.KERNELS.values()} == sources


def test_chip_smoke_bounds_of_the_fused_kernels():
    """att_head_block is bound by its bytes in bfloat16 and by its
    operations in float32, dec_block by its convolutions' operations,
    ancestral_update by reading x and eps and writing x' once."""
    sys.path.insert(0, REPO)
    import chip_smoke

    att, dec = chip_smoke.att_flops(48, 64, 64), chip_smoke.dec_flops(48, 64, 64)
    ms, by = chip_smoke.dec_bound(48, 64, 64, 2, chip_smoke.PEAK_BF16)
    assert by == "operations" and ms == pytest.approx(dec / chip_smoke.PEAK_BF16 * 1e3)
    ms, by = chip_smoke.att_bound(48, 64, 64, 2, chip_smoke.PEAK_BF16)
    assert by == "bytes" and ms == pytest.approx(48 * 64 * 64 * (128 + 64 + 12) * 2 / 3.35e12 * 1e3,
                                                 rel=1e-3)
    ms, by = chip_smoke.att_bound(48, 64, 64, 4, chip_smoke.PEAK_F32)
    assert by == "operations" and ms == pytest.approx(att / chip_smoke.PEAK_F32 * 1e3)
    n = 48 * 64 * 64 * 12
    ms, by = chip_smoke.update_bound(n, 4)
    assert by == "bytes" and ms == pytest.approx(3 * n * 4 / 3.35e12 * 1e3, rel=1e-6)


def _macs(*convs):
    """Multiply-adds a pixel of each conv's own output grid."""
    return [c.in_channels * c.out_channels * c.kernel_size[0] * c.kernel_size[1] // c.groups
            for c in convs]


def test_chip_smoke_fused_flops_count_the_models_layers():
    """The FLOPs behind the fused kernels' bounds are the model's own layers
    at their own resolution, as block_flops counts ResConvBlock-0: per s2d
    pixel, a conv at full resolution counts four times, and head_at is the
    composed 3x3 conv C->out_dim, not its s2d form."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from diffusionremotesensing_tpu_torch.models.unet import ResidualAttentionUNet

    m = ResidualAttentionUNet()
    att, gat = m.attention_blocks[2], m.gating_signals[2].conv
    g, wg, psi = _macs(gat, att.w_g[0], att.psi[0])
    wx, rc = _macs(att.w_x[0], att.result[0])
    c = att.result[0].out_channels
    head_at = 4 * 9 * c * m.output.out_channels
    assert chip_smoke.att_flops(48, 64, 64) == 2 * 48 * 64 * 64 * (g + wg + psi + wx + 4 * rc + head_at)
    assert chip_smoke.att_flops(48, 64, 64) == 2 * 48 * 64 * 64 * 14752

    up = m.ups[2]
    assert up.transform.kernel_size == (3, 3) and up.transform.stride == (2, 2)
    head_up4 = 25 * up.transform.in_channels * m.output.out_channels
    assert chip_smoke.dec_flops(48, 64, 64) == 2 * 48 * 64 * 64 * (sum(_macs(m.up_convs[1], up.conv))
                                                                  + head_up4)


def test_chip_smoke_fused_flops_are_the_nonzero_weights():
    """Per s2d pixel, the counted multiply-adds are exactly the entries of
    the fused kernels' weights that are not structural zeros (random
    weights: every other entry is nonzero)."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from diffusionremotesensing_tpu_torch.models.unet import residual_attention_unet_superres

    with torch.random.fork_rng():
        # seeded: an unseeded draw may hold an exact 0.0 among its ~10^5 entries
        torch.manual_seed(0)
        m = residual_attention_unet_superres(magnification_factor=2, s2d=True, tap44="block",
                                             fused_att=True, dec_block=True).eval()
    k = m.prepare_s2d_kernels(torch.float32)

    def nonzero(w, names):
        return sum(int((w[n] != 0).sum()) for n in names)

    att = nonzero(k["att_fused"], ("gw", "wg", "wx", "wpsi", "rc", "at"))
    dec = nonzero(k["dec"], ("wa", "wb", "k4"))
    assert chip_smoke.att_flops(2, 64, 64) == 2 * 2 * 64 * 64 * att
    assert chip_smoke.dec_flops(2, 64, 64) == 2 * 2 * 64 * 64 * dec


def test_the_third_slice_modules_are_guarded():
    """The modules of the tap44 levels and of use_pallas are among what the
    import guards above check."""
    checked = {os.path.relpath(p, PORT) for p in _port_sources() if p.startswith(PORT)}
    for mod in ("ops/tap_conv.py", "ops/tap_block.py", "ops/attention_gate.py",
                "models/blocks.py"):
        assert mod.replace("/", os.sep) in checked


@pytest.mark.parametrize("name", ["plain_gates", "conv2", "tap", "stem_level", "stem", "packed",
                                  "l1", "l1_fused"])
def test_chip_smoke_golden_configurations_agree_on_the_cpu(name):
    """Each configuration the golden phase adds computes GOLDEN on the CPU
    too (its kernels' plain versions), at the phase's tolerance."""
    sys.path.insert(0, REPO)
    import chip_smoke

    assert name in chip_smoke.GOLDEN_CONFIGS
    m = residual_attention_unet_superres(magnification_factor=2, **chip_smoke.CONFIGS[name])
    m.load_state_dict(init_params(chip_smoke.SEED, device="cpu"))
    x, t, cond = chip_smoke.golden_input()
    with torch.no_grad():
        got = m.eval()(*(torch.from_numpy(a) for a in (x, t, cond))).numpy()
    g = chip_smoke.GOLDEN
    np.testing.assert_allclose(got.reshape(-1)[::g["stride"]], g["values"], atol=chip_smoke.GOLDEN_TOL)


def test_chip_smoke_third_slice_flops_are_the_nonzero_weights():
    """Per s2d pixel (gating pixel for the gate), the multiply-adds behind
    the new kernels' bounds are exactly the entries of the weights they take
    that are not structural zeros; the result conv counts at each of the 4
    pixels of x above a gating pixel."""
    sys.path.insert(0, REPO)
    import chip_smoke

    def nnz(*ws):
        return sum(int((w != 0).sum()) for w in ws)

    with torch.random.fork_rng():
        # seeded: an unseeded draw may hold an exact 0.0 among its ~10^5 entries
        torch.manual_seed(0)
        kt = residual_attention_unet_superres(magnification_factor=2, s2d=True,
                                              tap44=True).eval().prepare_s2d_kernels(torch.float32)
        m = residual_attention_unet_superres(magnification_factor=2,
                                             **chip_smoke.CONFIGS["stem"]).eval()
    ks = m.prepare_s2d_kernels(torch.float32)
    n = 2 * 2 * 64 * 64
    assert chip_smoke.conv_flops(2, 64, 64, 128, 128) == n * nnz(kt["blk_conv2_44"])
    assert 2 * chip_smoke.conv_flops(2, 64, 64, 64, 128) == n * nnz(kt["blk_conv1_44"],
                                                                    kt["blk_skip_44"])
    st = ks["tap_stem"]
    assert chip_smoke.stem_flops(2, 64, 64) == n * nnz(st["w0"], st["w1"], st["w2"])
    for i, (hg, c) in enumerate(((16, 128), (32, 64))):
        w = ks[f"gate{i}"]
        assert chip_smoke.gate_flops(2, hg, hg, c) == 2 * 2 * hg * hg * (
            nnz(w["wg"], w["wx"], w["wpsi"]) + 4 * nnz(w["wr"]))


def test_chip_smoke_bounds_of_the_third_slice_kernels():
    """At B=48 bf16: tap_conv and tap_conv_pair are bound by their bytes,
    tap_stem_block by its operations, the gates by their bytes; the float32
    gates by their operations."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    ms, by = cs.conv_bound(48, 64, 64, 128, 128, 2, cs.PEAK_BF16)
    assert by == "bytes" and ms == pytest.approx(
        2 * (48 * 64 * 64 * 256 + 512 * 128) / 3.35e12 * 1e3)
    ms, by = cs.conv_bound(48, 64, 64, 64, 128, 2, cs.PEAK_BF16, n=2)
    assert by == "bytes" and ms == pytest.approx(
        2 * (48 * 64 * 64 * (64 + 256) + 2 * 256 * 128) / 3.35e12 * 1e3)
    ms, by = cs.stem_bound(48, 64, 64, 2, cs.PEAK_BF16)
    assert by == "operations" and ms == pytest.approx(cs.stem_flops(48, 64, 64) / cs.PEAK_BF16 * 1e3)
    assert cs.stem_flops(48, 64, 64) == 2 * 48 * 128 * 128 * (9 * 3 * 16 + 2 * 9 * 16 * 32
                                                              + 9 * 32 * 32 + 16 * 32)
    gates = [(16, 16, 128), (32, 32, 64)]
    assert cs.gate_bound(48, gates, 2, cs.PEAK_BF16)[1] == "bytes"
    ms, by = cs.gate_bound(48, gates, 4, cs.PEAK_F32)
    flops = sum(cs.gate_flops(48, *g) for g in gates)
    assert by == "operations" and ms == pytest.approx(flops / cs.PEAK_F32 * 1e3)


def test_the_training_modules_are_guarded():
    """The modules of training (the trainer, EMA, losses, profiling, the
    loader and the on-device DownBlur) are among what the import guards
    above check."""
    checked = {os.path.relpath(p, PORT) for p in _port_sources() if p.startswith(PORT)}
    for mod in ("train.py", "ema.py", "losses.py", "profiling.py", "data/__init__.py",
                "data/loader.py", "data/device_degradation.py"):
        assert mod.replace("/", os.sep) in checked


def test_the_thirteenth_slice_modules_are_guarded():
    """The PNG codec, utils, the data modules and the HTTP layer's module
    are among what the import guards above check."""
    checked = {os.path.relpath(p, PORT) for p in _port_sources() if p.startswith(PORT)}
    for mod in ("png.py", "utils.py", "serving.py", "data/datasets.py", "data/degradations.py",
                "data/cifar10.py"):
        assert mod.replace("/", os.sep) in checked


def test_the_fourteenth_slice_modules_are_guarded():
    """The command line, the parameter census and W8A8 quantization are
    among what the import guards above check, and importing the command
    line loads none of the media packages."""
    checked = {os.path.relpath(p, PORT) for p in _port_sources() if p.startswith(PORT)}
    for mod in ("cli.py", "models/census.py", "ops/quant.py"):
        assert mod.replace("/", os.sep) in checked
    code = ("import sys\nimport diffusionremotesensing_tpu_torch.cli\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n" % (FORBIDDEN,)
            + "print(bad); sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_chip_smoke_train_flops_are_torchs_count():
    """The train phase's operations: three times the forward's
    convolution and linear FLOPs as torch's own FlopCounterMode counts them
    on a CPU forward (the bicubic resize's small products aside); its bound
    at HR 256, batch 32, is the operations' (2.73 TFLOP a step)."""
    from torch.utils.flop_counter import FlopCounterMode

    sys.path.insert(0, REPO)
    import chip_smoke

    m = residual_attention_unet_superres(magnification_factor=2)
    with FlopCounterMode(display=False) as fc:
        m(torch.zeros(2, 32, 32, 3), torch.ones(2), torch.zeros(2, 16, 16, 3), train=True)
    counts = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    assert chip_smoke.train_flops(32, 2) == 3 * (counts["aten.convolution"] + counts["aten.addmm"])
    ms, by = chip_smoke.train_bound(256, 32, 4_383_058)
    assert by == "operations"
    assert chip_smoke.train_flops(256, 32) == pytest.approx(2.73e12, rel=2e-3)
    assert ms == pytest.approx(chip_smoke.train_flops(256, 32) / chip_smoke.PEAK_BF16 * 1e3)


def test_the_fourth_slice_modules_are_guarded():
    """The modules of packed_head and packed_conv are among what the import
    guards above check."""
    checked = {os.path.relpath(p, PORT) for p in _port_sources() if p.startswith(PORT)}
    for mod in ("ops/packed_head.py", "ops/packed_conv.py"):
        assert mod.replace("/", os.sep) in checked


def test_chip_smoke_fourth_slice_flops_are_the_nonzero_weights():
    """Per s2d pixel, the multiply-adds behind packed_head's and the level-1
    tap_block's bounds are exactly the entries of the weights they take that
    are not structural zeros, and the tap_block kernels' issued products the
    weight entries they multiply; packed_conv's are the model's level-1
    convs its docstring names (conv_block1.conv2, 64->64, and up_conv1,
    192->64)."""
    sys.path.insert(0, REPO)
    import chip_smoke

    def nnz(*ws):
        return sum(int((w != 0).sum()) for w in ws)

    with torch.random.fork_rng():
        # seeded: an unseeded draw may hold an exact 0.0 among its ~10^5 entries
        torch.manual_seed(0)
        m = residual_attention_unet_superres(magnification_factor=2,
                                             **chip_smoke.CONFIGS["packed"]).eval()
        kl = residual_attention_unet_superres(
            magnification_factor=2,
            **chip_smoke.CONFIGS["l1"]).eval().prepare_s2d_kernels(torch.float32)
    kp = m.prepare_s2d_kernels(torch.float32)["packed_head"]
    assert chip_smoke.head_flops(2, 64, 64) == 2 * 2 * 64 * 64 * nnz(kp["up4"], kp["at"])
    for key, c4, co4, skip in (("tap_block", 64, 128, True), ("tap_block1", 128, 256, False)):
        dense, issued = chip_smoke.block_flops(2, 32, 32, c4, co4, skip)
        assert dense == 2 * 2 * 32 * 32 * nnz(kl[key]["w1"], kl[key]["w2"])
        # the bf16 kernels issue X1 against W1's conv1 (and skip) columns,
        # im2col(h) against W2, and only the shortcut's 4 centre row blocks
        # (4 pieces x Ci rows = c4 rows of W1's last co4 columns)
        w1_conv = kl[key]["w1"][:, :-co4]
        assert issued == 2 * 2 * 32 * 32 * (w1_conv.numel() + kl[key]["w2"].numel() + c4 * co4)
    c2, uc1 = _macs(m.conv_blocks[1].conv2[0], m.up_convs[1])
    assert chip_smoke.pconv_flops(2, 64, 64, 64, 64) == 2 * 2 * 64 * 64 * c2
    assert chip_smoke.pconv_flops(2, 64, 64, 192, 64) == 2 * 2 * 64 * 64 * uc1


def test_chip_smoke_bounds_of_the_fourth_slice_kernels():
    """At B=48 bf16: packed_head (3.25 GFLOP, 80.3 MB) and packed_conv
    64->64 are bound by their bytes, packed_conv 192->64 and the level-1
    tap_block (22.5 GFLOP) by their operations."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    assert cs.head_flops(48, 64, 64) == pytest.approx(3.246e9, rel=1e-3)
    ms, by = cs.head_bound(48, 64, 64, 2, cs.PEAK_BF16)
    assert by == "bytes" and ms == pytest.approx(
        2 * (48 * 64 * 64 * (64 + 128 + 12) + 16 * 64 * 12 + 9 * 128 * 12) / 3.35e12 * 1e3)
    ms, by = cs.pconv_bound(48, 64, 64, 64, 64, 2, cs.PEAK_BF16)
    assert by == "bytes" and ms == pytest.approx(
        2 * (48 * 64 * 64 * 128 + 9 * 64 * 64 + 64) / 3.35e12 * 1e3)
    ms, by = cs.pconv_bound(48, 64, 64, 192, 64, 2, cs.PEAK_BF16)
    assert by == "operations" and ms == pytest.approx(cs.pconv_flops(48, 64, 64, 192, 64)
                                                      / cs.PEAK_BF16 * 1e3)
    dense, _ = cs.block_flops(48, 32, 32, 128, 256, skip=False)
    assert dense == pytest.approx(22.55e9, rel=1e-3)
    ms, by = cs.block_bound(48, 32, 32, 128, 256, 2, cs.PEAK_BF16, skip=False)
    assert by == "operations" and ms == pytest.approx(dense / cs.PEAK_BF16 * 1e3)


@pytest.mark.parametrize("name,tap_block,gates,packed", [
    ("block", 1, 0, 0), ("packed", 1, 0, 1), ("l1", 2, 0, 0), ("l1_fused", 2, 1, 0),
    ("stem", 0, 2, 0)])
def test_chip_smoke_per_forward_counts_the_new_paths(name, tap_block, gates, packed):
    """The launches chip_smoke.py expects of one forward: 'l1' runs
    tap_block twice and, with use_pallas, only gate 0 through the fused
    gate; packed_head runs once on the unfused tail; packed_conv never."""
    sys.path.insert(0, REPO)
    import chip_smoke

    want = chip_smoke.per_forward(name)
    assert (want["tap_block"], want["fused_attention_gate"], want["packed_head"]) == (
        tap_block, gates, packed)
    assert want["packed_conv"] == 0


def test_the_fifteenth_slice_modules_are_guarded():
    """The data- and tensor-parallel modules are among what the import
    guards above check, and importing them loads none of the forbidden
    packages."""
    checked = {os.path.relpath(p, PORT) for p in _port_sources() if p.startswith(PORT)}
    for mod in ("parallel/__init__.py", "parallel/sharding.py", "parallel/tensor.py"):
        assert mod.replace("/", os.sep) in checked
    code = ("import sys\nimport diffusionremotesensing_tpu_torch.parallel.tensor\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n" % (FORBIDDEN,)
            + "print(bad); sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_the_eighteenth_slice_modules_are_guarded():
    """The inference helpers and the class-grid generator are among what the
    import guards above check, and importing them loads no forbidden
    package (matplotlib only when a plot is drawn)."""
    checked = {os.path.relpath(p, PORT) for p in _port_sources() if p.startswith(PORT)}
    for mod in ("superres_and_NDVIgen.py", "imgs_generator.py", "io.py"):
        assert mod in checked
    code = ("import sys\nimport diffusionremotesensing_tpu_torch.superres_and_NDVIgen\n"
            "import diffusionremotesensing_tpu_torch.imgs_generator\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n" % (FORBIDDEN,)
            + "print(bad); sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_an_orbax_round_trip_loads_nothing_forbidden(tmp_path):
    """The port writes an Orbax directory and reads it back through
    tensorstore alone: in a fresh interpreter neither orbax nor JAX is
    loaded."""
    pytest.importorskip("tensorstore")
    code = ("import sys\n"
            "from diffusionremotesensing_tpu_torch.io import OrbaxSnapshotter, load_snapshot\n"
            "from diffusionremotesensing_tpu_torch.models.unet import "
            "residual_attention_unet_generation\n"
            "m = residual_attention_unet_generation(num_classes=2)\n"
            f"w = OrbaxSnapshotter({str(tmp_path / 'ckpt')!r})\n"
            "w.save(m, 4)\nw.close()\n"
            f"state, epochs = load_snapshot({str(tmp_path / 'ckpt')!r})\n"
            "m.load_state_dict(state)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n" % (FORBIDDEN,)
            + "print(epochs, bad); sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0 and r.stdout.startswith("4 []"), r.stdout + r.stderr


def test_chip_smoke_task_scoring_is_learning_checks():
    """chip_smoke.py's copies of benchmarks/learning_check.py's SAR pairs,
    class images, classifier and diversity statistic compute what the
    originals compute; its package probe imports nothing."""
    from benchmarks import learning_check as lc

    sys.path.insert(0, REPO)
    import chip_smoke as cs

    assert (cs.SAR_SIZE, cs.GEN_SIZE, cs.GEN_CLASSES) == (lc.SAR_SIZE, lc.GEN_SIZE, lc.GEN_CLASSES)
    a, b = np.random.default_rng(10_000), np.random.default_rng(10_000)
    for _ in range(3):
        for x, y in zip(cs._sar_pair(a, cs.SAR_SIZE), lc._sar_pair(b, lc.SAR_SIZE)):
            assert np.array_equal(x, y)
    a, b = np.random.default_rng(23), np.random.default_rng(23)
    imgs = np.stack([cs._gen_image(a, n) for n in cs.GEN_CLASSES for _ in range(3)])
    assert np.array_equal(imgs, np.stack([lc._gen_image(b, n) for n in lc.GEN_CLASSES
                                          for _ in range(3)]))
    f = imgs.astype(np.float32) / 255.0
    labels = np.repeat(np.arange(4), 3)
    assert np.array_equal(cs.classify_by_pattern(f), lc.classify_by_pattern(f))
    assert cs._color_diversity(f, labels, 4) == pytest.approx(lc._color_diversity(f, labels, 4),
                                                              rel=1e-12)
    before = set(sys.modules)
    found = cs.checkpoint_packages()
    assert set(found) == {"tensorstore", "zstandard", "orbax"}
    assert not {m for m in set(sys.modules) - before if m.split(".")[0] in FORBIDDEN | LAZY_ONLY}
