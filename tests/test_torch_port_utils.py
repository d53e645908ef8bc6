"""The port's utils (diffusionremotesensing_tpu_torch/utils.py) and
AggregationSampler.extract_patches / sample_patches against the reference
package's: psnr and ssim to 1e-12 on random images; save_image read back
by PIL exactly; the dataset organiser and the JPEG conversion give the same
files; the patch set and chunk plan exactly, sample_patches the patches
__call__ blends. And the eval tiles of benchmarks/learning_check.py as
chip_smoke.py draws them, with their LR from the on-device DownBlur within
2/255 of learning_check's PIL degradation."""

import os
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from benchmarks import learning_check as lc
from diffusionremotesensing_tpu import aggregation as jagg
from diffusionremotesensing_tpu import utils as jutils
from diffusionremotesensing_tpu_torch import aggregation as tagg
from diffusionremotesensing_tpu_torch import utils as tutils
from diffusionremotesensing_tpu_torch.data.device_degradation import make_downblur_transform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("shape", [(40, 40), (33, 47, 3), (16, 16, 1), (64, 48, 2)])
@pytest.mark.parametrize("seed", [0, 1])
def test_psnr_and_ssim_equal_the_references(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.random(shape)
    b = np.clip(a + 0.1 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    for fn in ("psnr", "ssim"):
        got, want = getattr(tutils, fn)(a, b), getattr(jutils, fn)(a, b)
        assert abs(got - want) <= 1e-12, (fn, got, want)
    assert tutils.psnr(a, a) == float("inf")
    assert tutils.ssim(a, a, data_range=2.0) == pytest.approx(jutils.ssim(a, a, data_range=2.0),
                                                              abs=1e-12)


@pytest.mark.parametrize("shape", [(20, 30, 3), (1, 12, 10, 3), (12, 10, 1), (9, 9, 4)])
def test_save_image_is_read_back_by_pil_exactly(shape, tmp_path):
    img = np.random.default_rng(3).random(shape).astype(np.float32) * 1.2 - 0.1
    path = str(tmp_path / "sub" / "img.png")
    tutils.save_image(img, path)
    want = tutils._frame_to_uint8(img).squeeze()
    np.testing.assert_array_equal(np.asarray(Image.open(path)), want)
    np.testing.assert_array_equal(want, jutils._frame_to_uint8(img).squeeze())
    jutils.save_image(img, str(tmp_path / "ref.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "ref.png")), want)


def test_save_image_other_formats_go_through_pil_and_refuse_without_it(tmp_path, monkeypatch):
    img = np.random.default_rng(4).random((8, 8, 3))
    tutils.save_image(img, str(tmp_path / "a.bmp"))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.bmp")),
                                  tutils._frame_to_uint8(img))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match=r"save_image\('b.jpg'\).*Pillow.*\.png"):
        tutils.save_image(img, str(tmp_path / "b.jpg"))
    tutils.save_image(img, str(tmp_path / "c.png"))  # PNG needs no PIL
    with pytest.raises(ImportError, match="convert_png_to_jpg"):
        tutils.convert_png_to_jpg(str(tmp_path))


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, n), root) for d, _, ns in os.walk(root)
                  for n in ns)


def test_data_organizer_and_jpeg_conversion_match_the_references(tmp_path):
    for pkg in ("port", "ref"):
        for i in range(23):
            sub = tmp_path / pkg / f"d{i % 3}"
            sub.mkdir(parents=True, exist_ok=True)
            Image.fromarray(np.full((4, 4, 3), i * 9, np.uint8)).save(sub / f"im{i}.png")
    tutils.data_organizer_superresolution(str(tmp_path / "port"), seed=5)
    jutils.data_organizer_superresolution(str(tmp_path / "ref"), seed=5)
    assert _tree(tmp_path / "port") == _tree(tmp_path / "ref")
    assert len(os.listdir(tmp_path / "port" / "train_original")) == 18
    for pkg, mod in (("port", tutils), ("ref", jutils)):
        mod.convert_png_to_jpg(str(tmp_path / pkg / "val_original"))
    assert _tree(tmp_path / "port") == _tree(tmp_path / "ref")
    for name in os.listdir(tmp_path / "port" / "val_original"):
        assert name.endswith(".jpg")
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "port" / "val_original" / name)),
            np.asarray(Image.open(tmp_path / "ref" / "val_original" / name)))


@pytest.mark.parametrize("h,w,patch,stride,mag", [(128, 128, 64, 32, 2), (40, 56, 16, 8, 2),
                                                  (64, 64, 32, 16, 4)])
def test_extract_patches_matches_the_reference(h, w, patch, stride, mag):
    img = np.random.default_rng(h + w).random((h, w, 3)).astype(np.float32)
    got, boxes = tagg.AggregationSampler(None, patch, stride, mag).extract_patches(img)
    want, jboxes = jagg.AggregationSampler(None, patch, stride, mag).extract_patches(img)
    assert boxes == jboxes
    np.testing.assert_array_equal(got, want)


class _NoisyStandIn:
    """A process whose sampler's output depends on its noise and its
    condition, so a change of noise order or of patch shows."""

    def sampler(self, fused_update=False, start_t=None):
        return lambda x_T, cond, generator=None: (
            0.05 * x_T + cond.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) * 0.8)

    def ddim_sampler(self, *a, **k):
        return self.sampler()


class _JaxStandIn:
    def sampler(self, **_):
        return lambda variables, key, x_T, cond: (
            jax.numpy.repeat(jax.numpy.repeat(cond, 2, axis=1), 2, axis=2) * 0.8 + 0.1)

    def ddim_sampler(self, *a, **k):
        return self.sampler()


class _TorchStandIn(_JaxStandIn):
    def sampler(self, **_):
        return lambda x_T, cond, generator=None: (
            cond.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) * 0.8 + 0.1)


def test_sample_patches_matches_the_reference_chunk_by_chunk():
    img = np.random.default_rng(0).random((40, 56, 3)).astype(np.float32)
    j = jagg.AggregationSampler(_JaxStandIn(), 16, 8, 2, batch_size=5)
    t = tagg.AggregationSampler(_TorchStandIn(), 16, 8, 2, batch_size=5)
    patches, _ = t.extract_patches(img)
    want = j.sample_patches(None, patches, jax.random.PRNGKey(0))
    got = t.sample_patches(patches, device="cpu")
    assert got.shape == (len(patches), 32, 32, 3)
    np.testing.assert_allclose(got, want, atol=1e-6)


def _blend(agg, out, boxes, shape):
    canvas, counts = np.zeros(shape, np.float32), np.zeros(shape[:2] + (1,), np.float32)
    wmask = agg.weight[:, :, None]
    for patch, (y0, y1, x0, x1) in zip(out, boxes):
        canvas[y0:y1, x0:x1] += patch * wmask
        counts[y0:y1, x0:x1] += wmask
    return np.clip(canvas / counts, 0.0, 1.0)


def test_sample_patches_are_the_patches_call_blends():
    """sample_patches draws the noise __call__ draws, chunk by chunk (9
    chunks of 3, past MAX_IN_FLIGHT): blended with the Gaussian weights its
    patches give __call__'s canvas."""
    img = np.random.default_rng(1).random((40, 56, 3)).astype(np.float32)
    agg = tagg.AggregationSampler(_NoisyStandIn(), 16, 8, 2, batch_size=3)
    patches, boxes = agg.extract_patches(img)
    assert len(agg.chunk_plan(len(patches))) > agg.MAX_IN_FLIGHT
    out = agg.sample_patches(patches, torch.Generator().manual_seed(7), device="cpu")
    tile = agg(img, generator=torch.Generator().manual_seed(7), device="cpu")
    np.testing.assert_array_equal(tile, _blend(agg, out, boxes, (80, 112, 3)))


def test_sample_tiles_blends_each_tiles_patches_of_one_chunk_stream():
    """Two tiles at once: their patches, concatenated, are denoised as one
    stream of chunks (a chunk holds patches of both) and each tile's are
    blended into its own canvas."""
    rng = np.random.default_rng(2)
    imgs = [rng.random((40, 56, 3)).astype(np.float32), rng.random((24, 32, 3)).astype(np.float32)]
    agg = tagg.AggregationSampler(_NoisyStandIn(), 16, 8, 2, batch_size=5)
    (pa, ba), (pb, bb) = agg.extract_patches(imgs[0]), agg.extract_patches(imgs[1])
    assert len(pa) % 5
    out = agg.sample_patches(np.concatenate([pa, pb]), torch.Generator().manual_seed(3), device="cpu")
    got = agg.sample_tiles(imgs, torch.Generator().manual_seed(3), device="cpu")
    np.testing.assert_array_equal(got[0], _blend(agg, out[:len(pa)], ba, (80, 112, 3)))
    np.testing.assert_array_equal(got[1], _blend(agg, out[len(pa):], bb, (48, 64, 3)))


def test_chip_smoke_eval_tiles_are_learning_checks():
    sys.path.insert(0, REPO)
    import chip_smoke

    erng = np.random.default_rng(0 + 10_000)  # learning_check.prepare's eval stream
    want = [lc._draw_image(erng, lc.TILE_HR) for _ in range(4)]
    got = chip_smoke.eval_tiles()
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == (256, 256, 3)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mag", [2, 4])
def test_eval_tiles_lr_from_the_device_downblur_is_learning_checks(mag):
    """The card has no PIL: its eval LR comes from the on-device DownBlur at
    blur 0.5, within 2/255 of learning_check._degrade_lr (PIL)."""
    erng = np.random.default_rng(10_000)
    tiles = np.stack([lc._draw_image(erng, lc.TILE_HR) for _ in range(4)])
    out = make_downblur_transform(lc.TILE_HR, mag, lc.BLUR_RADIUS)(
        {"hr_u8": torch.from_numpy(tiles)})
    for i, tile in enumerate(tiles):
        want = lc._degrade_lr(tile, mag)
        got = out["cond"][i].numpy()
        assert got.shape == want.shape == (256 // mag, 256 // mag, 3)
        assert np.abs(got - want).max() <= 2 / 255 + 1e-7
        # x is the tile times float32(1 / 255): an ulp from the scores' tile / 255
        np.testing.assert_allclose(out["x"][i].numpy(), tile.astype(np.float32) / 255.0,
                                   rtol=0, atol=6e-8)


def test_chip_smoke_eval_lrs_are_learning_checks_exactly():
    """The quality phase's LR is learning_check._degrade_lr's bit for bit
    (Pillow's bicubic and blur without PIL); the card's DownBlur, within
    2/255 of it, is only reported."""
    sys.path.insert(0, REPO)
    import chip_smoke

    tiles = chip_smoke.eval_tiles()
    lrs, diff = chip_smoke.eval_lrs(tiles, torch.device("cpu"))
    for lr, tile in zip(lrs, tiles):
        np.testing.assert_array_equal(lr, lc._degrade_lr(tile, 2))
    assert 0 < diff <= 2 / 255 + 1e-7


def test_infer_tiles_serves_each_image_and_refuses_a_bad_one():
    """InferenceServer.infer_tiles (the quality phase's extra draws): every
    image of the list super-resolved x2 into [0, 1], images of different
    sizes in one call; one misshapen image refuses the whole call."""
    from diffusionremotesensing_tpu_torch.convert import init_params
    from diffusionremotesensing_tpu_torch.models.unet import residual_attention_unet_superres
    from diffusionremotesensing_tpu_torch.serving import InferenceServer

    m = residual_attention_unet_superres(magnification_factor=2)
    m.load_state_dict(init_params(4, device="cpu"))
    rng = np.random.default_rng(6)
    lrs = [rng.random((16, 12, 3)).astype(np.float32), rng.random((8, 20, 3)).astype(np.float32)]
    server = InferenceServer(m, "cosine", 4, 16, device="cpu")
    try:
        outs = server.infer_tiles(lrs)
        with pytest.raises(ValueError, match="tile must be"):
            server.infer_tiles([lrs[0], np.zeros((4, 12, 3), np.float32)])
    finally:
        server.shutdown()
    assert [o.shape for o in outs] == [(32, 24, 3), (16, 40, 3)]
    for o in outs:
        assert np.isfinite(o).all() and o.min() >= 0.0 and o.max() <= 1.0


def _frames(n=4, size=16):
    rng = np.random.default_rng(7)
    return [rng.random((size, size, 3)).astype(np.float32) for _ in range(n)]


def test_gif_maker_writes_the_references_gif(tmp_path):
    """The same frames, frame duration and loop as the reference's writer."""
    tutils.gif_maker(_frames(), str(tmp_path / "port.gif"), fps=25)
    jutils.gif_maker(_frames(), str(tmp_path / "ref.gif"), fps=25)
    with Image.open(tmp_path / "port.gif") as a, Image.open(tmp_path / "ref.gif") as b:
        assert a.n_frames == b.n_frames == 4
        assert a.info.get("duration") == b.info.get("duration") == 40
        assert a.info.get("loop") == b.info.get("loop") == 0
        for i in range(4):
            a.seek(i)
            b.seek(i)
            assert np.array_equal(np.asarray(a.convert("RGB")), np.asarray(b.convert("RGB")))


def test_video_maker_writes_every_frame(tmp_path):
    import cv2

    tutils.video_maker(_frames(5, 32), str(tmp_path / "v" / "video.mp4"), fps=100)
    cap = cv2.VideoCapture(str(tmp_path / "v" / "video.mp4"))
    try:
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 5
        ok, frame = cap.read()
        assert ok and frame.shape == (32, 32, 3)
    finally:
        cap.release()


def test_save_preview_grid_writes_a_figure(tmp_path):
    rows = [(f[..., :1], f, f) for f in _frames(2)]
    tutils.save_preview_grid(rows, ["a", "b", "c"], str(tmp_path / "p" / "grid.png"))
    with Image.open(tmp_path / "p" / "grid.png") as img:
        assert img.size == (1500, 1000)  # 5 inches an image at matplotlib's 100 dpi


@pytest.mark.parametrize("writer,package,call", [
    ("video_maker", "cv2", lambda p: tutils.video_maker(_frames(1), p)),
    ("gif_maker", "imageio", lambda p: tutils.gif_maker(_frames(1), p)),
    ("save_preview_grid", "matplotlib", lambda p: tutils.save_preview_grid([_frames(1)], ["x"], p)),
])
def test_a_writer_without_its_package_names_both(writer, package, call, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, package, None)  # import raises ImportError
    with pytest.raises(ImportError, match=f"{writer} needs .*{package}"):
        call(str(tmp_path / "out"))


def test_force_cpu_is_the_callers_request(monkeypatch):
    for value, forced in (("1", True), ("", False), ("0", False)):
        monkeypatch.setenv("DRS_FORCE_CPU", value)
        assert tutils.force_cpu_if_requested() is forced
        assert tutils.default_device() == ("cpu" if forced else "cuda")
    monkeypatch.delenv("DRS_FORCE_CPU")
    assert tutils.force_cpu_if_requested() is False
