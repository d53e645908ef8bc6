"""The port's HTTP layer (diffusionremotesensing_tpu_torch/serving.py:
serve, make_http_server, _decode_image, _encode_image) against the
reference package's on the same requests, at a tiny size on the CPU; and
the super-resolution server's tiles under fused_update.

The reference server answers with its samplers replaced by constant
stand-ins (its HTTP layer is what is compared: status codes and JSON
keys); the port's runs its model for real. Images travel as base64 PNG:
the port encodes and decodes them with its own codec, the reference with
PIL."""

import base64
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from diffusionremotesensing_tpu import serving as jserving
from diffusionremotesensing_tpu.models.unet import (
    residual_attention_unet_generation as jax_generation,
)
from diffusionremotesensing_tpu.models.unet import residual_attention_unet_superres as jax_superres
from diffusionremotesensing_tpu_torch import diffusion as tdiffusion
from diffusionremotesensing_tpu_torch import serving as tserving
from diffusionremotesensing_tpu_torch.convert import init_params
from diffusionremotesensing_tpu_torch.models.unet import (
    residual_attention_unet_generation,
    residual_attention_unet_superres,
)
from diffusionremotesensing_tpu_torch.ops.fused_update import ancestral_update

SIZE, STEPS, CLASSES = 16, 4, 10


def _jax_server(task):
    """The reference's server with constant samplers (no JAX compile)."""
    model = jax_superres(magnification_factor=2) if task == "superres" else jax_generation(
        num_classes=CLASSES)
    srv = jserving.InferenceServer(model, None, "cosine", STEPS, SIZE, task=task, max_batch=2,
                                   max_wait_ms=5)
    srv._sampler = lambda variables, key, x_T, cond: x_T * 0.0 + 0.5
    srv._agg = lambda variables, img, key=None: np.full(
        (2 * img.shape[0], 2 * img.shape[1], 3), 0.5, np.float32)
    return srv


@pytest.fixture(scope="module")
def servers():
    sr = residual_attention_unet_superres(magnification_factor=2)
    sr.load_state_dict(init_params(3, device="cpu"))
    gen = residual_attention_unet_generation(num_classes=CLASSES)
    gen.load_state_dict(init_params(3, "generation", device="cpu"))
    out = {"superres": (tserving.InferenceServer(sr, "cosine", STEPS, SIZE, max_batch=2,
                                                 max_wait_ms=5, device="cpu"),
                        _jax_server("superres")),
           "generation": (tserving.InferenceServer(gen, "cosine", STEPS, SIZE, task="generation",
                                                   max_batch=2, max_wait_ms=5, device="cpu"),
                          _jax_server("generation"))}
    https = []
    for pair in out.values():
        for srv in pair:
            httpd = srv.make_http_server(port=0)
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            https.append((httpd, srv))
    ports = {task: tuple(h.server_address[1] for h, s in https if s in pair)
             for task, pair in out.items()}
    yield ports
    for httpd, srv in https:
        httpd.shutdown()
        srv.batcher.shutdown()


def _png_b64(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _call(port, path, body=None):
    """(status, JSON reply) of GET `path`, or POST `body` (bytes or JSON) to it."""
    url = f"http://127.0.0.1:{port}{path}"
    if body is None:
        req = urllib.request.Request(url)
    else:
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
        req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


_rng = np.random.default_rng(0)
_LR = (_rng.random((8, 8, 3)) * 255).astype(np.uint8)
_TILE = (_rng.random((16, 12, 3)) * 255).astype(np.uint8)
REQUESTS = [
    ("superres", "/healthz", None, 200),
    ("superres", "/nowhere", None, 404),
    ("superres", "/superres", {"image": _png_b64(_LR)}, 200),
    ("superres", "/superres", {}, 400),
    ("superres", "/superres", {"image": _png_b64(_LR[:6])}, 400),
    ("superres", "/superres", {"image": _png_b64(_LR[..., 0])}, 400),
    ("superres", "/generate", {"label": 1}, 404),
    ("superres", "/sar_to_ndvi", {"image": _png_b64(_LR)}, 404),
    ("superres", "/superres_tile", {"image": _png_b64(_TILE)}, 200),
    ("superres", "/superres_tile", {"image": _png_b64(_TILE[:4])}, 400),
    ("superres", "/superres_tile", {}, 400),
    ("superres", "/superres", {"image": "not base64 png"}, 500),
    ("superres", "/superres", b"{not json", 500),
    ("generation", "/generate", {"label": 3}, 200),
    ("generation", "/generate", {"label": CLASSES}, 400),
    ("generation", "/generate", {}, 400),
    ("generation", "/superres_tile", {"image": _png_b64(_TILE)}, 404),
    ("generation", "/superres", {"image": _png_b64(_LR)}, 404),
    ("generation", "/healthz", None, 200),
]


@pytest.mark.parametrize("task,path,body,code", REQUESTS,
                         ids=[f"{t}{p}-{c}-{i}" for i, (t, p, _, c) in enumerate(REQUESTS)])
def test_http_codes_and_keys_match_reference(servers, task, path, body, code):
    port_port, jax_port = servers[task]
    got, want = _call(port_port, path, body), _call(jax_port, path, body)
    assert got[0] == want[0] == code
    assert sorted(got[1]) == sorted(want[1])
    if code == 200 and "image" in got[1]:
        out = np.asarray(Image.open(io.BytesIO(base64.b64decode(got[1]["image"]))))
        ref = np.asarray(Image.open(io.BytesIO(base64.b64decode(want[1]["image"]))))
        assert out.shape == ref.shape and out.dtype == np.uint8
    if code == 500:
        assert ":" in got[1]["error"]
    if path == "/healthz":
        assert got[1] == want[1] == {"status": "ok", "task": task}


@pytest.mark.parametrize("bad", ["cat", None, [1, 2], 10**19])
def test_generate_malformed_label_is_400(servers, bad):
    status, reply = _call(servers["generation"][0], "/generate", {"label": bad})
    assert status == 400 and "label" in reply["error"]


def test_http_surface(servers):
    """The superres round trip: an 8x8 LR PNG in, a 16x16 RGB PNG out."""
    status, reply = _call(servers["superres"][0], "/superres", {"image": _png_b64(_LR)})
    assert status == 200
    arr = np.asarray(Image.open(io.BytesIO(base64.b64decode(reply["image"]))))
    assert arr.shape == (16, 16, 3) and arr.dtype == np.uint8


def test_infer_tile_aggregation_endpoint(servers):
    status, reply = _call(servers["superres"][0], "/superres_tile", {"image": _png_b64(_TILE)})
    assert status == 200
    arr = np.asarray(Image.open(io.BytesIO(base64.b64decode(reply["image"]))))
    assert arr.shape == (32, 24, 3)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_images_cross_between_the_packages(channels):
    """An image the reference encodes decodes in the port to the same
    floats, and the other way round."""
    arr = np.random.default_rng(channels).random((9, 7, channels)).astype(np.float32)
    want = (np.clip(arr, 0, 1) * 255).astype(np.uint8).astype(np.float32) / 255.0
    np.testing.assert_array_equal(tserving._decode_image(jserving._encode_image(arr)), want)
    np.testing.assert_array_equal(jserving._decode_image(tserving._encode_image(arr)), want)
    assert tserving._encode_image(arr) != ""


def test_decode_image_reads_16_bit_png_over_65535():
    import cv2

    a = (np.arange(48, dtype=np.uint16).reshape(6, 8) * 1361)
    ok, enc = cv2.imencode(".png", a)
    got = tserving._decode_image(base64.b64encode(enc.tobytes()).decode())
    np.testing.assert_array_equal(got[..., 0], a.astype(np.float32) / 65535.0)


def test_superres_server_tiles_run_the_fused_update(monkeypatch):
    """A DDPM server built with fused_update=True takes its tiles through
    the fused sampler: every step's update is one ancestral_update call (on
    the CPU its plain version, counting no launch)."""
    calls = []

    def counted(*a, **k):
        calls.append(a[4])
        return ancestral_update(*a, **k)

    monkeypatch.setattr(tdiffusion, "ancestral_update", counted)
    m = residual_attention_unet_superres(magnification_factor=2)
    m.load_state_dict(init_params(3, device="cpu"))
    server = tserving.InferenceServer(m, "cosine", 5, SIZE, fused_update=True, device="cpu")
    try:
        before = ancestral_update.launches
        out = server.infer_tile(np.full((8, 12, 3), 0.5, np.float32))
        assert server._agg.fused_update
    finally:
        server.shutdown()
    assert out.shape == (16, 24, 3) and np.isfinite(out).all()
    # 8 x 12 LR at patch 8, stride 4: 2 patches in one chunk, 4 steps
    assert sorted(calls) == [1, 2, 3, 4]
    assert ancestral_update.launches == before


def test_fused_update_server_and_its_tiles_agree_on_the_sampler():
    m = residual_attention_unet_superres(magnification_factor=2)
    server = tserving.InferenceServer(m, "cosine", 5, SIZE, device="cpu")
    try:
        server.infer_tile(np.full((8, 8, 3), 0.5, np.float32))
        assert not server._agg.fused_update
    finally:
        server.shutdown()
    with pytest.raises(ValueError, match="fused_update"):
        tserving.InferenceServer(m, "cosine", 5, SIZE, fused_update=True, ddim_steps=2,
                                 device="cpu")
    assert torch.device("cpu") == server.device


def test_infer_tiles_serves_several_tiles_and_refuses_a_bad_one():
    """infer_tiles: several tiles in one call, each its own shape's result;
    one bad tile refuses the call before any is sampled."""
    m = residual_attention_unet_superres(magnification_factor=2)
    m.load_state_dict(init_params(3, device="cpu"))
    server = tserving.InferenceServer(m, "cosine", 4, SIZE, ddim_steps=2, device="cpu")
    try:
        rng = np.random.default_rng(5)
        tiles = [rng.random((8, 12, 3)).astype(np.float32), rng.random((16, 8, 3)).astype(np.float32)]
        outs = server.infer_tiles(tiles)
        assert [o.shape for o in outs] == [(16, 24, 3), (32, 16, 3)]
        assert all(np.isfinite(o).all() and 0 <= o.min() and o.max() <= 1 for o in outs)
        with pytest.raises(ValueError, match="tile must be"):
            server.infer_tiles([tiles[0], np.zeros((4, 8, 3), np.float32)])
    finally:
        server.shutdown()
