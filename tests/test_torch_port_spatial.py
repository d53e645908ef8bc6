"""Spatial partitioning of the port (``parallel.sharding.spatial_sharding``,
``parallel.halo``): one image's height split into bands over a mesh, each
band the model on its own rows, the halos exchanged by hand.

At tests/test_sharding.py's size (x2, HR 64, linear schedule, 6 steps,
B = 1; one B = 2 case), float32, on the CPU, where every kernel's wrapper
runs its plain version:

* the port's DDPM sampler split over ``make_mesh(["cpu"] * k)``, k = 2 and
  4, in the dense, 'block', fused and 'stem' configurations and in those
  whose kernels run inside a chain on an extended band: tap44 True
  (``tap_conv_pair`` and ``tap_conv``), 'conv2', 'l1' (its stride-2 s2d
  down0, ``tap_block`` at level 1 and down1 as sites of their own) and
  'block' with ``packed_head``, against the reference package's sampler
  on ``spatial_sharding`` inputs over conftest's 8 host devices, given the
  noise the reference's key chain draws (through ``noise_fn``, as
  tests/test_torch_port_quality_superres.py replays it): within 1e-4. The
  reference runs its plain forward for all of them (its s2d forwards
  compute the same function, tests/test_torch_port_s2d_model.py,
  ..._tap44_levels and ..._fused_stack hold the port's to them, and its s2d
  sampler compiles for 10-15 s on the CPU under the 8-device sharding);
  against one device within 1e-5, the rows at each seam on their own;
* a halo one row short at one site (and the head's not extended at all)
  leaves the seam rows wrong: the checks above see seams; 'l1''s three
  sites are read on one forward;
* the fused update's band layout (``item_quads``): two bands of B = 2 items
  bitwise the whole state's rows, the whole image as its band bitwise
  today's stream, in the plain version and in csrc/ancestral_update.cu under
  tests/torch_port_helpers.py's emulation (against the plain words and
  update), and the fused sampler split against one device;
* two ranks of a gloo group (tests/torch_port_mp_worker.py's run_spatial,
  one band a rank, halos by ``batch_isend_irecv``) against one process,
  the int8 calibration over the ranks too;
* training under a band and heights the split cannot take raise.

int8 under bands is tests/test_torch_port_spatial_quant.py's.
"""

import ctypes
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu import diffusion as jdiff
from diffusionremotesensing_tpu.parallel.sharding import make_mesh as jax_make_mesh
from diffusionremotesensing_tpu.parallel.sharding import replicated_sharding as jax_replicated
from diffusionremotesensing_tpu.parallel.sharding import spatial_sharding as jax_spatial
from diffusionremotesensing_tpu_torch.diffusion import make_process
from diffusionremotesensing_tpu_torch.models.unet import (
    residual_attention_unet_generation,
    residual_attention_unet_sar_to_ndvi,
)
from diffusionremotesensing_tpu_torch.ops import quant as tq
from diffusionremotesensing_tpu_torch.ops.fused_update import (
    ancestral_update,
    philox_bits_plain,
    state_quads,
    update_coefs,
)
from diffusionremotesensing_tpu_torch.parallel import halo
from diffusionremotesensing_tpu_torch.parallel.sharding import make_mesh, spatial_sharding
from diffusionremotesensing_tpu_torch.schedules import make_schedule
from tests import torch_port_mp_worker
from tests.torch_port_helpers import JAX_MODELS, compile_emulated, port_model, random_jax_variables

HR, STEPS = 64, 6
STEM = dict(s2d=True, tap44="stem", use_pallas=True, fused_att=True, dec_block=True)
CONFIGS = {
    "dense": {},
    "block": dict(s2d=True, tap44="block"),
    "fused": dict(s2d=True, tap44="block", fused_att=True, dec_block=True),
    "stem": STEM,
    "tap44_true": dict(s2d=True, tap44=True),
    "conv2": dict(s2d=True, tap44="conv2"),
    "l1": dict(s2d=True, tap44="l1"),
    "packed": dict(s2d=True, tap44="block", packed_head=True),
}
SPAWN_TIMEOUT = 300


@functools.lru_cache(maxsize=None)
def _variables():
    return random_jax_variables(seed=5, image_size=HR)


@functools.lru_cache(maxsize=None)
def _inputs(batch=1):
    rng = np.random.default_rng(40 + batch)
    return (rng.standard_normal((batch, HR, HR, 3)).astype(np.float32),
            rng.random((batch, HR // 2, HR // 2, 3)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _reference():
    """The reference's sampler on spatial_sharding inputs over the 8 host
    devices, and the per-step noise its key chain drew (i = STEPS-1 .. 2)."""
    x_T, cond = _inputs()
    key = jax.random.PRNGKey(1)
    proc = jdiff.make_process(JAX_MODELS["superres"](), "linear", STEPS, HR)
    mesh = jax_make_mesh()
    sp, rep = jax_spatial(mesh), jax_replicated(mesh)
    variables = jax.tree_util.tree_map(jnp.asarray, _variables())
    out = np.asarray(proc.sampler()(jax.device_put(variables, rep), key,
                                    jax.device_put(x_T, sp), jax.device_put(cond, sp)))
    noise, k = {}, key
    for i in range(STEPS - 1, 0, -1):
        k, kn = jax.random.split(k)
        noise[i] = np.array(jdiff._normal_packed(kn, x_T.shape, jnp.float32))
    return out, noise


@functools.lru_cache(maxsize=None)
def _process(config):
    return make_process(port_model(_variables(), **CONFIGS[config]), "linear", STEPS, HR)


@functools.lru_cache(maxsize=None)
def _port(config, k):
    """The port's DDPM image, on one device (k = 1) or split into k bands,
    given the reference's noise."""
    _, noise = _reference()
    x_T, cond = _inputs()
    spatial = spatial_sharding(make_mesh(["cpu"] * k)) if k > 1 else None
    got = _process(config).sampler(spatial=spatial)(
        torch.from_numpy(x_T), torch.from_numpy(cond),
        noise_fn=lambda i, shape: torch.from_numpy(noise[i]))
    return got.numpy()


def _seams(k, height=HR, margin=3):
    """The rows within ``margin`` of each seam between k bands."""
    rows = set()
    for j in range(1, k):
        b = j * height // k
        rows.update(range(b - margin, b + margin))
    return sorted(rows)


def _assert_split(got, want, k, tol):
    assert got.shape == want.shape and np.isfinite(got).all()
    seam = _seams(k, got.shape[1])
    assert np.abs(got[:, seam] - want[:, seam]).max() <= tol
    assert np.abs(got - want).max() <= tol


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_split_sampler_equals_the_reference_spatially_sharded_sampler(config, k):
    want, _ = _reference()
    _assert_split(_port(config, k), want, k, 1e-4)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_split_sampler_equals_one_device(config, k):
    _assert_split(_port(config, k), _port(config, 1), k, 1e-5)


@pytest.mark.parametrize("name,short", [("stem_s2d", (1, 2)), ("stem_s2d", (2, 1)),
                                        ("head", (2, 4)), ("head", (0, 0)),
                                        ("down0_s2d", (0, 0)), ("cond_up", (2, 1)),
                                        ("up", (0, 2))])
def test_a_halo_one_row_short_shows_at_the_seams(monkeypatch, name, short):
    """One site's halo cut (the head's also not extended at all, as a band
    whose head ran on its own rows and bias frame would be): the seam rows
    of the 'stem' image over 2 bands then differ from one device's."""
    monkeypatch.setitem(halo.HALOS, name, short)
    x_T, cond = (torch.from_numpy(a) for a in _inputs())
    proc = _process("stem")
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    want = proc.sampler()(x_T, cond, generator=gen()).numpy()
    got = proc.sampler(spatial=spatial_sharding(make_mesh(["cpu"] * 2)))(
        x_T, cond, generator=gen()).numpy()
    seam = _seams(2)
    assert np.abs(got[:, seam] - want[:, seam]).max() > 1e-5


L1_FORWARD_TOL = 1e-6  # one 'l1' forward split in 2 against one device (read 1.5e-8)


def _l1_forward_seams():
    """max |split - one device| over the seam rows of one forward of the
    'l1' model at t = 3, split in 2."""
    model = port_model(_variables(), **CONFIGS["l1"])
    x_T, cond = (torch.from_numpy(a) for a in _inputs())
    args = (x_T, torch.tensor([3.0]), cond)
    with torch.no_grad():
        want = model(*args)
        got = torch.cat(halo.run_bands(spatial_sharding(make_mesh(["cpu"] * 2)),
                                       [lambda band, *a: model(*a, band=band)] * 2, args), 1)
    seam = _seams(2)
    return float((got - want)[:, seam].abs().max())


@pytest.mark.parametrize("name,short", [(None, None), ("down0s", (0, 0)), ("block_s2d", (0, 1)),
                                        ("block_s2d", (1, 0)), ("down1_s2d", (0, 0))],
                         ids=["halos", "down0s", "block_s2d_below", "block_s2d_above",
                              "down1_s2d"])
def test_an_l1_halo_one_row_short_shows_at_the_seams(monkeypatch, name, short):
    """'l1''s three sites of its own (the stride-2 s2d down0, tap_block at
    level 1, down1 from s2d): with the HALOS table one forward split in 2
    is one device's within L1_FORWARD_TOL at the seams; with one site's
    halo a row short the seam rows move beyond it (read 6.2e-6 to 4.2e-4;
    the sampler's last steps scale an eps error down ~100x, so one forward
    is read). down0s needs its 2 rows above also for the even start: 1
    raises, its output not cropping to whole rows."""
    if name is None:
        assert _l1_forward_seams() <= L1_FORWARD_TOL
        monkeypatch.setitem(halo.HALOS, "down0s", (1, 0))
        with pytest.raises(ValueError, match="does not crop"):
            _l1_forward_seams()
    else:
        monkeypatch.setitem(halo.HALOS, name, short)
        assert _l1_forward_seams() > L1_FORWARD_TOL


def test_band_row_counts_follow_the_halo_table():
    """The row counts a site's chain sees on the first, inner and last band
    (the shapes chip_smoke.py holds the kernels to at HR 512)."""
    assert halo.band_row_counts("stem_s2d", 256, 2) == [130]
    assert halo.band_row_counts("stem_s2d", 256, 4) == [66, 68]
    assert halo.band_row_counts("block_s2d", 128, 4) == [33, 34]
    assert halo.band_row_counts("head", 256, 2) == [131, 132]
    assert halo.band_row_counts("head", 256, 4) == [67, 68, 71]


def test_two_items_split_in_four_with_ddim_and_the_fused_update():
    """B = 2 in the 'stem' configuration over 4 bands: DDIM-3 with eta 0.5
    and clip_x0 (the noise drawn for the whole image and sliced), and the
    fused update's T-1 steps with its own generator (each band at its
    quads), against one device within 1e-5."""
    x_T, cond = (torch.from_numpy(a) for a in _inputs(2))
    proc = _process("stem")
    spatial = spatial_sharding(make_mesh(["cpu"] * 4))
    gen = lambda: torch.Generator().manual_seed(8)  # noqa: E731
    for call in (lambda **s: proc.ddim_sampler(3, eta=0.5, clip_x0=True, **s),
                 lambda **s: proc.sampler(fused_update=True, **s)):
        want = call()(x_T, cond, generator=gen()).numpy()
        got = call(spatial=spatial)(x_T, cond, generator=gen()).numpy()
        _assert_split(got, want, 4, 1e-5)


@pytest.mark.parametrize("variant", ["generation", "sar"])
def test_the_other_two_models_split_too(variant):
    """The class-conditional model (the same UNet class) under CFG 3, whose
    one model call takes twice the batch, through ``sample`` (x_T drawn
    from the generator, then split) and with the trajectory's frames; the
    SAR->NDVI model, its condition on the HR grid (the encoder's halo in
    HR rows). HR 32, B = 2, over 2 bands: one device's images within
    1e-5."""
    with torch.random.fork_rng():
        torch.manual_seed(6)
        if variant == "generation":
            net = residual_attention_unet_generation(num_classes=4, **STEM).eval()
        else:
            net = residual_attention_unet_sar_to_ndvi(**STEM).eval()
    proc = make_process(net, "linear", STEPS, 32)
    spatial = spatial_sharding(make_mesh(["cpu"] * 2))
    gen = lambda: torch.Generator().manual_seed(2)  # noqa: E731
    if variant == "generation":
        labels = np.array([1, 3])
        want = proc.sample(2, cond=labels, cfg_scale=3.0, ddim_steps=3, generator=gen())
        got = proc.sample(2, cond=labels, cfg_scale=3.0, ddim_steps=3, generator=gen(),
                          spatial=spatial)
        _assert_split(got.numpy(), want.numpy(), 2, 1e-5)
        x_T = torch.zeros(2, 32, 32, 3)
        (want, frames_1), (got, frames_2) = (
            proc.ddim_sampler(2, cfg_scale=3.0, capture_frames=True, spatial=sp)(
                x_T, torch.from_numpy(labels)) for sp in (None, spatial))
        assert frames_2.shape == (2, 2, 32, 32, 3)
        _assert_split(frames_2.reshape(4, 32, 32, 3).numpy(),
                      frames_1.reshape(4, 32, 32, 3).numpy(), 2, 1e-5)
    else:
        rng = np.random.default_rng(9)
        x_T = torch.from_numpy(rng.standard_normal((2, 32, 32, 1)).astype(np.float32))
        cond = torch.from_numpy(rng.random((2, 32, 32, 2)).astype(np.float32))
        want = proc.sampler()(x_T, cond, generator=gen())
        got = proc.sampler(spatial=spatial)(x_T, cond, generator=gen())
    _assert_split(got.numpy(), want.numpy(), 2, 1e-5)


def test_the_exchange_under_thread_pressure():
    """16 bands (more threads than this machine's cores) with the
    interpreter switching threads every microsecond, 40 exchanges each at
    four sites' halos in turn, on a (B, H, W, C) tensor whose value is its
    row's index in the whole image: every band's extended rows are always
    exactly its neighbours' and its own, and the crop gives its own back."""
    import sys

    k, rows, turns = 16, 4, 40
    spatial = spatial_sharding(make_mesh(["cpu"] * k))
    link = halo.make_link(spatial, spatial.local_bands())
    whole = torch.arange(k * rows, dtype=torch.float32)[None, :, None, None].expand(2, -1, 3, 2)
    names = ("block", "up", "down0_s2d", "head")

    def work(i):
        band, mine = halo.Band(i, k, link), whole[:, i * rows:(i + 1) * rows].contiguous()
        seen = []
        for turn in range(turns):
            ext = []
            back = band.site(names[turn % 4], lambda x: ext.append(x) or x.clone(), mine)
            seen.append((ext[0], back))
        return seen

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = link.run([lambda i=i: work(i) for i in range(k)])
    finally:
        sys.setswitchinterval(old)
    for i, seen in enumerate(out):
        assert len(seen) == turns
        for turn, (ext, back) in enumerate(seen):
            above, below = halo.HALOS[names[turn % 4]]
            lo = i * rows - (above if i else 0)
            hi = (i + 1) * rows + (below if i < k - 1 else 0)
            assert torch.equal(ext, whole[:, lo:hi])
            assert torch.equal(back, whole[:, i * rows:(i + 1) * rows])


# ------------------------------------------------------- the update's bands

def _update_inputs(shape=(2, 8, 8, 12)):
    rng = np.random.default_rng(31)
    return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(shape).astype(np.float32)))


def test_the_band_layout_in_the_plain_update():
    """Two bands of rows [0, 3) and [3, 8) of a B = 2 state, each at its
    quads (quad0 the quads before its first row, item_quads a whole
    item's), are bitwise the whole state's rows; the whole image as its own
    band is bitwise today's stream; the quad indices are the layout's."""
    x, eps = _update_inputs()
    seed = torch.tensor([0xFACE, 0xB00C], dtype=torch.int64)
    coefs = update_coefs(make_schedule("cosine", 1500), 600)
    row, item = 8 * 12 // 4, 8 * 8 * 12 // 4
    whole = ancestral_update(x, eps, coefs, seed, 600)
    parts = [ancestral_update(x[:, a:b].contiguous(), eps[:, a:b].contiguous(), coefs, seed, 600,
                              quad0=a * row, item_quads=item) for a, b in ((0, 3), (3, 8))]
    assert torch.equal(torch.cat(parts, 1), whole)
    assert torch.equal(ancestral_update(x, eps, coefs, seed, 600, item_quads=item), whole)
    assert not torch.equal(parts[1], ancestral_update(x[:, 3:].contiguous(),
                                                      eps[:, 3:].contiguous(), coefs, seed, 600))
    assert state_quads(6, 24, 40, 3).tolist() == [24, 25, 26, 64, 65, 66]
    with pytest.raises(ValueError, match="whole quads"):
        ancestral_update(x[:, :1, :1, :3].contiguous(), eps[:, :1, :1, :3].contiguous(), coefs,
                         seed, 600, item_quads=item)


_LAUNCHER = r"""
extern "C" int emu_band(const void* x, const void* eps, const void* seed, void* out,
                        long long n, float ca, float cb, float cn, unsigned step,
                        long long quad0, long long item_quads, long long band_quads) {
  const bool vec = quads_aligned(x, eps, out, 0);
  const dim3 g = {2, 1, 1};
  if (vec)
    emu_run(g, NTHREADS, [=] { ancestral_update_kernel<float, true>((const float*)x,
        (const float*)eps, nullptr, (const long long*)seed, (float*)out, n, ca, cb, cn, step,
        quad0, item_quads, band_quads); });
  else
    emu_run(g, NTHREADS, [=] { ancestral_update_kernel<float, false>((const float*)x,
        (const float*)eps, nullptr, (const long long*)seed, (float*)out, n, ca, cb, cn, step,
        quad0, item_quads, band_quads); });
  return vec;
}
extern "C" void emu_band_bits(const void* seed, void* out, long long n, unsigned step,
                              long long quad0, long long item_quads, long long band_quads) {
  const unsigned blocks = (unsigned)(((n + 3) / 4 + NTHREADS - 1) / NTHREADS);
  emu_run({blocks, 1, 1}, NTHREADS, [=] {
    philox_bits_kernel((const long long*)seed, (uint32_t*)out, (n + 3) / 4, step, quad0,
                       item_quads, band_quads); });
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    lib = compile_emulated("ancestral_update", _LAUNCHER, tmp_path_factory.mktemp("band_emu"))
    lib.emu_band.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_float] * 3
                             + [ctypes.c_uint] + [ctypes.c_longlong] * 3)
    lib.emu_band.restype = ctypes.c_int
    lib.emu_band_bits.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_uint]
                                  + [ctypes.c_longlong] * 3)
    return lib


def _emu(lib, x, eps, coefs, seed, step, quad0=0, item_quads=0, band_quads=0):
    out = torch.empty_like(x)
    lib.emu_band(x.data_ptr(), eps.data_ptr(), seed.data_ptr(), out.data_ptr(), x.numel(),
                 *coefs, step, quad0, item_quads, band_quads)
    return out


def test_the_band_layout_in_the_cuda_source_emulated(emulated):
    """csrc/ancestral_update.cu under the emulation: two bands of B = 2
    items bitwise the whole state's rows; the whole image as its band
    (band_quads = item_quads) bitwise the contiguous stream (band_quads =
    0); a band's generator words bitwise the plain layout's and its update
    the plain version's within 1e-5."""
    x, eps = _update_inputs()
    seed = torch.tensor([0x5EED, 0xCAFE], dtype=torch.int64)
    coefs = update_coefs(make_schedule("cosine", 1500), 444)
    row, item = 8 * 12 // 4, 8 * 8 * 12 // 4
    whole = _emu(emulated, x, eps, coefs, seed, 444)
    parts = []
    for a, b in ((0, 5), (5, 8)):
        xb, eb = x[:, a:b].contiguous(), eps[:, a:b].contiguous()
        band = (b - a) * row
        parts.append(_emu(emulated, xb, eb, coefs, seed, 444, a * row, item, band))
        words = torch.empty((xb.numel() // 4, 4), dtype=torch.int32)
        emulated.emu_band_bits(seed.data_ptr(), words.data_ptr(), xb.numel(), 444, a * row, item,
                               band)
        assert torch.equal(words.to(torch.int64) & 0xFFFFFFFF,
                           philox_bits_plain(seed, 444, xb.numel(), a * row, item, band))
        want = ancestral_update(xb, eb, coefs, seed, 444, quad0=a * row, item_quads=item)
        assert (parts[-1] - want).abs().max().item() <= 1e-5 * max(1.0, want.abs().max().item())
    assert torch.equal(torch.cat(parts, 1), whole)
    assert torch.equal(_emu(emulated, x, eps, coefs, seed, 444, 0, item, item), whole)


# ------------------------------------------------------------ two ranks

def test_two_ranks_of_a_gloo_group_equal_one_process(tmp_path):
    """The 'stem' image (DDPM and DDIM-3, the generator's noise) with its
    height split over two gloo ranks, one band a rank: both ranks hold the
    one-process image within 1e-5, and the int8 scales of one probe
    calibrated band by band, merged over the ranks by one all_reduce(MAX),
    the one process's within 1e-6 (the row-0 correction's site too, which
    only the top band owns)."""
    model = port_model(_variables(), **STEM)
    x_T, cond = (torch.from_numpy(a) for a in _inputs())
    t = torch.tensor([3.0])
    torch.save({"state": model.state_dict(), "flags": STEM, "steps": STEPS, "x_T": x_T,
                "cond": cond, "t": t, "seed": 12}, str(tmp_path / "spatial_inputs.pt"))
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=torch_port_mp_worker.run_spatial, args=(r, 2, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=SPAWN_TIMEOUT)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join()
    assert not any(alive) and [p.exitcode for p in procs] == [0, 0]
    proc = make_process(model, "linear", STEPS, HR)
    want = {"ddpm": proc.sampler()(x_T, cond, generator=torch.Generator().manual_seed(12)),
            "ddim": proc.ddim_sampler(3)(x_T, cond, generator=torch.Generator().manual_seed(12))}
    calib = tq.calibrate(proc.net, [(x_T, t, cond)])
    for r in range(2):
        got = torch.load(str(tmp_path / f"spatial{r}.pt"), weights_only=False)
        assert got["bands"] == 2 and got["local"] == [r]
        for name, w in want.items():
            _assert_split(got[name].numpy(), w.numpy(), 2, 1e-5)
        assert set(got["calib"]) == set(calib) and "s2d.head_fix_x" in calib
        for site, a in calib.items():
            assert float(got["calib"][site]) == pytest.approx(float(a), rel=1e-6), site


# ------------------------------------------------------------ refusals

def test_training_raises_under_a_split():
    model = port_model(_variables(), s2d=True, tap44="block")
    band = halo.Band(0, 2, None)
    x = torch.zeros(1, HR // 2, HR, 3)
    with pytest.raises(NotImplementedError, match="training"):
        model(x, torch.ones(1), torch.zeros(1, HR // 4, HR // 2, 3), train=True, band=band)


@pytest.mark.parametrize("height,k,match", [(72, 2, "multiple of 8 x the mesh size"),
                                            (48, 4, "multiple of 8 x the mesh size"),
                                            (32, 4, "at least the halo")])
def test_heights_the_split_cannot_take_raise(height, k, match):
    """72 over 2 and 48 over 4 are not multiples of 8 x the bands; 32 over
    4 leaves one row a band at 1/8, fewer than the bottleneck's halo."""
    proc = _process("stem")
    x_T = torch.zeros(1, height, height, 3)
    cond = torch.zeros(1, height // 2, height // 2, 3)
    with pytest.raises(ValueError, match=match):
        proc.sampler(spatial=spatial_sharding(make_mesh(["cpu"] * k)))(x_T, cond)


def test_a_split_takes_a_spatial_sharding_and_not_both():
    proc = _process("stem")
    mesh = make_mesh(["cpu"] * 2)
    with pytest.raises(TypeError, match="spatial_sharding"):
        proc.sampler(spatial=mesh)
    with pytest.raises(TypeError, match="spatial="):
        proc.sampler(mesh=spatial_sharding(mesh))
    with pytest.raises(ValueError, match="not both"):
        proc.sampler(mesh=mesh, spatial=spatial_sharding(mesh))
    sp = spatial_sharding(mesh)
    assert sp.bands == 2 and sp.local_bands() == [0, 1]
    assert sp.band_rows(64) == [(0, 32), (32, 64)]
