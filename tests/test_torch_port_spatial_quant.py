"""W8A8 int8 under spatial partitioning (``ops.quant`` with
``parallel.halo``): calibration band by band and the quantized forward on
bands, at tests/test_torch_port_spatial.py's size (x2, HR 64, B = 1,
float32, on the CPU):

* the port's banded ``calibrate`` over ``make_mesh(["cpu"] * k)``, k = 2
  and 4, against the reference package's ``quant.calibrate`` on
  ``spatial_sharding`` probes over conftest's 8 host devices (the dense s2d
  model, whose Pallas-free forward partitions under XLA), and against the
  port's one-device calibration in the configurations of the split
  (the 'l1' sites ``s2d.down0s`` and ``s2d.down1`` among them): every site,
  each amax within ``AMAX_RTOL``; ``quantize_for_sampling`` too;
* one quantized forward split into bands, on the reference's scales:
  against one device, every site's int8 input bit for bit on the bands'
  own rows (but at a rounding boundary) and the output within
  ``FORWARD_TOL``; against the reference's quantized forward on sharded
  inputs within ``INT8_REF_TOL`` (its reason is there); the seam rows read
  on their own;
* ``QuantSites`` under 16 band threads switching every microsecond: no
  band's maximum is lost, no halo row reaches a scale.

Two gloo ranks' banded calibration (one ``all_reduce(MAX)``) is
tests/test_torch_port_spatial.py's rank test.
"""

import copy
import functools
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu.models.unet import residual_attention_unet_superres as jax_superres
from diffusionremotesensing_tpu.ops import quant as jq
from diffusionremotesensing_tpu.parallel.sharding import make_mesh as jax_make_mesh
from diffusionremotesensing_tpu.parallel.sharding import replicated_sharding as jax_replicated
from diffusionremotesensing_tpu.parallel.sharding import spatial_sharding as jax_spatial
from diffusionremotesensing_tpu_torch.convert import from_jax_quant
from diffusionremotesensing_tpu_torch.ops import quant as tq
from diffusionremotesensing_tpu_torch.parallel import halo
from diffusionremotesensing_tpu_torch.parallel.sharding import make_mesh, spatial_sharding
from diffusionremotesensing_tpu_torch.schedules import make_schedule
from tests.test_torch_port_spatial import CONFIGS, HR, _inputs, _seams, _variables
from tests.torch_port_helpers import port_model

# each site's amax: the max of |x| over the same float32 activations,
# computed on bands (other shapes, sums in other orders) and on the whole
# image or by XLA: ~1e-7 apart (tests/test_torch_port_quant.py's bound)
AMAX_RTOL = 1e-6
# the quantized forward, relative to max |out|: the int8 products are
# exact, the rest float32 rounding, unless an activation lands within that
# rounding of a quantizer's boundary and moves one int8 step there
FORWARD_TOL = 1e-4
# against the reference's jitted forward on sharded inputs: XLA rounds the
# float32 ops between the int8 products otherwise, and at this size (~1e6
# quantized activations) some land across a boundary and move one int8
# step, which the layers after spread: the port read 5.3e-4 / 0.23 = 2.3e-3
# of max |out| from it, split or not (97.7% of the elements beyond 1e-6),
# and the reference's own forward without jit on the same sharded inputs
# read 1.2e-3 / 0.23 = 5.1e-3 from its jitted one. 1e-2 is twice the
# latter. A seam fault is the one-device test's to catch.
INT8_REF_TOL = 1e-2
T_PROBE = 40  # a probe's timestep: mostly image, where the activations spread most
DENSE_S2D = dict(s2d=True)


@functools.lru_cache(maxsize=None)
def _probe():
    x, cond = _inputs()
    return x, np.array([T_PROBE], np.int32), cond


def _torch_probe():
    x, t, cond = _probe()
    return torch.from_numpy(x), torch.from_numpy(t.astype(np.float32)), torch.from_numpy(cond)


@functools.lru_cache(maxsize=None)
def _jax_sharded():
    """The reference's dense s2d model with _variables(), its calibration on
    the probe sharded over the 8 host devices (height split, weights and t
    replicated), and its quantized forward on the default policy's scales,
    on the same sharded inputs."""
    jm = jax_superres(magnification_factor=2, s2d=True)
    mesh = jax_make_mesh()
    sp, rep = jax_spatial(mesh), jax_replicated(mesh)
    v = jax.device_put(jax.tree_util.tree_map(jnp.asarray, _variables()), rep)
    x, t, cond = _probe()
    args = (jax.device_put(x, sp), jax.device_put(t, rep), jax.device_put(cond, sp))
    tree = jq.calibrate(jm, v, [args], train=False)
    scales = jq.filter_scales(tree)
    out = jax.jit(lambda vs, *a: jm.apply(vs, *a, train=False))(jq.attach(v, scales), *args)
    return from_jax_quant(tree, "superres"), from_jax_quant(scales, "superres"), np.asarray(out)


def _split(k):
    return spatial_sharding(make_mesh(["cpu"] * k))


def _assert_scales(got, want, rtol=AMAX_RTOL):
    assert set(got) == set(want) and got
    for name, w in want.items():
        assert float(got[name]) == pytest.approx(float(w), rel=rtol), name


@pytest.mark.parametrize("k", [2, 4])
def test_banded_calibration_equals_the_reference_on_sharded_probes(k):
    want, _, _ = _jax_sharded()
    model = port_model(_variables(), **DENSE_S2D)
    _assert_scales(tq.calibrate(model, [_torch_probe()], spatial=_split(k)), want)
    assert model.quant_sites.calib is None


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("config", ["tap44_true", "conv2", "l1", "packed", "stem"])
def test_banded_calibration_equals_one_device(config, k):
    """Every site the configuration reaches (under 'l1' the stride-2 s2d
    down0 and down1, gate 1 in s2d), each amax the one device's."""
    model = port_model(_variables(), **CONFIGS[config])
    want = tq.calibrate(model, [_torch_probe()])
    got = tq.calibrate(model, [_torch_probe()], spatial=_split(k))
    _assert_scales(got, want)
    if config == "l1":
        assert {"s2d.down0s", "s2d.down1", "s2d.att1_wx"} <= set(got)


def test_quantize_for_sampling_under_a_split():
    """The probes of a sampling workload, the tap44 level and the dense
    branch both calibrated, each split in 2: the one device's quant map."""
    model = port_model(_variables(), **CONFIGS["l1"])
    x, _, cond = _torch_probe()
    ah = make_schedule("linear", 6).alpha_hat
    x0 = x.clamp(0.0, 1.0)
    maps = [tq.quantize_for_sampling(model, ah, x0, cond, torch.Generator().manual_seed(4),
                                     spatial=sp) for sp in (None, _split(2))]
    assert model.tap44 == "l1" and "s2d.blk_conv1" in maps[0]
    _assert_scales(maps[1], maps[0])


def _split_forward(model, k, args):
    """One forward of ``model`` (the quant map attached) split into k bands:
    each band a copy sharing its QuantSites, the bands' rows joined."""
    sites = model.quant_sites
    nets = [model] + [copy.deepcopy(model, {id(sites): sites}) for _ in range(k - 1)]
    with torch.no_grad():
        outs = halo.run_bands(_split(k), [lambda band, *a, net=net: net(*a, band=band)
                                          for net in nets], args)
    return torch.cat(outs, 1).numpy()


def _quantized_inputs(monkeypatch, forward):
    """``forward()`` with every int8 site's float input and its quantized
    one (NHWC) recorded, each cut to the recording band's own rows
    (``halo.own_rows``): {site: {thread name: (x, xq, sx)}}."""
    seen, current = {}, threading.local()
    real_amax, real_quantize = tq.QuantSites.amax, tq.quantize_act

    def amax(self, name, x, rows, top=False):
        current.name = name
        return real_amax(self, name, x, rows, top)

    def quantize(x, a):
        xq, sx = real_quantize(x, a)
        seen.setdefault(current.name, {})[threading.current_thread().name] = (
            halo.own_rows(x, 1).float(), halo.own_rows(xq, 1), float(sx))
        return xq, sx

    monkeypatch.setattr(tq.QuantSites, "amax", amax)
    monkeypatch.setattr(tq, "quantize_act", quantize)
    out = forward()
    monkeypatch.undo()
    return out, seen


@pytest.mark.parametrize("k", [2, 4])
def test_quantized_forward_split_equals_one_device(k, monkeypatch):
    """On the same scales, each int8 site's quantized input on the bands'
    own rows, joined, is the one device's bit for bit, but where the one
    device's x / sx sits within float32 rounding of a rounding boundary
    (there one int8 step may differ: none did here); the split forward
    within FORWARD_TOL of max |out| of one device's (read 0.0), the seam
    rows on their own. A halo short at any site moves int8 values far from
    a boundary at the seams, which the first check sees."""
    _, scales, _ = _jax_sharded()
    model = tq.attach(port_model(_variables(), **DENSE_S2D), scales)
    args = _torch_probe()
    with torch.no_grad():
        one, whole = _quantized_inputs(monkeypatch, lambda: model(*args).numpy())
    got, bands = _quantized_inputs(monkeypatch, lambda: _split_forward(model, k, args))
    assert set(whole) == set(bands) == {n for n in scales if n in whole} and len(whole) > 30
    for name in whole:
        (x, xq, sx), = whole[name].values()
        parts = bands[name]
        assert len(parts) == k
        joined = torch.cat([parts[f"band-{i}"][1] for i in range(k)], 1)
        moved = joined != xq
        assert (joined.int() - xq.int()).abs().max() <= 1, name
        u = x[moved] / sx
        assert ((u - u.floor() - 0.5).abs() < 1e-4).all(), name
    scale = np.abs(one).max()
    seam = _seams(k)
    assert np.abs(got[:, seam] - one[:, seam]).max() <= FORWARD_TOL * scale
    assert np.abs(got - one).max() <= FORWARD_TOL * scale


@pytest.mark.parametrize("k", [2, 4])
def test_quantized_forward_split_equals_the_reference(k):
    """The split forward against the reference's quantized forward, jitted
    on the sharded inputs, both on the reference's scales: within
    INT8_REF_TOL of max |out|, the seam rows on their own. That is as
    close as the reference's own two executions agree at this size, and
    looser than int8's own effect here (the exact forward reads 8.3e-3 of
    max |out| from the quantized one): the one-device test holds the int8
    values themselves, and tests/test_torch_port_quant.py the forward on
    the reference's scales where no activation crosses a boundary."""
    _, scales, want = _jax_sharded()
    model = tq.attach(port_model(_variables(), **DENSE_S2D), scales)
    args = _torch_probe()
    got = _split_forward(model, k, args)
    scale = np.abs(want).max()
    seam = _seams(k)
    assert np.abs(got[:, seam] - want[:, seam]).max() <= INT8_REF_TOL * scale
    assert np.abs(got - want).max() <= INT8_REF_TOL * scale
    tq.attach(model, None)
    with torch.no_grad():
        exact = model(*args).numpy()
    assert not np.array_equal(exact, got)


def test_banded_calibration_under_thread_pressure():
    """16 bands on 16 threads, the interpreter switching threads every
    microsecond, each recording 300 sites inside a site's chain whose halo
    rows hold 1e9 (what a chain may compute wrongly near the extended
    band's edge): every site holds exactly the largest of the bands' own
    maxima."""
    k, rows, names = 16, 8, [f"site{i}" for i in range(300)]
    spatial = _split(k)
    g = torch.Generator().manual_seed(7)
    whole = torch.rand((1, k * rows, 3, 2), generator=g)
    sites = tq.QuantSites()
    sites.calib = {}

    def work(band, mine):
        def chain(x):
            up = halo.HALOS["block"][0] if band.index else 0
            down = halo.HALOS["block"][1] if band.index < k - 1 else 0
            y = x.clone()
            y[:, :up] = 1e9
            y[:, y.shape[1] - down:] = 1e9
            for j, name in enumerate(names):
                sites.amax(name, y * (1.0 + j / len(names)), rows=1)
            return x
        return band.site("block", chain, mine)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        halo.run_bands(spatial, [work] * k, (whole,))
    finally:
        sys.setswitchinterval(old)
    for j, name in enumerate(names):
        assert float(sites.calib[name]) == pytest.approx(
            float(whole.max()) * (1.0 + j / len(names)), rel=1e-6), name
