"""W8A8 int8 inference of the port (``ops/quant.py`` and the conv sites of
``models/``) against the reference package's ``ops/quant.py`` on the CPU:
the int8 convolution (plain, strided, input-dilated), the calibrated amax
of every site on the s2d and the plain path, the exclusion policy, the
quantized forward on the reference's own scales, the forward without a
quant map bit for bit, and the tile calibration driving the aggregation
sampler. The reference's forwards run under ``jax.jit``, as its calibration
and samplers do."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu.models.unet import init_unet_params
from diffusionremotesensing_tpu.models.unet import residual_attention_unet_superres as jax_superres
from diffusionremotesensing_tpu.ops import quant as jq
from diffusionremotesensing_tpu_torch.aggregation import AggregationSampler
from diffusionremotesensing_tpu_torch.convert import from_jax_quant, from_jax_variables
from diffusionremotesensing_tpu_torch.diffusion import make_process
from diffusionremotesensing_tpu_torch.models.unet import ResidualAttentionUNet
from diffusionremotesensing_tpu_torch.models.unet import residual_attention_unet_superres
from diffusionremotesensing_tpu_torch.ops import quant as tq
from diffusionremotesensing_tpu_torch.ops.resize import resize_bicubic_keys
from diffusionremotesensing_tpu_torch.ops.s2d import conv_nhwc
from diffusionremotesensing_tpu_torch.schedules import make_schedule

# the int8 convolution: the quantized operands and the int32 accumulators are
# integers, equal exactly; the dequantized output is one float32 product of
# the same numbers, within 1e-6 of its largest
CONV_RTOL = 1e-6
# each site's calibrated amax: the max of |x| where x is the same float32
# activation computed by two libraries (~1e-7 apart; 8.9e-7 read here)
AMAX_RTOL = 1e-6
# the quantized forward on the reference's scales, relative to max |out|:
# the int8 products are exact, so the two differ only by float32 rounding
# outside them (3.3e-7 read here), unless an activation sits within that
# rounding of a quantization boundary
FORWARD_TOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=[True, False], ids=["s2d", "plain"])
def setup(request):
    """tests/test_quant.py's _superres_setup sizes: HR 16, batch 2, the
    reference's init at PRNGKey(0), carried into the port."""
    s2d = request.param
    jm = jax_superres(magnification_factor=2, s2d=s2d)
    v = init_unet_params(jm, jax.random.PRNGKey(0), image_size=16)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.array([100, 900], np.int32)
    cond = rng.random((2, 8, 8, 3)).astype(np.float32)
    tm = residual_attention_unet_superres(magnification_factor=2, s2d=s2d)
    tm.load_state_dict(from_jax_variables(_np(v["params"]), _np(v["batch_stats"])))
    tm.eval()
    probes = [(x, t, cond), (0.5 * x, t, cond)]
    tree = jq.calibrate(jm, v, [tuple(jnp.asarray(a) for a in p) for p in probes], train=False)
    return dict(jm=jm, v=v, tm=tm, x=x, t=t, cond=cond, probes=probes, tree=tree)


CONV_CASES = {
    "plain": dict(window_strides=(1, 1), padding=((1, 1), (1, 1))),
    "strided": dict(window_strides=(2, 2), padding=((1, 0), (1, 0))),
    "lhs_dilation": dict(window_strides=(1, 1), padding=((1, 2), (1, 2)), lhs_dilation=(2, 2)),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv_int8_matches_the_reference(case):
    kw = CONV_CASES[case]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    w = (0.1 * rng.standard_normal((3, 3, 16, 8))).astype(np.float32)
    amax = np.float32(0.8 * np.abs(x).max())  # clipping engaged
    dn = ("NHWC", "HWIO", "NHWC")
    want = np.asarray(jq.conv_int8(jnp.asarray(x), jnp.asarray(w), jnp.asarray(amax),
                                   dimension_numbers=dn, **kw))
    xq_j, sx_j = jq._quantize_act(jnp.asarray(x), jnp.asarray(amax))
    wq_j, sw_j = jq._weight_qparams(jnp.asarray(w))
    acc_j = np.asarray(jax.lax.conv_general_dilated(
        xq_j, wq_j, kw["window_strides"], kw["padding"], lhs_dilation=kw.get("lhs_dilation"),
        dimension_numbers=dn, preferred_element_type=jnp.int32))

    xt, wt = torch.from_numpy(x), torch.from_numpy(w).permute(3, 2, 0, 1)
    xq, sx = tq.quantize_act(xt, torch.tensor(amax))
    wq, sw = tq.weight_qparams(wt)
    assert np.array_equal(xq.numpy(), np.asarray(xq_j))
    assert np.array_equal(wq.permute(2, 3, 1, 0).numpy(), np.asarray(wq_j))
    assert float(sx) == float(sx_j) and np.array_equal(sw.numpy(), np.asarray(sw_j))
    d = kw.get("lhs_dilation", (1,))[0]
    acc = tq.conv_int8_acc(xq, wq, kw["window_strides"], kw["padding"], d)
    assert acc.dtype == torch.int32 and np.array_equal(acc.numpy(), acc_j)
    assert torch.equal(acc, tq.conv_int8_acc(xq, wq, kw["window_strides"], kw["padding"], d,
                                             matmul=tq.int8_matmul_plain))
    got = tq.conv_int8(xt, wt, torch.tensor(amax), stride=kw["window_strides"],
                       padding=kw["padding"], lhs_dilation=d).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=CONV_RTOL * np.abs(want).max())


def test_grouped_conv_stays_exact():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((1, 6, 6, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 4, 3, 3)).astype(np.float32))
    got = tq.conv_int8(x, w, torch.tensor(1.0), padding=1, groups=2)
    want = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w, padding=1, groups=2)
    torch.testing.assert_close(got, want.permute(0, 2, 3, 1), rtol=0, atol=0)


def test_int8_matmul_is_the_exact_product(monkeypatch):
    """torch._int_mm's product, K and N padded to multiples of 8 and M past
    16 as the card's requires, equals the exact int32 product (the plain
    version) at the shapes the model gives (K = 27 for the first conv, N = 1
    and 3, M below 17); so does a stand-in for the card's that enforces
    those rules."""
    rng = np.random.default_rng(3)
    cases = [(5, 27, 1), (100, 27, 16), (17, 2304, 3), (48, 576, 128)]
    ops = [(torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8)),
            torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8))) for m, k, n in cases]
    for a, b in ops:
        want = a.numpy().astype(np.int64) @ b.numpy().astype(np.int64).T
        plain = tq.int8_matmul_plain(a, b)
        assert plain.dtype == torch.int32 and np.array_equal(plain.numpy(), want)
        assert torch.equal(tq.int8_matmul(a, b), plain)

    def int_mm(a, b):
        assert a.dtype == b.dtype == torch.int8 and a.shape[0] > 16
        assert a.shape[1] % 8 == 0 and b.shape[1] % 8 == 0 and a.shape[1] == b.shape[0]
        return a.to(torch.int32) @ b.to(torch.int32)

    monkeypatch.setattr(torch, "_int_mm", int_mm)
    for a, b in ops:
        assert torch.equal(tq.int8_matmul(a, b), tq.int8_matmul_plain(a, b))


def test_calibration_matches_the_reference(setup):
    """The same sites, after the name map, and the same amax at each."""
    jmap = from_jax_quant(setup["tree"], "superres")
    tmap = tq.calibrate(setup["tm"], [tuple(torch.from_numpy(a) for a in p)
                                      for p in setup["probes"]])
    assert set(tmap) == set(jmap)
    assert any(k.startswith("s2d.") for k in tmap) == setup["tm"].s2d
    for k, want in jmap.items():
        assert float(tmap[k]) == pytest.approx(float(want), rel=AMAX_RTOL), k


def test_filter_scales_drops_the_reference_sites(setup):
    jf = from_jax_quant(jq.filter_scales(setup["tree"]), "superres")
    tf = tq.filter_scales(from_jax_quant(setup["tree"], "superres"))
    assert set(tf) == set(jf) and len(tf) < len(from_jax_quant(setup["tree"], "superres"))
    assert not any("head" in k or "psi" in k or k == "output" for k in tf)
    m = tq.filter_scales({"a": torch.tensor(2.0)}, margin=1.05)
    assert float(m["a"]) == pytest.approx(2.1)


def test_quantized_forward_matches_the_reference(setup):
    """Both packages on the reference's calibrated scales (default policy)."""
    tree = jq.filter_scales(setup["tree"])
    x, t, cond = setup["x"], setup["t"], setup["cond"]
    jm = setup["jm"]
    fwd = jax.jit(lambda vs: jm.apply(vs, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond),
                                      train=False))
    want = np.asarray(fwd(jq.attach(setup["v"], tree)))
    exact = np.asarray(fwd(setup["v"]))
    tm = copy.deepcopy(setup["tm"])
    tq.attach(tm, from_jax_quant(tree, "superres"))
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (x, t, cond))).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=FORWARD_TOL * scale)
    assert np.abs(want - exact).max() > 5 * FORWARD_TOL * scale  # int8 is engaged


CONFIGS = {"plain": {}, "dense": dict(s2d=True), "tap": dict(s2d=True, tap44=True),
           "stem_fused": dict(s2d=True, tap44="stem", use_pallas=True, fused_att=True,
                              dec_block=True),
           "l1_packed": dict(s2d=True, tap44="l1", packed_head=True)}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_without_a_quant_map_the_forward_is_bitwise_unchanged(name, monkeypatch):
    """Before and after a calibration pass, and after a quant map is
    attached and detached, the forward is bitwise the one whose every site
    is the plain convolution (nn.Conv2d, nn.ConvTranspose2d, conv_nhwc)."""
    with torch.random.fork_rng():
        torch.manual_seed(0)
        m = residual_attention_unet_superres(magnification_factor=2, **CONFIGS[name]).eval()
    rng = np.random.default_rng(4)
    args = (torch.from_numpy(rng.standard_normal((2, 16, 16, 3)).astype(np.float32)),
            torch.tensor([10.0, 700.0]),
            torch.from_numpy(rng.random((2, 8, 8, 3)).astype(np.float32)))
    with torch.no_grad():
        before = m(*args)
        qmap = tq.calibrate(m, [args])
        tq.attach(m, tq.filter_scales(qmap))
        quantized = m(*args)
        tq.attach(m, None)
        after = m(*args)
        plain = copy.deepcopy(m)
        for mod in plain.modules():
            for cls in (torch.nn.Conv2d, torch.nn.ConvTranspose2d):
                if isinstance(mod, cls):
                    mod.__class__ = cls
        monkeypatch.setattr(ResidualAttentionUNet, "_qconv",
                            lambda self, label, x, w, bias=None, padding=0, stride=1, top=False:
                            conv_nhwc(x, w, bias, padding=padding, stride=stride))
        want = plain(*args)
    assert qmap and torch.equal(before, want) and torch.equal(after, want)
    assert not torch.equal(quantized, want)


def test_the_dense_branch_is_calibrated_with_a_tap44_level():
    """As the reference's quantize_for_sampling: a model with a tap44 level
    also holds the scales of the dense-s2d branch's sites."""
    with torch.random.fork_rng():
        torch.manual_seed(1)
        m = residual_attention_unet_superres(magnification_factor=2, s2d=True,
                                             tap44="block").eval()
    sch = make_schedule("cosine", 20)
    g = torch.Generator().manual_seed(3)
    x0, cond = torch.rand((2, 16, 16, 3), generator=g), torch.rand((2, 8, 8, 3), generator=g)
    qmap = tq.quantize_for_sampling(m, sch.alpha_hat, x0, cond, torch.Generator().manual_seed(0))
    assert m.tap44 == "block"
    for site in ("s2d.conv0", "s2d.blk_conv1", "s2d.blk_skip", "s2d.blk_conv2", "s2d.blk_short",
                 "s2d.down0", "s2d.att_wx", "s2d.up2_conv"):
        assert site in qmap, site
    assert not any(any(e in k for e in tq.DEFAULT_EXCLUDE) for k in qmap)


def test_sampling_probes_take_the_reference_timesteps():
    sch = make_schedule("cosine", 1500)
    x0 = jnp.zeros((1, 8, 8, 3))
    want = [int(p[1][0]) for p in jq.sampling_probes(x0, jnp.asarray(sch.alpha_hat.numpy()),
                                                      jax.random.PRNGKey(0))]
    got = tq.sampling_probes(torch.zeros((1, 8, 8, 3)), sch.alpha_hat, torch.Generator())
    assert [int(p[1][0]) for p in got] == want
    for x_t, t in got:
        assert x_t.shape == (1, 8, 8, 3) and t.dtype == torch.int64


def test_the_x0_proxy_is_the_references_bicubic():
    rng = np.random.default_rng(5)
    lr = rng.random((2, 8, 8, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(lr), (2, 16, 16, 3), "bicubic"))
    got = resize_bicubic_keys(torch.from_numpy(lr), 16, 16).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_quantize_superres_tile_drives_the_aggregation_sampler():
    with torch.random.fork_rng():
        torch.manual_seed(2)
        m = residual_attention_unet_superres(magnification_factor=2, s2d=True).eval()
    proc = make_process(m, "cosine", 20, 16)
    lr = np.random.default_rng(6).random((16, 16, 3)).astype(np.float32)
    qmap = tq.quantize_superres_tile(proc.net, proc.schedule.alpha_hat, lr, 8, 2,
                                     torch.Generator().manual_seed(21))
    assert qmap and all(float(v) > 0 for v in qmap.values())
    sampler = AggregationSampler(proc, patch_size=8, stride=4, magnification_factor=2,
                                 ddim_steps=3)
    exact = sampler(lr, generator=torch.Generator().manual_seed(0), device="cpu")
    tq.attach(proc.net, qmap)
    out = sampler(lr, generator=torch.Generator().manual_seed(0), device="cpu")
    assert out.shape == (32, 32, 3) and np.isfinite(out).all()
    assert 0.0 <= out.min() and out.max() <= 1.0 and not np.array_equal(out, exact)
