"""The kernels at the shapes the SAR->NDVI and class-conditional models give
them: csrc/tap_stem_block.cu at CX4 = 4 (one NDVI channel, K0 = 16: one
k-step of the wgmma product) and without a condition tensor (the class
model's bias-only stem), csrc/att_head_block.cu and csrc/dec_block.cu at
out4 = 4 (8-byte output rows), each compiled with g++ under the CUDA
emulation of tests/torch_port_helpers.py and held against its plain version
(bfloat16 1e-2 and float32 1e-4 of max |plain|, as chip_smoke.py holds the
card); the stem's plain version against the reference's Pallas kernel on
bias-only slabs; packed_head's plain version at out4 = 4 on the SAR
model's head against the reference's; and the wrappers' checks of the new
widths. The card runs the real kernels in chip_smoke.py."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu.ops.packed_head import kpack_weights, packed_head as jax_packed_head
from diffusionremotesensing_tpu.ops.s2d import k3_to_s2d as jax_k3_to_s2d
from diffusionremotesensing_tpu.ops.tap_block import (
    build_block_weights as jax_build_block_weights,
    build_cond_slabs,
    tap_stem_block as jax_tap_stem_block,
)
from diffusionremotesensing_tpu_torch.convert import init_params
from diffusionremotesensing_tpu_torch.models.unet import residual_attention_unet_sar_to_ndvi
from diffusionremotesensing_tpu_torch.ops import att_block as ab
from diffusionremotesensing_tpu_torch.ops import dec_block as db
from diffusionremotesensing_tpu_torch.ops import packed_head as ph
from diffusionremotesensing_tpu_torch.ops import tap_block as tb
from diffusionremotesensing_tpu_torch.ops.att_block import att_head_block_plain, build_att_weights
from diffusionremotesensing_tpu_torch.ops.dec_block import dec_block_plain
from diffusionremotesensing_tpu_torch.ops.packed_head import packed_head, packed_head_plain
from diffusionremotesensing_tpu_torch.ops.tap_block import (
    build_block_weights,
    build_stem_weights,
    tap_stem_block_plain,
)
from tests import test_torch_port_att_block as att_tests
from tests import test_torch_port_dec_block as dec_tests
from tests.torch_port_helpers import TAP_TC_EMULATION, compile_emulated

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _close(got, want, dtype, what=""):
    want = want.float()
    err = (got.float() - want).abs().max().item()
    assert err <= TOL[dtype] * max(1.0, want.abs().max().item()), (what, err)


# ------------------------------------------------------------------ the stem

def _stem_raw(seed, cx):
    """conv0 (3,3,cx,16), its bias, and ResConvBlock-0's raw weights."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=0.1):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def bn():
        return {"scale": 1 + r(32, scale=0.2), "bias": r(32), "mean": r(32),
                "var": np.abs(r(32, scale=0.2)) + 0.5}

    block = [r(3, 3, 16, 32), r(32), bn(), r(3, 3, 16, 32), r(32), r(3, 3, 32, 32), r(32), bn(),
             r(1, 1, 16, 32), r(32), bn()]
    return r(3, 3, cx, 16, scale=0.3), r(16), block


def _as(raw, fn):
    return [{k: fn(v) for k, v in a.items()} if isinstance(a, dict) else fn(a) for a in raw]


def _stem(seed, cx, B, H2, W2, cond, dtype=torch.float32):
    """Port weights, b0, and inputs x (B,H2,W2,4cx), cond (or None), te4."""
    w0, b0, block = _stem_raw(seed, cx)
    sw = build_stem_weights(torch.from_numpy(w0), build_block_weights(*_as(block, torch.from_numpy)))
    rng = np.random.default_rng(seed + 1)
    x = torch.from_numpy(rng.standard_normal((B, H2, W2, 4 * cx)).astype(np.float32))
    c = torch.from_numpy((rng.standard_normal((B, H2, W2, 64)) * 0.5).astype(np.float32))
    te4 = torch.from_numpy((np.maximum(rng.standard_normal((B, 128)), 0) * 0.3).astype(np.float32))
    cast = lambda t: t.to(dtype).contiguous()  # noqa: E731
    return ({k: cast(v) for k, v in sw.items()}, cast(torch.from_numpy(np.tile(b0, 4))), cast(x),
            cast(c) if cond else None, cast(te4))


@pytest.mark.parametrize("cx,cond", [(1, True), (3, False)])
def test_stem_plain_matches_reference_kernel(cx, cond):
    """The SAR stem (cx 1) against the reference kernel on its slabs of bias
    + cond, and the class stem (cx 3) on its bias-only slabs built at B = 1,
    as its model builds them; float32, interpret mode, atol 2e-5."""
    w0, b0, block = _stem_raw(10, cx)
    sw, b0_t, x, c, te4 = _stem(10, cx, 2, 8, 8, cond)
    slabs = build_cond_slabs(jnp.asarray(np.tile(b0, 4)), 2 if cond else 1, 8, 8,
                             cond_s2d=jnp.asarray(c.numpy()) if cond else None, nh=2)
    want = jax_tap_stem_block(jnp.asarray(x.numpy()), slabs, jnp.asarray(te4.numpy()),
                              jax_build_block_weights(*_as(block, jnp.asarray)),
                              jax_k3_to_s2d(jnp.asarray(w0)), interpret=True)
    got = tap_stem_block_plain(x, c, te4, b0_t, sw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


_STEM_LAUNCHER = TAP_TC_EMULATION + r"""
// the stem at CX4 (4 or 12), with or without a condition tensor: float32's
// FMA kernel a block per tile; bfloat16's conv0 into a scratch h_s, then
// the block on h_s (emu_tc, a block per item)
template <int CX4, bool COND>
static void emu_stem(const void* const* p, void* out, int B, int H2, int W2, int is_bf16) {
  if (!is_bf16) {
    const float* q[11];
    for (int i = 0; i < 11; ++i) q[i] = static_cast<const float*>(p[i]);
    constexpr int TH = Cfg<float>::TH;
    emu_run({unsigned((W2 + TW - 1) / TW), unsigned((H2 + TH - 1) / TH), unsigned(B)}, NTHREADS, [=] {
      tap_stem_kernel<float, CX4, COND>(q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7], q[8], q[9],
                                        q[10], static_cast<float*>(out), H2, W2);
    });
    return;
  }
  typedef const __nv_bfloat16* Hp;
  std::vector<__nv_bfloat16> hs((size_t)B * H2 * W2 * C14);
  __nv_bfloat16* hd = hs.data();
  emu_run({unsigned((W2 + TC_TW - 1) / TC_TW), unsigned((H2 + S_TH - 1) / S_TH), unsigned(B)},
          S_THREADS, [=] {
            stem_conv0_kernel<CX4, COND>((Hp)p[0], (Hp)p[1], (Hp)p[3], (Hp)p[4], hd, H2, W2);
          });
  const void* q[8] = {hd, p[2], p[5], p[6], p[7], p[8], p[9], p[10]};
  emu_tc<0>(q, out, B, H2, W2, 0);
}
extern "C" void emu_launch(const void* const* p, void* out, int B, int H2, int W2, int cx4,
                           int is_bf16) {
  if (cx4 == 4) emu_stem<4, true>(p, out, B, H2, W2, is_bf16);
  else emu_stem<12, false>(p, out, B, H2, W2, is_bf16);
}
"""


@pytest.fixture(scope="module")
def stem_lib(tmp_path_factory):
    lib = compile_emulated("tap_stem_block", _STEM_LAUNCHER, tmp_path_factory.mktemp("stem_tasks"))
    lib.emu_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5
    return lib


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cx,cond", [(1, True), (3, False)])
def test_stem_cuda_source_emulated_matches_plain(stem_lib, cx, cond, dtype):
    """CX4 = 4 with cond (SAR) and CX4 = 12 bias-only (class), on ragged
    tiles of both kernels' tilings; the bias-only launch gets a null cond."""
    B, H2, W2 = (1, 9, 16) if dtype == torch.bfloat16 else (1, 9, 15)
    sw, b0, x, c, te4 = _stem(12, cx, B, H2, W2, cond, dtype)
    out = torch.empty((B, H2, W2, 128), dtype=dtype)
    ops = dict(sw, x_s2d=x, cond_s2d=c, te4=te4, b0=b0)
    ptrs = (ctypes.c_void_p * 11)(*(None if ops[k] is None else ops[k].data_ptr()
                                    for k in tb._STEM_ORDER))
    stem_lib.emu_launch(ptrs, out.data_ptr(), B, H2, W2, 4 * cx, int(dtype == torch.bfloat16))
    _close(out, tap_stem_block_plain(x, c, te4, b0, sw), dtype)


def test_stem_wrapper_takes_the_new_widths_and_refuses_others():
    sw, b0, x, _, te4 = _stem(14, 1, 1, 6, 6, False)
    tb._check_stem(x, None, te4, b0, sw)  # CX4 = 4, bias-only: taken
    with pytest.raises(ValueError, match="CX4"):
        tb._check_stem(torch.zeros(1, 6, 6, 8), None, te4, b0, sw)
    with pytest.raises(ValueError, match="w0"):  # conv0's weights for 3 channels, x of 1
        sw3, *_ = _stem(14, 3, 1, 6, 6, False)
        tb._check_stem(x, None, te4, b0, sw3)
    # the CPU path of the wrapper, without cond: the plain version, not counted
    before = tb.tap_stem_block.launches
    assert torch.equal(tb.tap_stem_block(x, None, te4, b0, sw), tap_stem_block_plain(x, None, te4, b0, sw))
    assert tb.tap_stem_block.launches == before


# ------------------------------------------------------- the heads at out4 = 4

_ATT_LAUNCHER = (att_tests._LAUNCHER.replace("att_head_kernel(", "att_head_kernel<4>(")
                 .replace("att_f32_kernel(", "att_f32_kernel<4>("))
_DEC_LAUNCHER = (dec_tests._LAUNCHER.replace("dec_tc_kernel<HEAD>(", "dec_tc_kernel<HEAD, 4>(")
                 .replace("dec_tail_f32_kernel(", "dec_tail_f32_kernel<4>("))


@pytest.fixture(scope="module")
def att_lib(tmp_path_factory):
    lib = compile_emulated("att_head_block", _ATT_LAUNCHER, tmp_path_factory.mktemp("att_tasks"))
    lib.emu_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
    return lib


@pytest.fixture(scope="module")
def dec_lib(tmp_path_factory):
    lib = compile_emulated("dec_block", _DEC_LAUNCHER, tmp_path_factory.mktemp("dec_tasks"))
    lib.emu_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5
    return lib


def _att_weights(dtype):
    raw = att_tests._raw(20, out4=4)
    return {k: v.to(dtype).contiguous()
            for k, v in build_att_weights(*att_tests._as(raw, torch.from_numpy)).items()}


@pytest.mark.parametrize("B,H,W,dtype", [(1, 12, 20, torch.float32), (1, 12, 20, torch.bfloat16)])
def test_att_head_block_out4_4_emulated_matches_plain(att_lib, B, H, W, dtype):
    """out4 = 4: 8-byte output rows written as two 4-byte pairs a pixel;
    ragged M-tiles and head tiles."""
    w = _att_weights(dtype)
    x, h = (torch.from_numpy(a).to(dtype) for a in att_tests._inputs(21, B, H, W))
    out = torch.empty((B, H, W, 4), dtype=dtype)
    attn = torch.empty((B, H, W, 128), dtype=dtype)
    ptrs = (ctypes.c_void_p * 13)(x.data_ptr(), h.data_ptr(), *(w[k].data_ptr() for k in att_tests._ORDER))
    att_lib.emu_launch(ptrs, out.data_ptr(), attn.data_ptr(), B, H, W, int(dtype == torch.bfloat16), 0)
    _close(out, att_head_block_plain(x, h, w), dtype)


def _dec_raw(seed):
    raw = dec_tests._raw(seed)
    raw["k4"] = (np.random.default_rng(seed + 1).standard_normal((4, 4, 64, 4)) * 0.1).astype(np.float32)
    return raw


@pytest.mark.parametrize("B,H,W,dtype", [(1, 5, 19, torch.float32), (1, 5, 19, torch.bfloat16)])
def test_dec_block_out4_4_emulated_matches_plain(dec_lib, B, H, W, dtype):
    """out4 = 4 on ragged tiles: h, the hh strips and the 4-column head."""
    w = {k: v.to(dtype).contiguous() for k, v in dec_tests._port_w(_dec_raw(22)).items()}
    xa, xb, te = (torch.from_numpy(a).to(dtype) for a in dec_tests._inputs(23, B, H, W))
    outs = [torch.empty(s, dtype=dtype) for s in ((B, H, W, 64), (B, 1, W, 64), (B, H, 1, 64),
                                                  (B, H, W, 4), (B, H, W, 64))]
    ins = (ctypes.c_void_p * 8)(*(t.data_ptr() for t in (xa, xb, w["wa"], w["ba"], te, w["wb"],
                                                         w["bb"], w["k4k"])))
    dec_lib.emu_launch(ins, (ctypes.c_void_p * 5)(*(t.data_ptr() for t in outs)), B, H, W,
                       int(dtype == torch.bfloat16), B * -(-H // 8) * -(-W // 32))
    for name, got, want in zip(("h", "hh row 0", "hh col 0", "out"), outs,
                               dec_block_plain(xa, xb, te, w)):
        _close(got, want, dtype, name)


def test_head_wrappers_take_out4_4_and_refuse_others():
    w = _att_weights(torch.float32)
    ab._check(torch.zeros(1, 4, 4, 128), torch.zeros(1, 4, 4, 64), w)
    w8 = dict(w, at=torch.zeros(3, 3, 128, 8))
    with pytest.raises(ValueError, match="out4"):
        ab._check(torch.zeros(1, 4, 4, 128), torch.zeros(1, 4, 4, 64), w8)
    wd = dec_tests._port_w(_dec_raw(24))
    db._check(torch.zeros(1, 4, 4, 128), torch.zeros(1, 4, 4, 64), torch.zeros(1, 64), wd)
    with pytest.raises(ValueError, match="out4"):
        db._check(torch.zeros(1, 4, 4, 128), torch.zeros(1, 4, 4, 64), torch.zeros(1, 64),
                  dict(wd, k4=torch.zeros(4, 4, 64, 8)))


def test_packed_head_out4_4_on_the_sar_models_head():
    """packed_head at out4 = 4 with the SAR model's own composed head
    (prepare_s2d_kernels): the plain version against the reference's Pallas
    kernel (interpret mode, float32, atol 2e-5), the wrapper's checks and
    CPU path. The emulated kernels at out4 = 4 are in
    tests/test_torch_port_packed_head.py."""
    m = residual_attention_unet_sar_to_ndvi(s2d=True, tap44="block", packed_head=True)
    m.load_state_dict(init_params(26, "sar", device="cpu"))
    kp = m.prepare_s2d_kernels()["packed_head"]
    assert kp["up4"].shape == (4, 4, 64, 4) and kp["at"].shape == (3, 3, 128, 4)
    rng = np.random.default_rng(25)
    hh = torch.from_numpy(rng.standard_normal((1, 8, 8, 64)).astype(np.float32))
    at = torch.from_numpy(rng.standard_normal((1, 8, 8, 128)).astype(np.float32))
    want = jax_packed_head(jnp.asarray(hh.numpy()), jnp.asarray(at.numpy()),
                           kpack_weights(jnp.asarray(kp["up4"].numpy())),
                           kpack_weights(jnp.asarray(kp["at"].numpy())), interpret=True)
    got = packed_head_plain(hh, at, kp["up4"], kp["at"])
    assert got.shape == (1, 8, 8, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    ph._check(hh, at, kp["up4"], kp["at"])
    assert torch.equal(packed_head(hh, at, kp["up4"], kp["at"]), got)
