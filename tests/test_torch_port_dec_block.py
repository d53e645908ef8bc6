"""ops/dec_block.py of the port: the BN-folded weights against the
reference package's build_dec_weights, the plain version against its Pallas
dec_block (interpret mode, head output unpacked with unpack_v8; float32, the
reference's own tolerances: 2e-5 for h and the strips, 5e-4 for the head,
whose 1024-term sums add up the differences), the wrapper's CPU path and
checks, and csrc/dec_block.cu compiled with g++ under the CUDA emulation of
tests/torch_port_helpers.py, held against the plain version. The card runs
the real kernels in chip_smoke.py."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu.ops.att_block import unpack_v8
from diffusionremotesensing_tpu.ops.dec_block import (
    _pair3,
    build_dec_weights as jax_build_dec_weights,
    dec_block as jax_dec_block,
)
from diffusionremotesensing_tpu.ops.packed_head import kpack_weights
from diffusionremotesensing_tpu_torch.ops.dec_block import (
    build_dec_weights,
    dec_block,
    dec_block_plain,
)
from tests.torch_port_helpers import compile_emulated

CA, CB, CM = 128, 64, 64


def _raw(seed):
    rng = np.random.default_rng(seed)

    def r(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    bn = {"scale": 1 + r(CM, scale=0.2), "bias": r(CM, scale=0.1), "mean": r(CM, scale=0.1),
          "var": np.abs(r(CM, scale=0.2)) + 0.5}
    return {"w_uc1": r(3, 3, CA + CB, CM, scale=0.08), "b_uc1": r(CM, scale=0.1),
            "w_up2": r(3, 3, CM, CM, scale=0.08), "b_up2": r(CM, scale=0.1), "bn": bn,
            "k4": r(4, 4, CM, 12, scale=0.1)}


def _jax_w(p):
    j = {k: ({n: jnp.asarray(a) for n, a in v.items()} if isinstance(v, dict) else jnp.asarray(v))
         for k, v in p.items()}
    return jax_build_dec_weights(j["w_uc1"], j["b_uc1"], CA, j["w_up2"], j["b_up2"], j["bn"], j["k4"])


def _port_w(p):
    t = {k: ({n: torch.from_numpy(a) for n, a in v.items()} if isinstance(v, dict)
             else torch.from_numpy(v)) for k, v in p.items()}
    return build_dec_weights(t["w_uc1"], t["b_uc1"], t["w_up2"], t["b_up2"], t["bn"], t["k4"])


def _inputs(seed, B, H, W):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, W, CA)).astype(np.float32) * 0.5,
            rng.standard_normal((B, H, W, CB)).astype(np.float32) * 0.5,
            np.maximum(rng.standard_normal((B, CM)), 0).astype(np.float32) * 0.3)


@pytest.fixture(scope="module")
def raw():
    return _raw(0)


def test_build_dec_weights_matches_reference(raw):
    want = _jax_w(raw)
    got = {k: v.numpy() for k, v in _port_w(raw).items()}
    # the reference splits and pairs the conv kernels for its lanes; the
    # port keeps them whole
    np.testing.assert_array_equal(got["wa"][:, :, :CA], np.asarray(want["wau"]))
    wap, wal = _pair3(jnp.asarray(got["wa"][:, :, CA:]))
    np.testing.assert_array_equal(np.asarray(wap), np.asarray(want["wap"]))
    np.testing.assert_array_equal(np.asarray(wal), np.asarray(want["wal"]))
    wbp, wbl = _pair3(jnp.asarray(got["wb"]))
    np.testing.assert_allclose(np.asarray(wbp), np.asarray(want["wbp"]), atol=1e-6)
    np.testing.assert_allclose(np.asarray(wbl), np.asarray(want["wbl"]), atol=1e-6)
    for k in ("ba", "bb"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(np.asarray(kpack_weights(jnp.asarray(got["k4"]))),
                                  np.asarray(want["k4p"]))
    assert got["k4k"].shape == (16 * CM, 16) and not got["k4k"][:, 12:].any()
    np.testing.assert_array_equal(got["k4k"][:, :12], raw["k4"].reshape(16 * CM, 12))


def test_plain_matches_reference_kernel(raw):
    xa, xb, te = _inputs(1, 2, 16, 8)  # two of the reference's 8-row packed groups
    h, r0, c0, outp = jax_dec_block(jnp.asarray(xa), jnp.asarray(xb), jnp.asarray(te), _jax_w(raw),
                                    interpret=True)
    got = dec_block_plain(*(torch.from_numpy(a) for a in (xa, xb, te)), _port_w(raw))
    for g, w, tol in zip(got, (h, r0, c0, unpack_v8(outp, 12)), (2e-5, 2e-5, 2e-5, 5e-4)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol)


def test_plain_bf16_rounds_like_reference(raw):
    xa, xb, te = _inputs(2, 1, 8, 8)
    wj = {k: v.astype(jnp.bfloat16) for k, v in _jax_w(raw).items()}
    want = jax_dec_block(*(jnp.asarray(a, jnp.bfloat16) for a in (xa, xb, te)), wj, interpret=True)
    wt = {k: v.bfloat16() for k, v in _port_w(raw).items()}
    got = dec_block_plain(*(torch.from_numpy(a).bfloat16() for a in (xa, xb, te)), wt)
    want = list(want[:3]) + [unpack_v8(want[3], 12)]
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        w32 = np.asarray(w.astype(jnp.float32))
        # h, h + te, hh and out rounded to bf16 after float32 sums in
        # different orders: one ulp apart at a rounding boundary
        np.testing.assert_allclose(g.float().numpy(), w32, atol=1e-2 * max(1.0, np.abs(w32).max()))


def test_wrapper_cpu_path_is_the_plain_version_and_not_counted(raw):
    w = _port_w(raw)
    args = [torch.from_numpy(a) for a in _inputs(3, 1, 8, 8)]
    before = dec_block.launches
    for g, p in zip(dec_block(*args, w), dec_block_plain(*args, w)):
        assert torch.equal(g, p)
    assert dec_block.launches == before


def test_wrapper_refuses_other_devices(raw):
    w = {k: v.to("meta") for k, v in _port_w(raw).items()}
    with pytest.raises(ValueError):
        dec_block(torch.empty((1, 8, 8, CA), device="meta"), torch.empty((1, 8, 8, CB), device="meta"),
                  torch.empty((1, CM), device="meta"), w)


_LAUNCHER = r"""
// bfloat16: the three wgmma kernels (concat, body, head) over `blocks`
// persistent blocks, each walking tiles blockIdx.x, blockIdx.x + blocks, ...;
// float32: the two FMA kernels, a block per pixel block and per tile
extern "C" void emu_launch(const void* const* p, void* const* o, int B, int H, int W,
                           int is_bf16, int blocks) {
  auto in = [&](int i) { return static_cast<const float*>(p[i]); };
  auto out = [&](int i) { return static_cast<float*>(o[i]); };
  if (!is_bf16) {
    const long long total = (long long)B * H * W;
    emu_run({unsigned((total + MP - 1) / MP), 1, 1}, NTHREADS,
            [=] { dec_concat_f32_kernel(in(0), in(1), in(2), in(3), out(0), B, H, W); });
    emu_run({unsigned((W + TILE - 1) / TILE), unsigned((H + TILE - 1) / TILE), unsigned(B)},
            NTHREADS, [=] {
              dec_tail_f32_kernel(out(0), in(4), in(5), in(6), in(7), out(1), out(2), out(3), H, W);
            });
    return;
  }
  using C3 = Tc<CONCAT>;
  using C4 = Tc<HEAD>;
  auto slab = [&](const void* t, long long c, int sw, int sh) {
    return sm90::TensorMap{t, {c, W, H, B}, {2, 2 * c, 2 * c * W, 2 * c * W * H}, {64, sw, sh, 1}};
  };
  const sm90::TensorMap xa = slab(p[0], CA, C3::SW, C3::SH), xb = slab(p[1], CB, C3::SW, C3::SH);
  const sm90::TensorMap hm = slab(o[0], CM, C3::SW, C3::SH), hhm = slab(o[4], CM, C4::SW, C4::SH);
  const sm90::TensorMap wa{p[2], {CM, 9 * CK, 1, 1}, {2, 2 * CM, 0, 0}, {CM, 64, 1, 1}};
  const sm90::TensorMap wb{p[5], {CM, 9 * CM, 1, 1}, {2, 2 * CM, 0, 0}, {CM, 64, 1, 1}};
  const sm90::TensorMap k4{p[7], {NPAD, 16 * CM, 1, 1}, {2, 2 * NPAD, 0, 0}, {NPAD, 64, 1, 1}, 32};
  auto bf = [&](int i) { return static_cast<const __nv_bfloat16*>(p[i]); };
  auto bo = [&](int i) { return static_cast<__nv_bfloat16*>(o[i]); };
  const dim3 grid{unsigned(blocks), 1, 1};
  emu_run(grid, TC_THREADS, [=] {
    dec_tc_kernel<CONCAT>(xa, xb, wa, bf(3), nullptr, bo(0), nullptr, nullptr, B, H, W);
  });
  emu_run(grid, TC_THREADS, [=] {
    dec_tc_kernel<BODY>(hm, hm, wb, bf(6), bf(4), bo(4), bo(1), bo(2), B, H, W);
  });
  emu_run(grid, TC_THREADS, [=] {
    dec_tc_kernel<HEAD>(hhm, hhm, k4, nullptr, nullptr, bo(3), nullptr, nullptr, B, H, W);
  });
}
extern "C" int emu_smem(int mode) {
  return mode == 0 ? Tc<CONCAT>::BYTES : mode == 1 ? Tc<BODY>::BYTES : Tc<HEAD>::BYTES;
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    lib = compile_emulated("dec_block", _LAUNCHER, tmp_path_factory.mktemp("dec_emu"))
    lib.emu_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5
    lib.emu_smem.argtypes = [ctypes.c_int]
    return lib


def _run_emulated(lib, raw, B, H, W, dtype, blocks=None):
    """One emulated call held against the plain version; bfloat16 runs on
    `blocks` persistent blocks (default one per 8 x 32 tile, as on a card
    with more SMs than tiles)."""
    w = {k: v.to(dtype).contiguous() for k, v in _port_w(raw).items()}
    xa, xb, te = (torch.from_numpy(a).to(dtype) for a in _inputs(4, B, H, W))
    outs = [torch.empty(s, dtype=dtype) for s in ((B, H, W, CM), (B, 1, W, CM), (B, H, 1, CM),
                                                  (B, H, W, 12), (B, H, W, CM))]
    ins = (ctypes.c_void_p * 8)(*(t.data_ptr() for t in (xa, xb, w["wa"], w["ba"], te, w["wb"],
                                                         w["bb"], w["k4k"])))
    tiles = B * -(-H // 8) * -(-W // 32)
    lib.emu_launch(ins, (ctypes.c_void_p * 5)(*(t.data_ptr() for t in outs)), B, H, W,
                   int(dtype == torch.bfloat16), tiles if blocks is None else blocks)
    # float32: the same products summed in another order; bfloat16: the
    # rounded intermediates on either side of a boundary (chip_smoke.py)
    tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2}[dtype]
    for name, got, want in zip(("h", "hh row 0", "hh col 0", "out"), outs,
                               dec_block_plain(xa, xb, te, w)):
        want = want.float()
        err = (got.float() - want).abs().max().item()
        assert err <= tol * max(1.0, want.abs().max().item()), (name, err)


@pytest.mark.parametrize("B,H,W,dtype", [
    (2, 5, 19, torch.float32),     # ragged tiles, several batch items, a partial pixel block
    (1, 16, 16, torch.bfloat16),   # the tensor-core path
    (1, 5, 19, torch.bfloat16),    # ... with ragged tiles
])
def test_cuda_source_emulated_matches_plain(raw, emulated, B, H, W, dtype):
    _run_emulated(emulated, raw, B, H, W, dtype)


@pytest.mark.parametrize("B,H,W,blocks", [
    (2, 16, 16, 1),   # 4 tiles on one block: 12 planes through the concat's 4 slots, 108
                      # weight pieces through its 6, 4 planes through the body's 3
    (2, 5, 19, 1),    # ragged tiles, both batch items on one block
    (1, 16, 40, 3),   # 4 tiles on 3 blocks, ragged columns
])
def test_cuda_source_emulated_bf16_persistent(raw, emulated, B, H, W, blocks):
    _run_emulated(emulated, raw, B, H, W, torch.bfloat16, blocks)


def test_smem_budget_matches_the_source(emulated):
    """The kernels' shared-memory tallies are the source note's, each within
    the 232,448 bytes a block may have."""
    assert [emulated.emu_smem(m) for m in range(3)] == [226496, 206928, 184400]
    assert max(emulated.emu_smem(m) for m in range(3)) <= 232448
