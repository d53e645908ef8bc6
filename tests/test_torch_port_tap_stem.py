"""ops/tap_block.py's stem (tap44='stem') in the port: tap_stem_block_plain
against the reference package's Pallas tap_stem_block fed with the
reference's own row slabs (build_cond_slabs of the same bias and cond, at
NH 2 and 4; interpret mode, as tests/test_tap_stem.py runs it; float32,
atol 2e-5: the same products summed in another order, conv0 in the tap
form instead of the dense s2d form), the wrapper's CPU path and refusals,
and csrc/tap_stem_block.cu compiled with g++ under the CUDA emulation of
tests/torch_port_helpers.py, held against the plain version. The card runs
the real kernel in chip_smoke.py."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu.ops.s2d import k3_to_s2d as jax_k3_to_s2d
from diffusionremotesensing_tpu.ops.tap_block import (
    build_block_weights as jax_build_block_weights,
    build_cond_slabs,
    tap_stem_block as jax_tap_stem_block,
)
from diffusionremotesensing_tpu_torch.ops import tap_block as tb
from diffusionremotesensing_tpu_torch.ops.tap_block import (
    build_block_weights,
    build_stem_weights,
    tap_block_plain,
    tap_stem_block,
    tap_stem_block_plain,
)
from diffusionremotesensing_tpu_torch.ops.tap_conv import im2col_s2d44
from tests.torch_port_helpers import TAP_TC_EMULATION, compile_emulated


def _raw(seed):
    """conv0 (3,3,3,16), its bias, and ResConvBlock-0's raw weights."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=0.1):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def bn():
        return {"scale": 1 + r(32, scale=0.2), "bias": r(32), "mean": r(32),
                "var": np.abs(r(32, scale=0.2)) + 0.5}

    block = [r(3, 3, 16, 32), r(32), bn(), r(3, 3, 16, 32), r(32), r(3, 3, 32, 32), r(32), bn(),
             r(1, 1, 16, 32), r(32), bn()]
    return r(3, 3, 3, 16, scale=0.2), r(16), block


def _as(raw, fn):
    return [{k: fn(v) for k, v in a.items()} if isinstance(a, dict) else fn(a) for a in raw]


def _inputs(seed, B, H2, W2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H2, W2, 12)).astype(np.float32)
    cond = (rng.standard_normal((B, H2, W2, 64)) * 0.5).astype(np.float32)
    te4 = (np.maximum(rng.standard_normal((B, 128)), 0) * 0.3).astype(np.float32)
    return x, cond, te4


def _port_weights(seed, dtype=torch.float32):
    w0, b0, block = _raw(seed)
    sw = build_stem_weights(torch.from_numpy(w0), build_block_weights(*_as(block, torch.from_numpy)))
    return ({k: v.to(dtype).contiguous() for k, v in sw.items()},
            torch.from_numpy(np.tile(b0, 4)).to(dtype))


@pytest.mark.parametrize("nh", [2, 4])
def test_plain_matches_reference_kernel_on_its_slabs(nh):
    w0, b0, block = _raw(0)
    x, cond, te4 = _inputs(1, 2, 8, 8)
    b0_4 = np.tile(b0, 4)
    condb = build_cond_slabs(jnp.asarray(b0_4), 2, 8, 8, cond_s2d=jnp.asarray(cond), nh=nh)
    want = jax_tap_stem_block(jnp.asarray(x), condb, jnp.asarray(te4),
                              jax_build_block_weights(*_as(block, jnp.asarray)),
                              jax_k3_to_s2d(jnp.asarray(w0)), interpret=True)
    sw, b0_t = _port_weights(0)
    got = tap_stem_block_plain(*(torch.from_numpy(a) for a in (x, cond, te4)), b0_t, sw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_plain_is_conv0_then_tap_block():
    """The stem's h_s is conv0 + the bias + cond, zero outside the image, and
    the rest is tap_block's arithmetic, in bf16 with its roundings."""
    sw, b0 = _port_weights(2, torch.bfloat16)
    x, cond, te4 = (torch.from_numpy(a).bfloat16() for a in _inputs(3, 1, 6, 10))
    h_s = (im2col_s2d44(x).float() @ sw["w0"].float() + (b0 + cond).float()).bfloat16()
    assert torch.equal(tap_stem_block_plain(x, cond, te4, b0, sw), tap_block_plain(h_s, te4, sw))


def test_wrapper_cpu_path_is_the_plain_version_and_not_counted():
    sw, b0 = _port_weights(4)
    x, cond, te4 = (torch.from_numpy(a) for a in _inputs(5, 1, 6, 6))
    before = tap_stem_block.launches
    assert torch.equal(tap_stem_block(x, cond, te4, b0, sw), tap_stem_block_plain(x, cond, te4, b0, sw))
    assert tap_stem_block.launches == before


def test_wrapper_refuses():
    sw, b0 = _port_weights(6)
    x, cond, te4 = (torch.from_numpy(a) for a in _inputs(7, 1, 6, 6))
    with pytest.raises(TypeError):
        tb._check_stem(x.half(), cond.half(), te4.half(), b0.half(),
                       {k: v.half() for k, v in sw.items()})
    with pytest.raises(ValueError, match="contiguous"):
        tb._check_stem(x, cond.transpose(1, 2).contiguous().transpose(1, 2), te4, b0, sw)
    with pytest.raises(ValueError, match="shape"):  # a 4-D row slab is not the flat features
        tb._check_stem(x, cond[..., :16], te4, b0, sw)
    with pytest.raises(ValueError, match="expected"):  # CPU weights beside an input elsewhere
        tb._check_stem(x.to("meta"), cond.to("meta"), te4.to("meta"), b0.to("meta"), sw)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tap_stem_block(x.to("meta"), cond, te4, b0, sw)


_LAUNCHER = TAP_TC_EMULATION + r"""
// bfloat16: conv0 into a scratch h_s (a block per tile), then the block on
// h_s (emu_tc, `blocks` persistent blocks); float32: the FMA kernel, a
// block per tile
extern "C" void emu_launch(const void* const* p, void* out, int B, int H2, int W2, int is_bf16,
                           int blocks) {
  if (!is_bf16) {
    const float* q[11];
    for (int i = 0; i < 11; ++i) q[i] = static_cast<const float*>(p[i]);
    constexpr int TH = Cfg<float>::TH;
    emu_run({unsigned((W2 + TW - 1) / TW), unsigned((H2 + TH - 1) / TH), unsigned(B)}, NTHREADS, [=] {
      tap_stem_kernel<float>(q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7], q[8], q[9], q[10],
                             static_cast<float*>(out), H2, W2);
    });
    return;
  }
  typedef const __nv_bfloat16* Hp;
  std::vector<__nv_bfloat16> hs((size_t)B * H2 * W2 * C14);
  __nv_bfloat16* hd = hs.data();
  emu_run({unsigned((W2 + TC_TW - 1) / TC_TW), unsigned((H2 + S_TH - 1) / S_TH), unsigned(B)},
          S_THREADS, [=] { stem_conv0_kernel((Hp)p[0], (Hp)p[1], (Hp)p[3], (Hp)p[4], hd, H2, W2); });
  const void* q[8] = {hd, p[2], p[5], p[6], p[7], p[8], p[9], p[10]};  // the block on h_s
  emu_tc<0>(q, out, B, H2, W2, blocks);
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    lib = compile_emulated("tap_stem_block", _LAUNCHER, tmp_path_factory.mktemp("stem_emu"))
    lib.emu_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5
    return lib


def _emulate(lib, B, H2, W2, dtype, blocks=0):
    sw, b0 = _port_weights(8, dtype)
    x, cond, te4 = (torch.from_numpy(a).to(dtype) for a in _inputs(9, B, H2, W2))
    out = torch.empty((B, H2, W2, 128), dtype=dtype)
    ops = dict(sw, x_s2d=x, cond_s2d=cond, te4=te4, b0=b0)
    ptrs = (ctypes.c_void_p * 11)(*(ops[k].data_ptr() for k in tb._STEM_ORDER))
    lib.emu_launch(ptrs, out.data_ptr(), B, H2, W2, int(dtype == torch.bfloat16), blocks)
    want = tap_stem_block_plain(x, cond, te4, b0, sw).float()
    # float32: the same products summed in another order; bfloat16: h_s, h
    # and the output rounded to bf16 on either side of a boundary
    tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2}[dtype]
    assert (out.float() - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())


@pytest.mark.parametrize("B,H2,W2,dtype", [
    (1, 8, 14, torch.float32),    # one float32 tile (8 x 14)
    (2, 11, 17, torch.float32),   # several tiles, ragged rows and columns
    (1, 9, 16, torch.bfloat16),   # the wgmma path (8 x 32 tiles), ragged both ways
])
def test_cuda_source_emulated_matches_plain(emulated, B, H2, W2, dtype):
    _emulate(emulated, B, H2, W2, dtype)


def test_cuda_source_emulated_bf16_persistent(emulated):
    """8 ragged tiles of two batch items on 3 persistent blocks, so that the
    block's plane and weight rings wrap."""
    _emulate(emulated, 2, 9, 33, torch.bfloat16, blocks=3)
