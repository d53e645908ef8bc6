"""ops/packed_conv.py of the port (an op alone: the reference model never
calls its packed_conv): the plain version against the reference package's
Pallas packed_conv (interpret mode, at the level-1 shapes of
tests/test_packed_conv.py, with and without the in-kernel bias; float32
atol 2e-5: the same products summed in another order; bfloat16 as
test_packed_conv_bf16_close), the wrapper's CPU path and refusals, and
csrc/packed_conv.cu compiled with g++ under the CUDA emulation of
tests/torch_port_helpers.py, held against the plain version. The card runs
the real kernel in chip_smoke.py."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu.ops.packed_conv import pack_conv_weights
from diffusionremotesensing_tpu.ops.packed_conv import packed_conv as jax_packed_conv
from diffusionremotesensing_tpu_torch.ops import packed_conv as pc
from diffusionremotesensing_tpu_torch.ops.packed_conv import packed_conv, packed_conv_plain
from tests.torch_port_helpers import compile_emulated


def _inputs(seed, B, h, w, ci, co):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((B, h, w, ci)) * 0.3).astype(np.float32),
            (rng.standard_normal((3, 3, ci, co)) * 0.05).astype(np.float32),
            rng.standard_normal((co,)).astype(np.float32))


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("h,w,ci,co", [
    (16, 16, 64, 64),    # conv_block1.conv2 shape family
    (16, 24, 192, 64),   # up_conv1 shape family (non-square)
    (16, 16, 32, 64),    # conv_block1.conv1 shape family
])
def test_plain_matches_reference_kernel(h, w, ci, co, with_bias):
    x, k, b = _inputs(1, 2, h, w, ci, co)
    bias = b if with_bias else None
    want = jax_packed_conv(jnp.asarray(x), pack_conv_weights(jnp.asarray(k), 2), v=2,
                           bias=None if bias is None else jnp.asarray(bias), interpret=True)
    got = packed_conv_plain(torch.from_numpy(x), torch.from_numpy(k),
                            None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_plain_bf16_close_to_reference_kernel():
    x, k, _ = (jnp.asarray(a).astype(jnp.bfloat16) for a in _inputs(2, 1, 16, 16, 64, 64))
    want = jax_packed_conv(x, pack_conv_weights(k, 2), v=2, interpret=True)
    got = packed_conv_plain(*(torch.from_numpy(np.asarray(a, np.float32)).bfloat16() for a in (x, k)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=0.05, rtol=0.05)


def test_wrapper_cpu_path_is_the_plain_version_and_not_counted():
    x, k, b = (torch.from_numpy(a) for a in _inputs(3, 1, 8, 8, 32, 64))
    before = packed_conv.launches
    assert torch.equal(packed_conv(x, k, b), packed_conv_plain(x, k, b))
    assert torch.equal(packed_conv(x, k), packed_conv_plain(x, k))
    assert packed_conv.launches == before


def test_wrapper_refuses():
    """What the launcher takes: a 3x3 kernel, Co in 16..64 by 16, Ci a
    multiple of 16 in bf16, contiguous operands of x's type and device; a
    tensor neither on the card nor on the CPU raises before any launch."""
    x, k, b = (torch.from_numpy(a) for a in _inputs(4, 1, 8, 8, 32, 64))
    with pytest.raises(TypeError):
        pc._check(x.half(), k.half(), None)
    with pytest.raises(ValueError, match="3x3"):
        pc._check(x, torch.zeros((5, 3, 32, 64)), None)
    with pytest.raises(ValueError, match="Co in"):
        pc._check(x, torch.zeros((3, 3, 32, 128)), None)
    with pytest.raises(ValueError, match="Ci % 16"):
        pc._check(torch.zeros((1, 8, 8, 40), dtype=torch.bfloat16),
                  torch.zeros((3, 3, 40, 64), dtype=torch.bfloat16), None)
    with pytest.raises(ValueError, match="bias"):
        pc._check(x, k, b[:32])
    with pytest.raises(ValueError, match="contiguous"):
        pc._check(x, k.transpose(0, 1), None)
    with pytest.raises(ValueError, match="cuda or cpu"):
        packed_conv(x.to("meta"), k.to("meta"))


_LAUNCHER = r"""
template <typename T, int NF>
static void emu_conv(const void* x, const void* w, const void* bias, void* out, int B, int H,
                     int W, int Ci) {
  emu_run({unsigned((W + TW - 1) / TW), unsigned((H + TH - 1) / TH), unsigned(B)}, NTHREADS,
          [=] {
            packed_conv_kernel<T, NF>((const T*)x, (const T*)w, (const T*)bias, (T*)out, H, W,
                                      Ci);
          });
}
template <typename T>
static void emu_co(const void* x, const void* w, const void* bias, void* out, int B, int H, int W,
                   int Ci, int Co) {
  if (Co == 64) emu_conv<T, 4>(x, w, bias, out, B, H, W, Ci);
  else emu_conv<T, 2>(x, w, bias, out, B, H, W, Ci);
}
extern "C" void emu_launch(const void* x, const void* w, const void* bias, void* out, int B, int H,
                           int W, int Ci, int Co, int is_bf16) {
  if (is_bf16) emu_co<__nv_bfloat16>(x, w, bias, out, B, H, W, Ci, Co);
  else emu_co<float>(x, w, bias, out, B, H, W, Ci, Co);
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    lib = compile_emulated("packed_conv", _LAUNCHER, tmp_path_factory.mktemp("packed_conv_emu"))
    lib.emu_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
    return lib


@pytest.mark.parametrize("B,H,W,ci,co,with_bias,dtype", [
    (1, 8, 16, 64, 64, True, torch.float32),      # 64->64, one tile
    (2, 11, 20, 32, 64, False, torch.float32),    # several tiles, ragged edges, no bias
    (1, 9, 18, 192, 64, True, torch.float32),     # 192->64, ragged
    (1, 10, 17, 16, 32, True, torch.float32),     # Co = 32
    (1, 8, 16, 64, 64, True, torch.bfloat16),     # the tensor-core path
    (1, 11, 20, 192, 64, True, torch.bfloat16),   # ... 192->64 with ragged tiles
])
def test_cuda_source_emulated_matches_plain(emulated, B, H, W, ci, co, with_bias, dtype):
    x, k, b = (torch.from_numpy(a).to(dtype).contiguous() for a in _inputs(5, B, H, W, ci, co))
    bias = b if with_bias else None
    out = torch.empty((B, H, W, co), dtype=dtype)
    emulated.emu_launch(x.data_ptr(), k.data_ptr(), None if bias is None else bias.data_ptr(),
                        out.data_ptr(), B, H, W, ci, co, int(dtype == torch.bfloat16))
    want = packed_conv_plain(x, k, bias).float()
    # float32: the same products summed in another order; bfloat16: the
    # output rounded to bf16 on either side of a boundary (chip_smoke.py)
    tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2}[dtype]
    assert (out.float() - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())
