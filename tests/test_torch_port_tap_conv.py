"""ops/tap_conv.py of the port (tap44 True and 'conv2'): the plain versions
against the reference package's Pallas tap_conv and tap_conv_pair
(interpret mode, as tests/test_tap_conv.py runs them; float32, atol 2e-5:
the same products summed in another order), the wrappers' CPU path and
refusals, and csrc/tap_conv.cu compiled with g++ under the CUDA emulation
of tests/torch_port_helpers.py, held against the plain versions. The card
runs the real kernels in chip_smoke.py."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu.ops.s2d import k3_to_s2d44 as jax_k3_to_s2d44
from diffusionremotesensing_tpu.ops.tap_conv import (
    tap_conv as jax_tap_conv,
    tap_conv_pair as jax_tap_conv_pair,
)
from diffusionremotesensing_tpu_torch.ops import tap_conv as tc
from diffusionremotesensing_tpu_torch.ops.tap_conv import (
    tap_conv,
    tap_conv_pair,
    tap_conv_pair_plain,
    tap_conv_plain,
    tap_weight,
)
from tests.torch_port_helpers import compile_emulated


def _x(seed, B, H2, W2, c4):
    return np.random.default_rng(seed).standard_normal((B, H2, W2, c4)).astype(np.float32)


def _w(seed, ci, co):
    return (np.random.default_rng(seed).standard_normal((3, 3, ci, co)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("ci,co,h2", [(32, 32, 8), (16, 32, 6)])
def test_plain_matches_reference_kernel(ci, co, h2):
    x, w = _x(0, 2, h2, h2, 4 * ci), _w(1, ci, co)
    want = jax_tap_conv(jnp.asarray(x), jax_k3_to_s2d44(jnp.asarray(w)), interpret=True)
    got = tap_conv_plain(torch.from_numpy(x), tap_weight(torch.from_numpy(w)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_pair_plain_matches_reference_kernel():
    x, wa, wb = _x(2, 2, 8, 8, 64), _w(3, 16, 32), _w(4, 16, 32)
    want = jax_tap_conv_pair(jnp.asarray(x), jax_k3_to_s2d44(jnp.asarray(wa)),
                             jax_k3_to_s2d44(jnp.asarray(wb)), interpret=True)
    got = tap_conv_pair_plain(torch.from_numpy(x), tap_weight(torch.from_numpy(wa)),
                              tap_weight(torch.from_numpy(wb)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)


def test_plain_bf16_rounds_the_output_once():
    """bfloat16: the float32 product of the bf16 operands, rounded once."""
    x = torch.from_numpy(_x(5, 1, 6, 6, 128)).bfloat16()
    w = tap_weight(torch.from_numpy(_w(6, 32, 32))).bfloat16()
    got = tap_conv_plain(x, w)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, (tc.im2col_s2d44(x).float() @ w.float()).bfloat16())


def test_wrappers_cpu_path_is_the_plain_version_and_not_counted():
    x = torch.from_numpy(_x(7, 1, 8, 8, 64))
    wa, wb = (tap_weight(torch.from_numpy(_w(s, 16, 32))) for s in (8, 9))
    before = (tap_conv.launches, tap_conv_pair.launches)
    assert torch.equal(tap_conv(x, wa), tap_conv_plain(x, wa))
    for g, w in zip(tap_conv_pair(x, wa, wb), tap_conv_pair_plain(x, wa, wb)):
        assert torch.equal(g, w)
    assert (tap_conv.launches, tap_conv_pair.launches) == before


def test_wrappers_refuse():
    """What the launcher takes: float32 or bf16, contiguous operands of one
    device, 4C a multiple of 64 in bf16; a tensor that is neither on the card
    nor on the CPU raises before any launch."""
    x = torch.zeros((1, 8, 8, 64))
    w = torch.zeros((256, 128))
    with pytest.raises(TypeError):
        tc._check("tap_conv", x.half(), [w.half()])
    with pytest.raises(ValueError, match="contiguous"):
        tc._check("tap_conv", x, [w.t().contiguous().t()])
    with pytest.raises(ValueError, match="expected"):  # a CPU weight beside an input elsewhere
        tc._check("tap_conv", x.to("meta"), [w])
    with pytest.raises(ValueError, match="4C % 64"):
        tc._check("tap_conv", torch.zeros((1, 8, 8, 32), dtype=torch.bfloat16),
                  [torch.zeros((128, 128), dtype=torch.bfloat16)])
    with pytest.raises(ValueError, match="cuda or cpu"):
        tap_conv(x.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tap_conv_pair(x.to("meta"), w.to("meta"), w.to("meta"))


_LAUNCHER = r"""
template <typename T, int NW>
static void emu_conv(const void* x, const void* wa, const void* wb, void* oa, void* ob, int B,
                     int H2, int W2, int C4, int CO4) {
  emu_run({unsigned((W2 + TW - 1) / TW), unsigned((H2 + TH - 1) / TH), unsigned(B)}, NTHREADS,
          [=] {
            tap_conv_kernel<T, NW>((const T*)x, (const T*)wa, (const T*)wb, (T*)oa, (T*)ob, H2,
                                   W2, C4, CO4);
          });
}
extern "C" void emu_launch(const void* x, const void* wa, const void* wb, void* oa, void* ob,
                           int B, int H2, int W2, int C4, int CO4, int is_bf16, int pair) {
  if (is_bf16 && pair) emu_conv<__nv_bfloat16, 2>(x, wa, wb, oa, ob, B, H2, W2, C4, CO4);
  else if (is_bf16) emu_conv<__nv_bfloat16, 1>(x, wa, wb, oa, ob, B, H2, W2, C4, CO4);
  else if (pair) emu_conv<float, 2>(x, wa, wb, oa, ob, B, H2, W2, C4, CO4);
  else emu_conv<float, 1>(x, wa, wb, oa, ob, B, H2, W2, C4, CO4);
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    lib = compile_emulated("tap_conv", _LAUNCHER, tmp_path_factory.mktemp("tap_conv_emu"))
    lib.emu_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
    return lib


@pytest.mark.parametrize("pair,B,H2,W2,dtype", [
    (False, 1, 8, 16, torch.float32),    # conv2's widths, one tile
    (False, 2, 10, 20, torch.float32),   # several tiles, ragged edges
    (True, 1, 10, 20, torch.float32),    # the pair, ragged
    (False, 1, 8, 16, torch.bfloat16),   # the tensor-core path
    (True, 1, 10, 20, torch.bfloat16),   # the pair on the tensor cores, ragged
])
def test_cuda_source_emulated_matches_plain(emulated, pair, B, H2, W2, dtype):
    ci = 16 if pair else 32
    x = torch.from_numpy(_x(10, B, H2, W2, 4 * ci)).to(dtype)
    wa, wb = (tap_weight(torch.from_numpy(_w(s, ci, 32))).to(dtype).contiguous() for s in (11, 12))
    oa, ob = (torch.empty((B, H2, W2, 128), dtype=dtype) for _ in range(2))
    emulated.emu_launch(x.data_ptr(), wa.data_ptr(), wb.data_ptr(), oa.data_ptr(), ob.data_ptr(),
                        B, H2, W2, 4 * ci, 128, int(dtype == torch.bfloat16), int(pair))
    want = tap_conv_pair_plain(x, wa, wb) if pair else (tap_conv_plain(x, wa),)
    # float32: the same products summed in another order; bfloat16: the
    # output rounded to bf16 on either side of a boundary (chip_smoke.py)
    tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2}[dtype]
    for got, w in zip((oa, ob), want):
        w = w.float()
        assert (got.float() - w).abs().max().item() <= tol * max(1.0, w.abs().max().item())
