"""ops/packed_head.py of the port (packed_head=True on the unfused s2d
tail): the plain version against the reference package's Pallas
packed_head (interpret mode, at the shapes of tests/test_packed_head.py;
float32 atol 2e-5: the same products summed in another order; bfloat16 as
test_packed_head_bf16_close), the wrapper's CPU path and refusals, and
csrc/packed_head.cu compiled with g++ under the CUDA emulation of
tests/torch_port_helpers.py, held against the plain version. The card runs
the real kernel in chip_smoke.py."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu.ops.packed_head import kpack_weights, packed_head as jax_packed_head
from diffusionremotesensing_tpu_torch.ops import packed_head as ph
from diffusionremotesensing_tpu_torch.ops.packed_head import packed_head, packed_head_plain
from tests.torch_port_helpers import compile_emulated


def _inputs(seed, B, h, w, c1, c2, out4):
    rng = np.random.default_rng(seed)

    def r(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return (r(B, h, w, c1, scale=0.3), r(B, h, w, c2, scale=0.3), r(4, 4, c1, out4, scale=0.05),
            r(3, 3, c2, out4, scale=0.05))


@pytest.mark.parametrize("h,w,c1,c2,out4", [
    (16, 16, 64, 128, 12),  # flagship channel widths (small spatial)
    (16, 16, 64, 128, 4),   # SAR->NDVI output width (out_dim=1)
    (8, 24, 32, 64, 12),    # non-square, one packed group
])
def test_plain_matches_reference_kernel(h, w, c1, c2, out4):
    hh, at, k1, k2 = _inputs(1, 2, h, w, c1, c2, out4)
    want = jax_packed_head(jnp.asarray(hh), jnp.asarray(at), kpack_weights(jnp.asarray(k1)),
                           kpack_weights(jnp.asarray(k2)), interpret=True)
    got = packed_head_plain(*(torch.from_numpy(a) for a in (hh, at, k1, k2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_plain_bf16_close_to_reference_kernel():
    hh, at, k1, k2 = (a.astype(jnp.bfloat16) for a in map(jnp.asarray,
                                                          _inputs(2, 1, 16, 16, 64, 128, 12)))
    want = jax_packed_head(hh, at, kpack_weights(k1), kpack_weights(k2), interpret=True)
    got = packed_head_plain(*(torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
                              for a in (hh, at, k1, k2)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=0.05, rtol=0.05)


def test_plain_bf16_rounds_once():
    """bfloat16: both convolutions of the bf16 operands summed in float32
    and rounded once (not each rounded, then added)."""
    hh, at, k1, k2 = (torch.from_numpy(a).bfloat16() for a in _inputs(3, 1, 8, 8, 32, 64, 12))
    want = (ph._conv_f32(hh, k1, ((1, 2), (1, 2))) + ph._conv_f32(at, k2, ((1, 1), (1, 1))))
    assert torch.equal(packed_head_plain(hh, at, k1, k2), want.bfloat16())


def test_wrapper_cpu_path_is_the_plain_version_and_not_counted():
    args = [torch.from_numpy(a) for a in _inputs(4, 1, 8, 8, 32, 64, 12)]
    before = packed_head.launches
    assert torch.equal(packed_head(*args), packed_head_plain(*args))
    assert packed_head.launches == before


def test_wrapper_refuses():
    """What the launcher takes: float32 or bf16 operands of one device,
    contiguous, C1 and C2 multiples of 16 in bf16, out4 <= 16; a tensor
    neither on the card nor on the CPU raises before any launch."""
    hh, at, k1, k2 = (torch.from_numpy(a) for a in _inputs(5, 1, 8, 8, 32, 64, 12))
    with pytest.raises(TypeError):
        ph._check(hh.half(), at.half(), k1.half(), k2.half())
    with pytest.raises(ValueError, match="contiguous"):
        ph._check(hh, at, k1, k2.transpose(0, 1))
    with pytest.raises(ValueError, match="expected"):  # a weight of another shape
        ph._check(hh, at, k1, k2[:, :, :32])
    with pytest.raises(ValueError, match="out4 <= 16"):
        ph._check(hh, at, torch.zeros((4, 4, 32, 20)), torch.zeros((3, 3, 64, 20)))
    with pytest.raises(ValueError, match="% 16"):
        ph._check(*(torch.zeros(s, dtype=torch.bfloat16) for s in
                    ((1, 8, 8, 40), (1, 8, 8, 64), (4, 4, 40, 12), (3, 3, 64, 12))))
    with pytest.raises(ValueError, match="cuda or cpu"):
        packed_head(*(a.to("meta") for a in (hh, at, k1, k2)))


_LAUNCHER = r"""
template <typename T>
static void emu_head(const void* hh, const void* at, const void* w4, const void* w3, void* out,
                     int B, int H, int W, int C1, int C2, int NO) {
  emu_run({unsigned((W + TW - 1) / TW), unsigned((H + TH - 1) / TH), unsigned(B)}, NTHREADS,
          [=] {
            packed_head_kernel<T>((const T*)hh, (const T*)at, (const T*)w4, (const T*)w3, (T*)out,
                                  H, W, C1, C2, NO);
          });
}
extern "C" void emu_launch(const void* hh, const void* at, const void* w4, const void* w3,
                           void* out, int B, int H, int W, int C1, int C2, int NO, int is_bf16) {
  if (is_bf16) emu_head<__nv_bfloat16>(hh, at, w4, w3, out, B, H, W, C1, C2, NO);
  else emu_head<float>(hh, at, w4, w3, out, B, H, W, C1, C2, NO);
}
extern "C" size_t emu_smem(int C1, int C2, int is_bf16) {
  return is_bf16 ? smem_bytes<__nv_bfloat16>(C1, C2) : smem_bytes<float>(C1, C2);
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    lib = compile_emulated("packed_head", _LAUNCHER, tmp_path_factory.mktemp("packed_head_emu"))
    lib.emu_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
    lib.emu_smem.argtypes = [ctypes.c_int] * 3
    lib.emu_smem.restype = ctypes.c_size_t
    return lib


@pytest.mark.parametrize("B,H,W,c1,c2,out4,dtype", [
    (1, 8, 16, 64, 128, 12, torch.float32),    # the flagship widths, one tile
    (2, 11, 20, 32, 64, 12, torch.float32),    # several tiles, ragged edges
    (1, 9, 18, 32, 64, 4, torch.float32),      # out4 = 4, ragged
    (1, 8, 16, 64, 128, 12, torch.bfloat16),   # the tensor-core path
    (1, 11, 20, 32, 64, 12, torch.bfloat16),   # ... with ragged tiles
])
def test_cuda_source_emulated_matches_plain(emulated, B, H, W, c1, c2, out4, dtype):
    hh, at, k1, k2 = (torch.from_numpy(a).to(dtype).contiguous()
                      for a in _inputs(6, B, H, W, c1, c2, out4))
    out = torch.empty((B, H, W, out4), dtype=dtype)
    emulated.emu_launch(hh.data_ptr(), at.data_ptr(), k1.data_ptr(), k2.data_ptr(), out.data_ptr(),
                        B, H, W, c1, c2, out4, int(dtype == torch.bfloat16))
    want = packed_head_plain(hh, at, k1, k2).float()
    # float32: the same products summed in another order; bfloat16: the
    # output rounded to bf16 on either side of a boundary (chip_smoke.py)
    tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2}[dtype]
    assert (out.float() - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())


def test_shared_memory_at_the_flagship_widths(emulated):
    """C1=64, C2=128: 98,944 bytes in bfloat16 (two blocks an SM), and
    float32 under Hopper's 232,448."""
    assert emulated.emu_smem(64, 128, 1) == 98944
    assert emulated.emu_smem(64, 128, 0) <= 232448
