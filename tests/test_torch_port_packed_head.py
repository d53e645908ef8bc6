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
from diffusionremotesensing_tpu_torch.ops.packed_head import (
    packed_head,
    packed_head_plain,
    wgmma_takes,
)
from diffusionremotesensing_tpu_torch.parallel.halo import band_row_counts
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


def test_wrapper_refuses_unaligned_tma_operands():
    """The wgmma kernel reads hh and attn_s by TMA, whose global address must
    be 16-byte aligned: an unaligned start raises where wgmma_takes says the
    wgmma kernel runs, and not where the first design's kernel does."""
    def unaligned(shape, dtype=torch.bfloat16):
        n = int(np.prod(shape))
        return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)

    def weights(c1, c2, dtype=torch.bfloat16):
        return torch.zeros((4, 4, c1, 12), dtype=dtype), torch.zeros((3, 3, c2, 12), dtype=dtype)

    hh = torch.zeros((1, 8, 8, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        ph._check(unaligned((1, 8, 8, 64)), torch.zeros((1, 8, 8, 128), dtype=torch.bfloat16),
                  *weights(64, 128))
    with pytest.raises(ValueError, match="aligned"):
        ph._check(hh, unaligned((1, 8, 8, 128)), *weights(64, 128))
    ph._check(hh, torch.zeros((1, 8, 8, 128), dtype=torch.bfloat16), *weights(64, 128))
    ph._check(hh, unaligned((1, 8, 8, 144)), *weights(64, 144))  # the WMMA kernel's width
    ph._check(unaligned((1, 8, 8, 64), torch.float32), torch.zeros((1, 8, 8, 128)),
              *weights(64, 128, torch.float32))


_LAUNCHER = r"""
// the first design's kernel (FMA in float32, WMMA in bfloat16), a block per
// 8 x 16 tile
template <typename T>
static void emu_head(const void* hh, const void* at, const void* w4, const void* w3, void* out,
                     int B, int H, int W, int C1, int C2, int NO) {
  emu_run({unsigned((W + FTW - 1) / FTW), unsigned((H + FTH - 1) / FTH), unsigned(B)}, NTHREADS,
          [=] {
            packed_head_kernel<T>((const T*)hh, (const T*)at, (const T*)w4, (const T*)w3, (T*)out,
                                  H, W, C1, C2, NO);
          });
}
// bfloat16's wgmma kernel over `blocks` persistent blocks (0: one per 8 x 32
// tile)
static void emu_tc(const void* hh, const void* at, const void* w4, const void* w3, void* out,
                   int B, int H, int W, int C1, int C2, int NO, int blocks) {
  auto slab = [&](const void* t, long long c, int sw, int sh) {
    return sm90::TensorMap{t, {c, W, H, B}, {2, 2 * c, 2 * c * W, 2 * c * W * H}, {64, sw, sh, 1}};
  };
  const sm90::TensorMap hm = slab(hh, C1, SW4, SH4), am = slab(at, C2, SW3, SH3);
  typedef const __nv_bfloat16* Bp;
  if (blocks == 0) blocks = B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  emu_run({unsigned(blocks), 1, 1}, TC_THREADS, [=] {
    head_tc_kernel(hm, am, (Bp)w4, (Bp)w3, (__nv_bfloat16*)out, B, H, W, C1, C2, NO);
  });
}
// tc: the wgmma kernel (bfloat16), else the first design's
extern "C" void emu_launch(const void* hh, const void* at, const void* w4, const void* w3,
                           void* out, int B, int H, int W, int C1, int C2, int NO, int is_bf16,
                           int tc, int blocks) {
  if (tc) emu_tc(hh, at, w4, w3, out, B, H, W, C1, C2, NO, blocks);
  else if (is_bf16) emu_head<__nv_bfloat16>(hh, at, w4, w3, out, B, H, W, C1, C2, NO);
  else emu_head<float>(hh, at, w4, w3, out, B, H, W, C1, C2, NO);
}
extern "C" size_t emu_smem(int C1, int C2, int is_bf16) {
  return is_bf16 ? smem_bytes<__nv_bfloat16>(C1, C2) : smem_bytes<float>(C1, C2);
}
extern "C" int emu_tc_bytes(int C1, int C2) { return tc_bytes(C1, C2); }
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    lib = compile_emulated("packed_head", _LAUNCHER, tmp_path_factory.mktemp("packed_head_emu"))
    lib.emu_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
    lib.emu_smem.argtypes = [ctypes.c_int] * 3
    lib.emu_smem.restype = ctypes.c_size_t
    lib.emu_tc_bytes.argtypes = [ctypes.c_int] * 2
    return lib


def _run_emulated(lib, B, H, W, c1, c2, out4, dtype, blocks=0):
    """One emulated call, the kernel chosen as the wrapper chooses it
    (wgmma_takes), held against the plain version; the wgmma kernel runs on
    `blocks` persistent blocks (0: one per 8 x 32 tile)."""
    hh, at, k1, k2 = (torch.from_numpy(a).to(dtype).contiguous()
                      for a in _inputs(6, B, H, W, c1, c2, out4))
    out = torch.empty((B, H, W, out4), dtype=dtype)
    lib.emu_launch(hh.data_ptr(), at.data_ptr(), k1.data_ptr(), k2.data_ptr(), out.data_ptr(),
                   B, H, W, c1, c2, out4, int(dtype == torch.bfloat16),
                   int(wgmma_takes(c1, c2, dtype)), blocks)
    want = packed_head_plain(hh, at, k1, k2).float()
    # float32: the same products summed in another order; bfloat16: the
    # output rounded to bf16 on either side of a boundary (chip_smoke.py)
    tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2}[dtype]
    assert (out.float() - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())


@pytest.mark.parametrize("B,H,W,c1,c2,out4,dtype", [
    (1, 8, 16, 64, 128, 12, torch.float32),    # the flagship widths, one tile
    (2, 11, 20, 32, 64, 12, torch.float32),    # several tiles, ragged edges
    (1, 9, 18, 32, 64, 4, torch.float32),      # out4 = 4, ragged
    (1, 8, 16, 64, 128, 12, torch.bfloat16),   # the tensor-core path
    (1, 11, 20, 32, 64, 12, torch.bfloat16),   # ... with ragged tiles
])
def test_cuda_source_emulated_matches_plain(emulated, B, H, W, c1, c2, out4, dtype):
    _run_emulated(emulated, B, H, W, c1, c2, out4, dtype)


@pytest.mark.parametrize("B,H,W,c1,c2,out4,blocks", [
    (1, 8, 32, 64, 128, 12, 0),   # the flagship widths on one tile: 3 planes through 3 slots
    (2, 11, 37, 64, 128, 12, 0),  # ragged H and W, which no 8 x 32 tile divides
    (2, 16, 40, 64, 128, 12, 3),  # 8 tiles on 3 blocks: the ring wraps across tiles
    (1, 9, 33, 64, 128, 4, 1),    # out4 = 4 (out_dim 1), 4 ragged tiles on one block
    (1, 8, 20, 48, 80, 5, 0),     # odd out4, partial planes (channels past C1, C2 zero)
])
def test_cuda_source_emulated_bf16_wgmma(emulated, B, H, W, c1, c2, out4, blocks):
    assert wgmma_takes(c1, c2)
    _run_emulated(emulated, B, H, W, c1, c2, out4, torch.bfloat16, blocks)


# the head chain's row counts on the bands of a split of the HR-64 image
# (32 rows and columns of hh and attn_s), k = 2 and 4: 19, 20; 11, 12, 15
BAND_ROWS = sorted(set(band_row_counts("head", 32, 2) + band_row_counts("head", 32, 4)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", BAND_ROWS)
def test_cuda_source_emulated_at_the_band_shapes(emulated, dtype, h):
    """The served widths on an extended band of a spatial split: the
    head's (3, 4) halo gives odd row counts, which no 8-row tile divides."""
    _run_emulated(emulated, 1, h, 32, 64, 128, 12, dtype)


def test_explicit_dispatch_by_shape(emulated):
    """wgmma_takes is the source's own rule (tc_bytes within the 232,448
    bytes a block may have), by shape and dtype alone: the served widths
    take the wgmma kernel, wider bfloat16 and float32 the first design's;
    a width the dispatch sends to the WMMA kernel is right there too."""
    for c1, c2 in ((64, 128), (32, 64), (16, 16), (64, 192), (64, 144), (64, 320), (128, 128),
                   (64, 256), (192, 64), (128, 64)):
        assert wgmma_takes(c1, c2) == (emulated.emu_tc_bytes(c1, c2) <= 232448), (c1, c2)
    assert wgmma_takes(64, 128) and not wgmma_takes(64, 144) and not wgmma_takes(128, 128)
    assert not wgmma_takes(64, 128, torch.float32)
    _run_emulated(emulated, 1, 9, 18, 64, 144, 12, torch.bfloat16)


def test_shared_memory_at_the_flagship_widths(emulated):
    """C1=64, C2=128: the wgmma kernel's 221,232 bytes (the source note's),
    and the first design's float32 kernel, each under Hopper's 232,448."""
    assert emulated.emu_tc_bytes(64, 128) == 221232
    assert emulated.emu_smem(64, 128, 0) <= 232448
