"""csrc/sm90.cuh's primitives under the CPU emulation of
tests/torch_port_helpers.py, held against torch: one warpgroup's
wgmma.m64nNk16 (N = 16, 32, 64, 128, 256) with A loaded by ldmatrix from a
padded row-major tile and B landed by a TMA box in the 128-byte swizzle (the
32-byte one for N = 16 and 32, two 16-column atoms LBO apart for 32; the
descriptor's MN-major layout), each accumulator
element read back through the documented fragment layout; and mbarrier
rings (full and empty barriers, parities over several rounds, transaction
bytes) fed by TMA row loads, from thread 0 or from a producer warpgroup
that hands its registers to the consumers (setmaxnreg); and a TMA box
stored back from shared memory, clipped at the tensor's edges. A layout slip here
shows before the card runs the kernels that use them (csrc/tap_conv.cu,
csrc/dec_block.cu, csrc/tap_block_sm90.cuh); the card remains the final
check."""

import ctypes

import numpy as np
import pytest
import torch

from tests.torch_port_helpers import compile_emulated

_LAUNCHER = r"""
// D (64 x N, float32) = A (64 x 16) B (16 x N), bf16 operands, on one warpgroup;
// B lands by TMA in the 128-byte swizzle (rows of 64 columns) or, for N = 16
// and 32, the 32-byte one (rows of 16 columns)
template <int N>
static void emu_product(const void* A, const void* B, float* D) {
  emu_run({1, 1, 1}, 128, [=] {
    constexpr int NA = N <= 32 ? 16 : 64;  // columns of a B row
    constexpr int ATOMS = N / NA;          // atoms side by side in N
    unsigned char* base = smem_raw;                                // 1024-aligned
    __nv_bfloat16* as = (__nv_bfloat16*)(base + ATOMS * 2048);     // A, rows of 24 elements
    uint64_t* bar = (uint64_t*)(base + ATOMS * 2048 + 64 * 48);
    const int t = threadIdx.x, w = t / 32, lane = t % 32, g = lane / 4, q = lane % 4;
    const sm90::TensorMap bmap{B, {N, 16, 1, 1}, {2, 2LL * N, 0, 0}, {NA, 16, 1, 1}, 2 * NA};
    if (t == 0) {
      sm90::mbar_init(bar, 1);
      sm90::fence_mbar_init();
      sm90::mbar_arrive_expect_tx(bar, N * 16 * 2);
      for (int na = 0; na < ATOMS; ++na)
        sm90::tma_load_2d(base + na * 2048, &bmap, NA * na, 0, bar);
    }
    for (int e = t; e < 64 * 16; e += 128)
      as[(e / 16) * 24 + e % 16] = ((const __nv_bfloat16*)A)[e];
    __syncthreads();
    sm90::mbar_wait(bar, 0);
    uint32_t a[4];
    sm90::ldmatrix_x4(a, as + (16 * w + lane % 16) * 24 + (lane / 16) * 8);
    float d[N / 2];
    for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
    // B: atoms of 8 rows x NA columns; the next NA columns 2048 bytes on,
    // the next 8 rows 8 row lengths on
    const uint64_t desc = N <= 32 ? sm90::desc_sw32(base, 2048, 256)
                                  : sm90::desc_sw128(base, 2048, 1024);
    sm90::wgmma_fence();
    if constexpr (N == 256) sm90::wgmma_m64n256k16(d, a, desc);
    else if constexpr (N == 128) sm90::wgmma_m64n128k16(d, a, desc);
    else if constexpr (N == 64) sm90::wgmma_m64n64k16(d, a, desc);
    else if constexpr (N == 32) sm90::wgmma_m64n32k16(d, a, desc);
    else sm90::wgmma_m64n16k16(d, a, desc);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    for (int j = 0; j < N / 8; ++j)
      for (int h = 0; h < 2; ++h)
        for (int e = 0; e < 2; ++e)
          D[(16 * w + g + 8 * h) * N + 8 * j + 2 * q + e] = d[4 * j + 2 * h + e];
  });
}
extern "C" void product(const void* A, const void* B, float* D, int n) {
  if (n == 256) emu_product<256>(A, B, D);
  else if (n == 128) emu_product<128>(A, B, D);
  else if (n == 64) emu_product<64>(A, B, D);
  else if (n == 32) emu_product<32>(A, B, D);
  else emu_product<16>(A, B, D);
}

// rows of X (rounds x 64, bf16) through two buffers: thread 0 loads row
// i + 1 while all 64 threads read row i; out[i][t] = X[i][t]
extern "C" void ring(const void* X, int rounds, float* out) {
  emu_run({1, 1, 1}, 64, [=] {
    unsigned char* base = smem_raw;
    uint64_t* full = (uint64_t*)(base + 2048);
    uint64_t* empty = full + 2;
    const int t = threadIdx.x;
    const sm90::TensorMap xmap{X, {64, rounds, 1, 1}, {2, 128, 0, 0}, {64, 1, 1, 1}};
    auto load = [&](int i, int s) {
      sm90::mbar_arrive_expect_tx(&full[s], 128);
      sm90::tma_load_2d(base + 1024 * s, &xmap, 0, i, &full[s]);
    };
    if (t == 0) {
      for (int s = 0; s < 2; ++s) {
        sm90::mbar_init(&full[s], 1);
        sm90::mbar_init(&empty[s], 64);
      }
      sm90::fence_mbar_init();
      load(0, 0);
    }
    __syncthreads();
    for (int i = 0; i < rounds; ++i) {
      const int s = i & 1;
      if (t == 0 && i + 1 < rounds) {
        if (i >= 1) sm90::mbar_wait(&empty[s ^ 1], ((i - 1) >> 1) & 1);
        load(i + 1, s ^ 1);
      }
      sm90::mbar_wait(&full[s], (i >> 1) & 1);
      out[i * 64 + t] = __bfloat162float(((const __nv_bfloat16*)(base + 1024 * s))[t]);
      sm90::mbar_arrive(&empty[s]);
    }
  });
}

// the same through three buffers, as the warp-specialised kernels run them:
// a consumer warpgroup (threads 0-127, registers raised) and a producer
// warpgroup (registers lowered) whose first warp loads and whose others
// leave; out[i][t] = X[i][t] for t < 64
extern "C" void ring_ws(const void* X, int rounds, float* out) {
  emu_run({1, 1, 1}, 256, [=] {
    unsigned char* base = smem_raw;
    uint64_t* full = (uint64_t*)(base + 3072);
    uint64_t* empty = full + 3;
    const int t = threadIdx.x;
    const sm90::TensorMap xmap{X, {64, rounds, 1, 1}, {2, 128, 0, 0}, {64, 1, 1, 1}};
    if (t == 0) {
      for (int s = 0; s < 3; ++s) {
        sm90::mbar_init(&full[s], 1);
        sm90::mbar_init(&empty[s], 128);
      }
      sm90::fence_mbar_init();
    }
    __syncthreads();
    if (t >= 128) {
      sm90::setmaxnreg_dec<40>();
      if (t >= 160) return;
      for (int i = 0; i < rounds; ++i) {
        const int s = i % 3;
        if (i >= 3) sm90::mbar_wait(&empty[s], (i / 3 - 1) & 1);
        if (t == 128) {
          sm90::mbar_arrive_expect_tx(&full[s], 128);
          sm90::tma_load_2d(base + 1024 * s, &xmap, 0, i, &full[s]);
        }
      }
      return;
    }
    sm90::setmaxnreg_inc<232>();
    for (int i = 0; i < rounds; ++i) {
      const int s = i % 3;
      sm90::mbar_wait(&full[s], (i / 3) & 1);
      if (t < 64) out[i * 64 + t] = __bfloat162float(((const __nv_bfloat16*)(base + 1024 * s))[t]);
      sm90::mbar_arrive(&empty[s]);
    }
  });
}

// a box of X (64 channels, w, h, 1: bf16) at (0, x0, y0, 0) through shared
// memory to Y at the same place, by TMA load and store in the 128-byte
// swizzle: the box's part inside the tensor is copied, the rest of Y kept
extern "C" void box_roundtrip(const void* X, void* Y, int w, int h, int x0, int y0) {
  emu_run({1, 1, 1}, 32, [=] {
    unsigned char* base = smem_raw;
    uint64_t* bar = (uint64_t*)(base + 16 * 1024);
    const sm90::TensorMap xm{X, {64, w, h, 1}, {2, 128, 128LL * w, 128LL * w * h}, {64, 16, 8, 1}};
    const sm90::TensorMap ym{Y, {64, w, h, 1}, {2, 128, 128LL * w, 128LL * w * h}, {64, 16, 8, 1}};
    if (threadIdx.x == 0) {
      sm90::mbar_init(bar, 1);
      sm90::fence_mbar_init();
      sm90::mbar_arrive_expect_tx(bar, 16 * 8 * 128);
      sm90::tma_load_4d(base, &xm, 0, x0, y0, 0, bar);
      sm90::mbar_wait(bar, 0);
      sm90::tma_store_4d(&ym, base, 0, x0, y0, 0);
      sm90::bulk_commit();
      sm90::bulk_wait_read<0>();
    }
  });
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    lib = compile_emulated("sm90.cuh", _LAUNCHER, tmp_path_factory.mktemp("sm90_emu"))
    lib.product.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.ring.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.ring_ws.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.box_roundtrip.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
    return lib


@pytest.mark.parametrize("n", [16, 32, 64, 128, 256])
def test_warpgroup_product_matches_torch(emulated, n):
    """64 x n x 16: every element in its documented fragment place. The
    operands are bf16, so the float32 product of 16 terms differs from
    torch's only by the order of the sum (atol 1e-5)."""
    rng = np.random.default_rng(n)
    a = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.standard_normal((16, n)).astype(np.float32)).bfloat16()
    d = torch.full((64, n), float("nan"))
    emulated.product(a.data_ptr(), b.data_ptr(), d.data_ptr(), n)
    torch.testing.assert_close(d, a.float() @ b.float(), atol=1e-5, rtol=0)


def test_mbarrier_ring_keeps_rounds_apart(emulated):
    """Nine rounds through two buffers: each round reads its own row, so the
    full/empty phases and parities alternate as the kernels use them."""
    rounds = 9
    x = torch.arange(rounds * 64, dtype=torch.float32).reshape(rounds, 64).bfloat16()
    out = torch.full((rounds, 64), float("nan"))
    emulated.ring(x.data_ptr(), rounds, out.data_ptr())
    assert torch.equal(out, x.float())


def test_mbarrier_ring_with_a_producer_warpgroup(emulated):
    """Nine rounds through three buffers fed by a producer warpgroup that
    lowers its registers for the consumer warpgroup (setmaxnreg) and whose
    idle warps leave early, as csrc/tap_block_sm90.cuh's kernel runs."""
    rounds = 9
    x = torch.arange(rounds * 64, dtype=torch.float32).reshape(rounds, 64).bfloat16()
    out = torch.full((rounds, 64), float("nan"))
    emulated.ring_ws(x.data_ptr(), rounds, out.data_ptr())
    assert torch.equal(out, x.float())


@pytest.mark.parametrize("x0,y0", [(0, 0), (10, 6), (-3, -2)])
def test_tma_store_writes_the_box_inside_the_tensor(emulated, x0, y0):
    """A 16 x 8 box of 64 channels loaded and stored back at (x0, y0) of a
    20 x 10 tensor: the stored part equals the source where the box lies
    inside the tensor, and the store leaves the rest alone (the 128-byte
    swizzle undone on the way out, the box clipped at the edges)."""
    w, h = 20, 10
    x = torch.arange(h * w * 64, dtype=torch.float32).reshape(h, w, 64).bfloat16()
    y = torch.full((h, w, 64), -1.0).bfloat16()
    emulated.box_roundtrip(x.data_ptr(), y.data_ptr(), w, h, x0, y0)
    inside = torch.zeros((h, w), dtype=torch.bool)
    inside[max(y0, 0):y0 + 8, max(x0, 0):x0 + 16] = True
    assert torch.equal(y[inside], x[inside])
    assert (y[~inside] == -1).all()
