// Hopper (sm_90a) primitives for the port's hand-written kernels, as thin
// wrappers over their PTX instructions (PTX ISA 8.x), so that a kernel
// reads as C++ and the register-fragment layouts are written down once:
//
//   ldmatrix_x4        four 8x8 b16 matrices from shared memory to registers
//   wgmma_m64n16k16, _m64n32k16, _m64n64k16, _m64n128k16, _m64n256k16
//                      warpgroup MMA, A (64x16 bf16) from registers, B
//                      (16xN bf16) from shared memory through a descriptor
//   wgmma_fence / _commit / _wait, fence_operand
//   desc_sw128, desc_sw32
//                      the B descriptor of a 128-byte- / 32-byte-swizzled
//                      layout
//   fence_proxy_async  orders this thread's shared-memory stores before
//                      later TMA and wgmma accesses (the async proxy)
//   setmaxnreg_dec / _inc
//                      a warpgroup's registers a thread, lowered (a producer
//                      handing them to the block's pool) or raised (consumers
//                      taking them)
//   mbar_*             shared-memory barriers with a phase and a count of
//                      bytes still to land (mbarrier)
//   tma_load_2d / _4d  a box of a 2-D / 4-D tensor to shared memory (TMA), zero
//                      outside the tensor, 128-byte swizzle, completing
//                      on an mbarrier; TensorMap describes the tensor
//   tma_store_4d, bulk_commit, bulk_wait_read
//                      a box from shared memory to a 4-D tensor (TMA), the
//                      parts outside the tensor dropped; its bulk group, and
//                      the wait until the group has read shared memory
//   pack_bf16x2, shfl, shfl_xor, quad_transpose
//                      epilogue helpers (shfl_xor: a float from lane ^ mask,
//                      the butterfly of a sum over a quad)
//
// Fragment layouts (lane l of a warp, g = l / 4, q = l % 4):
// * ldmatrix_x4: lane l gives the address of row l % 8 of matrix l / 8 (16
//   contiguous bytes); register i receives matrix i's row g, elements 2q and
//   2q + 1. With rows 0-15 at lanes 0-15 and the same rows 8 elements on at
//   lanes 16-31, the four registers are the A fragment of mma.m16n8k16,
//   which is also one warp's share of wgmma's A: warp w of the warpgroup
//   holds rows 16w .. 16w + 15.
// * wgmma D (float32, m64nN): thread t of the warpgroup, w = t / 32, holds
//   d[4j + 0..1] = D[16w + g][8j + 2q + 0..1] and d[4j + 2..3] =
//   D[16w + g + 8][8j + 2q + 0..1], j = 0 .. N/8 - 1.
// * The 128-byte swizzle (wgmma's layout type 1, TMA's SWIZZLE_128B): in
//   each 1024-byte-aligned group of eight 128-byte rows, the 16-byte chunk
//   c of row r lies at chunk c ^ r (address bits 4-6 ^= bits 7-9).
// * The 32-byte swizzle (layout type 3, SWIZZLE_32B): in each 256-byte-
//   aligned group of eight 32-byte rows, chunk c of row r lies at chunk
//   c ^ (r / 4) (address bit 4 ^= bit 7).
// * B, MN-major (W row-major: k rows, n contiguous), swizzled: atoms of 8 k
//   rows x 64 n (128-byte swizzle, 1024 bytes) or 8 k rows x 16 n (32-byte
//   swizzle, 256 bytes). Element (k, n) of a B whose atom (k / 8, n / A)
//   (A = 64 or 16) sits at start + (n / A) * LBO + (k / 8) * SBO.
// * A TMA box (b0, b1, b2, b3) of 2-byte elements lands as rows of 2 b0
//   bytes (128 or 32), row i1 + b1 (i2 + b2 i3) holding elements 0 .. b0-1
//   of (i1, i2, i3), swizzled as the map says.
//
// Read by a host compiler (the tests' CPU emulation of the CUDA thread
// model, tests/torch_port_helpers.py), each primitive has its plain meaning
// over the emulation's hooks: a per-warp and a per-warpgroup exchange area
// and barrier (emu_warp_slots, emu_wg_slots, __syncwarp, emu_wg_sync), the
// shared-memory array smem_raw, atomics for an mbarrier's phase, and
// emu_yield / emu_mbar_waited for its waits. wgmma's
// host meaning rebuilds A from the 128 threads' fragments and reads B
// through the descriptor as the layout above says, so a slip in either
// layout shows on the CPU as well as it can be written down there; the card
// is the final check.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#if defined(__CUDACC__)
#include <cuda.h>
#endif

namespace sm90 {

// B's descriptor fields, in 16-byte units: start address, LBO, SBO, and
// the 128-byte swizzle as layout type 1 (bits 62-63)
__host__ __device__ constexpr uint64_t desc_field(uint32_t bytes) { return (bytes & 0x3FFFF) >> 4; }

#if defined(__CUDACC__)

using TensorMap = CUtensorMap;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous MMAs (wgmma_fence / wgmma_wait order the hardware only)
template <int N> __device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint64_t desc_sw128(const void* start, uint32_t lbo, uint32_t sbo) {
  return desc_field(smem_addr(start)) | desc_field(lbo) << 16 | desc_field(sbo) << 32 | 1ull << 62;
}
__device__ __forceinline__ uint64_t desc_sw32(const void* start, uint32_t lbo, uint32_t sbo) {
  return desc_field(smem_addr(start)) | desc_field(lbo) << 16 | desc_field(sbo) << 32 | 3ull << 62;
}

// d += A B as wgmma_m64n128k16 below, 16, 32 and 64 columns wide
__device__ __forceinline__ void wgmma_m64n16k16(float (&d)[8], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d += A B, A 64x16 from the warpgroup's registers, B 16x128 (16x256) at
// desc_b, MN-major (n contiguous: the instruction's transpose-B flag)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// one arrival, and `bytes` more to land before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}
// the box of `map` at coordinates (c0, c1) to dst (1024-byte aligned); its
// bytes count toward `bar`'s transaction count
__device__ __forceinline__ void tma_load_2d(void* dst, const TensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}
// the same for a 4-D tensor at (c0, c1, c2, c3)
__device__ __forceinline__ void tma_load_4d(void* dst, const TensorMap* map, int c0, int c1, int c2,
                                            int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// the box of `map` at (c0, c1, c2, c3) from src (1024-byte aligned, laid
// out as tma_load_4d lands it); a bulk group's part
__device__ __forceinline__ void tma_store_4d(const TensorMap* map, const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// returns once at most N of this thread's bulk groups still read shared memory
template <int N> __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// every warp of the warpgroup executes it; N a multiple of 8 in [24, 256]
template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}
__device__ __forceinline__ uint32_t shfl(uint32_t v, int src_lane) {
  return __shfl_sync(0xffffffffu, v, src_lane);
}
__device__ __forceinline__ float shfl_xor(float v, int mask) {
  return __shfl_xor_sync(0xffffffffu, v, mask);
}

#else  // host meaning, for the CPU emulation

inline uint32_t smem_addr(const void* p) {
  return uint32_t(static_cast<const unsigned char*>(p) - smem_raw);
}

inline void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  const int lane = threadIdx.x % 32;
  uint64_t* slots = emu_warp_slots();
  slots[lane] = reinterpret_cast<uint64_t>(row);
  __syncwarp();
  for (int i = 0; i < 4; ++i)
    std::memcpy(&r[i],
                reinterpret_cast<const unsigned char*>(slots[8 * i + lane / 4]) + 4 * (lane % 4), 4);
  __syncwarp();
}

inline void wgmma_fence() {}
inline void wgmma_commit() {}
template <int N> inline void wgmma_wait() {}
template <int N> inline void fence_operand(float (&)[N]) {}

inline uint64_t desc_sw128(const void* start, uint32_t lbo, uint32_t sbo) {
  return desc_field(smem_addr(start)) | desc_field(lbo) << 16 | desc_field(sbo) << 32 | 1ull << 62;
}
inline uint64_t desc_sw32(const void* start, uint32_t lbo, uint32_t sbo) {
  return desc_field(smem_addr(start)) | desc_field(lbo) << 16 | desc_field(sbo) << 32 | 3ull << 62;
}

// element (k, n) of the MN-major B at `desc` (the 128- or 32-byte swizzle)
inline float emu_b(uint64_t desc, int k, int n) {
  const uint32_t start = uint32_t(desc & 0x3FFF) << 4;
  const uint32_t lbo = uint32_t((desc >> 16) & 0x3FFF) << 4;
  const uint32_t sbo = uint32_t((desc >> 32) & 0x3FFF) << 4;
  const bool sw32 = (desc >> 62) == 3;
  const int atom = sw32 ? 16 : 64;  // n per atom row (32 or 128 bytes)
  uint32_t a = start + (n / atom) * lbo + (k / 8) * sbo + (k % 8) * 2 * atom + (n % atom) * 2;
  a ^= sw32 ? ((a >> 7) & 1) << 4 : ((a >> 7) & 7) << 4;
  __nv_bfloat16 v;
  std::memcpy(&v, smem_raw + a, 2);
  return __bfloat162float(v);
}

template <int N>
inline void emu_wgmma(float* d, const uint32_t (&a)[4], uint64_t desc_b) {
  const int t = threadIdx.x % 128, w = t / 32, g = (t % 32) / 4, q = t % 4;
  uint32_t (*frag)[4] = emu_wg_slots();
  for (int i = 0; i < 4; ++i) frag[t][i] = a[i];
  emu_wg_sync();
  // this thread's two rows of A, from the fragments of the warp's lanes
  float A[2][16];
  for (int h = 0; h < 2; ++h)
    for (int k = 0; k < 16; ++k) {
      const int src = 32 * w + 4 * g + (k % 8) / 2;   // the lane holding (16w + g + 8h, k)
      const uint32_t word = frag[src][h + 2 * (k / 8)];
      __nv_bfloat16 v;
      v.v = uint16_t(k % 2 ? word >> 16 : word & 0xffff);
      A[h][k] = __bfloat162float(v);
    }
  for (int j = 0; j < N / 8; ++j)
    for (int e = 0; e < 2; ++e) {
      const int n = 8 * j + 2 * q + e;
      float b[16];
      for (int k = 0; k < 16; ++k) b[k] = emu_b(desc_b, k, n);
      for (int h = 0; h < 2; ++h) {
        float s = 0.f;
        for (int k = 0; k < 16; ++k) s += A[h][k] * b[k];
        d[4 * j + 2 * h + e] += s;
      }
    }
  emu_wg_sync();
}
inline void wgmma_m64n16k16(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b) {
  emu_wgmma<16>(d, a, desc_b);
}
inline void wgmma_m64n32k16(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b) {
  emu_wgmma<32>(d, a, desc_b);
}
inline void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  emu_wgmma<64>(d, a, desc_b);
}
inline void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  emu_wgmma<128>(d, a, desc_b);
}
inline void wgmma_m64n256k16(float (&d)[128], const uint32_t (&a)[4], uint64_t desc_b) {
  emu_wgmma<256>(d, a, desc_b);
}

// an mbarrier as one 64-bit word: arrivals pending in the current phase
// (bits 0-15), the count given to mbar_init (16-31), the phases completed,
// mod 2^16 (32-47: bit 32 is the phase parity the card keeps), and the
// 16-byte units still to land (48-63: every TMA transaction is a multiple
// of 16 bytes); the phase completes when both reach 0
inline void mbar_init(uint64_t* bar, unsigned count) {
  std::atomic_ref<uint64_t>(*bar).store(uint64_t(count) << 16 | count);
}
inline void fence_mbar_init() {}
inline void emu_mbar_update(uint64_t* bar, int arrivals, long long tx) {
  std::atomic_ref<uint64_t> r(*bar);
  uint64_t old = r.load(), nxt;
  do {
    uint64_t pending = (old & 0xffff) - arrivals, expected = (old >> 16) & 0xffff;
    uint64_t phases = (old >> 32) & 0xffff, units = uint64_t((long long)(old >> 48) + tx / 16);
    if (pending == 0 && units == 0) {
      phases = (phases + 1) & 0xffff;
      pending = expected;
    }
    nxt = pending | expected << 16 | phases << 32 | units << 48;
  } while (!r.compare_exchange_weak(old, nxt));
}
inline void mbar_arrive(uint64_t* bar) { emu_mbar_update(bar, 1, 0); }
inline void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  emu_mbar_update(bar, 1, bytes);
}
// The card's test, "the phase of parity `parity` before the current one has
// completed", holds for a lane in step with its warp. Here a warp's lanes
// are threads of their own, and a lane that only waits (a producer warp's
// lanes past the one that issues) can fall two phases behind, where the
// parity test would never pass again. So each thread counts the phases it
// has waited through (from -1: a fresh barrier's parity-1 wait passes at
// once; emu_mbar_waited is the calling CUDA thread's own table) and waits,
// giving way to the others (emu_yield), for the first phase of `parity` at
// or after them to complete: the same answer for a thread in step, and the
// right one for a thread behind.
inline void mbar_wait(uint64_t* bar, unsigned parity) {
  long long& seen = emu_mbar_waited().try_emplace(bar, -1).first->second;
  const long long phase = (seen & 1) == (long long)parity ? seen : seen + 1;
  std::atomic_ref<uint64_t> r(*bar);
  // phases completed minus (phase + 1), mod 2^16: not negative once it has
  while ((((r.load() >> 32) - uint64_t(phase + 1)) & 0xffff) >= 0x8000) emu_yield();
  seen = phase + 1;
}
// a tensor of 2-byte elements, up to 4-D: base, extents (innermost first;
// 1 past the rank), strides in bytes (stride[0] = 2), the box a load
// copies (box[0] = 64 or 16: one 128- or 32-byte row) and its swizzle in
// bytes (128 or 32)
struct TensorMap {
  const void* base;
  long long dim[4], stride[4];
  int box[4];
  int swizzle = 128;
};
inline void tma_load_4d(void* dst, const TensorMap* map, int c0, int c1, int c2, int c3,
                        uint64_t* bar) {
  const int* box = map->box;
  unsigned char* out = static_cast<unsigned char*>(dst);
  long long bytes = 0;
  for (int i3 = 0; i3 < box[3]; ++i3)
    for (int i2 = 0; i2 < box[2]; ++i2)
      for (int i1 = 0; i1 < box[1]; ++i1)
        for (int i0 = 0; i0 < box[0]; ++i0) {
          const long long c[4] = {c0 + i0, c1 + i1, c2 + i2, c3 + i3};
          bool inside = true;
          long long off = 0;
          for (int d = 0; d < 4; ++d) {
            inside = inside && c[d] >= 0 && c[d] < map->dim[d];
            off += c[d] * map->stride[d];
          }
          uint32_t a = smem_addr(out) + ((i1 + box[1] * (i2 + box[2] * i3)) * 2 * box[0] + 2 * i0);
          a ^= map->swizzle == 32 ? ((a >> 7) & 1) << 4 : ((a >> 7) & 7) << 4;
          const unsigned char* src = static_cast<const unsigned char*>(map->base) + off;
          if (inside) std::memcpy(smem_raw + a, src, 2);
          else std::memset(smem_raw + a, 0, 2);
          bytes += 2;
        }
  emu_mbar_update(bar, 0, -bytes);
}
inline void tma_load_2d(void* dst, const TensorMap* map, int c0, int c1, uint64_t* bar) {
  tma_load_4d(dst, map, c0, c1, 0, 0, bar);
}
inline void tma_store_4d(const TensorMap* map, const void* src, int c0, int c1, int c2, int c3) {
  const int* box = map->box;
  for (int i3 = 0; i3 < box[3]; ++i3)
    for (int i2 = 0; i2 < box[2]; ++i2)
      for (int i1 = 0; i1 < box[1]; ++i1)
        for (int i0 = 0; i0 < box[0]; ++i0) {
          const long long c[4] = {c0 + i0, c1 + i1, c2 + i2, c3 + i3};
          bool inside = true;
          long long off = 0;
          for (int d = 0; d < 4; ++d) {
            inside = inside && c[d] >= 0 && c[d] < map->dim[d];
            off += c[d] * map->stride[d];
          }
          uint32_t a = smem_addr(src) + ((i1 + box[1] * (i2 + box[2] * i3)) * 2 * box[0] + 2 * i0);
          a ^= map->swizzle == 32 ? ((a >> 7) & 1) << 4 : ((a >> 7) & 7) << 4;
          if (inside)
            std::memcpy(static_cast<unsigned char*>(const_cast<void*>(map->base)) + off,
                        smem_raw + a, 2);
        }
}
inline void bulk_commit() {}
template <int N> inline void bulk_wait_read() {}

inline void fence_proxy_async() {}
template <int N> inline void setmaxnreg_dec() {}  // registers are the host's
template <int N> inline void setmaxnreg_inc() {}

inline uint32_t pack_bf16x2(float lo, float hi) {
  return uint32_t(__float2bfloat16(lo).v) | uint32_t(__float2bfloat16(hi).v) << 16;
}
inline uint32_t shfl(uint32_t v, int src_lane) {
  uint64_t* slots = emu_warp_slots();
  slots[threadIdx.x % 32] = v;
  __syncwarp();
  const uint32_t r = uint32_t(slots[src_lane % 32]);
  __syncwarp();
  return r;
}
inline float shfl_xor(float v, int mask) {
  uint32_t u;
  std::memcpy(&u, &v, 4);
  u = shfl(u, (threadIdx.x % 32) ^ mask);
  std::memcpy(&v, &u, 4);
  return v;
}

#endif

// The epilogue's quad transpose. Lane q of a quad holds, in v[j], the
// column pair q of 8-column group j (j = 0..3) of one accumulator row
// (wgmma's D layout); afterwards v[j] holds pair j of group q, so that the
// lane holds the 8 consecutive columns 8q .. 8q + 7: one 16-byte store.
// Two butterfly exchanges (lane bits 0 and 1), on named registers so that
// no index into v is left to run time.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4]) {
  const int lane = threadIdx.x % 32;
  const bool hi1 = lane & 1, hi2 = lane & 2;
  uint32_t s0 = hi1 ? v[0] : v[1], s1 = hi1 ? v[2] : v[3];
  s0 = shfl(s0, lane ^ 1);
  s1 = shfl(s1, lane ^ 1);
  if (hi1) {
    v[0] = s0;
    v[2] = s1;
  } else {
    v[1] = s0;
    v[3] = s1;
  }
  s0 = hi2 ? v[0] : v[2];
  s1 = hi2 ? v[1] : v[3];
  s0 = shfl(s0, lane ^ 2);
  s1 = shfl(s1, lane ^ 2);
  if (hi2) {
    v[0] = s0;
    v[1] = s1;
  } else {
    v[2] = s0;
    v[3] = s1;
  }
}

}  // namespace sm90
