"""Shared inputs for the tests of the PyTorch port (tests/test_torch_port_*.py):
random variables in the reference package's tree layout, drawn with numpy
(jax.eval_shape gives the tree without compiling flax's init), the port's
model loaded with the same weights through convert.from_jax_variables, and
the CPU emulation of the CUDA thread model that the port's CUDA sources are
compiled under with g++ (EMULATION_PRELUDE, compile_emulated)."""

import ctypes
import functools
import os
import re
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu.models.unet import (
    init_unet_params,
    residual_attention_unet_generation as jax_generation,
    residual_attention_unet_sar_to_ndvi as jax_sar,
    residual_attention_unet_superres as jax_superres,
)
from diffusionremotesensing_tpu_torch.convert import from_jax_variables
from diffusionremotesensing_tpu_torch.ops import cuda_build
from diffusionremotesensing_tpu_torch.models.unet import (
    residual_attention_unet_generation as torch_generation,
    residual_attention_unet_sar_to_ndvi as torch_sar,
    residual_attention_unet_superres as torch_superres,
)

# One intra-op thread for the port's tests: the tier-1 command runs six
# workers on a machine of few cores, and torch's parallel regions over the
# small tensors of these tests then wait on threads the other workers hold
# (a 0.4 s DDIM tile took 85 s there with torch's default threads). Every
# xdist worker imports this module when it collects the port's tests.
torch.set_num_threads(1)

GEN_CLASSES = 4  # the class-conditional model of these tests (the repo's gate has 4)
# each variant's reference model and the port's, built with the same flags
JAX_MODELS = {
    "superres": lambda **kw: jax_superres(magnification_factor=2, **kw),
    "sar": jax_sar,
    "generation": lambda **kw: jax_generation(num_classes=GEN_CLASSES, **kw),
}
PORT_MODELS = {
    "superres": lambda **kw: torch_superres(magnification_factor=2, **kw),
    "sar": torch_sar,
    "generation": lambda **kw: torch_generation(num_classes=GEN_CLASSES, **kw),
}


@functools.lru_cache(maxsize=None)
def random_jax_variables(seed: int = 0, image_size: int = 32, variant: str = "superres") -> dict:
    """{'params', 'batch_stats'} of float32 numpy arrays for the model
    ``variant`` (JAX_MODELS; the x2 model by default): kernels
    U(+-1/sqrt(fan_in)), biases U(+-0.1), BatchNorm scale/var near 1, the
    label embedding N(0, 1). Cached per (seed, image_size, variant) for the
    whole test run, so the test files share one tree: callers read it and
    never write to it."""
    model = JAX_MODELS[variant]()
    shapes = jax.eval_shape(
        lambda: init_unet_params(model, jax.random.PRNGKey(0), image_size=image_size))
    rng = np.random.default_rng(seed)
    ranges = {"bias": (-0.1, 0.1), "scale": (0.8, 1.2), "mean": (-0.1, 0.1), "var": (0.5, 1.5)}

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            b = 1.0 / np.sqrt(np.prod(leaf.shape[:-1]))
            lo, hi = -b, b
        elif name == "embedding":
            return rng.standard_normal(leaf.shape).astype(np.float32)
        else:
            lo, hi = ranges[name]
        return rng.uniform(lo, hi, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def port_model(variables: dict, variant: str = "superres", **kwargs):
    """The port's model ``variant`` (the x2 one by default) in eval mode
    with ``variables`` loaded (strict)."""
    m = PORT_MODELS[variant](**kwargs)
    m.load_state_dict(from_jax_variables(variables["params"], variables["batch_stats"]),
                      strict=True)
    return m.eval()


def model_inputs(seed: int = 0, batch: int = 2, hr: int = 32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, hr, hr, 3)).astype(np.float32)
    t = rng.integers(1, 1500, (batch,)).astype(np.int32)
    cond = rng.random((batch, hr // 2, hr // 2, 3)).astype(np.float32)
    return x, t, cond


# The CUDA names the port's kernels use, for g++: one fiber per CUDA thread
# (threadIdx the running fiber's; a std::thread each under EMU_OS_THREADS),
# a barrier for __syncthreads, bf16 as
# its 16 bits with round-to-nearest-even, and WMMA with every thread of a
# warp holding the whole 16x16 tile (the API keeps fragment contents
# opaque, so this is its meaning; lane 0 stores). For csrc/sm90.cuh's host
# meanings (ldmatrix, wgmma, shfl, mbarriers): a barrier per warpgroup
# (emu_wg_sync) beside the per-warp ones, exchange areas through which the
# lanes of a warp (emu_warp_slots: one 64-bit slot a lane) and the threads of
# a warpgroup (emu_wg_slots: one A fragment a thread) see each other's
# registers, and shared memory aligned as the swizzle atoms want (1024
# bytes), emu_yield and emu_mbar_waited for the mbarrier waits. emu_run
# runs a grid.
EMULATION_PRELUDE = r"""
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <math.h>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <unordered_map>
#include <vector>
#include <sys/mman.h>
#include <ucontext.h>
using std::min;
struct dim3 { unsigned x, y, z; };
struct uint3e { unsigned x, y, z; };
static uint3e blockIdx;
using EmuWaited = std::unordered_map<const uint64_t*, long long>;
#if defined(EMU_OS_THREADS)
static thread_local uint3e threadIdx;
using EmuBarrier = std::barrier<>;
inline void emu_yield() { std::this_thread::yield(); }
inline EmuWaited& emu_mbar_waited() { thread_local EmuWaited w; return w; }
#else
static uint3e threadIdx;  // the running fiber's, set by emu_run's scheduler
struct EmuFiber { ucontext_t ctx; uint3e idx; bool done; EmuWaited waited; void* stack; };
static std::vector<EmuFiber> g_fibers;
static EmuFiber* g_fiber;
static ucontext_t g_sched;
inline void emu_yield() { swapcontext(&g_fiber->ctx, &g_sched); }
inline EmuWaited& emu_mbar_waited() { return g_fiber->waited; }
// a barrier of `count` fibers: the last to arrive opens it, the others give
// way until it has
struct EmuBarrier {
  unsigned count, arrived = 0, gen = 0;
  explicit EmuBarrier(unsigned c) : count(c) {}
  void arrive_and_wait() {
    const unsigned g = gen;
    if (++arrived == count) { arrived = 0; ++gen; return; }
    while (gen == g) emu_yield();
  }
};
#endif
static EmuBarrier* g_bar;
#define __global__
#define __device__
#define __forceinline__ inline
#define __constant__
#define __launch_bounds__(...)
#define __shared__
#define __align__(n)
#define __grid_constant__
inline void __syncthreads() { g_bar->arrive_and_wait(); }
static std::vector<EmuBarrier*>* g_warp_bars;  // one per warp of the running block
inline void __syncwarp() { (*g_warp_bars)[threadIdx.x / 32]->arrive_and_wait(); }
static std::vector<EmuBarrier*>* g_wg_bars;    // one per warpgroup of the running block
inline void emu_wg_sync() { (*g_wg_bars)[threadIdx.x / 128]->arrive_and_wait(); }
static uint64_t g_warp_slots[32][32];
static uint32_t g_wg_slots[8][128][4];
inline uint64_t* emu_warp_slots() { return g_warp_slots[threadIdx.x / 32]; }
inline uint32_t (*emu_wg_slots())[4] { return g_wg_slots[threadIdx.x / 128]; }
inline float rsqrtf(float v) { return 1.0f / std::sqrt(v); }
struct __nv_bfloat16 { uint16_t v; };
inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = uint32_t(b.v) << 16; float f; std::memcpy(&f, &u, 4); return f; }
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u; std::memcpy(&u, &f, 4); u += 0x7fffu + ((u >> 16) & 1u);
  __nv_bfloat16 b; b.v = uint16_t(u >> 16); return b; }
struct alignas(16) float4 { float x, y, z, w; };
#define __host__
static dim3 gridDim, blockDim;
inline unsigned __umulhi(unsigned a, unsigned b) { return unsigned((uint64_t(a) * b) >> 32); }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(8) uint2 { unsigned x, y; };
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 b) { return b.v; }
inline void sincospif(float v, float* s, float* c) {
  *s = float(std::sin(M_PI * double(v))); *c = float(std::cos(M_PI * double(v))); }
inline float cospif(float v) { return float(std::cos(M_PI * double(v))); }
namespace { alignas(1024) unsigned char smem_raw[232448]; }
// WMMA: every thread of a warp holds the whole 16x16 tile (the API keeps
// fragment contents opaque, so this is its meaning); lane 0 stores
namespace nvcuda { namespace wmma {
struct matrix_a {}; struct matrix_b {}; struct accumulator {}; struct row_major {};
enum layout_t { mem_row_major };
template <typename Use, int M, int N, int K, typename T, typename L = void>
struct fragment { float v[256]; };
template <typename F> inline void fill_fragment(F& f, float val) { for (float& e : f.v) e = val; }
template <typename U, typename T, typename L>
inline void load_matrix_sync(fragment<U, 16, 16, 16, T, L>& f, const T* p, unsigned ldm) {
  for (int r = 0; r < 16; ++r)
    for (int c = 0; c < 16; ++c) f.v[r * 16 + c] = __bfloat162float(p[r * ldm + c]); }
template <typename A, typename B, typename C>
inline void mma_sync(C& d, const A& a, const B& b, const C& c) {
  float t[256];
  for (int m = 0; m < 16; ++m)
    for (int n = 0; n < 16; ++n) {
      float s = c.v[m * 16 + n];
      for (int k = 0; k < 16; ++k) s += a.v[m * 16 + k] * b.v[k * 16 + n];
      t[m * 16 + n] = s;
    }
  std::memcpy(d.v, t, sizeof(t)); }
template <typename F>
inline void store_matrix_sync(float* p, const F& f, unsigned ldm, layout_t) {
  if (threadIdx.x % 32 != 0) return;
  for (int r = 0; r < 16; ++r)
    for (int c = 0; c < 16; ++c) p[r * ldm + c] = f.v[r * 16 + c]; }
}}

// Run `kernel` over `grid` one block at a time, a barrier for
// __syncthreads, one per warp for __syncwarp and one per warpgroup; shared
// memory starts as garbage. Each CUDA thread of the block is a fiber of the
// calling thread (its own stack, switched by swapcontext), run in turn
// until it waits at a barrier or an mbarrier and gives way: one OS thread,
// so a loaded machine slows the emulation by its share of a core and no
// more, and the interleaving is the same on every run. The turns go up the
// thread index and down it on alternate passes, odd blocks starting down:
// a thread reading what another wrote with no barrier between them reads
// it too early in one of the two directions, so a missing __syncthreads
// shows in every grid of two or more blocks. With EMU_OS_THREADS
// defined each CUDA thread is a std::thread instead (a lane the OS holds
// back, test_torch_port_mbarrier_lag.py).
template <typename K>
static void emu_run(dim3 grid, unsigned nthreads, K kernel) {
  gridDim = grid;
  blockDim = {nthreads, 1, 1};
  std::memset(smem_raw, 0xff, sizeof(smem_raw));
#if !defined(EMU_OS_THREADS)
  static std::function<void()> body;
  body = kernel;
  constexpr size_t kStack = 1 << 20;  // reserved, touched as used
  while (g_fibers.size() < nthreads) {
    g_fibers.emplace_back();
    g_fibers.back().stack = mmap(nullptr, kStack, PROT_READ | PROT_WRITE,
                                 MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
  }
#endif
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        blockIdx = {x, y, z};
        EmuBarrier bar(nthreads);
        g_bar = &bar;
        std::vector<EmuBarrier*> warps;
        for (unsigned w = 0; w * 32 < nthreads; ++w)
          warps.push_back(new EmuBarrier(std::min(32u, nthreads - 32 * w)));
        g_warp_bars = &warps;
        std::vector<EmuBarrier*> groups;
        for (unsigned w = 0; w * 128 < nthreads; ++w)
          groups.push_back(new EmuBarrier(std::min(128u, nthreads - 128 * w)));
        g_wg_bars = &groups;
#if defined(EMU_OS_THREADS)
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < nthreads; ++t)
          ts.emplace_back([=] {
            threadIdx = {t, 0, 0};
            kernel();
          });
        for (auto& th : ts) th.join();
#else
        for (unsigned t = 0; t < nthreads; ++t) {
          EmuFiber& f = g_fibers[t];
          f.idx = {t, 0, 0};
          f.done = false;
          f.waited.clear();
          getcontext(&f.ctx);
          f.ctx.uc_stack.ss_sp = f.stack;
          f.ctx.uc_stack.ss_size = kStack;
          f.ctx.uc_link = &g_sched;
          makecontext(&f.ctx, +[] { body(); g_fiber->done = true; }, 0);
        }
        const unsigned odd = ((z * grid.y + y) * grid.x + x) & 1;
        for (unsigned live = nthreads, pass = 0; live > 0; ++pass)
          for (unsigned i = 0; i < nthreads; ++i) {
            const unsigned t = ((pass + odd) & 1) ? nthreads - 1 - i : i;
            EmuFiber& f = g_fibers[t];
            if (f.done) continue;
            g_fiber = &f;
            threadIdx = f.idx;
            swapcontext(&g_sched, &f.ctx);
            live -= f.done;
          }
#endif
        for (auto* w : warps) delete w;
        for (auto* w : groups) delete w;
      }
}
"""


# csrc/tap_block_sm90.cuh's block under the emulation, for the launchers of
# the tap_block and tap_stem_block tests: emu_tc<LEVEL>(p, out, ...) runs the
# two launches of tap_tc_kernel (phase A into a scratch h, then phase B) over
# `blocks` persistent blocks (0: one per item, an 8 x 32 tile's N-block of
# 128 columns); p is x, te4, w1, w2,
# b1, bsk, bsh, b2 in bfloat16.
TAP_TC_EMULATION = r"""
template <int LEVEL>
static void emu_tc(const void* const* p, void* out, int B, int H2, int W2, int blocks) {
  using C = Tc<PHASE_A, LEVEL>;
  std::vector<__nv_bfloat16> h((size_t)B * H2 * W2 * C::CO4);
  auto slab = [&](const void* t, long long c) {
    return sm90::TensorMap{t, {c, W2, H2, B}, {2, 2 * c, 2 * c * W2, 2 * c * W2 * H2},
                           {64, TC_SW, TC_SH, 1}};
  };
  const sm90::TensorMap xm = slab(p[0], C::C4), hm = slab(h.data(), C::CO4);
  const sm90::TensorMap w1{p[2], {C::N1, 4 * C::C4, 1, 1}, {2, 2 * C::N1, 0, 0}, {64, 16, 1, 1}};
  const sm90::TensorMap w2{p[3], {C::CO4, 4 * C::CO4, 1, 1}, {2, 2 * C::CO4, 0, 0}, {64, 16, 1, 1}};
  typedef const __nv_bfloat16* Hp;
  const Hp te4 = (Hp)p[1], b1 = (Hp)p[4], bsk = (Hp)p[5], bsh = (Hp)p[6], b2 = (Hp)p[7];
  __nv_bfloat16* hd = h.data();
  __nv_bfloat16* o = (__nv_bfloat16*)out;
  if (blocks == 0) blocks = B * ((H2 + TC_TH - 1) / TC_TH) * ((W2 + TC_TW - 1) / TC_TW) * C::NBLK;
  const dim3 grid{unsigned(blocks), 1, 1};
  emu_run(grid, TC_THREADS, [=] {
    tap_tc_kernel<PHASE_A, LEVEL>(xm, hm, w1, w2, te4, b1, bsk, b2, bsh, hd, B, H2, W2);
  });
  emu_run(grid, TC_THREADS, [=] {
    tap_tc_kernel<PHASE_B, LEVEL>(xm, hm, w1, w2, te4, b1, bsk, b2, bsh, o, B, H2, W2);
  });
}
"""


def compile_emulated(name: str, launcher: str, out_dir, os_threads: bool = False) -> ctypes.CDLL:
    """``csrc/<name>.cu``'s device code (everything above its host
    launchers, local headers inlined) plus ``launcher``, compiled for the
    CPU under EMULATION_PRELUDE; a ``name`` ending in ``.cuh`` takes that
    header alone. The CUDA threads are fibers of the calling thread, or
    with ``os_threads`` a std::thread each. Skips the test when there is
    no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the CUDA source cannot be emulated here")

    def source(fname):
        with open(os.path.join(cuda_build.CSRC_DIR, fname)) as f:
            lines = f.read().splitlines()
        out = []
        for ln in lines:
            m = re.match(r'#include "(.+)"', ln)
            if m:
                out.append(source(m.group(1)))
            elif not ln.startswith("#include") and not ln.startswith("#pragma once"):
                out.append(ln)
        return "\n".join(out)

    device_code = source(name if name.endswith(".cuh") else f"{name}.cu")
    device_code = device_code.split("// ---- host launcher")[0]
    stem = name.split(".")[0]
    cpp = os.path.join(out_dir, f"{stem}_emu.cpp")
    lib = os.path.join(out_dir, f"lib{stem}_emu.so")
    with open(cpp, "w") as f:
        f.write(("#define EMU_OS_THREADS\n" if os_threads else "") + EMULATION_PRELUDE
                + device_code + launcher)
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-o", lib, cpp],
                   check=True, timeout=300)
    return ctypes.CDLL(lib)
