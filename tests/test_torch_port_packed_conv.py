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


def test_wrapper_refuses_unaligned_bf16_operands():
    """bfloat16 x and k are read by TMA, whose global address must be
    16-byte aligned: an unaligned start raises; float32 (the FMA kernel,
    no TMA) takes it."""
    def unaligned(shape, dtype):
        n = int(np.prod(shape))
        return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)

    k = torch.zeros((3, 3, 32, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        pc._check(unaligned((1, 8, 8, 32), torch.bfloat16), k, None)
    with pytest.raises(ValueError, match="aligned"):
        pc._check(torch.zeros((1, 8, 8, 32), dtype=torch.bfloat16), unaligned(k.shape, k.dtype),
                  None)
    pc._check(torch.zeros((1, 8, 8, 32), dtype=torch.bfloat16), k, None)
    pc._check(unaligned((1, 8, 8, 32), torch.float32), k.float(), None)


_LAUNCHER = r"""
// float32: the FMA kernel, a block per 8 x 16 tile
template <int NF>
static void emu_f32(const void* x, const void* w, const void* bias, void* out, int B, int H,
                    int W, int Ci) {
  emu_run({unsigned((W + FTW - 1) / FTW), unsigned((H + FTH - 1) / FTH), unsigned(B)}, NTHREADS,
          [=] {
            conv_f32_kernel<NF>((const float*)x, (const float*)w, (const float*)bias, (float*)out,
                                H, W, Ci);
          });
}
// bfloat16: the wgmma kernel over `blocks` persistent blocks (0: one per
// 8 x 32 tile), K resident where it fits as the launcher decides
template <int N, bool RESIDENT>
static void emu_tc_run(const sm90::TensorMap& xm, const sm90::TensorMap& wm, const void* bias,
                       void* out, int B, int H, int W, int Ci, int Co, int blocks) {
  emu_run({unsigned(blocks), 1, 1}, TC_THREADS, [=] {
    conv_tc_kernel<N, RESIDENT>(xm, wm, (const __nv_bfloat16*)bias, (__nv_bfloat16*)out, B, H, W,
                                Ci, Co);
  });
}
template <int N>
static void emu_tc(const void* x, const void* w, const void* bias, void* out, int B, int H, int W,
                   int Ci, int Co, int blocks) {
  const long long c = Ci;
  const sm90::TensorMap xm{x, {c, W, H, B}, {2, 2 * c, 2 * c * W, 2 * c * W * H}, {64, SW, SH, 1}};
  const sm90::TensorMap wm{w, {Co, 9 * c, 1, 1}, {2, 2 * Co, 0, 0}, {N == 64 ? 64 : 16, 64, 1, 1},
                           N == 64 ? 128 : 32};
  if (blocks == 0) blocks = B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (resident<N>(Ci)) emu_tc_run<N, true>(xm, wm, bias, out, B, H, W, Ci, Co, blocks);
  else emu_tc_run<N, false>(xm, wm, bias, out, B, H, W, Ci, Co, blocks);
}
extern "C" void emu_launch(const void* x, const void* w, const void* bias, void* out, int B, int H,
                           int W, int Ci, int Co, int is_bf16, int blocks) {
  if (is_bf16) {
    if (Co == 16) emu_tc<16>(x, w, bias, out, B, H, W, Ci, Co, blocks);
    else if (Co == 32) emu_tc<32>(x, w, bias, out, B, H, W, Ci, Co, blocks);
    else emu_tc<64>(x, w, bias, out, B, H, W, Ci, Co, blocks);
  } else {
    if (Co == 16) emu_f32<1>(x, w, bias, out, B, H, W, Ci);
    else if (Co == 32) emu_f32<2>(x, w, bias, out, B, H, W, Ci);
    else if (Co == 48) emu_f32<3>(x, w, bias, out, B, H, W, Ci);
    else emu_f32<4>(x, w, bias, out, B, H, W, Ci);
  }
}
// the wgmma kernel's shared memory at N = 64 and Ci (resident or streamed,
// as the launcher decides), and whether K is resident
extern "C" int emu_tc_bytes(int Ci) {
  const int nb = 9 * ((Ci + 63) / 64);
  return resident<64>(Ci) ? Tc<64, true>::bytes(nb) : Tc<64, false>::bytes(nb);
}
extern "C" int emu_resident(int Ci) { return resident<64>(Ci); }
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    lib = compile_emulated("packed_conv", _LAUNCHER, tmp_path_factory.mktemp("packed_conv_emu"))
    lib.emu_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
    lib.emu_tc_bytes.argtypes = lib.emu_resident.argtypes = [ctypes.c_int]
    return lib


def _run_emulated(lib, B, H, W, ci, co, with_bias, dtype, blocks=0):
    """One emulated call held against the plain version; bfloat16 runs the
    wgmma kernel on `blocks` persistent blocks (0: one per 8 x 32 tile, as
    on a card with more SMs than tiles)."""
    x, k, b = (torch.from_numpy(a).to(dtype).contiguous() for a in _inputs(5, B, H, W, ci, co))
    bias = b if with_bias else None
    out = torch.empty((B, H, W, co), dtype=dtype)
    lib.emu_launch(x.data_ptr(), k.data_ptr(), None if bias is None else bias.data_ptr(),
                   out.data_ptr(), B, H, W, ci, co, int(dtype == torch.bfloat16), blocks)
    want = packed_conv_plain(x, k, bias).float()
    # float32: the same products summed in another order; bfloat16: the
    # output rounded to bf16 on either side of a boundary (chip_smoke.py)
    tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2}[dtype]
    assert (out.float() - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())


@pytest.mark.parametrize("B,H,W,ci,co,with_bias,dtype", [
    (1, 8, 16, 64, 64, True, torch.float32),      # 64->64, one tile
    (2, 11, 20, 32, 64, False, torch.float32),    # several tiles, ragged edges, no bias
    (1, 9, 18, 192, 64, True, torch.float32),     # 192->64, ragged
    (1, 10, 17, 16, 32, True, torch.float32),     # Co = 32
    (1, 8, 16, 64, 64, True, torch.bfloat16),     # the tensor-core path
    (1, 11, 20, 192, 64, True, torch.bfloat16),   # ... 192->64 with ragged tiles
])
def test_cuda_source_emulated_matches_plain(emulated, B, H, W, ci, co, with_bias, dtype):
    _run_emulated(emulated, B, H, W, ci, co, with_bias, dtype)


@pytest.mark.parametrize("B,H,W,ci,co,with_bias,blocks", [
    (1, 8, 32, 64, 64, True, 0),     # the flagship 64->64 on one tile, K resident
    (1, 8, 32, 192, 64, True, 0),    # 192->64 on one tile: 27 pieces through 6 slots
    (2, 11, 37, 64, 64, True, 0),    # ragged H and W, which no 8 x 32 tile divides
    (2, 16, 40, 192, 64, False, 3),  # 8 tiles on 3 blocks: 24 planes through 4 slots
    (2, 13, 33, 64, 64, True, 1),    # 8 ragged tiles on one block: the resident ring wraps
    (1, 9, 20, 32, 16, True, 0),     # Co = 16 (N = 16), Ci = 32: zero channels past Ci
    (1, 9, 20, 96, 32, True, 0),     # Co = 32 (two 16-column atoms), a partial second plane
    (1, 9, 20, 32, 48, True, 0),     # Co = 48 at N = 64: K's columns 48-63 land as zeros
    (1, 8, 33, 128, 48, False, 1),   # Co = 48 with K streamed (2 planes), 2 tiles on 1 block
])
def test_cuda_source_emulated_bf16_wgmma(emulated, B, H, W, ci, co, with_bias, blocks):
    _run_emulated(emulated, B, H, W, ci, co, with_bias, torch.bfloat16, blocks)


def test_smem_budget_matches_the_source(emulated):
    """The wgmma kernel's shared-memory tallies at the flagship widths are
    the source note's, each within the 232,448 bytes a block may have:
    64->64 keeps K resident, 192->64 streams it."""
    assert emulated.emu_resident(64) and not emulated.emu_resident(192)
    assert [emulated.emu_tc_bytes(ci) for ci in (64, 192)] == [206904, 226464]
    assert max(emulated.emu_tc_bytes(ci) for ci in (16, 64, 128, 192, 512)) <= 232448
