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
from diffusionremotesensing_tpu_torch.parallel.halo import band_row_counts
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
// bfloat16: the persistent wgmma kernel over `blocks` blocks (each walks
// tiles blockIdx.x, blockIdx.x + blocks, ...); float32: a block per tile
template <int NW>
static void emu_tc(const void* x, const void* wa, const void* wb, void* oa, void* ob, int B,
                   int H2, int W2, int C4, int CO4, int blocks) {
  const sm90::TensorMap xmap{x, {C4, W2, H2, B}, {2, 2LL * C4, 2LL * W2 * C4, 2LL * H2 * W2 * C4},
                             {64, SW, SH, 1}};
  const sm90::TensorMap wamap{wa, {CO4, 4 * C4, 1, 1}, {2, 2LL * CO4, 0, 0}, {64, TC_WBOX, 1, 1}};
  sm90::TensorMap wbmap = wamap;
  wbmap.base = wb;
  emu_run({unsigned(blocks), 1, 1}, TC_THREADS, [=] {
    tap_conv_tc_kernel<NW>(xmap, wamap, wbmap, (__nv_bfloat16*)oa, (__nv_bfloat16*)ob, B, H2, W2,
                           C4, CO4);
  });
}
template <int NW>
static void emu_f32(const void* x, const void* wa, const void* wb, void* oa, void* ob, int B,
                    int H2, int W2, int C4, int CO4) {
  emu_run({unsigned((W2 + TW - 1) / TW), unsigned((H2 + TH - 1) / TH), unsigned(B)}, F32_THREADS,
          [=] {
            tap_conv_f32_kernel<NW>((const float*)x, (const float*)wa, (const float*)wb,
                                    (float*)oa, (float*)ob, H2, W2, C4, CO4);
          });
}
extern "C" void emu_launch(const void* x, const void* wa, const void* wb, void* oa, void* ob,
                           int B, int H2, int W2, int C4, int CO4, int is_bf16, int pair,
                           int blocks) {
  if (is_bf16 && pair) emu_tc<2>(x, wa, wb, oa, ob, B, H2, W2, C4, CO4, blocks);
  else if (is_bf16) emu_tc<1>(x, wa, wb, oa, ob, B, H2, W2, C4, CO4, blocks);
  else if (pair) emu_f32<2>(x, wa, wb, oa, ob, B, H2, W2, C4, CO4);
  else emu_f32<1>(x, wa, wb, oa, ob, B, H2, W2, C4, CO4);
}
extern "C" size_t emu_smem(int C4, int CO4, int nw) { return tc_smem_bytes(C4, CO4, nw); }
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    lib = compile_emulated("tap_conv", _LAUNCHER, tmp_path_factory.mktemp("tap_conv_emu"))
    lib.emu_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
    lib.emu_smem.argtypes = [ctypes.c_int] * 3
    lib.emu_smem.restype = ctypes.c_size_t
    return lib


def _run_emulated(lib, pair, B, H2, W2, dtype, blocks=None, tap=True, seed=10):
    """One emulated launch at conv2's widths (4C=128 -> 128) or the pair's
    (4C=64 -> 2 x 128), held against the plain version. bfloat16 runs on
    `blocks` persistent blocks (default: one per tile, as on a card with
    more SMs than tiles); tap=False draws W at random, every entry nonzero."""
    ci = 16 if pair else 32
    x = torch.from_numpy(_x(seed, B, H2, W2, 4 * ci)).to(dtype)
    if tap:
        wa, wb = (tap_weight(torch.from_numpy(_w(s, ci, 32))) for s in (11, 12))
    else:
        rng = np.random.default_rng(seed + 1)
        wa, wb = (torch.from_numpy(rng.standard_normal((16 * ci, 128)).astype(np.float32) * 0.1)
                  for _ in range(2))
    wa, wb = wa.to(dtype).contiguous(), wb.to(dtype).contiguous()
    oa, ob = (torch.empty((B, H2, W2, 128), dtype=dtype) for _ in range(2))
    tiles = B * -(-H2 // 8) * -(-W2 // 16)
    lib.emu_launch(x.data_ptr(), wa.data_ptr(), wb.data_ptr(), oa.data_ptr(), ob.data_ptr(),
                   B, H2, W2, 4 * ci, 128, int(dtype == torch.bfloat16), int(pair),
                   min(tiles, 132) if blocks is None else blocks)
    want = tap_conv_pair_plain(x, wa, wb) if pair else (tap_conv_plain(x, wa),)
    # float32: the same products summed in another order; bfloat16: the
    # output rounded to bf16 on either side of a boundary (chip_smoke.py)
    tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2}[dtype]
    for got, w in zip((oa, ob), want):
        w = w.float()
        assert (got.float() - w).abs().max().item() <= tol * max(1.0, w.abs().max().item())


@pytest.mark.parametrize("pair,B,H2,W2,dtype", [
    (False, 1, 8, 16, torch.float32),    # conv2's widths, one tile
    (False, 2, 10, 20, torch.float32),   # several tiles, ragged edges
    (True, 1, 10, 20, torch.float32),    # the pair, ragged
    (False, 1, 8, 16, torch.bfloat16),   # the tensor-core path
    (True, 1, 10, 20, torch.bfloat16),   # the pair on the tensor cores, ragged
])
def test_cuda_source_emulated_matches_plain(emulated, pair, B, H2, W2, dtype):
    _run_emulated(emulated, pair, B, H2, W2, dtype)


@pytest.mark.parametrize("pair,B,H2,W2,blocks,tap", [
    (False, 2, 10, 20, 3, True),    # 8 tiles on 3 blocks: each walks both slab buffers
    (True, 2, 10, 20, 3, True),     # the same for the pair
    (False, 1, 16, 16, None, True),  # B=1, two tiles
    (False, 1, 10, 20, None, True),  # conv2 ragged, bf16
    (False, 1, 8, 16, None, False),  # a random W: nothing relies on structural zeros
    (True, 1, 10, 20, 2, False),     # the pair, random W, blocks walking tiles
])
def test_cuda_source_emulated_bf16_persistent(emulated, pair, B, H2, W2, blocks, tap):
    _run_emulated(emulated, pair, B, H2, W2, torch.bfloat16, blocks, tap)


# the stem chain's row counts on the bands of a split of the HR-64 image
# (32 rows and columns on the s2d grid), k = 2 and 4: 18; 10 and 12
BAND_ROWS = sorted(set(band_row_counts("stem_s2d", 32, 2) + band_row_counts("stem_s2d", 32, 4)))


@pytest.mark.parametrize("pair,dtype", [(False, torch.float32), (True, torch.float32),
                                        (False, torch.bfloat16), (True, torch.bfloat16)])
@pytest.mark.parametrize("h2", BAND_ROWS)
def test_cuda_source_emulated_at_the_band_shapes(emulated, pair, dtype, h2):
    """conv2 and the pair on an extended band of a spatial split: row
    counts no 8-row tile divides, on the 32 s2d columns of the image."""
    _run_emulated(emulated, pair, 1, h2, 32, dtype)


def test_smem_budget_matches_the_source(emulated):
    """ops/tap_conv.py's shared-memory count is the kernel's, and conv2's
    fits within 6 KB of the limit as the source note says."""
    for c4, co4, nw in ((128, 128, 1), (64, 128, 2), (64, 256, 1), (128, 256, 1)):
        assert tc.smem_bytes(c4, co4, nw, torch.bfloat16) == emulated.emu_smem(c4, co4, nw)
    assert tc.smem_bytes(128, 128, 1, torch.bfloat16) == 226344 <= tc.SMEM_LIMIT
    assert tc.smem_bytes(64, 128, 2, torch.bfloat16) == 179240


def test_check_refuses_a_weight_too_large_to_stage():
    """bfloat16 W is staged whole in shared memory: 4C=128 -> 4Co=256 (256 KB)
    does not fit and raises before any launch; float32 keeps the old design,
    which reads W through the caches, and takes it."""
    x = torch.zeros((1, 8, 8, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shared memory"):
        tc._check("tap_conv", x, [torch.zeros((512, 256), dtype=torch.bfloat16)])
    with pytest.raises(ValueError, match="shared memory"):  # the pair at conv2's widths
        tc._check("tap_conv_pair", x, [torch.zeros((512, 128), dtype=torch.bfloat16)] * 2)
    with pytest.raises(ValueError, match="4Co % 128"):
        tc._check("tap_conv", x, [torch.zeros((512, 64), dtype=torch.bfloat16)])
    tc._check("tap_conv", x.float(), [torch.zeros((512, 256))])
