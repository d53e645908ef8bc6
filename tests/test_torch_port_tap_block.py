"""ops/tap_block.py of the port: the BN-folded weights and the plain version
against the reference package's Pallas tap_block (interpret mode, as
tests/test_tap_stem.py runs it; float32, atol 2e-5), the wrapper's CPU path
and checks, the structure of W1's shortcut columns the kernels rely on,
and the CUDA source itself: its im2col table (csrc/tap_block_sm90.cuh)
against the Python one, and the source compiled with g++ under a small
emulation of the CUDA thread model (one fiber per CUDA thread, a barrier
for __syncthreads), held against the plain version. The card
runs the real kernel in chip_smoke.py."""

import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu.ops.tap_block import (
    build_block_weights as jax_build_block_weights,
    tap_block as jax_tap_block,
)
from diffusionremotesensing_tpu_torch.ops import cuda_build
from diffusionremotesensing_tpu_torch.ops.tap_block import (
    build_block_weights,
    tap_block,
    tap_block_plain,
)
from diffusionremotesensing_tpu_torch.ops.tap_conv import PIECES
from diffusionremotesensing_tpu_torch.parallel.halo import band_row_counts
from tests.torch_port_helpers import TAP_TC_EMULATION, compile_emulated


def _raw_weights(seed, ci=16, co=32, skip=True):
    """build_block_weights' arguments; skip=False: level 1's block, whose
    skip conv is None."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=0.1):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def bn():
        return {"scale": 1 + r(co, scale=0.2), "bias": r(co), "mean": r(co),
                "var": np.abs(r(co, scale=0.2)) + 0.5}

    sk = [r(3, 3, ci, co), r(co)] if skip else [None, None]
    return [r(3, 3, ci, co), r(co), bn(), *sk, r(3, 3, co, co), r(co), bn(),
            r(1, 1, ci, co), r(co), bn()]


def _as(raw, fn):
    return [{k: fn(v) for k, v in a.items()} if isinstance(a, dict)
            else None if a is None else fn(a) for a in raw]


def _inputs(seed, B, H2, W2, c4=64, co4=128):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H2, W2, c4)).astype(np.float32)
    te4 = (np.maximum(rng.standard_normal((B, co4)), 0) * 0.3).astype(np.float32)
    return x, te4


# level 0 (the block with its skip conv) and level 1 (tap44='l1': Ci=32,
# Co=64, no skip conv)
LEVELS = {0: dict(ci=16, co=32, skip=True), 1: dict(ci=32, co=64, skip=False)}


def test_build_block_weights_matches_reference():
    raw = _raw_weights(0)
    want = jax_build_block_weights(*_as(raw, jnp.asarray))
    got = build_block_weights(*_as(raw, torch.from_numpy))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6, err_msg=k)


def test_build_block_weights_without_skip_matches_reference():
    """Level 1's block: w_skip=None gives w1 = [conv1' | shortcut'] of
    (16Ci, 2*4Co) and a zero bsk, as the reference builds them."""
    raw = _raw_weights(0, **LEVELS[1])
    want = jax_build_block_weights(*_as(raw, jnp.asarray))
    got = build_block_weights(*_as(raw, torch.from_numpy))
    assert set(got) == set(want)
    assert tuple(got["w1"].shape) == (16 * 32, 2 * 256) and not got["bsk"].any()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6, err_msg=k)


@pytest.mark.parametrize("B,H2,W2", [(2, 16, 16), (1, 8, 8)])
def test_plain_matches_reference_kernel(B, H2, W2):
    raw = _raw_weights(1)
    x, te4 = _inputs(2, B, H2, W2)
    want = jax_tap_block(jnp.asarray(x), jnp.asarray(te4),
                         jax_build_block_weights(*_as(raw, jnp.asarray)), interpret=True)
    got = tap_block_plain(torch.from_numpy(x), torch.from_numpy(te4),
                          build_block_weights(*_as(raw, torch.from_numpy)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_plain_level1_matches_reference_kernel():
    """Level 1 (4Ci=128, 4Co=256, no skip conv) at the golden input's level-1
    size, 8x8 s2d pixels."""
    raw = _raw_weights(1, **LEVELS[1])
    x, te4 = _inputs(2, 1, 8, 8, 128, 256)
    want = jax_tap_block(jnp.asarray(x), jnp.asarray(te4),
                         jax_build_block_weights(*_as(raw, jnp.asarray)), interpret=True)
    got = tap_block_plain(torch.from_numpy(x), torch.from_numpy(te4),
                          build_block_weights(*_as(raw, torch.from_numpy)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_plain_bf16_rounds_like_reference():
    raw = _raw_weights(3)
    x, te4 = _inputs(4, 1, 8, 8)
    bw_j = {k: v.astype(jnp.bfloat16) for k, v in jax_build_block_weights(*_as(raw, jnp.asarray)).items()}
    want = jax_tap_block(jnp.asarray(x, jnp.bfloat16), jnp.asarray(te4, jnp.bfloat16), bw_j,
                         interpret=True)
    bw_t = {k: v.to(torch.bfloat16) for k, v in build_block_weights(*_as(raw, torch.from_numpy)).items()}
    got = tap_block_plain(torch.from_numpy(x).bfloat16(), torch.from_numpy(te4).bfloat16(), bw_t)
    assert got.dtype == torch.bfloat16
    want32 = np.asarray(want.astype(jnp.float32))
    # both round h and out to bf16 after float32 sums in different orders
    np.testing.assert_allclose(got.float().numpy(), want32, atol=1e-2 * max(1.0, np.abs(want32).max()))


def test_wrapper_cpu_path_is_the_plain_version_and_not_counted():
    bw = build_block_weights(*_as(_raw_weights(5), torch.from_numpy))
    x, te4 = (torch.from_numpy(a) for a in _inputs(6, 1, 8, 8))
    before = tap_block.launches
    assert torch.equal(tap_block(x, te4, bw), tap_block_plain(x, te4, bw))
    assert tap_block.launches == before


def test_wrapper_refuses_other_devices():
    bw = {k: v.to("meta") for k, v in build_block_weights(*_as(_raw_weights(7), torch.from_numpy)).items()}
    x = torch.empty((1, 8, 8, 64), device="meta")
    with pytest.raises(ValueError):
        tap_block(x, torch.empty((1, 128), device="meta"), bw)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """With no nvcc to be found, building raises a clear error: nothing is
    loaded and nothing falls back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_build, "_LOADED", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build("tap_block")


def test_cuda_piece_table_matches_python_order():
    with open(os.path.join(cuda_build.CSRC_DIR, "tap_block_sm90.cuh")) as f:
        src = f.read()

    def table(name):
        body = re.search(name + r"\[16\] = \{([^}]*)\}", src).group(1)
        return [int(v) for v in body.split(",")]

    rows, cols = table("kPieceRow"), table("kPieceCol")
    assert [(r, c, k % 4) for k, (r, c) in enumerate(zip(rows, cols))] == PIECES


_EMULATION_LAUNCHER = TAP_TC_EMULATION + r"""
// float32: the FMA kernel, a block per tile
template <int TH, bool SKIP>
static void emu_fma(const void* const* p, void* out, int B, int H2, int W2, int C4, int CO4) {
  typedef const float* F;
  emu_run({unsigned((W2 + TW - 1) / TW), unsigned((H2 + TH - 1) / TH), unsigned(B)}, NTHREADS, [=] {
    tap_block_fma_kernel<TH, SKIP>((F)p[0], (F)p[1], (F)p[2], (F)p[3], (F)p[4], (F)p[5], (F)p[6],
                                   (F)p[7], (float*)out, H2, W2, C4, CO4);
  });
}
extern "C" void emu_launch(const void* x, const void* te4, const void* w1, const void* w2,
                           const void* b1, const void* bsk, const void* bsh, const void* b2,
                           void* out, int B, int H2, int W2, int C4, int CO4, int has_skip,
                           int is_bf16, int blocks) {
  const void* p[8] = {x, te4, w1, w2, b1, bsk, bsh, b2};
  // the two instantiations the model launches
  if (C4 == 64 && CO4 == 128 && has_skip) {
    if (is_bf16) emu_tc<0>(p, out, B, H2, W2, blocks);
    else emu_fma<16, true>(p, out, B, H2, W2, C4, CO4);
  } else if (C4 == 128 && CO4 == 256 && !has_skip) {
    if (is_bf16) emu_tc<1>(p, out, B, H2, W2, blocks);
    else emu_fma<8, false>(p, out, B, H2, W2, C4, CO4);
  } else {
    std::abort();
  }
}
extern "C" size_t emu_smem(int CO4, int is_bf16) {
  return is_bf16 ? (size_t)TC_BYTES : fma_smem_bytes(CO4);
}
"""


@pytest.fixture(scope="module")
def emulated_kernel(tmp_path_factory):
    """csrc/tap_block.cu's device code (everything above its host launcher,
    the shared header inlined), compiled for the CPU under the emulation of
    tests/torch_port_helpers.py."""
    lib = compile_emulated("tap_block", _EMULATION_LAUNCHER,
                           tmp_path_factory.mktemp("tap_block_emu"))
    lib.emu_launch.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
    lib.emu_launch.restype = None
    lib.emu_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.emu_smem.restype = ctypes.c_size_t
    return lib


def _emulate(lib, level, B, H2, W2, dtype, seed, blocks=0):
    """One emulated call of level `level`'s block, held against the plain
    version: float32 to 1e-5 (the same products summed in another order),
    bfloat16 to 1e-2 (h and the output rounded to bf16 on either side of a
    boundary, as chip_smoke.py holds the card), of max |plain|."""
    lv = LEVELS[level]
    c4, co4 = 4 * lv["ci"], 4 * lv["co"]
    bw = {k: v.to(dtype).contiguous()
          for k, v in build_block_weights(*_as(_raw_weights(seed, **lv), torch.from_numpy)).items()}
    x, te4 = (torch.from_numpy(a).to(dtype) for a in _inputs(seed + 1, B, H2, W2, c4, co4))
    out = torch.empty((B, H2, W2, co4), dtype=dtype)
    lib.emu_launch(x.data_ptr(), te4.data_ptr(),
                   *[bw[k].data_ptr() for k in ("w1", "w2", "b1", "bsk", "bsh", "b2")],
                   out.data_ptr(), B, H2, W2, c4, co4, int(lv["skip"]),
                   int(dtype == torch.bfloat16), blocks)
    want = tap_block_plain(x, te4, bw).float()
    tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2}[dtype]
    assert (out.float() - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())


@pytest.mark.parametrize("B,H2,W2,dtype", [
    (1, 16, 16, torch.float32),   # the HR-32 shape of the tests
    (2, 20, 12, torch.float32),   # several tiles, ragged edges
    (1, 5, 33, torch.float32),    # one row of ragged tiles
    (1, 16, 16, torch.bfloat16),  # the tensor-core path
    (1, 20, 12, torch.bfloat16),  # ... with ragged tiles
])
def test_cuda_source_emulated_matches_plain(emulated_kernel, B, H2, W2, dtype):
    _emulate(emulated_kernel, 0, B, H2, W2, dtype, 8)


@pytest.mark.parametrize("B,H2,W2,dtype", [
    (1, 10, 20, torch.float32),   # level 1, 4Ci=128, 4Co=256: 2x2 tiles of 8x16, ragged
    (1, 10, 8, torch.bfloat16),   # ... on the tensor cores, two tile rows
])
def test_cuda_source_emulated_level1_matches_plain(emulated_kernel, B, H2, W2, dtype):
    """Level 1's block (no skip conv) against the plain version, on images
    that cross the tile edges."""
    _emulate(emulated_kernel, 1, B, H2, W2, dtype, 13)


# 'l1''s level-1 chain (block_s2d) row counts on the bands of a split of
# the HR-64 image (16 rows and columns on the level-1 s2d grid), k = 2 and
# 4: 9; 5 and 6
BAND_ROWS = sorted(set(band_row_counts("block_s2d", 16, 2) + band_row_counts("block_s2d", 16, 4)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h2", BAND_ROWS)
def test_cuda_source_emulated_level1_at_the_band_shapes(emulated_kernel, dtype, h2):
    """Level 1's block on an extended band of a spatial split under 'l1'."""
    _emulate(emulated_kernel, 1, 1, h2, 16, dtype, 19)


def test_shared_memory_fits_at_both_levels(emulated_kernel):
    """bfloat16 runs one layout at both levels (3 plane slots and 6 weight
    pieces, 231,568 bytes: the source note's tally); float32's 16x16
    (level 0) and 8x16 (level 1) tiles fit 4Co=256 too, all under Hopper's
    232,448 bytes."""
    assert emulated_kernel.emu_smem(128, 1) == 231568
    for co4 in (128, 256):
        for bf in (0, 1):
            assert emulated_kernel.emu_smem(co4, bf) <= 232448


@pytest.mark.parametrize("level,B,H2,W2,blocks", [
    (0, 2, 9, 33, 3),   # 8 ragged tiles on 3 blocks: block 0's 9 phase-B planes through 3 slots
    (1, 1, 9, 20, 1),   # 2 ragged tiles x 2 N-blocks on one block: 24 phase-B plane visits
])
def test_cuda_source_emulated_bf16_persistent(emulated_kernel, level, B, H2, W2, blocks):
    """More tiles than blocks, so that the plane and weight rings wrap
    (their parities over several rounds), on images that cross tile edges."""
    _emulate(emulated_kernel, level, B, H2, W2, torch.bfloat16, 17, blocks)


@pytest.mark.parametrize("level", [0, 1])
def test_shortcut_columns_are_block_diagonal_centre_rows(level):
    """W1's shortcut columns are zero outside the 4 centre pieces (shift 0,
    0; piece 5t for tap block t) and block-diagonal inside them, the folded
    1x1 kernel on the diagonal: the kernels multiply only those rows."""
    lv = LEVELS[level]
    ci, co = lv["ci"], lv["co"]
    bw = build_block_weights(*_as(_raw_weights(21, **lv), torch.from_numpy))
    w_sh = bw["w1"][:, -4 * co:].reshape(16, ci, 4, co)  # piece, channel, tap block, column
    centre = [k for k, (r, c, _) in enumerate(PIECES) if (r, c) == (1, 1)]
    assert centre == [0, 5, 10, 15] and [PIECES[k][2] for k in centre] == [0, 1, 2, 3]
    diag = w_sh[0, :, 0]
    assert diag.abs().min() > 0
    for k in range(16):
        for t in range(4):
            if k in centre and PIECES[k][2] == t:
                assert torch.equal(w_sh[k, :, t], diag)
            else:
                assert not w_sh[k, :, t].any(), (k, t)


def test_wrapper_checks_the_level1_weights():
    """The no-skip w1 is (16Ci, 2*4Co); a w1 of the other width is refused."""
    from diffusionremotesensing_tpu_torch.ops import tap_block as tb

    bw = build_block_weights(*_as(_raw_weights(15, **LEVELS[1]), torch.from_numpy))
    x, te4 = (torch.from_numpy(a) for a in _inputs(16, 1, 8, 8, 128, 256))
    tb._check(x, te4, bw)
    with pytest.raises(ValueError, match="w1"):
        tb._check(x, te4, dict(bw, w1=torch.zeros((512, 3 * 256 + 1))))
    with pytest.raises(ValueError, match="4Co in"):
        tb._check(torch.zeros((1, 8, 8, 128)), torch.zeros((1, 384)),
                  dict(bw, w2=torch.zeros((4 * 384, 384))))
