"""ops/att_block.py of the port: the BN-folded weights against the
reference package's build_att_weights, the plain version against its Pallas
att_head_block (interpret mode, output unpacked with unpack_v8; float32,
atol 2e-5, and bf16 within the rounding of its outputs), the wrapper's CPU
path and checks, and csrc/att_head_block.cu compiled with g++ under the CUDA
emulation of tests/torch_port_helpers.py, held against the plain version.
The card runs the real kernel in chip_smoke.py."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu.ops.att_block import (
    att_head_block as jax_att_head_block,
    build_att_weights as jax_build_att_weights,
    unpack_v8,
)
from diffusionremotesensing_tpu.ops.packed_head import kpack_weights
from diffusionremotesensing_tpu_torch.ops.att_block import (
    att_head_block,
    att_head_block_plain,
    build_att_weights,
)
from diffusionremotesensing_tpu_torch.ops.s2d import k1_to_blockdiag
from tests.torch_port_helpers import compile_emulated


def _raw(seed, c=32, ch=64, out4=12):
    rng = np.random.default_rng(seed)

    def r(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def bn():
        return {"scale": 1 + r(c, scale=0.2), "bias": r(c, scale=0.1), "mean": r(c, scale=0.1),
                "var": np.abs(r(c, scale=0.2)) + 0.5}

    rc = k1_to_blockdiag(torch.from_numpy(r(1, 1, c, c, scale=0.2))).numpy()
    return [r(1, 1, ch, c, scale=0.2), r(c, scale=0.1), bn(), r(1, 1, c, c, scale=0.2),
            r(c, scale=0.1), r(1, 1, 4 * c, c, scale=0.15), r(c, scale=0.1),
            r(1, 1, c, 1, scale=0.3), r(1, scale=0.1), rc, r(c, scale=0.1), bn(),
            r(3, 3, 4 * c, out4, scale=0.1)]


def _as(raw, fn):
    return [{k: fn(v) for k, v in a.items()} if isinstance(a, dict) else fn(a) for a in raw]


def _inputs(seed, B, H, W):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, W, 128)).astype(np.float32) * 0.5,
            rng.standard_normal((B, H, W, 64)).astype(np.float32) * 0.5)


@pytest.fixture(scope="module")
def raw():
    return _raw(0)


def test_build_att_weights_matches_reference(raw):
    want = jax_build_att_weights(*_as(raw, jnp.asarray))
    got = build_att_weights(*_as(raw, torch.from_numpy))
    for k in set(want) - {"atp"}:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6, err_msg=k)
    # the reference keeps head_at V=8-packed; the port keeps it as it is
    np.testing.assert_array_equal(np.asarray(kpack_weights(jnp.asarray(got["at"].numpy()))),
                                  np.asarray(want["atp"]))
    atk = got["atk"].numpy()
    np.testing.assert_array_equal(atk[:, :12], raw[-1].reshape(9 * 128, 12))
    assert atk.shape == (9 * 128, 16) and not atk[:, 12:].any()


def test_plain_matches_reference_kernel(raw):
    x, h = _inputs(1, 2, 16, 8)  # two of the reference's 8-row packed groups
    want = unpack_v8(jax_att_head_block(jnp.asarray(x), jnp.asarray(h),
                                        jax_build_att_weights(*_as(raw, jnp.asarray)),
                                        interpret=True), 12)
    got = att_head_block_plain(torch.from_numpy(x), torch.from_numpy(h),
                               build_att_weights(*_as(raw, torch.from_numpy)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_plain_bf16_rounds_like_reference(raw):
    x, h = _inputs(2, 1, 8, 8)
    wj = {k: v.astype(jnp.bfloat16) for k, v in jax_build_att_weights(*_as(raw, jnp.asarray)).items()}
    want = unpack_v8(jax_att_head_block(jnp.asarray(x, jnp.bfloat16), jnp.asarray(h, jnp.bfloat16),
                                        wj, interpret=True), 12)
    wt = {k: v.bfloat16() for k, v in build_att_weights(*_as(raw, torch.from_numpy)).items()}
    got = att_head_block_plain(torch.from_numpy(x).bfloat16(), torch.from_numpy(h).bfloat16(), wt)
    assert got.dtype == torch.bfloat16
    want32 = np.asarray(want.astype(jnp.float32))
    # both round g, a, psi, the gated x, attn_s and the output to bf16 after
    # float32 sums in different orders: a value at a rounding boundary may
    # land one ulp apart and carry through the head
    np.testing.assert_allclose(got.float().numpy(), want32, atol=1e-2 * max(1.0, np.abs(want32).max()))


def test_wrapper_cpu_path_is_the_plain_version_and_not_counted(raw):
    w = build_att_weights(*_as(raw, torch.from_numpy))
    x, h = (torch.from_numpy(a) for a in _inputs(3, 1, 8, 8))
    before = att_head_block.launches
    assert torch.equal(att_head_block(x, h, w), att_head_block_plain(x, h, w))
    assert att_head_block.launches == before


def test_wrapper_refuses_other_devices(raw):
    w = {k: v.to("meta") for k, v in build_att_weights(*_as(raw, torch.from_numpy)).items()}
    with pytest.raises(ValueError):
        att_head_block(torch.empty((1, 8, 8, 128), device="meta"),
                       torch.empty((1, 8, 8, 64), device="meta"), w)


_LAUNCHER = r"""
// bfloat16: att_gate_kernel, then att_head_kernel, over `blocks` persistent
// blocks each (0: one per M-tile and one per tile), through host tensor maps
static void emu_bf16(const void* const* p, void* out, void* attn, int B, int H, int W,
                     int blocks) {
  typedef const __nv_bfloat16* Bp;
  const long long npix = (long long)B * H * W;
  using TM = sm90::TensorMap;
  const TM xm{p[0], {C4, npix, 1, 1}, {2, 2 * C4, 0, 0}, {64, MT, 1, 1}};
  const TM hm{p[1], {CH, npix, 1, 1}, {2, 2 * CH, 0, 0}, {64, MT, 1, 1}};
  const TM gwm{p[2], {C, CH, 1, 1}, {2, 2 * C, 0, 0}, {16, CH, 1, 1}, 32};
  const TM wgm{p[4], {C, C, 1, 1}, {2, 2 * C, 0, 0}, {16, C, 1, 1}, 32};
  const TM wxm{p[6], {C, C4, 1, 1}, {2, 2 * C, 0, 0}, {16, C4, 1, 1}, 32};
  const TM rcm{p[10], {C4, C4, 1, 1}, {2, 2 * C4, 0, 0}, {16, 32, 1, 1}, 32};
  const TM am{attn, {C4, W, H, B}, {2, 2 * C4, 2LL * C4 * W, 2LL * C4 * W * H}, {64, SW, SH, 1}};
  const TM km{p[12], {NPAD, 9 * C4, 1, 1}, {2, 2 * NPAD, 0, 0}, {NPAD, 64, 1, 1}, 32};
  const Bp gb = (Bp)p[3], bg = (Bp)p[5], bx = (Bp)p[7], wpsi = (Bp)p[8], bpsi = (Bp)p[9],
           brc = (Bp)p[11];
  __nv_bfloat16* at = (__nv_bfloat16*)attn;
  __nv_bfloat16* o = (__nv_bfloat16*)out;
  const int items = int((npix + MT - 1) / MT);
  const int tiles = B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  emu_run({unsigned(blocks ? blocks : items), 1, 1}, GATE_THREADS, [=] {
    att_gate_kernel(xm, hm, gwm, wgm, wxm, rcm, gb, bg, bx, wpsi, bpsi, brc, at, (int)npix);
  });
  emu_run({unsigned(blocks ? blocks : tiles), 1, 1}, HEAD_THREADS, [=] {
    att_head_kernel(am, km, o, B, H, W);
  });
}
// float32: the FMA kernel, a block per 8 x 8 tile
static void emu_f32(const void* const* p, void* out, int B, int H, int W) {
  const float* q[13];
  for (int i = 0; i < 13; ++i) q[i] = static_cast<const float*>(p[i]);
  emu_run({unsigned((W + TILE - 1) / TILE), unsigned((H + TILE - 1) / TILE), unsigned(B)}, NTHREADS,
          [=] {
            att_f32_kernel(q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7], q[8], q[9], q[10],
                           q[11], q[12], static_cast<float*>(out), H, W);
          });
}
extern "C" void emu_launch(const void* const* p, void* out, void* attn, int B, int H, int W,
                           int is_bf16, int blocks) {
  if (is_bf16) emu_bf16(p, out, attn, B, H, W, blocks);
  else emu_f32(p, out, B, H, W);
}
extern "C" size_t emu_smem(int which) {
  return which == 0 ? (size_t)GATE_BYTES : which == 1 ? (size_t)HEAD_BYTES : Smem::bytes;
}
"""

_ORDER = ("gw", "gb", "wg", "bg", "wx", "bx", "wpsi", "bpsi", "rc", "brc", "atk")


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    lib = compile_emulated("att_head_block", _LAUNCHER, tmp_path_factory.mktemp("att_emu"))
    lib.emu_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
    lib.emu_launch.restype = None
    lib.emu_smem.argtypes = [ctypes.c_int]
    lib.emu_smem.restype = ctypes.c_size_t
    return lib


def _emulate(raw, lib, B, H, W, dtype, blocks=0):
    """One emulated call against the plain version: float32 to 1e-5 (the
    same products summed in another order), bfloat16 to 1e-2 (the rounded
    intermediates on either side of a boundary, as chip_smoke.py holds the
    card), of max |plain|."""
    w = {k: v.to(dtype).contiguous() for k, v in build_att_weights(*_as(raw, torch.from_numpy)).items()}
    x, h = (torch.from_numpy(a).to(dtype) for a in _inputs(4, B, H, W))
    out = torch.empty((B, H, W, 12), dtype=dtype)
    attn = torch.empty((B, H, W, 128), dtype=dtype)
    ptrs = (ctypes.c_void_p * 13)(x.data_ptr(), h.data_ptr(), *(w[k].data_ptr() for k in _ORDER))
    lib.emu_launch(ptrs, out.data_ptr(), attn.data_ptr(), B, H, W, int(dtype == torch.bfloat16),
                   blocks)
    want = att_head_block_plain(x, h, w).float()
    tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2}[dtype]
    assert (out.float() - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())


@pytest.mark.parametrize("B,H,W,dtype", [
    (1, 12, 20, torch.float32),    # several float32 tiles (edge 8), ragged edges
    (1, 16, 16, torch.bfloat16),   # 4 M-tiles, one 8 x 32 head tile: the wgmma kernels
    (1, 12, 20, torch.bfloat16),   # ... with a ragged last M-tile and ragged head tiles
])
def test_cuda_source_emulated_matches_plain(raw, emulated, B, H, W, dtype):
    _emulate(raw, emulated, B, H, W, dtype)


@pytest.mark.parametrize("B,H,W,blocks", [
    (2, 17, 15, 1),   # 8 M-tiles on one block: the 6-slot ring wraps; 6 ragged head tiles,
                      # 12 planes through the 3 plane slots
    (2, 23, 21, 2),   # 16 M-tiles (the last of 6 pixels) on 2 blocks, 8 each; 3 head tiles a block
])
def test_cuda_source_emulated_bf16_persistent(raw, emulated, B, H, W, blocks):
    """More items than blocks, so that the input rings wrap (their parities
    over several rounds), on images that no tile divides."""
    _emulate(raw, emulated, B, H, W, torch.bfloat16, blocks)


def test_smem_budget_matches_the_source(emulated):
    """The source note's tally: the gate kernel 171,112 bytes (6 slots of
    24,576 and 22,528 of weights), the head kernel 170,040 (3 planes of
    44,032 and 36,864 of head_at), both under Hopper's 232,448; float32's
    8 x 8 tile too."""
    assert emulated.emu_smem(0) == 171112
    assert emulated.emu_smem(1) == 170040
    assert emulated.emu_smem(2) <= 232448


def test_wrapper_refuses_unaligned_bf16(raw):
    """TMA reads x, h and the weights from 16-byte aligned addresses: a view
    that starts 2 bytes into its storage is refused before any launch."""
    from diffusionremotesensing_tpu_torch.ops import att_block as ab

    w = {k: v.bfloat16() for k, v in build_att_weights(*_as(raw, torch.from_numpy)).items()}
    x, h = (torch.from_numpy(a).bfloat16() for a in _inputs(5, 1, 8, 8))
    ab._check(x, h, w)
    shifted = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)[1:].view(x.shape)
    with pytest.raises(ValueError, match="16-byte"):
        ab._check(shifted, h, w)
