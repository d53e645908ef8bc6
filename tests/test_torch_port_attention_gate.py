"""ops/attention_gate.py of the port (use_pallas): the plain version against
the reference package's Pallas fused_attention_gate (interpret mode, as
tests/test_pallas.py runs it; float32, atol 2e-5: float32 throughout on
both sides, sums in another order) and against the port's layer-by-layer
AttentionGate; the module's use_pallas switch; the wrapper's CPU path and
refusals; and csrc/attention_gate.cu compiled with g++ under the CUDA
emulation of tests/torch_port_helpers.py, held against the plain version.
The card runs the real kernel in chip_smoke.py."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu.ops.pallas_kernels import (
    fused_attention_gate as jax_fused_attention_gate,
)
from diffusionremotesensing_tpu_torch.models.blocks import AttentionGate
from diffusionremotesensing_tpu_torch.ops import attention_gate as ag
from diffusionremotesensing_tpu_torch.ops.attention_gate import (
    WEIGHTS,
    attention_gate_plain,
    build_gate_weights,
    fused_attention_gate,
)
from tests.torch_port_helpers import compile_emulated


def _gate(seed, c):
    """An AttentionGate with random weights and well-conditioned BN statistics."""
    gen = torch.Generator().manual_seed(seed)
    m = AttentionGate(c).eval()
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.15)
        bn = m.result[1]
        bn.weight.add_(1.0)
        bn.running_mean.copy_(torch.randn(c, generator=gen) * 0.1)
        bn.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
    return m


def _inputs(seed, B, H, W, C):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, W, C)).astype(np.float32),
            rng.standard_normal((B, H // 2, W // 2, C)).astype(np.float32))


@pytest.mark.parametrize("shape", [(2, 16, 16, 32), (2, 8, 8, 128)])
def test_plain_matches_reference_kernel(shape):
    B, H, W, C = shape
    m = _gate(0, C)
    x, g = _inputs(1, B, H, W, C)
    hwio = lambda conv: jnp.asarray(conv.weight.detach().permute(2, 3, 1, 0).numpy())  # noqa: E731
    vec = lambda p: jnp.asarray(p.detach().numpy())  # noqa: E731
    bn = m.result[1]
    want = jax_fused_attention_gate(
        jnp.asarray(x), jnp.asarray(g), hwio(m.w_g[0]), vec(m.w_g[0].bias), hwio(m.w_x[0]),
        vec(m.w_x[0].bias), hwio(m.psi[0]), vec(m.psi[0].bias), hwio(m.result[0]),
        vec(m.result[0].bias), vec(bn.weight), vec(bn.bias), vec(bn.running_mean),
        vec(bn.running_var), interpret=True)
    got = attention_gate_plain(torch.from_numpy(x), torch.from_numpy(g), build_gate_weights(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)])
def test_plain_matches_the_layer_by_layer_gate(dtype, tol):
    """The same function as AttentionGate's unfused forward. float32: sums
    in another order; bfloat16: the unfused gate rounds each of its five
    conv outputs to bf16 (the fused one only its output), up to ~5 ulps
    (2**-8 relative each) of the output's scale."""
    m = _gate(2, 64).to(dtype)
    x, g = (torch.from_numpy(a).to(dtype) for a in _inputs(3, 2, 12, 16, 64))
    with torch.no_grad():
        want = m(x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).float()
    got = attention_gate_plain(x, g, build_gate_weights(m))
    assert got.dtype == dtype
    assert (got.float() - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())


def test_use_pallas_switches_the_module_to_the_fused_gate():
    m = _gate(4, 32)
    fused = AttentionGate(32, use_pallas=True).eval()
    fused.load_state_dict(m.state_dict())
    x, g = (torch.from_numpy(a) for a in _inputs(5, 1, 8, 12, 32))
    xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    with torch.no_grad():
        got = fused(xc, gc)
        np.testing.assert_allclose(got.numpy(), m(xc, gc).numpy(), atol=1e-5)
    assert torch.equal(got.permute(0, 2, 3, 1), attention_gate_plain(x, g, build_gate_weights(m)))


def test_wrapper_cpu_path_is_the_plain_version_and_not_counted():
    w = build_gate_weights(_gate(6, 32))
    x, g = (torch.from_numpy(a) for a in _inputs(7, 1, 8, 8, 32))
    before = fused_attention_gate.launches
    assert torch.equal(fused_attention_gate(x, g, w), attention_gate_plain(x, g, w))
    assert fused_attention_gate.launches == before


def test_wrapper_refuses():
    w = build_gate_weights(_gate(8, 64))
    x, g = (torch.from_numpy(a) for a in _inputs(9, 1, 8, 8, 64))
    with pytest.raises(TypeError):
        ag._check(x.half(), g.half(), w)
    with pytest.raises(ValueError, match="contiguous"):  # an NCHW tensor's NHWC view
        ag._check(x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), g, w)
    with pytest.raises(ValueError, match="even"):
        ag._check(x[:, :7], g, w)
    with pytest.raises(ValueError, match="C in"):
        ag._check(x[..., :48], g[..., :48], w)
    with pytest.raises(ValueError, match="float32"):  # the weights stay float32 in bf16
        ag._check(x.bfloat16(), g.bfloat16(), {k: v.bfloat16() for k, v in w.items()})
    with pytest.raises(ValueError, match="expected"):  # CPU weights beside an input elsewhere
        ag._check(x.to("meta"), g.to("meta"), w)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_attention_gate(x.to("meta"), g.to("meta"), w)


_LAUNCHER = r"""
// bfloat16: gate_tc_kernel<C> over `blocks` persistent blocks (0: one per
// item of 4 x 16 gating pixels), through host tensor maps
template <int C>
static void emu_tc(const void* x, const void* g, const GateWeights& w, const void* wt, void* out,
                   int B, int Hg, int Wg, int blocks) {
  using G = Gt<C>;
  using TM = sm90::TensorMap;
  const long long c = C, hg = Hg, wg = Wg;
  const TM xm{x, {2 * c, wg, 2 * hg, B}, {2, 4 * c, 4 * c * wg, 8 * c * wg * hg}, {64, GT_TW, 2 * GT_TH, 1}};
  const TM om{out, {2 * c, wg, 2 * hg, B}, {2, 4 * c, 4 * c * wg, 8 * c * wg * hg}, {64, GT_TW, 2 * GT_TH, 1}};
  const TM gm{g, {c, wg, hg, B}, {2, 2 * c, 2 * c * wg, 2 * c * wg * hg},
              {C == 32 ? 16 : 64, GT_TW, GT_TH, 1}, C == 32 ? 32 : 128};
  const TM wm{wt, {c, 6 * c, 2, 1}, {2, 2 * c, 12 * c * c, 0},
              {G::ATOM, G::RESIDENT ? G::RROWS : 16, 2, 1}, G::SW128 ? 128 : 32};
  const int items = B * ((Hg + GT_TH - 1) / GT_TH) * ((Wg + GT_TW - 1) / GT_TW);
  emu_run({unsigned(blocks ? blocks : items), 1u, 1u}, GT_THREADS, [=] {
    gate_tc_kernel<C>(xm, gm, wm, om, w, B, Hg, Wg);
  });
}
// float32: the FMA kernel, P gating pixels a block
template <int C>
static void emu_f32(const void* x, const void* g, const GateWeights& w, void* out, int B, int Hg,
                    int Wg) {
  const int N = B * Hg * Wg;
  emu_run({unsigned((N + P - 1) / P), 1u, 1u}, NTHREADS, [=] {
    attention_gate_f32_kernel<C>((const float*)x, (const float*)g, w, (float*)out, N, Hg, Wg);
  });
}
template <int C>
static void emu_c(const void* x, const void* g, const GateWeights& w, const void* wt, void* out,
                  int B, int Hg, int Wg, int is_bf16, int blocks) {
  if (is_bf16) emu_tc<C>(x, g, w, wt, out, B, Hg, Wg, blocks);
  else emu_f32<C>(x, g, w, out, B, Hg, Wg);
}
extern "C" void emu_launch(const void* x, const void* g, const void* const* wp, void* out, int B,
                           int Hg, int Wg, int C, int is_bf16, int blocks) {
  const float* f[12];
  for (int i = 0; i < 12; ++i) f[i] = (const float*)wp[i];
  const GateWeights w = {f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9], f[10], f[11]};
  if (C == 32) emu_c<32>(x, g, w, wp[12], out, B, Hg, Wg, is_bf16, blocks);
  else if (C == 64) emu_c<64>(x, g, w, wp[12], out, B, Hg, Wg, is_bf16, blocks);
  else emu_c<128>(x, g, w, wp[12], out, B, Hg, Wg, is_bf16, blocks);
}
extern "C" size_t emu_smem(int C) {
  return C == 32 ? Gt<32>::BYTES : C == 64 ? Gt<64>::BYTES : Gt<128>::BYTES;
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    lib = compile_emulated("attention_gate", _LAUNCHER, tmp_path_factory.mktemp("gate_emu"))
    lib.emu_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
    lib.emu_launch.restype = None
    lib.emu_smem.argtypes = [ctypes.c_int]
    lib.emu_smem.restype = ctypes.c_size_t
    return lib


def _run(lib, x, g, w, blocks=0):
    """One emulated call: out like x."""
    B, H, W, C = x.shape
    out = torch.empty_like(x)
    ptrs = (ctypes.c_void_p * 13)(*(w[k].data_ptr() for k in WEIGHTS), w["wt"].data_ptr())
    lib.emu_launch(x.data_ptr(), g.data_ptr(), ptrs, out.data_ptr(), B, H // 2, W // 2, C,
                   int(x.dtype == torch.bfloat16), blocks)
    return out


def _emulate(lib, B, H, W, C, dtype, blocks=0):
    """The emulated kernel against the plain version: float32 to 1e-5 (the
    same products summed in another order), bfloat16 to 1e-2 (the output
    rounded to bf16 on either side of a boundary; float32 inside, the
    weights as hi + lo), of max |plain|."""
    w = build_gate_weights(_gate(10, C))
    x, g = (torch.from_numpy(a).to(dtype) for a in _inputs(11, B, H, W, C))
    out = _run(lib, x, g, w, blocks)
    want = attention_gate_plain(x, g, w).float()
    tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2}[dtype]
    assert (out.float() - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())


@pytest.mark.parametrize("B,H,W,C,dtype", [
    (1, 16, 16, 32, torch.float32),    # gate 2's width, two blocks
    (1, 10, 14, 64, torch.float32),    # gate 1's width, a ragged last block (35 pixels)
    (2, 8, 6, 128, torch.float32),     # gate 0's width, 24 pixels: one partial block
    (1, 10, 14, 64, torch.bfloat16),   # bf16 in and out, float32 inside: one ragged 5 x 7 item
])
def test_cuda_source_emulated_matches_plain(emulated, B, H, W, C, dtype):
    _emulate(emulated, B, H, W, C, dtype)


@pytest.mark.parametrize("B,H,W,C,blocks", [
    (1, 16, 16, 32, 0),    # B=1, gate 2's width: one 4 x 16 item, the C = 32 layouts
    (2, 20, 36, 32, 1),    # 6 ragged items on one block: the 4 input slots wrap
    (2, 12, 40, 64, 2),    # 8 ragged items (Hg 6, Wg 20) on 2 blocks: the 3 slots wrap
    (1, 8, 32, 128, 0),    # B=1, gate 0's width: one item, its 48 weight pieces streamed
    (2, 10, 36, 128, 1),   # 6 ragged items on one block: 288 pieces through the 8-slot ring
])
def test_cuda_source_emulated_bf16_persistent(emulated, B, H, W, C, blocks):
    """The tensor-core kernel at each width: more items than blocks, so that
    the input and weight rings wrap (their parities over several rounds), on
    gating grids that no 4 x 16 item divides."""
    _emulate(emulated, B, H, W, C, torch.bfloat16, blocks)


@pytest.mark.parametrize("c", [32, 64, 128])
def test_cuda_source_emulated_keeps_float32_weights(emulated, c):
    """A case that rounding the float32 weights to bf16 would get wrong: x
    all ones, every entry of Wr w = 1 + 3 * 2**-10 (bf16 holds 1), br =
    -C * bf16(w), psi = 1 (wpsi = 0, bpsi = 30) and an identity BN, so that
    r = C * (w - bf16(w)) = 3C * 2**-10 (0.09375 at C = 32) where bf16
    weights give 0. The kernel's hi + lo weights must land within 1e-2."""
    w = build_gate_weights(_gate(12, c))
    wv = 1.0 + 3 * 2.0 ** -10
    w["wr"] = torch.full((c, c), wv)
    w["br"] = torch.full((c,), -c * float(torch.tensor(wv).bfloat16()))
    w["wpsi"].zero_()
    w["bpsi"].fill_(30.0)
    w["scale"].fill_(1.0)
    w["bias"].zero_()
    w["mean"].zero_()
    w["var"].fill_(1.0 - 1e-5)
    cat = torch.cat([w["wg"], w["wx"], w["wr"]])
    hi = cat.bfloat16()
    w["wt"] = torch.stack([hi, (cat - hi.float()).bfloat16()]).contiguous()
    x = torch.ones((1, 8, 32, c), dtype=torch.bfloat16)
    g = torch.from_numpy(_inputs(13, 1, 8, 32, c)[1]).bfloat16()
    want = attention_gate_plain(x, g, w).float()
    assert torch.allclose(want, torch.full_like(want, 3 * c * 2.0 ** -10), atol=1e-3)
    out = _run(emulated, x, g, w).float()
    assert (out - want).abs().max().item() <= 1e-2


def test_build_gate_weights_hi_plus_lo_is_the_float32_weight():
    """wt's two bf16 parts add up to each float32 weight of [wg; wx; wr]
    within 2**-16 of its size (the split leaves at most ~2**-18)."""
    w = build_gate_weights(_gate(14, 64))
    cat = torch.cat([w["wg"], w["wx"], w["wr"]])
    assert w["wt"].dtype == torch.bfloat16 and tuple(w["wt"].shape) == (2, 6 * 64, 64)
    err = (w["wt"][0].float() + w["wt"][1].float() - cat).abs()
    assert (err <= 2.0 ** -16 * cat.abs()).all()
    assert torch.equal(w["wt"][0], cat.bfloat16())


def test_smem_budget_matches_the_source(emulated):
    """The source note's tally at each width, all under Hopper's 232,448."""
    assert [emulated.emu_smem(c) for c in (32, 64, 128)] == [108656, 223320, 231608]
    assert max(emulated.emu_smem(c) for c in (32, 64, 128)) <= 232448


def test_wrapper_refuses_bf16_without_hi_lo_or_unaligned():
    w = build_gate_weights(_gate(15, 32))
    x, g = (torch.from_numpy(a).bfloat16() for a in _inputs(16, 1, 8, 8, 32))
    ag._check(x, g, w)
    with pytest.raises(ValueError, match="wt"):
        ag._check(x, g, {k: v for k, v in w.items() if k != "wt"})
    shifted = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)[1:].view(x.shape)
    with pytest.raises(ValueError, match="16-byte"):
        ag._check(shifted, g, w)
