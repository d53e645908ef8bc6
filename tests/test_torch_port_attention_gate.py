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
template <typename T, int C>
static void emu_gate(const void* x, const void* g, const GateWeights& w, void* out, int B, int Hg,
                     int Wg) {
  const int N = B * Hg * Wg;
  emu_run({unsigned((N + P - 1) / P), 1u, 1u}, NTHREADS, [=] {
    attention_gate_kernel<T, C>((const T*)x, (const T*)g, w, (T*)out, N, Hg, Wg);
  });
}
template <typename T>
static void emu_c(const void* x, const void* g, const GateWeights& w, void* out, int B, int Hg,
                  int Wg, int C) {
  if (C == 32) emu_gate<T, 32>(x, g, w, out, B, Hg, Wg);
  else if (C == 64) emu_gate<T, 64>(x, g, w, out, B, Hg, Wg);
  else emu_gate<T, 128>(x, g, w, out, B, Hg, Wg);
}
extern "C" void emu_launch(const void* x, const void* g, const void* const* wp, void* out, int B,
                           int Hg, int Wg, int C, int is_bf16) {
  const float* f[12];
  for (int i = 0; i < 12; ++i) f[i] = (const float*)wp[i];
  const GateWeights w = {f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9], f[10], f[11]};
  if (is_bf16) emu_c<__nv_bfloat16>(x, g, w, out, B, Hg, Wg, C);
  else emu_c<float>(x, g, w, out, B, Hg, Wg, C);
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    lib = compile_emulated("attention_gate", _LAUNCHER, tmp_path_factory.mktemp("gate_emu"))
    lib.emu_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
    return lib


@pytest.mark.parametrize("B,H,W,C,dtype", [
    (1, 16, 16, 32, torch.float32),    # gate 2's width, two blocks
    (1, 10, 14, 64, torch.float32),    # gate 1's width, a ragged last block (35 pixels)
    (2, 8, 6, 128, torch.float32),     # gate 0's width, 24 pixels: one partial block
    (1, 10, 14, 64, torch.bfloat16),   # bf16 in and out, float32 inside
])
def test_cuda_source_emulated_matches_plain(emulated, B, H, W, C, dtype):
    w = build_gate_weights(_gate(10, C))
    x, g = (torch.from_numpy(a).to(dtype) for a in _inputs(11, B, H, W, C))
    out = torch.empty_like(x)
    ptrs = (ctypes.c_void_p * 12)(*(w[k].data_ptr() for k in WEIGHTS))
    emulated.emu_launch(x.data_ptr(), g.data_ptr(), ptrs, out.data_ptr(), B, H // 2, W // 2, C,
                        int(dtype == torch.bfloat16))
    want = attention_gate_plain(x, g, w).float()
    # float32: the same products summed in another order; bfloat16: the
    # output rounded to bf16 on either side of a boundary
    tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2}[dtype]
    assert (out.float() - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())
