"""ops/fused_update.py of the port: the step coefficients, the bits -> normal
map and the update against the reference package's Pallas ancestral_update
(interpret mode, with given bits, as tests/test_fused_update.py runs it;
float32, atol 2e-5), the plain Philox4x32-10 against a numpy uint64
reference and the generator's published known-answer vectors, the
wrapper's CPU path and checks, the fused_update + ddim_steps refusal, and
csrc/ancestral_update.cu compiled with g++ under the CUDA emulation of
tests/torch_port_helpers.py, held against the plain version. The card runs
the real kernel in chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionremotesensing_tpu.ops.fused_update import (
    _bits_to_normal as jax_bits_to_normal,
    ancestral_update as jax_ancestral_update,
    update_coefs as jax_update_coefs,
)
from diffusionremotesensing_tpu.schedules import make_schedule as jax_make_schedule
from diffusionremotesensing_tpu_torch.aggregation import AggregationSampler
from diffusionremotesensing_tpu_torch.ops.fused_update import (
    ancestral_update,
    ancestral_update_plain,
    bits_to_normal,
    philox4x32_10,
    philox_bits,
    philox_bits_plain,
    update_coefs,
)
from diffusionremotesensing_tpu_torch.schedules import make_schedule
from tests.torch_port_helpers import compile_emulated

M32 = np.uint64(0xFFFFFFFF)


def _state(seed, shape=(3, 8, 8, 12)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _bits(seed, shape=(3, 8, 8, 12)):
    return np.random.default_rng(seed).integers(0, 2**32, (2, *shape), dtype=np.uint32)


def _t_bits(bits):
    return torch.from_numpy(bits.view(np.int32))


def _np_philox(ctr, key):
    """Philox4x32-10 in numpy uint64: counter (4, n), key (2,)."""
    c = [np.asarray(v, np.uint64) for v in ctr]
    k0, k1 = np.uint64(key[0]), np.uint64(key[1])
    for r in range(10):
        if r:
            k0, k1 = (k0 + np.uint64(0x9E3779B9)) & M32, (k1 + np.uint64(0xBB67AE85)) & M32
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & M32, (p0 >> np.uint64(32)) ^ c[3] ^ k1,
             p0 & M32]
    return c


@pytest.mark.parametrize("i", [1, 2, 750, 1499])
def test_update_coefs_match_reference(i):
    want = np.asarray(jax_update_coefs(jax_make_schedule("cosine", 1500), jnp.int32(i)))
    got = update_coefs(make_schedule("cosine", 1500), i)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (got[2] == 0.0) == (i == 1)


def test_bits_to_normal_matches_reference():
    bits = _bits(0, (4096,))
    bits[:, :3] = [[0, 0xFFFFFFFF, 511], [0, 0xFFFFFFFF, 1 << 31]]  # the ends of the range
    want = np.asarray(jax_bits_to_normal(jnp.asarray(bits[0]), jnp.asarray(bits[1])))
    got = bits_to_normal(torch.from_numpy(bits[0].astype(np.int64)),
                         torch.from_numpy(bits[1].astype(np.int64)))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)


@pytest.mark.parametrize("i", [99, 2, 1])
def test_plain_matches_reference_kernel(i):
    x, eps = _state(1)
    bits = _bits(2)
    sch = jax_make_schedule("cosine", 100)
    want = jax_ancestral_update(jnp.asarray(x), jnp.asarray(eps), jax_update_coefs(sch, jnp.int32(i)),
                                jnp.zeros(2, jnp.uint32), bits=jnp.asarray(bits), interpret=True)
    got = ancestral_update_plain(torch.from_numpy(x), torch.from_numpy(eps),
                                 update_coefs(make_schedule("cosine", 100), i), None, i,
                                 bits=_t_bits(bits))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_plain_keeps_x_dtype_like_reference():
    """bf16 x: float32 math, output rounded to bf16 (one ulp apart at most)."""
    x, eps = _state(3, (2, 4, 4, 12))
    bits = _bits(4, (2, 4, 4, 12))
    sch = jax_make_schedule("cosine", 100)
    want = jax_ancestral_update(jnp.asarray(x, jnp.bfloat16), jnp.asarray(eps),
                                jax_update_coefs(sch, jnp.int32(50)), jnp.zeros(2, jnp.uint32),
                                bits=jnp.asarray(bits), interpret=True)
    got = ancestral_update_plain(torch.from_numpy(x).bfloat16(), torch.from_numpy(eps),
                                 update_coefs(make_schedule("cosine", 100), 50), None, 50,
                                 bits=_t_bits(bits))
    assert got.dtype == torch.bfloat16
    want32 = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want32, atol=1e-2 * max(1.0, np.abs(want32).max()))


def test_plain_philox_matches_numpy_and_known_answers():
    # Random123's known-answer vectors for Philox4x32-10
    kat = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
           ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
           ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in kat:
        got = philox4x32_10(*(torch.tensor([v], dtype=torch.int64) for v in ctr), *key)
        assert [int(v) for v in got] == list(want)
        assert [int(v[0]) for v in _np_philox([[v] for v in ctr], key)] == list(want)
    rng = np.random.default_rng(5)
    ctr = rng.integers(0, 2**32, (4, 1000), dtype=np.uint64)
    key = [int(v) for v in rng.integers(0, 2**32, 2, dtype=np.uint64)]
    got = philox4x32_10(*(torch.from_numpy(c.astype(np.int64)) for c in ctr), *key)
    for g, w in zip(got, _np_philox(ctr, key)):
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))


def test_philox_bits_layout():
    """Element 2p takes words 0 and 1 of pair p's call, element 2p + 1
    words 2 and 3; counter (p low, p high, step, 0); an odd count drops the
    last pair's second element."""
    seed = torch.tensor([0x12345678, 0x9ABCDEF0], dtype=torch.int64)
    n, step = 11, 7
    got = philox_bits(seed, step, n).numpy()
    p = np.arange(6, dtype=np.uint64)
    r = _np_philox([p, np.zeros(6, np.uint64), np.full(6, step, np.uint64), np.zeros(6, np.uint64)],
                   [0x12345678, 0x9ABCDEF0])
    np.testing.assert_array_equal(got[0], np.stack([r[0], r[2]], 1).reshape(-1)[:n].astype(np.int64))
    np.testing.assert_array_equal(got[1], np.stack([r[1], r[3]], 1).reshape(-1)[:n].astype(np.int64))


def test_generated_noise_is_standard_normal():
    seed = torch.tensor([11, 22], dtype=torch.int64)
    x = torch.zeros((4, 32, 32, 12))
    z = ancestral_update_plain(x, x, (0.0, 0.0, 1.0), seed, 5).double()
    # 49152 draws: the standard errors of mean and std are 0.0045 and 0.0032
    assert abs(z.mean().item()) < 0.02 and abs(z.std().item() - 1.0) < 0.015
    z2 = ancestral_update_plain(x, x, (0.0, 0.0, 1.0), seed, 6).double()
    assert abs(torch.corrcoef(torch.stack([z.reshape(-1), z2.reshape(-1)]))[0, 1].item()) < 0.02


def test_wrapper_cpu_path_is_the_plain_version_and_not_counted():
    x, eps = (torch.from_numpy(a) for a in _state(6))
    seed = torch.tensor([1, 2], dtype=torch.int64)
    coefs = update_coefs(make_schedule("cosine", 100), 40)
    before = ancestral_update.launches
    assert torch.equal(ancestral_update(x, eps, coefs, seed, 40),
                       ancestral_update_plain(x, eps, coefs, seed, 40))
    assert ancestral_update.launches == before


def test_wrapper_refuses_other_devices():
    x = torch.empty((1, 8, 8, 12), device="meta")
    with pytest.raises(ValueError):
        ancestral_update(x, x, (1.0, 0.0, 0.0), torch.empty(2, dtype=torch.int64, device="meta"), 1)


def test_fused_update_with_ddim_is_refused():
    with pytest.raises(ValueError, match="fused_update"):
        AggregationSampler(None, patch_size=8, stride=4, magnification_factor=2, ddim_steps=10,
                           fused_update=True)


_LAUNCHER = r"""
extern "C" void emu_update(const void* x, const void* eps, const void* bits, const void* seed,
                           void* out, long long n, float ca, float cb, float cn, unsigned step,
                           int is_bf16) {
  const dim3 g = {grid_for(n), 1, 1};
  typedef __nv_bfloat16 H;
  if (is_bf16)
    emu_run(g, NTHREADS, [=] { ancestral_update_kernel<H>((const H*)x, (const H*)eps,
        (const uint32_t*)bits, (const long long*)seed, (H*)out, n, ca, cb, cn, step); });
  else
    emu_run(g, NTHREADS, [=] { ancestral_update_kernel<float>((const float*)x, (const float*)eps,
        (const uint32_t*)bits, (const long long*)seed, (float*)out, n, ca, cb, cn, step); });
}
extern "C" void emu_bits(const void* seed, void* out, long long n, unsigned step) {
  emu_run({grid_for(n), 1, 1}, NTHREADS,
          [=] { philox_bits_kernel((const long long*)seed, (uint32_t*)out, n, step); });
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    import ctypes

    lib = compile_emulated("ancestral_update", _LAUNCHER, tmp_path_factory.mktemp("update_emu"))
    lib.emu_update.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_float] * 3
                               + [ctypes.c_uint, ctypes.c_int])
    lib.emu_bits.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint]
    return lib


@pytest.mark.parametrize("shape,dtype,mode", [
    ((3, 8, 8, 12), torch.float32, "philox"),
    ((1, 5, 3, 3), torch.float32, "philox"),    # odd element count
    ((3, 8, 8, 12), torch.float32, "bits"),
    ((2, 4, 4, 12), torch.bfloat16, "philox"),
])
def test_cuda_source_emulated_matches_plain(emulated, shape, dtype, mode):
    x, eps = (torch.from_numpy(a).to(dtype) for a in _state(7, shape))
    seed = torch.tensor([0xDEADBEEF, 0x01234567], dtype=torch.int64)
    bits = _t_bits(_bits(8, shape)) if mode == "bits" else None
    coefs = update_coefs(make_schedule("cosine", 1500), 321)
    out = torch.empty_like(x)
    n = x.numel()
    emulated.emu_update(x.data_ptr(), eps.data_ptr(), None if bits is None else bits.data_ptr(),
                        seed.data_ptr(), out.data_ptr(), n, *coefs, 321,
                        int(dtype == torch.bfloat16))
    want = ancestral_update_plain(x, eps, coefs, seed, 321, bits).float()
    # float32: libm's log/cos/sqrt against torch's, an ulp or two apart;
    # bfloat16: the output rounded to bf16 on either side of a boundary
    tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2}[dtype]
    assert (out.float() - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())
    if mode == "philox":
        words = torch.empty((2, n), dtype=torch.int32)
        emulated.emu_bits(seed.data_ptr(), words.data_ptr(), n, 321)
        assert torch.equal(words.to(torch.int64) & 0xFFFFFFFF, philox_bits_plain(seed, 321, n))


def test_cuda_source_emulated_last_step_is_exact(emulated):
    """cn = 0 at i == 1: the kernel's unfused roundings give ca*x - cb*eps exactly."""
    x, eps = (torch.from_numpy(a) for a in _state(9))
    ca, cb, cn = update_coefs(make_schedule("cosine", 1500), 1)
    out = torch.empty_like(x)
    seed = torch.tensor([3, 4], dtype=torch.int64)
    emulated.emu_update(x.data_ptr(), eps.data_ptr(), None, seed.data_ptr(), out.data_ptr(),
                        x.numel(), ca, cb, cn, 1, 0)
    assert torch.equal(out, ca * x - cb * eps)
