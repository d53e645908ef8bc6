"""ops/fused_update.py of the port: the step coefficients, the bits -> normal
map and the update against the reference package's Pallas ancestral_update
(interpret mode, with given bits, as tests/test_fused_update.py runs it;
float32, atol 2e-5), the plain Philox4x32-10 against a numpy uint64
reference and the generator's published known-answer vectors, the
generator's quad layout and its Box-Muller pairs against numpy, the
moments and correlations of its noise, the wrapper's CPU path and checks,
the fused_update + ddim_steps refusal, and csrc/ancestral_update.cu
compiled with g++ under the CUDA emulation of tests/torch_port_helpers.py,
held against the plain version (wide and scalar accesses, every n % 4, a
base pointer off a quad's bytes, the grid-stride loop) and in bits mode
against the reference kernel. The card runs the real kernel in
chip_smoke.py."""

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
    philox_normal_plain,
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
    """Row q holds the four words of quad q, elements 4q .. 4q + 3, from
    counter (q low, q high, step, 0); a count that is not a multiple of 4
    still gets its last quad whole."""
    seed = torch.tensor([0x12345678, 0x9ABCDEF0], dtype=torch.int64)
    n, step = 11, 7
    got = philox_bits(seed, step, n).numpy()
    q = np.arange(3, dtype=np.uint64)
    r = _np_philox([q, np.zeros(3, np.uint64), np.full(3, step, np.uint64), np.zeros(3, np.uint64)],
                   [0x12345678, 0x9ABCDEF0])
    np.testing.assert_array_equal(got, np.stack(r, 1).astype(np.int64))


def _np_box_muller(b1, b2):
    """float64 (r cos, r sin) of uint64 word pairs by the reference's map."""
    f1 = (np.uint32(0x3F800000) | (b1.astype(np.uint32) >> 9)).view(np.float32).astype(np.float64)
    f2 = (np.uint32(0x3F800000) | (b2.astype(np.uint32) >> 9)).view(np.float32).astype(np.float64)
    r, theta = np.sqrt(-2.0 * np.log(2.0 - f1)), 2.0 * np.pi * (f2 - 1.0)
    return r * np.cos(theta), r * np.sin(theta)


@pytest.mark.parametrize("n", [4096, 4095, 4094, 4093])
def test_plain_noise_is_box_muller_pairs_of_the_quad_words(n):
    """z[4q], z[4q + 1] are (w0, w1)'s cos and sin outputs, z[4q + 2],
    z[4q + 3] (w2, w3)'s, against numpy Philox and float64 Box-Muller
    (atol 1e-5: float32 log/cos/sin at |z| < 5.7); the even elements are
    the bits mode's cosine map of the same word pairs."""
    seed = torch.tensor([0xCAFEF00D, 0x0BADBEEF], dtype=torch.int64)
    q = np.arange((n + 3) // 4, dtype=np.uint64)
    w = _np_philox([q, np.zeros_like(q), np.full_like(q, 9), np.zeros_like(q)],
                   [0xCAFEF00D, 0x0BADBEEF])
    c01, s01 = _np_box_muller(w[0], w[1])
    c23, s23 = _np_box_muller(w[2], w[3])
    want = np.stack([c01, s01, c23, s23], 1).reshape(-1)[:n]
    got = philox_normal_plain(seed, 9, n)
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    b = philox_bits_plain(seed, 9, n)
    np.testing.assert_array_equal(got[0::2].numpy(), bits_to_normal(
        b[:, 0::2].reshape(-1), b[:, 1::2].reshape(-1))[: (n + 1) // 2].numpy())


def _corr(a, b):
    return abs(torch.corrcoef(torch.stack([a, b]))[0, 1].item())


def test_generated_noise_is_standard_normal():
    """196,608 draws (49,152 quads): the standard errors of mean and std are
    0.0023 and 0.0016; each correlation below is over 49,152 pairs or more,
    where |r| < 0.02 is 4.4 standard errors."""
    seed = torch.tensor([11, 22], dtype=torch.int64)
    x = torch.zeros((4, 64, 64, 12))
    z = ancestral_update_plain(x, x, (0.0, 0.0, 1.0), seed, 5).double().reshape(-1)
    assert abs(z.mean().item()) < 0.02 and abs(z.std().item() - 1.0) < 0.015
    quads = z.reshape(-1, 4)
    # the cos and sin partners of one word pair
    cos, sin = torch.cat([quads[:, 0], quads[:, 2]]), torch.cat([quads[:, 1], quads[:, 3]])
    assert _corr(cos, sin) < 0.02
    # the two word pairs of one quad, and the same lane of neighbouring quads
    assert _corr(quads[:, 0], quads[:, 2]) < 0.02
    for lane in range(4):
        assert _corr(quads[:-1, lane], quads[1:, lane]) < 0.02
    # the squared partners too: a shared radius would correlate them
    assert _corr(quads[:, 0] ** 2, quads[:, 1] ** 2) < 0.02
    z2 = ancestral_update_plain(x, x, (0.0, 0.0, 1.0), seed, 6).double().reshape(-1)
    assert _corr(z, z2) < 0.02


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
#define EMU_RUN(T, V) emu_run(g, NTHREADS, [=] { ancestral_update_kernel<T, V>((const T*)x, \
    (const T*)eps, (const uint32_t*)bits, (const long long*)seed, (T*)out, n, ca, cb, cn, step, \
    quad0); })
extern "C" int emu_update(const void* x, const void* eps, const void* bits, const void* seed,
                          void* out, long long n, float ca, float cb, float cn, unsigned step,
                          int is_bf16, unsigned blocks, long long quad0) {
  const dim3 g = {blocks, 1, 1};
  typedef __nv_bfloat16 H;
  const bool vec = quads_aligned(x, eps, out, is_bf16);
  if (is_bf16) {
    if (vec) EMU_RUN(H, true); else EMU_RUN(H, false);
  } else {
    if (vec) EMU_RUN(float, true); else EMU_RUN(float, false);
  }
  return vec;
}
extern "C" void emu_bits(const void* seed, void* out, long long n, unsigned step) {
  const unsigned blocks = (unsigned)(((n + 3) / 4 + NTHREADS - 1) / NTHREADS);
  emu_run({blocks, 1, 1}, NTHREADS,
          [=] { philox_bits_kernel((const long long*)seed, (uint32_t*)out, (n + 3) / 4, step, 0); });
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    import ctypes

    lib = compile_emulated("ancestral_update", _LAUNCHER, tmp_path_factory.mktemp("update_emu"))
    lib.emu_update.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_float] * 3
                               + [ctypes.c_uint, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong])
    lib.emu_update.restype = ctypes.c_int
    lib.emu_bits.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint]
    return lib


def _blocks(n, most=2):
    """Blocks for n elements: a quad a thread, at most `most` blocks, so that
    past 256 * most quads the grid-stride loop takes more than one turn."""
    return min(most, -(-n // 1024))


def _emu_update(lib, x, eps, coefs, seed, step, bits=None, out=None, blocks=None, quad0=0):
    """Run the emulated kernel into `out` (default a new tensor like x);
    returns (out, whether the wide accesses were taken)."""
    out = torch.empty_like(x) if out is None else out
    vec = lib.emu_update(x.data_ptr(), eps.data_ptr(), None if bits is None else bits.data_ptr(),
                         seed.data_ptr(), out.data_ptr(), x.numel(), *coefs, step,
                         int(x.dtype == torch.bfloat16), blocks or _blocks(x.numel()), quad0)
    return out, bool(vec)


# float32: libm's log/sqrt and a double sincospi against torch's float32
# log/cos/sin of 2 pi u2, an ulp or two apart; bfloat16: the output rounded
# to bf16 on either side of a boundary
EMU_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _assert_close(out, want, dtype):
    want = want.float()
    scale = max(1.0, want.abs().max().item())
    assert (out.float() - want).abs().max().item() <= EMU_TOL[dtype] * scale


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
    n = x.numel()
    out, _ = _emu_update(emulated, x, eps, coefs, seed, 321, bits)
    _assert_close(out, ancestral_update_plain(x, eps, coefs, seed, 321, bits), dtype)
    if mode == "philox":
        words = torch.empty(((n + 3) // 4, 4), dtype=torch.int32)
        emulated.emu_bits(seed.data_ptr(), words.data_ptr(), n, 321)
        assert torch.equal(words.to(torch.int64) & 0xFFFFFFFF, philox_bits_plain(seed, 321, n))


@pytest.mark.parametrize("rest", [0, 1, 2, 3])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_source_emulated_tails_and_offsets(emulated, dtype, offset, rest):
    """n = 1028 + rest elements (257 or 258 quads on one block of 256
    threads: the grid-stride loop's second turn), from a base pointer on a
    quad's bytes (wide accesses, then the scalar tail of n % 4) or one
    element off it (every quad scalar); the same noise either way."""
    n = 1028 + rest
    xb, eb = (torch.from_numpy(a).to(dtype) for a in _state(10 + rest, (n + 1,)))
    ob = torch.empty_like(xb)
    x, eps, out = xb[offset:offset + n], eb[offset:offset + n], ob[offset:offset + n]
    seed = torch.tensor([0x600DF00D, 0x7], dtype=torch.int64)
    coefs = update_coefs(make_schedule("cosine", 1500), 1200)
    _, vec = _emu_update(emulated, x, eps, coefs, seed, 1200, out=out, blocks=1)
    assert vec == (offset == 0)
    _assert_close(out, ancestral_update_plain(x, eps, coefs, seed, 1200), dtype)


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset1"])
def test_cuda_source_emulated_bits_mode_matches_reference_kernel(emulated, offset):
    """Given bits, the kernel is the reference's _update_kernel_bits
    (interpret mode): element e takes (b1[e], b2[e]), cosine only; atol
    2e-5 as the plain version's test."""
    shape = (3, 8, 8, 12)
    x, eps = _state(15, shape)
    bits = _bits(16, shape)
    want = jax_ancestral_update(jnp.asarray(x), jnp.asarray(eps),
                                jax_update_coefs(jax_make_schedule("cosine", 100), jnp.int32(60)),
                                jnp.zeros(2, jnp.uint32), bits=jnp.asarray(bits), interpret=True)
    n = x.size
    xb, eb = torch.zeros(n + 1), torch.zeros(n + 1)
    xb[offset:offset + n] = torch.from_numpy(x).reshape(-1)
    eb[offset:offset + n] = torch.from_numpy(eps).reshape(-1)
    out = torch.empty(n + 1)[offset:offset + n]
    _, vec = _emu_update(emulated, xb[offset:offset + n], eb[offset:offset + n],
                         update_coefs(make_schedule("cosine", 100), 60),
                         torch.zeros(2, dtype=torch.int64), 60, _t_bits(bits), out=out)
    assert vec == (offset == 0)
    np.testing.assert_allclose(out.reshape(shape).numpy(), np.asarray(want), atol=2e-5)


def test_cuda_source_emulated_last_step_is_exact(emulated):
    """cn = 0 at i == 1: the kernel's unfused roundings give ca*x - cb*eps exactly."""
    x, eps = (torch.from_numpy(a) for a in _state(9))
    ca, cb, cn = update_coefs(make_schedule("cosine", 1500), 1)
    seed = torch.tensor([3, 4], dtype=torch.int64)
    out, _ = _emu_update(emulated, x, eps, (ca, cb, cn), seed, 1)
    assert torch.equal(out, ca * x - cb * eps)


@pytest.mark.parametrize("split", [1, 2, 5])
def test_a_slice_at_its_quad_offset_draws_the_whole_states_noise(split):
    """A chunk split into rows [0, k) and [k, B) (one replica's share each)
    and updated slice by slice, each at its first quad, equals the whole
    chunk's update bit for bit (float32, the plain version)."""
    x, eps = (torch.from_numpy(a) for a in _state(21, (6, 8, 8, 12)))
    seed = torch.tensor([0x1234, 0xABCDEF], dtype=torch.int64)
    coefs = update_coefs(make_schedule("cosine", 1500), 700)
    whole = ancestral_update(x, eps, coefs, seed, 700)
    per_item = x[0].numel() // 4
    parts = [ancestral_update(x[a:b], eps[a:b], coefs, seed, 700, quad0=a * per_item)
             for a, b in ((0, split), (split, 6))]
    assert torch.equal(torch.cat(parts), whole)
    assert not torch.equal(ancestral_update(x[split:], eps[split:], coefs, seed, 700),
                           whole[split:])
    with pytest.raises(ValueError, match="quad0"):
        ancestral_update(x, eps, coefs, seed, 700, quad0=-1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_source_emulated_quad_offset_matches_plain(emulated, dtype):
    """The kernel at a quad offset past 2**32 quads (the counter's high
    word) and at a small one, against the plain version at the same
    offsets."""
    x, eps = (torch.from_numpy(a).to(dtype) for a in _state(22, (2, 8, 8, 12)))
    seed = torch.tensor([0xC0FFEE, 0x5EED], dtype=torch.int64)
    coefs = update_coefs(make_schedule("cosine", 1500), 900)
    for quad0 in (192, (1 << 32) + 5):
        out, _ = _emu_update(emulated, x, eps, coefs, seed, 900, quad0=quad0)
        _assert_close(out, ancestral_update_plain(x, eps, coefs, seed, 900, quad0=quad0), dtype)
        assert not torch.equal(out, _emu_update(emulated, x, eps, coefs, seed, 900)[0])
