"""Fused ancestral DDPM update (port of ``diffusionremotesensing_tpu/ops/fused_update.py``).

One pass over the sampler's state computes

    x' = ca*x - cb*eps + cn*z

with z ~ N(0, 1) i.i.d. by Box-Muller on two uint32 words a draw, through
the reference's mantissa map (``0x3F800000 | (b >> 9)`` read as float32 is
uniform in [1, 2)). The words come from a Philox4x32-10 generator keyed by
two seed words; its counter holds the quad index and the step, and one
call gives the four words of four neighbouring elements (``quad0`` starts
the quad index of a slice where the slice starts in the whole state, so
that a chunk split over devices draws the whole chunk's noise; with
``item_quads`` x is a band of rows of each of its items, an image split over
devices by height, and quad q of x is quad ``quad0 + (q // band) *
item_quads + q % band`` of the whole state, band the quads of one item in
x): each word pair
(w0, w1) and (w2, w3) gives both of its Box-Muller outputs, r cos and
r sin (``csrc/ancestral_update.cu`` states the layout). Given ``bits`` (two
planes shaped like x, uint32 viewed as int32) replace the generator, as
the reference's ``_update_kernel_bits`` does: element e takes its own word
pair, cosine only. That makes the update deterministic for tests.

The noise stream differs from ``torch.randn``'s, as the reference kernel's
differs from threefry: same distribution, other numbers. Samplers take the
update only when asked (``fused_update=True``).

:func:`ancestral_update` launches the CUDA kernel for CUDA tensors and runs
:func:`ancestral_update_plain`, the same arithmetic in ``torch`` ops, for
CPU tensors. A CUDA tensor the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Sequence

import torch

from diffusionremotesensing_tpu_torch.ops import cuda_build
from diffusionremotesensing_tpu_torch.schedules import Schedule

_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57      # Philox multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85      # Weyl key increments
_TWO_PI = 6.283185307179586
_COUNT_LOCK = threading.Lock()


def update_coefs(schedule: Schedule, i: int):
    """(ca, cb, cn) of step i in float32: x' = ca*x - cb*eps + cn*z is the
    ancestral step, with cn = 0 at the last step (i == 1)."""
    a, ah, b = schedule.alpha[i], schedule.alpha_hat[i], schedule.beta[i]
    ca = torch.rsqrt(a)
    cb = ca * (1.0 - a) / torch.sqrt(1.0 - ah)
    cn = torch.sqrt(b) if i > 1 else torch.zeros((), dtype=torch.float32)
    return float(ca), float(cb), float(cn)


def draw_seed(generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Two key words in [0, 2**32) as an int64 tensor on ``device``, drawn
    from ``generator`` (the device's default generator when None) on the
    generator's device: with both on the card, no synchronisation."""
    gen_device = generator.device if generator is not None else torch.device(device)
    return torch.randint(0, 1 << 32, (2,), generator=generator, device=gen_device,
                         dtype=torch.int64).to(device)


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) words of the 64-bit product of uint32 values ``a`` (int64
    tensor) and the constant m, in 16-bit halves: a full 32x32-bit product
    reaches 2**64 and would overflow int64."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    mid1, mid2 = a_hi * m_lo, a_lo * m_hi
    low = a_lo * m_lo + ((mid1 & 0xFFFF) << 16) + ((mid2 & 0xFFFF) << 16)
    hi = (a_hi * m_hi + (mid1 >> 16) + (mid2 >> 16) + (low >> 32)) & _MASK
    return hi, low & _MASK


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on int64 tensors holding uint32 words (the key words
    may be 0-dim tensors or ints); returns the four output words."""
    for r in range(10):
        if r > 0:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def state_quads(nq: int, quad0: int = 0, item_quads: Optional[int] = None,
                band_quads: Optional[int] = None, device=None) -> torch.Tensor:
    """The whole state's quad index of each of x's nq quads (int64): quad0 +
    q for a contiguous slice; for a band of ``band_quads`` quads of each item
    of ``item_quads`` quads, quad0 + (q // band_quads) * item_quads + q %
    band_quads."""
    q = torch.arange(nq, dtype=torch.int64, device=device)
    if item_quads is not None and band_quads != item_quads:
        q = q // band_quads * item_quads + q % band_quads
    return q + quad0


def philox_bits_plain(seed: torch.Tensor, step: int, n: int, quad0: int = 0,
                      item_quads: Optional[int] = None,
                      band_quads: Optional[int] = None) -> torch.Tensor:
    """The generator's words for elements [0, n) at ``step``, by quad:
    (ceil(n / 4), 4) int64 in [0, 2**32), row q the four words of elements
    4q .. 4q + 3, from counter (Q low, Q high, step, 0), Q the whole state's
    index of quad q (:func:`state_quads`: quad0 + q, or the band layout of
    ``item_quads`` and ``band_quads``). seed: (2,) int64 words."""
    q = state_quads((n + 3) // 4, quad0, item_quads, band_quads, seed.device)
    key = seed.to(torch.int64) & _MASK
    words = philox4x32_10(q & _MASK, q >> 32, torch.full_like(q, step & _MASK),
                          torch.zeros_like(q), key[0], key[1])
    return torch.stack(words, dim=1)


def _uniform12(b: torch.Tensor) -> torch.Tensor:
    """The reference's map of uint32 words (int64 tensor) to float32 uniform
    in [1, 2): the logical shift of the unsigned word, then the bits read as
    float32."""
    return ((b & _MASK) >> 9 | 0x3F800000).to(torch.int32).view(torch.float32)


def box_muller(b1: torch.Tensor, b2: torch.Tensor):
    """Both Box-Muller outputs of word pairs (b1, b2), int64 tensors of
    uint32 words: (r cos(2 pi u2), r sin(2 pi u2)) in float32, two
    independent N(0, 1) draws, r = sqrt(-2 log u1), u1 = 2 - f(b1) in
    (0, 1], u2 = f(b2) - 1 in [0, 1)."""
    r = torch.sqrt(-2.0 * torch.log(2.0 - _uniform12(b1)))
    theta = _TWO_PI * (_uniform12(b2) - 1.0)
    return r * torch.cos(theta), r * torch.sin(theta)


def bits_to_normal(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The reference's map of given words to N(0, 1) (``bits`` mode):
    element e takes its own pair (b1[e], b2[e]), cosine only."""
    return box_muller(b1, b2)[0]


def philox_normal_plain(seed: torch.Tensor, step: int, n: int, quad0: int = 0,
                        item_quads: Optional[int] = None,
                        band_quads: Optional[int] = None) -> torch.Tensor:
    """The noise of elements [0, n) at ``step``, float32 (n,): quad q's
    words (w0, w1, w2, w3) give z[4q], z[4q + 1] as (w0, w1)'s cos and sin
    outputs and z[4q + 2], z[4q + 3] as (w2, w3)'s; the quads laid out as
    :func:`philox_bits_plain` takes them."""
    w = philox_bits_plain(seed, step, n, quad0, item_quads, band_quads)
    c01, s01 = box_muller(w[:, 0], w[:, 1])
    c23, s23 = box_muller(w[:, 2], w[:, 3])
    return torch.stack([c01, s01, c23, s23], dim=1).reshape(-1)[:n]


def _band_quads(x: torch.Tensor, item_quads: Optional[int]) -> Optional[int]:
    """The quads of one item in x, a band of rows of its items when
    ``item_quads`` is given (None otherwise); raises unless each item's band
    is whole quads and no more than an item."""
    if item_quads is None:
        return None
    per_item = x[0].numel() if x.dim() else 0
    if x.dim() < 2 or per_item % 4 or not 0 < per_item // 4 <= item_quads:
        raise ValueError(f"ancestral_update: a band of {tuple(x.shape)} needs whole quads of "
                         f"each item ({per_item} elements) and at most item_quads={item_quads}")
    return per_item // 4


def ancestral_update_plain(x: torch.Tensor, eps: torch.Tensor, coefs: Sequence[float],
                           seed: Optional[torch.Tensor], step: int,
                           bits: Optional[torch.Tensor] = None,
                           quad0: int = 0, item_quads: Optional[int] = None) -> torch.Tensor:
    """The update in ``torch`` ops, float32 math, output in x's dtype."""
    n = x.numel()
    if bits is None:
        z = philox_normal_plain(seed, step, n, quad0, item_quads, _band_quads(x, item_quads))
    else:
        b = bits.reshape(2, n).to(torch.int64) & _MASK
        z = bits_to_normal(b[0], b[1])
    z = z.reshape(x.shape)
    ca, cb, cn = coefs
    return (ca * x.float() - cb * eps.float() + cn * z).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load("ancestral_update")
    lib.ancestral_update_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_float] * 3
        + [ctypes.c_uint] + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p])
    lib.ancestral_update_launch.restype = ctypes.c_int
    lib.philox_bits_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                       ctypes.c_uint] + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
    lib.philox_bits_launch.restype = ctypes.c_int
    return lib


def _check_seed(seed, device):
    if seed is None or tuple(seed.shape) != (2,) or seed.dtype != torch.int64:
        raise ValueError("ancestral_update: seed must be a (2,) int64 tensor")
    if seed.device != device or not seed.is_contiguous():
        raise ValueError(f"ancestral_update: seed is on {seed.device}, x on {device}")


def _check(x, eps, seed, bits):
    """Raise unless the kernel takes these tensors as they are."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ancestral_update takes float32 or bfloat16, got {x.dtype}")
    if eps.dtype != x.dtype or eps.shape != x.shape or eps.device != x.device:
        raise ValueError(f"ancestral_update: eps is {eps.dtype} {tuple(eps.shape)} on "
                         f"{eps.device}, x is {x.dtype} {tuple(x.shape)} on {x.device}")
    if not (x.is_contiguous() and eps.is_contiguous()):
        raise ValueError("ancestral_update: x and eps must be contiguous")
    if bits is None:
        _check_seed(seed, x.device)
    elif (bits.dtype != torch.int32 or tuple(bits.shape) != (2, *x.shape)
          or bits.device != x.device or not bits.is_contiguous()):
        raise ValueError(f"ancestral_update: bits must be contiguous int32 {(2, *x.shape)} "
                         f"on {x.device}, got {bits.dtype} {tuple(bits.shape)} on {bits.device}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def ancestral_update(x: torch.Tensor, eps: torch.Tensor, coefs: Sequence[float],
                     seed: Optional[torch.Tensor], step: int,
                     bits: Optional[torch.Tensor] = None, quad0: int = 0,
                     item_quads: Optional[int] = None) -> torch.Tensor:
    """x' = ca*x - cb*eps + cn*z. CUDA tensors launch
    ``csrc/ancestral_update.cu`` (each launch adds one to
    ``ancestral_update.launches``); CPU tensors run
    :func:`ancestral_update_plain`. coefs from :func:`update_coefs`; seed
    from :func:`draw_seed` (unused when bits are given); step the sampler's
    step index, which enters the generator's counter; quad0 the quad index
    of x's first element in the whole state (x a slice of it). With
    ``item_quads`` (the quads of one whole item of the state) x is a band of
    rows of each of its items and quad0 the quads before the band's first
    row (module docstring)."""
    if quad0 < 0:
        raise ValueError(f"ancestral_update: quad0 must be >= 0, got {quad0}")
    band_quads = _band_quads(x, item_quads)
    if x.device.type == "cpu":
        return ancestral_update_plain(x, eps, coefs, seed, step, bits, quad0, item_quads)
    if x.device.type != "cuda":
        raise ValueError(f"ancestral_update runs on cuda or cpu tensors, got {x.device}")
    _check(x, eps, seed, bits)
    out = torch.empty_like(x)
    ca, cb, cn = (float(c) for c in coefs)
    with torch.cuda.device(x.device):
        rc = _library().ancestral_update_launch(
            x.data_ptr(), eps.data_ptr(), None if bits is None else bits.data_ptr(),
            None if seed is None else seed.data_ptr(), out.data_ptr(), x.numel(), ca, cb, cn,
            step & 0xFFFFFFFF, int(quad0), int(item_quads or 0), int(band_quads or 0),
            int(x.dtype == torch.bfloat16), _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"ancestral_update launch failed with CUDA error {rc}")
    with _COUNT_LOCK:
        ancestral_update.launches += 1
    return out


ancestral_update.launches = 0


def philox_bits(seed: torch.Tensor, step: int, n: int, quad0: int = 0,
                item_quads: Optional[int] = None,
                band_quads: Optional[int] = None) -> torch.Tensor:
    """The words :func:`ancestral_update` draws for elements [0, n) at
    ``step`` (the quads laid out as :func:`philox_bits_plain` takes them), by
    quad as (ceil(n / 4), 4) int64 in [0, 2**32): from the kernel's own
    generator for a CUDA seed, from :func:`philox_bits_plain` for a CPU one.
    For checking the generator; the sampler never calls it."""
    if seed.device.type == "cpu":
        return philox_bits_plain(seed, step, n, quad0, item_quads, band_quads)
    _check_seed(seed, seed.device)
    out = torch.empty(((n + 3) // 4, 4), dtype=torch.int32, device=seed.device)
    with torch.cuda.device(seed.device):
        rc = _library().philox_bits_launch(seed.data_ptr(), out.data_ptr(), n,
                                           step & 0xFFFFFFFF, int(quad0), int(item_quads or 0),
                                           int(band_quads or 0), _stream(seed.device))
    if rc != 0:
        raise RuntimeError(f"philox_bits launch failed with CUDA error {rc}")
    return out.to(torch.int64) & _MASK
