"""Tap-structured im2col helpers (port of the parts of
``diffusionremotesensing_tpu/ops/tap_conv.py`` that ``tap_block`` uses).

The four output taps of one s2d pixel read a 4x4 window of original pixels,
so a level-0 3x3 conv is one (16C -> 4Co) contraction per s2d pixel. The
im2col concatenates 16 pieces, one per window position (r, s); piece
(r, s) is the s2d input shifted by (ar - 1, as - 1) pixels, restricted to
tap block tb. The piece order ``_ORDER`` is the reference's (chosen there
for the TPU's lane layout); it is kept so that the weight matrices built by
``tap_block.build_block_weights`` are the same matrices, row for row.

:func:`tap_conv` and :func:`tap_conv_pair` (``tap44`` True and 'conv2')
launch the hand-written CUDA kernels of ``csrc/tap_conv.cu`` for CUDA
tensors and run :func:`tap_conv_plain` / :func:`tap_conv_pair_plain`, the
im2col times the weight matrix in ``torch`` ops, for CPU tensors. A CUDA
tensor the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch
import torch.nn.functional as F

from diffusionremotesensing_tpu_torch.ops import cuda_build
from diffusionremotesensing_tpu_torch.ops.s2d import k3_to_s2d44

_COUNT_LOCK = threading.Lock()  # launches may come from several server threads

# window position r -> (row offset into the 1-padded s2d tile, tap row):
# original row 2i + r - 1 is s2d row i + ar - 1, tap q
_RS = {0: (0, 1), 1: (1, 0), 2: (1, 1), 3: (2, 0)}

_BY_TB = {tb: [] for tb in range(4)}
for _r in range(4):
    for _s in range(4):
        _BY_TB[2 * _RS[_r][1] + _RS[_s][1]].append((_r, _s))
_ORDER = [_BY_TB[k % 4][k // 4] for k in range(16)]

# per piece k of _ORDER: (row offset ar, column offset as, tap block tb)
PIECES = [(_RS[r][0], _RS[s][0], 2 * _RS[r][1] + _RS[s][1]) for (r, s) in _ORDER]


def _w2d(w44: torch.Tensor) -> torch.Tensor:
    """(4,4,C,4Co) tap-structured kernel -> (16C, 4Co) matmul weight, rows
    in ``_ORDER``."""
    return torch.cat([w44[r, s] for (r, s) in _ORDER], dim=0)


def im2col_s2d44(x: torch.Tensor) -> torch.Tensor:
    """(B, H2, W2, 4C) s2d tensor -> (B, H2, W2, 16C) im2col for the 4x4
    stride-2 window, pieces in ``_ORDER``, zero outside the image (the 3x3
    conv's SAME padding on the original grid)."""
    B, H2, W2, C4 = x.shape
    C = C4 // 4
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))  # one zero s2d pixel on every side
    pieces = [xp[:, ar:ar + H2, as_:as_ + W2, tb * C:(tb + 1) * C] for (ar, as_, tb) in PIECES]
    return torch.cat(pieces, dim=-1)


def tap_weight(w: torch.Tensor) -> torch.Tensor:
    """3x3 HWIO kernel (3,3,C,Co) -> the (16C, 4Co) matrix :func:`tap_conv`
    takes (``_w2d`` of ``k3_to_s2d44``)."""
    return _w2d(k3_to_s2d44(w))


def tap_conv_plain(x_s2d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The s2d-layout 3x3 SAME conv in ``torch`` ops: x_s2d (B,H2,W2,4C), w
    (16C, 4Co) from :func:`tap_weight` in x's dtype. The product accumulates
    in float32 and is rounded once to x's dtype."""
    return (im2col_s2d44(x_s2d).float() @ w.float()).to(x_s2d.dtype)


def tap_conv_pair_plain(x_s2d: torch.Tensor, wa: torch.Tensor, wb: torch.Tensor):
    """Two convs of one input off one im2col: (conv(x, wa), conv(x, wb))."""
    xc = im2col_s2d44(x_s2d).float()
    return (xc @ wa.float()).to(x_s2d.dtype), (xc @ wb.float()).to(x_s2d.dtype)


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load("tap_conv")
    lib.tap_conv_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.tap_conv_pair_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    lib.tap_conv_launch.restype = lib.tap_conv_pair_launch.restype = ctypes.c_int
    return lib


SMEM_LIMIT = 232448  # bytes of shared memory a block may have on an H100


def smem_bytes(C4: int, CO4: int, n_weights: int, dtype: torch.dtype) -> int:
    """Shared memory one block of ``csrc/tap_conv.cu`` needs: bfloat16, the
    whole W (``n_weights`` of them), two x slabs (each 4C / 64 planes of
    10 x 18 pixels x 128 bytes, a plane rounded up to 1024 bytes), 1024
    bytes of alignment and 5 mbarriers; float32, one x slab (each pixel
    padded by 4 channels) and the warps' epilogue buffers."""
    if dtype == torch.bfloat16:
        return 1024 + n_weights * 2 * 4 * C4 * CO4 + 2 * (C4 // 64) * 23552 + 40
    return -(-4 * 10 * 18 * (C4 + 4) // 128) * 128 + 4 * 8 * 16 * 68


def _check(name, x_s2d, ws):
    """Raise unless the kernel takes x_s2d and the weights ws as they are."""
    if x_s2d.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes float32 or bfloat16, got {x_s2d.dtype}")
    if x_s2d.dim() != 4:
        raise ValueError(f"{name}: x_s2d must be (B, H2, W2, 4C), got {tuple(x_s2d.shape)}")
    C4, CO4 = x_s2d.shape[3], ws[0].shape[-1]
    bf16 = x_s2d.dtype == torch.bfloat16
    # bfloat16: 16-channel pieces (ldmatrix) and 128-column wgmma passes
    c4_unit, co4_unit = (64, 128) if bf16 else (4, 64)
    if C4 % c4_unit or CO4 % co4_unit:
        raise ValueError(f"{name} needs 4C % {c4_unit} == 0 and 4Co % {co4_unit} == 0, "
                         f"got {C4}, {CO4}")
    need = smem_bytes(C4, CO4, len(ws), x_s2d.dtype)
    if need > SMEM_LIMIT:
        raise ValueError(f"{name}: W ({4 * C4} x {CO4}, {len(ws)} of them) and the x slabs need "
                         f"{need} bytes of shared memory, more than the {SMEM_LIMIT} a block has")
    ops = {"x_s2d": (x_s2d, tuple(x_s2d.shape))}
    ops.update({f"w{i}": (w, (4 * C4, CO4)) for i, w in enumerate(ws)})
    cuda_build.check_operands(name, x_s2d, ops)
    if any(t.data_ptr() % 16 for t in (x_s2d, *ws)):
        raise ValueError(f"{name}: operands must be 16-byte aligned (16-byte copies)")


def _launch(name, x_s2d, ws):
    if x_s2d.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {x_s2d.device}")
    _check(name, x_s2d, ws)
    B, H2, W2, C4 = x_s2d.shape
    CO4 = ws[0].shape[1]
    outs = [torch.empty((B, H2, W2, CO4), dtype=x_s2d.dtype, device=x_s2d.device) for _ in ws]
    lib = _library()
    fn = lib.tap_conv_launch if len(ws) == 1 else lib.tap_conv_pair_launch
    with torch.cuda.device(x_s2d.device):
        rc = fn(x_s2d.data_ptr(), *(w.data_ptr() for w in ws), *(o.data_ptr() for o in outs),
                B, H2, W2, C4, CO4, int(x_s2d.dtype == torch.bfloat16),
                torch.cuda.current_stream(x_s2d.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")
    return outs


def tap_conv(x_s2d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """s2d-layout 3x3 SAME conv: x_s2d (B,H2,W2,4C), w (16C, 4Co) from
    :func:`tap_weight`. CUDA tensors launch ``csrc/tap_conv.cu`` (each launch
    adds one to ``tap_conv.launches``); CPU tensors run
    :func:`tap_conv_plain`. Returns (B,H2,W2,4Co) in x's dtype."""
    if x_s2d.device.type == "cpu":
        return tap_conv_plain(x_s2d, w)
    (out,) = _launch("tap_conv", x_s2d, [w])
    with _COUNT_LOCK:
        tap_conv.launches += 1
    return out


def tap_conv_pair(x_s2d: torch.Tensor, wa: torch.Tensor, wb: torch.Tensor):
    """Two s2d-layout 3x3 SAME convs of one input, (conv(x, wa), conv(x, wb)),
    off one staged input. CUDA tensors launch ``csrc/tap_conv.cu``'s pair
    kernel (each launch adds one to ``tap_conv_pair.launches``); CPU tensors
    run :func:`tap_conv_pair_plain`."""
    if x_s2d.device.type == "cpu":
        return tap_conv_pair_plain(x_s2d, wa, wb)
    if wa.shape != wb.shape:
        raise ValueError(f"tap_conv_pair: weights of shapes {tuple(wa.shape)}, {tuple(wb.shape)}")
    oa, ob = _launch("tap_conv_pair", x_s2d, [wa, wb])
    with _COUNT_LOCK:
        tap_conv_pair.launches += 1
    return oa, ob


tap_conv.launches = 0
tap_conv_pair.launches = 0
