"""The yardstick: the card's published peaks and the operations and bytes
of the cell's work, from the layers' shapes.

The peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity),
at its 700 W power limit; every share is stated against them with the
card's power limit beside it. ``*_flops`` and ``*_bound`` are the hand
kernels' dense operations and least times (ms), each input read and each
output written once (copied from ``chip_smoke.py``'s bounds, where the
kernel table of ``PERF.md`` was measured). :func:`forward_flops` counts a
UNet forward's dense operations from the plain reference's layer shapes.
"""

from __future__ import annotations

from portbench.reference.unet import forward_macs

PEAK_BF16 = 989e12            # H100 SXM dense bf16 tensor FLOP/s
PEAK_F32 = 67e12              # H100 SXM float32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 bytes/s


def forward_flops(shapes, batch: int, hr: int, conditioning: str, magnification: int = 2) -> int:
    """Dense FLOPs of one UNet forward of ``batch`` images at ``hr`` px:
    2 x the multiply-adds of every convolution, ConvTranspose and linear
    layer. A training step counts 3 forwards' worth (the backward's two
    products); classifier-free guidance doubles the batch."""
    return 2 * forward_macs(shapes, batch, hr, conditioning, magnification)

def block_flops(B, H2, W2, C4, CO4, skip=True):
    """(dense, issued) FLOPs of one tap_block call. Dense is the block's own
    work at full resolution (2*H2 x 2*W2 pixels, Ci = C4/4 in, Co = CO4/4
    out): conv1 and (with `skip`, level 0) the skip conv 3x3 Ci->Co, conv2
    3x3 Co->Co, shortcut 1x1 Ci->Co. Issued is the size of the products the
    bfloat16 kernel runs: the tap im2col of x against conv1's (and skip's)
    columns of W1, the tap im2col of h against W2, and the centre rows of
    the shortcut (4 of its 16 row blocks), structural zeros of the tap form
    included."""
    ci, co, n1 = C4 // 4, CO4 // 4, 3 if skip else 2
    dense = 2 * B * (2 * H2) * (2 * W2) * ((n1 - 1) * 9 * ci * co + 9 * co * co + ci * co)
    issued = 2 * B * H2 * W2 * (4 * C4 * (n1 - 1) * CO4 + 4 * CO4 * CO4 + C4 * CO4)
    return dense, issued

def _bound(flops, nbytes, peak):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")

def block_bound(B, H2, W2, C4, CO4, itemsize, peak, skip=True):
    """Least time (ms) for one tap_block call: bytes each read or written
    once, the block's dense operations at the card's peak for the input type."""
    flops, _ = block_flops(B, H2, W2, C4, CO4, skip)
    nbytes = itemsize * (B * H2 * W2 * C4 + B * CO4 + 4 * C4 * (3 if skip else 2) * CO4
                         + 4 * CO4 * CO4 + 4 * CO4 + B * H2 * W2 * CO4)
    return _bound(flops, nbytes, peak)

def att_flops(B, H, W, c4=128, c=32, ch=64, out4=12):
    """Dense FLOPs of one att_head_block call over B x H x W s2d pixels,
    counted from the model's layers at their own resolution, as block_flops
    counts: the gating conv ch->c, w_g c->c and psi c->1 at H x W; w_x, the
    2x2 stride-2 conv C->c (C = c4/4) reading the 2H x 2W skip; the result
    conv C->C and the composed head_at, a 3x3 conv C->out4/4, at 2H x 2W.
    The s2d forms the kernel runs (the block-diagonal rc, the 3x3 head_at
    over all 4 sub-pixels) carry structural zeros, not counted."""
    cf, o = c4 // 4, out4 // 4
    macs = ch * c + c * c + c + 4 * cf * c + 4 * cf * cf + 4 * 9 * cf * o
    return 2 * B * H * W * macs

def att_bound(B, H, W, itemsize, peak, c4=128, c=32, ch=64, out4=12):
    """Least time (ms) for one att_head_block call: x and h read and the head
    contribution written once, the weights as the kernel takes them once;
    att_flops at the card's peak for the input type."""
    weights = ch * c + c * c + c4 * c + c + c4 * c4 + 9 * c4 * out4 + 3 * c + 1 + c4
    return _bound(att_flops(B, H, W, c4, c, ch, out4),
                  itemsize * (B * H * W * (c4 + ch + out4) + weights), peak)

def dec_flops(B, H, W, ca=128, cb=64, cm=64, out4=12):
    """Dense FLOPs of one dec_block call over B x H x W pixels: the 3x3
    concat conv (ca+cb)->cm and the 3x3 conv cm->cm at H x W, and the
    composed head_up4 (UpConvBlock-2's 3x3 stride-2 ConvTranspose, then the
    head's 3x3 conv to out4/4 channels). Through it a full-resolution pixel
    of even row reaches 3 rows of hh and one of odd row 2, so the four
    sub-pixels reach 9 + 6 + 6 + 4 = 25 of the 4x4 s2d kernel's 64 taps of
    each channel pair; the other taps are structural zeros, not counted."""
    macs = 9 * (ca + cb) * cm + 9 * cm * cm + 25 * cm * (out4 // 4)
    return 2 * B * H * W * macs

def dec_bound(B, H, W, itemsize, peak, ca=128, cb=64, cm=64, out4=12):
    """Least time (ms) for one dec_block call: xa, xb, te read and h, the two
    hh strips and the head contribution written once, the weights as the
    kernel takes them once; dec_flops at the card's peak for the input type."""
    acts = B * H * W * (ca + cb + cm + out4) + B * cm + B * (H + W) * cm
    weights = 9 * (ca + cb) * cm + 9 * cm * cm + 16 * cm * out4 + 2 * cm
    return _bound(dec_flops(B, H, W, ca, cb, cm, out4), itemsize * (acts + weights), peak)

def stem_flops(B, H2, W2, CX4=12, C14=64, CO4=128):
    """Dense FLOPs of one tap_stem_block call: conv0, the 3x3 conv
    CX4/4 -> C14/4 at full resolution, plus the block's (block_flops)."""
    conv0 = 2 * B * (2 * H2) * (2 * W2) * 9 * (CX4 // 4) * (C14 // 4)
    return conv0 + block_flops(B, H2, W2, C14, CO4)[0]

def stem_bound(B, H2, W2, itemsize, peak, CX4=12, C14=64, CO4=128, cond=True):
    """Least time (ms) for one tap_stem_block call: x, cond (unless
    cond=False, the bias-only stem) and te4 read and res0_s written once,
    the weights as the kernel takes them once; stem_flops at the card's
    peak for the input type."""
    weights = 4 * CX4 * C14 + C14 + 4 * C14 * 3 * CO4 + 4 * CO4 * CO4 + 4 * CO4
    nbytes = itemsize * (B * H2 * W2 * (CX4 + C14 * cond + CO4) + B * CO4 + weights)
    return _bound(stem_flops(B, H2, W2, CX4, C14, CO4), nbytes, peak)

def gate_flops(B, Hg, Wg, C):
    """FLOPs of one fused_attention_gate call over B x Hg x Wg gating
    pixels, the gate's layers at their own resolution: w_g C->C and psi
    C->1 at the gating grid, w_x (2x2 stride 2, 4C->C a gating pixel) and
    the result conv C->C at each of the 4 pixels of x above it."""
    return 2 * B * Hg * Wg * (C * C + C + 4 * C * C + 4 * C * C)

def gate_bound(B, gates, itemsize, peak):
    """Least time (ms) for the fused_attention_gate calls of `gates`, a list
    of (Hg, Wg, C): x and g read and out written once in the input type, the
    float32 weights read once; gate_flops at the card's peak for the input
    type (the kernel computes in float32: at 67 TFLOP/s the same products
    take longer than the bound)."""
    flops = sum(gate_flops(B, hg, wg, c) for hg, wg, c in gates)
    nbytes = sum(itemsize * B * hg * wg * 9 * c + 4 * (6 * c * c + 8 * c + 1) for hg, wg, c in gates)
    return _bound(flops, nbytes, peak)


# The hand layers' least time (ms) per forward at a cell's shapes, from its
# work: its batch, its s2d pixels a side, whether the stem reads a condition.
# bf16 operands (2 bytes) at the bf16 peak; kernels/*.json names them.

def stem_layer(w):
    s = w["s2d_px"]
    return stem_bound(w["batch"], s, s, 2, PEAK_BF16, cond=w["conditioned"])[0]


def block_layer(w):
    s = w["s2d_px"]
    return block_bound(w["batch"], s, s, 64, 128, 2, PEAK_BF16)[0]


def att_layer(w):
    s = w["s2d_px"]
    return att_bound(w["batch"], s, s, 2, PEAK_BF16)[0]


def dec_layer(w):
    s = w["s2d_px"]
    return dec_bound(w["batch"], s, s, 2, PEAK_BF16)[0]


def gates_layer(w):
    s = w["s2d_px"]
    return gate_bound(w["batch"], [(s // 4, s // 4, 128), (s // 2, s // 2, 64)], 2, PEAK_BF16)[0]
