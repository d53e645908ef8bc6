"""Tap-structured im2col helpers (port of the parts of
``diffusionremotesensing_tpu/ops/tap_conv.py`` that ``tap_block`` uses).

The four output taps of one s2d pixel read a 4x4 window of original pixels,
so a level-0 3x3 conv is one (16C -> 4Co) contraction per s2d pixel. The
im2col concatenates 16 pieces, one per window position (r, s); piece
(r, s) is the s2d input shifted by (ar - 1, as - 1) pixels, restricted to
tap block tb. The piece order ``_ORDER`` is the reference's (chosen there
for the TPU's lane layout); it is kept so that the weight matrices built by
``tap_block.build_block_weights`` are the same matrices, row for row.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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
