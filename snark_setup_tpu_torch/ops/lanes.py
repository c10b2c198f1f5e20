"""The one bound on a launch's width in the phase-2 modules.

A batch wider than MAX_LANES is cut into slices of that width on the lane
(last) axis, each slice runs alone and the results are put back together:
slicing changes no value and no byte. It bounds device memory only; the
kernels themselves take any width.
"""

from __future__ import annotations

import torch

from .curve import PointVec

MAX_LANES = 1 << 17
"""Widest batch of one call. At this width a BW6-761 point batch is 75 MB
(576 bytes a lane), a scalar-mul launch holds ~1.3 KB a lane (170 MB), and
the plain field layer's Montgomery conversion of a decoded batch ~2.4 GB of
int64 product columns (48 x 48 limbs a lane): a small part of the H100's
80 GB. Every phase-2 vector up to a 2^16 domain (2^17 - 1 tau powers) runs
unsliced; the reference's production target, 2^27 points a section (~77 GB
for one BW6-761 batch), would not fit whole."""


def spans(n: int) -> list[tuple[int, int]]:
    """[lo, hi) slices of at most MAX_LANES covering range(n)."""
    return [(lo, min(lo + MAX_LANES, n)) for lo in range(0, n, MAX_LANES)]


def _take(operand, lo: int, hi: int):
    if isinstance(operand, dict):
        return PointVec({k: v[..., lo:hi] for k, v in operand.items()})
    return operand[..., lo:hi]


def cat(parts: list) -> PointVec:
    """PointVecs concatenated along the lane axis."""
    if len(parts) == 1:
        return parts[0]
    return PointVec({k: torch.cat([p[k] for p in parts], dim=-1) for k in ("x", "y", "z")})


def lanewise(fn, *operands) -> PointVec:
    """fn(*operands) over slices of at most MAX_LANES lanes of every operand
    (PointVecs or tensors, lanes on the last axis), concatenated."""
    first = operands[0]
    B = (first["x"] if isinstance(first, dict) else first).shape[-1]
    return cat([fn(*(_take(o, lo, hi) for o in operands)) for lo, hi in spans(B)])
