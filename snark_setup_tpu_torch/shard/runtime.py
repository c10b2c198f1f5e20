"""Single-device runtime of the contribution hot loop.

The reference's module of this name shards the batch axis over a device mesh;
the port runs one card so far, so placement is a plain copy to the chosen
device and the pad width is the identity. No batch-width guard is carried
over: the reference's lane bounds worked around compiler faults of its
backend and have no counterpart here. The only bound on a batch is the
card's memory — the ladder kernel needs ~8 KB of local memory per resident
thread and 6 L + 2 nwin + 2 words of global memory per lane; the ladder over
the group law (Fp2 / Fp3 coordinates, MNT curves) keeps a 16-entry table of
48 L d words per lane and a few stacked rounds of 6 L d T words (T = 9 tower
products for Fp3): about 0.1 MB per lane at L = 48, d = 3, so 16384 lanes take
~2 GB, far below 80 GB.
"""

from __future__ import annotations

import torch

from ..ops.curve import CurveOps, PointVec
from ..utils.device import resolve_device


def pad_width(pad: int) -> int:
    """Batch pad size rounded up to the device count: identity on one card."""
    return pad


def put_points(ops: CurveOps, pts: PointVec, device=None) -> PointVec:
    """Place a point batch on the device (default: the card)."""
    return pts.to(resolve_device(device))


def put_scalars(ops: CurveOps, scalars: torch.Tensor, device=None) -> torch.Tensor:
    return scalars.to(resolve_device(device))


def scalar_mul(ops: CurveOps, pts: PointVec, scalars_raw: torch.Tensor, device=None) -> PointVec:
    """The contribution hot loop's batch scalar-mul: [k mod r]P per lane for
    subgroup points, through the port's kernels on the card (GLV digits and
    ladder, or the stacked-product kernel under the group law) and their
    plain versions when the caller asked for the CPU."""
    dev = resolve_device(device)
    with torch.no_grad():
        return ops.scalar_mul(pts.to(dev), scalars_raw.to(dev))
