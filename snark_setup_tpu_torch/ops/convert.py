"""State carried across the two packages' seams: limb planes and point
batches between the reference layout (numpy uint32, 16-bit limbs, batch axis
last) and the port's tensors (torch.int32, same shape, same values). Any
shape passes unchanged: Fq planes (L, B), extension-field planes (L, d, B),
stacked operands (L, S, B) or (L, d, S, B).

Values are < 2^16, so the two dtypes hold the same bits; these helpers only
change the container. Tests use them to hand both packages the same numpy
inputs and to compare outputs limb for limb.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from .curve import PointVec


def planes_from_reference(arr, device=None) -> torch.Tensor:
    """numpy (or array-like) uint32 limb planes -> int32 tensor on `device`
    (default: the card; without one that raises unless "cpu" is asked for)."""
    device = resolve_device(device)
    a = np.ascontiguousarray(np.asarray(arr))
    if a.size and int(a.max()) > 0xFFFF:
        raise ValueError("limb planes must hold 16-bit limbs")
    return torch.from_numpy(a.astype(np.int32)).to(device)


def planes_to_reference(t: torch.Tensor) -> np.ndarray:
    """int32 tensor of limb planes -> numpy uint32 (the reference's dtype)."""
    return t.detach().cpu().numpy().astype(np.uint32)


def pointvec_from_reference(p, device=None) -> PointVec:
    """dict of numpy x/y/z planes -> PointVec of tensors on `device`
    (default: the card, as for `planes_from_reference`)."""
    device = resolve_device(device)
    return PointVec({k: planes_from_reference(p[k], device) for k in ("x", "y", "z")})


def pointvec_to_reference(p: PointVec) -> dict:
    return {k: planes_to_reference(p[k]) for k in ("x", "y", "z")}
