"""Field-ops protocol the curve group law and the codec are written against.

Only the degree-1 member exists so far: a thin passthrough to `FpOps` with
layout (L, *batch). The Fp2 / Fp3 towers (and the stacked weighted-product
entry point they share with the degree-1 class in the reference) arrive
together with their kernel; `make_field_ops` raises for them until then.
"""

from __future__ import annotations

import numpy as np
import torch

from .fp import FpOps


class BaseFieldOps:
    """Degree-1 'extension': direct passthrough to FpOps; layout (L, *batch)."""

    degree = 1

    def __init__(self, fp: FpOps):
        self.fp = fp
        # max #plain-products accumulated per coefficient by prod_cols
        self.prod_nprod = 1

    def zeros(self, shape, device):
        return self.fp.zeros(shape, device)

    def ones(self, shape, device):
        return self.fp.ones(shape, device)

    def bc(self, c: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """Broadcast-reshape a (L,) or (L, 1) constant against `like`."""
        return c.reshape(self.fp.L, *([1] * (like.ndim - 1)))

    def stack(self, elems):
        """Stack independent elements along a new first batch axis (axis 1)."""
        return torch.stack(torch.broadcast_tensors(*elems), dim=1)

    def unstack(self, arr, i):
        return arr[:, i]

    def add(self, a, b):
        return self.fp.add(a, b)

    def sub(self, a, b):
        return self.fp.sub(a, b)

    def neg(self, a):
        return self.fp.neg(a)

    def prod_cols(self, a, b):
        """Column-space product: (2L, *batch) non-negative int64 columns."""
        return self.fp.school_cols(a, b)

    def redc(self, cols, nprod: int | None = None):
        return self.fp.redc_cols(cols, nprod if nprod is not None else self.prod_nprod)

    def mul(self, a, b):
        return self.redc(self.prod_cols(a, b))

    def sqr(self, a):
        return self.mul(a, a)

    def mul_small(self, a, k):
        return self.fp.mul_small(a, k)

    def inv(self, a):
        return self.fp.inv(a)

    def is_zero(self, a):
        return self.fp.is_zero(a)

    def eq(self, a, b):
        return self.fp.eq(a, b)

    def select(self, cond, a, b):
        return self.fp.select(cond, a, b)

    def from_coeffs(self, host_vals) -> np.ndarray:
        """list of int tuples (or ints) -> (L, n) host numpy Montgomery."""
        vals = [v[0] if isinstance(v, (tuple, list)) else v for v in host_vals]
        return self.fp.from_int(vals)

    def to_coeffs(self, a):
        return [(v,) for v in self.fp.to_int(a)]


def make_field_ops(fp: FpOps, degree: int, nonresidue: int = 0) -> BaseFieldOps:
    if degree == 1:
        return BaseFieldOps(fp)
    raise NotImplementedError(
        f"degree-{degree} coordinate fields are not ported yet "
        "(ROADMAP Queue A: extension towers + stacked-product kernel)"
    )
