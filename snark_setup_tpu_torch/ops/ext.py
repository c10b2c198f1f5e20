"""Field-ops protocol the curve group law and the codec are written against:
Fq itself and the Fp2 / Fp3 towers over it.

Element layout (limbs-leading, batch-trailing, as in fp.py and the
reference's ext_jax.py):
  Fp  : (L, *batch)
  Fp2 : (L, 2, *batch)
  Fp3 : (L, 3, *batch)
The coefficient axis sits between the limb axis and the batch axes, so the
FpOps elementwise ops (add/sub/neg/select) apply unchanged, while products
go through `mul_stacked`: G Montgomery products, each a weighted sum of S
stacked products, in one launch of a stacked-product kernel on the card —
K5 (ops/cuda_mul.py) by default, K6-K8 under the opt-in switches
(ops/cuda_routes.py) — and its plain version on the CPU. A tower
product flattens into that same primitive: every output coefficient of every
group is a weighted sum of base-field products, so a stack of S tower
products with curve-level weights becomes one composite weight matrix over
the S*T base products (T = 4 for Fp2, 9 for Fp3). A negative non-residue is
folded in by negating the `a` operand of the affected base products, so no
weight is ever negative.

Every product goes through the field-ops object's `product`, the route
dispatcher of its modulus (`StackedProduct`: the switches are read at every
call, in the reference's order); the plain versions swap in its `plain`
method, which takes the same route's counted plain version
(ops/curve.py: plain_group_law).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.device import to_device
from .cuda_routes import stacked_product_for
from .fp import FpOps


def _flat_batch(U: torch.Tensor, V: torch.Tensor, lead: int):
    """Broadcast U, V and flatten every axis after the first `lead` into one
    batch axis. Returns (U, V, batch shape)."""
    U, V = torch.broadcast_tensors(U, V)
    batch = U.shape[lead:]
    B = math.prod(batch)
    return U.reshape(*U.shape[:lead], B), V.reshape(*V.shape[:lead], B), batch


class BaseFieldOps:
    """Degree-1 'extension': direct passthrough to FpOps; layout (L, *batch)."""

    degree = 1

    def __init__(self, fp: FpOps):
        self.fp = fp
        # (U, V, weights, rows=None) -> stacked products on the switches'
        # route (ops/cuda_routes.py)
        self.product = stacked_product_for(fp.modulus)
        # max #plain-products accumulated per coefficient by one product
        self.prod_nprod = 1

    def zeros(self, shape, device):
        return self.fp.zeros(shape, device)

    def ones(self, shape, device):
        return self.fp.ones(shape, device)

    def bc(self, c: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """Broadcast-reshape a (L,) or (L, 1) constant against `like`."""
        return c.reshape(self.fp.L, *([1] * (like.ndim - 1)))

    def const(self, key, arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        """A host constant element ((L, 1) numpy) as a tensor on `like`'s
        device, materialised once per device, broadcastable against `like`."""
        return self.fp.const_of(key, arr, like)

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

    def mul(self, a, b):
        return self.fp.mont_mul(a, b)

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

    def mul_stacked(self, U, V, weights: tuple, nprod: int):
        """G Montgomery products, each a weighted sum of S stacked products:
        out[:, g] = redc(sum_s weights[g][s] * U_s * V_s). U, V (L, S, *batch)
        -> (L, G, *batch); one launch of the route's kernel on the card.
        `nprod` is the caller's bound on sum_s weights[g][s] (the
        reference's REDC bound)."""
        assert max(sum(g) for g in weights) <= nprod
        L = U.shape[0]
        Uf, Vf, batch = _flat_batch(U, V, 2)
        out = self.product(Uf, Vf, weights)
        return out.reshape(L, len(weights), *batch)


class _ExtCommon:
    degree: int

    def __init__(self, fp: FpOps, nonresidue: int):
        self.fp = fp
        self.product = stacked_product_for(fp.modulus)
        self.nr = nonresidue if nonresidue <= fp.modulus // 2 else nonresidue - fp.modulus
        self._flat_cache: dict = {}

    def zeros(self, shape, device):
        return self.fp.zeros((self.degree, *shape), device)

    def ones(self, shape, device):
        z = self.zeros(shape, device)
        z[:, 0] = self.fp.ones(shape, device)
        return z

    def bc(self, c: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """Broadcast-reshape a (L, d) or (L, d, 1) constant against `like`."""
        return c.reshape(self.fp.L, self.degree, *([1] * (like.ndim - 2)))

    def const(self, key, arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        """A host constant element ((L, d, 1) numpy) as a tensor on `like`'s
        device, materialised once per device, broadcastable against `like`."""
        cache = self.fp._dev_consts
        ck = (key, like.device, torch.int32)
        t = cache.get(ck)
        if t is None:
            t = cache[ck] = to_device(np.asarray(arr).astype(np.int64), like.device).to(torch.int32)
        return self.bc(t, like)

    def stack(self, elems):
        """Stack independent elements along a new first batch axis (axis 2)."""
        return torch.stack(torch.broadcast_tensors(*elems), dim=2)

    def unstack(self, arr, i):
        return arr[:, :, i]

    def add(self, a, b):
        return self.fp.add(a, b)

    def sub(self, a, b):
        return self.fp.sub(a, b)

    def neg(self, a):
        return self.fp.neg(a)

    def mul(self, a, b):
        """One tower product per batch element: a one-row mul_stacked."""
        return self.mul_stacked(a.unsqueeze(2), b.unsqueeze(2), ((1,),), self.prod_nprod)[:, :, 0]

    def sqr(self, a):
        return self.mul(a, a)

    def mul_small(self, a, k):
        return self.fp.mul_small(a, k)

    def is_zero(self, a):
        return (a == 0).all(dim=0).all(dim=0)

    def eq(self, a, b):
        return (a == b).all(dim=0).all(dim=0)

    def select(self, cond, a, b):
        return torch.where(cond, a, b)

    def from_coeffs(self, host_vals) -> np.ndarray:
        """list of d-tuples -> (L, d, n) host numpy Montgomery."""
        cs = [self.fp.from_int([v[i] for v in host_vals]) for i in range(self.degree)]
        return np.stack(cs, axis=1)

    def to_coeffs(self, a):
        arr = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        cs = [self.fp.to_int(arr[:, i]) for i in range(self.degree)]
        return list(zip(*cs))

    # tower expansion table: per output coefficient c, a list of
    # (a_coeff_idx, b_coeff_idx, weight, negate_a) base products
    def _tower_products(self):
        nr = self.nr
        w = abs(nr)
        neg = nr < 0
        if self.degree == 2:
            return [
                [(0, 0, 1, False), (1, 1, w, neg)],  # c0 = a0b0 + nr a1b1
                [(0, 1, 1, False), (1, 0, 1, False)],  # c1 = a0b1 + a1b0
            ]
        return [
            [(0, 0, 1, False), (1, 2, w, neg), (2, 1, w, neg)],  # c0 = a0b0 + nr(a1b2 + a2b1)
            [(0, 1, 1, False), (1, 0, 1, False), (2, 2, w, neg)],  # c1 = a0b1 + a1b0 + nr a2b2
            [(0, 2, 1, False), (2, 0, 1, False), (1, 1, 1, False)],  # c2 = a0b2 + a2b0 + a1b1
        ]

    def _flattened(self, weights: tuple, S: int):
        """Row maps and composite weights of a stack of S tower products
        under curve-level `weights` (G rows). Base stack order (s, t), t
        enumerating the tower products; operand rows index the (d*S)
        coefficient-major planes of U and V (row c*S + s); output row
        g*d + c is coefficient c of group g."""
        key = (weights, S)
        if key in self._flat_cache:
            return self._flat_cache[key]
        tower = self._tower_products()
        prods = [p for c in tower for p in c]
        T = len(prods)
        urow, vrow, uneg = [], [], []
        for s in range(S):
            for ai, bi, _w, na in prods:
                urow.append(ai * S + s)
                vrow.append(bi * S + s)
                uneg.append(int(na))
        offs = np.cumsum([0] + [len(c) for c in tower])
        comp = []
        for g_w in weights:
            for c in range(self.degree):
                row = [0] * (S * T)
                for s, w in enumerate(g_w):
                    if w:
                        for k, (_ai, _bi, tw, _na) in enumerate(tower[c]):
                            row[s * T + offs[c] + k] = w * tw
                comp.append(tuple(row))
        out = self._flat_cache[key] = tuple(comp), (tuple(urow), tuple(vrow), tuple(uneg))
        return out

    def mul_stacked(self, U, V, weights: tuple, nprod: int):
        """Ext-field twin of BaseFieldOps.mul_stacked: U, V (L, d, S, *batch)
        -> (L, d, G, *batch). The curve-level weights and the tower products
        flatten into one composite weight matrix (G*d rows over S*T base
        products) and one launch of the route's kernel, which reads the
        coefficient planes of U and V through row maps and negates where the
        non-residue is negative. The route is chosen on the composite
        weights, as the reference does."""
        assert max(sum(g) for g in weights) * self.prod_nprod <= nprod
        d = self.degree
        L, S = U.shape[0], U.shape[2]
        Uf, Vf, batch = _flat_batch(U, V, 3)
        comp, rows = self._flattened(tuple(tuple(g) for g in weights), S)
        out = self.product(Uf.reshape(L, d * S, -1), Vf.reshape(L, d * S, -1), comp, rows)
        # (L, G*d, B) with index g*d + c -> (L, d, G, *batch)
        G = len(weights)
        return out.reshape(L, G, d, -1).transpose(1, 2).reshape(L, d, G, *batch)


class QuadFieldOps(_ExtCommon):
    """Fp2 = Fp[u]/(u^2 - nr); layout (L, 2, *batch)."""

    degree = 2

    def __init__(self, fp: FpOps, nonresidue: int):
        super().__init__(fp, nonresidue)
        self.prod_nprod = max(1 + abs(self.nr), 2)

    def inv(self, a):
        fp = self.fp
        a0, a1 = a[:, 0], a[:, 1]
        norm = fp.sub(fp.mont_sqr(a0), _nr_mul(fp, fp.mont_sqr(a1), self.nr))
        ninv = fp.inv(norm)
        return torch.stack([fp.mont_mul(a0, ninv), fp.neg(fp.mont_mul(a1, ninv))], dim=1)


class CubicFieldOps(_ExtCommon):
    """Fp3 = Fp[u]/(u^3 - nr); layout (L, 3, *batch)."""

    degree = 3

    def __init__(self, fp: FpOps, nonresidue: int):
        super().__init__(fp, nonresidue)
        self.prod_nprod = max(1 + 2 * abs(self.nr), 2 + abs(self.nr), 3)

    def inv(self, a):
        fp = self.fp
        a0, a1, a2 = (a[:, i] for i in range(3))

        def nrm(x):
            return _nr_mul(fp, x, self.nr)

        t0 = fp.sub(fp.mont_sqr(a0), nrm(fp.mont_mul(a1, a2)))
        t1 = fp.sub(nrm(fp.mont_sqr(a2)), fp.mont_mul(a0, a1))
        t2 = fp.sub(fp.mont_sqr(a1), fp.mont_mul(a0, a2))
        norm = fp.add(fp.mont_mul(a0, t0), nrm(fp.add(fp.mont_mul(a2, t1), fp.mont_mul(a1, t2))))
        ninv = fp.inv(norm)
        return torch.stack([fp.mont_mul(t0, ninv), fp.mont_mul(t1, ninv), fp.mont_mul(t2, ninv)], dim=1)


def _nr_mul(fp: FpOps, a, nr: int):
    """Multiply by the (small, possibly negative) tower non-residue."""
    out = fp.mul_small(a, abs(nr))
    if nr < 0:
        out = fp.neg(out)
    return out


def make_field_ops(fp: FpOps, degree: int, nonresidue: int = 0):
    if degree == 1:
        return BaseFieldOps(fp)
    if degree == 2:
        return QuadFieldOps(fp, nonresidue)
    if degree == 3:
        return CubicFieldOps(fp, nonresidue)
    raise ValueError(degree)
