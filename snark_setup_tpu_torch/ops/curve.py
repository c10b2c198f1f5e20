"""Batched elliptic-curve group law on device — complete projective formulas.

Coordinates are field elements of a field-ops object (ops/ext.py: Fq, Fp2 or
Fp3 limb planes), so one group law serves G1 and G2 of every curve in
`curves/constants.py`, a = 0 or not.

Design:
- Limbs-leading layout (fp.py): coordinates are (L[, d], B) int32 limb planes
  with the batch axis last; a point batch is a `PointVec` dict of x, y, z.
- Renes–Costello–Batina *complete* formulas (eprint 2015/1060: Algorithm 1
  for a != 0, Algorithm 7 / 9 for a = 0): branch-free, they handle doubling
  and infinity uniformly. Infinity is (0 : 1 : 0). Every formula is three
  multiplication rounds; each round is one `F.mul_stacked` call — stacked
  products, a weighted merge of their columns and one reduction per output —
  which is one launch of the stacked-product kernel K5 on the card. On Fq
  coordinates with a = 0 (G1 of BLS12-377/381, both groups of BW6-761) a
  whole double or add is instead one launch of the group-op kernel K2
  (ops/cuda_group.py), whose plain version is this stacked law.
- `scalar_mul` is the GLV path ([k mod r]P, subgroup points only) where the
  curve has the cube-root endomorphism: on Fq coordinates the digits kernel
  K3 and the whole-ladder kernel K4 (cuda_glv.py, cuda_ladder.py); on Fp2
  coordinates K3 for the digits and a windowed ladder over the group law
  (K5 rounds). Curves without it (a != 0) take `scalar_mul_windowed`, the raw
  integer ladder that makes no subgroup assumption.

Every field op returns canonical values, so the projective coordinates these
functions return equal the reference's limb for limb.
"""

from __future__ import annotations

import copy
import functools
import math

import numpy as np
import torch

from ..curves.constants import CurveSpec, get_curve
from ..curves.host import AffinePoint, INFINITY, g1_curve, g2_curve
from ..fields.limb import LIMB_BITS, int_to_limbs, limbs_batch_to_ints
from .ext import make_field_ops
from .fp import _tree_batch_inv, fp_ops


class PointVec(dict):
    """Batched projective points: {'x','y','z'} tensors, batch axis last."""

    @property
    def x(self):
        return self["x"]

    @property
    def y(self):
        return self["y"]

    @property
    def z(self):
        return self["z"]

    def to(self, device) -> "PointVec":
        return PointVec({k: v.to(device) for k, v in self.items()})


def _identity_weights(n: int) -> tuple:
    return tuple(tuple(1 if i == j else 0 for j in range(n)) for i in range(n))


_ID2 = _identity_weights(2)
_ID4 = _identity_weights(4)
_ID6 = _identity_weights(6)
_PAIRS3 = ((1, 1, 0, 0, 0, 0), (0, 0, 1, 1, 0, 0), (0, 0, 0, 0, 1, 1))


class CurveOps:
    """Group-law ops for one source group of one curve."""

    WINDOW = 4

    def __init__(self, spec: CurveSpec, group: str):
        self.spec = spec
        self.group_name = group
        gspec = spec.g1 if group == "g1" else spec.g2
        self.gspec = gspec
        self.fq = fp_ops(spec.q)
        degree = {"fp": 1, "fp2": 2, "fp3": 3}[gspec.field_kind]
        self.field = make_field_ops(self.fq, degree, spec.ext_nonresidue)
        self.host_curve = g1_curve(spec) if group == "g1" else g2_curve(spec)
        # curve constants, Montgomery form, host numpy with a trailing
        # singleton batch axis: (L[, d], 1)
        a_host = tuple(gspec.a) if degree > 1 else (gspec.a[0],)
        b_host = tuple(gspec.b) if degree > 1 else (gspec.b[0],)
        self.a_is_zero = all(v == 0 for v in a_host)
        self.a_np = self.field.from_coeffs([a_host])
        self.b_np = self.field.from_coeffs([b_host])
        self.b3_np = self.field.from_coeffs([tuple(3 * v % spec.q for v in b_host)])
        if not self.a_is_zero:
            # -(a^2), used by the complete addition's round 1
            from .hostmath import host_ext_pow

            nr = spec.ext_nonresidue if degree > 1 else 0
            a2 = host_ext_pow(a_host, 2, spec.q, degree, nr)
            self.neg_a2_np = self.field.from_coeffs([tuple((spec.q - c) % spec.q for c in a2)])
        # |3b| as a small integer where the curve allows it (Fq coordinates,
        # a = 0, b in {1, -1, 4}): doubling folds 3b Z^2 into round 0 as a
        # column weight, and the ladder kernel replaces the 3b products by
        # short addition chains. (|w|, negate) or None.
        self._b3_small = None
        if self.a_is_zero and degree == 1:
            b3i = 3 * b_host[0] % spec.q
            if b3i <= 1 << 10:
                self._b3_small = (b3i, False)
            elif spec.q - b3i <= 1 << 10:
                self._b3_small = (spec.q - b3i, True)
        # scalar field
        self.fr = fp_ops(spec.r)
        self.scalar_bits = spec.r.bit_length()
        # GLV endomorphism (j=0 curves): decomposition + host constants
        from .glv import GLVOps, derive_glv

        self.glv = None
        params = derive_glv(spec.name, group)
        if params is not None:
            self.glv = GLVOps(params, self.fr.L)
            # beta in Fq: multiplying every coordinate plane by it applies phi
            # whatever the extension degree (coefficient-wise)
            self.beta_np = self.fq.from_int(params.beta)[:, None]
        # the endomorphism subgroup check phi(P) == [e]P (ops/codec.py):
        # (|e| as raw limbs (nl, 1), bit width of |e|, e < 0), or None where
        # the curve has no such e (then the check is [r]P == O)
        self._endo_check = None
        if params is not None and params.endo_check_lambda is not None:
            e = params.endo_check_lambda
            nl = -(-abs(e).bit_length() // LIMB_BITS)
            self._endo_check = (int_to_limbs(abs(e), nl)[:, None], abs(e).bit_length(), e < 0)
        # one launch of K2 per double / add where it applies (Fq, a = 0);
        # False in the plain law every plain version runs (plain_group_law)
        self.use_group_kernel = degree == 1 and self.a_is_zero and self._b3_small is not None

    def _const(self, name: str, like: torch.Tensor) -> torch.Tensor:
        """a_np / b_np / b3_np / neg_a2_np as a tensor broadcastable against
        a coordinate shaped like `like`."""
        key = (name, self.spec.name, self.group_name)
        return self.field.const(key, getattr(self, name), like)

    # -- constructors ------------------------------------------------------
    def infinity(self, shape, device) -> PointVec:
        return PointVec(
            x=self.field.zeros(shape, device),
            y=self.field.ones(shape, device),
            z=self.field.zeros(shape, device),
        )

    def from_affine_host(self, points: list[AffinePoint], device) -> PointVec:
        """Host affine points -> projective batch on `device`."""
        deg = self.field.degree
        xs, ys, infs = [], [], []
        for p in points:
            inf = p.is_infinity
            if inf:
                xs.append((0,) * deg)
                ys.append((1,) + (0,) * (deg - 1))
            elif deg == 1:
                xs.append((p.x.v,))
                ys.append((p.y.v,))
            else:
                xs.append(tuple(c.v for c in p.x.coeffs))
                ys.append(tuple(c.v for c in p.y.coeffs))
            infs.append(inf)
        x = self.field.from_coeffs(xs)  # (L[, d], B) host numpy Montgomery
        y = self.field.from_coeffs(ys)
        inf_mask = np.array(infs, bool)
        one = np.broadcast_to(self.field.from_coeffs([(1,) + (0,) * (deg - 1)]), x.shape)
        z = np.where(inf_mask, 0, one)
        return PointVec(
            x=self.fq.tensor(x, device), y=self.fq.tensor(y, device), z=self.fq.tensor(z, device)
        )

    def to_affine_host(self, p: PointVec) -> list[AffinePoint]:
        """Device batch -> host affine points. Unless every Z is one or
        zero (every decoded point's is), the batch is normalised on the
        device first (`normalize`: one batched inversion); the coordinates
        leave Montgomery form on the device (one product each)."""
        one = (1,) + (0,) * (self.field.degree - 1)

        def host(v):  # standard-form coefficients -> a host field element
            return self.spec.fp(v[0]) if self.field.degree == 1 else self.spec.g2_field(v)

        zs = self._std_to_coeffs(self.fq.from_mont(p["z"]))
        x, y = p["x"], p["y"]
        if not all(z == one or not any(z) for z in zs):
            x, y, _ = self.normalize(p)
        xs, ys = (self._std_to_coeffs(self.fq.from_mont(v)) for v in (x, y))
        return [AffinePoint(host(x), host(y)) if any(z) else INFINITY for x, y, z in zip(xs, ys, zs)]

    def _std_to_coeffs(self, arr: torch.Tensor) -> list[tuple]:
        """Standard-form limb planes (L[, d], B) -> list of int tuples."""
        a = arr.cpu().numpy()
        L, deg = a.shape[0], self.field.degree
        # (L, d, B) -> (B, d, L) rows, point-major
        flat = a.reshape(L, deg, -1).transpose(2, 1, 0).reshape(-1, L)
        ints = limbs_batch_to_ints(flat)
        return [tuple(ints[i * deg : (i + 1) * deg]) for i in range(len(ints) // deg)]

    # -- group law ---------------------------------------------------------
    def _group_kernel(self):
        """The K2 wrapper of this group, or None where the stacked law runs."""
        if not self.use_group_kernel:
            return None
        from .cuda_group import group_ops_for

        return group_ops_for(self.spec.name, self.group_name)

    def add(self, p: PointVec, q: PointVec) -> PointVec:
        """Complete addition: one K2 launch on Fq coordinates with a = 0 (its
        plain version on CPU tensors), else the stacked law (K5 rounds).
        Batch shapes broadcast."""
        k2 = self._group_kernel()
        if k2 is not None:
            return k2.add(p, q)
        return self._add_law(p, q)

    def double(self, p: PointVec) -> PointVec:
        """Complete doubling: one K2 launch where it applies, else the
        stacked law."""
        k2 = self._group_kernel()
        if k2 is not None:
            return k2.double(p)
        return self._double_law(p)

    def _add_law(self, p: PointVec, q: PointVec) -> PointVec:
        """RCB complete addition in three stacked multiplication rounds
        (Alg. 7 for a = 0, Alg. 1 otherwise)."""
        F = self.field
        X1, Y1, Z1, X2, Y2, Z2 = torch.broadcast_tensors(p["x"], p["y"], p["z"], q["x"], q["y"], q["z"])

        # round 0: the six symmetric products (the three pair sums of each
        # operand come from one stacked addition)
        ax = 1 if F.degree == 1 else 2  # the stack axis
        sums = F.add(F.stack([X1, X1, Y1, X2, X2, Y2]), F.stack([Y1, Z1, Z1, Y2, Z2, Z2]))
        U = torch.cat([F.stack([X1, Y1, Z1]), F.unstack(sums, slice(0, 3))], dim=ax)
        V = torch.cat([F.stack([X2, Y2, Z2]), F.unstack(sums, slice(3, 6))], dim=ax)
        W = F.mul_stacked(U, V, _ID6, F.prod_nprod)
        t0, t1, t2 = (F.unstack(W, i) for i in range(3))
        # X1Y2+X2Y1, X1Z2+X2Z1, Y1Z2+Y2Z1
        cross = F.sub(F.unstack(W, slice(3, 6)), F.add(F.stack([t0, t0, t1]), F.stack([t1, t2, t2])))
        t3, t4, t5 = (F.unstack(cross, i) for i in range(3))

        if self.a_is_zero:
            # round 1: constant products with 3b
            st = F.stack([t2, t4])
            m = F.mul_stacked(self._const("b3_np", st).expand_as(st), st, _ID2, F.prod_nprod)
            Z3_, t4b = F.unstack(m, 0), F.unstack(m, 1)
            t1n = F.add(F.add(t0, t0), t0)  # 3 X1X2
        else:
            # round 1: constant products, 3-group weighted merge
            a_c, b3, na2 = (self._const(n, X1).expand_as(X1) for n in ("a_np", "b3_np", "neg_a2_np"))
            consts = F.stack([a_c, b3, b3, a_c, na2, a_c])
            opnds = F.stack([t4, t2, t4, t0, t2, t2])
            mr = F.mul_stacked(
                consts, opnds,
                ((1, 1, 0, 0, 0, 0), (0, 0, 1, 1, 1, 0), (0, 0, 0, 0, 0, 1)),
                3 * F.prod_nprod,
            )
            Z3_ = F.unstack(mr, 0)  # a t4 + 3b Z1Z2
            t4b = F.unstack(mr, 1)  # 3b t4 + a(X1X2 - a Z1Z2)
            t1n = F.add(F.add(F.add(t0, t0), t0), F.unstack(mr, 2))  # 3X1X2 + a Z1Z2
        X3_ = F.sub(t1, Z3_)
        Z3p = F.add(t1, Z3_)

        # round 2: six products merged pairwise under one reduction each
        A = F.stack([X3_, t1n, t3, F.neg(t5), t5, t3])
        Bv = F.stack([Z3p, t4b, X3_, t4b, Z3p, t1n])
        R = F.mul_stacked(A, Bv, _PAIRS3, 2 * F.prod_nprod)
        return PointVec(x=F.unstack(R, 1), y=F.unstack(R, 0), z=F.unstack(R, 2))

    def _double_law(self, p: PointVec) -> PointVec:
        """Complete doubling. For a = 0 the dedicated RCB doubling (Alg. 9):
        9 products in three stacked rounds (two where |3b| folds into round 0
        as a weight). a != 0 is add(p, p)."""
        if not self.a_is_zero:
            return self._add_law(p, p)
        F = self.field
        X, Y, Z = p["x"], p["y"], p["z"]
        U = F.stack([Y, Y, X, Z])
        if self._b3_small is not None:
            # fold c = 3b Z^2 into round 0 — as a column weight on the Z*Z
            # stack when w N < R (the REDC bound), else by pre-scaling one
            # operand; either way the 3b round disappears
            w, negate = self._b3_small
            if w * self.spec.q < self.fq.spec.mont_r_pow:
                wts = ((1, 0, 0, 0), (0, 1, 0, 0), (0, 0, 1, 0), (0, 0, 0, w))
                W = F.mul_stacked(U, F.stack([Y, Z, Y, Z]), wts, w * F.prod_nprod)
            else:
                W = F.mul_stacked(U, F.stack([Y, Z, Y, F.mul_small(Z, w)]), _ID4, F.prod_nprod)
            t0, t1, m3, c = (F.unstack(W, i) for i in range(4))
            if negate:
                c = F.neg(c)
        else:
            # round 0: t0=Y^2, t1=YZ, m3=XY, t2=Z^2; round 1: c = 3b Z^2
            W = F.mul_stacked(U, F.stack([Y, Z, Y, Z]), _ID4, F.prod_nprod)
            t0, t1, m3, t2 = (F.unstack(W, i) for i in range(4))
            st = F.stack([t2])
            c = F.unstack(F.mul_stacked(self._const("b3_np", st).expand_as(st), st, ((1,),), F.prod_nprod), 0)
        z3a = F.mul_small(t0, 8)
        t0p = F.sub(t0, F.mul_small(c, 3))
        y3sum = F.add(t0, c)
        # round 2: X3=c*z3a, Z3=t1*z3a, Y3a=t0p*y3sum, X3b=t0p*m3
        W2 = F.mul_stacked(F.stack([c, t1, t0p, t0p]), F.stack([z3a, z3a, y3sum, m3]), _ID4, F.prod_nprod)
        x3, z3, y3a, x3b = (F.unstack(W2, i) for i in range(4))
        xy = F.add(F.stack([x3b, x3]), F.stack([x3b, y3a]))
        return PointVec(x=F.unstack(xy, 0), y=F.unstack(xy, 1), z=z3)

    def neg(self, p: PointVec) -> PointVec:
        return PointVec(x=p["x"], y=self.field.neg(p["y"]), z=p["z"])

    def eq_projective(self, p: PointVec, q: PointVec) -> torch.Tensor:
        """Projective equality mask: X1 Z2 == X2 Z1 and Y1 Z2 == Y2 Z1
        (two stacked rounds, K5 on the card). Infinity (Z = 0) equals only
        infinity."""
        F = self.field
        x = p["x"]
        U = F.stack([p["x"], p["y"]])
        V = F.stack([q["z"].expand_as(x)] * 2)
        U2 = F.stack([q["x"], q["y"]])
        V2 = F.stack([p["z"].expand_as(x)] * 2)
        A = F.mul_stacked(U, V, _ID2, F.prod_nprod)
        Bm = F.mul_stacked(U2, V2, _ID2, F.prod_nprod)
        both_inf = self.is_infinity(p) & self.is_infinity(q)
        coords_eq = F.eq(F.unstack(A, 0), F.unstack(Bm, 0)) & F.eq(F.unstack(A, 1), F.unstack(Bm, 1))
        return coords_eq | both_inf

    def select(self, cond, p: PointVec, q: PointVec) -> PointVec:
        F = self.field
        return PointVec({k: F.select(cond, p[k], q[k]) for k in ("x", "y", "z")})

    def is_infinity(self, p: PointVec):
        return self.field.is_zero(p["z"])

    # -- scalar multiplication --------------------------------------------
    def scalar_digits_msb(
        self, scalars_raw: torch.Tensor, w: int, nbits: int | None = None
    ) -> torch.Tensor:
        """(Ls, B) raw 16-bit limb scalars -> (nwin, B) w-bit digits, MSB
        first (w must divide LIMB_BITS). `nbits` bounds the scalar width
        (defaults to the full scalar-field width)."""
        assert LIMB_BITS % w == 0
        Ls, B = scalars_raw.shape
        per = LIMB_BITS // w
        shifts = (w * torch.arange(per, device=scalars_raw.device, dtype=scalars_raw.dtype))
        digs = (scalars_raw[:, None, :] >> shifts[None, :, None]) & ((1 << w) - 1)
        digs = digs.reshape(Ls * per, B)  # LSB-first digit order
        nwin = -(-(nbits if nbits is not None else self.scalar_bits) // w)
        return torch.flip(digs[:nwin], dims=(0,))

    def _window_table(self, p: PointVec) -> dict:
        """Stacked multiples table T[j] = j*P for j in [0, 2^w): coords
        (L[, d], 2^w, B)."""
        B = p["x"].shape[-1]
        rows = [self.infinity((B,), p["x"].device), p, self.double(p)]
        for _ in range(3, 1 << self.WINDOW):
            rows.append(self.add(rows[-1], p))
        return {k: torch.stack([r[k] for r in rows], dim=-2) for k in ("x", "y", "z")}

    def _select_entry(self, table_arr: dict, digit: torch.Tensor) -> PointVec:
        """Uniform-access table lookup: a one-hot contraction over all 2^w
        table rows (axis -2), so the memory access pattern does not depend
        on the (secret) digit."""
        rows = torch.arange(1 << self.WINDOW, device=digit.device, dtype=digit.dtype)
        oh = (digit[None, :] == rows[:, None]).to(torch.int32)  # (2^w, B)
        return PointVec({k: (arr * oh).sum(dim=-2, dtype=torch.int32) for k, arr in table_arr.items()})

    def _window_doubles(self, acc: PointVec, w: int) -> PointVec:
        for _ in range(w):
            acc = self.double(acc)
        return acc

    def scalar_mul_windowed(
        self, p: PointVec, scalars_raw: torch.Tensor, nbits: int | None = None
    ) -> PointVec:
        """Batched fixed-window scalar multiplication (w=4) over the RAW
        integer value of the scalars (no mod-r or subgroup assumptions —
        this is the ladder a Direct subgroup check must use). Every group
        operation is three K5 rounds on the card."""
        w = self.WINDOW
        digits = self.scalar_digits_msb(scalars_raw, w, nbits)
        table_arr = self._window_table(p)
        acc = self.infinity((scalars_raw.shape[-1],), scalars_raw.device)
        for digit in digits:
            acc = self._window_doubles(acc, w)
            acc = self.add(acc, self._select_entry(table_arr, digit))
        return acc

    def _fq_mul_planes(self, arr: torch.Tensor, const_np: np.ndarray, key) -> torch.Tensor:
        """Multiply every (extension-coefficient x stack) plane of
        `arr` (L, *mid, B) by a base-field constant: one K5 launch with
        identity weights over the flattened planes."""
        L, B = arr.shape[0], arr.shape[-1]
        S = math.prod(arr.shape[1:-1])
        if S == 0:
            return arr
        U = arr.reshape(L, S, B)
        V = self.fq.const_of(key, const_np, U).expand_as(U)
        return self.field.product(U, V, _identity_weights(S)).reshape(arr.shape)

    def endo(self, p: PointVec) -> PointVec:
        """Cube-root endomorphism phi(x, y) = (beta*x, y) on projective
        coordinates. beta is in Fq, so the multiply is coefficient-wise even
        on extension-field coordinates."""
        assert self.glv is not None
        x = self._fq_mul_planes(p["x"], self.beta_np, ("beta_np", self.spec.name, self.group_name))
        return PointVec(x=x, y=p["y"], z=p["z"])

    def scalar_mul(self, p: PointVec, scalars_raw: torch.Tensor) -> PointVec:
        """Batched scalar multiplication with the GLV fast path.

        GLV semantics: computes [k mod r]P assuming P lies in the order-r
        subgroup (where phi acts as [lambda]) — exactly the ceremony
        contract for batch_exp. Callers needing the raw integer ladder on
        arbitrary curve points (the Direct subgroup check multiplies by the
        group order itself!) must call scalar_mul_windowed.
        """
        if self.glv is None:
            return self.scalar_mul_windowed(p, scalars_raw)
        return self._scalar_mul_glv(p, scalars_raw)

    def _scalar_mul_glv(self, p: PointVec, scalars_raw: torch.Tensor) -> PointVec:
        """k*P = k1*(s1 P) + k2*(s2 phi(P)) with half-width k1, k2 from the
        lattice decomposition: ~half the doublings of the full-width ladder.
        The digits come from the digits kernel (K3) on the card. On Fq
        coordinates the whole ladder is one kernel (K4). On extension
        coordinates the ladder runs over the group law: the phi table comes
        from the P table with one coefficient-wise Fq multiply (phi is a
        homomorphism, so phi(j * s1 P) = j * s1 phi(P); a conditional
        y-negation fixes the sign where s1 != s2)."""
        from .cuda_glv import glv_digits_for

        d1, d2, neg1, flip = glv_digits_for(self.spec.name, self.group_name)(scalars_raw)
        if self.field.degree == 1:
            from .cuda_ladder import fused_ladder_for

            return fused_ladder_for(self.spec.name, self.group_name)(p, d1, d2, neg1, flip)
        return self._glv_ladder(p, d1, d2, neg1.bool(), flip.bool())

    def _glv_ladder(self, p: PointVec, d1, d2, neg1, flip) -> PointVec:
        """The windowed GLV ladder over the group law (the reference's
        non-fused branch, curve_jax.py:598-623)."""
        F = self.field
        t1 = self._window_table(self.select(neg1, self.neg(p), p))
        t2 = {
            "x": self._fq_mul_planes(t1["x"], self.beta_np, ("beta_np", self.spec.name, self.group_name)),
            "y": F.select(flip, F.neg(t1["y"]), t1["y"]),
            "z": t1["z"],
        }
        acc = self.infinity((p["x"].shape[-1],), p["x"].device)
        for k in range(d1.shape[0]):
            acc = self._window_doubles(acc, self.WINDOW)
            acc = self.add(acc, self._select_entry(t1, d1[k]))
            acc = self.add(acc, self._select_entry(t2, d2[k]))
        return acc

    # -- reductions --------------------------------------------------------
    def sum_reduce(self, p: PointVec) -> PointVec:
        """Tree-reduce a batch of points over the last axis to one point
        (last axis of size 1): lanes 2i and 2i+1 are added at every level,
        an odd last lane is carried up unchanged — the reference's pairing
        order, so the projective result is the reference's too."""
        n = p["x"].shape[-1]
        while n > 1:
            half = n // 2
            even = PointVec({k: v[..., 0 : 2 * half : 2] for k, v in p.items()})
            odd = PointVec({k: v[..., 1 : 2 * half : 2] for k, v in p.items()})
            merged = self.add(even, odd)
            if n % 2:
                merged = PointVec({k: torch.cat([merged[k], p[k][..., -1:]], dim=-1) for k in merged})
            p = merged
            n = half + (n % 2)
        return p

    def msm(self, p: PointVec, scalars_raw: torch.Tensor) -> PointVec:
        """Multi-scalar multiplication for subgroup points: the batched GLV
        scalar-mul, then the tree reduction."""
        return self.sum_reduce(self.scalar_mul(p, scalars_raw))

    # -- normalization -----------------------------------------------------
    def normalize(self, p: PointVec):
        """Projective -> affine using one batched inversion over the
        (flattened) batch axes. Returns (x, y, infinity_mask)."""
        F = self.field
        z = p["z"]
        el_ndim = 1 if F.degree == 1 else 2
        inv_z = _tree_batch_inv(F, z.reshape(*z.shape[:el_ndim], -1)).reshape(z.shape)
        return F.mul(p["x"], inv_z), F.mul(p["y"], inv_z), self.is_infinity(p)


@functools.lru_cache(maxsize=None)
def plain_group_law(ops: CurveOps) -> CurveOps:
    """A copy of `ops` whose field products are the plain version of the
    product's route (K5's by default; counted in that wrapper's
    `plain_calls`) and whose add / double are the stacked law on every
    group: the group law of every plain version, pure PyTorch on any
    device, never a kernel launch."""
    plain = copy.copy(ops)
    plain.field = copy.copy(ops.field)
    plain.field.product = ops.field.product.plain
    plain.use_group_kernel = False
    return plain


@functools.lru_cache(maxsize=None)
def _curve_ops(canonical_name: str, group: str) -> CurveOps:
    return CurveOps(get_curve(canonical_name), group)


def curve_ops(curve_name: str, group: str) -> CurveOps:
    """The one CurveOps of a (curve, group); aliases of a curve's name
    ("bw6", "bw6_761") share it."""
    return _curve_ops(get_curve(curve_name).name, group)
