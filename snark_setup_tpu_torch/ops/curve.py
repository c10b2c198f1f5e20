"""Batched elliptic-curve group law on device — complete projective formulas.

Scope of this module today: source groups whose coordinates live in the base
field Fq (degree 1) on curves with a = 0 — G1 of BLS12-377/381 and both
groups of BW6-761. Anything else raises NotImplementedError naming the
ROADMAP item that brings it.

Design:
- Limbs-leading layout (fp.py): coordinates are (L, B) int32 limb planes with
  the batch axis last; a point batch is a `PointVec` dict of x, y, z.
- Renes–Costello–Batina *complete* formulas (eprint 2015/1060, Algorithm 7
  for addition and Algorithm 9 for doubling, both a = 0): branch-free, they
  handle doubling and infinity uniformly. Infinity is (0 : 1 : 0).
  Independent products of one formula are stacked on an extra batch axis so a
  group operation is three wide multiplications instead of fourteen narrow
  ones (eager PyTorch is launch-bound at small widths).
- `scalar_mul` is the GLV path ([k mod r]P, subgroup points only): digit
  extraction and the whole windowed ladder are the two CUDA kernels
  (cuda_glv.py, cuda_ladder.py) for tensors on the card and their plain
  PyTorch versions for tensors on the CPU. `scalar_mul_windowed` is the raw
  integer ladder that makes no subgroup assumption.

Every field op returns canonical values, so the projective coordinates these
functions return equal the reference's limb for limb.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..curves.constants import CurveSpec, get_curve
from ..curves.host import AffinePoint, INFINITY, g1_curve, g2_curve
from ..fields.limb import LIMB_BITS, limbs_batch_to_ints
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


class CurveOps:
    """Group-law ops for one source group of one curve."""

    WINDOW = 4

    def __init__(self, spec: CurveSpec, group: str):
        self.spec = spec
        self.group_name = group
        gspec = spec.g1 if group == "g1" else spec.g2
        self.gspec = gspec
        if gspec.field_kind != "fp":
            raise NotImplementedError(
                f"{spec.name} {group} has {gspec.field_kind} coordinates: the "
                "extension towers and their stacked-product kernel are not "
                "ported yet (ROADMAP Queue A, 'ext towers + K5')"
            )
        if any(v != 0 for v in gspec.a):
            raise NotImplementedError(
                f"{spec.name} {group} has a != 0: the generic complete "
                "addition is not ported yet (ROADMAP Queue A, 'MNT curves')"
            )
        self.a_is_zero = True
        self.fq = fp_ops(spec.q)
        self.field = make_field_ops(self.fq, 1, 0)
        self.host_curve = g1_curve(spec) if group == "g1" else g2_curve(spec)
        b = gspec.b[0]
        self.b_np = self.field.from_coeffs([b])
        b3i = 3 * b % spec.q
        self.b3_np = self.field.from_coeffs([b3i])
        # |3b| as a small integer where the curve allows it (b in {1, -1, 4}
        # for every group in scope): the ladder kernel replaces the 3b
        # products by short addition chains. (|w|, negate) or None.
        self._b3_small = None
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
            self.beta_np = self.fq.from_int(params.beta)[:, None]

    def _const(self, name: str, like: torch.Tensor) -> torch.Tensor:
        """b_np / b3_np / beta_np as a tensor broadcastable against `like`."""
        key = (name, self.spec.name, self.group_name)
        return self.fq.const_of(key, getattr(self, name), like)

    # -- constructors ------------------------------------------------------
    def infinity(self, shape, device) -> PointVec:
        return PointVec(
            x=self.field.zeros(shape, device),
            y=self.field.ones(shape, device),
            z=self.field.zeros(shape, device),
        )

    def from_affine_host(self, points: list[AffinePoint], device) -> PointVec:
        """Host affine points -> projective batch on `device`."""
        xs, ys, infs = [], [], []
        for p in points:
            inf = p.is_infinity
            xs.append(0 if inf else p.x.v)
            ys.append(1 if inf else p.y.v)
            infs.append(inf)
        inf_mask = np.array(infs, bool)
        x = self.fq.from_int(xs)
        y = self.fq.from_int(ys)
        z = np.where(inf_mask, 0, np.broadcast_to(self.fq.one_mont_np, x.shape))
        return PointVec(
            x=self.fq.tensor(x, device), y=self.fq.tensor(y, device), z=self.fq.tensor(z, device)
        )

    def to_affine_host(self, p: PointVec) -> list[AffinePoint]:
        """Device batch -> host affine points (batch-inverts Z on device)."""
        x, y, inf = self.normalize(p)
        xs = self._std_to_ints(self.fq.from_mont(x))
        ys = self._std_to_ints(self.fq.from_mont(y))
        out = []
        for vx, vy, isinf in zip(xs, ys, inf.cpu().numpy().reshape(-1)):
            out.append(INFINITY if isinf else AffinePoint(self.spec.fp(vx), self.spec.fp(vy)))
        return out

    def _std_to_ints(self, arr: torch.Tensor) -> list[int]:
        """Standard-form limb planes (L, B) -> list of ints."""
        a = arr.cpu().numpy()
        return limbs_batch_to_ints(a.reshape(a.shape[0], -1).T)

    # -- group law ---------------------------------------------------------
    def add(self, p: PointVec, q: PointVec) -> PointVec:
        """RCB complete addition (Alg. 7, a = 0) in three stacked
        multiplication rounds: 14 products, 9 reductions."""
        F = self.field
        X1, Y1, Z1 = p["x"], p["y"], p["z"]
        X2, Y2, Z2 = q["x"], q["y"], q["z"]

        # round 0: the six symmetric products (the three pair sums of each
        # operand come from one stacked addition)
        sums = F.add(F.stack([X1, X1, Y1, X2, X2, Y2]), F.stack([Y1, Z1, Z1, Y2, Z2, Z2]))
        U = torch.cat([F.stack([X1, Y1, Z1]), sums[:, 0:3]], dim=1)
        V = torch.cat([F.stack([X2, Y2, Z2]), sums[:, 3:6]], dim=1)
        W = F.mul(U, V)
        t0, t1, t2 = W[:, 0], W[:, 1], W[:, 2]
        cross = F.sub(W[:, 3:6], F.add(F.stack([t0, t0, t1]), F.stack([t1, t2, t2])))
        t3, t4, t5 = cross[:, 0], cross[:, 1], cross[:, 2]  # X1Y2+X2Y1, X1Z2+X2Z1, Y1Z2+Y2Z1

        # round 1: constant products with 3b
        st = F.stack([t2, t4])
        m = F.mul(self._const("b3_np", st), st)
        Z3_, t4b = m[:, 0], m[:, 1]
        t1n = F.add(F.add(t0, t0), t0)  # 3 X1X2
        X3_ = F.sub(t1, Z3_)
        Z3p = F.add(t1, Z3_)

        # round 2: six products merged pairwise under one reduction each
        # (two products share a REDC: valid while 2N < R)
        A = F.stack([X3_, t1n, t3, F.neg(t5), t5, t3])
        Bv = F.stack([Z3p, t4b, X3_, t4b, Z3p, t1n])
        cols = F.prod_cols(A, Bv)
        R = F.redc(cols[:, 0::2] + cols[:, 1::2], 2)
        return PointVec(x=R[:, 1], y=R[:, 0], z=R[:, 2])

    def double(self, p: PointVec) -> PointVec:
        """Dedicated RCB doubling (Alg. 9, a = 0): 9 products in three
        stacked rounds."""
        F = self.field
        X, Y, Z = p["x"], p["y"], p["z"]
        # round 0: t0=Y^2, t1=YZ, m3=XY, t2=Z^2
        W = F.mul(F.stack([Y, Y, X, Z]), F.stack([Y, Z, Y, Z]))
        t0, t1, m3, t2 = W[:, 0], W[:, 1], W[:, 2], W[:, 3]
        # round 1: c = 3b * Z^2
        c = F.mul(self._const("b3_np", t2), t2)
        # 8 t0 and 3 c by doubling chains, the two chains stacked
        d = F.add(F.stack([t0, c]), F.stack([t0, c]))  # 2 t0, 2 c
        d = F.add(d, F.stack([d[:, 0], c]))  # 4 t0, 3 c
        z3a = F.add(d[:, 0], d[:, 0])
        t0p = F.sub(t0, d[:, 1])
        y3sum = F.add(t0, c)
        # round 2: X3=c*z3a, Z3=t1*z3a, Y3a=t0p*y3sum, X3b=t0p*m3
        W2 = F.mul(F.stack([c, t1, t0p, t0p]), F.stack([z3a, z3a, y3sum, m3]))
        x3, z3, y3a, x3b = W2[:, 0], W2[:, 1], W2[:, 2], W2[:, 3]
        xy = F.add(F.stack([x3b, x3]), F.stack([x3b, y3a]))
        return PointVec(x=xy[:, 0], y=xy[:, 1], z=z3)

    def neg(self, p: PointVec) -> PointVec:
        return PointVec(x=p["x"], y=self.field.neg(p["y"]), z=p["z"])

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
        (L, 2^w, B)."""
        B = p["x"].shape[-1]
        rows = [self.infinity((B,), p["x"].device), p, self.double(p)]
        for _ in range(3, 1 << self.WINDOW):
            rows.append(self.add(rows[-1], p))
        return {k: torch.stack([r[k] for r in rows], dim=1) for k in ("x", "y", "z")}

    def _select_entry(self, table_arr: dict, digit: torch.Tensor) -> PointVec:
        """Uniform-access table lookup: a one-hot contraction over all 2^w
        table rows (axis 1), so the memory access pattern does not depend
        on the (secret) digit."""
        rows = torch.arange(1 << self.WINDOW, device=digit.device, dtype=digit.dtype)
        oh = (digit[None, :] == rows[:, None]).to(torch.int32)  # (2^w, B)
        return PointVec({k: (arr * oh[None]).sum(dim=1, dtype=torch.int32) for k, arr in table_arr.items()})

    def _window_doubles(self, acc: PointVec, w: int) -> PointVec:
        for _ in range(w):
            acc = self.double(acc)
        return acc

    def scalar_mul_windowed(
        self, p: PointVec, scalars_raw: torch.Tensor, nbits: int | None = None
    ) -> PointVec:
        """Batched fixed-window scalar multiplication (w=4) over the RAW
        integer value of the scalars (no mod-r or subgroup assumptions —
        this is the ladder a Direct subgroup check must use). Plain PyTorch
        on whatever device the tensors are on."""
        w = self.WINDOW
        digits = self.scalar_digits_msb(scalars_raw, w, nbits)
        table_arr = self._window_table(p)
        acc = self.infinity((scalars_raw.shape[-1],), scalars_raw.device)
        for digit in digits:
            acc = self._window_doubles(acc, w)
            acc = self.add(acc, self._select_entry(table_arr, digit))
        return acc

    def endo(self, p: PointVec) -> PointVec:
        """Cube-root endomorphism phi(x, y) = (beta*x, y) on projective
        coordinates."""
        assert self.glv is not None
        x = self.fq.mont_mul(p["x"], self._const("beta_np", p["x"]))
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
        Two launches on the card: the digits kernel, then the whole-ladder
        kernel; on CPU tensors the wrappers run their plain versions."""
        from .cuda_glv import glv_digits_for
        from .cuda_ladder import fused_ladder_for

        d1, d2, neg1, flip = glv_digits_for(self.spec.name, self.group_name)(scalars_raw)
        return fused_ladder_for(self.spec.name, self.group_name)(p, d1, d2, neg1, flip)

    # -- normalization -----------------------------------------------------
    def normalize(self, p: PointVec):
        """Projective -> affine using one batched inversion over the
        (flattened) batch axes. Returns (x, y, infinity_mask)."""
        F = self.field
        z = p["z"]
        inv_z = _tree_batch_inv(F, z.reshape(z.shape[0], -1)).reshape(z.shape)
        return F.mul(p["x"], inv_z), F.mul(p["y"], inv_z), self.is_infinity(p)


@functools.lru_cache(maxsize=None)
def _curve_ops(canonical_name: str, group: str) -> CurveOps:
    return CurveOps(get_curve(canonical_name), group)


def curve_ops(curve_name: str, group: str) -> CurveOps:
    """The one CurveOps of a (curve, group); aliases of a curve's name
    ("bw6", "bw6_761") share it."""
    return _curve_ops(get_curve(curve_name).name, group)
