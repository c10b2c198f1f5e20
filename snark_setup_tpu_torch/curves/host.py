"""Host-side exact elliptic curve arithmetic (affine, Python ints).

Oracle + protocol-layer curve math; the batch hot paths live on device
(snark_setup_tpu_torch.ops). Coordinates are host field elements (Fp/Fp2/Fp3).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields.host import Fp
from .constants import CurveSpec, GroupSpec


@dataclass(frozen=True)
class AffinePoint:
    """Affine point or infinity (x=y=None). Coordinates are field elements."""

    x: object
    y: object

    @property
    def is_infinity(self) -> bool:
        return self.x is None

    def __eq__(self, other):
        return self.x == other.x and self.y == other.y

    def __hash__(self):
        return hash((self.x, self.y))


INFINITY = AffinePoint(None, None)


class HostCurve:
    """One source group (G1 or G2) with exact host arithmetic."""

    def __init__(self, spec: CurveSpec, group: GroupSpec):
        self.spec = spec
        self.group = group
        self.a = spec.g2_field(group.a) if group.field_kind != "fp" else spec.fp(group.a[0])
        self.b = spec.g2_field(group.b) if group.field_kind != "fp" else spec.fp(group.b[0])
        if group.field_kind == "fp":
            gx, gy = spec.fp(group.gen_x[0]), spec.fp(group.gen_y[0])
        else:
            gx, gy = spec.g2_field(group.gen_x), spec.g2_field(group.gen_y)
        self.generator = AffinePoint(gx, gy)
        self.r = spec.r
        self.cofactor = group.cofactor

    # -- basic ops --------------------------------------------------------
    def is_on_curve(self, p: AffinePoint) -> bool:
        if p.is_infinity:
            return True
        lhs = p.y * p.y
        rhs = p.x * p.x * p.x + self.a * p.x + self.b
        return lhs == rhs

    def in_subgroup(self, p: AffinePoint) -> bool:
        return self.mul(p, self.r).is_infinity

    def neg(self, p: AffinePoint) -> AffinePoint:
        if p.is_infinity:
            return p
        return AffinePoint(p.x, -p.y)

    def add(self, p1: AffinePoint, p2: AffinePoint) -> AffinePoint:
        if p1.is_infinity:
            return p2
        if p2.is_infinity:
            return p1
        if p1.x == p2.x:
            if (p1.y + p2.y).is_zero():
                return INFINITY
            lam = (p1.x * p1.x * 3 + self.a) * (p1.y * 2).inverse()
        else:
            lam = (p2.y - p1.y) * (p2.x - p1.x).inverse()
        x3 = lam * lam - p1.x - p2.x
        y3 = lam * (p1.x - x3) - p1.y
        return AffinePoint(x3, y3)

    def double(self, p: AffinePoint) -> AffinePoint:
        return self.add(p, p)

    def mul(self, p: AffinePoint, k: int) -> AffinePoint:
        if k < 0:
            return self.mul(self.neg(p), -k)
        acc = INFINITY
        add = p
        while k > 0:
            if k & 1:
                acc = self.add(acc, add)
            add = self.add(add, add)
            k >>= 1
        return acc

    def clear_cofactor(self, p: AffinePoint) -> AffinePoint:
        return self.mul(p, self.cofactor)

    def solve_y(self, x) -> object | None:
        """Return one square root of x^3 + a x + b, or None."""
        rhs = x * x * x + self.a * x + self.b
        if isinstance(rhs, Fp):
            return rhs.sqrt()
        return rhs.sqrt()

    def get_point_from_x(self, x, greatest: bool) -> AffinePoint | None:
        """arkworks get_point_from_x_unchecked semantics: solve y, then pick
        the lexicographically larger root iff `greatest`."""
        y = self.solve_y(x)
        if y is None:
            return None
        neg_y = -y
        larger, smaller = (y, neg_y) if y.is_geq_neg() else (neg_y, y)
        return AffinePoint(x, larger if greatest else smaller)

    def msm(self, points, scalars) -> AffinePoint:
        """Host MSM (double-and-add per element; oracle use only)."""
        acc = INFINITY
        for p, s in zip(points, scalars):
            acc = self.add(acc, self.mul(p, s))
        return acc


def g1_curve(spec: CurveSpec) -> HostCurve:
    return HostCurve(spec, spec.g1)


def g2_curve(spec: CurveSpec) -> HostCurve:
    return HostCurve(spec, spec.g2)
