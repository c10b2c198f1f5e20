"""Generic extension-field tower contexts (host side) for pairings.

Elements are nested tuples of ints; a context object provides the ring ops.
This representation is allocation-light and lets one Tate-pairing
implementation serve all five ceremony curves (BLS12-377/381 with k=12,
BW6-761 with k=6 over Fp, MNT4-753 k=4, MNT6-753 k=6).
"""

from __future__ import annotations


class PrimeCtx:
    """Fp: elements are ints."""

    def __init__(self, p: int):
        self.p = p
        self.degree_over_fp = 1

    def zero(self):
        return 0

    def one(self):
        return 1

    def add(self, a, b):
        return (a + b) % self.p

    def sub(self, a, b):
        return (a - b) % self.p

    def neg(self, a):
        return (-a) % self.p

    def mul(self, a, b):
        return a * b % self.p

    def square(self, a):
        return a * a % self.p

    def inv(self, a):
        return pow(a, -1, self.p)

    def is_zero(self, a):
        return a % self.p == 0

    def eq(self, a, b):
        return (a - b) % self.p == 0

    def mul_small(self, a, k: int):
        return a * k % self.p


class QuadCtx:
    """base[w]/(w^2 - nr): elements are (c0, c1) over base."""

    def __init__(self, base, nr):
        self.base = base
        self.nr = nr
        self.degree_over_fp = 2 * base.degree_over_fp

    def zero(self):
        return (self.base.zero(), self.base.zero())

    def one(self):
        return (self.base.one(), self.base.zero())

    def embed(self, c0):
        """Lift a base element."""
        return (c0, self.base.zero())

    def add(self, a, b):
        return (self.base.add(a[0], b[0]), self.base.add(a[1], b[1]))

    def sub(self, a, b):
        return (self.base.sub(a[0], b[0]), self.base.sub(a[1], b[1]))

    def neg(self, a):
        return (self.base.neg(a[0]), self.base.neg(a[1]))

    def mul(self, a, b):
        B = self.base
        v0 = B.mul(a[0], b[0])
        v1 = B.mul(a[1], b[1])
        c0 = B.add(v0, B.mul(self.nr, v1))
        c1 = B.sub(B.sub(B.mul(B.add(a[0], a[1]), B.add(b[0], b[1])), v0), v1)
        return (c0, c1)

    def square(self, a):
        return self.mul(a, a)

    def inv(self, a):
        B = self.base
        norm = B.sub(B.mul(a[0], a[0]), B.mul(self.nr, B.mul(a[1], a[1])))
        ninv = B.inv(norm)
        return (B.mul(a[0], ninv), B.neg(B.mul(a[1], ninv)))

    def is_zero(self, a):
        return self.base.is_zero(a[0]) and self.base.is_zero(a[1])

    def eq(self, a, b):
        return self.base.eq(a[0], b[0]) and self.base.eq(a[1], b[1])

    def mul_base(self, a, c):
        """Multiply by a base-field element."""
        return (self.base.mul(a[0], c), self.base.mul(a[1], c))


class CubicCtx:
    """base[w]/(w^3 - nr): elements are (c0, c1, c2) over base."""

    def __init__(self, base, nr):
        self.base = base
        self.nr = nr
        self.degree_over_fp = 3 * base.degree_over_fp

    def zero(self):
        z = self.base.zero()
        return (z, z, z)

    def one(self):
        z = self.base.zero()
        return (self.base.one(), z, z)

    def embed(self, c0):
        z = self.base.zero()
        return (c0, z, z)

    def add(self, a, b):
        B = self.base
        return (B.add(a[0], b[0]), B.add(a[1], b[1]), B.add(a[2], b[2]))

    def sub(self, a, b):
        B = self.base
        return (B.sub(a[0], b[0]), B.sub(a[1], b[1]), B.sub(a[2], b[2]))

    def neg(self, a):
        B = self.base
        return (B.neg(a[0]), B.neg(a[1]), B.neg(a[2]))

    def mul(self, a, b):
        B = self.base
        v0 = B.mul(a[0], b[0])
        v1 = B.mul(a[1], b[1])
        v2 = B.mul(a[2], b[2])
        t0 = B.sub(B.sub(B.mul(B.add(a[1], a[2]), B.add(b[1], b[2])), v1), v2)
        c0 = B.add(v0, B.mul(self.nr, t0))
        t1 = B.sub(B.sub(B.mul(B.add(a[0], a[1]), B.add(b[0], b[1])), v0), v1)
        c1 = B.add(t1, B.mul(self.nr, v2))
        t2 = B.sub(B.sub(B.mul(B.add(a[0], a[2]), B.add(b[0], b[2])), v0), v2)
        c2 = B.add(t2, v1)
        return (c0, c1, c2)

    def square(self, a):
        return self.mul(a, a)

    def inv(self, a):
        B = self.base
        nr = self.nr
        t0 = B.sub(B.mul(a[0], a[0]), B.mul(nr, B.mul(a[1], a[2])))
        t1 = B.sub(B.mul(nr, B.mul(a[2], a[2])), B.mul(a[0], a[1]))
        t2 = B.sub(B.mul(a[1], a[1]), B.mul(a[0], a[2]))
        norm = B.add(
            B.mul(a[0], t0),
            B.mul(nr, B.add(B.mul(a[2], t1), B.mul(a[1], t2))),
        )
        ninv = B.inv(norm)
        return (B.mul(t0, ninv), B.mul(t1, ninv), B.mul(t2, ninv))

    def is_zero(self, a):
        return all(self.base.is_zero(c) for c in a)

    def eq(self, a, b):
        return all(self.base.eq(x, y) for x, y in zip(a, b))

    def mul_base(self, a, c):
        B = self.base
        return (B.mul(a[0], c), B.mul(a[1], c), B.mul(a[2], c))


def ctx_pow(ctx, a, e: int):
    if e < 0:
        a = ctx.inv(a)
        e = -e
    result = ctx.one()
    base = a
    while e > 0:
        if e & 1:
            result = ctx.mul(result, base)
        base = ctx.square(base)
        e >>= 1
    return result
