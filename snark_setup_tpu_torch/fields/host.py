"""Host-side exact field arithmetic (Python ints).

This is the bit-exactness layer: it backs serialization, transcript
operations, pairings, and serves as the oracle the device limb kernels are
validated against. The device hot path lives in snark_setup_tpu_torch.ops; this
module is deliberately simple and exact.

Replaces the role of ark-ff (reference L1, SURVEY.md §1) for host-side work.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass


def tonelli_shanks_sqrt(a: int, p: int) -> int | None:
    """Square root mod odd prime p, or None if a is a non-residue."""
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    # Tonelli-Shanks
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    # find a non-residue z
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        # find least i, 0 < i < m, with t^(2^i) == 1
        i, t2 = 0, t
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t = t * c % p
        r = r * b % p
    return r


@dataclass(frozen=True)
class FieldSpec:
    """A prime field's static data, including its Montgomery parameters.

    The Montgomery radix matches arkworks' 64-bit-limb layout (R = 2^{64*n}),
    which matters because arkworks' `Fp::rand` interprets raw sampled limbs as
    the Montgomery representation (see transcript/arkrand.py).
    """

    modulus: int
    name: str = "Fp"

    @property
    def bit_size(self) -> int:
        return self.modulus.bit_length()

    @property
    def limbs64(self) -> int:
        """Number of 64-bit limbs in the arkworks BigInt representation."""
        return (self.bit_size + 63) // 64

    @property
    def byte_size(self) -> int:
        """Serialized size: ceil(bits/8), matching ark-serialize 0.4."""
        return (self.bit_size + 7) // 8

    @property
    def mont_r(self) -> int:
        return pow(2, 64 * self.limbs64, self.modulus)

    @property
    def mont_r_inv(self) -> int:
        return pow(self.mont_r, -1, self.modulus)

    @property
    def shave_bits(self) -> int:
        """Unused top bits in the 64-bit-limb repr (ark num_bits_to_shave)."""
        return 64 * self.limbs64 - self.bit_size

    def to_mont(self, a: int) -> int:
        return a * self.mont_r % self.modulus

    def from_mont(self, a: int) -> int:
        return a * self.mont_r_inv % self.modulus


class Fp:
    """Element of a prime field; thin wrapper used by tower fields & pairings.

    Values are stored as plain ints in standard (non-Montgomery) form.
    """

    __slots__ = ("v", "p")

    def __init__(self, v: int, p: int):
        self.v = v % p
        self.p = p

    def __add__(self, o):
        return Fp(self.v + o.v, self.p)

    def __sub__(self, o):
        return Fp(self.v - o.v, self.p)

    def __neg__(self):
        return Fp(-self.v, self.p)

    def __mul__(self, o):
        if isinstance(o, int):
            return Fp(self.v * o, self.p)
        return Fp(self.v * o.v, self.p)

    __rmul__ = __mul__

    def __eq__(self, o):
        return isinstance(o, Fp) and self.v == o.v and self.p == o.p

    def __hash__(self):
        return hash((self.v, self.p))

    def __repr__(self):
        return f"Fp(0x{self.v:x})"

    def is_zero(self) -> bool:
        return self.v == 0

    def inverse(self):
        return Fp(pow(self.v, -1, self.p), self.p)

    def square(self):
        return Fp(self.v * self.v, self.p)

    def pow(self, e: int):
        return Fp(pow(self.v, e, self.p), self.p)

    def sqrt(self):
        r = tonelli_shanks_sqrt(self.v, self.p)
        return None if r is None else Fp(r, self.p)

    def legendre(self) -> int:
        ls = pow(self.v, (self.p - 1) // 2, self.p)
        return -1 if ls == self.p - 1 else ls

    def is_geq_neg(self) -> bool:
        """True if self > -self lexicographically (arkworks 'largest' /
        y-is-negative flag semantics for prime fields)."""
        return self.v > (self.p - self.v) % self.p


class _ExtBase:
    """Shared helpers for quadratic/cubic extensions over some base field.

    `coeffs` is a tuple of base-field elements c0..c{d-1} representing
    c0 + c1*u + ... ; `nr` is the non-residue with u^d = nr.
    """

    __slots__ = ("coeffs", "nr")

    def __init__(self, coeffs, nr):
        self.coeffs = tuple(coeffs)
        self.nr = nr

    def __eq__(self, o):
        return type(self) is type(o) and self.coeffs == o.coeffs

    def __hash__(self):
        return hash((type(self).__name__, self.coeffs))

    def __add__(self, o):
        return type(self)([a + b for a, b in zip(self.coeffs, o.coeffs)], self.nr)

    def __sub__(self, o):
        return type(self)([a - b for a, b in zip(self.coeffs, o.coeffs)], self.nr)

    def __neg__(self):
        return type(self)([-a for a in self.coeffs], self.nr)

    def is_zero(self):
        return all(c.is_zero() for c in self.coeffs)

    def scalar_mul(self, k: int):
        return type(self)([c * k for c in self.coeffs], self.nr)

    def pow(self, e: int):
        result = self.one_like()
        base = self
        while e > 0:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def square(self):
        return self * self

    def __repr__(self):
        return f"{type(self).__name__}{self.coeffs}"


class Fp2(_ExtBase):
    """Quadratic extension: c0 + c1*u with u^2 = nr."""

    def one_like(self):
        c0 = self.coeffs[0]
        return Fp2([Fp(1, c0.p), Fp(0, c0.p)], self.nr)

    def zero_like(self):
        c0 = self.coeffs[0]
        return Fp2([Fp(0, c0.p), Fp(0, c0.p)], self.nr)

    def __mul__(self, o):
        if isinstance(o, (int, Fp)):
            return Fp2([c * o for c in self.coeffs], self.nr)
        a0, a1 = self.coeffs
        b0, b1 = o.coeffs
        # Karatsuba
        v0 = a0 * b0
        v1 = a1 * b1
        c0 = v0 + self.nr * v1
        c1 = (a0 + a1) * (b0 + b1) - v0 - v1
        return Fp2([c0, c1], self.nr)

    __rmul__ = __mul__

    def inverse(self):
        a0, a1 = self.coeffs
        norm = a0 * a0 - self.nr * (a1 * a1)
        ninv = norm.inverse()
        return Fp2([a0 * ninv, -(a1 * ninv)], self.nr)

    def conjugate(self):
        a0, a1 = self.coeffs
        return Fp2([a0, -a1], self.nr)

    def frobenius(self, frob_c1):
        """frob_c1 = nr^((p-1)/2) (an Fp element)."""
        a0, a1 = self.coeffs
        return Fp2([a0, a1 * frob_c1], self.nr)

    def sqrt(self):
        """Square root in Fp2 (complex-method); returns None if non-residue."""
        a0, a1 = self.coeffs
        p = a0.p
        if a1.is_zero():
            r = a0.sqrt()
            if r is not None:
                return Fp2([r, Fp(0, p)], self.nr)
            # sqrt(a0) = sqrt(a0/nr)*u
            r = (a0 * self.nr.inverse()).sqrt()
            if r is None:
                return None
            return Fp2([Fp(0, p), r], self.nr)
        # norm = a0^2 - nr*a1^2 must be a QR in Fp
        norm = a0 * a0 - self.nr * (a1 * a1)
        n = norm.sqrt()
        if n is None:
            return None
        inv2 = Fp(pow(2, -1, p), p)
        x0 = (a0 + n) * inv2
        r0 = x0.sqrt()
        if r0 is None:
            x0 = (a0 - n) * inv2
            r0 = x0.sqrt()
            if r0 is None:
                return None
        r1 = a1 * (r0 * 2).inverse()
        cand = Fp2([r0, r1], self.nr)
        if cand * cand == self:
            return cand
        return None

    def is_geq_neg(self) -> bool:
        """arkworks QuadExtField PartialOrd: compare c1 first, then c0."""
        a0, a1 = self.coeffs
        neg = -self
        n0, n1 = neg.coeffs
        if a1.v != n1.v:
            return a1.v > n1.v
        return a0.v > n0.v


class Fp3(_ExtBase):
    """Cubic extension: c0 + c1*u + c2*u^2 with u^3 = nr."""

    def one_like(self):
        c0 = self.coeffs[0]
        return Fp3([Fp(1, c0.p), Fp(0, c0.p), Fp(0, c0.p)], self.nr)

    def zero_like(self):
        c0 = self.coeffs[0]
        return Fp3([Fp(0, c0.p), Fp(0, c0.p), Fp(0, c0.p)], self.nr)

    def __mul__(self, o):
        if isinstance(o, (int, Fp)):
            return Fp3([c * o for c in self.coeffs], self.nr)
        a0, a1, a2 = self.coeffs
        b0, b1, b2 = o.coeffs
        # Toom/Karatsuba-lite (CH-SQR3 style)
        v0 = a0 * b0
        v1 = a1 * b1
        v2 = a2 * b2
        c0 = v0 + self.nr * ((a1 + a2) * (b1 + b2) - v1 - v2)
        c1 = (a0 + a1) * (b0 + b1) - v0 - v1 + self.nr * v2
        c2 = (a0 + a2) * (b0 + b2) - v0 - v2 + v1
        return Fp3([c0, c1, c2], self.nr)

    __rmul__ = __mul__

    def inverse(self):
        a0, a1, a2 = self.coeffs
        nr = self.nr
        t0 = a0 * a0 - nr * (a1 * a2)
        t1 = nr * (a2 * a2) - a0 * a1
        t2 = a1 * a1 - a0 * a2
        # norm = a0*t0 + nr*(a2*t1 + a1*t2)
        norm = a0 * t0 + nr * (a2 * t1) + nr * (a1 * t2)
        ninv = norm.inverse()
        return Fp3([t0 * ninv, t1 * ninv, t2 * ninv], self.nr)

    def frobenius(self, c1, c2):
        """c1 = nr^((p-1)/3), c2 = nr^((2p-2)/3) (Fp elements)."""
        a0, a1, a2 = self.coeffs
        return Fp3([a0, a1 * c1, a2 * c2], self.nr)

    def sqrt(self):
        """Square root in Fp3 via generic Tonelli-Shanks over the extension."""
        if self.is_zero():
            return self
        p = self.coeffs[0].p
        q = p**3
        # Check residuosity: self^((q-1)/2) == 1
        if self.pow((q - 1) // 2) != self.one_like():
            return None
        if q % 4 == 3:
            return self.pow((q + 1) // 4)
        # Tonelli-Shanks in the extension group
        s, t = 0, q - 1
        while t % 2 == 0:
            t //= 2
            s += 1
        # find a non-residue in Fp3: try u + k
        z = None
        for k in range(1, 100):
            cand = Fp3([Fp(k, p), Fp(1, p), Fp(0, p)], self.nr)
            if cand.pow((q - 1) // 2) != self.one_like():
                z = cand
                break
        assert z is not None
        m, c, tt, r = s, z.pow(t), self.pow(t), self.pow((t + 1) // 2)
        one = self.one_like()
        while tt != one:
            i, t2 = 0, tt
            while t2 != one:
                t2 = t2 * t2
                i += 1
            b = c.pow(1 << (m - i - 1))
            m, c = i, b * b
            tt = tt * c
            r = r * b
        return r

    def is_geq_neg(self) -> bool:
        """arkworks CubicExtField PartialOrd: compare c2, then c1, then c0."""
        a = self.coeffs
        n = (-self).coeffs
        for i in (2, 1, 0):
            if a[i].v != n[i].v:
                return a[i].v > n[i].v
        return False


@functools.lru_cache(maxsize=None)
def field_spec(modulus: int, name: str = "Fp") -> FieldSpec:
    return FieldSpec(modulus, name)
