"""Host-side pairings for all five ceremony curves via a single generic
(Tate) pairing over binomial towers.

Design note: every protocol use of pairings in the reference is an *equality
of pairing products* (same_ratio, helpers.rs:406-424; Groth16 verification).
Any fixed non-degenerate bilinear pairing decides those equalities
identically, so we use the Tate pairing e(P, Q) = f_{r,P}(Q)^((q^k-1)/r)
uniformly instead of per-family optimal-ate Miller loops — one implementation,
five curves, and products of pairings share a single final exponentiation.

Replaces reference L1 `E::pairing` (ark-ec) for host verification. The batch
MSM feeding these checks runs on the card (ops/), so only O(1) pairings per
batch are computed here (SURVEY.md C14).
"""

from __future__ import annotations

import functools

from .constants import CurveSpec, get_curve
from .host import AffinePoint, HostCurve, g1_curve, g2_curve
from .tower import CubicCtx, PrimeCtx, QuadCtx, ctx_pow


class DegeneratePairingError(Exception):
    """Raised when a Miller loop hits an unexpected degenerate configuration
    (input point not of prime order r). Callers in verification paths treat
    this as a failed check."""


def _pow_window(ctx, a, e: int, w: int = 5):
    """a^e (e > 0) by a sliding window of w bits over the odd powers
    a, a^3, ..., a^(2^w - 1): about one multiplication per w + 1 bits
    besides the squarings, where square-and-multiply takes one per two."""
    a2 = ctx.square(a)
    odd = [a]
    for _ in range((1 << (w - 1)) - 1):
        odd.append(ctx.mul(odd[-1], a2))
    result = None
    i = e.bit_length() - 1
    while i >= 0:
        if not (e >> i) & 1:
            result = ctx.square(result)
            i -= 1
            continue
        j = max(i - w + 1, 0)
        while not (e >> j) & 1:  # the window ends on a set bit
            j += 1
        val = (e >> j) & ((1 << (i - j + 1)) - 1)
        if result is not None:
            for _ in range(i - j + 1):
                result = ctx.square(result)
        result = odd[val >> 1] if result is None else ctx.mul(result, odd[val >> 1])
        i = j - 1
    return result


def _scale_int(ctx, a, c: int):
    """Multiply a tower element by an Fp integer (coefficient-wise)."""
    if isinstance(ctx, PrimeCtx):
        return ctx.mul(a, c)
    return tuple(_scale_int(ctx.base, x, c) for x in a)


def _embed_int(ctx, c: int):
    """Lift an Fp integer into the tower."""
    if isinstance(ctx, PrimeCtx):
        return c % ctx.p
    return (_embed_int(ctx.base, c),) + tuple(ctx.base.zero() for _ in range(1 if isinstance(ctx, QuadCtx) else 2))


class PairingEngine:
    def __init__(self, spec: CurveSpec):
        self.spec = spec
        self.g1c: HostCurve = g1_curve(spec)
        self.g2c: HostCurve = g2_curve(spec)
        self.q = spec.q
        self.r = spec.r
        self.k = spec.embedding_degree
        self._build_tower()
        self.final_exp_e = (self.q**self.k - 1) // self.r
        # every tower's top is quadratic over Fq^(k/2), whose conjugation is
        # the q^(k/2)-power Frobenius: f^(q^(k/2) - 1) = conj(f) / f, and
        # (q^(k/2) + 1) / r is what is left of the final exponent
        half = self.q ** (self.k // 2) + 1
        assert self.k % 2 == 0 and half % self.r == 0
        self.final_exp_hard = half // self.r

    # -- tower construction ------------------------------------------------
    def _build_tower(self):
        spec = self.spec
        fp = PrimeCtx(spec.q)
        if spec.name in ("bls12_377", "bls12_381"):
            fp2 = QuadCtx(fp, spec.ext_nonresidue)
            xi = tuple(c % spec.q for c in spec.tower_nr)
            fp6 = CubicCtx(fp2, xi)
            v = (fp2.zero(), fp2.one(), fp2.zero())  # v in Fp6, v^3 = xi
            ctx = QuadCtx(fp6, v)  # w^2 = v  =>  w^6 = xi
            self.ctx = ctx
            self.g2_base = fp2
            self._embed_coord = lambda coeffs: ctx.embed(fp6.embed(coeffs))
            w = (fp6.zero(), fp6.one())
            w2 = ctx.square(w)
            w3 = ctx.mul(w2, w)
            if spec.twist_kind == "D":
                self._ux, self._uy = w2, w3
            else:  # M twist: multiply by w^-2, w^-3
                self._ux, self._uy = ctx.inv(w2), ctx.inv(w3)
        elif spec.name == "bw6":
            # Fq6 = Fp3[w]/(w^2 - u), Fp3 = Fp[u]/(u^3 - xi), xi a sextic NR.
            xi = self._find_sextic_nonresidue(spec.q)
            fp3 = CubicCtx(fp, xi)
            u = (0, 1, 0)
            ctx = QuadCtx(fp3, u)
            self.ctx = ctx
            self.g2_base = fp
            self._embed_coord = lambda v: _embed_int(ctx, v)
            # alpha^6 = b / b' links the twist E' (y^2 = x^3 + b') to E.
            b = spec.g1.b[0]
            b2 = spec.g2.b[0]
            s = b * pow(b2, -1, spec.q) % spec.q
            alpha = self._sixth_root(ctx, _embed_int(ctx, s))
            self._ux = ctx.square(alpha)
            self._uy = ctx.mul(self._ux, alpha)
        elif spec.name == "mnt4_753":
            fp2 = QuadCtx(fp, spec.ext_nonresidue)
            u = (0, 1)
            ctx = QuadCtx(fp2, u)  # w^2 = u, u^2 = nr => w^4 = nr
            self.ctx = ctx
            self.g2_base = fp2
            self._embed_coord = lambda coeffs: ctx.embed(coeffs)
            # quadratic twist by D=u: untwist (x/u, y/(u*w))
            u_top = ctx.embed(u)
            w = (fp2.zero(), fp2.one())
            self._ux = ctx.inv(u_top)
            self._uy = ctx.inv(ctx.mul(u_top, w))
        elif spec.name == "mnt6_753":
            fp3 = CubicCtx(fp, spec.ext_nonresidue)
            u = (0, 1, 0)
            ctx = QuadCtx(fp3, u)  # w^2 = u, u^3 = nr => w^6 = nr
            self.ctx = ctx
            self.g2_base = fp3
            self._embed_coord = lambda coeffs: ctx.embed(coeffs)
            u_top = ctx.embed(u)
            w = (fp3.zero(), fp3.one())
            self._ux = ctx.inv(u_top)
            self._uy = ctx.inv(ctx.mul(u_top, w))
        else:
            raise ValueError(f"no pairing tower for {spec.name}")

    @staticmethod
    def _find_sextic_nonresidue(q: int) -> int:
        """Smallest xi that is neither a square nor a cube mod q (makes
        x^6 - xi irreducible for q ≡ 1 mod 6)."""
        assert q % 6 == 1
        for xi in range(2, 10_000):
            if pow(xi, (q - 1) // 2, q) == 1:
                continue
            if pow(xi, (q - 1) // 3, q) == 1:
                continue
            return xi
        raise RuntimeError("no sextic nonresidue found")

    def _sixth_root(self, ctx, s):
        """alpha with alpha^6 = s in Fq^k (k even, here BW6's Fq6), via
        sqrt then cube root with generic Tonelli-Shanks / AMM."""
        order = self.q**self.k - 1
        t = self._ext_sqrt(ctx, s, order)
        alpha = self._ext_cbrt(ctx, t, order)
        # fix possible sign/cube-root-of-unity ambiguity: verify
        if not ctx.eq(ctx_pow(ctx, alpha, 6), s):
            raise RuntimeError("sixth root failed verification")
        return alpha

    def _ext_sqrt(self, ctx, a, order):
        # Tonelli-Shanks in the cyclic group of order `order`
        if ctx.eq(ctx_pow(ctx, a, order // 2), ctx.one()) is False:
            raise DegeneratePairingError("not a square in extension")
        q, s = order, 0
        while q % 2 == 0:
            q //= 2
            s += 1
        z = self._find_ext_nonresidue(ctx, order, 2)
        m, c, t, r_ = s, ctx_pow(ctx, z, q), ctx_pow(ctx, a, q), ctx_pow(ctx, a, (q + 1) // 2)
        one = ctx.one()
        while not ctx.eq(t, one):
            i, t2 = 0, t
            while not ctx.eq(t2, one):
                t2 = ctx.square(t2)
                i += 1
            b = ctx_pow(ctx, c, 1 << (m - i - 1))
            m, c = i, ctx.square(b)
            t = ctx.mul(t, c)
            r_ = ctx.mul(r_, b)
        return r_

    def _ext_cbrt(self, ctx, a, order):
        """Cube root via AMM: order = 3^s * m with 3 ∤ m.

        With alpha = 3^{-1} mod m and k = (3*alpha - 1)/m:
        (a^alpha)^3 = a^{1+km} = a * b^k for b = a^m in the 3-Sylow subgroup;
        writing b = g^e (digit-wise discrete log), root = a^alpha * g^{-ek/3}.
        """
        n = order
        s, m = 0, n
        while m % 3 == 0:
            m //= 3
            s += 1
        if s == 0:
            return ctx_pow(ctx, a, pow(3, -1, n))
        alpha = pow(3, -1, m)
        k = (3 * alpha - 1) // m
        z = self._find_ext_nonresidue(ctx, n, 3)
        g = ctx_pow(ctx, z, m)  # generator of the 3^s Sylow subgroup
        b = ctx_pow(ctx, a, m)
        one = ctx.one()
        omega = ctx_pow(ctx, g, 3 ** (s - 1))
        e = 0
        for i in range(s):
            h = ctx_pow(ctx, ctx.mul(b, ctx_pow(ctx, g, -e)), 3 ** (s - 1 - i))
            if ctx.eq(h, one):
                d = 0
            elif ctx.eq(h, omega):
                d = 1
            else:
                d = 2
            e += d * 3**i
        if e % 3 != 0:
            raise DegeneratePairingError("not a cube in extension")
        root = ctx.mul(
            ctx_pow(ctx, a, alpha),
            ctx_pow(ctx, g, (-(e // 3) * k) % (3**s)),
        )
        if not ctx.eq(ctx_pow(ctx, root, 3), a):
            for _ in range(3):
                root = ctx.mul(root, omega)
                if ctx.eq(ctx_pow(ctx, root, 3), a):
                    break
            else:
                raise DegeneratePairingError("cube root failed")
        return root

    @functools.lru_cache(maxsize=8)
    def _find_ext_nonresidue(self, ctx, order, p_small):
        """Find an element that is not a p_small-th power in the extension."""
        import random

        rng = random.Random(1234)
        while True:
            cand = self._random_ext_element(ctx, rng)
            if not ctx.eq(ctx_pow(ctx, cand, order // p_small), ctx.one()):
                return cand

    def _random_ext_element(self, ctx, rng):
        if isinstance(ctx, PrimeCtx):
            return rng.randrange(1, ctx.p)
        n = 2 if isinstance(ctx, QuadCtx) else 3
        return tuple(self._random_ext_element(ctx.base, rng) for _ in range(n))

    # -- untwisting --------------------------------------------------------
    def _embed_g2_coord(self, c):
        """Embed a G2 coordinate (host Fp/Fp2/Fp3 element) into the tower."""
        if self.spec.g2.field_kind == "fp":
            return self._embed_coord(c.v)
        return self._embed_coord(tuple(x.v for x in c.coeffs))

    def untwist(self, q_pt: AffinePoint):
        """Map a G2 (twist-curve) point into E(Fq^k)."""
        ctx = self.ctx
        x = ctx.mul(self._embed_g2_coord(q_pt.x), self._ux)
        y = ctx.mul(self._embed_g2_coord(q_pt.y), self._uy)
        return (x, y)

    # -- Miller loop (Tate) ------------------------------------------------
    def _miller(self, p_pt: AffinePoint, q_xy):
        """Accumulate (numerator, denominator) of f_{r,P}(Q)."""
        ctx = self.ctx
        q = self.q
        a_coeff = self.spec.g1.a[0]
        xq, yq = q_xy
        px, py = p_pt.x.v, p_pt.y.v

        f_n, f_d = ctx.one(), ctx.one()
        tx, ty = px, py
        t_inf = False
        bits = bin(self.r)[3:]
        for i, bit in enumerate(bits):
            if t_inf:
                raise DegeneratePairingError("T hit infinity mid-loop")
            # doubling step
            if ty == 0:
                # order-2 point: tangent is vertical
                l = ctx.sub(xq, _embed_int(ctx, tx))
                f_n = ctx.mul(ctx.square(f_n), l)
                f_d = ctx.square(f_d)
                t_inf = True
            else:
                lam = (3 * tx * tx + a_coeff) * pow(2 * ty, -1, q) % q
                # l(Q) = yQ - yT - lam*(xQ - xT)
                l = ctx.sub(
                    ctx.sub(yq, _embed_int(ctx, ty)),
                    _scale_int(ctx, ctx.sub(xq, _embed_int(ctx, tx)), lam),
                )
                nx = (lam * lam - 2 * tx) % q
                ny = (lam * (tx - nx) - ty) % q
                f_n = ctx.mul(ctx.square(f_n), l)
                v = ctx.sub(xq, _embed_int(ctx, nx))
                f_d = ctx.mul(ctx.square(f_d), v)
                tx, ty = nx, ny
            if bit == "1":
                if t_inf:
                    raise DegeneratePairingError("T infinity before add")
                if tx == px and (ty + py) % q == 0:
                    # T = -P: line through T and P is the vertical at P
                    l = ctx.sub(xq, _embed_int(ctx, px))
                    f_n = ctx.mul(f_n, l)
                    t_inf = True
                elif tx == px and ty == py:
                    raise DegeneratePairingError("unexpected T == P")
                else:
                    lam = (py - ty) * pow(px - tx, -1, q) % q
                    l = ctx.sub(
                        ctx.sub(yq, _embed_int(ctx, ty)),
                        _scale_int(ctx, ctx.sub(xq, _embed_int(ctx, tx)), lam),
                    )
                    nx = (lam * lam - tx - px) % q
                    ny = (lam * (tx - nx) - ty) % q
                    f_n = ctx.mul(f_n, l)
                    f_d = ctx.mul(f_d, ctx.sub(xq, _embed_int(ctx, nx)))
                    tx, ty = nx, ny
        if not t_inf:
            # [r]P != O: P was not of order r
            raise DegeneratePairingError("input not killed by r")
        return f_n, f_d

    def _final_exp(self, f_n, f_d):
        """(f_n / f_d)^final_exp_e: the easy part (q^(k/2) - 1) as
        conj(f_n) f_d / (f_n conj(f_d)), one inversion, then the power
        final_exp_hard, about half the bits of final_exp_e. The same value
        as the generic power (0 for f_n = 0)."""
        ctx = self.ctx
        if ctx.is_zero(f_n):
            return ctx.zero()
        conj = lambda a: (a[0], ctx.base.neg(a[1]))
        g = ctx.mul(ctx.mul(conj(f_n), f_d), ctx.inv(ctx.mul(f_n, conj(f_d))))
        return _pow_window(ctx, g, self.final_exp_hard)

    # -- public API --------------------------------------------------------
    def pairing_value(self, p_pt: AffinePoint, q_pt: AffinePoint):
        """Final-exponentiated Tate pairing value (for tests/equality)."""
        if p_pt.is_infinity or q_pt.is_infinity:
            return self.ctx.one()
        return self._final_exp(*self._miller(p_pt, self.untwist(q_pt)))

    def product_is_one(self, pairs) -> bool:
        """Check prod_i e(P_i, Q_i) == 1 with a single final exponentiation.

        pairs: iterable of (g1_point, g2_point). Degenerate inputs (wrong
        subgroup) report False rather than raising.
        """
        ctx = self.ctx
        acc_n, acc_d = ctx.one(), ctx.one()
        try:
            for p_pt, q_pt in pairs:
                if p_pt.is_infinity or q_pt.is_infinity:
                    continue
                f_n, f_d = self._miller(p_pt, self.untwist(q_pt))
                acc_n = ctx.mul(acc_n, f_n)
                acc_d = ctx.mul(acc_d, f_d)
        except DegeneratePairingError:
            return False
        return ctx.eq(self._final_exp(acc_n, acc_d), ctx.one())

    def same_ratio(self, g1_pair, g2_pair) -> bool:
        """e(g1.0, g2.1) == e(g1.1, g2.0).

        Reference: same_ratio, setup-utils/src/helpers.rs:406-408.
        """
        a, b = g1_pair
        c, d = g2_pair
        return self.product_is_one([(a, d), (self.g1c.neg(b), c)])

    def check_same_ratio(self, g1_pair, g2_pair, err: str) -> None:
        """Reference: check_same_ratio, helpers.rs:410-424 (zero-rejection)."""
        from ..utils.errors import InvalidRatioError

        a, b = g1_pair
        c, d = g2_pair
        if a.is_infinity or b.is_infinity or c.is_infinity or d.is_infinity:
            raise InvalidRatioError(err)
        if not self.same_ratio(g1_pair, g2_pair):
            raise InvalidRatioError(err)


@functools.lru_cache(maxsize=None)
def pairing_engine(curve_name: str) -> PairingEngine:
    return PairingEngine(get_curve(curve_name))
