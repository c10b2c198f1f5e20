"""GLV endomorphism machinery for the j-invariant-0 ceremony curves.

Every a=0 curve here (BLS12-377/381 G1+G2, BW6-761 G1+G2) carries the
cube-root endomorphism phi(x, y) = (beta * x, y) with beta a primitive cube
root of unity in Fq. On the order-r ceremony subgroup phi acts as
multiplication by an eigenvalue lambda with lambda^2 + lambda + 1 = 0 mod r,
which buys two wins over the plain fixed-window ladder:

1. **GLV scalar multiplication** (replaces the full-width batch_exp hot loop,
   reference setup-utils/src/helpers.rs:56-140): decompose k = k1 + k2*lambda
   with |k1|, |k2| ~ sqrt(r), then walk k1 and k2 jointly — half the
   doublings of the full-width ladder. The decomposition runs ON DEVICE in
   the same 16-bit-limb integer arithmetic as the field kernels (Barrett
   rounding against host-precomputed reciprocals), so tau-power scalars never
   round-trip to the host.

2. **Endomorphism subgroup check** (replaces the mul-by-group-order Direct
   check, reference phase1/src/helpers/accumulator.rs:95-139): when the
   matched eigenvalue has an integer representative with
   lambda^2 + lambda + 1 == r *exactly*, ker(phi - [lambda]) has order
   deg(phi - [lambda]) = r and therefore IS the prime-order subgroup — so
   `phi(P) == [lambda]P` characterizes membership with a half-width scalar
   multiplication instead of a full-width one.

Correctness caveat encoded in the API: GLV multiplication is only
[k mod r]-correct for points in the r-subgroup (that is where phi acts as
[lambda]). Callers that multiply potentially-out-of-subgroup points by the
group order itself (the Direct subgroup check) must use the generic windowed
ladder — see CurveOps.scalar_mul_windowed.

Parameter derivation is fully self-verified at build time: beta/lambda pairs
are matched against the host curve generator, and the short lattice basis
comes from the classic extended-Euclid construction (GLV'01), checked to lie
in the lattice and to be short.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from fractions import Fraction

import numpy as np
import torch

from ..fields.limb import LIMB_BITS, int_to_limbs, limbs_to_int
from .fp import _diag_rect, _resolve_carries, _sub_with_borrow


# ---------------------------------------------------------------------------
# Parameter derivation (host, exact integers)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GLVParams:
    beta: int  # endo coefficient in Fq (standard form)
    lam: int  # eigenvalue of phi on the r-subgroup, in [0, r)
    r: int
    v1: tuple  # short lattice basis vectors (a, b) with a + b*lam = 0 mod r
    v2: tuple
    nbits: int  # bit budget per half-scalar magnitude
    # signed integer representative e with e^2 + e + 1 == r exactly, enabling
    # the endomorphism subgroup check phi(P) == [e]P; None if unavailable
    endo_check_lambda: int | None


def _cube_roots_of_unity(p: int) -> list[int]:
    """The two primitive cube roots of unity mod p (p = 1 mod 3)."""
    from ..fields.host import tonelli_shanks_sqrt

    s = tonelli_shanks_sqrt((p - 3) % p, p)
    if s is None:
        return []
    r1 = (p - 1 + s) * pow(2, -1, p) % p
    r2 = (p - 1 - s) * pow(2, -1, p) % p
    return [r for r in (r1, r2) if r != 1 and pow(r, 3, p) == 1]


def _short_basis(r: int, lam: int) -> tuple[tuple, tuple]:
    """GLV'01 extended-Euclid short basis of {(a,b): a + b*lam = 0 mod r}."""
    import math

    sqrt_r = math.isqrt(r)
    r0, t0 = r, 0
    r1, t1 = lam, 1
    while r1 >= sqrt_r:
        q = r0 // r1
        r0, t0, r1, t1 = r1, t1, r0 - q * r1, t0 - q * t1
    # one more step for the alternative second vector
    q = r0 // r1
    r2, t2 = r0 - q * r1, t0 - q * t1
    v1 = (r1, -t1)
    cand_a = (r0, -t0)
    cand_b = (r2, -t2)
    v2 = cand_a if max(map(abs, cand_a)) <= max(map(abs, cand_b)) else cand_b
    for a, b in (v1, v2):
        assert (a + b * lam) % r == 0, "basis vector not in GLV lattice"
    return v1, v2


@functools.lru_cache(maxsize=None)
def derive_glv(curve_name: str, group: str) -> GLVParams | None:
    """Derive + self-verify GLV parameters for one source group, or None if
    the curve has no cube-root endomorphism (a != 0 or q != 1 mod 3)."""
    from ..curves.constants import get_curve
    from ..curves.host import g1_curve, g2_curve

    spec = get_curve(curve_name)
    gspec = spec.g1 if group == "g1" else spec.g2
    if any(v != 0 for v in gspec.a):
        return None
    if spec.q % 3 != 1 or spec.r % 3 != 1:
        return None
    betas = _cube_roots_of_unity(spec.q)
    lams = _cube_roots_of_unity(spec.r)
    if not betas or not lams:
        return None

    hc = g1_curve(spec) if group == "g1" else g2_curve(spec)
    gen = hc.generator

    def apply_endo_host(pt, beta):
        if pt.is_infinity:
            return pt
        from ..curves.host import AffinePoint

        if group == "g1" and gspec.field_kind == "fp":
            bx = pt.x * spec.fp(beta)
        elif gspec.field_kind == "fp":
            bx = pt.x * spec.fp(beta)
        else:
            coeffs = [0] * {"fp2": 2, "fp3": 3}[gspec.field_kind]
            coeffs[0] = beta
            bx = pt.x * spec.g2_field(tuple(coeffs))
        return AffinePoint(bx, pt.y)

    beta = min(betas)
    phi_g = apply_endo_host(gen, beta)
    lam = next((l for l in lams if hc.mul(gen, l) == phi_g), None)
    if lam is None:
        return None

    v1, v2 = _short_basis(spec.r, lam)
    # generous magnitude budget: exact Babai plus one unit of Barrett slip
    bound = 2 * max(
        abs(v1[0]) + abs(v2[0]),
        abs(v1[1]) + abs(v2[1]),
    )
    nbits = bound.bit_length() + 1

    endo_check_lambda = None
    for cand in (lam, lam - spec.r):
        if cand * cand + cand + 1 == spec.r:
            endo_check_lambda = cand
            break
    return GLVParams(
        beta=beta,
        lam=lam,
        r=spec.r,
        v1=v1,
        v2=v2,
        nbits=nbits,
        endo_check_lambda=endo_check_lambda,
    )


# ---------------------------------------------------------------------------
# Device integer helpers (16-bit limb planes, batch axis last)
# ---------------------------------------------------------------------------


def _umul_cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned integer product column sums: a (na, *batch) 16-bit limbs x
    b (nb,) constant int64 limbs -> (na+nb, *batch) unresolved int64 columns
    (< min(na, nb) * 2^32)."""
    return _diag_rect(a.to(torch.int64), b.reshape(-1, *([1] * (a.ndim - 1))))


_COLS_BITS = 40  # column bound of _umul_cols sums (<= 64 limbs x 2^32, twice over)


def _pad_limbs(x: torch.Tensor, n: int) -> torch.Tensor:
    if x.shape[0] >= n:
        return x[:n]
    pad = torch.zeros((n - x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=0)


def _limbs_of(v: int, min_len: int = 1) -> np.ndarray:
    n = max(min_len, -(-max(v.bit_length(), 1) // LIMB_BITS))
    return int_to_limbs(v, n)


class GLVOps:
    """Device-side GLV decomposition for one (curve, group), built from
    host-precomputed Barrett reciprocals and basis limb constants."""

    def __init__(self, params: GLVParams, scalar_limbs: int):
        self.p = params
        Ls = scalar_limbs
        self.Ls = Ls
        a1, b1 = params.v1
        a2, b2 = params.v2
        det = a1 * b2 - a2 * b1
        assert abs(det) == params.r, "GLV basis determinant must be +-r"

        # c_i = round(k * g_i) with g1 = b2/det, g2 = -b1/det
        gs = [Fraction(b2, det), Fraction(-b1, det)]
        cmax = max(abs(b2), abs(b1)) + 2
        self.Lc = -(-(cmax.bit_length() + 1) // LIMB_BITS) + 1
        # Barrett shift: wide enough that the reciprocal truncation error
        # cannot move the rounded value by more than 1
        self.S_limbs = Ls + self.Lc
        S = LIMB_BITS * self.S_limbs
        self.mu = []
        self.mu_sign = []
        for g in gs:
            num, den = abs(g.numerator), g.denominator  # den > 0 by Fraction
            mu = ((num << (S + 1)) + den) // (2 * den)
            self.mu.append(_limbs_of(mu))
            self.mu_sign.append(1 if g >= 0 else -1)

        # half-scalar magnitude geometry
        self.Lh = -(-params.nbits // LIMB_BITS) + 1
        # term magnitudes: |c_i| * |coeff| — shared working width
        coeff_max = max(abs(v) for v in (a1, b1, a2, b2) if v) + 1
        La = -(-coeff_max.bit_length() // LIMB_BITS) + 1
        self.LT = max(Ls, self.Lc + La) + 2

        def term_consts(coeffs):
            out = []
            for sign_g, coeff in zip(self.mu_sign, coeffs):
                if coeff == 0:
                    out.append(None)
                    continue
                sgn = sign_g * (1 if coeff > 0 else -1)
                out.append((sgn, _limbs_of(abs(coeff))))
            return out

        # k1 = k - c1*a1 - c2*a2 ; k2 = -(c1*b1 + c2*b2)
        self.k1_terms = term_consts((a1, a2))
        self.k2_terms = term_consts((b1, b2))
        self.half_limb = self.S_limbs - 1  # add 2^(S-1) for round-to-nearest
        self._dev_consts: dict = {}

    def _const(self, limbs: np.ndarray, device) -> torch.Tensor:
        """A host limb constant as an int64 tensor, kept per device."""
        key = (limbs.tobytes(), str(device))
        t = self._dev_consts.get(key)
        if t is None:
            t = torch.from_numpy(limbs.astype(np.int64)).to(device)
            self._dev_consts[key] = t
        return t

    # -- device decomposition ----------------------------------------------
    def decompose(self, k_raw: torch.Tensor):
        """(Ls, *batch) standard-form scalar limbs (values < r) ->
        (m1, neg1, m2, neg2): two (Lh, *batch) int32 magnitudes + negative
        masks (bool) with k = (-1)^neg1 * m1 + (-1)^neg2 * m2 * lambda (mod r)."""
        cs = []
        for mu in self.mu:
            cols = _umul_cols(k_raw, self._const(mu, k_raw.device))
            cols = _pad_limbs(cols, max(cols.shape[0], self.S_limbs + self.Lc))
            half = np.zeros(cols.shape[0], np.uint32)
            half[self.half_limb] = 1 << (LIMB_BITS - 1)
            half = self._const(half, k_raw.device).reshape(-1, *([1] * (cols.ndim - 1)))
            t = _resolve_carries(cols + half, _COLS_BITS)
            cs.append(t[self.S_limbs : self.S_limbs + self.Lc])

        m1, neg1 = self._signed_combine(k_raw, cs, self.k1_terms)
        m2, neg2 = self._signed_combine(None, cs, self.k2_terms)
        return m1, neg1, m2, neg2

    def _signed_combine(self, k_raw, cs, terms):
        """value = (k or 0) - sum_i sign_i * (c_i * |coeff_i|) ->
        (magnitude limbs (Lh,), negative mask)."""
        zero = torch.zeros((self.LT, *cs[0].shape[1:]), dtype=torch.int64, device=cs[0].device)
        pos = zero if k_raw is None else _pad_limbs(k_raw.to(torch.int64), self.LT)
        neg = zero
        for c, term in zip(cs, terms):
            if term is None:
                continue
            sgn, coeff_limbs = term
            cols = _pad_limbs(_umul_cols(c, self._const(coeff_limbs, c.device)), self.LT)
            if sgn > 0:
                neg = neg + cols
            else:
                pos = pos + cols
        P = _resolve_carries(pos, _COLS_BITS)
        N = _resolve_carries(neg, _COLS_BITS)
        d_pn, borrow = _sub_with_borrow(P, N)
        d_np, _ = _sub_with_borrow(N, P)
        mag = torch.where(borrow, d_np, d_pn)
        return mag[: self.Lh].to(torch.int32), borrow

    # -- host model (exact mirror, for tests) --------------------------------
    def decompose_host(self, k: int) -> tuple[int, int]:
        """Bit-exact host model of decompose(): returns signed (k1, k2) with
        k1 + k2*lam = k (mod r) and |ki| < 2^nbits."""
        S = LIMB_BITS * self.S_limbs
        cs = []
        for mu, sign_g in zip(self.mu, self.mu_sign):
            c = (k * limbs_to_int(mu) + (1 << (S - 1))) >> S
            cs.append((sign_g, c))
        (sg1, c1), (sg2, c2) = cs
        a1, b1 = self.p.v1
        a2, b2 = self.p.v2
        k1 = k - sg1 * c1 * a1 - sg2 * c2 * a2
        k2 = -(sg1 * c1 * b1 + sg2 * c2 * b2)
        assert (k1 + k2 * self.p.lam - k) % self.p.r == 0
        return k1, k2
