"""Bit-exact replica of arkworks 0.4 UniformRand sampling from a rand-core RNG.

Why this exists: the reference's deterministic contribution paths
(key_generation with derive_rng_from_seed / beacon rng, phase1 tests,
phase2 Keypair) draw field elements and curve points through arkworks'
`UniformRand`, whose exact consumption pattern is part of the observable
behavior when a seed is fixed:

- Fp::rand: fill 64-bit limbs (limb 0 first; each via BlockRng next_u64),
  mask the top `shave` bits, reject if >= modulus, and interpret the result
  AS THE MONTGOMERY REPRESENTATION (value = raw * R^{-1} mod p).
- Projective::rand: loop { x = Fq::rand; greatest = bool(sign bit of
  next_u32); get_point_from_x(x, greatest) } then clear cofactor.
"""

from __future__ import annotations

from ..curves.constants import CurveSpec
from ..curves.host import AffinePoint, HostCurve
from ..fields.host import FieldSpec
from .chacha import ChaChaRng


class ArkRng:
    """Wraps a ChaChaRng with arkworks sampling semantics."""

    def __init__(self, rng: ChaChaRng):
        self.rng = rng

    # -- integers ----------------------------------------------------------
    def next_u32(self) -> int:
        return self.rng.next_u32()

    def next_u64(self) -> int:
        return self.rng.next_u64()

    def gen_bool(self) -> bool:
        return self.rng.gen_bool()

    def gen_u8(self) -> int:
        return self.rng.gen_u8()

    # -- field elements ----------------------------------------------------
    def field_rand_raw(self, modulus: int) -> int:
        """The raw rejected-sampled bigint (arkworks' Montgomery repr)."""
        spec = FieldSpec(modulus)
        n = spec.limbs64
        shave = spec.shave_bits
        mask = (1 << 64) - 1 if shave == 0 else ((1 << 64) - 1) >> shave
        while True:
            limbs = [self.rng.next_u64() for _ in range(n)]
            limbs[-1] &= mask
            v = 0
            for i in range(n - 1, -1, -1):
                v = (v << 64) | limbs[i]
            if v < modulus:
                return v

    def field_rand(self, modulus: int) -> int:
        """The sampled field *value* (standard form) = raw * R^{-1} mod p."""
        spec = FieldSpec(modulus)
        raw = self.field_rand_raw(modulus)
        return raw * spec.mont_r_inv % modulus

    def fr_rand(self, curve: CurveSpec) -> int:
        return self.field_rand(curve.r)

    def fq_rand(self, curve: CurveSpec) -> int:
        return self.field_rand(curve.q)

    # -- curve points ------------------------------------------------------
    def g1_projective_rand(self, curve: HostCurve) -> AffinePoint:
        """ark-ec 0.4 Projective::rand (then normalized to affine): sample
        x, pick greater/lesser root by a bool draw, clear cofactor."""
        q = curve.spec.q
        while True:
            x = self.field_rand(q)
            greatest = self.rng.gen_bool()
            pt = curve.get_point_from_x(curve.spec.fp(x), greatest)
            if pt is not None:
                return curve.clear_cofactor(pt)
