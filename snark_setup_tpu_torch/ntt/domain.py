"""Radix-2 evaluation domains over the scalar field Fr — host side.

Interop contract: the (I)FFT result is the mathematically unique
(interpolation / evaluation) linear map once the domain {omega^i} is fixed,
so bit-exactness with the reference reduces to using the same omega.
arkworks derives `omega = GENERATOR^((r-1)/n) (mod r)` where GENERATOR is
the curve crate's multiplicative-group generator constant
(ark-ff fft_friendly derivation; used by ark-poly Radix2EvaluationDomain,
reference setup-utils/src/groth16_utils.rs:93).

The arkworks curve crates are not available in this environment, so the
GENERATOR values are *recalled* constants, each self-verified to be a
quadratic non-residue at first use (a necessary condition for a generator,
and sufficient for `g^((r-1)/n)` to have exact order n for n | 2^s).
Provenance is tracked in `FR_GENERATOR_SOURCE`; a recalled value that fails
self-verification falls back to the smallest non-residue (flagged
"derived-not-arkworks", still internally consistent end-to-end).
"""

from __future__ import annotations

import functools

from ..curves.constants import get_curve

# Recalled arkworks Fr GENERATOR constants (see module docstring):
#   bls12_377: ark-bls12-377 fr.rs  GENERATOR = 22
#   bls12_381: ark-bls12-381 fr.rs  GENERATOR = 7
#   bw6_761:   Fr == BLS12-377 Fq;  ark-bls12-377 fq.rs GENERATOR = -5
#   mnt4_753:  ark-mnt4-753 fr.rs   GENERATOR = 17
#   mnt6_753:  Fr == MNT4-753 Fq;   ark-mnt4-753 fq.rs GENERATOR = 17
_FR_GENERATOR_RECALLED = {
    "bls12_377": 22,
    "bls12_381": 7,
    "bw6_761": -5,
    "mnt4_753": 17,
    "mnt6_753": 17,
}

FR_GENERATOR_SOURCE: dict[str, str] = {}


def _is_nonresidue(g: int, r: int) -> bool:
    return pow(g, (r - 1) // 2, r) == r - 1


@functools.lru_cache(maxsize=None)
def fr_generator(curve_name: str) -> int:
    """Multiplicative-group generator candidate for Fr (see module doc)."""
    r = get_curve(curve_name).r
    g = _FR_GENERATOR_RECALLED.get(curve_name)
    if g is not None and _is_nonresidue(g % r, r):
        FR_GENERATOR_SOURCE[curve_name] = "arkworks-recalled"
        return g % r
    for cand in range(2, 1000):
        if _is_nonresidue(cand, r):
            FR_GENERATOR_SOURCE[curve_name] = "derived-not-arkworks"
            return cand
    raise AssertionError("no quadratic non-residue found")


@functools.lru_cache(maxsize=None)
def two_adicity(curve_name: str) -> int:
    r = get_curve(curve_name).r
    return ((r - 1) & -(r - 1)).bit_length() - 1


class Radix2Domain:
    """Multiplicative subgroup {omega^i : 0 <= i < n}, n a power of two.

    Mirrors ark-poly Radix2EvaluationDomain semantics: `new(num_coeffs)`
    rounds n up to the next power of two; fft/ifft are the evaluation /
    interpolation maps over the subgroup in index order.
    """

    def __init__(self, curve_name: str, num_coeffs: int):
        spec = get_curve(curve_name)
        self.curve_name = curve_name
        self.r = spec.r
        n = 1 << max(num_coeffs - 1, 0).bit_length()
        if num_coeffs == 0:
            n = 1
        s = two_adicity(curve_name)
        if n > (1 << s):
            raise ValueError(
                f"domain size {n} exceeds 2-adicity {s} of {curve_name} Fr "
                "(the reference would fall back to a mixed-radix domain; "
                "not supported yet)"
            )
        self.size = n
        self.log_size = n.bit_length() - 1
        g = fr_generator(curve_name)
        self.group_gen = pow(g, (self.r - 1) // n, self.r)
        self.group_gen_inv = pow(self.group_gen, -1, self.r)
        self.size_inv = pow(n, -1, self.r)
        # exact-order sanity: omega^n == 1 and omega^(n/2) == -1 (n > 1)
        assert pow(self.group_gen, n, self.r) == 1
        if n > 1:
            assert pow(self.group_gen, n // 2, self.r) == self.r - 1

    # -- host oracle transforms (Python ints, O(n^2)-free iterative FFT) ----
    def _fft_scalars(self, values: list[int], omega: int) -> list[int]:
        n, r = self.size, self.r
        assert len(values) == n
        a = list(values)
        # bit-reversal permutation
        j = 0
        for i in range(1, n):
            bit = n >> 1
            while j & bit:
                j ^= bit
                bit >>= 1
            j |= bit
            if i < j:
                a[i], a[j] = a[j], a[i]
        m = 2
        while m <= n:
            wm = pow(omega, n // m, r)
            for k in range(0, n, m):
                w = 1
                for jj in range(m // 2):
                    t = w * a[k + jj + m // 2] % r
                    u = a[k + jj]
                    a[k + jj] = (u + t) % r
                    a[k + jj + m // 2] = (u - t) % r
                    w = w * wm % r
            m <<= 1
        return a

    def fft(self, coeffs: list[int]) -> list[int]:
        """Coefficients -> evaluations over the domain (zero-padded)."""
        c = list(coeffs) + [0] * (self.size - len(coeffs))
        return self._fft_scalars(c, self.group_gen)

    def ifft(self, evals: list[int]) -> list[int]:
        """Evaluations -> coefficients (inverse transform)."""
        e = list(evals) + [0] * (self.size - len(evals))
        out = self._fft_scalars(e, self.group_gen_inv)
        return [v * self.size_inv % self.r for v in out]

    def elements(self) -> list[int]:
        out, cur = [], 1
        for _ in range(self.size):
            out.append(cur)
            cur = cur * self.group_gen % self.r
        return out


def domain_size(curve_name: str, phase2_size: int) -> int:
    """Reference: setup-utils/src/groth16_utils.rs:65-69."""
    return Radix2Domain(curve_name, phase2_size).size
