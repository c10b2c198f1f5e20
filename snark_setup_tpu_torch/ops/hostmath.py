"""Small host-side bigint helpers shared by the device-op modules
(pure Python — safe for constant setup in any module)."""

from __future__ import annotations


def host_ext_pow(coeffs, e, q, d, nr):
    """Host-side extension-field pow for constant setup (binomial x^d - nr)."""
    nr %= q

    def mul(a, b):
        res = [0] * (2 * d - 1)
        for i in range(d):
            for j in range(d):
                res[i + j] = (res[i + j] + a[i] * b[j]) % q
        for k in range(2 * d - 2, d - 1, -1):
            res[k - d] = (res[k - d] + res[k] * nr) % q
        return tuple(res[:d])

    result = host_ext_one(d)
    base = tuple(c % q for c in coeffs)
    while e > 0:
        if e & 1:
            result = mul(result, base)
        base = mul(base, base)
        e >>= 1
    return result


def host_ext_one(d):
    return tuple([1] + [0] * (d - 1))
