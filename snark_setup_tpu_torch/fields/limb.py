"""Limb representation shared by host and device code.

Device field elements are vectors of 16-bit limbs, one limb per 32-bit
word: the layout of the reference package (chosen there for a chip without a
64-bit integer multiply), kept at every seam of the port so the two packages
exchange and compare limb planes as they are. The plain PyTorch field layer
works on these limbs directly (ops/fp.py); the CUDA kernels pack pairs of
them into 32-bit limbs in registers. 377-bit fields use 24 limbs, 753/761-bit
fields use 48.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


@dataclass(frozen=True)
class LimbSpec:
    """Static limb geometry for a modulus."""

    modulus: int

    @property
    def n_limbs(self) -> int:
        # round up to a multiple of 8 limbs (=128 bits), as the reference does:
        # the Montgomery radix R = 2^(16 * n_limbs) must be the same in both
        raw = -(-self.modulus.bit_length() // LIMB_BITS)
        return -(-raw // 8) * 8

    @property
    def total_bits(self) -> int:
        return self.n_limbs * LIMB_BITS

    @property
    def mont_r(self) -> int:
        """Device Montgomery radix R = 2^(16*n_limbs), reduced mod N."""
        return pow(2, self.total_bits, self.modulus)

    @property
    def mont_r_pow(self) -> int:
        """Raw (unreduced) Montgomery radix R = 2^(16*n_limbs)."""
        return 1 << self.total_bits

    @property
    def mont_r2(self) -> int:
        return pow(2, 2 * self.total_bits, self.modulus)

    @property
    def n0_inv(self) -> int:
        """-modulus^{-1} mod 2^total_bits (for Montgomery reduction)."""
        return (-pow(self.modulus, -1, 1 << self.total_bits)) % (1 << self.total_bits)


def int_to_limbs(v: int, n_limbs: int) -> np.ndarray:
    """Little-endian 16-bit limbs as uint32. One to_bytes call instead of
    a per-limb Python loop (raises OverflowError if v needs more limbs)."""
    b = v.to_bytes(2 * n_limbs, "little")
    return np.frombuffer(b, "<u2").astype(np.uint32)


def limbs_to_int(limbs) -> int:
    v = 0
    for i, l in enumerate(np.asarray(limbs, dtype=np.uint64).tolist()):
        v |= int(l) << (LIMB_BITS * i)
    return v


def ints_to_limbs_batch(vals, n_limbs: int) -> np.ndarray:
    """(batch,) python ints -> (batch, n_limbs) uint32. One to_bytes call
    per value instead of n_limbs Python-loop iterations (~20x on the
    host conversion paths feeding device batches)."""
    nb = 2 * n_limbs
    b = b"".join(v.to_bytes(nb, "little") for v in vals)
    return np.frombuffer(b, "<u2").reshape(len(vals), n_limbs).astype(np.uint32)


def limbs_batch_to_ints(arr) -> list[int]:
    """Inverse of ints_to_limbs_batch. PRECONDITION: canonical 16-bit
    limbs — values >= 2^16 would be silently truncated by the <u2 cast,
    so they fail loudly here instead (ADVICE r3)."""
    arr = np.asarray(arr)
    L = arr.shape[-1]
    if arr.size and arr.dtype.itemsize > 2 and int(arr.max()) > 0xFFFF:
        raise ValueError("limbs_batch_to_ints: non-canonical limb >= 2^16")
    flat = np.ascontiguousarray(arr.reshape(-1, L)).astype("<u2")
    b = flat.tobytes()
    nb = 2 * L
    return [
        int.from_bytes(b[i * nb : (i + 1) * nb], "little")
        for i in range(flat.shape[0])
    ]
