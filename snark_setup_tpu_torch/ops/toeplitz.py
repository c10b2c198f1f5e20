"""Host constants and switches of the stacked product's three opt-in routes.

Copied from the reference (ops/pallas_field.py: `redc_matrices`,
`v2_bounds`, `PallasFieldMul.v2_supported`, `kernel_v2_enabled`,
`kernel_v3_enabled`, `mxu_stacked_forced`), pure numpy and Python; the port
imports nothing of the JAX package.

The Toeplitz reduction writes both constant multiplies of a Montgomery
reduction, m = c * N' mod R and u = m * N, as products of constant byte
matrices with the byte planes of the operand: every entry is a byte, every
term < 2^16, and a sum of at most 4L terms stays below 2^24, so the products
are exact in int32 (the tensor cores' u8 x u8 -> s32) and in float32 alike.

The three switches read the environment at every call, as the reference's
do, but lower-case the value: "ON" and "True" enable a route where the
reference accepts only "1", "on" and "true".
"""

from __future__ import annotations

import os

import numpy as np


def _flag(name: str) -> bool:
    return os.environ.get(name, "0").strip().lower() in ("1", "on", "true")


def kernel_v2_enabled() -> bool:
    """SNARK_SETUP_KERNEL_V2: the f32 byte-plane schoolbook + Toeplitz REDC
    (K8) wherever the weights pass `v2_supported`."""
    return _flag("SNARK_SETUP_KERNEL_V2")


def kernel_v3_enabled() -> bool:
    """SNARK_SETUP_KERNEL_V3: the u32 schoolbook + Toeplitz REDC (K7)."""
    return _flag("SNARK_SETUP_KERNEL_V3")


def mxu_stacked_forced() -> bool:
    """SNARK_SETUP_MXU_STACKED: the product columns (K6), then the
    matrix-product Toeplitz reduction `FpOps.redc_cols_matmul`."""
    return _flag("SNARK_SETUP_MXU_STACKED")


def redc_matrices(modulus: int, n0_inv: int, L: int):
    """Blocked-layout Toeplitz REDC matrices (host, float32, byte entries).

    T_low4 (2L, 4L): maps the 4-byte blocked split of the low L unresolved
    columns to the blocked byte rows of m = c * N' mod R.
    T_full (4L, 2L): maps the 2-byte blocked split of resolved m to the
    blocked byte rows of u = m * N.
    Blocked layout: output row r < half is byte digit 2r, else
    2 (r - half) + 1; input column p L + i is byte digit 2 i + p."""

    def bytes_of(v, n):
        return np.array([(v >> (8 * k)) & 0xFF for k in range(n)], np.float32)

    Np8 = bytes_of(n0_inv, 2 * L)
    N8 = bytes_of(modulus, 2 * L)

    def build(coeffs, rows, in_blocks):
        M = np.zeros((rows, in_blocks * L), np.float32)
        half = rows // 2
        for col in range(in_blocks * L):
            p, i = divmod(col, L)
            d_in = 2 * i + p
            for r in range(rows):
                d = (2 * r if r < half else 2 * (r - half) + 1) - d_in
                if 0 <= d < 2 * L:
                    M[r, col] = coeffs[d]
        return M

    return build(Np8, 2 * L, 4), build(N8, 4 * L, 2)


def tc_matrices(modulus: int, n0_inv: int, L: int):
    """The two constant byte matrices of the port's tensor-core reduction
    (kernels K7 and K8, csrc/toeplitz_tc.cuh), uint8, over byte digits in
    their natural order (not `redc_matrices`' blocked one):

    T_low2 (2L, 2L): row d gives byte digit d of c * N' from the 2L bytes
    of c mod R (column i = byte i); T_full (4L, 2L): row d gives byte digit
    d of m * N from the 2L bytes of m. Entry [d, i] is byte d - i of N'
    (n0_inv = -N^{-1} mod R) or of N, 0 where d - i is no byte index."""

    def toeplitz(v: int, rows: int) -> np.ndarray:
        coef = np.array([(v >> (8 * k)) & 0xFF for k in range(2 * L)], np.uint8)
        d = np.arange(rows)[:, None] - np.arange(2 * L)[None, :]
        return np.where((d >= 0) & (d < 2 * L), coef[np.clip(d, 0, 2 * L - 1)], 0).astype(np.uint8)

    return toeplitz(n0_inv, 2 * L), toeplitz(modulus, 4 * L)


def mma_fragments(T: np.ndarray) -> np.ndarray:
    """T (M, K) uint8 as the A operands of PTX `mma.sync.m16n8k32` (u8), flat
    uint8: T zero-padded to whole tiles of 16 rows by 32 columns, tile
    (j, ks) (rows 16 j.., columns 32 ks..) at byte 512 (j KS + ks) with KS
    = ceil(K / 32), and in it thread `lid`'s four 32-bit registers at bytes
    16 lid .. 16 lid + 15: rows g, g + 8, g, g + 8 by columns 4 tig .. 4 tig
    + 3, the same, 16 + 4 tig .., the same (g = lid // 4, tig = lid % 4),
    each register's bytes in column order (PTX ISA, the A fragment of
    m16n8k32 for 8-bit types)."""
    M, K = T.shape
    mt, ks = -(-M // 16), -(-K // 32)
    P = np.zeros((mt * 16, ks * 32), np.uint8)
    P[:M, :K] = T
    blk = P.reshape(mt, 2, 8, ks, 2, 4, 4)  # j, row // 8, g, ks, column // 16, tig, byte
    return np.ascontiguousarray(blk.transpose(0, 3, 2, 5, 4, 1, 6)).reshape(-1)


def v2_bounds(L: int, weights) -> tuple[bool, bool]:
    """(supported, fused_s) for the f32 byte-plane schoolbook: every A-plane
    must stay exact in f32 (< 2^24) and the combined columns must fit 32
    bits; with fused_s, c + u16 fits 32 bits too, so the final carry
    resolution runs once."""
    max_sw = max(sum(g) for g in weights)
    P = 255 * 255
    a2 = 2 * L * P * max_sw
    c_bound = 2 * (L * P * max_sw) + (a2 << 8)
    if a2 >= 1 << 24 or c_bound >= 1 << 32:
        return False, False
    u16_bound = 2 * L * P * 257
    return True, c_bound + u16_bound < (1 << 32)


def v2_supported(modulus: int, L: int, weights) -> bool:
    """Whether the f32 route takes these weights: `v2_bounds` and the REDC
    bound max_g sum_s W[g, s] * N < R."""
    ok, _ = v2_bounds(L, weights)
    return ok and modulus * max(sum(g) for g in weights) < (1 << (16 * L))
