"""SHA-256 preimage R1CS circuit (the reference's "complex" test circuit).

Reference capability: TestHashCircuit (phase2/src/helpers/testing.rs:14-35)
— prove knowledge of a 32-byte x with SHA256(x) = digest, digest exposed as
packed field-element public inputs. This is an independent gadget
implementation (not a port of ark-r1cs-std's Sha256Gadget): one 512-bit
block (32-byte messages only), single-multiplication Ch, two-multiplication
Maj, carry-decomposed 32-bit additions. ~26k constraints.

Public-input packing follows ark's bytes→field packing: chunks of
floor((Fr_bits−1)/8) bytes, little-endian per chunk.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from .r1cs import ConstraintSystem, LinearCombination, Variable

_K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]
_H0 = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]


@dataclass
class Bit:
    """One wire valued in {0,1}: a linear combination + concrete value
    (None in setup mode). Constants carry lc on the ONE variable."""

    lc: dict  # Variable -> coeff
    val: int | None
    const: bool = False


class _Builder:
    def __init__(self, cs: ConstraintSystem):
        self.cs = cs
        self.r = cs.r
        self.one = cs.one

    # -- lc algebra ---------------------------------------------------------
    def _combine(self, *terms) -> dict:
        out: dict = {}
        for coeff, lc in terms:
            for v, c in lc.items():
                out[v] = (out.get(v, 0) + coeff * c) % self.r
        return {v: c for v, c in out.items() if c}

    def _enforce(self, a: dict, b: dict, c: dict):
        self.cs.enforce_constraint(
            LinearCombination(a), LinearCombination(b), LinearCombination(c)
        )

    def const_bit(self, v: int) -> Bit:
        return Bit({self.one: v % self.r} if v else {}, v, const=True)

    def alloc_bit(self, val: int | None) -> Bit:
        v = self.cs.new_witness_variable(val if not self.cs.setup else None)
        lc = {v: 1}
        self._enforce(lc, lc, lc)  # b*b = b
        return Bit(lc, val)

    def xor(self, a: Bit, b: Bit) -> Bit:
        if a.const:
            a, b = b, a
        if b.const:
            if b.val == 0:
                return a
            # NOT a: 1 - a (linear, no constraint)
            lc = self._combine((1, {self.one: 1}), (-1, a.lc))
            return Bit(lc, None if a.val is None else 1 - a.val, a.const)
        val = None if a.val is None or b.val is None else a.val ^ b.val
        out = self.alloc_bit(val)
        # 2a * b = a + b - out
        self._enforce(
            self._combine((2, a.lc)),
            b.lc,
            self._combine((1, a.lc), (1, b.lc), (-1, out.lc)),
        )
        return out

    def ch(self, e: Bit, f: Bit, g: Bit) -> Bit:
        """Ch = e(f−g)+g — one multiplication; result is f or g, so no
        booleanity constraint is needed."""
        val = None if None in (e.val, f.val, g.val) else (f.val if e.val else g.val)
        v = self.cs.new_witness_variable(val if not self.cs.setup else None)
        out = Bit({v: 1}, val)
        self._enforce(
            e.lc,
            self._combine((1, f.lc), (-1, g.lc)),
            self._combine((1, out.lc), (-1, g.lc)),
        )
        return out

    def maj(self, a: Bit, b: Bit, c: Bit) -> Bit:
        """Maj via t = b·c, then a·(b+c−2t) = out−t — two multiplications."""
        tval = None if None in (b.val, c.val) else b.val & c.val
        t = self.cs.new_witness_variable(tval if not self.cs.setup else None)
        t_lc = {t: 1}
        self._enforce(b.lc, c.lc, t_lc)
        oval = (
            None
            if None in (a.val, b.val, c.val)
            else (a.val & b.val) ^ (a.val & c.val) ^ (b.val & c.val)
        )
        v = self.cs.new_witness_variable(oval if not self.cs.setup else None)
        out = Bit({v: 1}, oval)
        self._enforce(
            a.lc,
            self._combine((1, b.lc), (1, c.lc), (-2, t_lc)),
            self._combine((1, out.lc), (-1, t_lc)),
        )
        return out

    # -- 32-bit words as LSB-first bit lists ---------------------------------
    def word_const(self, v: int) -> list[Bit]:
        return [self.const_bit((v >> i) & 1) for i in range(32)]

    def word_xor(self, x: list[Bit], y: list[Bit]) -> list[Bit]:
        return [self.xor(a, b) for a, b in zip(x, y)]

    def rotr(self, x: list[Bit], n: int) -> list[Bit]:
        # LSB-first: rotr(x, n)[i] = x[(i + n) % 32]
        return [x[(i + n) % 32] for i in range(32)]

    def shr(self, x: list[Bit], n: int) -> list[Bit]:
        return [x[i + n] if i + n < 32 else self.const_bit(0) for i in range(32)]

    def add_words(self, words: list[list[Bit]]) -> list[Bit]:
        """Sum k words mod 2^32: allocate 32 result bits + carry bits and
        enforce the single linear identity Σ words = result + carry·2^32."""
        k = len(words)
        n_carry = max((k - 1).bit_length(), 1)
        total = None
        if not self.cs.setup:
            total = sum(
                sum((b.val << i) for i, b in enumerate(w)) for w in words
            )
        res_bits = [
            self.alloc_bit(None if total is None else (total >> i) & 1)
            for i in range(32)
        ]
        carry_bits = [
            self.alloc_bit(None if total is None else (total >> (32 + j)) & 1)
            for j in range(n_carry)
        ]
        lhs_terms = [(1 << i, b.lc) for w in words for i, b in enumerate(w)]
        rhs_terms = [(-(1 << i), b.lc) for i, b in enumerate(res_bits)]
        rhs_terms += [(-(1 << (32 + j)), b.lc) for j, b in enumerate(carry_bits)]
        # (Σ lhs − Σ rhs) * 1 = 0
        self._enforce(
            self._combine(*lhs_terms, *rhs_terms), {self.one: 1}, {}
        )
        return res_bits


def _sha256_block(bld: _Builder, block_bits: list[Bit]) -> list[list[Bit]]:
    """One compression round over a 512-bit block (LSB-first words)."""
    w = [block_bits[i * 32 : (i + 1) * 32] for i in range(16)]
    for t in range(16, 64):
        s0 = bld.word_xor(
            bld.word_xor(bld.rotr(w[t - 15], 7), bld.rotr(w[t - 15], 18)),
            bld.shr(w[t - 15], 3),
        )
        s1 = bld.word_xor(
            bld.word_xor(bld.rotr(w[t - 2], 17), bld.rotr(w[t - 2], 19)),
            bld.shr(w[t - 2], 10),
        )
        w.append(bld.add_words([w[t - 16], s0, w[t - 7], s1]))

    a, b, c, d, e, f, g, h = [bld.word_const(v) for v in _H0]
    for t in range(64):
        big_s1 = bld.word_xor(
            bld.word_xor(bld.rotr(e, 6), bld.rotr(e, 11)), bld.rotr(e, 25)
        )
        ch = [bld.ch(e[i], f[i], g[i]) for i in range(32)]
        t1 = bld.add_words([h, big_s1, ch, bld.word_const(_K[t]), w[t]])
        big_s0 = bld.word_xor(
            bld.word_xor(bld.rotr(a, 2), bld.rotr(a, 13)), bld.rotr(a, 22)
        )
        maj = [bld.maj(a[i], b[i], c[i]) for i in range(32)]
        t2 = bld.add_words([big_s0, maj])
        h, g, f = g, f, e
        e = bld.add_words([d, t1])
        d, c, b = c, b, a
        a = bld.add_words([t1, t2])

    return [
        bld.add_words([x, bld.word_const(v)])
        for x, v in zip([a, b, c, d, e, f, g, h], _H0)
    ]


def _pack_capacity_bytes(r: int) -> int:
    return (r.bit_length() - 1) // 8


def pack_digest(r: int, digest: bytes) -> list[int]:
    """ark bytes→field packing: chunks of capacity bytes, LE per chunk."""
    cap = _pack_capacity_bytes(r)
    return [
        int.from_bytes(digest[i : i + cap], "little") % r
        for i in range(0, len(digest), cap)
    ]


@dataclass
class TestHashCircuit:
    """Knowledge of a 32-byte SHA-256 preimage."""

    __test__ = False  # not a pytest class
    preimage: bytes

    def public_inputs(self, r: int) -> list[int]:
        return pack_digest(r, hashlib.sha256(self.preimage).digest())

    def generate_constraints(self, cs: ConstraintSystem) -> None:
        assert len(self.preimage) == 32
        bld = _Builder(cs)
        setup = cs.setup

        # witness: the preimage bits (LSB-first within each byte, bytes in
        # message order), constrained boolean by alloc_bit
        msg_bits = []
        for byte in self.preimage:
            for i in range(8):
                msg_bits.append(bld.alloc_bit(None if setup else (byte >> i) & 1))

        # one padded 512-bit block: msg(256) || 0x80 || zeros || len=256 (BE)
        padding = bytes([0x80] + [0] * 29 + [0x01, 0x00])
        pad_bits = [
            bld.const_bit((byte >> i) & 1) for byte in padding for i in range(8)
        ]
        all_bytes = msg_bits + pad_bits  # 512 bits, byte-order, LSB-first bits

        # SHA-256 words are big-endian 32-bit reads of the byte stream;
        # convert byte-ordered LSB-first bits into LSB-first word bit lists
        block = []
        for word_i in range(16):
            word_bytes = [all_bytes[(word_i * 4 + j) * 8 : (word_i * 4 + j + 1) * 8] for j in range(4)]
            bits = [None] * 32
            for j, byte_bits in enumerate(word_bytes):
                for i in range(8):
                    # byte j is bits [24-8j, 32-8j) of the word (big-endian)
                    bits[8 * (3 - j) + i] = byte_bits[i]
            block.extend(bits)

        out_words = _sha256_block(bld, block)

        # digest bytes (big-endian per word) packed LE into field inputs
        digest_bits_by_byte: list[list] = []
        for word in out_words:
            for j in range(4):
                digest_bits_by_byte.append(word[8 * (3 - j) : 8 * (3 - j) + 8])

        digest_val = None if setup else hashlib.sha256(self.preimage).digest()
        cap = _pack_capacity_bytes(cs.r)
        for chunk_start in range(0, 32, cap):
            chunk = digest_bits_by_byte[chunk_start : chunk_start + cap]
            inp_val = (
                None
                if setup
                else int.from_bytes(
                    digest_val[chunk_start : chunk_start + cap], "little"
                ) % cs.r
            )
            inp = cs.new_input_variable(inp_val)
            terms = [(1, {inp: 1})]
            for byte_i, byte_bits in enumerate(chunk):
                for i in range(8):
                    terms.append((-(1 << (8 * byte_i + i)), byte_bits[i].lc))
            bld._enforce(bld._combine(*terms), {bld.one: 1}, {})
