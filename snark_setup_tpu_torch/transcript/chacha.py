"""Bit-exact replica of rand_chacha 0.3's ChaCha20Rng.

The reference seeds ChaChaRng from Blake2 digests for every deterministic
randomness path (get_rng: setup-utils/src/helpers.rs:201-204; hash_to_g2:
helpers.rs:277-291; derive_rng_from_seed: seed.rs:5-14), so the exact
keystream *and* the exact rand-core consumption pattern (next_u32 /
next_u64 / BlockRng buffer boundaries) are part of the wire protocol.

ChaCha20 "djb" variant: 64-bit block counter in state words 12-13, 64-bit
stream id in words 14-15 (both zero-initialized), 20 rounds. rand_chacha
generates 4 blocks (64 u32 words) per refill.
"""

from __future__ import annotations

import numpy as np

MASK32 = 0xFFFFFFFF

_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def _rotl(x: int, n: int) -> int:
    return ((x << n) | (x >> (32 - n))) & MASK32


def _quarter_round(s, a, b, c, d):
    s[a] = (s[a] + s[b]) & MASK32
    s[d] = _rotl(s[d] ^ s[a], 16)
    s[c] = (s[c] + s[d]) & MASK32
    s[b] = _rotl(s[b] ^ s[c], 12)
    s[a] = (s[a] + s[b]) & MASK32
    s[d] = _rotl(s[d] ^ s[a], 8)
    s[c] = (s[c] + s[d]) & MASK32
    s[b] = _rotl(s[b] ^ s[c], 7)


def chacha20_block(key_words, counter: int, stream_words) -> list[int]:
    """One 64-byte ChaCha20 block as 16 u32 words."""
    init = list(_CONSTANTS) + list(key_words) + [
        counter & MASK32,
        (counter >> 32) & MASK32,
        stream_words[0],
        stream_words[1],
    ]
    s = list(init)
    for _ in range(10):
        _quarter_round(s, 0, 4, 8, 12)
        _quarter_round(s, 1, 5, 9, 13)
        _quarter_round(s, 2, 6, 10, 14)
        _quarter_round(s, 3, 7, 11, 15)
        _quarter_round(s, 0, 5, 10, 15)
        _quarter_round(s, 1, 6, 11, 12)
        _quarter_round(s, 2, 7, 8, 13)
        _quarter_round(s, 3, 4, 9, 14)
    return [(a + b) & MASK32 for a, b in zip(s, init)]


def chacha_words_np(key_words, block0: int, nblocks: int) -> np.ndarray:
    """Bulk ChaCha20 keystream: u32 words of blocks [block0, block0+nblocks)
    as a flat (nblocks*16,) uint32 array — vectorized over the block axis.
    Bit-identical to chacha20_block / the streaming ChaChaRng."""
    return chacha_blocks_np(key_words, np.arange(block0, block0 + nblocks, dtype=np.uint64)).reshape(-1)


def chacha_blocks_np(key_words, counters: np.ndarray) -> np.ndarray:
    """The ChaCha20 blocks at the given block counters (any order, uint64):
    (len(counters), 16) uint32 words — vectorized over the block axis."""
    counters = np.asarray(counters, np.uint64)
    nblocks = counters.shape[0]
    init = np.empty((16, nblocks), np.uint32)
    for i, c in enumerate(_CONSTANTS):
        init[i] = c
    for i, k in enumerate(key_words):
        init[4 + i] = k
    init[12] = (counters & 0xFFFFFFFF).astype(np.uint32)
    init[13] = (counters >> 32).astype(np.uint32)
    init[14] = 0
    init[15] = 0
    s = init.copy()

    def rotl(x, n):
        return (x << np.uint32(n)) | (x >> np.uint32(32 - n))

    def qr(a, b, c, d):
        s[a] += s[b]
        s[d] = rotl(s[d] ^ s[a], 16)
        s[c] += s[d]
        s[b] = rotl(s[b] ^ s[c], 12)
        s[a] += s[b]
        s[d] = rotl(s[d] ^ s[a], 8)
        s[c] += s[d]
        s[b] = rotl(s[b] ^ s[c], 7)

    with np.errstate(over="ignore"):
        for _ in range(10):
            qr(0, 4, 8, 12)
            qr(1, 5, 9, 13)
            qr(2, 6, 10, 14)
            qr(3, 7, 11, 15)
            qr(0, 5, 10, 15)
            qr(1, 6, 11, 12)
            qr(2, 7, 8, 13)
            qr(3, 4, 9, 14)
        s += init
    return s.T


class ChaChaRng:
    """rand_chacha::ChaCha20Rng replica (BlockRng over 4-block refills)."""

    BUF_WORDS = 64  # 4 blocks x 16 words

    def __init__(self, seed: bytes):
        assert len(seed) == 32
        self.key = [int.from_bytes(seed[i : i + 4], "little") for i in range(0, 32, 4)]
        self.stream = [0, 0]
        self.counter = 0  # next block index to generate
        self.buf: list[int] = []
        self.index = self.BUF_WORDS  # force refill on first use

    @classmethod
    def from_seed(cls, seed: bytes) -> "ChaChaRng":
        return cls(seed)

    def _refill(self):
        words = []
        for j in range(4):
            words.extend(chacha20_block(self.key, self.counter + j, self.stream))
        self.counter += 4
        self.buf = words
        self.index = 0

    def next_u32(self) -> int:
        if self.index >= self.BUF_WORDS:
            self._refill()
        v = self.buf[self.index]
        self.index += 1
        return v

    def next_u64(self) -> int:
        """BlockRng::next_u64 semantics, incl. the buffer-boundary case."""
        if self.index >= self.BUF_WORDS:
            self._refill()
        if self.index < self.BUF_WORDS - 1:
            lo = self.buf[self.index]
            hi = self.buf[self.index + 1]
            self.index += 2
            return lo | (hi << 32)
        # index == BUF_WORDS - 1: low word is the last of this buffer,
        # high word is the first of the next.
        lo = self.buf[self.index]
        self._refill()
        hi = self.buf[0]
        self.index = 1
        return lo | (hi << 32)

    def gen_u8(self) -> int:
        """rand 0.8 Standard distribution for u8: next_u32 truncated."""
        return self.next_u32() & 0xFF

    def gen_bool(self) -> bool:
        """rand 0.8 Standard distribution for bool: sign bit of next_u32."""
        return self.next_u32() >= 0x8000_0000

    def fill_bytes(self, n: int) -> bytes:
        """rand_core BlockRng::fill_bytes (fill_via_u32_chunks semantics):
        consume words as LE bytes; a partially-consumed word's remainder is
        discarded (the index advances to the next word boundary)."""
        out = bytearray()
        while len(out) < n:
            if self.index >= self.BUF_WORDS:
                self._refill()
            remaining = n - len(out)
            avail_words = self.BUF_WORDS - self.index
            take_words = min((remaining + 3) // 4, avail_words)
            chunk = b"".join(
                self.buf[self.index + i].to_bytes(4, "little") for i in range(take_words)
            )
            out.extend(chunk[:remaining])
            self.index += take_words
        return bytes(out)
