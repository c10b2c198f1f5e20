"""Blake2 hash chain, seed derivation, and hash-to-G2 — host side, bit-exact.

Reference: setup-utils/src/helpers.rs (calculate_hash :266-273, blank_hash
:393-395, reduced_hash :397-401, hash_to_g2 :277-291, compute_g2_s :428-443,
get_rng :201-204, beacon_randomness_sha256_work :166-198) and
setup-utils/src/seed.rs (derive_rng_from_seed).
"""

from __future__ import annotations

import hashlib

from ..curves.constants import CurveSpec
from ..curves.host import AffinePoint, g2_curve
from ..serialize.arkworks import g1_codec, g2_codec
from ..utils.enums import UseCompression
from .arkrand import ArkRng
from .chacha import ChaChaRng

SEED_PERSONALIZATION = b"NIM-SEED"
HASH_CHUNK = 1 << 30  # hash files in 1 GiB chunks (helpers.rs:267)


def calculate_hash(data) -> bytes:
    """Blake2b-512 over the whole buffer (1 GiB chunks)."""
    h = hashlib.blake2b(digest_size=64)
    mv = memoryview(data)
    for off in range(0, len(mv), HASH_CHUNK):
        h.update(mv[off : off + HASH_CHUNK])
    if len(mv) == 0:
        pass
    return h.digest()


def blank_hash() -> bytes:
    """Blake2b-512 of the empty string."""
    return hashlib.blake2b(digest_size=64).digest()


def reduced_hash(old_power: int, new_power: int) -> bytes:
    h = hashlib.blake2b(digest_size=64)
    h.update(bytes([old_power, new_power]))
    return h.digest()


def derive_rng_from_seed(seed: bytes) -> ArkRng:
    """Blake2s-256(personal=NIM-SEED)(seed) -> ChaCha20Rng."""
    digest = hashlib.blake2s(seed, digest_size=32, person=SEED_PERSONALIZATION).digest()
    return ArkRng(ChaChaRng.from_seed(digest))


def get_rng(digest: bytes) -> ArkRng:
    """First 32 digest bytes seed a ChaCha20Rng (helpers.rs:201-204)."""
    return ArkRng(ChaChaRng.from_seed(bytes(digest[:32])))


def hash_to_g2(spec: CurveSpec, digest: bytes) -> AffinePoint:
    """Rejection-sample a G2 point from a ChaCha20 stream seeded with the
    first 32 digest bytes; multiply by the cofactor; retry on zero.

    Byte-consumption detail (interop-critical): each candidate byte is
    rand 0.8's `rng.gen::<u8>()`, which consumes a FULL u32 from the stream,
    so candidate i is the low bytes of keystream words [i n, (i+1) n). The
    rejection rate is high (the unmasked top byte of every base-field
    coefficient must be <= p's, ~2^-21 for MNT6-753's three coefficients), so
    candidates are pre-filtered on those top bytes alone — one keystream
    block per candidate and coefficient, in numpy bulk — and the exact
    arkworks parse runs only on survivors, in stream order: bit-identical to
    the sequential loop, since the pre-filter is a necessary condition of
    the exact one.
    """
    import numpy as np

    from .chacha import chacha_blocks_np, chacha_words_np

    assert len(digest) >= 32
    seed = bytes(digest[:32])
    key_words = [int.from_bytes(seed[i : i + 4], "little") for i in range(0, 32, 4)]
    codec = g2_codec(spec)
    curve = g2_curve(spec)
    n = codec.compressed_size
    fp_bytes = (spec.q.bit_length() + 7) // 8
    deg = codec.ext_degree
    q_bytes = np.frombuffer(spec.q.to_bytes(fp_bytes, "little"), np.uint8)
    q_top = int(q_bytes[-1])

    def lt_q(coeff: np.ndarray) -> bool:
        # lexicographic from the most-significant byte
        for k in range(fp_bytes - 1, -1, -1):
            if coeff[k] != q_bytes[k]:
                return bool(coeff[k] < q_bytes[k])
        return False

    def top_bytes(cands: np.ndarray, c: int) -> np.ndarray:
        """Most significant byte of coefficient c of each candidate."""
        pos = cands * n + c * fp_bytes + fp_bytes - 1
        blocks = chacha_blocks_np(key_words, (pos // 16).astype(np.uint64))
        return (blocks[np.arange(pos.shape[0]), pos % 16] & 0xFF).astype(np.int64)

    CAND_CHUNK = 1 << 16
    first = 0
    while True:
        cands = np.arange(first, first + CAND_CHUNK, dtype=np.int64)
        first += CAND_CHUNK
        # the last coefficient's top byte carries the flags: both set is
        # invalid, and the coefficient is read with them masked off
        b = top_bytes(cands, deg - 1)
        cands = cands[((b & 0xC0) != 0xC0) & ((b & 0x3F) <= q_top)]
        for c in range(deg - 1):
            if cands.size:
                cands = cands[top_bytes(cands, c) <= q_top]
        for i in cands:  # stream order
            w0 = int(i) * n
            words = chacha_words_np(key_words, w0 // 16, (w0 + n - 1) // 16 - w0 // 16 + 1)
            cand = (words[w0 % 16 : w0 % 16 + n] & 0xFF).astype(np.uint8)
            work = cand.copy()
            work[-1] &= 0x3F
            if not all(lt_q(work[c * fp_bytes : (c + 1) * fp_bytes]) for c in range(deg)):
                continue
            p = codec.from_random_bytes(bytes(cand))
            if p is None:
                continue
            scaled = curve.clear_cofactor(p)
            if not scaled.is_infinity:
                return scaled


def compute_g2_s(
    spec: CurveSpec,
    digest: bytes,
    g1_s: AffinePoint,
    g1_s_x: AffinePoint,
    personalization: int,
) -> AffinePoint:
    """Blake2b(personalization || digest || ser_c(g1_s) || ser_c(g1_s_x))
    hashed to G2 (helpers.rs:428-443)."""
    codec = g1_codec(spec)
    h = hashlib.blake2b(digest_size=64)
    h.update(bytes([personalization]))
    h.update(digest)
    h.update(codec.serialize(g1_s, UseCompression.YES))
    h.update(codec.serialize(g1_s_x, UseCompression.YES))
    return hash_to_g2(spec, h.digest())


def user_system_randomness(prompt: bool = True) -> bytes:
    """1024 OS-entropy bytes + optional interactive user entropy, hashed to a
    64-byte seed (helpers.rs:143-164). `prompt=False` skips the stdin read
    for non-interactive use."""
    import os as _os
    import sys as _sys

    h = hashlib.blake2b(digest_size=64)
    h.update(_os.urandom(1024))
    if prompt:
        print("Type some random text and press [ENTER] to provide additional entropy...")
        h.update(_sys.stdin.readline().encode())
    return h.digest()


def beacon_randomness_sha256_work(beacon_hash: bytes, n: int = 42, progress=None) -> bytes:
    """2^n SHA-256 iterations with 1024 interstitial checkpoints
    (helpers.rs:166-198). `n` is parameterized for testability; the CLI
    default matches the reference (N=42)."""
    assert len(beacon_hash) == 32
    cur = bytes(beacon_hash)
    total = 1 << n
    step = 1 << max(n - 10, 0)
    for i in range(total):
        if progress is not None and i % step == 0:
            progress(i, cur)
        cur = hashlib.sha256(cur).digest()
    return cur
