"""Phase-2 keypair: delta trapdoor + signature-of-knowledge public key.

Reference: phase2/src/keypair.rs — PublicKey layout (delta_after, s,
s_delta, r_delta uncompressed + 64-byte transcript; 544 B on BLS12-377,
keypair.rs:25,227-229), u32 big-endian batch count (keypair.rs:61-76),
transcript hash chain H(cs_hash ‖ prior pubkeys ‖ ser_c(s) ‖ ser_c(s_delta))
(keypair.rs:155-179).
"""

from __future__ import annotations

import hashlib
import io
from dataclasses import dataclass

from ..curves.constants import CurveSpec
from ..curves.host import AffinePoint, g1_curve, g2_curve
from ..serialize.arkworks import g1_codec, g2_codec
from ..transcript.arkrand import ArkRng
from ..transcript.hashing import hash_to_g2
from ..utils.enums import CheckForCorrectness, UseCompression


@dataclass
class Phase2PrivateKey:
    """The delta trapdoor — must be destroyed after contributing."""

    delta: int


@dataclass
class Phase2PublicKey:
    delta_after: AffinePoint
    s: AffinePoint
    s_delta: AffinePoint
    r_delta: AffinePoint  # G2
    transcript: bytes  # 64

    def write(self, spec: CurveSpec) -> bytes:
        c1, c2 = g1_codec(spec), g2_codec(spec)
        out = io.BytesIO()
        for p in (self.delta_after, self.s, self.s_delta):
            out.write(c1.serialize(p, UseCompression.NO))
        out.write(c2.serialize(self.r_delta, UseCompression.NO))
        out.write(self.transcript)
        return out.getvalue()

    @classmethod
    def read(cls, spec: CurveSpec, data, offset: int = 0) -> tuple["Phase2PublicKey", int]:
        """Parse one public key at `offset`; returns (key, next_offset).
        Points are validated Full like the reference's read (keypair.rs:95)."""
        c1, c2 = g1_codec(spec), g2_codec(spec)
        s1, s2 = c1.uncompressed_size, c2.uncompressed_size
        pos = offset
        pts = []
        for _ in range(3):
            pts.append(
                c1.deserialize(bytes(data[pos : pos + s1]), UseCompression.NO, CheckForCorrectness.FULL)
            )
            pos += s1
        r_delta = c2.deserialize(bytes(data[pos : pos + s2]), UseCompression.NO, CheckForCorrectness.FULL)
        pos += s2
        transcript = bytes(data[pos : pos + 64])
        pos += 64
        return cls(pts[0], pts[1], pts[2], r_delta, transcript), pos

    @staticmethod
    def size(spec: CurveSpec) -> int:
        c1, c2 = g1_codec(spec), g2_codec(spec)
        return 3 * c1.uncompressed_size + c2.uncompressed_size + 64

    def hash(self, spec: CurveSpec) -> bytes:
        """Blake2b-512 of the serialized key (keypair.rs:51-59)."""
        return hashlib.blake2b(self.write(spec), digest_size=64).digest()

    @staticmethod
    def write_batch(spec: CurveSpec, pub_keys: list["Phase2PublicKey"]) -> bytes:
        out = io.BytesIO()
        out.write(len(pub_keys).to_bytes(4, "big"))
        for pk in pub_keys:
            out.write(pk.write(spec))
        return out.getvalue()

    @staticmethod
    def read_batch(spec: CurveSpec, data, offset: int = 0) -> tuple[list["Phase2PublicKey"], int]:
        n = int.from_bytes(bytes(data[offset : offset + 4]), "big")
        pos = offset + 4
        out = []
        for _ in range(n):
            pk, pos = Phase2PublicKey.read(spec, data, pos)
            out.append(pk)
        return out, pos


@dataclass
class Keypair:
    public_key: Phase2PublicKey
    private_key: Phase2PrivateKey

    @classmethod
    def new(
        cls,
        spec: CurveSpec,
        rng: ArkRng,
        delta_g1: AffinePoint,
        cs_hash: bytes,
        contributions: list[Phase2PublicKey],
    ) -> "Keypair":
        """RNG consumption order mirrors keypair.rs:124-138: delta, then s."""
        g1c, g2c = g1_curve(spec), g2_curve(spec)
        delta = rng.fr_rand(spec)
        delta_after = g1c.mul(delta_g1, delta)
        s = rng.g1_projective_rand(g1c)
        s_delta = g1c.mul(s, delta)
        transcript = hash_cs_pub_keys(spec, cs_hash, contributions, s, s_delta)
        r = hash_to_g2(spec, transcript)
        r_delta = g2c.mul(r, delta)
        return cls(
            Phase2PublicKey(delta_after, s, s_delta, r_delta, transcript),
            Phase2PrivateKey(delta),
        )


def hash_cs_pub_keys(
    spec: CurveSpec,
    cs_hash: bytes,
    contributions: list[Phase2PublicKey],
    s: AffinePoint,
    s_delta: AffinePoint,
) -> bytes:
    """H(cs_hash ‖ contributions ‖ ser_c(s) ‖ ser_c(s_delta)), Blake2b-512."""
    c1 = g1_codec(spec)
    h = hashlib.blake2b(digest_size=64)
    h.update(cs_hash)
    for pk in contributions:
        h.update(pk.write(spec))
    h.update(c1.serialize(s, UseCompression.YES))
    h.update(c1.serialize(s_delta, UseCompression.YES))
    return h.digest()
