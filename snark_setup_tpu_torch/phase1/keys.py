"""Phase-1 keypair: proof-of-knowledge public key + trapdoor secrets.

Reference: phase1/src/key_generation.rs:6-54,
phase1/src/objects/public_key.rs (serialization layout + buffer offsets),
phase1/src/objects/private_key.rs.
"""

from __future__ import annotations

import io
from dataclasses import dataclass

from ..curves.constants import CurveSpec
from ..curves.host import AffinePoint, g1_curve, g2_curve
from ..serialize.arkworks import g1_codec, g2_codec
from ..transcript.arkrand import ArkRng
from ..transcript.hashing import compute_g2_s
from ..utils.enums import UseCompression
from ..utils.errors import InvalidLengthError
from .parameters import Phase1Parameters


@dataclass
class PrivateKey:
    """The trapdoors — must be destroyed after contributing."""

    tau: int
    alpha: int
    beta: int


@dataclass
class PublicKey:
    """PoK elements: per secret x, ((g1_s, g1_s^x), H(...)_2^x).

    Serialized (ark derive order, public_key.rs:14-23): the six G1 points
    (tau_g1 pair, alpha_g1 pair, beta_g1 pair) then three G2 points, all
    compressed."""

    tau_g1: tuple[AffinePoint, AffinePoint]
    alpha_g1: tuple[AffinePoint, AffinePoint]
    beta_g1: tuple[AffinePoint, AffinePoint]
    tau_g2: AffinePoint
    alpha_g2: AffinePoint
    beta_g2: AffinePoint

    def serialize(self, spec: CurveSpec) -> bytes:
        c1, c2 = g1_codec(spec), g2_codec(spec)
        out = io.BytesIO()
        for p in (*self.tau_g1, *self.alpha_g1, *self.beta_g1):
            out.write(c1.serialize(p, UseCompression.YES))
        for p in (self.tau_g2, self.alpha_g2, self.beta_g2):
            out.write(c2.serialize(p, UseCompression.YES))
        return out.getvalue()

    @classmethod
    def deserialize(cls, spec: CurveSpec, data: bytes) -> "PublicKey":
        c1, c2 = g1_codec(spec), g2_codec(spec)
        s1, s2 = c1.compressed_size, c2.compressed_size
        g1s = [
            c1.deserialize(data[i * s1 : (i + 1) * s1], UseCompression.YES)
            for i in range(6)
        ]
        off = 6 * s1
        g2s = [
            c2.deserialize(data[off + i * s2 : off + (i + 1) * s2], UseCompression.YES)
            for i in range(3)
        ]
        return cls(
            tau_g1=(g1s[0], g1s[1]),
            alpha_g1=(g1s[2], g1s[3]),
            beta_g1=(g1s[4], g1s[5]),
            tau_g2=g2s[0],
            alpha_g2=g2s[1],
            beta_g2=g2s[2],
        )

    # -- buffer placement (public_key.rs:40-69) ---------------------------
    @staticmethod
    def position(parameters: Phase1Parameters, accumulator_was_compressed: UseCompression) -> int:
        if accumulator_was_compressed is UseCompression.YES:
            return parameters.contribution_size - parameters.public_key_size
        return parameters.accumulator_size

    def write(
        self,
        output: bytearray | memoryview,
        accumulator_was_compressed: UseCompression,
        parameters: Phase1Parameters,
    ) -> None:
        pos = self.position(parameters, accumulator_was_compressed)
        data = self.serialize(parameters.spec)
        output[pos : pos + len(data)] = data

    @classmethod
    def read(
        cls,
        input_buf,
        accumulator_was_compressed: UseCompression,
        parameters: Phase1Parameters,
    ) -> "PublicKey":
        pos = cls.position(parameters, accumulator_was_compressed)
        return cls.deserialize(
            parameters.spec, bytes(memoryview(input_buf)[pos : pos + parameters.public_key_size])
        )


def key_generation(spec: CurveSpec, rng: ArkRng, digest: bytes) -> tuple[PublicKey, PrivateKey]:
    """Sample (tau, alpha, beta) + per-secret PoK, replicating the
    reference's RNG consumption order exactly (key_generation.rs:8-54)."""
    if len(digest) != 64:
        raise InvalidLengthError(64, len(digest))
    g1c, g2c = g1_curve(spec), g2_curve(spec)

    tau = rng.fr_rand(spec)
    alpha = rng.fr_rand(spec)
    beta = rng.fr_rand(spec)

    def op(x: int, personalization: int):
        g1_s = rng.g1_projective_rand(g1c)
        g1_s_x = g1c.mul(g1_s, x)
        g2_s = compute_g2_s(spec, digest, g1_s, g1_s_x, personalization)
        g2_s_x = g2c.mul(g2_s, x)
        return (g1_s, g1_s_x), g2_s_x

    pk_tau = op(tau, 0)
    pk_alpha = op(alpha, 1)
    pk_beta = op(beta, 2)

    return (
        PublicKey(
            tau_g1=pk_tau[0],
            alpha_g1=pk_alpha[0],
            beta_g1=pk_beta[0],
            tau_g2=pk_tau[1],
            alpha_g2=pk_alpha[1],
            beta_g2=pk_beta[1],
        ),
        PrivateKey(tau=tau, alpha=alpha, beta=beta),
    )
