"""Ceremony geometry — byte-exact replica of Phase1Parameters.

Reference: phase1/src/objects/parameters.rs:14-294. All size formulas are
reproduced exactly (accumulator_size :135-160, contribution_size :168-197,
chunk_sizes :246-294) so files interoperate byte-for-byte.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..curves.constants import CurveSpec, get_curve
from ..utils.enums import ContributionMode, ProvingSystem, UseCompression

HASH_SIZE = 64


@dataclass
class CurveParameters:
    """Serialized element sizes (parameters.rs:14-37)."""

    g1_size: int
    g2_size: int
    g1_compressed_size: int
    g2_compressed_size: int

    @classmethod
    def from_spec(cls, spec: CurveSpec) -> "CurveParameters":
        return cls(
            g1_size=spec.g1.uncompressed_size,
            g2_size=spec.g2.uncompressed_size,
            g1_compressed_size=spec.g1.compressed_size,
            g2_compressed_size=spec.g2.compressed_size,
        )


@dataclass
class Phase1Parameters:
    spec: CurveSpec
    contribution_mode: ContributionMode
    chunk_index: int
    chunk_size: int
    proving_system: ProvingSystem
    total_size_in_log2: int
    batch_size: int
    curve: CurveParameters = field(init=False)
    g1_chunk_size: int = field(init=False)
    other_chunk_size: int = field(init=False)
    powers_length: int = field(init=False)
    powers_g1_length: int = field(init=False)
    accumulator_size: int = field(init=False)
    public_key_size: int = field(init=False)
    contribution_size: int = field(init=False)
    hash_size: int = HASH_SIZE

    def __post_init__(self):
        assert self.batch_size > 0, "batch_size must be positive"
        self.curve = CurveParameters.from_spec(self.spec)
        c = self.curve
        n = self.total_size_in_log2
        self.powers_length = 1 << n
        self.powers_g1_length = (self.powers_length << 1) - 1
        self.g1_chunk_size, self.other_chunk_size = self._chunk_sizes()

        if self.proving_system is ProvingSystem.GROTH16:
            self.accumulator_size = (
                self.g1_chunk_size * c.g1_size
                + self.other_chunk_size * (c.g2_size + 2 * c.g1_size)
                + c.g2_size
                + HASH_SIZE
            )
        else:  # Marlin
            extra = 0
            if self.chunk_index == 0:
                extra = (
                    3 * c.g1_size
                    + 3 * n * c.g1_size
                    + (n + 2) * c.g2_size
                )
            self.accumulator_size = self.g1_chunk_size * c.g1_size + extra + HASH_SIZE

        self.public_key_size = 3 * c.g2_compressed_size + 6 * c.g1_compressed_size

        if self.proving_system is ProvingSystem.GROTH16:
            self.contribution_size = (
                self.g1_chunk_size * c.g1_compressed_size
                + self.other_chunk_size * (c.g2_compressed_size + 2 * c.g1_compressed_size)
                + c.g2_compressed_size
                + HASH_SIZE
                + self.public_key_size
            )
        else:
            extra = 0
            if self.chunk_index == 0:
                extra = (
                    3 * c.g1_compressed_size
                    + 3 * n * c.g1_compressed_size
                    + (n + 2) * c.g2_compressed_size
                )
            self.contribution_size = (
                self.g1_chunk_size * c.g1_compressed_size + extra + HASH_SIZE + self.public_key_size
            )

    # -- constructors (parameters.rs:77-128) -------------------------------
    @classmethod
    def new_full(
        cls, curve, proving_system: ProvingSystem, total_size_in_log2: int, batch_size: int
    ) -> "Phase1Parameters":
        spec = curve if isinstance(curve, CurveSpec) else get_curve(curve)
        return cls(
            spec, ContributionMode.FULL, 0, 0, proving_system, total_size_in_log2, batch_size
        )

    @classmethod
    def new_chunk(
        cls,
        curve,
        contribution_mode: ContributionMode,
        chunk_index: int,
        chunk_size: int,
        proving_system: ProvingSystem,
        total_size_in_log2: int,
        batch_size: int,
    ) -> "Phase1Parameters":
        spec = curve if isinstance(curve, CurveSpec) else get_curve(curve)
        return cls(
            spec,
            contribution_mode,
            chunk_index,
            chunk_size,
            proving_system,
            total_size_in_log2,
            batch_size,
        )

    def into_chunk_parameters(
        self, contribution_mode: ContributionMode, chunk_index: int, chunk_size: int
    ) -> "Phase1Parameters":
        return Phase1Parameters(
            self.spec,
            contribution_mode,
            chunk_index,
            chunk_size,
            self.proving_system,
            self.total_size_in_log2,
            self.batch_size,
        )

    def get_length(self, compressed: UseCompression) -> int:
        if compressed is UseCompression.YES:
            return self.contribution_size - self.public_key_size
        return self.accumulator_size

    def _chunk_sizes(self) -> tuple[int, int]:
        upper_bound = (
            self.powers_g1_length
            if self.proving_system is ProvingSystem.GROTH16
            else self.powers_length
        )
        if self.contribution_mode is ContributionMode.CHUNKED:
            start = self.chunk_index * self.chunk_size
            end = (self.chunk_index + 1) * self.chunk_size
        else:
            start, end = 0, upper_bound

        g1_chunk_size = upper_bound - start if end > upper_bound else end - start

        if self.proving_system is ProvingSystem.GROTH16:
            if end > self.powers_length and start >= self.powers_length:
                other = 0
            elif end > self.powers_length:
                other = self.powers_length - start
            else:
                other = end - start
        else:
            other = 0
        return g1_chunk_size, other

    @property
    def num_chunks(self) -> int:
        upper_bound = (
            self.powers_g1_length
            if self.proving_system is ProvingSystem.GROTH16
            else self.powers_length
        )
        assert self.chunk_size > 0
        return -(-upper_bound // self.chunk_size)
