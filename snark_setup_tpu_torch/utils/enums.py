"""Config enums mirroring the reference's policy knobs.

Reference: setup-utils/src/elements.rs:17-102 and
setup-utils/src/converters.rs:17-89 of nimiq/snark-setup.
"""

import enum


class UseCompression(enum.Enum):
    """Whether group elements on the wire are point-compressed.

    Reference: setup-utils/src/elements.rs:15 (alias of ark_serialize::Compress).
    """

    NO = "no"
    YES = "yes"

    @property
    def is_compressed(self) -> bool:
        return self is UseCompression.YES


class CheckForCorrectness(enum.Enum):
    """Input-validation policy when deserializing points.

    Reference: setup-utils/src/elements.rs:17-43.
    FULL       -> on-curve + subgroup check + nonzero
    ONLY_NON_ZERO -> nonzero only
    ONLY_IN_GROUP -> on-curve + subgroup check
    NO         -> parse only
    """

    FULL = "full"
    ONLY_NON_ZERO = "only-non-zero"
    ONLY_IN_GROUP = "only-in-group"
    NO = "no"

    @property
    def validate(self) -> bool:
        """Maps to arkworks Validate (elements.rs:36-43)."""
        return self in (CheckForCorrectness.FULL, CheckForCorrectness.ONLY_IN_GROUP)


class BatchExpMode(enum.Enum):
    """Batch exponentiation algorithm selection.

    Reference: setup-utils/src/elements.rs:66-82. The reference stubs
    BatchInversion (helpers.rs:89-115, a PITODO); we implement it for real on
    device (simultaneous affine additions via batched inversion).
    """

    AUTO = "auto"
    DIRECT = "direct"
    BATCH_INVERSION = "batch-inversion"


class SubgroupCheckMode(enum.Enum):
    """Prime-order subgroup check selection.

    Reference: setup-utils/src/elements.rs:85-102; the Batched mode is
    disabled there (elements.rs:123-139) — implemented for real here via a
    random-linear-combination check.
    """

    AUTO = "auto"
    DIRECT = "direct"
    BATCHED = "batched"
    NO = "no"


class ContributionMode(enum.Enum):
    """Full accumulator vs. per-chunk contribution.

    Reference: setup-utils/src/converters.rs (ContributionMode).
    """

    FULL = "full"
    CHUNKED = "chunked"


class ProvingSystem(enum.Enum):
    """Supported proving systems. Reference: phase1/src/lib.rs:40-56."""

    GROTH16 = "groth16"
    MARLIN = "marlin"


class CurveKind(enum.Enum):
    """CLI-selectable curves. Reference: setup-utils/src/converters.rs:17-23.

    BLS12-381 is additionally exercised by tests (phase2/tests/mpc.rs:4).
    """

    BLS12_377 = "bls12_377"
    BW6_761 = "bw6"
    MNT4_753 = "mnt4_753"
    MNT6_753 = "mnt6_753"
    BLS12_381 = "bls12_381"


class ElementType(enum.Enum):
    """Accumulator vector sections. Reference: setup-utils/src/elements.rs:45-64."""

    TAU_G1 = "tau_g1"
    TAU_G2 = "tau_g2"
    ALPHA_G1 = "alpha_g1"
    BETA_G1 = "beta_g1"
    BETA_G2 = "beta_g2"
