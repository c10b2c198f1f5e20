"""Error taxonomy mirroring the reference's setup-utils/src/errors.rs:10-104."""

import enum


class Error(Exception):
    """Base error (reference `Error` enum)."""


class SerializationError(Error):
    """Point / field (de)serialization failures."""


class PointAtInfinityError(SerializationError):
    """Deserialized the point at infinity where disallowed."""


class InvalidLengthError(Error):
    def __init__(self, expected: int, got: int):
        super().__init__(f"invalid length: expected {expected}, got {got}")
        self.expected = expected
        self.got = got


class InvalidChunkError(Error):
    pass


class IncorrectSubgroupError(Error):
    """Element not in the prime-order subgroup."""


class BatchTooSmallError(Error):
    pass


class HashChainError(Error):
    """Response's embedded hash does not match H(challenge).

    Reference: panic!("Hash chain failure...") in
    phase1-cli/src/transform_pok_and_correctness.rs:116.
    """


class VerificationError(Error):
    """Reference `VerificationError` (errors.rs)."""


class VerificationFailedError(VerificationError):
    """Fatal ceremony verification failure.

    Reference: panic!("INVALID CONTRIBUTION!!!") in
    phase1-cli/src/transform_pok_and_correctness.rs:196.
    """


class InvalidRatioError(VerificationError):
    def __init__(self, context: str):
        super().__init__(f"invalid ratio: {context}")
        self.context = context


class InvalidGeneratorError(VerificationError):
    def __init__(self, element_type):
        super().__init__(f"invalid generator for {element_type}")
        self.element_type = element_type


class InvariantKind(enum.Enum):
    """Reference errors.rs InvariantKind (12 variants)."""

    ALPHA_G1 = "AlphaG1"
    BETA_G1 = "BetaG1"
    BETA_G2 = "BetaG2"
    GAMMA_ABC_G1 = "GammaAbcG1"
    GAMMA_G2 = "GammaG2"
    DELTA_G1 = "DeltaG1"
    DELTA_G2 = "DeltaG2"
    A_QUERY = "AQuery"
    B_G1_QUERY = "BG1Query"
    B_G2_QUERY = "BG2Query"
    H_QUERY = "HQuery"
    L_QUERY = "LQuery"
    TRANSCRIPT = "Transcript"
    CONTRIBUTION_COUNT = "ContributionCount"
    CS_HASH = "CsHash"
    CONTRIBUTIONS = "Contributions"


class Phase2Error(Error):
    """Reference `Phase2Error`."""


class BrokenInvariantError(Phase2Error):
    def __init__(self, kind: InvariantKind):
        super().__init__(f"broken invariant: {kind.value}")
        self.kind = kind


class NoContributionsError(Phase2Error):
    pass


class InvalidTranscriptError(Phase2Error):
    pass


class UnconstrainedVariableError(Phase2Error):
    """A witness variable has an all-zero L query row
    (SynthesisError::UnconstrainedVariable, parameters.rs:132-135)."""
