from .enums import (
    BatchExpMode,
    CheckForCorrectness,
    ContributionMode,
    CurveKind,
    ElementType,
    ProvingSystem,
    SubgroupCheckMode,
    UseCompression,
)
from .errors import (
    Error,
    InvalidChunkError,
    InvalidLengthError,
    IncorrectSubgroupError,
    PointAtInfinityError,
    Phase2Error,
    InvariantKind,
    SerializationError,
    VerificationError,
)
from .helpers import log_2, upgrade_correctness_check_config, print_hash_grid
from .tracing import info_span, get_logger

__all__ = [
    "BatchExpMode",
    "CheckForCorrectness",
    "ContributionMode",
    "CurveKind",
    "ElementType",
    "ProvingSystem",
    "SubgroupCheckMode",
    "UseCompression",
    "Error",
    "InvalidChunkError",
    "InvalidLengthError",
    "IncorrectSubgroupError",
    "PointAtInfinityError",
    "Phase2Error",
    "InvariantKind",
    "SerializationError",
    "VerificationError",
    "log_2",
    "upgrade_correctness_check_config",
    "print_hash_grid",
    "info_span",
    "get_logger",
]
