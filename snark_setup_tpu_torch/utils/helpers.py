"""Small shared helpers (reference: setup-utils/src/helpers.rs misc fns)."""

from .enums import CheckForCorrectness


def log_2(x: int) -> int:
    """Floor log2. Reference: setup-utils/src/helpers.rs:211-214."""
    assert x > 0
    return x.bit_length() - 1


def upgrade_correctness_check_config(
    check_correctness: CheckForCorrectness, force_correctness_checks: bool
) -> CheckForCorrectness:
    """Reference: setup-utils/src/helpers.rs:554-563."""
    if force_correctness_checks:
        if check_correctness is CheckForCorrectness.NO:
            return CheckForCorrectness.ONLY_IN_GROUP
        if check_correctness is CheckForCorrectness.ONLY_NON_ZERO:
            return CheckForCorrectness.FULL
    return check_correctness


def print_hash_grid(hash_bytes: bytes) -> str:
    """Human-friendly 4x16-byte hex grid of a 64-byte hash.

    Reference: setup-utils/src/helpers.rs:39-53 (print_hash).
    """
    lines = ["\n"]
    for off in range(0, len(hash_bytes), 16):
        line = hash_bytes[off : off + 16]
        sections = [line[i : i + 4].hex() for i in range(0, len(line), 4)]
        lines.append("\t" + " ".join(sections) + " \n")
    return "".join(lines)
