"""Phase-1 CLI commands — new / contribute (beacon is contribute with a
beacon-derived rng).

Each function mirrors the observable behavior of the same-named reference
command module (phase1-cli/src/*.rs): the same compression policy constants,
the same length preconditions, the same hash side-files, and the same
hash-chain placement (the previous file's Blake2b-512 digest lives at bytes
[0, 64) of the next file).
"""

from __future__ import annotations

from ..phase1.parameters import Phase1Parameters
from ..phase1.protocol import Phase1
from ..transcript.hashing import blank_hash, calculate_hash
from ..utils.enums import BatchExpMode, CheckForCorrectness, UseCompression
from ..utils.helpers import print_hash_grid
from ..utils.tracing import get_logger
from .fileio import create_writable_map, open_readable_map, write_to_file

logger = get_logger("snark_setup_tpu_torch.cli.phase1")

# Compression policy (compile-time consts in the reference):
# challenges are uncompressed, responses compressed
# (phase1-cli/src/contribute.rs:14-15, new_challenge.rs:10).
COMPRESSED_INPUT = UseCompression.NO
COMPRESSED_OUTPUT = UseCompression.YES
COMPRESS_NEW_CHALLENGE = UseCompression.NO


def new_challenge(
    challenge_filename: str,
    challenge_hash_filename: str,
    parameters: Phase1Parameters,
) -> bytes:
    """Create the initial challenge file. Reference:
    phase1-cli/src/new_challenge.rs:12-69. Host-only: no device work."""
    logger.info(
        "Will generate an empty accumulator for 2^%d powers of tau",
        parameters.total_size_in_log2,
    )
    expected = parameters.get_length(COMPRESS_NEW_CHALLENGE)
    writable = create_writable_map(challenge_filename, expected)
    try:
        writable[0:64] = blank_hash()
        Phase1.initialization(writable, COMPRESS_NEW_CHALLENGE, parameters)
        contribution_hash = calculate_hash(writable)
    finally:
        writable.flush()
        writable.close()
    write_to_file(challenge_hash_filename, contribution_hash)
    logger.info("Empty contribution is formed with a hash:%s", print_hash_grid(contribution_hash))
    return contribution_hash


def contribute(
    challenge_filename: str,
    challenge_hash_filename: str,
    response_filename: str,
    response_hash_filename: str,
    check_input_correctness: CheckForCorrectness,
    batch_exp_mode: BatchExpMode,
    parameters: Phase1Parameters,
    rng,
    device=None,
) -> bytes:
    """Produce a response to a challenge, on the card unless `device="cpu"`.
    Reference: phase1-cli/src/contribute.rs:17-153 (beacon is the same
    function with a beacon-derived rng, bin/phase1.rs:79-97)."""
    expected_challenge_length = parameters.get_length(COMPRESSED_INPUT)
    readable = open_readable_map(challenge_filename, expected_challenge_length)

    required_output_length = (
        parameters.contribution_size
        if COMPRESSED_OUTPUT is UseCompression.YES
        else parameters.accumulator_size + parameters.public_key_size
    )
    writable = create_writable_map(response_filename, required_output_length)
    try:
        logger.info("Calculating previous contribution hash...")
        current_accumulator_hash = calculate_hash(readable)
        logger.info(
            "`challenge` file contains decompressed points and has a hash:%s",
            print_hash_grid(current_accumulator_hash),
        )
        write_to_file(challenge_hash_filename, current_accumulator_hash)
        writable[0:64] = current_accumulator_hash

        public_key, private_key = Phase1.key_generation(
            parameters.spec, rng, current_accumulator_hash
        )

        logger.info("Computing and writing your contribution, this could take a while...")
        Phase1.computation(
            readable,
            writable,
            COMPRESSED_INPUT,
            COMPRESSED_OUTPUT,
            check_input_correctness,
            batch_exp_mode,
            private_key,
            parameters,
            device=device,
        )
        public_key.write(writable, COMPRESSED_OUTPUT, parameters)
        contribution_hash = calculate_hash(writable)
    finally:
        writable.flush()
        writable.close()
        readable.close()

    write_to_file(response_hash_filename, contribution_hash)
    logger.info(
        "Done! The BLAKE2b hash of response file is:%s", print_hash_grid(contribution_hash)
    )
    return contribution_hash
