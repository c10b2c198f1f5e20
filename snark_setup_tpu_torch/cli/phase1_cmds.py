"""Phase-1 CLI commands — new / contribute (beacon is contribute with a
beacon-derived rng) / verify-transform / combine / split.

Each function mirrors the observable behavior of the same-named reference
command module (phase1-cli/src/*.rs): the same compression policy constants,
the same length preconditions, the same hash side-files, and the same
hash-chain placement (the previous file's Blake2b-512 digest lives at bytes
[0, 64) of the next file).
"""

from __future__ import annotations

from ..phase1.keys import PublicKey
from ..phase1.parameters import Phase1Parameters
from ..phase1.protocol import Phase1
from ..transcript.hashing import blank_hash, calculate_hash
from ..utils.enums import BatchExpMode, CheckForCorrectness, SubgroupCheckMode, UseCompression
from ..utils.errors import HashChainError, VerificationFailedError
from ..utils.helpers import print_hash_grid
from ..utils.tracing import get_logger
from .fileio import create_writable_map, open_readable_map, write_to_file

logger = get_logger("snark_setup_tpu_torch.cli.phase1")

# Compression policy (compile-time consts in the reference):
# challenges are uncompressed, responses compressed
# (phase1-cli/src/contribute.rs:14-15, new_challenge.rs:10,
#  transform_pok_and_correctness.rs:12-14).
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


def transform_pok_and_correctness(
    challenge_filename: str,
    challenge_hash_filename: str,
    check_input_correctness: CheckForCorrectness,
    response_filename: str,
    response_hash_filename: str,
    check_output_correctness: CheckForCorrectness,
    new_challenge_filename: str,
    new_challenge_hash_filename: str,
    subgroup_check_mode: SubgroupCheckMode,
    ratio_check: bool,
    parameters: Phase1Parameters,
    device=None,
) -> bytes:
    """Verify one contribution (PoK + per-batch correctness) and decompress
    it into the next challenge, on the card unless `device="cpu"`.
    Reference: phase1-cli/src/transform_pok_and_correctness.rs:16-200."""
    logger.info(
        "Will verify and decompress a contribution to accumulator for 2^%d powers of tau",
        parameters.total_size_in_log2,
    )
    challenge_map = open_readable_map(challenge_filename, parameters.get_length(COMPRESSED_INPUT))
    expected_response_length = (
        parameters.contribution_size
        if COMPRESSED_OUTPUT is UseCompression.YES
        else parameters.accumulator_size + parameters.public_key_size
    )
    response_map = open_readable_map(response_filename, expected_response_length)

    try:
        current_accumulator_hash = calculate_hash(challenge_map)
        write_to_file(challenge_hash_filename, current_accumulator_hash)
        logger.info(
            "Hash of the `challenge` file for verification:%s", print_hash_grid(current_accumulator_hash)
        )

        # the hash chain: a response embeds the hash of the challenge it was
        # based on (transform_pok_and_correctness.rs:102-118)
        response_challenge_hash = bytes(response_map[0:64])
        logger.info("`response` was based on the hash:%s", print_hash_grid(response_challenge_hash))
        if response_challenge_hash != current_accumulator_hash:
            raise HashChainError("Hash chain failure. This is not the right response.")

        response_hash = calculate_hash(response_map)
        write_to_file(response_hash_filename, response_hash)
        logger.info("Hash of the response file for verification:%s", print_hash_grid(response_hash))

        public_key = PublicKey.read(response_map, COMPRESSED_OUTPUT, parameters)

        logger.info("Verifying a contribution to contain proper powers...")
        writable = create_writable_map(new_challenge_filename, parameters.accumulator_size)
        try:
            writable[0:64] = response_hash
            try:
                Phase1.verification(
                    challenge_map,
                    response_map,
                    writable,
                    public_key,
                    current_accumulator_hash,
                    COMPRESSED_INPUT,
                    COMPRESSED_OUTPUT,
                    COMPRESS_NEW_CHALLENGE,
                    check_input_correctness,
                    check_output_correctness,
                    subgroup_check_mode,
                    ratio_check,
                    parameters,
                    device=device,
                )
            except Exception as e:
                logger.error("Verification failed: %s", e)
                raise VerificationFailedError("INVALID CONTRIBUTION!!!") from e
            recompressed_hash = calculate_hash(writable)
        finally:
            writable.flush()
            writable.close()
    finally:
        challenge_map.close()
        response_map.close()

    write_to_file(new_challenge_hash_filename, recompressed_hash)
    logger.info("Verification succeeded! New challenge hash:%s", print_hash_grid(recompressed_hash))
    return recompressed_hash


def transform_ratios(
    response_filename: str,
    check_input_correctness: CheckForCorrectness,
    parameters: Phase1Parameters,
    device=None,
) -> None:
    """Full-accumulator RLC ratio verification (after combine), on the card
    unless `device="cpu"`. Reference: phase1-cli/src/transform_ratios.rs:10-73."""
    logger.info(
        "Will verify a contribution to accumulator for 2^%d powers of tau", parameters.total_size_in_log2
    )
    full_params = parameters.into_chunk_parameters(
        parameters.contribution_mode, 0, parameters.powers_g1_length
    )
    response_map = open_readable_map(response_filename, full_params.accumulator_size)
    try:
        response_hash = calculate_hash(response_map)
        logger.info("Hash of the response file for verification:%s", print_hash_grid(response_hash))
        try:
            Phase1.aggregate_verification(
                response_map, UseCompression.NO, check_input_correctness, parameters, device=device
            )
        except Exception as e:
            logger.error("Verification failed: %s", e)
            raise VerificationFailedError("INVALID CONTRIBUTION!!!") from e
    finally:
        response_map.close()
    logger.info("Verification succeeded!")


def combine(
    response_list_filename: str,
    combined_filename: str,
    parameters: Phase1Parameters,
    device=None,
) -> None:
    """Combine chunked (compressed) responses into one uncompressed full
    accumulator. Reference: phase1-cli/src/combine.rs:16-114."""
    logger.info("Will combine contributions")
    contribution_is_compressed = UseCompression.YES
    compress_new_combined = UseCompression.NO

    with open(response_list_filename) as f:
        lines = [ln.strip() for ln in f if ln.strip()]

    readers = []
    try:
        for chunk_index, line in enumerate(lines):
            chunk_params = parameters.into_chunk_parameters(
                parameters.contribution_mode, chunk_index, parameters.chunk_size
            )
            expected = (
                chunk_params.contribution_size
                if contribution_is_compressed is UseCompression.YES
                else chunk_params.accumulator_size + chunk_params.public_key_size
            )
            readers.append(open_readable_map(line, expected))

        output_params = parameters.into_chunk_parameters(
            parameters.contribution_mode, 0, parameters.powers_g1_length
        )
        writable = create_writable_map(combined_filename, output_params.accumulator_size)
        try:
            agg_params = parameters.into_chunk_parameters(parameters.contribution_mode, 0, parameters.chunk_size)
            Phase1.aggregation(
                [(r, contribution_is_compressed) for r in readers],
                writable,
                compress_new_combined,
                agg_params,
                device=device,
            )
        finally:
            writable.flush()
            writable.close()
    finally:
        for r in readers:
            r.close()
    logger.info("Combining succeeded!")


def split(
    chunk_filename_prefix: str,
    combined_filename: str,
    parameters: Phase1Parameters,
    device=None,
) -> None:
    """Split one compressed full response into uncompressed per-chunk files
    `prefix_i`. Reference: phase1-cli/src/split.rs:14-120."""
    logger.info("Will split contributions")
    contribution_is_compressed = UseCompression.YES
    compress_new_split = UseCompression.NO

    input_params = parameters.into_chunk_parameters(
        parameters.contribution_mode, 0, parameters.powers_g1_length
    )
    expected = (
        input_params.contribution_size
        if contribution_is_compressed is UseCompression.YES
        else input_params.accumulator_size
    )
    readable = open_readable_map(combined_filename, expected)

    chunk_params0 = parameters.into_chunk_parameters(parameters.contribution_mode, 0, parameters.chunk_size)
    writers = []
    try:
        for chunk_index in range(chunk_params0.num_chunks):
            cp = parameters.into_chunk_parameters(parameters.contribution_mode, chunk_index, parameters.chunk_size)
            writers.append(create_writable_map(f"{chunk_filename_prefix}_{chunk_index}", cp.accumulator_size))
        Phase1.split(
            readable,
            contribution_is_compressed,
            [(w, compress_new_split) for w in writers],
            chunk_params0,
            device=device,
        )
    finally:
        for w in writers:
            w.flush()
            w.close()
        readable.close()
    logger.info("Splitting succeeded!")
