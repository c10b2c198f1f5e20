"""Phase-2 CLI subcommand implementations over files.

Mirrors phase2-cli/src/{new_challenge,contribute,verify,combine}.rs and the
compression policy constants (phase2-cli/src/lib.rs:37-39):
contribute-input uncompressed, contribute-output compressed, combined
uncompressed. Every command computes on `device` (None: the card).
"""

from __future__ import annotations

from ..curves.constants import CurveSpec
from ..ntt.domain import domain_size
from ..phase2.load_circuit import Matrices
from ..phase2.parameters import MPCParameters, ProvingKey, verify_transcript
from ..transcript.hashing import calculate_hash
from ..utils.enums import CheckForCorrectness, SubgroupCheckMode, UseCompression
from ..utils.helpers import print_hash_grid
from ..utils.tracing import get_logger
from .fileio import write_to_file

logger = get_logger("snark_setup_tpu_torch.cli.phase2")

COMPRESS_CONTRIBUTE_INPUT = UseCompression.NO
COMPRESS_CONTRIBUTE_OUTPUT = UseCompression.YES
COMBINED_IS_COMPRESSED = UseCompression.NO


def new_challenge(
    spec: CurveSpec,
    challenge_fname: str,
    challenge_hash_fname: str,
    challenge_list_fname: str,
    chunk_size: int,
    phase1_fname: str,
    circuit_fname: str,
    device=None,
) -> int:
    """phase2-cli/src/new_challenge.rs:15-102; returns the chunk count."""
    logger.info("Generating phase 2")
    with open(circuit_fname, "rb") as f:
        matrices = Matrices.read(spec, f.read())
    logger.info("Loaded circuit with %d constraints", matrices.num_constraints)

    phase2_size = max(
        matrices.num_constraints,
        matrices.num_witness_variables + matrices.num_instance_variables,
    )
    dsize = domain_size(spec.name, phase2_size)
    chunk_size = min(chunk_size, dsize)

    with open(phase1_fname, "rb") as f:
        transcript = f.read()

    full_mpc, query_params, chunks = MPCParameters.new_from_buffer_chunked(
        matrices,
        transcript,
        UseCompression.NO,
        CheckForCorrectness.NO,
        dsize,
        chunk_size,
        device,
    )

    serialized_full = full_mpc.write(COMPRESS_CONTRIBUTE_INPUT, device)
    write_to_file(f"{challenge_fname}.full", serialized_full)
    contribution_hash = calculate_hash(serialized_full)

    write_to_file(
        f"{challenge_fname}.query",
        query_params.write(spec, COMPRESS_CONTRIBUTE_INPUT, device),
    )

    with open(challenge_list_fname, "w") as list_file:
        for i, chunk in enumerate(chunks):
            write_to_file(f"{challenge_fname}.{i}", chunk.write(COMPRESS_CONTRIBUTE_INPUT, device))
            list_file.write(f"{challenge_fname}.{i}\n")

    write_to_file(challenge_hash_fname, contribution_hash)
    logger.info("Empty contribution is formed with a hash:%s", print_hash_grid(contribution_hash))
    logger.info("Wrote a fresh accumulator to challenge file")
    return len(chunks)


def contribute(
    spec: CurveSpec,
    challenge_fname: str,
    challenge_hash_fname: str,
    response_fname: str,
    response_hash_fname: str,
    check_input_correctness: CheckForCorrectness,
    rng,
    device=None,
) -> None:
    """phase2-cli/src/contribute.rs:11-55."""
    logger.info("Contributing to phase 2")
    with open(challenge_fname, "rb") as f:
        challenge_contents = f.read()
    challenge_hash = calculate_hash(challenge_contents)
    write_to_file(challenge_hash_fname, challenge_hash)
    logger.info("`challenge` file contains decompressed points and has a hash:%s",
                print_hash_grid(challenge_hash))

    parameters = MPCParameters.read(
        spec,
        challenge_contents,
        COMPRESS_CONTRIBUTE_INPUT,
        check_input_correctness,
        SubgroupCheckMode.AUTO,
        device,
    )
    parameters.contribute(rng, device)
    serialized_response = parameters.write(COMPRESS_CONTRIBUTE_OUTPUT, device)
    write_to_file(response_fname, serialized_response)
    response_hash = calculate_hash(serialized_response)
    write_to_file(response_hash_fname, response_hash)
    logger.info("Done! Your contribution has been written to the response file. "
                "The BLAKE2b hash of the response file is:%s", print_hash_grid(response_hash))


def verify(
    spec: CurveSpec,
    challenge_fname: str,
    challenge_hash_fname: str,
    check_input_correctness: CheckForCorrectness,
    response_fname: str,
    response_hash_fname: str,
    check_output_correctness: CheckForCorrectness,
    new_challenge_fname: str,
    new_challenge_hash_fname: str,
    subgroup_check_mode: SubgroupCheckMode,
    verifying_full_contribution: bool,
    device=None,
) -> None:
    """phase2-cli/src/verify.rs:11-96."""
    logger.info("Verifying phase 2")
    with open(challenge_fname, "rb") as f:
        challenge_contents = f.read()
    challenge_hash = calculate_hash(challenge_contents)
    write_to_file(challenge_hash_fname, challenge_hash)

    parameters_before = MPCParameters.read(
        spec,
        challenge_contents,
        COMPRESS_CONTRIBUTE_INPUT,
        check_input_correctness,
        subgroup_check_mode,
        device,
    )

    with open(response_fname, "rb") as f:
        response_contents = f.read()
    response_hash = calculate_hash(response_contents)
    write_to_file(response_hash_fname, response_hash)

    after_compressed = (
        COMBINED_IS_COMPRESSED if verifying_full_contribution else COMPRESS_CONTRIBUTE_OUTPUT
    )
    parameters_after = MPCParameters.read(
        spec,
        response_contents,
        after_compressed,
        check_output_correctness,
        subgroup_check_mode,
        device,
    )

    # the new challenge is the decompressed re-serialization of the response
    new_challenge_bytes = parameters_after.write(COMPRESS_CONTRIBUTE_INPUT, device)
    import os

    if os.path.exists(new_challenge_fname):
        raise FileExistsError(new_challenge_fname)
    write_to_file(new_challenge_fname, new_challenge_bytes)
    write_to_file(new_challenge_hash_fname, calculate_hash(new_challenge_bytes))

    parameters_before.verify(parameters_after, device=device)
    logger.info("Done! The BLAKE2b hash of the response file is:%s", print_hash_grid(response_hash))


def combine(
    spec: CurveSpec,
    initial_query_fname: str,
    initial_full_fname: str,
    response_list_fname: str,
    combined_fname: str,
    combine_initial: bool,
    device=None,
) -> None:
    """phase2-cli/src/combine.rs:16-100."""
    logger.info("Combining phase 2")
    from ..phase2.vecio import Cursor

    with open(initial_full_fname, "rb") as f:
        full_parameters = MPCParameters.read(
            spec, f.read(), UseCompression.NO, CheckForCorrectness.NO, device=device
        )
    with open(initial_query_fname, "rb") as f:
        query_parameters = ProvingKey.read(
            spec, Cursor(f.read()), UseCompression.NO, CheckForCorrectness.NO, device=device
        )

    parameters_compressed = (
        COMPRESS_CONTRIBUTE_INPUT if combine_initial else COMPRESS_CONTRIBUTE_OUTPUT
    )
    all_parameters = []
    with open(response_list_fname) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            with open(line, "rb") as rf:
                all_parameters.append(
                    MPCParameters.read(
                        spec, rf.read(), parameters_compressed, CheckForCorrectness.NO, device=device
                    )
                )

    combined = MPCParameters.combine(spec, query_parameters, all_parameters)

    if combine_initial:
        contributions_hash = verify_transcript(
            spec, full_parameters.cs_hash, combined.contributions
        )
    else:
        contributions_hash = full_parameters.verify(combined, device=device)

    logger.info("Contributions hashes:")
    for h in contributions_hash:
        logger.info("%s", print_hash_grid(h))

    write_to_file(combined_fname, combined.write(COMBINED_IS_COMPRESSED, device))
    # bare uncompressed ProvingKey for provers (combine.rs:93-99)
    write_to_file(
        f"{combined_fname}.params", combined.params.write(spec, UseCompression.NO, device)
    )


def prepare_phase2(
    spec: CurveSpec,
    phase2_fname: str,
    response_fname: str,
    phase2_size: int,
    parameters,
    device=None,
) -> None:
    """phase2-cli/src/prepare_phase2.rs:16-69 (with the stale-signature wart
    fixed: correctness checking is an explicit argument there but the bin
    passes 4 args; here it's one coherent function)."""
    from ..phase2.lagrange import prepare_transcript_device

    with open(response_fname, "rb") as f:
        response = f.read()
    # device-resident path: bounded reads -> on-device IFFT/h-query ->
    # bounded writes, no per-point Python objects (byte-identical to
    # Groth16Params.new().write())
    transcript = prepare_transcript_device(
        spec.name,
        phase2_size,
        response,
        parameters,
        UseCompression.NO,
        CheckForCorrectness.NO,
        UseCompression.NO,
        device,
    )
    import os

    if os.path.exists(phase2_fname):
        raise FileExistsError(phase2_fname)
    write_to_file(phase2_fname, transcript)
