"""Testing fixtures mirroring phase1/src/helpers/testing.rs.

`generate_input` builds an initialized accumulator buffer; `setup_verify`
produces one full contribution ready for verification.
"""

from __future__ import annotations

from ..transcript.hashing import blank_hash, derive_rng_from_seed
from ..utils.enums import BatchExpMode, CheckForCorrectness, UseCompression
from .parameters import Phase1Parameters
from .protocol import Phase1


def generate_input(parameters: Phase1Parameters, compressed: UseCompression) -> bytearray:
    buf = bytearray(parameters.get_length(compressed))
    Phase1.initialization(buf, compressed, parameters)
    return buf


def generate_output(parameters: Phase1Parameters, compressed: UseCompression) -> bytearray:
    return bytearray(parameters.get_length(compressed))


def setup_verify(
    compressed_input: UseCompression,
    check_input_correctness: CheckForCorrectness,
    compressed_output: UseCompression,
    parameters: Phase1Parameters,
    seed: bytes = b"setup_verify",
    device=None,
):
    """One seeded contribution, computed on `device` (the card unless
    "cpu"): returns (input, output, pubkey, privkey, challenge_hash)."""
    inp = generate_input(parameters, compressed_input)
    out = generate_output(parameters, compressed_output)
    rng = derive_rng_from_seed(seed)
    digest = blank_hash()
    pubkey, privkey = Phase1.key_generation(parameters.spec, rng, digest)
    Phase1.computation(
        inp,
        out,
        compressed_input,
        compressed_output,
        check_input_correctness,
        BatchExpMode.AUTO,
        privkey,
        parameters,
        device=device,
    )
    return inp, out, pubkey, privkey, digest
