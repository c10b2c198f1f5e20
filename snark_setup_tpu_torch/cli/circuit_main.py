"""`create_circuit` and `test_circuit` binary equivalents
(phase2-cli/src/bin/{create_circuit,test_circuit}.rs).

- create: synthesize TestCircuit (x^2, random witness) — or the SHA-256
  preimage TestHashCircuit with --complex — into a serialized Matrices file
  `testcircuit_<curve>`.
- test: load a bare uncompressed ProvingKey (`combined.params`), prove the
  circuit for a random witness, and verify the proof — the ceremony
  acceptance gate ("params actually prove things", SURVEY §4.4). The key's
  vectors and the prover's MSMs run on `--device` (default `cuda`; without a
  card that is an error unless `--device cpu` is given); `create` is host
  work.

Run as `python -m snark_setup_tpu_torch.cli.circuit_main {create,test} ...`.
"""

from __future__ import annotations

import argparse
import secrets
import sys

from ..curves.constants import get_curve
from ..phase2 import groth16
from ..phase2.load_circuit import Matrices
from ..phase2.parameters import ProvingKey
from ..phase2.r1cs import TestCircuit, circuit_to_qap
from ..phase2.vecio import Cursor
from ..transcript.hashing import derive_rng_from_seed
from ..utils.device import resolve_device
from ..utils.enums import CheckForCorrectness, UseCompression
from ..utils.tracing import configure_logging, get_logger, log_exit_counters
from .fileio import write_to_file

logger = get_logger("snark_setup_tpu_torch.cli.circuit")

CURVES = ["bls12_377", "bls12_381", "bw6", "mnt4_753", "mnt6_753"]


def _curve(name: str):
    return get_curve("bw6_761" if name == "bw6" else name)


def _make_circuit(spec, complex_: bool, with_witness: bool):
    if complex_:
        from ..phase2.sha256_circuit import TestHashCircuit

        preimage = secrets.token_bytes(32)
        return TestHashCircuit(preimage), TestHashCircuit(preimage).public_inputs(spec.r)
    x = secrets.randbelow(spec.r) if with_witness else None
    circuit = TestCircuit(x)
    inputs = [x * x % spec.r] if with_witness else None
    return circuit, inputs


def cmd_create(args) -> int:
    spec = _curve(args.curve_kind)
    circuit, _ = _make_circuit(spec, args.complex, with_witness=True)
    cs = circuit_to_qap(circuit, spec.r)
    matrices = Matrices.from_constraint_system(spec, cs)
    filename = f"testcircuit_{args.curve_kind}"
    write_to_file(filename, matrices.write())
    logger.info("Successfully created circuit at `%s`", filename)
    return 0


def cmd_test(args) -> int:
    spec = _curve(args.curve_kind)
    device = resolve_device(args.device)
    circuit, public_inputs = _make_circuit(spec, args.complex, with_witness=True)
    with open(args.proving_key_path, "rb") as f:
        pk = ProvingKey.read(
            spec, Cursor(f.read()), UseCompression.NO, CheckForCorrectness.NO, device=device
        )
    logger.info("Proving circuit")
    proof = groth16.prove(spec, pk, circuit, derive_rng_from_seed(secrets.token_bytes(32)), device)
    logger.info("Verifying circuit")
    if not groth16.verify(spec, pk.vk, proof, public_inputs):
        logger.error("Could not verify proof")
        return 1
    logger.info("Successfully verified proof")
    return 0


def main(argv=None) -> int:
    configure_logging()
    p = argparse.ArgumentParser(prog="circuit")
    sub = p.add_subparsers(dest="command", required=True)
    for name in ("create", "test"):
        s = sub.add_parser(name)
        s.add_argument("--curve-kind", default="bls12_377", choices=CURVES)
        s.add_argument("--complex", action="store_true", help="use the SHA-256 preimage circuit")
        if name == "test":
            s.add_argument("--proving-key-path", required=True)
            s.add_argument("--device", default="cuda",
                           help="torch device of the compute path: cuda (default) or cpu")
    args = p.parse_args(argv)
    try:
        return cmd_create(args) if args.command == "create" else cmd_test(args)
    except Exception:
        logger.exception("circuit %s failed", args.command)
        return 1
    finally:
        log_exit_counters(logger)


if __name__ == "__main__":
    sys.exit(main())
