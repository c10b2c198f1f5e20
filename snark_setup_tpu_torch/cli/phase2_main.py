"""`phase2` binary equivalent: flag parsing + curve dispatch.

Mirrors phase2-cli/src/bin/phase2.rs:25-92 and the Phase2Opts flag set
(phase2-cli/src/lib.rs:41-103) — same subcommands (new, contribute, beacon,
verify, combine), flags, and defaults (batch-size 16384), plus `--device`
(default `cuda`; without a card that is an error unless `--device cpu` is
given). Run as `python -m snark_setup_tpu_torch.cli.phase2_main ...`.
"""

from __future__ import annotations

import argparse
import sys
import time

from ..curves.constants import get_curve
from ..transcript.hashing import derive_rng_from_seed
from ..utils.device import resolve_device
from ..utils.enums import CheckForCorrectness, SubgroupCheckMode
from ..utils.helpers import upgrade_correctness_check_config
from ..utils.tracing import configure_logging, get_logger, log_exit_counters, maybe_profile
from . import phase2_cmds

logger = get_logger("snark_setup_tpu_torch.cli.phase2")

# phase2-cli/src/bin/phase2.rs:20-23 policy consts
CHALLENGE_IS_COMPRESSED = False
CONTRIBUTION_IS_COMPRESSED = True

DEFAULT_BEACON_HASH = "0000000000000000000a558a61ddc8ee4e488d647a747fe4dcc362fe2026c620"
CURVES = ["bls12_377", "bls12_381", "bw6", "mnt4_753", "mnt6_753"]


def _curve(name: str):
    return get_curve("bw6_761" if name == "bw6" else name)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="phase2", description="Groth16 specialization MPC (PyTorch/CUDA)")
    p.add_argument("--seed", help="file containing the hex seed to derive private elements from")
    p.add_argument("--curve-kind", default="bls12_377", choices=CURVES)
    p.add_argument("--proving-system", default="groth16", choices=["groth16"])
    p.add_argument("--batch-size", type=int, default=16384)
    p.add_argument("--contribution-mode", default="chunked", choices=["full", "chunked"])
    p.add_argument("--chunk-index", type=int, default=0)
    p.add_argument("--chunk-size", type=int, default=0)
    p.add_argument("--force-correctness-checks", action="store_true")
    p.add_argument("--batch-exp-mode", default="auto", choices=["auto", "direct", "batch-inversion"])
    p.add_argument("--subgroup-check-mode", default="auto", choices=["auto", "direct", "batched", "no"])
    p.add_argument("--device", default="cuda",
                   help="torch device of the compute path: cuda (default) or cpu")

    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("new", help="creates a new challenge for the ceremony")
    s.add_argument("--challenge-fname", default="challenge")
    s.add_argument("--challenge-hash-fname", default="challenge.verified.hash")
    s.add_argument("--challenge-list-fname", default="new_challenge_list")
    s.add_argument("--phase1-fname", default="phase1")
    s.add_argument("--circuit-fname", default="circuit.constraints")

    for name in ("contribute", "beacon"):
        s = sub.add_parser(name)
        s.add_argument("--challenge-fname", default="challenge")
        s.add_argument("--challenge-hash-fname", default="challenge.hash")
        s.add_argument("--response-fname", required=True)
        s.add_argument("--response-hash-fname", default="response.hash")
        s.add_argument("--beacon-hash", default=DEFAULT_BEACON_HASH)

    s = sub.add_parser("verify")
    s.add_argument("--challenge-fname", default="challenge")
    s.add_argument("--challenge-hash-fname", default="challenge.verified.hash")
    s.add_argument("--response-fname", default="response")
    s.add_argument("--response-hash-fname", default="response.verified.hash")
    s.add_argument("--new-challenge-fname", default="new_challenge")
    s.add_argument("--new-challenge-hash-fname", default="new_challenge.verified.hash")
    s.add_argument("--verifying-full-contribution", action="store_true")

    s = sub.add_parser("combine")
    s.add_argument("--initial-query-fname", default="challenge.query")
    s.add_argument("--initial-full-fname", default="challenge.full")
    s.add_argument("--response-list-fname", default="response_list")
    s.add_argument("--combined-fname", default="combined")
    s.add_argument("--combine-initial", action="store_true")

    return p


def execute(args: argparse.Namespace) -> None:
    spec = _curve(args.curve_kind)
    t0 = time.time()
    device = resolve_device(args.device)

    if args.command == "new":
        phase2_cmds.new_challenge(
            spec,
            args.challenge_fname,
            args.challenge_hash_fname,
            args.challenge_list_fname,
            args.chunk_size,
            args.phase1_fname,
            args.circuit_fname,
            device,
        )
    elif args.command in ("contribute", "beacon"):
        if args.command == "contribute":
            with open(args.seed) as f:
                seed = bytes.fromhex(f.read().strip())
            rng = derive_rng_from_seed(seed)
        else:
            beacon_hash = bytes.fromhex(args.beacon_hash)
            if len(beacon_hash) < 32:
                raise ValueError("beacon hash must be at least 32 bytes")
            rng = derive_rng_from_seed(beacon_hash[:32])
        phase2_cmds.contribute(
            spec,
            args.challenge_fname,
            args.challenge_hash_fname,
            args.response_fname,
            args.response_hash_fname,
            upgrade_correctness_check_config(
                CheckForCorrectness.NO, args.force_correctness_checks
            ),
            rng,
            device,
        )
    elif args.command == "verify":
        phase2_cmds.verify(
            spec,
            args.challenge_fname,
            args.challenge_hash_fname,
            upgrade_correctness_check_config(
                CheckForCorrectness.NO, args.force_correctness_checks
            ),
            args.response_fname,
            args.response_hash_fname,
            upgrade_correctness_check_config(
                CheckForCorrectness.FULL, args.force_correctness_checks
            ),
            args.new_challenge_fname,
            args.new_challenge_hash_fname,
            SubgroupCheckMode(args.subgroup_check_mode),
            args.verifying_full_contribution,
            device,
        )
    elif args.command == "combine":
        phase2_cmds.combine(
            spec,
            args.initial_query_fname,
            args.initial_full_fname,
            args.response_list_fname,
            args.combined_fname,
            args.combine_initial,
            device,
        )
    else:  # pragma: no cover
        raise SystemExit(2)

    logger.info("Executing %s took: %.2fs", args.command, time.time() - t0)


def main(argv=None) -> int:
    configure_logging()
    args = build_parser().parse_args(argv)
    try:
        with maybe_profile():
            execute(args)
    except Exception:
        logger.exception("phase2 %s failed", args.command)
        return 1
    finally:
        log_exit_counters(logger)
    return 0


if __name__ == "__main__":
    sys.exit(main())
