"""`phase1` binary equivalent: flag parsing + curve dispatch.

Mirrors phase1-cli/src/bin/phase1.rs:36-152 and the Phase1Opts flag set
(phase1-cli/src/lib.rs:39-193) — same flags, same defaults, same subcommand
names, plus `--device` (default `cuda`; without a card that is an error
unless `--device cpu` is given). Run as
`python -m snark_setup_tpu_torch.cli.phase1_main ...`.
"""

from __future__ import annotations

import argparse
import sys
import time

from ..phase1.parameters import Phase1Parameters
from ..transcript.hashing import derive_rng_from_seed
from ..utils.device import resolve_device
from ..utils.enums import (
    BatchExpMode,
    CheckForCorrectness,
    ContributionMode,
    ProvingSystem,
    SubgroupCheckMode,
)
from ..utils.helpers import upgrade_correctness_check_config
from ..utils.tracing import configure_logging, get_logger, log_exit_counters, maybe_profile
from . import phase1_cmds

logger = get_logger("snark_setup_tpu_torch.cli.phase1")

# Correctness-check policy defaults (setup-utils/src/lib.rs consts;
# SURVEY C16): contribute-input=No, verify-input=No, verify-output=Full.
DEFAULT_CONTRIBUTE_CHECK_INPUT_CORRECTNESS = CheckForCorrectness.NO
DEFAULT_VERIFY_CHECK_INPUT_CORRECTNESS = CheckForCorrectness.NO
DEFAULT_VERIFY_CHECK_OUTPUT_CORRECTNESS = CheckForCorrectness.FULL

DEFAULT_BEACON_HASH = "0000000000000000000a558a61ddc8ee4e488d647a747fe4dcc362fe2026c620"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="phase1", description="Powers of Tau MPC (PyTorch/CUDA)")
    p.add_argument("--seed", help="file containing the hex seed to derive private elements from")
    p.add_argument("--contribution-mode", default="chunked", choices=[m.value for m in ContributionMode])
    p.add_argument("--chunk-index", type=int, default=0)
    p.add_argument("--chunk-size", type=int, default=0)
    p.add_argument("--curve-kind", default="bls12_377",
                   choices=["bls12_377", "bls12_381", "bw6", "bw6_761", "mnt4_753", "mnt6_753"])
    p.add_argument("--proving-system", default="groth16", choices=[m.value for m in ProvingSystem])
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--power", type=int, default=21)
    p.add_argument("--force-correctness-checks", action="store_true")
    p.add_argument("--batch-exp-mode", default="auto", choices=[m.value for m in BatchExpMode])
    p.add_argument("--subgroup-check-mode", default="auto", choices=[m.value for m in SubgroupCheckMode])
    p.add_argument("--skip-ratio-check", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device of the compute path: cuda (default) or cpu")

    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("new", help="creates a new challenge for the ceremony")
    s.add_argument("--challenge-fname", default="challenge")
    s.add_argument("--challenge-hash-fname", default="challenge.verified.hash")

    for name in ("contribute", "beacon"):
        s = sub.add_parser(name)
        s.add_argument("--challenge-fname", default="challenge")
        s.add_argument("--challenge-hash-fname", default="challenge.hash")
        s.add_argument("--response-fname", required=True)
        s.add_argument("--response-hash-fname", default="response.hash")
        s.add_argument("--beacon-hash", default=DEFAULT_BEACON_HASH)

    s = sub.add_parser("verify-and-transform-pok-and-correctness")
    s.add_argument("--challenge-fname", default="challenge")
    s.add_argument("--challenge-hash-fname", default="challenge.verified.hash")
    s.add_argument("--response-fname", default="response")
    s.add_argument("--response-hash-fname", default="response.verified.hash")
    s.add_argument("--new-challenge-fname", default="new_challenge")
    s.add_argument("--new-challenge-hash-fname", default="new_challenge.verified.hash")

    s = sub.add_parser("verify-and-transform-ratios")
    s.add_argument("--response-fname", default="response")

    s = sub.add_parser("combine")
    s.add_argument("--response-list-fname", default="response_list")
    s.add_argument("--combined-fname", default="combined")

    s = sub.add_parser("split")
    s.add_argument("--chunk-fname-prefix", default="response")
    s.add_argument("--full-fname", default="full")

    return p


def execute(args: argparse.Namespace) -> None:
    parameters = Phase1Parameters.new_chunk(
        args.curve_kind,
        ContributionMode(args.contribution_mode),
        args.chunk_index,
        args.chunk_size,
        ProvingSystem(args.proving_system),
        args.power,
        args.batch_size,
    )
    t0 = time.time()
    # `new` is host-only; every other command runs on the chosen device
    device = None if args.command == "new" else resolve_device(args.device)

    if args.command == "new":
        phase1_cmds.new_challenge(args.challenge_fname, args.challenge_hash_fname, parameters)
    elif args.command in ("contribute", "beacon"):
        if args.command == "contribute":
            with open(args.seed) as f:
                seed = bytes.fromhex(f.read().strip())
        else:
            beacon_hash = bytes.fromhex(args.beacon_hash)
            # from_slice: the seed is the first 32 bytes (bin/phase1.rs:83-85)
            if len(beacon_hash) < 32:
                raise ValueError("beacon hash must be at least 32 bytes")
            seed = beacon_hash[:32]
        rng = derive_rng_from_seed(seed)
        phase1_cmds.contribute(
            args.challenge_fname,
            args.challenge_hash_fname,
            args.response_fname,
            args.response_hash_fname,
            upgrade_correctness_check_config(
                DEFAULT_CONTRIBUTE_CHECK_INPUT_CORRECTNESS, args.force_correctness_checks
            ),
            BatchExpMode(args.batch_exp_mode),
            parameters,
            rng,
            device=device,
        )
    elif args.command == "verify-and-transform-pok-and-correctness":
        phase1_cmds.transform_pok_and_correctness(
            args.challenge_fname,
            args.challenge_hash_fname,
            upgrade_correctness_check_config(
                DEFAULT_VERIFY_CHECK_INPUT_CORRECTNESS, args.force_correctness_checks
            ),
            args.response_fname,
            args.response_hash_fname,
            upgrade_correctness_check_config(
                DEFAULT_VERIFY_CHECK_OUTPUT_CORRECTNESS, args.force_correctness_checks
            ),
            args.new_challenge_fname,
            args.new_challenge_hash_fname,
            SubgroupCheckMode(args.subgroup_check_mode),
            not args.skip_ratio_check,
            parameters,
            device=device,
        )
    elif args.command == "verify-and-transform-ratios":
        phase1_cmds.transform_ratios(
            args.response_fname,
            upgrade_correctness_check_config(
                DEFAULT_VERIFY_CHECK_INPUT_CORRECTNESS, args.force_correctness_checks
            ),
            parameters,
            device=device,
        )
    elif args.command == "combine":
        phase1_cmds.combine(args.response_list_fname, args.combined_fname, parameters, device=device)
    elif args.command == "split":
        phase1_cmds.split(args.chunk_fname_prefix, args.full_fname, parameters, device=device)
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
        logger.exception("phase1 %s failed", args.command)
        return 1
    finally:
        log_exit_counters(logger)
    return 0


if __name__ == "__main__":
    sys.exit(main())
