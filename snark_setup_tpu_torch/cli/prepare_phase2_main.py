"""`prepare_phase2` binary equivalent (phase2-cli/src/bin/prepare_phase2.rs):
phase-1 response file → Lagrange-coefficient transcript, through the
group-element NTT on `--device` (default `cuda`; without a card that is an
error unless `--device cpu` is given). Run as
`python -m snark_setup_tpu_torch.cli.prepare_phase2_main`.
"""

from __future__ import annotations

import argparse
import sys
import time

from ..curves.constants import get_curve
from ..phase1.parameters import Phase1Parameters
from ..utils.device import resolve_device
from ..utils.enums import ProvingSystem
from ..utils.tracing import configure_logging, get_logger, log_exit_counters
from .phase2_cmds import prepare_phase2

logger = get_logger("snark_setup_tpu_torch.cli.prepare_phase2")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="prepare_phase2")
    p.add_argument("--phase2-fname", required=True,
                   help="output file for the FFT coefficients processed for phase 2")
    p.add_argument("--response-fname", required=True,
                   help="the uncompressed full phase-1 response to process")
    p.add_argument("--curve-kind", default="bls12_377",
                   choices=["bls12_377", "bls12_381", "bw6", "mnt4_753", "mnt6_753"])
    p.add_argument("--proving-system", default="groth16", choices=[m.value for m in ProvingSystem])
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--power", type=int, required=True)
    p.add_argument("--phase2-size", type=int, default=None,
                   help="constraints + instance variables for phase 2 (defaults to 2^power)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the compute path: cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    configure_logging()
    args = build_parser().parse_args(argv)
    curve = "bw6_761" if args.curve_kind == "bw6" else args.curve_kind
    spec = get_curve(curve)
    phase2_size = args.phase2_size if args.phase2_size is not None else 1 << args.power
    parameters = Phase1Parameters.new_full(
        curve, ProvingSystem(args.proving_system), args.power, args.batch_size
    )
    t0 = time.time()
    try:
        prepare_phase2(spec, args.phase2_fname, args.response_fname, phase2_size, parameters,
                       resolve_device(args.device))
    except Exception:
        logger.exception("prepare_phase2 failed")
        return 1
    finally:
        log_exit_counters(logger)
    logger.info("Executing prepare_phase2 took: %.2fs", time.time() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
