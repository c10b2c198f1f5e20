"""Structured span logging — equivalent of the reference's `tracing` crate
usage (info_span!("phase1-computation") etc., computation.rs:26-27).

Spans log enter/exit with wall-clock duration at DEBUG level; the CLI wires a
subscriber configured by the SNARK_SETUP_LOG env var (mirroring RUST_LOG).
"""

import contextlib
import gc
import json
import logging
import os
import sys
import time

_CONFIGURED = False


def configure_logging(level: str | None = None) -> None:
    global _CONFIGURED
    if _CONFIGURED:
        return
    level = level or os.environ.get("SNARK_SETUP_LOG", "INFO")
    logging.basicConfig(
        level=getattr(logging, level.upper(), logging.INFO),
        format="%(asctime)sZ %(levelname)s %(name)s: %(message)s",
    )
    logging.Formatter.converter = time.gmtime
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(name)


WRAPPER_MODULES = "snark_setup_tpu_torch.ops.cuda_"  # the kernel wrappers' modules


def exit_counters() -> dict:
    """What a command used of the card: the most device memory it held
    (`torch.cuda.max_memory_allocated`, None if it never touched the card)
    and the launches of every kernel wrapper that launched, by kernel."""
    torch = sys.modules.get("torch")
    peak = torch.cuda.max_memory_allocated() if torch is not None and torch.cuda.is_initialized() else None
    launches: dict = {}
    for o in gc.get_objects():
        if str(getattr(type(o), "__module__", "")).startswith(WRAPPER_MODULES):
            n = getattr(o, "__dict__", {}).get("launches")
            if isinstance(n, int) and n:
                name = getattr(o, "name", None) or type(o).__name__
                launches[name] = launches.get(name, 0) + n
    return {"peak_device_bytes": peak, "launches": launches}


def log_exit_counters(logger: logging.Logger) -> None:
    """One line at a CLI's exit, `exit counters {...}` (`exit_counters` as
    JSON), which scripts/torch_ceremony.py reads."""
    logger.info("exit counters %s", json.dumps(exit_counters(), sort_keys=True))


@contextlib.contextmanager
def maybe_profile():
    """Device-level profiling: when SNARK_SETUP_PROFILE_DIR is set, wrap the
    command in a torch.profiler trace and export it there as a Chrome trace."""
    profile_dir = os.environ.get("SNARK_SETUP_PROFILE_DIR")
    if not profile_dir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


@contextlib.contextmanager
def info_span(name: str, logger: logging.Logger | None = None, **fields):
    """Timed span; equivalent of tracing's info_span! + enter."""
    logger = logger or get_logger("snark_setup_tpu_torch")
    detail = " ".join(f"{k}={v}" for k, v in fields.items())
    logger.debug("enter %s %s", name, detail)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        logger.debug("exit %s (%.3fs)", name, dt)
