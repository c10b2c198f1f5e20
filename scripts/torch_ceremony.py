#!/usr/bin/env python3
"""The ceremony scripts' flows through the PyTorch/CUDA port's CLIs.

    python3 scripts/torch_ceremony.py PROFILE [--curve C] [--power P]
        [--batch-size B] [--chunk-size N] [--proving-system S]
        [--device cuda|cpu] [--workdir DIR] [--resume] [--seed N] ...

Each profile runs the steps of one of the repo's ceremony scripts, with the
same flags and default sizes, through the port's four CLIs
(`python -m snark_setup_tpu_torch.cli.{phase1_main, prepare_phase2_main,
phase2_main, circuit_main}`), one subprocess a step, from the work
directory:

- `full`: scripts/phase1_full.sh (new, contribute, verify, beacon, verify,
  ratios);
- `chunked`: scripts/phase1_chunked.sh (per chunk two participants
  alternating contribute / verify-and-transform; combine, beacon, full
  verify, ratios, split, and the second round over the split chunks;
  `split` reads the beacon's compressed response, where the script names
  the uncompressed new challenge, which `split` refuses by its length);
- `prepare`: scripts/phase1_chunked_prepare_phase2.sh (the first round,
  combine, beacon, full verify, ratios, then `prepare_phase2` with
  `--phase2-size` into `--transcript`);
- `phase2_chunked`: scripts/phase2_chunked.sh on `--transcript`, after
  `circuit_main create` (`--complex`: the SHA-256 circuit); per chunk two
  participants contribute / verify, combine, `circuit_main test`;
- `scale`: scripts/phase1_scale.sh (one participant a chunk, combine,
  ratios on the combined accumulator);
- `bench`: scripts/benchmark.sh (chunk 0's `new` and `contribute` at
  chunk size = batch size) and that chunk's
  verify-and-transform-pok-and-correctness.

Seed files are written from `--seed N` when it is given, else from
`secrets`, as the scripts' /dev/urandom. `--device` goes to every CLI that
computes (default `cuda`: the card; nothing falls back to the CPU). After
every step each `.hash` file the step wrote must hold the Blake2b-512 of its
file, and the response of every phase-1 `contribute` / `beacon` is held at
four lanes of its tau_g1 section (and of tau_g2, alpha_g1 and
beta_g1 and beta_g2 in Groth16) against the host oracle: the challenge's
point times the power of the secrets that the step's seed gives. A step
that exits non-zero or fails a check stops the run with exit code 1.

`--workdir DIR` keeps every file (otherwise a temporary directory is
removed at the end); with `--resume` a step that `journal.jsonl` in DIR
records as done, whose outputs exist and whose `.hash` files still match,
is skipped, so a long run can be split across calls. Files are kept: the
scripts' removals of used challenges are left out, so that a resumed run
can check them.

Standard output: one JSON line a step (profile, step, chunk, wall seconds,
exit code, bytes of its outputs, the child's peak RSS from `wait4`, the
peak device memory and kernel launches from the CLI's `exit counters` log
line, the hash files and oracle lanes checked), then one summary line.
Each child's log is in DIR/logs/.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import importlib
import json
import logging
import mmap
import os
import random
import re
import secrets
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # the oracle reads the port's host modules
    sys.path.insert(0, REPO)
PACKAGE = "snark_setup_tpu_torch.cli"
BEACON_HASH = "0000000000000000000a558a61ddc8ee4e488d647a747fe4dcc362fe2026c620"
PROFILES = ("full", "chunked", "prepare", "phase2_chunked", "scale", "bench")
# the scripts' default sizes: (curve, power, batch, chunk size)
DEFAULTS = {
    "full": ("bls12_377", 3, 8, None),
    "chunked": ("bls12_377", 3, 8, 4),
    "prepare": ("bls12_377", 4, 16, 16),
    "phase2_chunked": ("bls12_377", None, 64, 4),
    "scale": ("bls12_377", 20, 1 << 16, 1 << 18),
    "bench": ("bw6", 16, 1 << 14, None),
}
COUNTERS = re.compile(r"exit counters (\{.*\})")
ORACLE_LANES = 4  # lanes of each phase-1 response held against the host oracle


@dataclasses.dataclass
class Config:
    profile: str
    curve: str
    power: int | None
    batch: int
    chunk_size: int | None
    proving_system: str = "groth16"
    device: str | None = "cuda"  # None: no --device flag (the JAX package's CLIs take none)
    phase2_size: int | None = None  # prepare: defaults to 2^power
    transcript: str = "phase1_transcript"  # prepare's output, phase2_chunked's input
    complex: bool = False  # phase2_chunked: the SHA-256 circuit


@dataclasses.dataclass
class Step:
    label: str
    cli: str  # module of the CLI package
    argv: list
    outputs: list  # files the step writes, removed before it runs
    hashes: list = dataclasses.field(default_factory=list)  # (file, .hash file) pairs it writes
    chunk: int | None = None
    writes: dict = dataclasses.field(default_factory=dict)  # list files written just before
    oracle: dict | None = None  # a phase-1 response to hold against the host oracle


@dataclasses.dataclass
class Expand:
    """Steps known only once an earlier step has run: `fn(workdir)` makes
    them (phase 2's chunk count is the line count of the challenge list)."""
    label: str
    fn: object


def total_powers(cfg: Config) -> int:
    return (1 << (cfg.power + 1)) - 1 if cfg.proving_system == "groth16" else 1 << cfg.power


def n_chunks(cfg: Config) -> int:
    return -(-total_powers(cfg) // cfg.chunk_size)


def _dev(cfg: Config) -> list:
    return [] if cfg.device is None else ["--device", cfg.device]


def _p1(cfg: Config, mode: str, seed: str | None) -> list:
    """The scripts' phase-1 command prefixes, flags in their order."""
    if cfg.profile == "bench":  # benchmark.sh's order, no --proving-system
        return ["--curve-kind", cfg.curve, "--batch-size", str(cfg.batch), "--power", str(cfg.power), "--seed",
                seed, "--contribution-mode", mode, "--chunk-size", str(cfg.chunk_size)] + _dev(cfg)
    out = ["--curve-kind", cfg.curve, "--batch-size", str(cfg.batch), "--contribution-mode", mode]
    if mode == "chunked":
        out += ["--chunk-size", str(cfg.chunk_size)]
    out += ["--power", str(cfg.power)]
    if seed:
        out += ["--seed", seed]
    return out + ["--proving-system", cfg.proving_system] + _dev(cfg)


def _index(i) -> list:
    return [] if i is None else ["--chunk-index", str(i)]


def _new(prefix, i, chal, chal_hash=None) -> Step:
    """phase1 `new`; a hash file of None is left to the CLI's default name."""
    flags = [] if chal_hash is None else ["--challenge-hash-fname", chal_hash]
    chal_hash = chal_hash or "challenge.verified.hash"
    return Step("new" if i is None else f"chunk {i} new", "phase1_main",
                prefix + _index(i) + ["new", "--challenge-fname", chal, *flags], [chal, chal_hash],
                [(chal, chal_hash)], i)


def _contribute(label, prefix, i, chal, resp, seed, mode, chal_hash=None, resp_hash=None, beacon=False) -> Step:
    """phase1 `contribute` (`beacon`: the beacon hash's key); hash files of
    None are left to the CLI's default names."""
    argv = prefix + _index(i) + ["beacon" if beacon else "contribute", "--challenge-fname", chal]
    argv += [] if chal_hash is None else ["--challenge-hash-fname", chal_hash]
    argv += ["--response-fname", resp]
    argv += [] if resp_hash is None else ["--response-hash-fname", resp_hash]
    argv += ["--beacon-hash", BEACON_HASH] if beacon else []
    chal_hash, resp_hash = chal_hash or "challenge.hash", resp_hash or "response.hash"
    return Step(label, "phase1_main", argv, [chal_hash, resp, resp_hash], [(chal, chal_hash), (resp, resp_hash)],
                i, oracle={"challenge": chal, "response": resp, "seed": None if beacon else seed, "mode": mode,
                           "chunk": i})


def _verify(label, prefix, i, chal, resp, new) -> Step:
    hashes = [(f, f"{f}.verified.hash") for f in (chal, resp, new)]
    argv = prefix + _index(i) + ["verify-and-transform-pok-and-correctness", "--challenge-fname", chal,
                                 "--challenge-hash-fname", hashes[0][1], "--response-fname", resp,
                                 "--response-hash-fname", hashes[1][1], "--new-challenge-fname", new,
                                 "--new-challenge-hash-fname", hashes[2][1]]
    return Step(label, "phase1_main", argv, [h for _, h in hashes] + [new], hashes, i)


def _round(cfg, p1, p2, chal, resp, tag: str, new: bool) -> tuple[list, list]:
    """scripts/phase1_chunked.sh: contribute_round over every chunk (with
    `new` first in the first round); returns the steps and the list entries."""
    steps, listed = [], []
    for i in range(n_chunks(cfg)):
        c1, c2, a, b = (p1, p2, "seed1", "seed2") if i % 2 == 0 else (p2, p1, "seed2", "seed1")
        if new:
            steps.append(_new(p1, i, f"{chal}_{i}", f"{chal}_{i}.verified.hash"))
        steps += [
            _contribute(f"{tag}chunk {i} contribute", c1, i, f"{chal}_{i}", f"{resp}_{i}", a, "chunked",
                        f"{chal}_{i}.hash", f"{resp}_{i}.hash"),
            _verify(f"{tag}chunk {i} verify", c2, i, f"{chal}_{i}", f"{resp}_{i}", f"new_{chal}_{i}"),
            _contribute(f"{tag}chunk {i} contribute 2", c2, i, f"new_{chal}_{i}", f"new_{resp}_{i}", b, "chunked",
                        f"new_{chal}_{i}.hash", f"new_{resp}_{i}.hash"),
            _verify(f"{tag}chunk {i} verify 2", c1, i, f"new_{chal}_{i}", f"new_{resp}_{i}", f"new_new_{chal}_{i}"),
        ]
        listed.append(f"new_{resp}_{i}")
    return steps, listed


def _combine(prefix, listed, list_name, combined) -> Step:
    return Step(f"combine {combined}", "phase1_main",
                prefix + ["combine", "--response-list-fname", list_name, "--combined-fname", combined], [combined],
                writes={list_name: "".join(f"{r}\n" for r in listed)})


def _ratios(prefix, response) -> Step:
    return Step(f"ratios {response}", "phase1_main", prefix + ["verify-and-transform-ratios", "--response-fname",
                                                               response], [])


def _close(combine_prefix, full_prefix, listed, list_name, combined, beacon, new) -> list:
    """combine, beacon (the script's default hash file names), full verify,
    ratios: the end of both chunked scripts' rounds."""
    return [
        _combine(combine_prefix, listed, list_name, combined),
        _contribute(f"beacon {combined}", full_prefix, None, combined, beacon, None, "full", beacon=True),
        _verify(f"verify {beacon}", full_prefix, None, combined, beacon, new),
        _ratios(full_prefix, new),
    ]


def plan_full(cfg: Config) -> list:
    p = _p1(cfg, "full", "seed1")
    return [
        _new(p, None, "challenge", "challenge.verified.hash"),
        _contribute("contribute", p, None, "challenge", "response", "seed1", "full", "challenge.hash",
                    "response.hash"),
        _verify("verify", p, None, "challenge", "response", "new_challenge"),
        _contribute("beacon", p, None, "new_challenge", "new_response", None, "full", "new_challenge.hash",
                    "new_response.hash", beacon=True),
        _verify("verify beacon", p, None, "new_challenge", "new_response", "new_challenge_2"),
        _ratios(p, "new_challenge_2"),
    ]


def _chunked_first_round(cfg: Config):
    p1, p2 = _p1(cfg, "chunked", "seed1"), _p1(cfg, "chunked", "seed2")
    comb, full = _p1(cfg, "chunked", None), _p1(cfg, "full", None)
    steps, listed = _round(cfg, p1, p2, "challenge", "response", "", new=True)
    steps += _close(comb, full, listed, "response_list", "combined", "response_beacon",
                    "response_beacon_new_challenge")
    return steps, (p1, p2, comb, full)


def plan_chunked(cfg: Config) -> list:
    steps, (p1, p2, comb, full) = _chunked_first_round(cfg)
    # split reads a compressed full response (split.rs: CONTRIBUTION_IS_COMPRESSED), the beacon's;
    # the script names the uncompressed new challenge, which both packages' split refuse by its length
    steps.append(Step("split", "phase1_main", comb + ["split", "--chunk-fname-prefix", "chunk_split",
                                                      "--full-fname", "response_beacon"],
                      [f"chunk_split_{i}" for i in range(n_chunks(cfg))]))
    more, listed = _round(cfg, p1, p2, "chunk_split", "response_split", "split ", new=False)
    steps += more
    steps += _close(comb, full, listed, "response_list_split", "combined_split", "response_beacon_split",
                    "response_beacon_new_challenge_split")
    return steps


def plan_prepare(cfg: Config) -> list:
    steps, _ = _chunked_first_round(cfg)
    size = cfg.phase2_size if cfg.phase2_size is not None else 1 << cfg.power
    steps.append(Step(f"prepare_phase2 {size}", "prepare_phase2_main",
                      ["--curve-kind", cfg.curve, "--batch-size", str(cfg.batch), "--power", str(cfg.power),
                       "--proving-system", cfg.proving_system, "--phase2-size", str(size), "--phase2-fname",
                       cfg.transcript, "--response-fname", "response_beacon_new_challenge", *_dev(cfg)],
                      [cfg.transcript]))
    return steps


def _p2_contribute(label, prefix, i, chal, resp) -> Step:
    hashes = [(chal, f"{chal}.hash"), (resp, f"{resp}.hash")]
    return Step(label, "phase2_main",
                prefix + _index(i) + ["contribute", "--challenge-fname", chal, "--challenge-hash-fname",
                                      hashes[0][1], "--response-fname", resp, "--response-hash-fname", hashes[1][1]],
                [hashes[0][1], resp, hashes[1][1]], hashes, i)


def _p2_verify(label, prefix, i, chal, chal_hash, resp, new) -> Step:
    hashes = [(chal, chal_hash), (resp, f"{resp}.verified.hash"), (new, f"{new}.verified.hash")]
    return Step(label, "phase2_main",
                prefix + _index(i) + ["verify", "--challenge-fname", chal, "--challenge-hash-fname", chal_hash,
                                      "--response-fname", resp, "--response-hash-fname", hashes[1][1],
                                      "--new-challenge-fname", new, "--new-challenge-hash-fname", hashes[2][1]],
                [h for _, h in hashes] + [new], hashes, i)


def plan_phase2_chunked(cfg: Config) -> list:
    circuit = f"testcircuit_{cfg.curve}"
    cplx = ["--complex"] if cfg.complex else []
    base = ["--curve-kind", cfg.curve, "--batch-size", str(cfg.batch)]
    pc = base + ["--contribution-mode", "full", "--chunk-size", str(cfg.chunk_size)] + _dev(cfg)
    seeded = {s: base + ["--contribution-mode", "chunked", "--chunk-size", str(cfg.chunk_size), "--seed", s]
              + _dev(cfg) for s in ("seed1", "seed2")}

    def rounds(workdir: str) -> list:
        with open(os.path.join(workdir, "new_challenge_list")) as f:
            count = len(f.read().split())
        steps = []
        for i in range(count):
            c1, c2 = (seeded["seed1"], seeded["seed2"]) if i % 2 == 0 else (seeded["seed2"], seeded["seed1"])
            steps += [
                _p2_contribute(f"chunk {i} contribute", c1, i, f"challenge.{i}", f"response_{i}"),
                _p2_verify(f"chunk {i} verify", c1, i, f"challenge.{i}", f"challenge_{i}.verified.hash",
                           f"response_{i}", f"verified_{i}"),
                _p2_contribute(f"chunk {i} contribute 2", c2, i, f"verified_{i}", f"new_response_{i}"),
                _p2_verify(f"chunk {i} verify 2", c2, i, f"verified_{i}", f"verified_{i}.verified.hash",
                           f"new_response_{i}", f"verified2_{i}"),
            ]
        steps += [
            Step("combine", "phase2_main",
                 pc + ["combine", "--response-list-fname", "response_list", "--initial-query-fname",
                       "challenge.query", "--initial-full-fname", "challenge.full", "--combined-fname", "combined"],
                 ["combined", "combined.params"],
                 writes={"response_list": "".join(f"new_response_{i}\n" for i in range(count))}),
            Step("test", "circuit_main",
                 ["test", "--curve-kind", cfg.curve, *cplx, "--proving-key-path", "combined.params", *_dev(cfg)],
                 []),
        ]
        return steps

    return [
        Step("create", "circuit_main", ["create", "--curve-kind", cfg.curve, *cplx], [circuit]),
        Step("new", "phase2_main",
             pc + ["new", "--challenge-fname", "challenge", "--challenge-hash-fname", "challenge.verified.hash",
                   "--challenge-list-fname", "new_challenge_list", "--phase1-fname", cfg.transcript,
                   "--circuit-fname", circuit],
             ["challenge.full", "challenge.query", "challenge.verified.hash", "new_challenge_list"],
             [("challenge.full", "challenge.verified.hash")]),
        Expand("chunks", rounds),
    ]


def plan_scale(cfg: Config) -> list:
    p = _p1(cfg, "chunked", "seed1")
    steps = []
    for i in range(n_chunks(cfg)):
        steps += [
            _new(p, i, f"challenge_{i}", f"challenge_{i}.verified.hash"),
            _contribute(f"chunk {i} contribute", p, i, f"challenge_{i}", f"response_{i}", "seed1", "chunked",
                        f"challenge_{i}.hash", f"response_{i}.hash"),
            _verify(f"chunk {i} verify", p, i, f"challenge_{i}", f"response_{i}", f"new_challenge_{i}"),
        ]
    return steps + [_combine(p, [f"response_{i}" for i in range(n_chunks(cfg))], "response_list", "combined"),
                    _ratios(_p1(cfg, "full", None), "combined")]


def plan_bench(cfg: Config) -> list:
    """benchmark.sh's chunk 0 (its `new` and `contribute` leave the hash
    files to the CLI's default names), then the chunk's verification."""
    p = _p1(cfg, "chunked", "seed1")
    i = 0
    return [
        _new(p, i, f"challenge_{i}"),
        _contribute(f"chunk {i} contribute", p, i, f"challenge_{i}", f"response_{i}", "seed1", "chunked"),
        _verify(f"chunk {i} verify", p, i, f"challenge_{i}", f"response_{i}", f"new_challenge_{i}"),
    ]


PLANS = {"full": plan_full, "chunked": plan_chunked, "prepare": plan_prepare,
         "phase2_chunked": plan_phase2_chunked, "scale": plan_scale, "bench": plan_bench}


def plan(cfg: Config) -> list:
    return PLANS[cfg.profile](cfg)


# -- checks ----------------------------------------------------------------------------------------


def blake2b_file(path: str) -> bytes:
    h = hashlib.blake2b(digest_size=64)
    with open(path, "rb") as f:
        while block := f.read(1 << 24):
            h.update(block)
    return h.digest()


def check_hashes(step: Step, workdir: str) -> int:
    """Every (file, .hash file) pair of the step: the .hash file holds the
    Blake2b-512 of the file. Returns the count; raises on a mismatch."""
    for target, hfile in step.hashes:
        with open(os.path.join(workdir, hfile), "rb") as f:
            if f.read() != blake2b_file(os.path.join(workdir, target)):
                raise CheckFailed(f"{step.label}: {hfile} is not the Blake2b-512 of {target}")
    return len(step.hashes)


def _mapped(path: str):
    with open(path, "rb") as f:
        return mmap.mmap(f.fileno(), 0, prot=mmap.PROT_READ)


def check_oracle(cfg: Config, step: Step, workdir: str, rng: random.Random, lanes: int = ORACLE_LANES) -> int:
    """`lanes` lanes of a phase-1 response against the host oracle:
    response[i] == challenge[i] * tau^(first + i) (* alpha / beta), the
    secrets from the key the step's seed (or the beacon hash) gives for the
    challenge's hash. Groth16: tau_g1, tau_g2, alpha_g1 and beta_g1 at the
    same lanes (each within its length) and beta_g2 (in full mode and chunk
    0: a verification writes it into chunk 0's new challenge only);
    Marlin: tau_g1."""
    from snark_setup_tpu_torch.curves.host import g1_curve, g2_curve
    from snark_setup_tpu_torch.phase1.buffers import split
    from snark_setup_tpu_torch.phase1.keys import key_generation
    from snark_setup_tpu_torch.phase1.parameters import Phase1Parameters
    from snark_setup_tpu_torch.serialize.arkworks import g1_codec, g2_codec
    from snark_setup_tpu_torch.transcript.hashing import derive_rng_from_seed
    from snark_setup_tpu_torch.utils.enums import CheckForCorrectness, ContributionMode, ProvingSystem, \
        UseCompression

    o = step.oracle
    system = ProvingSystem(cfg.proving_system)
    if o["mode"] == "full":
        params = Phase1Parameters.new_full(cfg.curve, system, cfg.power, cfg.batch)
        first = 0
    else:
        params = Phase1Parameters.new_chunk(cfg.curve, ContributionMode.CHUNKED, o["chunk"], cfg.chunk_size, system,
                                            cfg.power, cfg.batch)
        first = o["chunk"] * cfg.chunk_size
    spec = params.spec
    if o["seed"] is None:
        seed = bytes.fromhex(BEACON_HASH)[:32]
    else:
        with open(os.path.join(workdir, o["seed"])) as f:
            seed = bytes.fromhex(f.read().strip())
    challenge, response = _mapped(os.path.join(workdir, o["challenge"])), _mapped(os.path.join(workdir, o["response"]))
    try:
        if bytes(response[:64]) != blake2b_file(os.path.join(workdir, o["challenge"])):
            raise CheckFailed(f"{step.label}: the response does not start with the challenge's hash")
        _, key = key_generation(spec, derive_rng_from_seed(seed), bytes(response[:64]))
        r = spec.r
        NO, YES = UseCompression.NO, UseCompression.YES
        s_in, s_out = split(params, NO), split(params, YES)
        codecs = {"g1": (g1_codec(spec), g1_curve(spec)), "g2": (g2_codec(spec), g2_curve(spec))}
        n1 = s_in["tau_g1"].num_elements
        inner = range(1, n1 - 1)  # the first, the last and random lanes between: min(lanes, n1) of them
        picks = sorted({0, n1 - 1, *rng.sample(inner, min(max(lanes - 2, 0), len(inner)))})[:lanes]
        sections = [("tau_g1", "g1", 1)]
        if system is ProvingSystem.GROTH16:
            sections += [("tau_g2", "g2", 1), ("alpha_g1", "g1", key.alpha), ("beta_g1", "g1", key.beta)]
        checked = 0
        for name, group, coeff in sections:
            codec, curve = codecs[group]
            for i in (i for i in picks if i < s_in[name].num_elements):
                p_in = codec.deserialize(bytes(s_in[name].slice_of(challenge, i, i + 1)), NO, CheckForCorrectness.NO)
                p_out = codec.deserialize(bytes(s_out[name].slice_of(response, i, i + 1)), YES,
                                          CheckForCorrectness.NO)
                if p_out != curve.mul(p_in, pow(key.tau, first + i, r) * coeff % r):
                    raise CheckFailed(f"{step.label}: {name}[{i}] differs from the host oracle")
                checked += 1
        if system is ProvingSystem.GROTH16 and not first:  # chunks past 0 carry no beta_g2 of their own
            codec, curve = codecs["g2"]
            b_in = codec.deserialize(bytes(s_in["beta_g2"].slice_of(challenge, 0, 1)), NO, CheckForCorrectness.NO)
            b_out = codec.deserialize(bytes(s_out["beta_g2"].slice_of(response, 0, 1)), YES, CheckForCorrectness.NO)
            if b_out != curve.mul(b_in, key.beta):
                raise CheckFailed(f"{step.label}: beta_g2 differs from the host oracle")
            checked += 1
        return checked
    finally:
        challenge.close()
        response.close()


class CheckFailed(Exception):
    pass


# -- running ---------------------------------------------------------------------------------------


def run_subprocess(step: Step, workdir: str, log_path: str, package: str) -> tuple[int, int | None, str]:
    """The step's CLI as `python -m`, from `workdir`; its output to
    `log_path`. Returns the exit code, the child's peak RSS in bytes and
    its log."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else REPO
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", f"{package}.{step.cli}", *step.argv], cwd=workdir,
                                stdout=log, stderr=subprocess.STDOUT, env=env)
        try:
            _, status, usage = os.wait4(proc.pid, 0)
        except BaseException:
            proc.kill()
            proc.wait()
            raise
        proc.returncode = os.waitstatus_to_exitcode(status)
    with open(log_path, errors="replace") as f:
        return proc.returncode, usage.ru_maxrss * 1024, f.read()


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(self.format(record))


def run_inprocess(step: Step, workdir: str, log_path: str, package: str) -> tuple[int, int | None, str]:
    """The step's CLI `main(argv)` in this process, from `workdir` (the
    peak RSS is this process's, so it is not reported)."""
    module = importlib.import_module(f"{package}.{step.cli}")
    capture = _Capture()
    root = logging.getLogger()
    root.addHandler(capture)
    old = os.getcwd()
    os.chdir(workdir)
    try:
        rc = module.main(list(step.argv))
    finally:
        os.chdir(old)
        root.removeHandler(capture)
    text = "\n".join(capture.lines)
    with open(log_path, "w") as f:
        f.write(text)
    return rc, None, text


def _journal(workdir: str) -> dict:
    path = os.path.join(workdir, "journal.jsonl")
    done = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                done[rec["label"]] = rec["argv"]
    return done


def _resumable(step: Step, workdir: str, done: dict) -> bool:
    if done.get(step.label) != step.argv:
        return False
    if not all(os.path.exists(os.path.join(workdir, p)) for p in step.outputs):
        return False
    try:
        check_hashes(step, workdir)
    except (CheckFailed, FileNotFoundError):
        return False
    return True


def run(cfg: Config, steps: list, workdir: str, *, resume: bool = False, inprocess: bool = False,
        package: str = PACKAGE, rng_seed: int = 0, out=sys.stdout) -> list:
    """Run `steps` in `workdir`: one JSON line a step on `out`. Raises
    StepFailed at the first step that exits non-zero or fails a check.
    Returns the step records."""
    os.makedirs(os.path.join(workdir, "logs"), exist_ok=True)
    done = _journal(workdir) if resume else {}
    if not resume and os.path.exists(os.path.join(workdir, "journal.jsonl")):
        os.remove(os.path.join(workdir, "journal.jsonl"))
    runner = run_inprocess if inprocess else run_subprocess
    rng = random.Random(rng_seed)
    records, launches_before = [], {}
    queue = list(steps)
    n = 0
    while queue:
        step = queue.pop(0)
        if isinstance(step, Expand):
            queue[:0] = step.fn(workdir)
            continue
        n += 1
        rec = {"profile": cfg.profile, "step": step.label, "chunk": step.chunk}
        if resume and _resumable(step, workdir, done):
            rec |= {"skipped": True, "rc": 0}
            records.append(rec)
            print(json.dumps(rec), file=out, flush=True)
            continue
        for name in step.outputs:
            path = os.path.join(workdir, name)
            if os.path.exists(path):
                os.remove(path)
        for name, text in step.writes.items():
            with open(os.path.join(workdir, name), "w") as f:
                f.write(text)
        log_path = os.path.join(workdir, "logs", f"{n:03d}_{re.sub(r'[^A-Za-z0-9_.-]+', '_', step.label)}.log")
        t0 = time.perf_counter()
        rc, rss, text = runner(step, workdir, log_path, package)
        rec |= {"cli": step.cli, "wall_seconds": time.perf_counter() - t0, "rc": rc,
                "output_bytes": sum(os.path.getsize(os.path.join(workdir, p)) for p in step.outputs
                                    if os.path.exists(os.path.join(workdir, p))),
                "peak_rss_bytes": rss, "peak_device_bytes": None, "kernel_launches": None}
        found = COUNTERS.findall(text)
        if found:
            counters = json.loads(found[-1])
            launches = counters.get("launches", {})
            rec["peak_device_bytes"] = counters.get("peak_device_bytes")
            # in one process the wrappers' counts accumulate: this step's share
            rec["kernel_launches"] = {k: v - launches_before.get(k, 0) for k, v in launches.items()
                                      if v - launches_before.get(k, 0)} if inprocess else launches
            if inprocess:
                launches_before = launches
        try:
            if rc != 0:
                raise CheckFailed(f"{step.label}: exit code {rc}")
            rec["hash_checks"] = check_hashes(step, workdir)
            if step.oracle is not None:
                t1 = time.perf_counter()
                rec["oracle_points"] = check_oracle(cfg, step, workdir, rng)
                rec["oracle_seconds"] = time.perf_counter() - t1
        except CheckFailed as e:
            rec["failed"] = str(e)
            records.append(rec)
            print(json.dumps(rec), file=out, flush=True)
            tail = "\n".join(text.splitlines()[-60:])
            raise StepFailed(f"{e}\n--- last lines of {log_path} ---\n{tail}") from None
        records.append(rec)
        print(json.dumps(rec), file=out, flush=True)
        with open(os.path.join(workdir, "journal.jsonl"), "a") as f:
            f.write(json.dumps({"label": step.label, "argv": step.argv}) + "\n")
    return records


class StepFailed(Exception):
    pass


def write_seeds(workdir: str, seed: int | None, resume: bool) -> None:
    """seed1 and seed2 as the scripts write them (32 hex digits); from
    `seed` when given, else from `secrets`; kept when resuming."""
    for k in (1, 2):
        path = os.path.join(workdir, f"seed{k}")
        if resume and os.path.exists(path):
            continue
        if seed is None:
            text = secrets.token_hex(16).upper()
        else:
            text = hashlib.blake2b(f"torch_ceremony {seed} seed{k}".encode(), digest_size=16).hexdigest().upper()
        with open(path, "w") as f:
            f.write(text)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("profile", choices=PROFILES)
    ap.add_argument("--curve", help="the CLIs' --curve-kind (bw6 for BW6-761)")
    ap.add_argument("--power", type=int)
    ap.add_argument("--batch-size", type=int)
    ap.add_argument("--chunk-size", type=int)
    ap.add_argument("--proving-system", default="groth16", choices=["groth16", "marlin"])
    ap.add_argument("--phase2-size", type=int, help="prepare: constraints + instance variables (2^power)")
    ap.add_argument("--transcript", default="phase1_transcript",
                    help="prepare's output and phase2_chunked's input, in the work directory")
    ap.add_argument("--complex", action="store_true", help="phase2_chunked: the SHA-256 circuit")
    ap.add_argument("--device", default="cuda", help="passed to every CLI: cuda (default) or cpu")
    ap.add_argument("--workdir", help="keep the files here (default: a temporary directory, removed)")
    ap.add_argument("--resume", action="store_true", help="skip steps the work directory's journal records")
    ap.add_argument("--seed", type=int, help="derive the seed files from this number (default: secrets)")
    return ap


def config_of(args) -> Config:
    curve, power, batch, chunk = DEFAULTS[args.profile]
    batch = args.batch_size or batch
    chunk = args.chunk_size or chunk or (batch if args.profile == "bench" else None)
    return Config(args.profile, args.curve or curve, args.power or power, batch, chunk, args.proving_system,
                  args.device, args.phase2_size, args.transcript, args.complex)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_of(args)
    workdir = args.workdir or tempfile.mkdtemp(prefix=f"torch_ceremony_{cfg.profile}_")
    os.makedirs(workdir, exist_ok=True)
    write_seeds(workdir, args.seed, args.resume)
    t0 = time.perf_counter()
    try:
        records = run(cfg, plan(cfg), workdir, resume=args.resume, rng_seed=args.seed or 0)
    except StepFailed as e:
        print(f"torch_ceremony: {e}", file=sys.stderr)
        print(json.dumps({"profile": cfg.profile, "ok": False, "workdir": workdir}), flush=True)
        return 1
    finally:
        if not args.workdir:
            shutil.rmtree(workdir, ignore_errors=True)
    files = sum(os.path.getsize(os.path.join(workdir, f)) for f in os.listdir(workdir)
                if os.path.isfile(os.path.join(workdir, f))) if args.workdir else None
    print(json.dumps({"profile": cfg.profile, "ok": True, "steps": len(records),
                      "skipped": sum(1 for r in records if r.get("skipped")), "wall_seconds": time.perf_counter() - t0,
                      "config": dataclasses.asdict(cfg), "workdir_bytes": files}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
