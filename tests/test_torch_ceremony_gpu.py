"""The ceremony driver (scripts/torch_ceremony.py) on the card, on the curves
whose chunked and Marlin modes only the CPU had run:

- the `chunked` profile (two participants a chunk, combine, beacon, full
  verification, ratios, split and the second round) on BLS12-381, MNT4-753
  and MNT6-753 at power 8, batch = chunk = 128, Groth16 and Marlin, with
  `--device cuda`: every step exits 0 and passes the driver's hash and
  host-oracle checks, and every response (each participant's and the
  beacon's) is byte-identical to the one the same CLI step writes with
  `--device cpu` from the same challenge and seed file (tolerance 0);
- BLS12-381's `prepare` profile (power 6, batch = chunk = 64, two
  participants, `prepare_phase2` at 8, the circuit's domain) into its `phase2_chunked` profile
  with the x^2 circuit, ending in `circuit_main test`: a proof from the
  combined parameters verifies.

Each ceremony runs in one process, every step through its CLI's
`main(argv)` there (the driver's in-process runner: one interpreter start a
ceremony, not one a step); then its contributions on the CPU, eight
processes. The host pairings of verification set the time: an MNT6-753
case takes tens of minutes, BLS12-381's a few (`-k bls12_381`).
These tests need an NVIDIA GPU and nvcc: they are marked `gpu`, decide inside
a fixture whether a card is present, and skip without one. Run them on the
machine with the card:

    python -m pytest --noconftest tests/test_torch_ceremony_gpu.py -q -m gpu -s
"""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [(c, s) for c in ("bls12_381", "mnt4_753", "mnt6_753") for s in ("groth16", "marlin")]
POWER, BATCH = 8, 128
PHASE2 = ("bls12_381", 6, 64)  # curve, power, batch = chunk
CPU_WORKERS = 8
SEED = 8

# one process: the driver's profiles (a JSON list of argv lists) in this
# interpreter, every step's JSON line on stdout
CARD = f"""
import json, os, sys
sys.path[:0] = [{REPO!r}, {os.path.join(REPO, "scripts")!r}]
import torch_ceremony as C
for argv in json.loads(sys.argv[1]):
    args = C.build_parser().parse_args(argv)
    cfg = C.config_of(args)
    os.makedirs(args.workdir, exist_ok=True)
    C.write_seeds(args.workdir, args.seed, resume=False)
    C.run(cfg, C.plan(cfg), args.workdir, inprocess=True)
"""
# one process: phase-1 CLI steps on the CPU, [workdir, argv] each; prints [response, rc] each
CPU = f"""
import json, os, sys
sys.path.insert(0, {REPO!r})
import torch
torch.set_num_threads(1)
from snark_setup_tpu_torch.cli import phase1_main
out = []
for workdir, argv in json.loads(sys.argv[1]):
    os.chdir(workdir)
    out.append([argv[argv.index("--response-fname") + 1], phase1_main.main(argv)])
print(json.dumps(out))
"""


def _lines(stdout: str) -> list:
    return [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]


def _cpu_twin(argv: list) -> list:
    """A contribute / beacon step's argv with `--device cpu`, into
    `<response>.cpu` (and its hash files beside)."""
    argv = list(argv)
    argv[argv.index("--device") + 1] = "cpu"
    for flag in ("--response-fname", "--response-hash-fname", "--challenge-hash-fname"):
        if flag in argv:
            argv[argv.index(flag) + 1] += ".cpu"
    return argv


def _card_run(tmp_path, argvs: list) -> tuple[list, str]:
    """The driver's profiles `argvs` on the card in one process; returns
    its step lines and its log, and fails the test on a non-zero exit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from snark_setup_tpu_torch.ops import build

    build.build()  # here, once: the child loads the libraries
    log = tmp_path / "card.log"
    with open(log, "w") as f:  # the CLIs' logs go to a file: a full pipe would stall the child
        done = subprocess.run([sys.executable, "-c", CARD, json.dumps(argvs)], stdout=subprocess.PIPE, stderr=f,
                              text=True)
    assert done.returncode == 0, log.read_text()[-3000:]
    return _lines(done.stdout), log.read_text()


@pytest.mark.gpu
@pytest.mark.parametrize("curve,system", CASES)
def test_chunked_ceremony_on_the_card_equals_the_cpu(tmp_path, curve, system):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import torch_ceremony as C

    workdir = str(tmp_path / "ceremony")
    argv = ["chunked", "--curve", curve, "--power", str(POWER), "--batch-size", str(BATCH), "--chunk-size",
            str(BATCH), "--proving-system", system, "--device", "cuda", "--workdir", workdir, "--seed", str(SEED)]
    t0 = time.perf_counter()
    steps, _ = _card_run(tmp_path, [argv])
    card_seconds = time.perf_counter() - t0
    assert steps and all(r["rc"] == 0 for r in steps)
    chunks = 4 if system == "groth16" else 2  # power 8: 511 / 256 tau_g1 powers
    assert len(steps) == 9 * chunks + 9
    # every contribution (each participant's and the beacon's) again on the CPU
    plan = {s.label: s for s in C.plan(C.config_of(C.build_parser().parse_args(argv)))}
    jobs = [(workdir, _cpu_twin(plan[r["step"]].argv)) for r in steps if plan[r["step"]].oracle is not None]
    assert len(jobs) == 4 * chunks + 2
    logs = [tmp_path / f"cpu_{i}.log" for i in range(CPU_WORKERS)]
    procs = [subprocess.Popen([sys.executable, "-c", CPU, json.dumps(jobs[i::CPU_WORKERS])], stdout=subprocess.PIPE,
                              stderr=open(logs[i], "w"), text=True) for i in range(CPU_WORKERS)]
    results = []
    for i, p in enumerate(procs):
        stdout, _ = p.communicate()
        assert p.returncode == 0, logs[i].read_text()[-3000:]
        results += json.loads(stdout.splitlines()[-1])
    print(json.dumps({"curve": curve, "system": system, "steps": len(steps), "card_seconds": card_seconds,
                      "cpu_seconds": time.perf_counter() - t0 - card_seconds,
                      "slowest": max(steps, key=lambda r: r["wall_seconds"])["step"]}))
    assert len(results) == len(jobs)
    for response, rc in results:
        assert rc == 0, response
        with open(os.path.join(workdir, response[: -len(".cpu")]), "rb") as a, \
                open(os.path.join(workdir, response), "rb") as b:
            assert a.read() == b.read(), response


@pytest.mark.gpu
def test_bls12_381_prepare_into_phase2_on_the_card(tmp_path):
    curve, power, batch = PHASE2
    common = ["--curve", curve, "--device", "cuda", "--workdir", str(tmp_path / "phase2"), "--seed", str(SEED)]
    # the transcript is prepared for the x^2 circuit's domain, 8: `new` reads a domain's Lagrange
    # coefficients and refuses a transcript made for another size (the scripts' defaults, 2^power)
    steps, _ = _card_run(tmp_path, [["prepare", "--power", str(power), "--batch-size", str(batch), "--chunk-size",
                                     str(batch), "--phase2-size", "8", *common], ["phase2_chunked", *common]])
    assert all(r["rc"] == 0 for r in steps)
    assert [r["step"] for r in steps][-3:] == ["chunk 1 verify 2", "combine", "test"]
    assert steps[-1]["profile"] == "phase2_chunked"
    assert os.path.getsize(tmp_path / "phase2" / "combined.params") > 0
