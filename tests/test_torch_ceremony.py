"""The port's ceremony driver, scripts/torch_ceremony.py, on the CPU.

- Every profile's plan at its script's default sizes names the steps and
  flags of that script (scripts/*.sh), transcribed below; the driver adds
  `--device` to each CLI that computes (left out here), `circuit_main
  create` before phase 2, and the `bench` chunk's verification.
- The `full` profile (BLS12-377, power 3, batch 8) from fixed seed files
  through the port's CLIs with `--device cpu` writes every file
  byte-identical (tolerance 0) to the same plan through the JAX package's
  CLIs (`snark_setup_tpu.cli`, run in a fresh interpreter); once as it is
  and once with every batch cut into slices of 3 lanes (`lanes.MAX_LANES`),
  the bound that keeps a 2^21-lane BW6-761 batch within the card's memory.
- The `chunked` profile (power 3, batch 8, chunk 4; Groth16 and Marlin) on
  the port alone: every step exits 0, every `.hash` file and the host
  oracle's lanes check, and both ratio checks accept.
- A response whose `.hash` file was rewritten after one byte of it was
  flipped makes the driver exit non-zero at that chunk's verification.
- The two whole-batch buffers bounded by `MAX_LANES` (the plain Montgomery
  product's columns and the batched subgroup check's rounds) give the same
  values sliced as whole.
"""

import importlib.util
import io
import json
import os
import pickle
import random
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch_phase2_reference as R
from filelock import FileLock

from snark_setup_tpu_torch.ops import lanes
from snark_setup_tpu_torch.ops.curve import curve_ops
from snark_setup_tpu_torch.phase1 import protocol

# several pytest workers share the host's cores (see tests/test_torch_cli_phase2.py)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 14
BEACON = "0000000000000000000a558a61ddc8ee4e488d647a747fe4dcc362fe2026c620"


def _driver():
    spec = importlib.util.spec_from_file_location("torch_ceremony", os.path.join(REPO, "scripts", "torch_ceremony.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


C = _driver()


def _config(profile, device="cpu", **kw):
    curve, power, batch, chunk = C.DEFAULTS[profile]
    return C.Config(profile, kw.pop("curve", curve), kw.pop("power", power), kw.pop("batch", batch),
                    kw.pop("chunk", chunk or (batch if profile == "bench" else None)), device=device, **kw)


def _files(workdir) -> dict:
    """Every file a run wrote but the driver's journal."""
    return {n: open(os.path.join(workdir, n), "rb").read() for n in sorted(os.listdir(workdir))
            if os.path.isfile(os.path.join(workdir, n)) and n != "journal.jsonl"}


def _run(cfg, workdir, seed=SEED, **kw):
    C.write_seeds(str(workdir), seed, resume=False)
    out = io.StringIO()
    records = C.run(cfg, C.plan(cfg), str(workdir), inprocess=True, out=out, **kw)
    return records, [json.loads(line) for line in out.getvalue().splitlines()]


# -- the scripts, transcribed ----------------------------------------------------------------------

VERIFY = "verify-and-transform-pok-and-correctness"


def _verify_line(prefix, i, chal, resp, new):
    idx = "" if i is None else f" --chunk-index {i}"
    return (f"{prefix}{idx} {VERIFY} --challenge-fname {chal} --challenge-hash-fname {chal}.verified.hash "
            f"--response-fname {resp} --response-hash-fname {resp}.verified.hash --new-challenge-fname {new} "
            f"--new-challenge-hash-fname {new}.verified.hash")


def script_full(C_="bls12_377", P=3, B=8, PS="groth16"):
    """scripts/phase1_full.sh."""
    phase1 = f"phase1_main --curve-kind {C_} --batch-size {B} --contribution-mode full --power {P} --seed seed1 " \
             f"--proving-system {PS}"
    return [
        f"{phase1} new --challenge-fname challenge --challenge-hash-fname challenge.verified.hash",
        f"{phase1} contribute --challenge-fname challenge --challenge-hash-fname challenge.hash --response-fname "
        f"response --response-hash-fname response.hash",
        _verify_line(phase1, None, "challenge", "response", "new_challenge"),
        f"{phase1} beacon --challenge-fname new_challenge --challenge-hash-fname new_challenge.hash "
        f"--response-fname new_response --response-hash-fname new_response.hash --beacon-hash {BEACON}",
        _verify_line(phase1, None, "new_challenge", "new_response", "new_challenge_2"),
        f"{phase1} verify-and-transform-ratios --response-fname new_challenge_2",
    ]


def _chunked_prefixes(C_, P, B, CS, PS):
    common = f"--curve-kind {C_} --batch-size {B} --contribution-mode chunked --chunk-size {CS} --power {P}"
    return (f"phase1_main {common} --seed seed1 --proving-system {PS}",
            f"phase1_main {common} --seed seed2 --proving-system {PS}",
            f"phase1_main {common} --proving-system {PS}",
            f"phase1_main --curve-kind {C_} --batch-size {B} --contribution-mode full --power {P} "
            f"--proving-system {PS}")


def _contribute_round(i, c1, c2, chal, resp):
    """scripts/phase1_chunked.sh: contribute_round."""
    return [
        f"{c1} --chunk-index {i} contribute --challenge-fname {chal}_{i} --challenge-hash-fname {chal}_{i}.hash "
        f"--response-fname {resp}_{i} --response-hash-fname {resp}_{i}.hash",
        _verify_line(c2, i, f"{chal}_{i}", f"{resp}_{i}", f"new_{chal}_{i}"),
        f"{c2} --chunk-index {i} contribute --challenge-fname new_{chal}_{i} --challenge-hash-fname "
        f"new_{chal}_{i}.hash --response-fname new_{resp}_{i} --response-hash-fname new_{resp}_{i}.hash",
        _verify_line(c1, i, f"new_{chal}_{i}", f"new_{resp}_{i}", f"new_new_{chal}_{i}"),
    ]


def _close(comb, full, list_name, combined, beacon, new):
    return [
        f"{comb} combine --response-list-fname {list_name} --combined-fname {combined}",
        f"{full} beacon --challenge-fname {combined} --response-fname {beacon} --beacon-hash {BEACON}",
        _verify_line(full, None, combined, beacon, new),
        f"{full} verify-and-transform-ratios --response-fname {new}",
    ]


def _first_round(C_, P, B, CS, PS):
    p1, p2, comb, full = _chunked_prefixes(C_, P, B, CS, PS)
    total = 2 ** (P + 1) - 1 if PS == "groth16" else 2 ** P
    lines = []
    for i in range((total + CS - 1) // CS):
        c1, c2 = (p1, p2) if i % 2 == 0 else (p2, p1)
        lines.append(f"{p1} --chunk-index {i} new --challenge-fname challenge_{i} --challenge-hash-fname "
                     f"challenge_{i}.verified.hash")
        lines += _contribute_round(i, c1, c2, "challenge", "response")
    lines += _close(comb, full, "response_list", "combined", "response_beacon", "response_beacon_new_challenge")
    return lines, total


def script_chunked(C_="bls12_377", P=3, B=8, CS=4, PS="groth16"):
    """scripts/phase1_chunked.sh."""
    p1, p2, comb, full = _chunked_prefixes(C_, P, B, CS, PS)
    lines, total = _first_round(C_, P, B, CS, PS)
    # the script's --full-fname is response_beacon_new_challenge: uncompressed, which split (it reads a
    # compressed full response) refuses by its length in both packages; the driver splits the beacon's response
    lines.append(f"{comb} split --chunk-fname-prefix chunk_split --full-fname response_beacon")
    for i in range((total + CS - 1) // CS):
        c1, c2 = (p1, p2) if i % 2 == 0 else (p2, p1)
        lines += _contribute_round(i, c1, c2, "chunk_split", "response_split")
    return lines + _close(comb, full, "response_list_split", "combined_split", "response_beacon_split",
                          "response_beacon_new_challenge_split")


def script_prepare(C_="bls12_377", P=4, B=16, CS=16, PS="groth16"):
    """scripts/phase1_chunked_prepare_phase2.sh (OUT in the work directory)."""
    lines, _ = _first_round(C_, P, B, CS, PS)
    return lines + [f"prepare_phase2_main --curve-kind {C_} --batch-size {B} --power {P} --proving-system {PS} "
                    f"--phase2-size {2 ** P} --phase2-fname phase1_transcript --response-fname "
                    f"response_beacon_new_challenge"]


def script_phase2_chunked(chunks, C_="bls12_377", B=64, CS=4):
    """`circuit_main create`, then scripts/phase2_chunked.sh on its circuit
    file (the script copies $CIRCUIT to circuit.constraints)."""
    pc = f"phase2_main --curve-kind {C_} --batch-size {B} --contribution-mode full --chunk-size {CS}"
    p = {s: f"phase2_main --curve-kind {C_} --batch-size {B} --contribution-mode chunked --chunk-size {CS} "
            f"--seed {s}" for s in ("seed1", "seed2")}
    lines = [f"circuit_main create --curve-kind {C_}",
             f"{pc} new --challenge-fname challenge --challenge-hash-fname challenge.verified.hash "
             f"--challenge-list-fname new_challenge_list --phase1-fname phase1_transcript --circuit-fname "
             f"testcircuit_{C_}"]
    for i in range(chunks):
        c1, c2 = (p["seed1"], p["seed2"]) if i % 2 == 0 else (p["seed2"], p["seed1"])
        lines += [
            f"{c1} --chunk-index {i} contribute --challenge-fname challenge.{i} --challenge-hash-fname "
            f"challenge.{i}.hash --response-fname response_{i} --response-hash-fname response_{i}.hash",
            f"{c1} --chunk-index {i} verify --challenge-fname challenge.{i} --challenge-hash-fname "
            f"challenge_{i}.verified.hash --response-fname response_{i} --response-hash-fname "
            f"response_{i}.verified.hash --new-challenge-fname verified_{i} --new-challenge-hash-fname "
            f"verified_{i}.verified.hash",
            f"{c2} --chunk-index {i} contribute --challenge-fname verified_{i} --challenge-hash-fname "
            f"verified_{i}.hash --response-fname new_response_{i} --response-hash-fname new_response_{i}.hash",
            f"{c2} --chunk-index {i} verify --challenge-fname verified_{i} --challenge-hash-fname "
            f"verified_{i}.verified.hash --response-fname new_response_{i} --response-hash-fname "
            f"new_response_{i}.verified.hash --new-challenge-fname verified2_{i} --new-challenge-hash-fname "
            f"verified2_{i}.verified.hash",
        ]
    return lines + [f"{pc} combine --response-list-fname response_list --initial-query-fname challenge.query "
                    f"--initial-full-fname challenge.full --combined-fname combined",
                    f"circuit_main test --curve-kind {C_} --proving-key-path combined.params"]


def script_scale(C_="bls12_377", P=20, B=2 ** 16, CS=2 ** 18, PS="groth16"):
    """scripts/phase1_scale.sh."""
    phase1 = f"phase1_main --curve-kind {C_} --batch-size {B} --contribution-mode chunked --chunk-size {CS} " \
             f"--power {P} --seed seed1 --proving-system {PS}"
    full = f"phase1_main --curve-kind {C_} --batch-size {B} --contribution-mode full --power {P} --proving-system {PS}"
    lines = []
    for i in range((2 ** (P + 1) - 1 + CS - 1) // CS):
        lines += [
            f"{phase1} --chunk-index {i} new --challenge-fname challenge_{i} --challenge-hash-fname "
            f"challenge_{i}.verified.hash",
            f"{phase1} --chunk-index {i} contribute --challenge-fname challenge_{i} --challenge-hash-fname "
            f"challenge_{i}.hash --response-fname response_{i} --response-hash-fname response_{i}.hash",
            _verify_line(phase1, i, f"challenge_{i}", f"response_{i}", f"new_challenge_{i}"),
        ]
    return lines + [f"{phase1} combine --response-list-fname response_list --combined-fname combined",
                    f"{full} verify-and-transform-ratios --response-fname combined"]


def script_bench(C_="bw6", P=16, B=2 ** 14):
    """scripts/benchmark.sh, then the chunk's verification (the driver's)."""
    phase1 = f"phase1_main --curve-kind {C_} --batch-size {B} --power {P} --seed seed1 --contribution-mode chunked " \
             f"--chunk-size {B}"
    return [f"{phase1} --chunk-index 0 new --challenge-fname challenge_0",
            f"{phase1} --chunk-index 0 contribute --challenge-fname challenge_0 --response-fname response_0",
            _verify_line(phase1, 0, "challenge_0", "response_0", "new_challenge_0")]


SCRIPTS = {"full": script_full, "chunked": script_chunked, "prepare": script_prepare,
           "phase2_chunked": lambda: script_phase2_chunked(2), "scale": script_scale, "bench": script_bench}


@pytest.mark.parametrize("profile", C.PROFILES)
def test_plan_names_the_scripts_steps_and_flags(profile, tmp_path):
    steps = C.plan(_config(profile, device=None))
    (tmp_path / "new_challenge_list").write_text("challenge.0\nchallenge.1\n")
    lines = []
    for s in steps:
        for t in (s.fn(str(tmp_path)) if isinstance(s, C.Expand) else [s]):
            lines.append(" ".join([t.cli, *t.argv]))
    assert lines == SCRIPTS[profile]()
    # on a device every CLI that computes gets the flag; `new` and `create` are host work
    for s in C.plan(_config(profile, device="cuda")):
        if not isinstance(s, C.Expand) and s.argv[-2:] != ["--device", "cuda"]:
            assert " new " in f" {' '.join(s.argv)} " or s.argv[0] == "create" or "--device" in s.argv, s.label


# -- the full profile against the JAX package ------------------------------------------------------


def jax_full_run(workdir: str) -> dict:
    """The `full` profile's plan through the JAX package's CLIs, in this
    (fresh) interpreter; returns every file it wrote."""
    cfg = _config("full", device=None)
    _run(cfg, workdir, package="snark_setup_tpu.cli")
    return _files(workdir)


@pytest.fixture(scope="session")
def jax_full(tmp_path_factory):
    root = R.shared_dir(tmp_path_factory)
    path = root / "torch_ceremony_full_jax.pkl"
    with FileLock(str(path) + ".lock"):
        if not path.exists():
            workdir = root / "torch_ceremony_full_jax"
            workdir.mkdir(exist_ok=True)
            files = R.in_fresh_interpreter("test_torch_ceremony", "jax_full_run", str(workdir))
            with open(path, "wb") as f:
                pickle.dump(files, f)
    with open(path, "rb") as f:
        return pickle.load(f)  # written by this test run


@pytest.mark.parametrize("max_lanes", [None, 3], ids=["whole", "lanes_3"])
def test_full_profile_files_equal_the_jax_packages(jax_full, tmp_path, monkeypatch, max_lanes):
    if max_lanes is not None:
        monkeypatch.setattr(lanes, "MAX_LANES", max_lanes)
    records, lines = _run(_config("full"), tmp_path)
    assert [r["step"] for r in records] == ["new", "contribute", "verify", "beacon", "verify beacon",
                                            "ratios new_challenge_2"]
    assert all(r["rc"] == 0 for r in records) and lines == records
    # four tau_g1 lanes, the same lanes of the other sections that reach them, beta_g2
    assert records[1]["oracle_points"] >= 4 + 3 + 1 and records[3]["oracle_points"] >= 4 + 3 + 1
    assert sum(r["hash_checks"] for r in records) == 11
    files = _files(tmp_path)
    assert sorted(files) == sorted(jax_full)
    assert [n for n in files if files[n] != jax_full[n]] == []


# -- the chunked profile, the corrupted response -------------------------------------------------


@pytest.mark.parametrize("system", ["groth16", "marlin"])
def test_chunked_profile_runs_and_checks(system, tmp_path):
    cfg = _config("chunked", proving_system=system)
    records, _ = _run(cfg, tmp_path)
    chunks = 4 if system == "groth16" else 2
    assert len(records) == 5 * chunks + 5 + 4 * chunks + 4
    assert all(r["rc"] == 0 for r in records)
    contributions = [r for r in records if "contribute" in r["step"] or r["step"].startswith("beacon")]
    assert len(contributions) == 4 * chunks + 2
    total = 15 if system == "groth16" else 8  # tau_g1 powers; the last Groth16 chunk holds 3
    for r in contributions:  # four tau_g1 lanes, or every lane of a shorter chunk
        assert r["oracle_points"] >= (4 if r["chunk"] is None else min(4, total - 4 * r["chunk"])), r
    assert [r["step"] for r in records if r["step"].startswith("ratios")] == [
        "ratios response_beacon_new_challenge", "ratios response_beacon_new_challenge_split"]
    files = _files(tmp_path)
    for i in range(chunks):
        assert files[f"chunk_split_{i}"] and files[f"new_response_split_{i}"][:64] == \
            C.blake2b_file(str(tmp_path / f"new_chunk_split_{i}"))


def test_flipped_response_byte_stops_the_driver_at_its_verification(tmp_path):
    cfg = _config("chunked")
    steps = C.plan(cfg)
    C.write_seeds(str(tmp_path), SEED, resume=False)
    C.run(cfg, steps[:4], str(tmp_path), inprocess=True, out=io.StringIO())  # chunk 0 up to its second response
    assert [s.label for s in steps[2:5]] == ["chunk 0 verify", "chunk 0 contribute 2", "chunk 0 verify 2"]
    resp = tmp_path / "new_response_0"
    data = bytearray(resp.read_bytes())
    data[len(data) // 2] ^= 0x01
    resp.write_bytes(bytes(data))
    (tmp_path / "new_response_0.hash").write_bytes(C.blake2b_file(str(resp)))
    done = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "torch_ceremony.py"), "chunked",
                           "--device", "cpu", "--workdir", str(tmp_path), "--resume", "--seed", str(SEED)],
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert done.returncode == 1, done.stderr[-2000:]
    lines = [json.loads(line) for line in done.stdout.splitlines()]
    assert [r.get("skipped") for r in lines[:4]] == [True] * 4
    assert lines[4]["step"] == "chunk 0 verify 2" and lines[4]["rc"] != 0
    assert lines[-1] == {"profile": "chunked", "ok": False, "workdir": str(tmp_path)}


# -- the whole-batch buffers, sliced ---------------------------------------------------------------


@pytest.mark.parametrize("curve", ["bls12_377", "bw6_761"])
def test_sliced_montgomery_product_equals_whole(curve, monkeypatch):
    fq = curve_ops(curve, "g1").fq
    rng = random.Random(5)
    xs, ys = [rng.randrange(fq.modulus) for _ in range(11)], [rng.randrange(fq.modulus) for _ in range(22)]
    a = fq.tensor(fq.from_int(xs), "cpu")
    b3 = fq.tensor(fq.from_int(ys), "cpu").view(fq.L, 2, 11)  # a batch of two axes
    a3 = a.view(fq.L, 1, 11)
    pairs = b3.transpose(1, 2)  # (L, 11, 2) against (L, 11, 1): the batch inversion's downward pass
    calls = lambda: (fq.mont_mul(a, a.flip(-1)), fq.to_mont_raw(a), fq.mont_mul(b3, a3),
                     fq.mont_mul(a3[..., :1], b3), fq.mont_mul(a.unsqueeze(-1), pairs))
    whole = calls()
    monkeypatch.setattr(lanes, "MAX_LANES", 3)
    sliced = calls()
    for w, s in zip(whole, sliced):
        assert torch.equal(w, s)
    assert fq.to_int(whole[0]) == [x * y % fq.modulus for x, y in zip(xs, xs[::-1])]
    assert fq.to_int(whole[2]) == [y * xs[i % 11] % fq.modulus for i, y in enumerate(ys)]
    assert fq.to_int(whole[3]) == [y * xs[0] % fq.modulus for y in ys]
    assert fq.to_int(whole[4]) == [ys[j * 11 + i] * xs[i] % fq.modulus for i in range(11) for j in range(2)]


def test_sliced_subgroup_sums_equal_whole(monkeypatch):
    from snark_setup_tpu_torch.curves.host import INFINITY, g1_curve

    ops = curve_ops("bls12_377", "g1")
    host = g1_curve(ops.spec)
    rng = np.random.default_rng(9)
    B = 11
    pts = ops.from_affine_host([host.mul(host.generator, int(k)) for k in rng.integers(1, 1 << 30, B)], "cpu")
    bits = rng.integers(0, 2, (protocol.SUBGROUP_BATCH_ROUNDS, B)).astype(bool)
    whole = protocol._batched_subgroup_sums(ops, pts, bits)
    monkeypatch.setattr(lanes, "MAX_LANES", 4)  # slices of 4, 4 and 3 lanes
    sliced = protocol._batched_subgroup_sums(ops, pts, bits)
    for c in "xyz":
        assert torch.equal(whole[c], sliced[c])
    sums = ops.to_affine_host(whole)
    points = ops.to_affine_host(pts)
    for j in (0, 17, 63):
        want = INFINITY
        for i in np.flatnonzero(bits[j]):
            want = host.add(want, points[i])
        assert sums[j] == want


# -- the prover's h polynomial -------------------------------------------------------------------


@pytest.mark.parametrize("curve", ["bls12_377", "bw6_761"])
@pytest.mark.parametrize("circuit", ["x2", "parallel_29"])
def test_h_coefficients_by_the_coset_equal_the_jax_packages_schoolbook(curve, circuit):
    """The prover's quotient (A·B − C) / (X^m − 1) by coset transforms equals
    the JAX package's schoolbook product's, and both refuse a bad witness.
    `circuit_main test` on the SHA-256 circuit (m = 2^16) did not finish in
    26 minutes on the schoolbook product."""
    from snark_setup_tpu.ntt.domain import Radix2Domain as JDomain
    from snark_setup_tpu.phase2 import groth16 as jgroth16

    from snark_setup_tpu_torch.curves.constants import get_curve
    from snark_setup_tpu_torch.ntt.domain import Radix2Domain
    from snark_setup_tpu_torch.phase2 import groth16
    from snark_setup_tpu_torch.phase2.r1cs import (
        ConstraintSystem, TestCircuit, TestParallelCircuit, add_input_density_constraints)

    r = get_curve(curve).r
    rng = random.Random(3)
    if circuit == "x2":
        c = TestCircuit(rng.randrange(r))
    else:
        c = TestParallelCircuit(29, [rng.randrange(r) for _ in range(30)])
    cs = ConstraintSystem(r, setup=False)
    c.generate_constraints(cs)
    add_input_density_constraints(cs)
    z = cs.full_assignment()
    n = max(cs.num_constraints, len(z))
    h = groth16._h_coefficients(cs, z, Radix2Domain(curve, n))
    assert h == jgroth16._h_coefficients(cs, z, JDomain(curve, n))
    assert len(h) == Radix2Domain(curve, n).size - 1
    bad = list(z)
    bad[-1] = (bad[-1] + 1) % r
    for fn, dom in ((groth16._h_coefficients, Radix2Domain), (jgroth16._h_coefficients, JDomain)):
        with pytest.raises(AssertionError, match="does not vanish"):
            fn(cs, bad, dom(curve, n))
