"""Shared inputs and JAX-package outputs of the phase-2 parity tests
(tests/test_torch_phase2.py, tests/test_torch_cli_phase2.py,
tests/test_torch_phase2_chunked.py).

- `phase1_transcript`: a full, uncompressed Groth16 phase-1 transcript made
  with host arithmetic (fixed tau, alpha, beta) on a given curve, handed to
  both packages.
- `jax_reference`: everything the JAX package computes from it on that
  curve — Groth16Params and prepare_phase2 bytes, QAP evaluations,
  MPCParameters new / new_chunked / contribute / verify / combine, and (on
  BLS12-377) its phase-2 CLI chain's files — in one process, so that each
  of its deep XLA:CPU compiles (the group FFT, the segmented row sums, the
  codec) runs once.
- `reference`: a session fixture's getter, per curve; the first pytest
  worker that needs a curve's outputs computes them in a fresh interpreter
  (an XLA:CPU abort then fails a test instead of taking a worker down)
  under a file lock in the directory the workers share; the others read
  them.
- `jax_chunked_reference` / `chunked_reference`: the JAX package's streaming
  phase 2 on MPCParameters bytes, the same way in a fresh interpreter of
  its own.
"""

import contextlib
import os
import pickle
import random
import subprocess
import sys

from filelock import FileLock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CURVE = "bls12_377"
POWER = 4  # 31 tau_g1 powers: a domain of 8 and its 7 h points
PHASE2_SIZE = 7  # TestCircuit: 6 constraints -> domain 8
CHUNK = 4  # 2 chunks of the 7 h points
TAU, ALPHA, BETA = 0x1D2C3B4A5968778695A4B3C2D1E0F, 0x5EED_A1FA, 0x5EED_BE7A
CONTRIBUTION_SEEDS = (b"phase2-c1", b"phase2-c2")
CLI_SEEDS = ("cc" * 32, "dd" * 32)
PARALLEL_K = 3  # TestParallelCircuit(3): 7 constraints, nnz 7 / 3 / 3


def phase1_transcript(curve: str = CURVE, power: int = POWER) -> bytes:
    """A full uncompressed Groth16 phase-1 transcript of `power` with
    tau^i G1 (i < 2^(power+1) - 1), tau^i G2, alpha tau^i G1, beta tau^i G1
    (i < 2^power) and beta G2, each point written by the host codec."""
    from snark_setup_tpu_torch.curves.host import g1_curve, g2_curve
    from snark_setup_tpu_torch.phase1.buffers import split
    from snark_setup_tpu_torch.phase1.parameters import Phase1Parameters
    from snark_setup_tpu_torch.serialize.arkworks import g1_codec, g2_codec
    from snark_setup_tpu_torch.utils.enums import ProvingSystem, UseCompression

    params = Phase1Parameters.new_full(curve, ProvingSystem.GROTH16, power, 8)
    spec = params.spec
    sec = split(params, UseCompression.NO)
    buf = bytearray(params.get_length(UseCompression.NO))
    r = spec.r
    c1, c2 = g1_curve(spec), g2_curve(spec)
    w1, w2 = g1_codec(spec), g2_codec(spec)
    for name, curve_, codec, scale in (("tau_g1", c1, w1, 1), ("tau_g2", c2, w2, 1),
                                        ("alpha_g1", c1, w1, ALPHA), ("beta_g1", c1, w1, BETA)):
        for i in range(sec[name].num_elements):
            p = curve_.mul(curve_.generator, scale * pow(TAU, i, r) % r)
            sec[name].slice_of(buf, i, i + 1)[:] = codec.serialize(p, UseCompression.NO)
    sec["beta_g2"].slice_of(buf, 0, 1)[:] = w2.serialize(c2.mul(c2.generator, BETA), UseCompression.NO)
    return bytes(buf)


def _ser(spec, group, pts) -> list[bytes]:
    """Points as uncompressed bytes, by the JAX package's host codec."""
    from snark_setup_tpu.serialize.arkworks import g1_codec, g2_codec
    from snark_setup_tpu.utils.enums import UseCompression

    codec = g1_codec(spec) if group == "g1" else g2_codec(spec)
    return [codec.serialize(p, UseCompression.NO) for p in pts]


def _raised(fn) -> tuple:
    try:
        fn()
    except Exception as e:  # the test compares the class and message
        return type(e).__name__, str(e)
    return None


@contextlib.contextmanager
def _cwd(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def cli_chain(circuit_main, prepare_main, phase2_main, workdir: str, transcript: bytes, extra=(),
              curve: str = CURVE) -> dict:
    """prepare -> new (2 chunks) -> one participant contributes to each
    chunk -> verify each -> combine -> circuit test on `curve` (a power-4
    transcript), through one package's CLI mains (`extra`: flags every
    command of it takes) in `workdir`; returns each command's exit code by
    name."""
    with open(os.path.join(workdir, "response"), "wb") as f:
        f.write(transcript)
    with open(os.path.join(workdir, "seed1"), "w") as f:
        f.write(CLI_SEEDS[0])
    rcs = {}
    common = ["--curve-kind", curve, "--batch-size", "4", "--chunk-size", str(CHUNK), *extra]
    with _cwd(workdir):
        rcs["create"] = circuit_main.main(["create", "--curve-kind", curve])
        rcs["prepare"] = prepare_main.main(["--curve-kind", curve, "--power", str(POWER), "--batch-size", "8",
                                            "--phase2-size", "8", "--phase2-fname", "transcript",
                                            "--response-fname", "response", *extra])
        rcs["new"] = phase2_main.main(common + ["new", "--challenge-fname", "challenge",
                                                "--challenge-hash-fname", "challenge.verified.hash",
                                                "--challenge-list-fname", "new_challenge_list",
                                                "--phase1-fname", "transcript",
                                                "--circuit-fname", f"testcircuit_{curve}"])
        with open("new_challenge_list") as f:
            chunks = f.read().split()
        for i, chunk in enumerate(chunks):
            rcs[f"contribute {i}"] = phase2_main.main(
                common + ["--seed", "seed1", "--chunk-index", str(i), "contribute", "--challenge-fname", chunk,
                          "--challenge-hash-fname", f"{chunk}.hash", "--response-fname", f"response_{i}",
                          "--response-hash-fname", f"response_{i}.hash"])
            rcs[f"verify {i}"] = phase2_main.main(
                common + ["--chunk-index", str(i), "verify", "--challenge-fname", chunk,
                          "--challenge-hash-fname", f"{chunk}.verified.hash", "--response-fname",
                          f"response_{i}", "--response-hash-fname", f"response_{i}.verified.hash",
                          "--new-challenge-fname", f"verified_{i}",
                          "--new-challenge-hash-fname", f"verified_{i}.verified.hash"])
        with open("response_list", "w") as f:
            f.write("".join(f"response_{i}\n" for i in range(len(chunks))))
        rcs["combine"] = phase2_main.main(common + ["combine", "--response-list-fname", "response_list",
                                                    "--initial-query-fname", "challenge.query",
                                                    "--initial-full-fname", "challenge.full",
                                                    "--combined-fname", "combined"])
        test_args = ["test", "--curve-kind", curve, "--proving-key-path", "combined.params"]
        rcs["test"] = circuit_main.main(test_args + [a for a in extra])
    return rcs


def jax_reference(transcript: bytes, workdir: str, curve: str = CURVE) -> dict:
    """The JAX package's outputs from `transcript` on `curve` (see the
    module doc); the parallel circuit and the CLI chain on `CURVE` only."""
    from snark_setup_tpu.cli import circuit_main, phase2_main, prepare_phase2_main
    from snark_setup_tpu.curves.constants import get_curve
    from snark_setup_tpu.curves.host import g1_curve
    from snark_setup_tpu.ops.curve_jax import curve_ops
    from snark_setup_tpu.phase1.buffers import split
    from snark_setup_tpu.phase1.parameters import Phase1Parameters
    from snark_setup_tpu.phase2.lagrange import Groth16Params, prepare_transcript_device
    from snark_setup_tpu.phase2.load_circuit import Matrices
    from snark_setup_tpu.phase2.parameters import MPCParameters
    from snark_setup_tpu.phase2.polynomial import dot_product_vec, eval_qap, process_matrix
    from snark_setup_tpu.phase2.r1cs import TestCircuit, TestParallelCircuit, circuit_to_qap
    from snark_setup_tpu.serialize.arkworks import g1_codec, g2_codec
    from snark_setup_tpu.transcript.hashing import derive_rng_from_seed
    from snark_setup_tpu.utils.enums import CheckForCorrectness, ProvingSystem, UseCompression

    NO, YES = UseCompression.NO, UseCompression.YES
    spec = get_curve(curve)
    params = Phase1Parameters.new_full(curve, ProvingSystem.GROTH16, POWER, 8)
    sec = split(params, NO)

    def section(name, group):
        codec = g1_codec(spec) if group == "g1" else g2_codec(spec)
        return [codec.deserialize(bytes(sec[name].slice_of(transcript, i, i + 1)), NO, CheckForCorrectness.NO)
                for i in range(sec[name].num_elements)]

    tau_g1, tau_g2 = section("tau_g1", "g1"), section("tau_g2", "g2")
    alpha_g1, beta_g1, beta_g2 = section("alpha_g1", "g1"), section("beta_g1", "g1"), section("beta_g2", "g2")
    out = {}
    gp = Groth16Params.new(curve, PHASE2_SIZE, tau_g1, tau_g2, alpha_g1, beta_g1, beta_g2[0])
    out["params_write"] = gp.write(NO)
    out["prepare"] = prepare_transcript_device(curve, PHASE2_SIZE, transcript, params)

    def matrices(circuit):
        return Matrices.from_constraint_system(spec, circuit_to_qap(circuit, spec.r))

    mats = matrices(TestCircuit())
    nv = mats.num_instance_variables + mats.num_witness_variables
    at, bt, ct = (process_matrix(x, nv) for x in (mats.a, mats.b, mats.c))
    qap = eval_qap(curve, gp.coeffs_g1, gp.coeffs_g2, gp.alpha_coeffs_g1, gp.beta_coeffs_g1, at, bt, ct,
                   mats.num_instance_variables)
    out["eval_qap"] = [_ser(spec, g, v) for g, v in zip(("g1", "g1", "g2", "g1", "g1"), qap)]
    if curve == CURVE:
        par = matrices(TestParallelCircuit(PARALLEL_K))
        pat = process_matrix(par.a, par.num_instance_variables + par.num_witness_variables)
        out["parallel_a_g1"] = _ser(spec, "g1", dot_product_vec(curve_ops(CURVE, "g1"), gp.coeffs_g1, pat))

    mpc = MPCParameters.new(mats, gp)
    out["mpc_new"] = mpc.write(NO)
    full, query, chunks = MPCParameters.new_chunked(mats, gp, CHUNK)
    out["mpc_chunked"] = (full.write(NO), query.write(spec, NO), [c.write(NO) for c in chunks])
    c1 = mpc.clone()
    out["contribution_hashes"] = [c1.contribute(derive_rng_from_seed(CONTRIBUTION_SEEDS[0]))]
    c2 = c1.clone()
    out["contribution_hashes"].append(c2.contribute(derive_rng_from_seed(CONTRIBUTION_SEEDS[1])))
    out["contributed"] = (c1.write(YES), c2.write(YES))
    out["verify_hashes"] = (mpc.verify(c1, rlc_rng=random.Random(11)), mpc.verify(c2, rlc_rng=random.Random(12)),
                            c1.verify(c2, rlc_rng=random.Random(13)))
    out["verify_self"] = _raised(lambda: mpc.verify(mpc))
    bad = c2.clone()
    bad.params.delta_g1 = g1_curve(spec).mul(bad.params.delta_g1, 2)
    out["verify_tampered"] = _raised(lambda: c1.verify(bad, rlc_rng=random.Random(14)))
    after = []
    for ch in chunks:
        ch.contribute(derive_rng_from_seed(CONTRIBUTION_SEEDS[0]))
        after.append(ch)
    combined = MPCParameters.combine(spec, query, after)
    out["combined"] = combined.write(NO)
    out["combined_verify"] = full.verify(combined, rlc_rng=random.Random(15))
    if curve != CURVE:
        return out

    out["cli_rcs"] = cli_chain(circuit_main, prepare_phase2_main, phase2_main, workdir, transcript)
    out["cli_files"] = {}
    for name in sorted(os.listdir(workdir)):
        with open(os.path.join(workdir, name), "rb") as f:
            out["cli_files"][name] = f.read()
    return out


CHUNKED_BATCH = 4  # the streaming batch: the h (7) and l vectors take two batches each
CHUNKED_SEEDS = (b"chunked-1" + b"\0" * 23, b"chunked-2" + b"\0" * 23)
E2E_CHUNK = 2  # TestCircuit's domain of 8 // 3: four chunks of the h query
E2E_SEED = b"\0" * 32
REJECTIONS = ("a_point", "l_point", "truncated", "no_contributions", "only_non_zero_verify",
              "only_non_zero_contribute")


def tampered(layout, g1_ser, g1_curve, base: bytes, contributed: bytes, comp) -> dict:
    """The rejection cases of the streaming verify, as (before, after)
    buffers from one package's `_layout`, G1 serializer and host curve:
    an a-query point replaced by another subgroup point, an L point likewise,
    the L vector one point short, no contribution (before = after)."""
    _, _, spans, _ = layout(base, comp)
    _, _, after_spans, _ = layout(contributed, comp)
    out = {}
    for case, name, k in (("a_point", "a", 7), ("l_point", "l", 12345)):
        bad = bytearray(contributed)
        at = after_spans[name].offset
        bad[at : at + after_spans[name].el_size] = g1_ser(g1_curve.mul(g1_curve.generator, k), comp)
        out[case] = (base, bytes(bad))
    span = after_spans["l"]
    short = bytearray(contributed)
    short[span.offset - 8 : span.offset] = (span.count - 1).to_bytes(8, "little")
    del short[span.end - span.el_size : span.end]
    out["truncated"] = (base, bytes(short))
    out["no_contributions"] = (base, base)
    return out


def jax_chunked_reference(inputs: dict) -> dict:
    """The JAX package's streaming phase 2 (`phase2/chunked.py`) on the
    MPCParameters bytes in `inputs` (made by the port's `new` /
    `new_chunked`, which tests/test_torch_phase2.py holds to the JAX
    package's): per compression two in-place contributions, three streaming
    verifications and the rejections; then the end-to-end chunked flow of
    tests/test_phase2_chunked.py (a contribution per chunk, `combine`, the
    streaming verify of the combined parameters)."""
    from snark_setup_tpu.curves.constants import get_curve
    from snark_setup_tpu.curves.host import g1_curve
    from snark_setup_tpu.phase2 import chunked
    from snark_setup_tpu.phase2.keypair import Phase2PublicKey
    from snark_setup_tpu.phase2.parameters import MPCParameters, ProvingKey
    from snark_setup_tpu.phase2.vecio import Cursor
    from snark_setup_tpu.serialize.arkworks import g1_codec
    from snark_setup_tpu.transcript.hashing import derive_rng_from_seed
    from snark_setup_tpu.utils.enums import CheckForCorrectness, UseCompression

    spec = get_curve(CURVE)
    FULL, ONZ = CheckForCorrectness.FULL, CheckForCorrectness.ONLY_NON_ZERO
    pk_size = Phase2PublicKey.size(spec)
    out = {}
    for comp in (UseCompression.NO, UseCompression.YES):
        base = inputs["mpc"][comp.name]
        res = {"hashes": [], "contributed": []}
        prev = base
        for seed in CHUNKED_SEEDS:
            buf = bytearray(prev) + bytes(pk_size)
            res["hashes"].append(chunked.contribute(spec, buf, derive_rng_from_seed(seed), CHUNKED_BATCH, comp, FULL))
            res["contributed"].append(bytes(buf))
            prev = bytes(buf)
        c1, c2 = res["contributed"]
        res["verify"] = [chunked.verify(spec, b, a, CHUNKED_BATCH, comp, FULL, rlc_rng=random.Random(21 + i))
                         for i, (b, a) in enumerate(((base, c1), (c1, c2), (base, c2)))]
        cases = tampered(lambda d, c: chunked._layout(spec, d, c), g1_codec(spec).serialize, g1_curve(spec), base,
                         c1, comp)
        rej = {case: _raised(lambda b=b, a=a: chunked.verify(spec, b, a, CHUNKED_BATCH, comp, FULL,
                                                                rlc_rng=random.Random(24)))
               for case, (b, a) in cases.items()}
        rej["only_non_zero_verify"] = _raised(lambda: chunked.verify(spec, base, c1, CHUNKED_BATCH, comp, ONZ))
        rej["only_non_zero_contribute"] = _raised(lambda: chunked.contribute(
            spec, bytearray(base) + bytes(pk_size), derive_rng_from_seed(CHUNKED_SEEDS[0]), CHUNKED_BATCH, comp, ONZ))
        res["rejections"] = rej
        out[comp.name] = res

    NO, YES = UseCompression.NO, UseCompression.YES
    mpcs = [MPCParameters.read(spec, c, NO) for c in inputs["chunks"]]
    for m in mpcs:
        m.contribute(derive_rng_from_seed(E2E_SEED))
    query = ProvingKey.read(spec, Cursor(inputs["query"]), NO, CheckForCorrectness.NO)
    combined = MPCParameters.combine(spec, query, mpcs).write(YES)
    full = MPCParameters.read(spec, inputs["full"], NO).write(YES)
    out["e2e"] = {"chunks": [m.write(NO) for m in mpcs], "combined": combined,
                  "verify": chunked.verify(spec, full, combined, 3, YES, FULL, rlc_rng=random.Random(50))}
    return out


def in_fresh_interpreter(module: str, name: str, *args):
    """`name(*args)` of the test module `module`, run in a new Python
    process set up as tests/conftest.py sets up this one, with a large
    stack; arguments and result pickled (the result alone on its standard
    output)."""
    code = (
        "import pickle, sys\n"
        f"sys.path[:0] = [{REPO!r}, {os.path.join(REPO, 'tests')!r}]\n"
        "import tests.conftest\n"
        f"import tests.{module} as m\n"
        "result, sys.stdout = sys.stdout.buffer, sys.stderr\n"
        f"out = m.{name}(*pickle.loads(sys.stdin.buffer.read()))\n"
        "result.write(pickle.dumps(out))\n"
    )
    # XLA:CPU's deep compiles overflow the default 8 MB stack
    # (scripts/test_all.sh raises it the same way)
    shell = 'ulimit -s 262144 2>/dev/null; exec "$@"'
    done = subprocess.run(["/bin/sh", "-c", shell, "sh", sys.executable, "-c", code], input=pickle.dumps(args),
                          capture_output=True, cwd=REPO, timeout=2400)
    if done.returncode != 0:
        raise RuntimeError(f"{name} failed (rc {done.returncode}):\n{done.stderr.decode()[-3000:]}")
    return pickle.loads(done.stdout)  # written by this test run


def shared_dir(tmp_path_factory):
    """The directory every pytest worker of this run shares."""
    base = tmp_path_factory.getbasetemp()
    return base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base


def reference(tmp_path_factory, curve: str = CURVE, with_jax: bool = True) -> dict:
    """The transcript and the JAX package's outputs on `curve` (None unless
    `with_jax`), made once per run and curve, in a file of its own."""
    root = shared_dir(tmp_path_factory)
    tag = "" if curve == CURVE else f"_{curve}"
    path = root / f"torch_phase2_reference{tag}.pkl"
    with FileLock(str(path) + ".lock"):
        if not path.exists():
            transcript = phase1_transcript(curve)
            workdir = root / f"torch_phase2_jax_cli{tag}"
            workdir.mkdir(exist_ok=True)
            data = {"transcript": transcript,
                    "jax": in_fresh_interpreter("torch_phase2_reference", "jax_reference", transcript,
                                                str(workdir), curve) if with_jax else None}
            with open(path, "wb") as f:
                pickle.dump(data, f)
    with open(path, "rb") as f:
        return pickle.load(f)  # written by this test run


def chunked_reference(tmp_path_factory, make_inputs) -> dict:
    """`jax_chunked_reference` of the inputs that `make_inputs()` returns,
    made once per run in a fresh interpreter (a file of its own: an abort of
    its XLA:CPU compiles fails the streaming tests alone); returns
    {"inputs": ..., "jax": ...}."""
    root = shared_dir(tmp_path_factory)
    path = root / "torch_phase2_chunked_reference.pkl"
    with FileLock(str(path) + ".lock"):
        if not path.exists():
            inputs = make_inputs()
            data = {"inputs": inputs,
                    "jax": in_fresh_interpreter("torch_phase2_reference", "jax_chunked_reference", inputs)}
            with open(path, "wb") as f:
                pickle.dump(data, f)
    with open(path, "rb") as f:
        return pickle.load(f)  # written by this test run
