"""The slice as a whole: the port's phase-1 verification on the CPU, held
against the JAX package.

- Transcripts the JAX package produced (`setup_verify`, power 1, batch 4:
  BLS12-377 Groth16 and Marlin, BW6-761, BLS12-381): the port's
  `Phase1.verification` accepts them and writes a new challenge
  byte-identical to the JAX package's — its verification's output on
  BLS12-377 (Groth16 and Marlin) and BLS12-381, its host codec's
  re-encoding of the response on BW6-761 (the same bytes: the JAX
  package's own tests hold its verification to that re-encoding).
  MNT4-753 and MNT6-753 (a != 0): the port's own contribution, against the
  JAX package's host codec re-encoding.
- A wrong digest, a tampered byte (also on BLS12-381 and MNT6-753) and an
  out-of-subgroup point (DIRECT and BATCHED on BLS12-377 and BLS12-381 G1,
  DIRECT on BW6-761 G1) raise the same exception class in both packages.
- `aggregate_verification` (Groth16 and Marlin) and `_batched_subgroup_sums`
  (same subset bits) agree with the JAX package.
- The CLI chain on `--device cpu`: new -> contribute -> verify -> beacon ->
  verify -> ratios, and chunked combine / split, hash chain intact.

The transcripts of one curve are made once per test run, together: the
first worker to need them computes them under a file lock in the directory
the pytest workers share, the others read them. The JAX package's deep
compiles (its ladder, its scanned subset sums) run in a fresh interpreter:
XLA:CPU can abort on them (KNOWN_ISSUES.md §3), which would take a whole
pytest worker down with them. Most of the time left is host pairings
(`check_same_ratio`, 12 per verification at power 1). Exact equality
(bytes; tolerance 0).
"""

import hashlib
import os
import pickle
import random
import subprocess
import sys

import numpy as np
import pytest
import torch
from filelock import FileLock

from snark_setup_tpu.phase1.keys import PublicKey as JPublicKey
from snark_setup_tpu.phase1.parameters import Phase1Parameters as JParams
from snark_setup_tpu.phase1.protocol import Phase1 as JPhase1
from snark_setup_tpu.phase1.protocol import _batched_subgroup_sums as j_sums
from snark_setup_tpu.phase1.protocol import _check_subgroup_device as j_check_subgroup
from snark_setup_tpu.phase1.testing import setup_verify as j_setup_verify
from snark_setup_tpu.serialize import arkworks as jark
from snark_setup_tpu.utils import enums as je
from snark_setup_tpu_torch.cli import phase1_main
from snark_setup_tpu_torch.curves.host import INFINITY, g1_curve
from snark_setup_tpu_torch.ops import convert
from snark_setup_tpu_torch.ops.codec import batch_codec
from snark_setup_tpu_torch.ops.convert import pointvec_to_reference
from snark_setup_tpu_torch.phase1.buffers import split
from snark_setup_tpu_torch.phase1.keys import PublicKey as TPublicKey
from snark_setup_tpu_torch.phase1.parameters import Phase1Parameters as TParams
from snark_setup_tpu_torch.phase1.protocol import Phase1 as TPhase1
from snark_setup_tpu_torch.phase1.protocol import _batched_subgroup_sums as t_sums
from snark_setup_tpu_torch.phase1.protocol import _check_subgroup_device as t_check_subgroup
from snark_setup_tpu_torch.phase1.testing import generate_output, setup_verify as t_setup_verify
from snark_setup_tpu_torch.serialize.arkworks import g1_codec
from snark_setup_tpu_torch.utils import enums as te

# The suite runs several pytest workers on one host: PyTorch's intra-op
# thread pool in each would oversubscribe the cores, and its idle threads'
# spinning slows the plain versions' small operators by orders of magnitude.
torch.set_num_threads(1)

POWER, BATCH = 1, 4
CHUNK_POWER = 2  # the chunked CLI test: 7 G1 powers in chunks of 4 and 3
RLC_SEED = 7
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _in_fresh_interpreter(name, *args):
    """`name(*args)` of this module, run in a new Python process set up as
    tests/conftest.py sets up this one; arguments and result pickled."""
    code = (
        "import pickle, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import tests.conftest\n"
        "import tests.test_torch_verify as m\n"
        f"out = m.{name}(*pickle.loads(sys.stdin.buffer.read()))\n"
        "sys.stdout.buffer.write(pickle.dumps(out))\n"
    )
    done = subprocess.run([sys.executable, "-c", code], input=pickle.dumps(args), capture_output=True,
                          cwd=REPO, timeout=1200)
    if done.returncode != 0:
        raise RuntimeError(f"{name} failed (rc {done.returncode}):\n{done.stderr.decode()[-3000:]}")
    return pickle.loads(done.stdout)  # written by this test run


# case -> (curve, proving system, who made the transcript, who made the
# expected new challenge: the JAX verification or the JAX host codec)
CASES = {
    "bls12_377": ("bls12_377", "GROTH16", "jax", "verification"),
    "bls12_377_marlin": ("bls12_377", "MARLIN", "jax", "verification"),
    "bw6_761": ("bw6_761", "GROTH16", "jax", "host codec"),
    "mnt4_753": ("mnt4_753", "GROTH16", "port", "host codec"),
    "bls12_381": ("bls12_381", "GROTH16", "jax", "verification"),
    "mnt6_753": ("mnt6_753", "GROTH16", "port", "host codec"),
}
# the subgroup-check mode each case's verification runs in (AUTO elsewhere)
MODES = {"bw6_761": "BATCHED"}
SECTIONS = ("tau_g1", "tau_g2", "alpha_g1", "beta_g1", "beta_g2")


def _params(case):
    curve, ps, _, _ = CASES[case]
    return (
        JParams.new_full(curve, je.ProvingSystem[ps], POWER, BATCH),
        TParams.new_full(curve, te.ProvingSystem[ps], POWER, BATCH),
    )


def _host_new_challenge(jp, out: bytes) -> bytes:
    """The new challenge as the JAX package's host codec writes it: every
    response point decoded and re-encoded uncompressed (the header stays
    zero: the CLI writes it, not the protocol)."""
    from snark_setup_tpu.phase1.buffers import split as jsplit

    s_out, s_new = jsplit(jp, je.UseCompression.YES), jsplit(jp, je.UseCompression.NO)
    new = bytearray(jp.get_length(je.UseCompression.NO))
    codecs = {"g1": jark.g1_codec(jp.spec), "g2": jark.g2_codec(jp.spec)}
    for name in SECTIONS:
        codec = codecs["g2" if name in ("tau_g2", "beta_g2") else "g1"]
        for i in range(s_out[name].num_elements):
            p = codec.deserialize(bytes(s_out[name].slice_of(out, i, i + 1)), je.UseCompression.YES,
                                  je.CheckForCorrectness.NO)
            s_new[name].slice_of(new, i, i + 1)[:] = codec.serialize(p, je.UseCompression.NO)
    return bytes(new)


def _make_transcripts(curve) -> dict:
    """case -> {input, output, key (serialized public key), digest, new}
    for every case on `curve`; the JAX package's compiles of the first
    case serve the next."""
    made = {}
    for case in (c for c in CASES if CASES[c][0] == curve):
        jp, tp = _params(case)
        _, _, made_by, expected_by = CASES[case]
        if made_by == "jax":
            inp, out, key, _, digest = j_setup_verify(
                je.UseCompression.NO, je.CheckForCorrectness.NO, je.UseCompression.YES, jp
            )
        else:
            inp, out, key, _, digest = t_setup_verify(
                te.UseCompression.NO, te.CheckForCorrectness.NO, te.UseCompression.YES, tp, device="cpu"
            )
        t = {"input": bytes(inp), "output": bytes(out), "key": key.serialize(jp.spec if made_by == "jax" else tp.spec),
             "digest": digest}
        t["new"] = _jax_verify(jp, t) if expected_by == "verification" else _host_new_challenge(jp, out)
        made[case] = t
    return made


@pytest.fixture(scope="session")
def transcripts(tmp_path_factory):
    """case -> {input, output, key, digest, new}, made once per test run
    (in a fresh interpreter where the JAX package computes)."""
    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    cache = {}

    def get(case):
        curve = CASES[case][0]
        if curve not in cache:
            path = root / f"torch_verify_{curve}.pkl"
            with FileLock(str(path) + ".lock"):
                if not path.exists():
                    jax_made = any(CASES[c][2] == "jax" for c in CASES if CASES[c][0] == curve)
                    data = _in_fresh_interpreter("_make_transcripts", curve) if jax_made else _make_transcripts(curve)
                    with open(path, "wb") as f:
                        pickle.dump(data, f)
            with open(path, "rb") as f:
                cache[curve] = pickle.load(f)  # written by this test run
        return cache[curve][case]

    return get


def _port_verify(tp, t, output=None, digest=None, mode=te.SubgroupCheckMode.AUTO):
    out = t["output"] if output is None else output
    new = generate_output(tp, te.UseCompression.NO)
    TPhase1.verification(
        t["input"], out, new, TPublicKey.deserialize(tp.spec, t["key"]),
        t["digest"] if digest is None else digest,
        te.UseCompression.NO, te.UseCompression.YES, te.UseCompression.NO,
        te.CheckForCorrectness.NO, te.CheckForCorrectness.FULL, mode, True, tp,
        rlc_rng=random.Random(RLC_SEED), device="cpu",
    )
    return bytes(new)


def _jax_verify(jp, t, output=None, digest=None) -> bytes:
    out = t["output"] if output is None else output
    new = bytearray(jp.get_length(je.UseCompression.NO))
    JPhase1.verification(
        t["input"], out, new, JPublicKey.deserialize(jp.spec, t["key"]),
        t["digest"] if digest is None else digest,
        je.UseCompression.NO, je.UseCompression.YES, je.UseCompression.NO,
        je.CheckForCorrectness.NO, je.CheckForCorrectness.FULL, je.SubgroupCheckMode.AUTO,
        True, jp, rlc_rng=random.Random(RLC_SEED),
    )
    return bytes(new)


@pytest.mark.parametrize("case,mode", [(case, MODES.get(case, "AUTO")) for case in CASES])
def test_verification_accepts_and_writes_reference_challenge(transcripts, case, mode):
    _, tp = _params(case)
    t = transcripts(case)
    new = _port_verify(tp, t, mode=te.SubgroupCheckMode[mode])
    assert new == t["new"]
    if case != "bls12_377":  # the helpers decompress every point again: once is enough
        return
    # the test helpers: the decompressed accumulator holds the response's
    # points, and writing them back gives the new challenge's bytes
    acc = TPhase1.deserialize(new, te.UseCompression.NO, te.CheckForCorrectness.NO, tp, device="cpu")
    assert acc == TPhase1.deserialize(t["output"], te.UseCompression.YES, te.CheckForCorrectness.NO, tp,
                                      device="cpu")
    buf = bytearray(len(new))
    TPhase1.serialize_accumulator(acc, buf, te.UseCompression.NO, tp, device="cpu")
    assert bytes(buf) == new


def _raised(fn):
    try:
        fn()
    except Exception as e:  # the class is what both packages must agree on
        return e
    raise AssertionError("accepted")


def _rejected_input(case, t, kind):
    """The response and digest of a `kind` rejection of transcript `t`."""
    out, digest = bytearray(t["output"]), t["digest"]
    if kind == "wrong_digest":
        digest = bytes(64 - len(b"wrong")) + b"wrong"
    else:
        # the low byte of tau_g1[1]'s x (read by the initial-element checks),
        # flipped by the first mask that leaves no curve point there as the
        # JAX package's host codec decodes it (on MNT6-753 the mask 0x01
        # gives another point of the curve, which the ratio check rejects)
        jp, tp = _params(case)
        sec = split(tp, te.UseCompression.YES)["tau_g1"]
        at = sec.offset + sec.element_size
        for mask in range(1, 256):
            x = bytearray(sec.slice_of(out, 1, 2))
            x[0] ^= mask
            try:
                jark.g1_codec(jp.spec).deserialize(bytes(x), je.UseCompression.YES, je.CheckForCorrectness.NO)
            except Exception:  # the codec's own error: no point with that x
                break
        out[at] ^= mask
    return out, digest


@pytest.mark.parametrize("case", ["bls12_377", "bw6_761", "bls12_381", "mnt6_753"])
@pytest.mark.parametrize("kind", ["wrong_digest", "tampered_byte"])
def test_rejections_raise_the_reference_exception_class(transcripts, case, kind):
    """On a transcript the port made (MNT6-753: the JAX package's verification
    of it is a deep compile beyond the suite's time), against the class the
    JAX package raises for the same rejection on BLS12-377."""
    jcase = "bls12_377" if CASES[case][2] == "port" else case
    jp, _ = _params(jcase)
    _, tp = _params(case)
    ej = _raised(lambda: _jax_verify(jp, transcripts(jcase), *_rejected_input(jcase, transcripts(jcase), kind)))
    et = _raised(lambda: _port_verify(tp, transcripts(case), *_rejected_input(case, transcripts(case), kind)))
    assert type(et).__name__ == type(ej).__name__, (et, ej)
    assert [c.__name__ for c in type(et).__mro__[:-2]] == [c.__name__ for c in type(ej).__mro__[:-2]]


def _out_of_subgroup(spec, hc):
    """The smallest-x point outside the order-r subgroup, order-2 points
    (y = 0, test_order_two_point_rejected) left out."""
    for x in range(1, 2000):
        p = hc.get_point_from_x(spec.fp(x), greatest=False)
        if p is not None and not p.y.is_zero() and not hc.in_subgroup(p):
            return p
    raise AssertionError("no out-of-subgroup point found")


@pytest.mark.parametrize(
    "curve,mode",
    [
        pytest.param("bls12_377", "DIRECT", id="DIRECT"),
        pytest.param("bls12_377", "BATCHED", id="BATCHED"),
        pytest.param("bw6_761", "DIRECT", id="bw6_761-DIRECT"),
        pytest.param("bls12_381", "DIRECT", id="bls12_381-DIRECT"),
        pytest.param("bls12_381", "BATCHED", id="bls12_381-BATCHED"),
    ],
)
def test_out_of_subgroup_point_rejected_like_reference(transcripts, curve, mode):
    """The G1 subgroup check alone (three subgroup points, one outside, two
    infinity padding lanes) in the port, in `mode`, and in the JAX package's
    DIRECT mode (its host check, no deep compile): the endomorphism check
    on BLS12-377, [r]P == O on BW6-761. On BLS12-377 in DIRECT mode also
    the port's whole verification of a response carrying that point."""
    from snark_setup_tpu.curves.host import INFINITY as JINF, g1_curve as jg1
    from snark_setup_tpu.ops.codec_jax import batch_codec as j_batch_codec

    jc, tc = j_batch_codec(curve, "g1"), batch_codec(curve, "g1", "cpu")
    jhc, thc = jg1(jc.spec), g1_curve(tc.spec)
    jbad, tbad = _out_of_subgroup(jc.spec, jhc), _out_of_subgroup(tc.spec, thc)
    jpts = jc.ops.from_affine_host([jhc.mul(jhc.generator, 5 + i) for i in range(3)] + [jbad, JINF, JINF])
    tpts = tc.ops.from_affine_host([thc.mul(thc.generator, 5 + i) for i in range(3)] + [tbad, INFINITY, INFINITY],
                                   "cpu")
    ej = _raised(lambda: j_check_subgroup(jc, jpts, je.SubgroupCheckMode.DIRECT, 4))
    et = _raised(lambda: t_check_subgroup(tc, tpts, te.SubgroupCheckMode[mode], 4))
    assert type(et).__name__ == type(ej).__name__ == "IncorrectSubgroupError"
    # good points pass
    t_check_subgroup(tc, convert.pointvec_from_reference(
        {k: np.asarray(v)[:, [0, 1, 2, 4, 5]] for k, v in jpts.items()}, "cpu"), te.SubgroupCheckMode[mode], 3)
    if (curve, mode) != ("bls12_377", "DIRECT"):  # the whole verification: once is enough on the CPU
        return
    # through the whole verification: tau_g1[2] replaced
    _, tp = _params(curve)
    t = transcripts(curve)
    out = bytearray(t["output"])
    sec = split(tp, te.UseCompression.YES)["tau_g1"]
    sec.slice_of(out, 2, 3)[:] = g1_codec(tp.spec).serialize(tbad, te.UseCompression.YES)
    et = _raised(lambda: _port_verify(tp, t, out, mode=te.SubgroupCheckMode[mode]))
    assert type(et).__name__ == "IncorrectSubgroupError", et


def test_aggregate_verification_agrees(transcripts):
    """Both packages accept the verified new challenge, and both reject it
    with two tau_g1 powers swapped, with the same exception class."""
    jp, tp = _params("bls12_377")
    new = bytearray(transcripts("bls12_377")["new"])
    TPhase1.aggregate_verification(new, te.UseCompression.NO, te.CheckForCorrectness.FULL, tp,
                                   rlc_rng=random.Random(1), device="cpu")
    JPhase1.aggregate_verification(new, je.UseCompression.NO, je.CheckForCorrectness.FULL, jp,
                                   rlc_rng=random.Random(1))
    sec = split(tp, te.UseCompression.NO)["tau_g1"]
    a, b = bytes(sec.slice_of(new, 1, 2)), bytes(sec.slice_of(new, 2, 3))
    sec.slice_of(new, 1, 2)[:], sec.slice_of(new, 2, 3)[:] = b, a
    et = _raised(lambda: TPhase1.aggregate_verification(
        new, te.UseCompression.NO, te.CheckForCorrectness.FULL, tp, device="cpu"))
    ej = _raised(lambda: JPhase1.aggregate_verification(new, je.UseCompression.NO, je.CheckForCorrectness.FULL, jp))
    assert type(et).__name__ == type(ej).__name__ == "InvalidRatioError"


@pytest.mark.parametrize("curve,group", [("bls12_377", "g1"), ("bw6_761", "g2")])
def test_batched_subgroup_sums_equal_reference(curve, group):
    """Same points, same subset bits: the port's rounds-in-lanes reduction
    returns the JAX package's per-round scan sums, projective limb for
    limb."""
    tops = batch_codec(curve, group, "cpu").ops
    hc = tops.host_curve
    rng = np.random.default_rng(13)
    pts = [hc.mul(hc.generator, int(k)) for k in rng.integers(1, 1 << 30, 4)] + [INFINITY]
    bits = rng.integers(0, 2, (64, 5)).astype(bool)
    pv = tops.from_affine_host(pts, "cpu")
    want = _in_fresh_interpreter("_jax_subset_sums", curve, group, pointvec_to_reference(pv), bits)
    got = pointvec_to_reference(t_sums(tops, pv, bits))
    for k in "xyz":
        assert (got[k] == want[k]).all(), k


def _jax_subset_sums(curve, group, planes, bits):
    """The JAX package's `_batched_subgroup_sums` on numpy planes."""
    from snark_setup_tpu.ops.curve_jax import PointVec as JPointVec, curve_ops as jax_curve_ops

    sums = j_sums(jax_curve_ops(curve, group), JPointVec(planes), bits)
    return {k: np.asarray(v) for k, v in sums.items()}


BEACON = "0000000000000000000a558a61ddc8ee4e488d647a747fe4dcc362fe2026c620"


def _cli(workdir, *args, power=POWER):
    old = os.getcwd()
    os.chdir(workdir)
    try:
        return phase1_main.main(["--curve-kind", "bls12_377", "--proving-system", "groth16",
                                 "--device", "cpu", "--batch-size", str(BATCH), "--power", str(power), *args])
    finally:
        os.chdir(old)


def _hash_ok(workdir, name, side=None):
    data = (workdir / name).read_bytes()
    return (workdir / (side or f"{name}.hash")).read_bytes() == hashlib.blake2b(data).digest()


def test_cli_full_chain(tmp_path):
    """new -> contribute -> verify -> beacon -> verify -> ratios."""
    (tmp_path / "seed1").write_text("aa" * 32)
    full = ["--contribution-mode", "full"]
    assert _cli(tmp_path, *full, "new", "--challenge-fname", "challenge",
                "--challenge-hash-fname", "challenge.verified.hash") == 0
    assert _cli(tmp_path, *full, "--seed", "seed1", "contribute", "--challenge-fname", "challenge",
                "--challenge-hash-fname", "challenge.hash", "--response-fname", "response",
                "--response-hash-fname", "response.hash") == 0
    for src, dst in (("challenge", "new_challenge"), ("new_challenge", "new_challenge_2")):
        resp = "response" if src == "challenge" else "new_response"
        if src == "new_challenge":
            assert _cli(tmp_path, *full, "beacon", "--challenge-fname", src, "--challenge-hash-fname",
                        f"{src}.hash", "--response-fname", resp, "--response-hash-fname",
                        f"{resp}.hash", "--beacon-hash", BEACON) == 0
        assert _cli(tmp_path, *full, "verify-and-transform-pok-and-correctness",
                    "--challenge-fname", src, "--challenge-hash-fname", f"{src}.verified.hash",
                    "--response-fname", resp, "--response-hash-fname", f"{resp}.verified.hash",
                    "--new-challenge-fname", dst, "--new-challenge-hash-fname", f"{dst}.verified.hash") == 0
        response = (tmp_path / resp).read_bytes()
        assert response[:64] == hashlib.blake2b((tmp_path / src).read_bytes()).digest()
        assert (tmp_path / dst).read_bytes()[:64] == hashlib.blake2b(response).digest()
        for name, side in ((src, f"{src}.verified.hash"), (resp, f"{resp}.verified.hash"),
                           (dst, f"{dst}.verified.hash")):
            assert _hash_ok(tmp_path, name, side), name
    assert _cli(tmp_path, *full, "verify-and-transform-ratios", "--response-fname", "new_challenge_2") == 0


def test_cli_chunked_combine_split(tmp_path):
    """Two chunks contributed, combined, checked with the ratios command;
    a beacon on the combined accumulator split back into chunks, each
    equal to its slice of the decompressed full response."""
    (tmp_path / "seed1").write_text("aa" * 32)
    chunk = ["--contribution-mode", "chunked", "--chunk-size", "4"]
    responses = []
    for i in range(2):  # 2^3 - 1 = 7 G1 powers: chunks of 4 and 3
        ci = [*chunk, "--chunk-index", str(i)]
        assert _cli(tmp_path, *ci, "new", "--challenge-fname", f"challenge_{i}",
                    "--challenge-hash-fname", f"challenge_{i}.hash", power=CHUNK_POWER) == 0
        assert _cli(tmp_path, *ci, "--seed", "seed1", "contribute", "--challenge-fname", f"challenge_{i}",
                    "--challenge-hash-fname", f"challenge_{i}.hash", "--response-fname", f"response_{i}",
                    "--response-hash-fname", f"response_{i}.hash", power=CHUNK_POWER) == 0
        assert _hash_ok(tmp_path, f"response_{i}")
        responses.append(f"response_{i}")
    (tmp_path / "response_list").write_text("".join(f"{r}\n" for r in responses))
    assert _cli(tmp_path, *chunk, "combine", "--response-list-fname", "response_list",
                "--combined-fname", "combined", power=CHUNK_POWER) == 0
    full = ["--contribution-mode", "full"]
    assert _cli(tmp_path, *full, "verify-and-transform-ratios", "--response-fname", "combined", power=CHUNK_POWER) == 0
    assert _cli(tmp_path, *full, "beacon", "--challenge-fname", "combined", "--challenge-hash-fname",
                "combined.hash", "--response-fname", "response_beacon", "--response-hash-fname",
                "response_beacon.hash", "--beacon-hash", BEACON, power=CHUNK_POWER) == 0
    assert (tmp_path / "response_beacon").read_bytes()[:64] == hashlib.blake2b(
        (tmp_path / "combined").read_bytes()).digest()
    assert _cli(tmp_path, *chunk, "split", "--chunk-fname-prefix", "chunk_split",
                "--full-fname", "response_beacon", power=CHUNK_POWER) == 0
    tp = TParams.new_full("bls12_377", te.ProvingSystem.GROTH16, CHUNK_POWER, BATCH)
    decompressed = bytearray(tp.get_length(te.UseCompression.NO))
    TPhase1.decompress((tmp_path / "response_beacon").read_bytes(), decompressed,
                       te.CheckForCorrectness.FULL, tp, device="cpu")
    s_full = split(tp, te.UseCompression.NO)
    for i in range(2):
        cp = TParams.new_chunk("bls12_377", te.ContributionMode.CHUNKED, i, 4, te.ProvingSystem.GROTH16,
                               CHUNK_POWER, BATCH)
        part = (tmp_path / f"chunk_split_{i}").read_bytes()
        s_chunk = split(cp, te.UseCompression.NO)
        for name in SECTIONS:
            sc = s_chunk[name]
            if sc.num_elements == 0:
                continue
            lo = 0 if name == "beta_g2" else 4 * i
            assert bytes(sc.slice_of(part)) == bytes(s_full[name].slice_of(decompressed, lo, lo + sc.num_elements)), (i, name)


def test_marlin_aggregate_verification_agrees(transcripts):
    """The Marlin branch of aggregate_verification (the degree-bound host
    ratio checks beside the RLC power pairs): both packages accept the
    verified Marlin new challenge and reject it with its two tau_g1 powers
    (power 1: G1 and tau G1) swapped, with the same exception class and
    message."""
    jp, tp = _params("bls12_377_marlin")
    new = bytearray(transcripts("bls12_377_marlin")["new"])
    TPhase1.aggregate_verification(new, te.UseCompression.NO, te.CheckForCorrectness.FULL, tp,
                                   rlc_rng=random.Random(1), device="cpu")
    JPhase1.aggregate_verification(new, je.UseCompression.NO, je.CheckForCorrectness.FULL, jp,
                                   rlc_rng=random.Random(1))
    sec = split(tp, te.UseCompression.NO)["tau_g1"]
    assert sec.num_elements == 2
    a, b = bytes(sec.slice_of(new, 0, 1)), bytes(sec.slice_of(new, 1, 2))
    sec.slice_of(new, 0, 1)[:], sec.slice_of(new, 1, 2)[:] = b, a
    et = _raised(lambda: TPhase1.aggregate_verification(
        new, te.UseCompression.NO, te.CheckForCorrectness.FULL, tp, device="cpu"))
    ej = _raised(lambda: JPhase1.aggregate_verification(new, je.UseCompression.NO, je.CheckForCorrectness.FULL, jp))
    assert type(et).__name__ == "InvalidRatioError"
    assert (type(et).__name__, str(et)) == (type(ej).__name__, str(ej))


@pytest.mark.parametrize("mode", ["DIRECT", "BATCHED"])
def test_order_two_point_rejected(mode):
    """BW6-761 G1 holds the point (1, 0) of order 2. The complete formulas
    meet their exceptional case on it ((0 : 0 : 0), which has Z = 0), so a
    device check that reads Z = 0 as infinity accepts it — as the JAX
    package's device path does (ROADMAP Queue C). The port rejects it in
    both modes, as the JAX package's host check does."""
    from snark_setup_tpu.curves.host import g1_curve as jg1
    from snark_setup_tpu.ops.codec_jax import batch_codec as j_batch_codec

    jc, tc = j_batch_codec("bw6_761", "g1"), batch_codec("bw6_761", "g1", "cpu")
    thc, jhc = g1_curve(tc.spec), jg1(jc.spec)
    t2 = thc.get_point_from_x(tc.spec.fp(1), greatest=False)
    assert t2.y.v == 0 and not thc.in_subgroup(t2)
    good = [thc.mul(thc.generator, 5 + i) for i in range(3)]
    tpts = tc.ops.from_affine_host(good + [t2, INFINITY], "cpu")
    et = _raised(lambda: t_check_subgroup(tc, tpts, te.SubgroupCheckMode[mode], 4))
    jpts = jc.ops.from_affine_host([jhc.mul(jhc.generator, 5 + i) for i in range(3)]
                                   + [jhc.get_point_from_x(jc.spec.fp(1), greatest=False)])
    ej = _raised(lambda: j_check_subgroup(jc, jpts, je.SubgroupCheckMode.DIRECT, 4))
    assert type(et).__name__ == type(ej).__name__ == "IncorrectSubgroupError"
    # the subgroup points alone pass
    t_check_subgroup(tc, tc.ops.from_affine_host(good + [INFINITY], "cpu"), te.SubgroupCheckMode[mode], 3)
