"""The port's phase 2 on the CPU against the JAX package: prepare_phase2
(Groth16Params, prepare_transcript_device), QAP evaluation, MPCParameters
new / new_chunked / contribute / verify / combine, the constant-time MSM,
and a Groth16 proof from the port's parameters.

Both packages get the same phase-1 transcript (host arithmetic, power 4: a
domain of 8 for TestCircuit's 6 constraints), on each curve of `CURVES`:
BLS12-377, BLS12-381, MNT4-753 and MNT6-753 (a != 0: every scalar
multiplication of the group FFT, the QAP and the contributions is the
windowed ladder; G2 over Fp2 / Fp3; the host pairings over Fp4 / Fp6). The
JAX package's outputs are made once per test run and curve in a fresh
interpreter (tests/torch_phase2_reference.py); the port runs its plain
versions on CPU tensors. The lane slicing, the parallel circuit and the
constant-time MSM stay on BLS12-377. Modular arithmetic and bytes: exact
equality (tolerance 0)."""

import pickle
import random

import pytest
import torch
import torch_phase2_reference as R
from filelock import FileLock

from snark_setup_tpu_torch.curves.constants import get_curve
from snark_setup_tpu_torch.curves.host import INFINITY, g1_curve, g2_curve
from snark_setup_tpu_torch.curves.pairing import pairing_engine
from snark_setup_tpu_torch.fields.limb import ints_to_limbs_batch
from snark_setup_tpu_torch.ntt.domain import Radix2Domain
from snark_setup_tpu_torch.ops import lanes
from snark_setup_tpu_torch.ops.curve import curve_ops
from snark_setup_tpu_torch.ops.msm import msm_secret
from snark_setup_tpu_torch.phase1.buffers import split
from snark_setup_tpu_torch.phase1.parameters import Phase1Parameters
from snark_setup_tpu_torch.phase2 import groth16
from snark_setup_tpu_torch.phase2.keypair import Keypair
from snark_setup_tpu_torch.phase2.lagrange import Groth16Params, prepare_transcript_device
from snark_setup_tpu_torch.phase2.load_circuit import Matrices
from snark_setup_tpu_torch.phase2.parameters import MPCParameters
from snark_setup_tpu_torch.phase2.polynomial import dot_product_vec, eval_qap, process_matrix
from snark_setup_tpu_torch.phase2.r1cs import TestCircuit, TestParallelCircuit, circuit_to_qap
from snark_setup_tpu_torch.serialize.arkworks import g1_codec, g2_codec
from snark_setup_tpu_torch.transcript.hashing import derive_rng_from_seed
from snark_setup_tpu_torch.utils.enums import CheckForCorrectness, ProvingSystem, UseCompression

# The suite runs several pytest workers on one host: PyTorch's intra-op
# thread pool in each would oversubscribe the cores, and its idle threads'
# spinning slows the plain versions' small operators by orders of magnitude.
torch.set_num_threads(1)

NO, YES = UseCompression.NO, UseCompression.YES
CPU = "cpu"
CURVES = [R.CURVE, "bls12_381", "mnt4_753", "mnt6_753"]
# The JAX package's phase 2 takes more than 300 s of XLA:CPU compiles on
# these curves on an 8-core host (ROADMAP Queue C: a hazard of the reference,
# not a fault of the port), so the port is held to the host oracle there:
# Python-int Lagrange values, host dot products, h and L = delta^-1 times
# the previous values, the delta ratio by host pairing and the hash lists.
ORACLE_CURVES = {"bls12_381", "mnt4_753", "mnt6_753"}
ON_REFERENCE_CURVE = pytest.mark.parametrize("curve", [R.CURVE], indirect=True)


def _ser(spec, group, pts) -> list[bytes]:
    codec = g1_codec(spec) if group == "g1" else g2_codec(spec)
    return [codec.serialize(p, NO) for p in pts]


def _matrices(spec, circuit) -> Matrices:
    return Matrices.from_constraint_system(spec, circuit_to_qap(circuit, spec.r))


@pytest.fixture(scope="module", params=CURVES)
def curve(request):
    return request.param


@pytest.fixture(scope="module")
def spec(curve):
    return get_curve(curve)


@pytest.fixture(scope="module")
def ref(tmp_path_factory, curve):
    """{"transcript", "jax"}: "jax" is None on the oracle's curves."""
    return R.reference(tmp_path_factory, curve, with_jax=curve not in ORACLE_CURVES)


def _host_gp(curve, spec) -> Groth16Params:
    """The Groth16Params of R.phase1_transcript in Python ints: coefficient
    j of each vector is L_j(tau) times its base (L_j the Lagrange basis of
    the domain), h_g1[i] = (tau^(i+m) - tau^i) G1."""
    r = spec.r
    xs = Radix2Domain(curve, R.PHASE2_SIZE).elements()
    m = len(xs)
    lag = []
    for j, xj in enumerate(xs):
        num = den = 1
        for k, xk in enumerate(xs):
            if k != j:
                num, den = num * (R.TAU - xk) % r, den * (xj - xk) % r
        lag.append(num * pow(den, -1, r) % r)
    c1, c2 = g1_curve(spec), g2_curve(spec)
    mul1 = lambda k: c1.mul(c1.generator, k % r)
    return Groth16Params(spec, mul1(R.ALPHA), mul1(R.BETA), c2.mul(c2.generator, R.BETA), [mul1(x) for x in lag],
                         [c2.mul(c2.generator, x) for x in lag], [mul1(R.ALPHA * x) for x in lag],
                         [mul1(R.BETA * x) for x in lag],
                         [mul1(pow(R.TAU, i + m, r) - pow(R.TAU, i, r)) for i in range(m - 1)])


def _host_rows(hc, pts, rows):
    """sum coeff * pts[j] over each row's (coeff, j), on the host."""
    out = []
    for row in rows:
        acc = INFINITY
        for coeff, j in row:
            acc = hc.add(acc, hc.mul(pts[j], coeff))
        out.append(acc)
    return out


def _host_contribution(spec, before: MPCParameters, seed: bytes) -> tuple[MPCParameters, bytes]:
    """`before` after one contribution from `seed`'s rng, on the host: the
    keypair contribute derives, h and L times delta^-1, delta_g1 and
    delta_g2 times delta, the public key appended; and its hash."""
    kp = Keypair.new(spec, derive_rng_from_seed(seed), before.params.delta_g1, before.cs_hash, before.contributions)
    delta = kp.private_key.delta
    c1, c2 = g1_curve(spec), g2_curve(spec)
    after = before.clone()
    inv = pow(delta, -1, spec.r)
    after.params.h_query = [c1.mul(p, inv) for p in before.params.h_query]
    after.params.l_query = [c1.mul(p, inv) for p in before.params.l_query]
    after.params.delta_g1 = c1.mul(before.params.delta_g1, delta)
    after.params.vk.delta_g2 = c2.mul(before.params.vk.delta_g2, delta)
    after.contributions.append(kp.public_key)
    return after, kp.public_key.hash(spec)


# the JAX package's verify rejections on BLS12-377, BLS12-381 and MNT6-753
# (its outputs on those curves): the oracle's curves are held to them
REJECTIONS = {"verify_self": ("NoContributionsError", "There were no contributions found"),
              "verify_tampered": ("BrokenInvariantError", "broken invariant: DeltaG1")}


@pytest.fixture(scope="module")
def params(curve):
    return Phase1Parameters.new_full(curve, ProvingSystem.GROTH16, R.POWER, 8)


def _once(tmp_path_factory, name, make):
    """make(), computed once per test run by the first pytest worker that
    needs it, under a file lock in the directory the workers share, and
    read by the others: on the MNT curves one port phase-2 step takes
    minutes on the CPU."""
    path = R.shared_dir(tmp_path_factory) / f"torch_phase2_port_{name}.pkl"
    with FileLock(str(path) + ".lock"):
        if not path.exists():
            with open(path, "wb") as f:
                pickle.dump(make(), f)
    with open(path, "rb") as f:
        return pickle.load(f)  # written by this test run


@pytest.fixture(scope="module")
def gp(tmp_path_factory, ref, params, curve, spec):
    """The port's Groth16Params from the shared transcript."""
    return _once(tmp_path_factory, f"gp_{curve}", lambda: _port_gp(ref, params, curve, spec))


def _port_gp(ref, params, curve, spec):
    sec = split(params, NO)

    def section(name, codec):
        return [codec.deserialize(bytes(sec[name].slice_of(ref["transcript"], i, i + 1)), NO,
                                  CheckForCorrectness.NO) for i in range(sec[name].num_elements)]

    c1, c2 = g1_codec(spec), g2_codec(spec)
    return Groth16Params.new(curve, R.PHASE2_SIZE, section("tau_g1", c1), section("tau_g2", c2),
                             section("alpha_g1", c1), section("beta_g1", c1), section("beta_g2", c2)[0],
                             device=CPU)


@pytest.fixture(scope="module")
def mpc(tmp_path_factory, gp, curve, spec):
    return _once(tmp_path_factory, f"mpc_{curve}",
                 lambda: MPCParameters.new(_matrices(spec, TestCircuit()), gp, device=CPU))


@pytest.fixture(scope="module")
def contributed(tmp_path_factory, mpc, curve):
    return _once(tmp_path_factory, f"contributed_{curve}", lambda: _contribute_twice(mpc))


def _contribute_twice(mpc):
    c1 = mpc.clone()
    h1 = c1.contribute(derive_rng_from_seed(R.CONTRIBUTION_SEEDS[0]), device=CPU)
    c2 = c1.clone()
    h2 = c2.contribute(derive_rng_from_seed(R.CONTRIBUTION_SEEDS[1]), device=CPU)
    return c1, c2, [h1, h2]


def test_groth16_params_write_equals_reference(ref, gp, curve, spec):
    if ref["jax"] is None:
        assert gp == _host_gp(curve, spec)
        assert Groth16Params.read(curve, gp.write(NO, CPU), NO, CheckForCorrectness.NO, 8, device=CPU) == gp
        return
    assert gp.write(NO, CPU) == ref["jax"]["params_write"]
    back = Groth16Params.read(curve, ref["jax"]["params_write"], NO, CheckForCorrectness.NO, 8, device=CPU)
    assert back == gp


def test_prepare_transcript_device_equals_reference(ref, params, curve, spec):
    got = prepare_transcript_device(curve, R.PHASE2_SIZE, ref["transcript"], params, device=CPU)
    if ref["jax"] is None:  # the oracle's parameters, written by the port's codec
        assert got == _host_gp(curve, spec).write(NO, CPU)
        return
    assert got == ref["jax"]["prepare"]
    assert got == ref["jax"]["params_write"]  # and Groth16Params.new(...).write()


@ON_REFERENCE_CURVE
def test_slicing_lanes_changes_no_byte(ref, params, monkeypatch):
    """Reads, transforms, h-query and writes in slices of 3 lanes."""
    monkeypatch.setattr(lanes, "MAX_LANES", 3)
    assert lanes.spans(7) == [(0, 3), (3, 6), (6, 7)]
    got = prepare_transcript_device(R.CURVE, R.PHASE2_SIZE, ref["transcript"], params, device=CPU)
    assert got == ref["jax"]["prepare"]


def test_eval_qap_equals_reference(ref, gp, curve, spec):
    mats = _matrices(spec, TestCircuit())
    nv = mats.num_instance_variables + mats.num_witness_variables
    at, bt, ct = (process_matrix(x, nv) for x in (mats.a, mats.b, mats.c))
    got = eval_qap(curve, gp.coeffs_g1, gp.coeffs_g2, gp.alpha_coeffs_g1, gp.beta_coeffs_g1, at, bt, ct,
                   mats.num_instance_variables, device=CPU)
    if ref["jax"] is None:
        hc1, hc2 = g1_curve(spec), g2_curve(spec)
        ext = [hc1.add(hc1.add(a, b), c) for a, b, c in zip(_host_rows(hc1, gp.beta_coeffs_g1, at),
                                                            _host_rows(hc1, gp.alpha_coeffs_g1, bt),
                                                            _host_rows(hc1, gp.coeffs_g1, ct))]
        n = mats.num_instance_variables
        assert list(got) == [_host_rows(hc1, gp.coeffs_g1, at), _host_rows(hc1, gp.coeffs_g1, bt),
                             _host_rows(hc2, gp.coeffs_g2, bt), ext[:n], ext[n:]]
        return
    assert [_ser(spec, g, v) for g, v in zip(("g1", "g1", "g2", "g1", "g1"), got)] == ref["jax"]["eval_qap"]


@ON_REFERENCE_CURVE
def test_dot_product_vec_parallel_circuit(ref, gp, spec):
    """TestParallelCircuit: the A rows in G1 against the JAX package, the B
    rows in G2 and an empty row against the host oracle."""
    mats = _matrices(spec, TestParallelCircuit(R.PARALLEL_K))
    nv = mats.num_instance_variables + mats.num_witness_variables
    g1, g2 = curve_ops(R.CURVE, "g1"), curve_ops(R.CURVE, "g2")
    at = process_matrix(mats.a, nv)
    assert _ser(spec, "g1", dot_product_vec(g1, gp.coeffs_g1, at, CPU)) == ref["jax"]["parallel_a_g1"]
    bt = process_matrix(mats.b, nv) + [[]]
    hc = g2.host_curve
    want = []
    for row in bt:
        acc = INFINITY
        for coeff, j in row:
            acc = hc.add(acc, hc.mul(gp.coeffs_g2[j], coeff))
        want.append(acc)
    assert dot_product_vec(g2, gp.coeffs_g2, bt, CPU) == want
    assert dot_product_vec(g1, gp.coeffs_g1, [[], []], CPU) == [INFINITY, INFINITY]


def test_mpc_new_and_chunked_equal_reference(ref, gp, mpc, spec):
    full, query, chunks = MPCParameters.new_chunked(_matrices(spec, TestCircuit()), gp, R.CHUNK, device=CPU)
    if ref["jax"] is None:  # gamma = delta = 1, h from the transcript, chunks slice h and L
        c1, c2 = g1_curve(spec), g2_curve(spec)
        pk = mpc.params
        assert (pk.delta_g1, pk.vk.delta_g2, pk.vk.gamma_g2) == (c1.generator, c2.generator, c2.generator)
        assert (pk.vk.alpha_g1, pk.beta_g1, pk.vk.beta_g2) == (gp.alpha_g1, gp.beta_g1, gp.beta_g2)
        assert pk.h_query == gp.h_g1 and not mpc.contributions
        assert full == mpc and not query.h_query and not query.l_query
        assert (query.a_query, query.b_g1_query, query.b_g2_query) == (pk.a_query, pk.b_g1_query, pk.b_g2_query)
        assert [c.params.h_query for c in chunks] == [pk.h_query[:R.CHUNK], pk.h_query[R.CHUNK:]]
        assert [c.params.l_query for c in chunks] == [pk.l_query[:R.CHUNK], pk.l_query[R.CHUNK:]]
        assert len(chunks) == 2 and all(c.cs_hash == mpc.cs_hash for c in chunks)
        return
    assert mpc.write(NO, CPU) == ref["jax"]["mpc_new"]
    jfull, jquery, jchunks = ref["jax"]["mpc_chunked"]
    assert full.write(NO, CPU) == jfull
    assert query.write(spec, NO, CPU) == jquery
    assert [c.write(NO, CPU) for c in chunks] == jchunks
    assert len(chunks) == 2


def test_contribute_equals_reference(ref, mpc, contributed, spec):
    c1, c2, hashes = contributed
    if ref["jax"] is None:
        want1, h1 = _host_contribution(spec, mpc, R.CONTRIBUTION_SEEDS[0])
        want2, h2 = _host_contribution(spec, want1, R.CONTRIBUTION_SEEDS[1])
        assert (c1, c2, hashes) == (want1, want2, [h1, h2])
        eng = pairing_engine(spec.name)  # the delta ratio: e(delta_g1, G2) = e(G1, delta_g2)
        eng.check_same_ratio((g1_curve(spec).generator, c2.params.delta_g1),
                             (g2_curve(spec).generator, c2.params.vk.delta_g2), "delta")
        assert MPCParameters.read(spec, c2.write(YES, CPU), YES, CheckForCorrectness.FULL, device=CPU) == c2
        return
    assert hashes == ref["jax"]["contribution_hashes"]
    assert (c1.write(YES, CPU), c2.write(YES, CPU)) == ref["jax"]["contributed"]
    back = MPCParameters.read(spec, ref["jax"]["contributed"][1], YES, CheckForCorrectness.FULL, device=CPU)
    assert back == c2


def test_verify_accepts_contributions(ref, mpc, contributed):
    c1, c2, _ = contributed
    got = (mpc.verify(c1, random.Random(11), CPU), mpc.verify(c2, random.Random(12), CPU),
           c1.verify(c2, random.Random(13), CPU))
    if ref["jax"] is None:  # each verify returns the hashes of the contributions so far
        hashes = contributed[2]
        assert got == ([hashes[0]], hashes, hashes)
        return
    assert got == ref["jax"]["verify_hashes"]


def test_verify_rejects_self_and_tampered(ref, mpc, contributed, spec):
    c1, c2, _ = contributed
    want = REJECTIONS if ref["jax"] is None else ref["jax"]
    assert R._raised(lambda: mpc.verify(mpc, device=CPU)) == want["verify_self"]
    assert want["verify_self"][0] == "NoContributionsError"
    bad = c2.clone()
    bad.params.delta_g1 = g1_curve(spec).mul(bad.params.delta_g1, 2)
    assert R._raised(lambda: c1.verify(bad, random.Random(14), CPU)) == want["verify_tampered"]
    assert want["verify_tampered"] is not None


def test_combine_equals_reference(ref, gp, spec):
    full, query, chunks = MPCParameters.new_chunked(_matrices(spec, TestCircuit()), gp, R.CHUNK, device=CPU)
    for ch in chunks:
        ch.contribute(derive_rng_from_seed(R.CONTRIBUTION_SEEDS[0]), device=CPU)
    combined = MPCParameters.combine(spec, query, chunks)
    if ref["jax"] is None:  # one contribution from one seed: every chunk took the same delta
        want, h = _host_contribution(spec, full, R.CONTRIBUTION_SEEDS[0])
        assert combined == want
        assert full.verify(combined, random.Random(15), CPU) == [h]
        return
    assert combined.write(NO, CPU) == ref["jax"]["combined"]
    assert full.verify(combined, random.Random(15), CPU) == ref["jax"]["combined_verify"]


@pytest.mark.parametrize("curve,group", [("bls12_377", "g1"), ("bls12_377", "g2"), ("bw6_761", "g1")])
def test_msm_secret_equals_host_sum(curve, group):
    ops = curve_ops(curve, group)
    hc = ops.host_curve
    rnd = random.Random(len(curve) + len(group))
    pts = [hc.mul(hc.generator, rnd.randrange(1, ops.spec.r)) for _ in range(4)] + [INFINITY]
    ks = [0, 1, ops.spec.r - 1, rnd.randrange(ops.spec.r), rnd.randrange(ops.spec.r)]
    raw = ints_to_limbs_batch(ks, ops.fr.L).T
    got = ops.to_affine_host(msm_secret(ops, ops.from_affine_host(pts, CPU), raw))
    want = INFINITY
    for p, k in zip(pts, ks):
        want = hc.add(want, hc.mul(p, k))
    assert got == [want]


def test_port_params_prove_and_verify(contributed, spec):
    """The port's twice-contributed parameters prove 5^2 = 25."""
    pk = contributed[1].params
    proof = groth16.prove(spec, pk, TestCircuit(5), derive_rng_from_seed(b"prover"), device=CPU)
    assert groth16.verify(spec, pk.vk, proof, [25])
    assert not groth16.verify(spec, pk.vk, proof, [26])


@ON_REFERENCE_CURVE
def test_phase2_entry_points_raise_without_a_card(gp, params, spec):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves")
    g2 = g2_curve(spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Groth16Params.new(R.CURVE, 7, [g2.generator] * 15, [g2.generator] * 8, [], [], g2.generator)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare_transcript_device(R.CURVE, 7, b"", params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gp.write(NO)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MPCParameters.new(_matrices(spec, TestCircuit()), gp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        groth16.prove(spec, None, TestCircuit(5), derive_rng_from_seed(b"prover"))
