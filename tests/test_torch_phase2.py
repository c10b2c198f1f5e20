"""The port's phase 2 on the CPU against the JAX package: prepare_phase2
(Groth16Params, prepare_transcript_device), QAP evaluation, MPCParameters
new / new_chunked / contribute / verify / combine, the constant-time MSM,
and a Groth16 proof from the port's parameters.

Both packages get the same phase-1 transcript (host arithmetic, BLS12-377,
power 4: a domain of 8 for TestCircuit's 6 constraints). The JAX package's
outputs are made once per test run in a fresh interpreter
(tests/torch_phase2_reference.py); the port runs its plain versions on CPU
tensors. Modular arithmetic and bytes: exact equality (tolerance 0)."""

import random

import pytest
import torch
import torch_phase2_reference as R

from snark_setup_tpu_torch.curves.constants import get_curve
from snark_setup_tpu_torch.curves.host import INFINITY, g1_curve, g2_curve
from snark_setup_tpu_torch.fields.limb import ints_to_limbs_batch
from snark_setup_tpu_torch.ops import lanes
from snark_setup_tpu_torch.ops.curve import curve_ops
from snark_setup_tpu_torch.ops.msm import msm_secret
from snark_setup_tpu_torch.phase1.buffers import split
from snark_setup_tpu_torch.phase1.parameters import Phase1Parameters
from snark_setup_tpu_torch.phase2 import groth16
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
SPEC = get_curve(R.CURVE)
CPU = "cpu"


def _ser(group, pts) -> list[bytes]:
    codec = g1_codec(SPEC) if group == "g1" else g2_codec(SPEC)
    return [codec.serialize(p, NO) for p in pts]


def _matrices(circuit) -> Matrices:
    return Matrices.from_constraint_system(SPEC, circuit_to_qap(circuit, SPEC.r))


@pytest.fixture(scope="session")
def ref(tmp_path_factory):
    return R.reference(tmp_path_factory)


@pytest.fixture(scope="module")
def params():
    return Phase1Parameters.new_full(R.CURVE, ProvingSystem.GROTH16, R.POWER, 8)


@pytest.fixture(scope="module")
def gp(ref, params):
    """The port's Groth16Params from the shared transcript."""
    sec = split(params, NO)

    def section(name, codec):
        return [codec.deserialize(bytes(sec[name].slice_of(ref["transcript"], i, i + 1)), NO,
                                  CheckForCorrectness.NO) for i in range(sec[name].num_elements)]

    c1, c2 = g1_codec(SPEC), g2_codec(SPEC)
    return Groth16Params.new(R.CURVE, R.PHASE2_SIZE, section("tau_g1", c1), section("tau_g2", c2),
                             section("alpha_g1", c1), section("beta_g1", c1), section("beta_g2", c2)[0],
                             device=CPU)


@pytest.fixture(scope="module")
def mpc(gp):
    return MPCParameters.new(_matrices(TestCircuit()), gp, device=CPU)


@pytest.fixture(scope="module")
def contributed(mpc):
    c1 = mpc.clone()
    h1 = c1.contribute(derive_rng_from_seed(R.CONTRIBUTION_SEEDS[0]), device=CPU)
    c2 = c1.clone()
    h2 = c2.contribute(derive_rng_from_seed(R.CONTRIBUTION_SEEDS[1]), device=CPU)
    return c1, c2, [h1, h2]


def test_groth16_params_write_equals_reference(ref, gp):
    assert gp.write(NO, CPU) == ref["jax"]["params_write"]
    back = Groth16Params.read(R.CURVE, ref["jax"]["params_write"], NO, CheckForCorrectness.NO, 8, device=CPU)
    assert back == gp


def test_prepare_transcript_device_equals_reference(ref, params):
    got = prepare_transcript_device(R.CURVE, R.PHASE2_SIZE, ref["transcript"], params, device=CPU)
    assert got == ref["jax"]["prepare"]
    assert got == ref["jax"]["params_write"]  # and Groth16Params.new(...).write()


def test_slicing_lanes_changes_no_byte(ref, params, monkeypatch):
    """Reads, transforms, h-query and writes in slices of 3 lanes."""
    monkeypatch.setattr(lanes, "MAX_LANES", 3)
    assert lanes.spans(7) == [(0, 3), (3, 6), (6, 7)]
    got = prepare_transcript_device(R.CURVE, R.PHASE2_SIZE, ref["transcript"], params, device=CPU)
    assert got == ref["jax"]["prepare"]


def test_eval_qap_equals_reference(ref, gp):
    mats = _matrices(TestCircuit())
    nv = mats.num_instance_variables + mats.num_witness_variables
    at, bt, ct = (process_matrix(x, nv) for x in (mats.a, mats.b, mats.c))
    got = eval_qap(R.CURVE, gp.coeffs_g1, gp.coeffs_g2, gp.alpha_coeffs_g1, gp.beta_coeffs_g1, at, bt, ct,
                   mats.num_instance_variables, device=CPU)
    assert [_ser(g, v) for g, v in zip(("g1", "g1", "g2", "g1", "g1"), got)] == ref["jax"]["eval_qap"]


def test_dot_product_vec_parallel_circuit(ref, gp):
    """TestParallelCircuit: the A rows in G1 against the JAX package, the B
    rows in G2 and an empty row against the host oracle."""
    mats = _matrices(TestParallelCircuit(R.PARALLEL_K))
    nv = mats.num_instance_variables + mats.num_witness_variables
    g1, g2 = curve_ops(R.CURVE, "g1"), curve_ops(R.CURVE, "g2")
    at = process_matrix(mats.a, nv)
    assert _ser("g1", dot_product_vec(g1, gp.coeffs_g1, at, CPU)) == ref["jax"]["parallel_a_g1"]
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


def test_mpc_new_and_chunked_equal_reference(ref, gp, mpc):
    assert mpc.write(NO, CPU) == ref["jax"]["mpc_new"]
    full, query, chunks = MPCParameters.new_chunked(_matrices(TestCircuit()), gp, R.CHUNK, device=CPU)
    jfull, jquery, jchunks = ref["jax"]["mpc_chunked"]
    assert full.write(NO, CPU) == jfull
    assert query.write(SPEC, NO, CPU) == jquery
    assert [c.write(NO, CPU) for c in chunks] == jchunks
    assert len(chunks) == 2


def test_contribute_equals_reference(ref, contributed):
    c1, c2, hashes = contributed
    assert hashes == ref["jax"]["contribution_hashes"]
    assert (c1.write(YES, CPU), c2.write(YES, CPU)) == ref["jax"]["contributed"]
    back = MPCParameters.read(SPEC, ref["jax"]["contributed"][1], YES, CheckForCorrectness.FULL, device=CPU)
    assert back == c2


def test_verify_accepts_contributions(ref, mpc, contributed):
    c1, c2, _ = contributed
    got = (mpc.verify(c1, random.Random(11), CPU), mpc.verify(c2, random.Random(12), CPU),
           c1.verify(c2, random.Random(13), CPU))
    assert got == ref["jax"]["verify_hashes"]


def test_verify_rejects_self_and_tampered(ref, mpc, contributed):
    c1, c2, _ = contributed
    assert R._raised(lambda: mpc.verify(mpc, device=CPU)) == ref["jax"]["verify_self"]
    assert ref["jax"]["verify_self"][0] == "NoContributionsError"
    bad = c2.clone()
    bad.params.delta_g1 = g1_curve(SPEC).mul(bad.params.delta_g1, 2)
    assert R._raised(lambda: c1.verify(bad, random.Random(14), CPU)) == ref["jax"]["verify_tampered"]
    assert ref["jax"]["verify_tampered"] is not None


def test_combine_equals_reference(ref, gp):
    full, query, chunks = MPCParameters.new_chunked(_matrices(TestCircuit()), gp, R.CHUNK, device=CPU)
    for ch in chunks:
        ch.contribute(derive_rng_from_seed(R.CONTRIBUTION_SEEDS[0]), device=CPU)
    combined = MPCParameters.combine(SPEC, query, chunks)
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


def test_port_params_prove_and_verify(contributed):
    """The port's twice-contributed parameters prove 5^2 = 25."""
    pk = contributed[1].params
    proof = groth16.prove(SPEC, pk, TestCircuit(5), derive_rng_from_seed(b"prover"), device=CPU)
    assert groth16.verify(SPEC, pk.vk, proof, [25])
    assert not groth16.verify(SPEC, pk.vk, proof, [26])


def test_phase2_entry_points_raise_without_a_card(gp, params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves")
    g2 = g2_curve(SPEC)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Groth16Params.new(R.CURVE, 7, [g2.generator] * 15, [g2.generator] * 8, [], [], g2.generator)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare_transcript_device(R.CURVE, 7, b"", params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gp.write(NO)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MPCParameters.new(_matrices(TestCircuit()), gp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        groth16.prove(SPEC, None, TestCircuit(5), derive_rng_from_seed(b"prover"))
