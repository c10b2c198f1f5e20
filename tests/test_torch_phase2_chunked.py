"""The port's streaming phase 2 (`phase2/chunked.py`) on the CPU against the
JAX package's: in-place contributions, streaming verifications and their
rejections under both compressions, and the end-to-end chunked flow of
tests/test_phase2_chunked.py (a contribution per chunk, `combine`, the
streaming verify, a proof from the combined parameters).

Both packages get the same MPCParameters bytes: the port's `new` /
`new_chunked` from the shared phase-1 transcript (BLS12-377, TestCircuit,
domain 8), which tests/test_torch_phase2.py holds to the JAX package's. The
JAX side runs once per test run in a fresh interpreter
(tests/torch_phase2_reference.py: `jax_chunked_reference`); the port runs its
plain versions on CPU tensors, in batches of CHUNKED_BATCH = 4. Bytes and
hashes: exact equality (tolerance 0)."""

import random

import pytest
import torch
import torch_phase2_reference as R

from snark_setup_tpu_torch.curves.constants import get_curve
from snark_setup_tpu_torch.curves.host import g1_curve
from snark_setup_tpu_torch.phase1.buffers import split
from snark_setup_tpu_torch.phase1.parameters import Phase1Parameters
from snark_setup_tpu_torch.phase2 import chunked, groth16
from snark_setup_tpu_torch.phase2.keypair import Phase2PublicKey
from snark_setup_tpu_torch.phase2.lagrange import Groth16Params
from snark_setup_tpu_torch.phase2.load_circuit import Matrices
from snark_setup_tpu_torch.phase2.parameters import MPCParameters, ProvingKey
from snark_setup_tpu_torch.phase2.r1cs import TestCircuit, circuit_to_qap
from snark_setup_tpu_torch.phase2.vecio import Cursor
from snark_setup_tpu_torch.serialize.arkworks import g1_codec, g2_codec
from snark_setup_tpu_torch.transcript.hashing import derive_rng_from_seed
from snark_setup_tpu_torch.utils.enums import CheckForCorrectness, ProvingSystem, UseCompression

# The suite runs several pytest workers on one host: PyTorch's intra-op
# thread pool in each would oversubscribe the cores, and its idle threads'
# spinning slows the plain versions' small operators by orders of magnitude.
torch.set_num_threads(1)

NO, YES = UseCompression.NO, UseCompression.YES
FULL = CheckForCorrectness.FULL
SPEC = get_curve(R.CURVE)
CPU = "cpu"
COMPRESSIONS = ["NO", "YES"]


def _gp() -> Groth16Params:
    params = Phase1Parameters.new_full(R.CURVE, ProvingSystem.GROTH16, R.POWER, 8)
    transcript = R.phase1_transcript()
    sec = split(params, NO)

    def section(name, codec):
        return [codec.deserialize(bytes(sec[name].slice_of(transcript, i, i + 1)), NO, CheckForCorrectness.NO)
                for i in range(sec[name].num_elements)]

    c1, c2 = g1_codec(SPEC), g2_codec(SPEC)
    return Groth16Params.new(R.CURVE, R.PHASE2_SIZE, section("tau_g1", c1), section("tau_g2", c2),
                             section("alpha_g1", c1), section("beta_g1", c1), section("beta_g2", c2)[0],
                             device=CPU)


def _matrices() -> Matrices:
    return Matrices.from_constraint_system(SPEC, circuit_to_qap(TestCircuit(), SPEC.r))


def _inputs() -> dict:
    gp, mats = _gp(), _matrices()
    mpc = MPCParameters.new(mats, gp, CPU)
    full, query, chunks = MPCParameters.new_chunked(mats, gp, R.E2E_CHUNK, CPU)
    return {"mpc": {"NO": mpc.write(NO, CPU), "YES": mpc.write(YES, CPU)}, "full": full.write(NO, CPU),
            "query": query.write(SPEC, NO, CPU), "chunks": [c.write(NO, CPU) for c in chunks]}


@pytest.fixture(scope="session")
def ref(tmp_path_factory):
    return R.chunked_reference(tmp_path_factory, _inputs)


@pytest.fixture(scope="module")
def contributed(ref):
    """The port's two in-place contributions per compression: (hashes,
    buffers)."""
    out = {}
    for name in COMPRESSIONS:
        comp, prev, hashes, bufs = UseCompression[name], ref["inputs"]["mpc"][name], [], []
        for seed in R.CHUNKED_SEEDS:
            buf = bytearray(prev) + bytes(Phase2PublicKey.size(SPEC))
            hashes.append(chunked.contribute(SPEC, buf, derive_rng_from_seed(seed), R.CHUNKED_BATCH, comp, FULL,
                                             device=CPU))
            bufs.append(bytes(buf))
            prev = bytes(buf)
        out[name] = (hashes, bufs)
    return out


@pytest.mark.parametrize("name", COMPRESSIONS)
def test_chunked_contribute_equals_reference(ref, contributed, name):
    """In-place bytes and hashes equal the JAX package's, and the port's
    object API (read, contribute, write) gives the same bytes."""
    jax = ref["jax"][name]
    hashes, bufs = contributed[name]
    assert hashes == jax["hashes"]
    assert bufs == jax["contributed"]
    comp = UseCompression[name]
    obj = MPCParameters.read(SPEC, ref["inputs"]["mpc"][name], comp, device=CPU)
    assert obj.contribute(derive_rng_from_seed(R.CHUNKED_SEEDS[0]), CPU) == hashes[0]
    assert obj.write(comp, CPU) == bufs[0]


@pytest.mark.parametrize("name", COMPRESSIONS)
def test_chunked_verify_hashes_equal_reference(ref, contributed, name):
    base = ref["inputs"]["mpc"][name]
    c1, c2 = contributed[name][1]
    got = [chunked.verify(SPEC, b, a, R.CHUNKED_BATCH, UseCompression[name], FULL, rlc_rng=random.Random(21 + i),
                          device=CPU)
           for i, (b, a) in enumerate(((base, c1), (c1, c2), (base, c2)))]
    assert got == ref["jax"][name]["verify"]
    assert got[2] == contributed[name][0]


def _case(ref, contributed, name, case):
    comp = UseCompression[name]
    base, c1 = ref["inputs"]["mpc"][name], contributed[name][1][0]
    if case == "only_non_zero_verify":
        return lambda: chunked.verify(SPEC, base, c1, R.CHUNKED_BATCH, comp, CheckForCorrectness.ONLY_NON_ZERO,
                                      device=CPU)
    if case == "only_non_zero_contribute":
        return lambda: chunked.contribute(SPEC, bytearray(base) + bytes(Phase2PublicKey.size(SPEC)),
                                          derive_rng_from_seed(R.CHUNKED_SEEDS[0]), R.CHUNKED_BATCH, comp,
                                          CheckForCorrectness.ONLY_NON_ZERO, device=CPU)
    cases = R.tampered(lambda d, c: chunked._layout(SPEC, d, c), g1_codec(SPEC).serialize, g1_curve(SPEC), base,
                       c1, comp)
    before, after = cases[case]
    return lambda: chunked.verify(SPEC, before, after, R.CHUNKED_BATCH, comp, FULL, rlc_rng=random.Random(24),
                                  device=CPU)


@pytest.mark.parametrize("case", R.REJECTIONS)
@pytest.mark.parametrize("name", COMPRESSIONS)
def test_chunked_rejections_equal_reference(ref, contributed, name, case):
    """The same error class and message as the JAX package's, in its order
    of checks: a changed a point (BrokenInvariantError, A_QUERY), a changed L
    point (the L ratio check), a short L vector (InvalidLengthError), no
    contribution (NoContributionsError), ONLY_NON_ZERO (SerializationError)."""
    want = ref["jax"][name]["rejections"][case]
    assert want is not None
    assert R._raised(_case(ref, contributed, name, case)) == want


def test_chunked_slicing_changes_no_byte(ref, contributed, monkeypatch):
    """A launch bound of 3 lanes under the caller's batch of 4: the same
    bytes."""
    monkeypatch.setattr(chunked, "MAX_LANES", 3)
    assert chunked._batches(7, 4) == [(0, 3), (3, 6), (6, 7)]
    buf = bytearray(ref["inputs"]["mpc"]["NO"]) + bytes(Phase2PublicKey.size(SPEC))
    h = chunked.contribute(SPEC, buf, derive_rng_from_seed(R.CHUNKED_SEEDS[0]), R.CHUNKED_BATCH, NO, FULL,
                           device=CPU)
    assert (h, bytes(buf)) == (contributed["NO"][0][0], contributed["NO"][1][0])


def test_chunked_end_to_end_proof(ref):
    """tests/test_phase2_chunked.py:101 on the port: one contribution per
    chunk, combine, the streaming verify of the combined parameters (bytes
    and hashes equal the JAX package's), then a proof of 5^2 = 25."""
    inputs, jax = ref["inputs"], ref["jax"]["e2e"]
    mpcs = [MPCParameters.read(SPEC, c, NO, device=CPU) for c in inputs["chunks"]]
    for m in mpcs:
        m.contribute(derive_rng_from_seed(R.E2E_SEED), CPU)
    assert [m.write(NO, CPU) for m in mpcs] == jax["chunks"]
    query = ProvingKey.read(SPEC, Cursor(inputs["query"]), NO, CheckForCorrectness.NO, device=CPU)
    combined = MPCParameters.combine(SPEC, query, mpcs)
    assert combined.write(YES, CPU) == jax["combined"]
    full = MPCParameters.read(SPEC, inputs["full"], NO, device=CPU).write(YES, CPU)
    hashes = chunked.verify(SPEC, full, jax["combined"], 3, YES, FULL, rlc_rng=random.Random(50), device=CPU)
    assert hashes == jax["verify"]
    pk = combined.params
    proof = groth16.prove(SPEC, pk, TestCircuit(5), derive_rng_from_seed(b"prover-chunked"), device=CPU)
    assert groth16.verify(SPEC, pk.vk, proof, [25])
    assert not groth16.verify(SPEC, pk.vk, proof, [26])


def test_chunked_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chunked.contribute(SPEC, bytearray(), derive_rng_from_seed(R.E2E_SEED), 4, NO, FULL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chunked.verify(SPEC, b"", b"", 4, NO, FULL)
