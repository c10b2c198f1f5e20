"""The port's portable phase-2 contributor (`portable/contributor.py`, a
copy of the JAX package's: pure host Python) against the JAX package's and
against the port's own MPCParameters.contribute.

The challenge is the port's MPCParameters from the shared phase-1
transcript (BLS12-377, TestCircuit, domain 8), written uncompressed. The
JAX package's contributor is pure Python too, so both run here without a
compile. `_main` runs in a subprocess where `torch` and `jax` cannot be
imported. Bytes and hashes: exact equality (tolerance 0)."""

import random
import subprocess
import sys

import pytest
import torch
import torch_phase2_reference as R

from snark_setup_tpu.portable import contribute_challenge as jax_contribute_challenge
from snark_setup_tpu_torch.curves.constants import get_curve
from snark_setup_tpu_torch.phase1.buffers import split
from snark_setup_tpu_torch.phase1.parameters import Phase1Parameters
from snark_setup_tpu_torch.phase2.lagrange import Groth16Params
from snark_setup_tpu_torch.phase2.load_circuit import Matrices
from snark_setup_tpu_torch.phase2.parameters import MPCParameters
from snark_setup_tpu_torch.phase2.r1cs import TestCircuit, circuit_to_qap
from snark_setup_tpu_torch.portable import contribute_challenge
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
SEEDS = {"equal": b"portable-seed-2" + b"\0" * 17, "main": b"portable-seed-1" + b"\0" * 17}


@pytest.fixture(scope="module")
def ceremony() -> MPCParameters:
    params = Phase1Parameters.new_full(R.CURVE, ProvingSystem.GROTH16, R.POWER, 8)
    transcript = R.phase1_transcript()
    sec = split(params, NO)

    def section(name, codec):
        return [codec.deserialize(bytes(sec[name].slice_of(transcript, i, i + 1)), NO, CheckForCorrectness.NO)
                for i in range(sec[name].num_elements)]

    c1, c2 = g1_codec(SPEC), g2_codec(SPEC)
    gp = Groth16Params.new(R.CURVE, R.PHASE2_SIZE, section("tau_g1", c1), section("tau_g2", c2),
                           section("alpha_g1", c1), section("beta_g1", c1), section("beta_g2", c2)[0], device=CPU)
    matrices = Matrices.from_constraint_system(SPEC, circuit_to_qap(TestCircuit(), SPEC.r))
    return MPCParameters.new(matrices, gp, CPU)


def test_portable_equals_jax_package_and_device_contribute(ceremony):
    """The same seed through the port's portable contributor, the JAX
    package's and the port's MPCParameters.contribute: one response, one
    hash."""
    challenge = ceremony.write(NO, CPU)
    seed = SEEDS["equal"]
    resp, h = contribute_challenge(challenge, "inner", seed=seed)
    assert (resp, h) == jax_contribute_challenge(challenge, "inner", seed=seed)
    dev = ceremony.clone()
    assert dev.contribute(derive_rng_from_seed(seed), CPU) == h
    assert dev.write(YES, CPU) == resp


def test_portable_main_runs_without_torch_and_jax(ceremony, tmp_path):
    """`_main` in a subprocess where importing torch or jax raises; the
    response verifies with the port's MPCParameters.verify on the CPU and
    its last hash is the one printed."""
    challenge, response, seed_file = tmp_path / "challenge", tmp_path / "response", tmp_path / "seed"
    challenge.write_bytes(ceremony.write(NO, CPU))
    seed_file.write_text(SEEDS["main"].hex())
    code = (
        "import sys\n"
        f"sys.path.insert(0, {R.REPO!r})\n"
        "sys.modules['torch'] = None  # any torch import now raises\n"
        "sys.modules['jax'] = None\n"
        "from snark_setup_tpu_torch.portable.contributor import _main\n"
        f"rc = _main([{str(challenge)!r}, {str(response)!r}, '--curve', 'inner', '--seed-file', {str(seed_file)!r}])\n"
        "assert sys.modules['torch'] is None and sys.modules['jax'] is None\n"
        "assert not [m for m in sys.modules if m.startswith(('torch.', 'jax.', 'snark_setup_tpu.'))]\n"
        "sys.exit(rc)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    contrib_hash = bytes.fromhex(proc.stdout.strip())
    assert contrib_hash == jax_contribute_challenge(challenge.read_bytes(), "inner", seed=SEEDS["main"])[1]
    after = MPCParameters.read(SPEC, response.read_bytes(), YES, CheckForCorrectness.FULL, device=CPU)
    hashes = ceremony.verify(after, rlc_rng=random.Random(31), device=CPU)
    assert hashes[-1] == contrib_hash
