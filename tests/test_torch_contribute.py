"""The slices as a whole: `phase1 contribute` of the port on the CPU.

- Groth16 on BW6-761 and BLS12-381 (power 2, batch 2, uncompressed
  challenge -> compressed response): the port's `Phase1.computation` output
  is byte-identical to the JAX package's for the same challenge and key.
- Marlin on BW6-761: the port's output against the host oracle
  (Python-int curve arithmetic).
- The port's CLI `new` + `contribute` against the port's protocol call.
- The CLI with its default curve, BLS12-377 (G2 over Fp2): the response is
  byte-identical to the JAX package's; a chunk equals the full response
  slice for slice.
- MNT4-753 and MNT6-753 (a != 0, G2 over Fp2 / Fp3; power 1, batch 4):
  every point of every section against the host oracle.
"""

import functools
import hashlib
import os

import pytest
import torch

from snark_setup_tpu.phase1.parameters import Phase1Parameters as JParams
from snark_setup_tpu.phase1.protocol import Phase1 as JPhase1
from snark_setup_tpu.transcript.hashing import derive_rng_from_seed as j_rng
from snark_setup_tpu.utils import enums as je
from snark_setup_tpu_torch.cli import phase1_main
from snark_setup_tpu_torch.curves.host import g1_curve, g2_curve
from snark_setup_tpu_torch.phase1.buffers import split
from snark_setup_tpu_torch.phase1.parameters import Phase1Parameters as TParams
from snark_setup_tpu_torch.phase1.protocol import Phase1 as TPhase1
from snark_setup_tpu_torch.serialize.arkworks import g1_codec, g2_codec
from snark_setup_tpu_torch.transcript.hashing import blank_hash, calculate_hash, derive_rng_from_seed
from snark_setup_tpu_torch.utils import enums as te

# The suite runs several pytest workers on one host: PyTorch's intra-op
# thread pool in each would oversubscribe the cores, and its idle threads'
# spinning slows the plain versions' small operators by orders of magnitude.
torch.set_num_threads(1)

CURVE, POWER, BATCH = "bw6_761", 2, 2
SEED = bytes(range(32))


def _challenge(params):
    ch = bytearray(params.get_length(te.UseCompression.NO))
    ch[:64] = blank_hash()
    TPhase1.initialization(ch, te.UseCompression.NO, params)
    return ch


def _port_contribution(params, challenge):
    digest = calculate_hash(challenge)
    _, key = TPhase1.key_generation(params.spec, derive_rng_from_seed(SEED), digest)
    out = bytearray(params.contribution_size)
    TPhase1.computation(
        challenge, out, te.UseCompression.NO, te.UseCompression.YES,
        te.CheckForCorrectness.NO, te.BatchExpMode.AUTO, key, params, device="cpu",
    )
    return key, out


@functools.lru_cache(maxsize=None)
def _groth16(curve):
    params = TParams.new_full(curve, te.ProvingSystem.GROTH16, POWER, BATCH)
    challenge = _challenge(params)
    key, out = _port_contribution(params, challenge)
    return params, challenge, key, out


@pytest.fixture(scope="module")
def groth16():
    return _groth16(CURVE)


@pytest.mark.parametrize("curve", [CURVE, "bls12_381"])
def test_groth16_response_byte_identical_to_jax_package(curve):
    tp, challenge, key, got = _groth16(curve)
    jp = JParams.new_full(curve, je.ProvingSystem.GROTH16, POWER, BATCH)
    j_challenge = bytearray(jp.get_length(je.UseCompression.NO))
    j_challenge[:64] = blank_hash()
    JPhase1.initialization(j_challenge, je.UseCompression.NO, jp)
    assert challenge == j_challenge

    _, j_key = JPhase1.key_generation(jp.spec, j_rng(SEED), calculate_hash(challenge))
    assert (key.tau, key.alpha, key.beta) == (j_key.tau, j_key.alpha, j_key.beta)
    want = bytearray(jp.contribution_size)
    JPhase1.computation(
        j_challenge, want, je.UseCompression.NO, je.UseCompression.YES,
        je.CheckForCorrectness.NO, je.BatchExpMode.AUTO, j_key, jp,
    )
    assert bytes(got) == bytes(want)
    assert any(got[64:])


def test_chunked_contribution_equals_the_full_one_slice_for_slice(groth16):
    """Chunk 1 of 2-element chunks, same key: every section of the chunk's
    response equals the matching element range of the full response."""
    full_params, _, key, full = groth16
    _check_chunk(CURVE, full_params, key, full)


def _check_chunk(curve, full_params, key, full):
    chunk_size, index = 2, 1
    cp = TParams.new_chunk(curve, te.ContributionMode.CHUNKED, index, chunk_size,
                           te.ProvingSystem.GROTH16, POWER, BATCH)
    challenge = _challenge(cp)
    out = bytearray(cp.contribution_size)
    TPhase1.computation(
        challenge, out, te.UseCompression.NO, te.UseCompression.YES,
        te.CheckForCorrectness.NO, te.BatchExpMode.AUTO, key, cp, device="cpu",
    )
    sec_full = split(full_params, te.UseCompression.YES)
    sec_chunk = split(cp, te.UseCompression.YES)
    lo = index * chunk_size
    for name in ("tau_g1", "tau_g2", "alpha_g1", "beta_g1"):
        n = sec_chunk[name].num_elements
        assert n == chunk_size
        assert bytes(sec_chunk[name].slice_of(out)) == bytes(sec_full[name].slice_of(full, lo, lo + n)), name
    assert bytes(sec_chunk["beta_g2"].slice_of(out)) == bytes(sec_full["beta_g2"].slice_of(full))


@pytest.fixture(scope="module")
def marlin():
    params = TParams.new_full(CURVE, te.ProvingSystem.MARLIN, POWER, BATCH)
    challenge = _challenge(params)
    key, out = _port_contribution(params, challenge)
    return params, challenge, key, out


def test_marlin_response_matches_host_oracle(marlin):
    params, challenge, key, out = marlin
    spec, r = params.spec, params.spec.r
    n = params.total_size_in_log2
    sec = split(params, te.UseCompression.YES)
    c1, c2 = g1_codec(spec), g2_codec(spec)
    G1, G2 = g1_curve(spec), g2_curve(spec)

    def point(codec, name, i):
        return codec.deserialize(bytes(sec[name].slice_of(out, i, i + 1)),
                                 te.UseCompression.YES, te.CheckForCorrectness.NO)

    # tau_g1[i] = tau^i G1
    for i in range(sec["tau_g1"].num_elements):
        assert point(c1, "tau_g1", i) == G1.mul(G1.generator, pow(key.tau, i, r)), i
    # tau_g2 = [1, tau, then the inverse degree-bound powers]
    bounds = [pow(key.tau, params.powers_length - 1 - (1 << i) + 2, r) for i in range(n)]
    want_g2 = [1, key.tau % r] + [pow(b, -1, r) for b in bounds]
    for i, k in enumerate(want_g2):
        assert point(c2, "tau_g2", i) == G2.mul(G2.generator, k), i
    # alpha_g1 = alpha * [1, tau, tau^2, then (f, f tau, f tau^2) per bound]
    want_a = [pow(key.tau, i, r) for i in range(3)]
    for f in bounds:
        want_a += [f, f * key.tau % r, f * pow(key.tau, 2, r) % r]
    for i, k in enumerate(want_a):
        assert point(c1, "alpha_g1", i) == G1.mul(G1.generator, k * key.alpha % r), i


def test_cli_new_and_contribute_equal_protocol_call(marlin, tmp_path):
    params, challenge, key, out = marlin
    seed_file = tmp_path / "seed"
    seed_file.write_text(SEED.hex())
    common = ["--curve-kind", CURVE, "--proving-system", "marlin", "--contribution-mode", "full",
              "--power", str(POWER), "--batch-size", str(BATCH), "--device", "cpu"]
    f = lambda name: str(tmp_path / name)
    assert phase1_main.main([*common, "new", "--challenge-fname", f("challenge"),
                             "--challenge-hash-fname", f("challenge.hash")]) == 0
    with open(f("challenge"), "rb") as fh:
        assert fh.read() == bytes(challenge)
    assert phase1_main.main([*common, "--seed", str(seed_file), "contribute",
                             "--challenge-fname", f("challenge"),
                             "--challenge-hash-fname", f("challenge.hash2"),
                             "--response-fname", f("response"),
                             "--response-hash-fname", f("response.hash")]) == 0
    with open(f("response"), "rb") as fh:
        response = fh.read()
    assert response[:64] == hashlib.blake2b(bytes(challenge), digest_size=64).digest()
    body_end = len(response) - params.public_key_size
    assert response[64:body_end] == bytes(out[64:body_end])
    assert any(response[body_end:])  # the public key follows the accumulator
    with open(f("response.hash"), "rb") as fh:
        side = fh.read()
    assert side == hashlib.blake2b(response, digest_size=64).digest()
    # never overwrite an existing response
    assert phase1_main.main([*common, "--seed", str(seed_file), "contribute",
                             "--challenge-fname", f("challenge"),
                             "--challenge-hash-fname", f("challenge.hash3"),
                             "--response-fname", f("response")]) == 1
    assert os.path.getsize(f("response")) == len(response)


@pytest.fixture(scope="module")
def default_curve_cli(tmp_path_factory):
    """`new` + `contribute` through the port's CLI without --curve-kind
    (BLS12-377), Groth16, power 2, batch 2, on the CPU."""
    tmp = tmp_path_factory.mktemp("default_curve")
    seed_file = tmp / "seed"
    seed_file.write_text(SEED.hex())
    common = ["--proving-system", "groth16", "--contribution-mode", "full",
              "--power", str(POWER), "--batch-size", str(BATCH), "--device", "cpu"]
    f = lambda name: str(tmp / name)
    assert phase1_main.main([*common, "new", "--challenge-fname", f("challenge"),
                             "--challenge-hash-fname", f("challenge.hash")]) == 0
    assert phase1_main.main([*common, "--seed", str(seed_file), "contribute",
                             "--challenge-fname", f("challenge"),
                             "--challenge-hash-fname", f("challenge.hash2"),
                             "--response-fname", f("response"),
                             "--response-hash-fname", f("response.hash")]) == 0
    with open(f("challenge"), "rb") as fh:
        challenge = fh.read()
    with open(f("response"), "rb") as fh:
        response = fh.read()
    params = TParams.new_full("bls12_377", te.ProvingSystem.GROTH16, POWER, BATCH)
    _, key = TPhase1.key_generation(params.spec, derive_rng_from_seed(SEED), calculate_hash(challenge))
    return params, challenge, response, key


def test_default_curve_cli_response_byte_identical_to_jax_package(default_curve_cli):
    params, challenge, response, _ = default_curve_cli
    assert phase1_main.build_parser().parse_args(["new"]).curve_kind == "bls12_377"
    assert response[:64] == hashlib.blake2b(challenge, digest_size=64).digest()
    jp = JParams.new_full("bls12_377", je.ProvingSystem.GROTH16, POWER, BATCH)
    j_pk, j_key = JPhase1.key_generation(jp.spec, j_rng(SEED), calculate_hash(challenge))
    want = bytearray(jp.contribution_size)
    JPhase1.computation(
        challenge, want, je.UseCompression.NO, je.UseCompression.YES,
        je.CheckForCorrectness.NO, je.BatchExpMode.AUTO, j_key, jp,
    )
    j_pk.write(want, je.UseCompression.YES, jp)
    assert len(response) == len(want) and response[64:] == bytes(want[64:])
    sec = split(params, te.UseCompression.YES)
    assert any(sec["tau_g2"].slice_of(response, 1, 2))


def test_default_curve_chunked_contribution_equals_the_full_one_slice_for_slice(default_curve_cli):
    params, _, response, key = default_curve_cli
    _check_chunk("bls12_377", params, key, response)


@pytest.mark.parametrize("curve", ["mnt4_753", "mnt6_753"])
def test_mnt_groth16_response_matches_host_oracle(curve):
    """a != 0 on both groups: every scalar multiplication is the windowed
    ladder over the complete addition (K5 rounds). One batch of 4 holds
    every section at power 1: four ladder calls (batch 2 takes eight, each a
    753-bit ladder of several seconds on the CPU)."""
    params = TParams.new_full(curve, te.ProvingSystem.GROTH16, 1, 4)
    key, out = _port_contribution(params, _challenge(params))
    spec, r = params.spec, params.spec.r
    sec = split(params, te.UseCompression.YES)
    G1, G2 = g1_curve(spec), g2_curve(spec)
    c1, c2 = g1_codec(spec), g2_codec(spec)
    for name, codec, G, coeff in (("tau_g1", c1, G1, 1), ("tau_g2", c2, G2, 1),
                                  ("alpha_g1", c1, G1, key.alpha), ("beta_g1", c1, G1, key.beta)):
        for i in range(sec[name].num_elements):
            got = codec.deserialize(bytes(sec[name].slice_of(out, i, i + 1)),
                                    te.UseCompression.YES, te.CheckForCorrectness.NO)
            assert got == G.mul(G.generator, pow(key.tau, i, r) * coeff % r), (name, i)
    got = c2.deserialize(bytes(sec["beta_g2"].slice_of(out, 0, 1)), te.UseCompression.YES,
                         te.CheckForCorrectness.NO)
    assert got == G2.mul(G2.generator, key.beta)
