"""Testing fixtures mirroring phase1/src/helpers/testing.rs.

`generate_input` builds an initialized accumulator buffer; `setup_verify`
produces one full contribution ready for verification. `host_transcript`
builds a small correct contribution with host arithmetic alone, and
`two_fault_response` spoils one with a deferred fault and a read fault.
"""

from __future__ import annotations

from ..curves.host import INFINITY, g1_curve, g2_curve
from ..serialize.arkworks import g1_codec, g2_codec
from ..transcript.hashing import blank_hash, derive_rng_from_seed
from ..utils.enums import BatchExpMode, CheckForCorrectness, ProvingSystem, UseCompression
from .buffers import split
from .parameters import Phase1Parameters
from .protocol import Phase1


def generate_input(parameters: Phase1Parameters, compressed: UseCompression) -> bytearray:
    buf = bytearray(parameters.get_length(compressed))
    Phase1.initialization(buf, compressed, parameters)
    return buf


def generate_output(parameters: Phase1Parameters, compressed: UseCompression) -> bytearray:
    return bytearray(parameters.get_length(compressed))


def setup_verify(
    compressed_input: UseCompression,
    check_input_correctness: CheckForCorrectness,
    compressed_output: UseCompression,
    parameters: Phase1Parameters,
    seed: bytes = b"setup_verify",
    device=None,
):
    """One seeded contribution, computed on `device` (the card unless
    "cpu"): returns (input, output, pubkey, privkey, challenge_hash)."""
    inp = generate_input(parameters, compressed_input)
    out = generate_output(parameters, compressed_output)
    rng = derive_rng_from_seed(seed)
    digest = blank_hash()
    pubkey, privkey = Phase1.key_generation(parameters.spec, rng, digest)
    Phase1.computation(
        inp,
        out,
        compressed_input,
        compressed_output,
        check_input_correctness,
        BatchExpMode.AUTO,
        privkey,
        parameters,
        device=device,
    )
    return inp, out, pubkey, privkey, digest


def host_transcript(curve: str, power: int, batch: int, compression: UseCompression,
                    seed: bytes = b"host transcript") -> dict:
    """A Groth16 contribution to the initial accumulator, every point a host
    scalar-mul of the generator (tau^i, alpha tau^i, beta tau^i, beta):
    {input (uncompressed), output (`compression`, header left zero), key
    (serialized public key), digest}. No device work: cheap at small
    powers on any host."""
    params = Phase1Parameters.new_full(curve, ProvingSystem.GROTH16, power, batch)
    spec = params.spec
    digest = blank_hash()
    pub, priv = Phase1.key_generation(spec, derive_rng_from_seed(seed), digest)
    groups = {"g1": (g1_curve(spec), g1_codec(spec)), "g2": (g2_curve(spec), g2_codec(spec))}
    coeff = {"tau_g1": 1, "tau_g2": 1, "alpha_g1": priv.alpha, "beta_g1": priv.beta, "beta_g2": priv.beta}
    out = generate_output(params, compression)
    for name, sec in split(params, compression).items():
        hc, codec = groups["g2" if name in ("tau_g2", "beta_g2") else "g1"]
        for i in range(sec.num_elements):
            k = pow(priv.tau, i, spec.r) * coeff[name] % spec.r
            sec.slice_of(out, i, i + 1)[:] = codec.serialize(hc.mul(hc.generator, k), compression)
    return {"input": bytes(generate_input(params, UseCompression.NO)), "output": bytes(out),
            "key": pub.serialize(spec), "digest": digest}


def out_of_subgroup_g1(spec):
    """The smallest-x point of G1's curve outside the order-r subgroup (not
    of order 2)."""
    hc = g1_curve(spec)
    for x in range(1, 2000):
        p = hc.get_point_from_x(spec.fp(x), greatest=False)
        if p is not None and not p.y.is_zero() and not hc.in_subgroup(p):
            return p
    raise AssertionError("no out-of-subgroup point found")


def two_fault_response(kind: str, curve: str = "bls12_377", power: int = 2, batch: int = 4) -> dict:
    """`host_transcript` with two faults in one batch (index 2, past the
    elements the initial checks read; power 2 and batch 4 put indices 0-3
    of every section in the first batch). For `verification` (a compressed
    response): tau_g1[2] outside the subgroup, found by the deferred
    subgroup check of the first section, and tau_g2[2] at infinity, found by
    the read of the next. For `aggregate_verification` (an uncompressed
    accumulator): tau_g1[2] and tau_g1[3] swapped, found by the deferred
    ratio check, and tau_g2[2] at infinity. A verification that checks each
    section before it reads the next raises the first fault's error; the
    reference's pipeline raises the read's, PointAtInfinityError."""
    comp = UseCompression.YES if kind == "verification" else UseCompression.NO
    t = host_transcript(curve, power, batch, comp)
    params = Phase1Parameters.new_full(curve, ProvingSystem.GROTH16, power, batch)
    sec = split(params, comp)
    out = bytearray(t["output"])
    tau_g1 = sec["tau_g1"]
    if kind == "verification":
        tau_g1.slice_of(out, 2, 3)[:] = g1_codec(params.spec).serialize(out_of_subgroup_g1(params.spec), comp)
    elif kind == "aggregate_verification":
        a, b = bytes(tau_g1.slice_of(out, 2, 3)), bytes(tau_g1.slice_of(out, 3, 4))
        tau_g1.slice_of(out, 2, 3)[:], tau_g1.slice_of(out, 3, 4)[:] = b, a
    else:
        raise ValueError(f"unknown two-fault kind {kind!r}")
    sec["tau_g2"].slice_of(out, 2, 3)[:] = g2_codec(params.spec).serialize(INFINITY, comp)
    t["output"] = bytes(out)
    return t
