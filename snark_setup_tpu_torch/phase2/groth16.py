"""Groth16 prove/verify against MPC-produced parameters.

Replaces the reference's use of ark-groth16 in its acceptance test
(phase2/tests/mpc.rs:237-266: "params actually prove things"). Proof
generation follows the standard Groth16 equations with the BGM17 key shape
(gamma = 1). The query MSMs run on the chosen device (default: the card)
through `ops/msm.py: msm_secret`; the H-polynomial coefficients are computed
over Fr on the host via the radix-2 domain and its coset (O(m log m) Python
ints; the reference's schoolbook product is O(m^2), test-circuit sizes only).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..curves.constants import CurveSpec
from ..curves.host import AffinePoint, g1_curve, g2_curve
from ..curves.pairing import pairing_engine
from ..fields.limb import ints_to_limbs_batch
from ..ntt.domain import Radix2Domain, fr_generator
from ..ops.curve import curve_ops
from ..ops.msm import msm_secret
from ..utils.device import resolve_device
from .parameters import ProvingKey
from .r1cs import ConstraintSystem, add_input_density_constraints


@dataclass
class Proof:
    a: AffinePoint
    b: AffinePoint  # G2
    c: AffinePoint


def _msm_device(spec: CurveSpec, group: str, pts: list[AffinePoint], scalars: list[int], device) -> AffinePoint:
    """Prove-time MSM over SECRET scalars (witness / h-coefficients).

    Routes through ops.msm.msm_secret — the constant-time GLV ladder — not
    msm_public: Pippenger's host digit recoding and data-dependent bucket
    gather/scatter indices would leak the witness through timing and
    memory-access side channels. No scalar-dependent filtering happens
    here either: zero scalars ride the ladder like any other value (the
    complete formulas yield the identity), so the device work and the
    batch geometry depend only on the public key shape. Bases come from
    verified MPC parameters, hence lie in the prime-order subgroup — the
    GLV contract. (Host-side bigint packing of the scalars remains
    Python-int arithmetic; its data-dependent timing is the residual
    side channel.)"""
    if not pts:
        from ..curves.host import INFINITY

        return INFINITY
    assert len(pts) == len(scalars)
    ops = curve_ops(spec.name, group)
    pv = ops.from_affine_host(pts, device)
    raw = np.ascontiguousarray(
        ints_to_limbs_batch([s % spec.r for s in scalars], ops.fr.L).T
    )
    out = msm_secret(ops, pv, raw)
    return ops.to_affine_host(out)[0]


def _h_coefficients(cs: ConstraintSystem, z: list[int], domain: Radix2Domain) -> list[int]:
    """h(X) = (A(X)·B(X) − C(X)) / (X^m − 1), degree ≤ m−2.

    A(ω^j) = <A_j, z> etc.; A, B and C are interpolated by the domain IFFT
    and evaluated on the coset g·ω^j (g the generator of Fr^*), where
    X^m − 1 is the constant g^m − 1; h's values there are interpolated back.
    O(m log m) host products, where the reference's schoolbook product is
    O(m^2) (hours at the SHA-256 circuit's m = 2^16); the same quotient."""
    r, m = domain.r, domain.size
    a_mat, b_mat, c_mat = cs.to_matrices()

    def evals(mat):
        out = [0] * m
        for j, row in enumerate(mat):
            out[j] = sum(coeff * z[col] for coeff, col in row) % r
        return out

    a_e, b_e, c_e = evals(a_mat), evals(b_mat), evals(c_mat)
    if any((x * y - w) % r for x, y, w in zip(a_e, b_e, c_e)):
        raise AssertionError("A·B−C does not vanish on the domain (bad witness)")

    g = fr_generator(domain.curve_name)

    def scaled(coeffs, step):  # coeffs[i] * step^i
        out, f = [], 1
        for c in coeffs:
            out.append(c * f % r)
            f = f * step % r
        return out

    a_s, b_s, c_s = (domain.fft(scaled(domain.ifft(e), g)) for e in (a_e, b_e, c_e))
    z_inv = pow(pow(g, m, r) - 1, -1, r)
    h = scaled(domain.ifft([(x * y - w) * z_inv % r for x, y, w in zip(a_s, b_s, c_s)]), pow(g, -1, r))
    if h[m - 1]:
        raise AssertionError("A·B−C is not divisible by X^m − 1")
    return h[: m - 1]


def prove(
    spec: CurveSpec,
    pk: ProvingKey,
    circuit,
    rng,
    device=None,
) -> Proof:
    """Standard Groth16 prover over a prove-mode constraint system.

    The circuit object must expose generate_constraints(cs); the synthesized
    system must match the setup-mode one used for the MPC (including the
    input-density constraints appended by circuit_to_qap)."""
    dev = resolve_device(device)
    r = spec.r
    cs = ConstraintSystem(r, setup=False)
    circuit.generate_constraints(cs)
    add_input_density_constraints(cs)
    z = cs.full_assignment()
    m_constraints = cs.num_constraints
    domain = Radix2Domain(spec.name, max(m_constraints, len(z)))

    rr = rng.fr_rand(spec) if hasattr(rng, "fr_rand") else rng.randrange(r)
    ss = rng.fr_rand(spec) if hasattr(rng, "fr_rand") else rng.randrange(r)

    g1c, g2c = g1_curve(spec), g2_curve(spec)
    h_coeffs = _h_coefficients(cs, z, domain)

    def g1_add(*pts):
        acc = pts[0]
        for p in pts[1:]:
            acc = g1c.add(acc, p)
        return acc

    a_z = _msm_device(spec, "g1", pk.a_query, z, dev)
    b1_z = _msm_device(spec, "g1", pk.b_g1_query, z, dev)
    b2_z = _msm_device(spec, "g2", pk.b_g2_query, z, dev)
    h_term = _msm_device(spec, "g1", pk.h_query, h_coeffs, dev)
    l_term = _msm_device(spec, "g1", pk.l_query, z[cs.num_instance_variables :], dev)

    a_g1 = g1_add(pk.vk.alpha_g1, a_z, g1c.mul(pk.delta_g1, rr))
    b_g1 = g1_add(pk.beta_g1, b1_z, g1c.mul(pk.delta_g1, ss))
    b_g2 = g2c.add(g2c.add(pk.vk.beta_g2, b2_z), g2c.mul(pk.vk.delta_g2, ss))

    # C = h + l + s·A + r·B1 − rs·delta
    c_g1 = g1_add(
        h_term,
        l_term,
        g1c.mul(a_g1, ss),
        g1c.mul(b_g1, rr),
        g1c.neg(g1c.mul(pk.delta_g1, rr * ss % r)),
    )
    return Proof(a=a_g1, b=b_g2, c=c_g1)


def verify(spec: CurveSpec, vk, proof: Proof, public_inputs: list[int]) -> bool:
    """e(A,B) == e(alpha,beta) · e(Σ x_i·gamma_abc_i, gamma) · e(C, delta).

    public_inputs excludes the leading constant 1 (ark verify_proof
    convention)."""
    eng = pairing_engine(spec.name)
    g1c = g1_curve(spec)
    assert len(public_inputs) + 1 == len(vk.gamma_abc_g1), "input count mismatch"
    ic = vk.gamma_abc_g1[0]
    for x, base in zip(public_inputs, vk.gamma_abc_g1[1:]):
        ic = g1c.add(ic, g1c.mul(base, x % spec.r))
    return eng.product_is_one(
        [
            (g1c.neg(proof.a), proof.b),
            (vk.alpha_g1, vk.beta_g2),
            (ic, vk.gamma_g2),
            (proof.c, vk.delta_g2),
        ]
    )
