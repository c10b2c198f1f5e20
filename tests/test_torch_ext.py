"""The Fp2 / Fp3 towers (ops/ext.py) and the generic group law over them and
over a != 0 (ops/curve.py) against the JAX package, at a batch of 4 with
infinity, doubling and opposite-point inputs: projective X, Y, Z limb for
limb. The MNT ladder against the host oracle. Exact equality throughout."""

import random
from functools import partial

import numpy as np
import pytest
import torch

from snark_setup_tpu.ops.curve_jax import PointVec as JPointVec, curve_ops as jax_curve_ops
from snark_setup_tpu_torch.curves.host import INFINITY
from snark_setup_tpu_torch.fields.limb import ints_to_limbs_batch
from snark_setup_tpu_torch.ops import convert
from snark_setup_tpu_torch.ops.convert import planes_to_reference, pointvec_to_reference
from snark_setup_tpu_torch.ops.curve import curve_ops as torch_curve_ops

# The suite runs several pytest workers on one host: PyTorch's intra-op
# thread pool in each would oversubscribe the cores, and its idle threads'
# spinning slows the plain versions' small operators by orders of magnitude.
torch.set_num_threads(1)

planes_from_reference = partial(convert.planes_from_reference, device="cpu")
pointvec_from_reference = partial(convert.pointvec_from_reference, device="cpu")

B = 4


@pytest.mark.parametrize("curve", ["bls12_377", "mnt4_753", "mnt6_753"])
def test_tower_mul_sqr_inv_equal_reference(curve):
    jF, tF = jax_curve_ops(curve, "g2").field, torch_curve_ops(curve, "g2").field
    d, q = jF.degree, jF.fp.modulus
    rng = random.Random(17)
    a_vals = [tuple(rng.randrange(q) for _ in range(d)) for _ in range(B)]
    b_vals = [tuple(rng.randrange(q) for _ in range(d)) for _ in range(B)]
    a_vals[0] = (0,) * d  # zero: inverts to zero
    b_vals[1] = (1,) + (0,) * (d - 1)  # one
    b_vals[2] = tuple((q - c) % q for c in a_vals[2])  # -a
    a, b = jF.from_coeffs(a_vals), jF.from_coeffs(b_vals)
    ta, tb = planes_from_reference(a), planes_from_reference(b)
    for name, want, got in (
        ("mul", jF.mul(a, b), tF.mul(ta, tb)),
        ("sqr", jF.sqr(a), tF.sqr(ta)),
        ("add", jF.add(a, b), tF.add(ta, tb)),
        ("sub", jF.sub(a, b), tF.sub(ta, tb)),
    ):
        assert (planes_to_reference(got) == np.asarray(want)).all(), name
    # the inverse (a norm, one Fq inversion, d products — the same formula as
    # the reference's) against host arithmetic: a * a^-1 = 1 where a != 0
    inv = tF.inv(ta)
    ones = tF.to_coeffs(tF.mul(ta, inv))
    assert ones == [(0,) * d] + [(1,) + (0,) * (d - 1)] * (B - 1)
    field = torch_curve_ops(curve, "g2").spec.g2_field
    for x, y in zip(a_vals[1:], tF.to_coeffs(inv)[1:]):
        assert field(x) * field(y) == field((1,) + (0,) * (d - 1))


def _points(hc, seed):
    rng = np.random.default_rng(seed)
    P = [hc.mul(hc.generator, int(k)) for k in rng.integers(1, 1 << 30, B)]
    Q = [hc.mul(hc.generator, int(k)) for k in rng.integers(1, 1 << 30, B)]
    P[1] = INFINITY  # O + Q
    Q[2] = P[2]  # P + P
    Q[3] = hc.neg(P[3])  # P + (-P) = O
    return P, Q


@pytest.mark.parametrize(
    "curve,group", [("bls12_377", "g2"), ("mnt4_753", "g1"), ("mnt4_753", "g2"), ("mnt6_753", "g2")]
)
def test_add_double_equal_reference(curve, group):
    """Projective X, Y, Z of add / double equal the JAX package's, on affine
    and on projective (Z != 1) operands; affine results equal the host's."""
    jops, tops = jax_curve_ops(curve, group), torch_curve_ops(curve, group)
    hc = tops.host_curve
    P, Q = _points(hc, 4)
    pv, qv = jops.from_affine_host(P), jops.from_affine_host(Q)
    tp, tq = pointvec_from_reference(pv), pointvec_from_reference(qv)
    for k in "xyz":
        assert (planes_to_reference(tp[k]) == np.asarray(pv[k])).all(), ("from_affine_host", k)
    assert (planes_to_reference(tops.from_affine_host(P, "cpu")["z"]) == np.asarray(pv["z"])).all()

    def same(got, want, what):
        got = pointvec_to_reference(got)
        for k in "xyz":
            assert (got[k] == np.asarray(want[k])).all(), (what, k)

    jp2, jq2 = jops.double(pv), jops.double(qv)
    tp2, tq2 = tops.double(tp), tops.double(tq)
    same(tp2, jp2, "double")
    same(tops.add(tp, tq), jops.add(pv, qv), "add affine")
    same(tops.add(tp2, tq2), jops.add(JPointVec(**jp2), JPointVec(**jq2)), "add projective")
    assert tops.to_affine_host(tops.add(tp2, tq2)) == [hc.add(hc.add(p, p), hc.add(q, q)) for p, q in zip(P, Q)]
    assert tops.is_infinity(tops.add(tp, tq)).tolist() == [False, False, False, True]


@pytest.mark.parametrize("curve,group", [("mnt4_753", "g1"), ("mnt6_753", "g2")])
def test_mnt_scalar_mul_matches_host_oracle(curve, group):
    """The full-width windowed ladder (no GLV on a != 0 curves) over K5's
    plain version, against host_curve.mul, with 0, 1, r - 1 and infinity."""
    tops = torch_curve_ops(curve, group)
    assert tops.glv is None
    hc, r = tops.host_curve, tops.spec.r
    rng = np.random.default_rng(21)
    ks = [0, 1, r - 1, int.from_bytes(rng.bytes(100), "little") % r]
    pts = [hc.mul(hc.generator, 5 + i) for i in range(len(ks))]
    pts[1] = INFINITY
    raw = planes_from_reference(np.ascontiguousarray(ints_to_limbs_batch(ks, tops.fr.L).T))
    out = tops.scalar_mul(tops.from_affine_host(pts, "cpu"), raw)
    assert tops.to_affine_host(out) == [hc.mul(p, k) for p, k in zip(pts, ks)]


def test_bls12_377_g2_scalar_mul_is_the_glv_ladder_over_k5():
    """G2 of BLS12-377: the digits come from K3's plain version and the ladder
    runs over the group law; [k mod r]P against the host."""
    from snark_setup_tpu_torch.ops.cuda_glv import glv_digits_for
    from snark_setup_tpu_torch.ops.cuda_mul import stacked_mul_for

    tops = torch_curve_ops("bls12_377", "g2")
    hc, r = tops.host_curve, tops.spec.r
    ks = [0, 1, r - 1, 0x1234567890ABCDEF1234567890ABCDEF << 100]
    pts = [hc.mul(hc.generator, 3 + i) for i in range(len(ks))]
    pts[2] = INFINITY
    raw = planes_from_reference(np.ascontiguousarray(ints_to_limbs_batch(ks, tops.fr.L).T))
    dig, K = glv_digits_for("bls12_377", "g2"), stacked_mul_for(tops.spec.q)
    before = (dig.plain_calls, K.plain_calls)
    out = tops.scalar_mul(tops.from_affine_host(pts, "cpu"), raw)
    assert dig.plain_calls == before[0] + 1 and K.plain_calls > before[1]
    assert tops.to_affine_host(out) == [hc.mul(p, k % r) for p, k in zip(pts, ks)]
