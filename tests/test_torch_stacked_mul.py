"""The stacked-product kernel's plain version (K5, ops/cuda_mul.py) and the
tower products built on it (ops/ext.py) against the JAX package's Pallas
kernel `PallasFieldMul.__call__` in interpret mode, limb for limb. Exact
equality (tolerance 0): these are integers mod N."""

import random

import numpy as np
import pytest
import torch

from snark_setup_tpu.ops import pallas_field
from snark_setup_tpu.ops.curve_jax import curve_ops as jax_curve_ops
from snark_setup_tpu.ops.fp_jax import fp_ops as jax_fp_ops
from snark_setup_tpu.ops.pallas_field import pallas_mul_for
from snark_setup_tpu_torch.curves.constants import get_curve
from snark_setup_tpu_torch.ops.convert import planes_from_reference, planes_to_reference
from snark_setup_tpu_torch.ops.cuda_mul import stacked_mul_for, stacked_mul_plain
from snark_setup_tpu_torch.ops.curve import curve_ops as torch_curve_ops
from snark_setup_tpu_torch.ops.fp import fp_ops

# The suite runs several pytest workers on one host: PyTorch's intra-op
# thread pool in each would oversubscribe the cores, and its idle threads'
# spinning slows the plain versions' small operators by orders of magnitude.
torch.set_num_threads(1)


def _planes(fq, S, B, seed):
    """(L, S, B) numpy Montgomery planes of seeded values; lane 0 holds 0,
    lane 1 the largest value N - 1."""
    rng = random.Random(seed)
    ints = [[rng.randrange(fq.modulus) for _ in range(B)] for _ in range(S)]
    for row in ints:
        row[0], row[1] = 0, fq.modulus - 1
    return np.stack([fq.from_int(row) for row in ints], axis=1)


@pytest.mark.parametrize("curve", ["bls12_377", "bw6_761", "mnt4_753"])
def test_plain_version_equals_reference_kernel(curve):
    q = get_curve(curve).q
    fq = fp_ops(q)
    S, B = 3, 40  # B no multiple of the reference's 256-lane tile
    U, V = _planes(fq, S, B, 31), _planes(fq, S, B, 32)
    weights = ((1, 3, 0), (0, 0, 2))
    want = np.asarray(pallas_mul_for(q)(U, V, weights, interpret=True))
    Ut, Vt = planes_from_reference(U, "cpu"), planes_from_reference(V, "cpu")
    got = stacked_mul_plain(fq, Ut, Vt, weights)
    assert (planes_to_reference(got) == want).all()
    # the wrapper on CPU tensors runs the plain version, also through row
    # maps (rows read in another order, one negated), which equal the plain
    # version on operands gathered and negated with host integers
    K = stacked_mul_for(q)
    before = (K.launches, K.plain_calls)
    assert torch.equal(K(Ut, Vt, weights), got)
    rows = ((2, 0, 1), (1, 2, 0), (0, 1, 0))
    Ub = np.stack([fq.from_int([(-v if neg else v) % q for v in fq.to_int(U[:, r])])
                   for r, neg in zip(rows[0], rows[2])], axis=1)
    want_mapped = stacked_mul_plain(fq, planes_from_reference(Ub, "cpu"),
                                    planes_from_reference(V[:, list(rows[1])], "cpu"), weights)
    assert torch.equal(K(Ut, Vt, weights, rows), want_mapped)
    assert (K.launches, K.plain_calls) == (before[0], before[1] + 2)


@pytest.mark.parametrize("curve", ["bls12_377", "mnt4_753", "mnt6_753"])
def test_tower_mul_stacked_equals_reference_pallas_branch(curve):
    """The composite (curve x tower) flattening of Fp2 / Fp3 products: the
    port's `mul_stacked` against the JAX package's through its Pallas branch
    (interpret mode), for G2's coordinate field."""
    jF = jax_curve_ops(curve, "g2").field
    tF = torch_curve_ops(curve, "g2").field
    # one tower product per output on Fp3 (nine base products), two on Fp2:
    # interpret mode costs seconds per base product at L = 48
    d, B = jF.degree, 3
    S, weights = ((1, ((2,),)) if d == 3 else (2, ((1, 2),)))
    rng = random.Random(7)

    def rand_el():
        return tuple(rng.randrange(jF.fp.modulus) for _ in range(d))

    U = jF.from_coeffs([rand_el() for _ in range(S * B)]).reshape(jF.fp.L, d, S, B)
    V = jF.from_coeffs([rand_el() for _ in range(S * B)]).reshape(jF.fp.L, d, S, B)
    nprod = 3 * jF.prod_nprod

    orig_call, orig_enabled = pallas_field.PallasFieldMul.__call__, pallas_field.pallas_enabled
    pallas_field.PallasFieldMul.__call__ = lambda self, u, v, w, interpret=False: orig_call(
        self, u, v, w, interpret=True)
    pallas_field.pallas_enabled = lambda: True
    try:
        want = np.asarray(jF.mul_stacked(U, V, weights, nprod))
    finally:
        pallas_field.PallasFieldMul.__call__, pallas_field.pallas_enabled = orig_call, orig_enabled
    got = tF.mul_stacked(planes_from_reference(U, "cpu"), planes_from_reference(V, "cpu"), weights, nprod)
    assert got.shape == want.shape
    assert (planes_to_reference(got) == want).all()


def test_wrapper_checks_the_reduction_bound_and_its_operands():
    q = get_curve("bls12_377").q
    fq = fp_ops(q)
    K = stacked_mul_for(q)
    U = planes_from_reference(_planes(fq, 2, 3, 5), "cpu")
    # max_g sum_s W[g, s] * N must stay below R = 2^384 (N ~ 2^377)
    big = (fq.spec.mont_r_pow // q) + 1
    with pytest.raises(ValueError, match="REDC bound"):
        K(U, U, ((big, 0),))
    with pytest.raises(ValueError, match="REDC bound"):
        K(U, U, ((big // 2, big // 2 + 1),))
    K(U, U, ((big - 1, 0),))  # the largest allowed weight passes
    with pytest.raises(ValueError, match="non-negative"):
        K(U, U, ((1, -1),))
    with pytest.raises(ValueError, match="entries"):
        K(U, U, ((1, 0, 0),))
    with pytest.raises(ValueError, match="int32"):
        K(U.to(torch.int64), U, ((1, 0),))
    with pytest.raises(ValueError, match="row map"):
        K(U, U, ((1,),), ((2,), (0,), (0,)))
    # the reference's fp layer agrees on the bound it asserts
    assert jax_fp_ops(q).spec.mont_r_pow == fq.spec.mont_r_pow
