"""The phase-2 device paths on the card against their plain versions: the
group FFT (K3 + K4 on Fq coordinates, K3 + the ladder over the group law on
BLS12-377 G2; K2 or K5 rounds for the adds), the h-query, the QAP row sums
and the constant-time MSM, each equal limb for limb (tolerance 0) to the same
call with every kernel replaced by its plain PyTorch version on the same
CUDA tensors, and the transforms also to the host scalar oracle.

These tests need an NVIDIA GPU and nvcc: they are marked `gpu`, decide inside
the test whether a card is present, and skip without one. Run them on the
machine with the card:

    python -m pytest tests/test_torch_phase2_gpu.py -q -m gpu
"""

import copy
import random

import pytest
import torch

from snark_setup_tpu_torch.curves.host import INFINITY
from snark_setup_tpu_torch.fields.limb import ints_to_limbs_batch
from snark_setup_tpu_torch.ntt import GroupFFT, Radix2Domain, h_query_device
from snark_setup_tpu_torch.ops.cuda_glv import glv_digits_for, glv_digits_plain
from snark_setup_tpu_torch.ops.cuda_ladder import glv_ladder_plain
from snark_setup_tpu_torch.ops.curve import PointVec, curve_ops, plain_group_law
from snark_setup_tpu_torch.ops.msm import msm_secret
from snark_setup_tpu_torch.phase2.polynomial import dot_product_vec, process_matrix
from snark_setup_tpu_torch.phase2.r1cs import TestCircuit, TestParallelCircuit, circuit_to_qap

GROUPS = [("bw6_761", "g1"), ("bw6_761", "g2"), ("bls12_377", "g2")]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _plain(ops):
    """A copy of `ops` whose group law, products and scalar-mul are the plain
    versions on any device: no kernel launch."""
    plain = copy.copy(plain_group_law(ops))

    def scalar_mul(p, scalars):
        d1, d2, neg1, flip = glv_digits_plain(ops, scalars)
        if ops.field.degree == 1:
            return glv_ladder_plain(ops, p, d1, d2, neg1, flip)
        return plain._glv_ladder(p, d1, d2, neg1.bool(), flip.bool())

    plain.scalar_mul = scalar_mul
    return plain


def _oracle(ops, coeffs, dev) -> PointVec:
    """[c_j] G for every lane, by the card's batch scalar-mul."""
    hc = ops.host_curve
    g = ops.from_affine_host([hc.generator], dev)
    base = PointVec({k: v.expand(*v.shape[:-1], len(coeffs)).contiguous() for k, v in g.items()})
    return ops.scalar_mul(base, ops.fr.tensor(ints_to_limbs_batch(coeffs, ops.fr.L).T, dev))


def _equal(a: PointVec, b: PointVec) -> bool:
    return all(torch.equal(a[k], b[k]) for k in "xyz")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [8, 1 << 12, 1 << 14])
@pytest.mark.parametrize("curve,group", GROUPS)
def test_group_fft_equals_plain_version_on_the_card(curve, group, n):
    dev = _card()
    ops = curve_ops(curve, group)
    dom = Radix2Domain(curve, n)
    rnd = random.Random(n)
    ks = [rnd.randrange(1, ops.spec.r) for _ in range(n)]
    with torch.no_grad():
        pts = _oracle(ops, ks, dev)
        f, fp = GroupFFT(ops, dom), GroupFFT(_plain(ops), dom)
        dig = glv_digits_for(curve, group)
        n_dig = dig.launches
        for direction, scalar in (("ifft", dom.ifft), ("fft", dom.fft)):
            got = getattr(f, direction)(pts)
            torch.cuda.synchronize()
            assert _equal(got, getattr(fp, direction)(pts)), direction
            assert ops.to_affine_host(ops.add(got, ops.neg(_oracle(ops, scalar(ks), dev)))) == [INFINITY] * n
        assert dig.launches > n_dig


@pytest.mark.gpu
@pytest.mark.parametrize("curve,group", [("bw6_761", "g1")])
def test_h_query_equals_plain_version_on_the_card(curve, group):
    dev = _card()
    ops = curve_ops(curve, group)
    m = 1 << 12
    rnd = random.Random(3)
    with torch.no_grad():
        pts = _oracle(ops, [rnd.randrange(ops.spec.r) for _ in range(2 * m - 1)], dev)
        assert _equal(h_query_device(ops, pts, m), h_query_device(_plain(ops), pts, m))


@pytest.mark.gpu
@pytest.mark.parametrize("circuit", [TestCircuit(), TestParallelCircuit(300)], ids=["x2", "parallel300"])
@pytest.mark.parametrize("curve,group", GROUPS)
def test_dot_product_vec_equals_plain_version_on_the_card(curve, group, circuit):
    dev = _card()
    ops = curve_ops(curve, group)
    cs = circuit_to_qap(circuit, ops.spec.r)
    a, b, _ = cs.to_matrices()
    nv = cs.num_instance_variables + cs.num_witness_variables
    m = Radix2Domain(curve, max(cs.num_constraints, nv)).size
    rnd = random.Random(9)
    with torch.no_grad():
        coeff_points = ops.to_affine_host(_oracle(ops, [rnd.randrange(1, ops.spec.r) for _ in range(m)], dev))
        for mat in (a, b):
            rows = process_matrix(mat, nv)
            assert dot_product_vec(ops, coeff_points, rows, dev) == dot_product_vec(
                _plain(ops), coeff_points, rows, dev)


@pytest.mark.gpu
@pytest.mark.parametrize("curve,group", GROUPS)
def test_msm_secret_equals_plain_version_on_the_card(curve, group):
    dev = _card()
    ops = curve_ops(curve, group)
    rnd = random.Random(11)
    B = 1000
    ks = [0, 1, ops.spec.r - 1] + [rnd.randrange(ops.spec.r) for _ in range(B - 3)]
    with torch.no_grad():
        pts = _oracle(ops, [rnd.randrange(1, ops.spec.r) for _ in range(B)], dev)
        raw = ints_to_limbs_batch(ks, ops.fr.L).T
        got = msm_secret(ops, pts, raw)
        assert _equal(got, msm_secret(_plain(ops), pts, raw))
