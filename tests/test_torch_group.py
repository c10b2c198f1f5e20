"""Kernel K2's plain version — the port's `CurveOps.add / double` on CPU
tensors of the Fq, a = 0 groups — against the JAX package's fused group-op
Pallas kernels (`PallasGroupOps`, interpret mode), projective X, Y, Z limb
for limb; and `eq_projective` / `sum_reduce` against the JAX `CurveOps`.
Modular arithmetic: exact equality (tolerance 0)."""

from functools import partial

import jax
import numpy as np
import pytest
import torch

from snark_setup_tpu.curves.host import INFINITY as JINF
from snark_setup_tpu.ops.curve_jax import PointVec as JPointVec, curve_ops as jax_curve_ops
from snark_setup_tpu.ops.pallas_group import group_ops_for as jax_group_ops_for
from snark_setup_tpu_torch.ops import convert
from snark_setup_tpu_torch.ops.convert import pointvec_to_reference
from snark_setup_tpu_torch.ops.cuda_group import GroupOps, group_ops_for
from snark_setup_tpu_torch.ops.curve import PointVec, curve_ops as torch_curve_ops

# The suite runs several pytest workers on one host: PyTorch's intra-op
# thread pool in each would oversubscribe the cores, and its idle threads'
# spinning slows the plain versions' small operators by orders of magnitude.
torch.set_num_threads(1)

pointvec_from_reference = partial(convert.pointvec_from_reference, device="cpu")

GROUPS = [("bls12_377", "g1"), ("bw6_761", "g1"), ("bw6_761", "g2")]


def _edge_batches(hc, seed):
    """P, Q host point lists with the complete-formula edge cases of
    tests/test_pallas_group.py: O + Q, P + O, P + P, P + (-P)."""
    rng = np.random.default_rng(seed)
    a = [hc.mul(hc.generator, int(k)) for k in rng.integers(1, 1 << 30, 4)]
    b = [hc.mul(hc.generator, int(k)) for k in rng.integers(1, 1 << 30, 4)]
    a += [JINF, a[0], a[1], a[2]]
    b += [b[0], JINF, a[1], hc.neg(a[2])]
    return a, b


def _equal(got: PointVec, want) -> bool:
    g = pointvec_to_reference(got)
    return all((g[k] == np.asarray(want[k])).all() for k in "xyz")


@pytest.mark.parametrize("curve,group", GROUPS)
def test_double_equals_pallas_group_kernel(curve, group):
    jops, tops = jax_curve_ops(curve, group), torch_curve_ops(curve, group)
    kern = jax_group_ops_for(curve, group)
    a, _ = _edge_batches(jops.host_curve, 3)
    pv = jops.from_affine_host(a)
    k2 = group_ops_for(curve, group)
    n0 = k2.dbl.plain_calls
    got = tops.double(pointvec_from_reference(pv))
    assert k2.dbl.plain_calls == n0 + 1  # CPU tensors take the plain version
    want = kern.double(pv, interpret=True)
    assert _equal(got, want)
    # projective (Z != 1) input: double again
    assert _equal(tops.double(got), kern.double(JPointVec(want), interpret=True))


@pytest.mark.parametrize("curve,group", GROUPS)
def test_add_equals_pallas_group_kernel(curve, group):
    jops, tops = jax_curve_ops(curve, group), torch_curve_ops(curve, group)
    kern = jax_group_ops_for(curve, group)
    a, b = _edge_batches(jops.host_curve, 4)
    pv, qv = jops.from_affine_host(a), jops.from_affine_host(b)
    tp, tq = pointvec_from_reference(pv), pointvec_from_reference(qv)
    assert _equal(tops.add(tp, tq), kern.add(pv, qv, interpret=True))
    # Z != 1 on both sides, then a batch-1 second operand (broadcast)
    pv2, qv2 = kern.double(pv, interpret=True), kern.double(qv, interpret=True)
    tp2, tq2 = tops.double(tp), tops.double(tq)
    assert _equal(tops.add(tp2, tq2), kern.add(JPointVec(pv2), JPointVec(qv2), interpret=True))
    q1 = JPointVec({k: np.asarray(v)[:, 3:4] for k, v in qv2.items()})
    t1 = PointVec({k: v[:, 3:4] for k, v in tq2.items()})
    assert _equal(tops.add(tp2, t1), kern.add(JPointVec(pv2), q1, interpret=True))


@pytest.mark.parametrize("curve,group", [("bls12_377", "g2"), ("mnt4_753", "g1"), ("mnt6_753", "g2")])
def test_group_kernel_scope(curve, group):
    """Outside Fq coordinates with a = 0 the wrapper refuses (the
    reference asserts) and CurveOps keeps the stacked law."""
    ops = torch_curve_ops(curve, group)
    assert not ops.use_group_kernel and ops._group_kernel() is None
    with pytest.raises(NotImplementedError):
        GroupOps(ops)


@pytest.mark.parametrize("curve,group", GROUPS)
def test_eq_projective_and_sum_reduce_equal_reference(curve, group):
    jops, tops = jax_curve_ops(curve, group), torch_curve_ops(curve, group)
    hc = jops.host_curve
    rng = np.random.default_rng(9)
    pts = [hc.mul(hc.generator, int(k)) for k in rng.integers(1, 1 << 30, 6)] + [JINF]
    pv = dict(jops.from_affine_host(pts))  # odd batch of 7, infinity included
    tp = pointvec_from_reference(pv)
    # the reference side jitted: one compile instead of one per operation
    j_sum = jax.jit(lambda p: dict(jops.sum_reduce(JPointVec(p))))
    j_twin = jax.jit(lambda p: dict(jops.add(jops.double(JPointVec(p)), jops.neg(JPointVec(p)))))
    j_eq = jax.jit(lambda p, q: jops.eq_projective(JPointVec(p), JPointVec(q)))
    # sum_reduce: projective limb for limb, odd tail included
    want = j_sum(pv)
    got = tops.sum_reduce(tp)
    assert _equal(got, want)
    assert repr(tops.to_affine_host(got)[0]) == repr(jops.to_affine_host(JPointVec(want))[0])
    # eq_projective: each point against its doubled-and-subtracted twin
    # (another Z), against its neighbour, infinity against infinity
    tp2, jp2 = tops.add(tops.double(tp), tops.neg(tp)), j_twin(pv)
    assert _equal(tp2, jp2)
    shift = PointVec({k: torch.roll(v, 1, dims=-1) for k, v in tp.items()})
    jshift = {k: np.roll(np.asarray(v), 1, axis=-1) for k, v in pv.items()}
    assert tops.eq_projective(tp, tp2).tolist() == np.asarray(j_eq(pv, jp2)).tolist() == [True] * 7
    mixed = tops.eq_projective(tp, shift).tolist()
    assert mixed == np.asarray(j_eq(pv, jshift)).tolist() == [False] * 7
