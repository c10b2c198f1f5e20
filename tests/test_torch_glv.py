"""`glv_digits_plain` (the plain PyTorch version beside the digits kernel)
against the JAX package's digits kernel run in interpret mode, and against
the exact integer model `decompose_host`. Exact equality (tolerance 0)."""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snark_setup_tpu.fields.limb import ints_to_limbs_batch
from snark_setup_tpu.ops.curve_jax import curve_ops as jax_curve_ops
from snark_setup_tpu.ops.pallas_glv import PallasGLVDigits
from snark_setup_tpu_torch.ops import convert
from snark_setup_tpu_torch.ops.convert import planes_to_reference
from snark_setup_tpu_torch.ops.cuda_glv import GLVDigits, glv_digits_for, glv_digits_plain
from snark_setup_tpu_torch.ops.curve import curve_ops as torch_curve_ops

# The suite runs several pytest workers on one host: PyTorch's intra-op
# thread pool in each would oversubscribe the cores, and its idle threads'
# spinning slows the plain versions' small operators by orders of magnitude.
torch.set_num_threads(1)

# the tests run on the CPU: every seam constructor is asked for it by name
planes_from_reference = partial(convert.planes_from_reference, device="cpu")

GROUPS = [("bls12_377", "g1"), ("bw6_761", "g1"), ("bw6_761", "g2"), ("bls12_381", "g1"), ("bls12_381", "g2")]


def _scalars(ops, B, seed):
    rng = np.random.default_rng(seed)
    ks = [int.from_bytes(rng.bytes(64), "little") % ops.spec.r for _ in range(B)]
    ks[:5] = 0, 1, ops.spec.r - 1, ops.glv.p.lam, ops.spec.r - ops.glv.p.lam
    return ks, np.ascontiguousarray(ints_to_limbs_batch(ks, ops.fr.L).T)


@pytest.mark.parametrize("curve,group", GROUPS)
def test_plain_digits_equal_reference_kernel_interpreted(curve, group):
    jops, tops = jax_curve_ops(curve, group), torch_curve_ops(curve, group)
    ks, sc = _scalars(jops, 8, 11)
    e1, e2, eneg, eflip = PallasGLVDigits(jops)(jnp.asarray(sc), interpret=True)
    d1, d2, neg, flip = glv_digits_plain(tops, planes_from_reference(sc))
    assert d1.dtype == d2.dtype == neg.dtype == flip.dtype == torch.int32
    assert (planes_to_reference(d1) == np.asarray(e1)).all()
    assert (planes_to_reference(d2) == np.asarray(e2)).all()
    assert (planes_to_reference(neg) == np.asarray(eneg)).all()
    assert (planes_to_reference(flip) == np.asarray(eflip)).all()


@pytest.mark.parametrize("curve,group", GROUPS)
def test_plain_digits_equal_host_model(curve, group):
    tops = torch_curve_ops(curve, group)
    ks, sc = _scalars(tops, 12, 12)
    wrapper = glv_digits_for(curve, group)
    before = (wrapper.launches, wrapper.plain_calls)
    d1, d2, neg, flip = wrapper(planes_from_reference(sc))  # CPU tensor -> plain version
    assert (wrapper.launches, wrapper.plain_calls) == (before[0], before[1] + 1)
    nwin = wrapper.nwin
    assert d1.shape == d2.shape == (nwin, len(ks))
    for i, k in enumerate(ks):
        k1, k2 = tops.glv.decompose_host(k)
        v1 = sum(int(d) << (4 * (nwin - 1 - j)) for j, d in enumerate(d1[:, i].tolist()))
        v2 = sum(int(d) << (4 * (nwin - 1 - j)) for j, d in enumerate(d2[:, i].tolist()))
        assert (v1, v2) == (abs(k1), abs(k2))
        assert bool(neg[i]) == (k1 < 0) and bool(flip[i]) == ((k1 < 0) != (k2 < 0))
        assert (k1 + k2 * tops.glv.p.lam - k) % tops.spec.r == 0


@pytest.mark.parametrize("curve,group", GROUPS)
def test_decompose_equals_reference_decompose(curve, group):
    jops, tops = jax_curve_ops(curve, group), torch_curve_ops(curve, group)
    ks, sc = _scalars(jops, 6, 13)
    jm1, jn1, jm2, jn2 = jops.glv.decompose(sc)
    tm1, tn1, tm2, tn2 = tops.glv.decompose(planes_from_reference(sc))
    assert (planes_to_reference(tm1) == np.asarray(jm1)).all()
    assert (planes_to_reference(tm2) == np.asarray(jm2)).all()
    assert (tn1.numpy() == np.asarray(jn1)).all() and (tn2.numpy() == np.asarray(jn2)).all()


@pytest.mark.parametrize("curve,group", GROUPS)
def test_kernel_constant_block_layout(curve, group):
    """The constant block handed to the CUDA kernel by value: the limb rows
    and term signs at the offsets of the kernel's DigitsConsts, zero-padded
    to the curve's compile-time geometry."""
    tops = torch_curve_ops(curve, group)
    w = GLVDigits(tops)
    c, g, geo = w._consts_host, tops.glv, w.geometry
    MU, CO = geo["MU"], geo["CO"]
    assert c.dtype == np.uint32 and c.shape == (2 * MU + 4 * CO + 4,)
    assert (geo["LS"], geo["LC"], geo["LT"], geo["LH"], geo["NWIN"]) == (w.Ls, g.Lc, g.LT, g.Lh, w.nwin)
    assert g.S_limbs == w.Ls + g.Lc  # the kernel's Barrett shift
    for m, mu in enumerate(g.mu):
        row = c[MU * m : MU * (m + 1)]
        assert (row[: len(mu)] == mu).all() and not row[len(mu):].any()
    for t, term in enumerate((*g.k1_terms, *g.k2_terms)):
        row, to_neg = c[2 * MU + CO * t : 2 * MU + CO * (t + 1)], c[2 * MU + 4 * CO + t]
        if term is None:
            assert not row.any() and to_neg == 0
        else:
            assert to_neg == (1 if term[0] > 0 else 0)
            assert (row[: len(term[1])] == term[1]).all() and not row[len(term[1]):].any()


def test_wrapper_rejects_wrong_operands():
    w = glv_digits_for("bls12_377", "g1")
    with pytest.raises(ValueError):
        w(torch.zeros((w.Ls, 4), dtype=torch.int64))
    with pytest.raises(ValueError):
        w(torch.zeros((w.Ls + 1, 4), dtype=torch.int32))
