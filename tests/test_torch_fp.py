"""FpOps of the port against the JAX package's fp_ops, for Fq and Fr of both
curves: the same numpy inputs through both, integer results compared for
exact equality (tolerance 0 — modular arithmetic)."""

from functools import partial

import numpy as np
import pytest
import torch

from snark_setup_tpu.curves.constants import get_curve
from snark_setup_tpu.ops.fp_jax import fp_ops as jax_fp_ops
from snark_setup_tpu_torch.ops import convert
from snark_setup_tpu_torch.ops.convert import planes_to_reference
from snark_setup_tpu_torch.ops.fp import fp_ops as torch_fp_ops

# The suite runs several pytest workers on one host: PyTorch's intra-op
# thread pool in each would oversubscribe the cores, and its idle threads'
# spinning slows the plain versions' small operators by orders of magnitude.
torch.set_num_threads(1)

# the tests run on the CPU: every seam constructor is asked for it by name
planes_from_reference = partial(convert.planes_from_reference, device="cpu")

FIELDS = [("bw6_761", "q"), ("bw6_761", "r"), ("bls12_377", "q"), ("bls12_377", "r")]


def _setup(curve, field, seed=0):
    m = getattr(get_curve(curve), field)
    rng = np.random.default_rng(seed)
    vals_a = [0, 1, m - 1, 2, m - 2] + [int.from_bytes(rng.bytes(120), "little") % m for _ in range(5)]
    vals_b = [m - 1, 0, m - 1, 1, 3] + [int.from_bytes(rng.bytes(120), "little") % m for _ in range(5)]
    J, T = jax_fp_ops(m), torch_fp_ops(m)
    a, b = J.from_int(vals_a), J.from_int(vals_b)
    return m, J, T, vals_a, vals_b, a, b


@pytest.mark.parametrize("curve,field", FIELDS)
@pytest.mark.parametrize("op", ["mont_mul", "add", "sub"])
def test_binary_ops_equal_reference(curve, field, op):
    m, J, T, va, vb, a, b = _setup(curve, field, 1)
    want = np.asarray(getattr(J, op)(a, b))
    got = getattr(T, op)(planes_from_reference(a), planes_from_reference(b))
    assert got.dtype == torch.int32
    assert (planes_to_reference(got) == want).all()
    host = {"mont_mul": lambda x, y: x * y, "add": lambda x, y: x + y, "sub": lambda x, y: x - y}[op]
    assert T.to_int(got) == [host(x, y) % m for x, y in zip(va, vb)]


@pytest.mark.parametrize("curve,field", FIELDS)
@pytest.mark.parametrize("op", ["neg", "mont_sqr", "from_mont", "to_mont_raw", "double_el"])
def test_unary_ops_equal_reference(curve, field, op):
    m, J, T, va, vb, a, b = _setup(curve, field, 2)
    want = np.asarray(getattr(J, op)(a))
    got = getattr(T, op)(planes_from_reference(a))
    assert (planes_to_reference(got) == want).all()


@pytest.mark.parametrize("curve,field", FIELDS)
def test_host_conversions_and_constants_equal_reference(curve, field):
    m, J, T, va, vb, a, b = _setup(curve, field, 3)
    assert (T.from_int(va) == a).all()
    assert T.to_int(planes_from_reference(a)) == J.to_int(a) == va
    assert (T.from_int(va[3]) == J.from_int(va[3])).all()
    for k in (0, 1, 3, 8, 12):
        got = T.mul_small(planes_from_reference(a), k)
        assert T.to_int(got) == [v * k % m for v in va]
    ta, tb = planes_from_reference(a), planes_from_reference(b)
    assert T.is_zero(ta).tolist() == [v == 0 for v in va]
    assert T.eq(ta, tb).tolist() == [x == y for x, y in zip(va, vb)]
    sel = T.select(T.is_zero(ta), tb, ta)
    assert T.to_int(sel) == [y if x == 0 else x for x, y in zip(va, vb)]


@pytest.mark.parametrize("curve,field", FIELDS)
def test_inv_and_batch_inv_equal_host(curve, field):
    """Inverses are unique and every result is canonical, so equality with
    the host's pow(v, -1, m) is equality with the reference's inv/batch_inv
    limb for limb (its scans cost ~20 s of CPU compile per field to rerun)."""
    m, J, T, va, vb, a, b = _setup(curve, field, 4)
    want = [pow(v, -1, m) if v else 0 for v in va]
    ta = planes_from_reference(a)
    assert T.to_int(T.batch_inv(ta)) == want
    assert T.to_int(T.inv(ta[:, :4])) == want[:4]
    # odd widths exercise the tree's padding
    for n in (1, 3, 7):
        assert T.to_int(T.batch_inv(ta[:, 1 : 1 + n])) == want[1 : 1 + n]


@pytest.mark.parametrize("curve,field", FIELDS)
def test_column_space_products_reduce_to_reference(curve, field):
    """school_cols/redc_cols keep their contract: the columns represent the
    integer product, and a sum of two products reduces under one REDC."""
    m, J, T, va, vb, a, b = _setup(curve, field, 6)
    ta, tb = planes_from_reference(a), planes_from_reference(b)
    cols = T.school_cols(ta, tb)
    assert cols.shape[0] == 2 * T.L and cols.dtype == torch.int64
    R = T.spec.mont_r
    for i in range(len(va)):
        value = sum(int(c) << (16 * k) for k, c in enumerate(cols[:, i].tolist()))
        assert value == (va[i] * R % m) * (vb[i] * R % m)
    two = T.redc_cols(cols + T.school_cols(tb, ta), 2)
    assert T.to_int(two) == [2 * x * y % m for x, y in zip(va, vb)]
