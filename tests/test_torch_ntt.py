"""The port's group FFT (ntt/group_fft.py) on the CPU: against the host
scalar oracle on BLS12-377 and BW6-761, G1 and G2, at n = 8 and 16 (the
transform of [k_i] G is [c_i] G with c the scalar transform of k over Fr,
by linearity, for the same omega), against the JAX package's GroupFFT and
h_query_device, and against the JAX package's host stage tables. The JAX
package's transforms compile deep XLA:CPU graphs (about a minute each), so
they run once per test run, together, in a fresh interpreter, at n = 8 on
BW6-761 (its BLS12-377 IFFTs at n = 8 are compared through prepare_phase2's
bytes in tests/test_torch_phase2.py). Exact equality (tolerance 0)."""

import pickle
import random

import numpy as np
import pytest
import torch
import torch_phase2_reference as R
from filelock import FileLock

from snark_setup_tpu_torch.ntt import GroupFFT, Radix2Domain, group_fft, h_query_device
from snark_setup_tpu_torch.ops import lanes
from snark_setup_tpu_torch.ops.curve import curve_ops
from snark_setup_tpu_torch.serialize.arkworks import g1_codec, g2_codec
from snark_setup_tpu_torch.utils.enums import UseCompression

# The suite runs several pytest workers on one host: PyTorch's intra-op
# thread pool in each would oversubscribe the cores, and its idle threads'
# spinning slows the plain versions' small operators by orders of magnitude.
torch.set_num_threads(1)

GROUPS = [("bls12_377", "g1"), ("bls12_377", "g2"), ("bw6_761", "g1"), ("bw6_761", "g2")]
# (curve, group, "ifft" / "fft" / "h_query") computed by the JAX package
JAX_CASES = [("bw6_761", "g1", "ifft"), ("bw6_761", "g2", "ifft"), ("bw6_761", "g1", "fft"),
             ("bw6_761", "g1", "h_query")]
N = 8


def _scalars(curve, n, seed) -> list[int]:
    from snark_setup_tpu_torch.curves.constants import get_curve

    rnd = random.Random(seed)
    return [rnd.randrange(get_curve(curve).r) for _ in range(n)]


def _multiples(ops, ks):
    hc = ops.host_curve
    return [hc.mul(hc.generator, k) for k in ks]


def _bytes(curve, group, pts) -> list[bytes]:
    from snark_setup_tpu_torch.curves.constants import get_curve

    spec = get_curve(curve)
    codec = g1_codec(spec) if group == "g1" else g2_codec(spec)
    return [codec.serialize(p, UseCompression.NO) for p in pts]


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("curve,group", GROUPS)
def test_group_fft_equals_host_oracle(curve, group, n):
    ops = curve_ops(curve, group)
    dom = Radix2Domain(curve, n)
    ks = _scalars(curve, n, n)
    pts = ops.from_affine_host(_multiples(ops, ks), "cpu")
    f = group_fft(curve, group, n)
    assert ops.to_affine_host(f.ifft(pts)) == _multiples(ops, dom.ifft(ks))
    fwd = f.fft(pts)
    assert ops.to_affine_host(fwd) == _multiples(ops, dom.fft(ks))
    if n == 8:  # the round trip
        assert ops.to_affine_host(f.ifft(fwd)) == _multiples(ops, ks)


@pytest.mark.parametrize("curve,group", [("bls12_377", "g1"), ("bw6_761", "g1")])
def test_h_query_equals_host_oracle(curve, group):
    ops = curve_ops(curve, group)
    ks = _scalars(curve, 2 * N - 1, 5)
    got = ops.to_affine_host(h_query_device(ops, ops.from_affine_host(_multiples(ops, ks), "cpu"), N))
    r = ops.spec.r
    assert got == _multiples(ops, [(ks[i + N] - ks[i]) % r for i in range(N - 1)])


def test_slicing_lanes_changes_nothing(monkeypatch):
    ops = curve_ops("bls12_377", "g1")
    ks = _scalars("bls12_377", 16, 3)
    pts = ops.from_affine_host(_multiples(ops, ks), "cpu")
    f = GroupFFT(ops, Radix2Domain("bls12_377", 16))
    whole = ops.to_affine_host(f.ifft(pts)), ops.to_affine_host(h_query_device(ops, pts, 8))
    monkeypatch.setattr(lanes, "MAX_LANES", 3)
    assert (ops.to_affine_host(f.ifft(pts)), ops.to_affine_host(h_query_device(ops, pts, 8))) == whole


@pytest.mark.parametrize("inverse", [True, False])
def test_twiddles_equal_reference_stage_tables(inverse):
    """The port's per-stage twiddles, bit reversal and 1/n scale are the JAX
    package's host tables (whose first stage and forward scale are all
    ones: the multiplications the port skips)."""
    from snark_setup_tpu.ntt.domain import Radix2Domain as JDomain
    from snark_setup_tpu.ntt.group_fft import GroupFFT as JGroupFFT
    from snark_setup_tpu.ops.curve_jax import curve_ops as j_curve_ops

    n = 16
    jf = JGroupFFT(j_curve_ops("bw6_761", "g1"), JDomain("bw6_761", n))
    tw, _, _, _, rev, scale, _ = jf._tables(inverse)
    t_rev, stages, t_scale = group_fft("bw6_761", "g1", n).tables(inverse, "cpu")
    one = np.zeros(tw.shape[1], np.uint32)
    one[0] = 1
    assert (tw[0] == one[:, None]).all()  # stage 1: all ones
    assert len(stages) == tw.shape[0] - 1
    for s, t in enumerate(stages):
        assert (t.numpy() == tw[s + 1].astype(np.int32)).all(), s
    assert (t_rev.numpy() == rev).all()
    if inverse:
        assert (t_scale.numpy() == scale.astype(np.int32)).all()
    else:
        assert t_scale is None and (scale == one[:, None]).all()


def _inputs(curve, group, kind):
    ops = curve_ops(curve, group)
    return _bytes(curve, group, _multiples(ops, _scalars(curve, 2 * N - 1 if kind == "h_query" else N, 7)))


def jax_outputs() -> dict:
    """JAX_CASES -> the JAX package's outputs, as uncompressed bytes."""
    from snark_setup_tpu.curves.constants import get_curve
    from snark_setup_tpu.ntt.group_fft import group_fft as j_group_fft, h_query_device as j_h_query
    from snark_setup_tpu.ops.curve_jax import curve_ops as j_curve_ops
    from snark_setup_tpu.serialize.arkworks import g1_codec as j1, g2_codec as j2
    from snark_setup_tpu.utils.enums import CheckForCorrectness, UseCompression as JC

    out = {}
    for curve, group, kind in JAX_CASES:
        spec = get_curve(curve)
        codec = j1(spec) if group == "g1" else j2(spec)
        ops = j_curve_ops(curve, group)
        pts = ops.from_affine_host([codec.deserialize(b, JC.NO, CheckForCorrectness.NO)
                                    for b in _inputs(curve, group, kind)])
        if kind == "h_query":
            res = j_h_query(ops, pts, N)
        else:
            f = j_group_fft(curve, group, N)
            res = f.ifft(pts) if kind == "ifft" else f.fft(pts)
        out[(curve, group, kind)] = [codec.serialize(p, JC.NO) for p in ops.to_affine_host(res)]
    return out


@pytest.fixture(scope="session")
def jax_made(tmp_path_factory):
    path = R.shared_dir(tmp_path_factory) / "torch_ntt_reference.pkl"
    with FileLock(str(path) + ".lock"):
        if not path.exists():
            data = R.in_fresh_interpreter("test_torch_ntt", "jax_outputs")
            with open(path, "wb") as f:
                pickle.dump(data, f)
    with open(path, "rb") as f:
        return pickle.load(f)  # written by this test run


@pytest.mark.parametrize("curve,group,kind", JAX_CASES)
def test_equals_reference_group_fft(jax_made, curve, group, kind):
    ops = curve_ops(curve, group)
    codec = g1_codec(ops.spec) if group == "g1" else g2_codec(ops.spec)
    from snark_setup_tpu_torch.utils.enums import CheckForCorrectness

    pts = ops.from_affine_host([codec.deserialize(b, UseCompression.NO, CheckForCorrectness.NO)
                                for b in _inputs(curve, group, kind)], "cpu")
    if kind == "h_query":
        res = h_query_device(ops, pts, N)
    else:
        f = group_fft(curve, group, N)
        res = f.ifft(pts) if kind == "ifft" else f.fft(pts)
    assert _bytes(curve, group, ops.to_affine_host(res)) == jax_made[(curve, group, kind)]
