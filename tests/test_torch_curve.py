"""The port's group law and plain GLV ladder against the JAX package's ladder
kernel bodies (`_kadd`, `_kdbl`, called eagerly — no Pallas), projective
coordinates limb for limb, and against the host curve. Exact equality."""

from functools import partial

import numpy as np
import pytest
import torch

from snark_setup_tpu.curves.host import INFINITY as JINF
from snark_setup_tpu.fields.limb import ints_to_limbs_batch
from snark_setup_tpu.ops.curve_jax import PointVec as JPointVec, curve_ops as jax_curve_ops
from snark_setup_tpu.ops.pallas_ladder import _b3s_for, _fmul, _fneg, _kadd, _kdbl
from snark_setup_tpu_torch.curves.host import INFINITY as TINF
from snark_setup_tpu_torch.ops import convert
from snark_setup_tpu_torch.ops.convert import planes_to_reference, pointvec_to_reference
from snark_setup_tpu_torch.ops.cuda_ladder import fused_ladder_for, glv_ladder_plain
from snark_setup_tpu_torch.ops.cuda_mul import stacked_mul_for
from snark_setup_tpu_torch.ops.curve import PointVec, curve_ops as torch_curve_ops

# The suite runs several pytest workers on one host: PyTorch's intra-op
# thread pool in each would oversubscribe the cores, and its idle threads'
# spinning slows the plain versions' small operators by orders of magnitude.
torch.set_num_threads(1)

# the tests run on the CPU: every seam constructor is asked for it by name
planes_from_reference = partial(convert.planes_from_reference, device="cpu")
pointvec_from_reference = partial(convert.pointvec_from_reference, device="cpu")

GROUPS = [("bls12_377", "g1"), ("bw6_761", "g1"), ("bw6_761", "g2")]
TB = 4


def _consts(ops):
    L = ops.fq.L
    N_b = np.ascontiguousarray(np.broadcast_to(ops.fq.N, (L, TB))).astype(np.uint32)
    Np_b = np.ascontiguousarray(np.broadcast_to(ops.fq.Nprime, (L, TB))).astype(np.uint32)
    b3_b = np.ascontiguousarray(
        np.broadcast_to(np.asarray(ops.b3_dev).reshape(L, 1), (L, TB))
    ).astype(np.uint32)
    return N_b, Np_b, b3_b, np.concatenate([N_b] * 6, axis=-1), np.concatenate([Np_b] * 6, axis=-1)


def _points(jops, seed):
    hc = jops.host_curve
    rng = np.random.default_rng(seed)
    P = [hc.mul(hc.generator, int(k)) for k in rng.integers(1, 1 << 30, TB)]
    Q = [hc.mul(hc.generator, int(k)) for k in rng.integers(1, 1 << 30, TB)]
    P[1] = JINF  # complete formulas: O + Q, P + P
    Q[2] = P[2]
    return P, Q


def _ref(jops, fn, *pts, b3s):
    N_b, Np_b, b3_b, NS, NpS = _consts(jops)
    coords = [(p["x"], p["y"], p["z"]) for p in pts]
    x, y, z = fn(*coords, N_b, Np_b, b3_b, NS, NpS, TB, b3s)
    return {"x": np.asarray(x), "y": np.asarray(y), "z": np.asarray(z)}


def _ref_group_law(jops, via):
    """(double, add) of the reference on dicts of numpy planes: its ladder
    kernel's bodies `_kdbl/_kadd` called eagerly (with the small-3b shortcut
    that kernel uses on these curves), or its `CurveOps.double/add` column
    path. Both return canonical coordinates, so either pins X, Y, Z."""
    if via == "kernel_bodies":
        b3s = _b3s_for(jops)
        return (lambda p: _ref(jops, _kdbl, p, b3s=b3s)), (lambda p, q: _ref(jops, _kadd, p, q, b3s=b3s))
    to_np = lambda pv: {k: np.asarray(pv[k]) for k in "xyz"}
    as_pv = lambda p: JPointVec(x=p["x"], y=p["y"], z=p["z"])
    return (lambda p: to_np(jops.double(as_pv(p)))), (lambda p, q: to_np(jops.add(as_pv(p), as_pv(q))))


@pytest.mark.parametrize(
    "curve,group,via",
    [("bls12_377", "g1", "kernel_bodies"), ("bw6_761", "g1", "curve_ops"), ("bw6_761", "g2", "curve_ops")],
)
def test_add_double_equal_reference_kernel_bodies(curve, group, via):
    """Projective X, Y, Z of add/double equal the reference's, limb for limb."""
    jops, tops = jax_curve_ops(curve, group), torch_curve_ops(curve, group)
    ref_double, ref_add = _ref_group_law(jops, via)
    P, Q = _points(jops, 4)
    pv, qv = jops.from_affine_host(P), jops.from_affine_host(Q)
    # projective (Z != 1) operands: double both first, through the reference
    pv2, qv2 = ref_double(pv), ref_double(qv)
    tp, tq = pointvec_from_reference(pv), pointvec_from_reference(qv)
    tp2, tq2 = tops.double(tp), tops.double(tq)
    for k in "xyz":
        assert (planes_to_reference(tp2[k]) == pv2[k]).all(), ("double", k)
    want = ref_add(pv2, qv2)
    got = pointvec_to_reference(tops.add(tp2, tq2))
    for k in "xyz":
        assert got[k].dtype == np.uint32 and (got[k] == want[k]).all(), ("add", k)
    # mixed with affine inputs and infinity
    want = ref_add(pv, qv)
    got = pointvec_to_reference(tops.add(tp, tq))
    for k in "xyz":
        assert (got[k] == want[k]).all(), ("add affine", k)


@pytest.mark.parametrize("curve,group", GROUPS)
def test_group_law_matches_host(curve, group):
    tops = torch_curve_ops(curve, group)
    hc = tops.host_curve
    rng = np.random.default_rng(5)
    P = [hc.mul(hc.generator, int(k)) for k in rng.integers(1, 1 << 30, TB)]
    Q = [hc.mul(hc.generator, int(k)) for k in rng.integers(1, 1 << 30, TB)]
    P[1], Q[2], Q[3] = TINF, P[2], hc.neg(P[3])
    pv, qv = tops.from_affine_host(P, "cpu"), tops.from_affine_host(Q, "cpu")
    assert tops.to_affine_host(tops.add(pv, qv)) == [hc.add(p, q) for p, q in zip(P, Q)]
    assert tops.to_affine_host(tops.double(pv)) == [hc.add(p, p) for p in P]
    assert tops.to_affine_host(tops.neg(pv)) == [hc.neg(p) for p in P]
    assert tops.is_infinity(tops.add(pv, qv)).tolist() == [False, False, False, True]
    x, y, inf = tops.normalize(tops.double(pv))
    assert inf.tolist() == [False, True, False, False]
    e = tops.to_affine_host(tops.endo(pv))
    assert e == [p if p.is_infinity else hc.mul(p, tops.glv.p.lam) for p in P]


def _reference_ladder(jops, pts, d1, d2, neg1, flip):
    """The reference kernel's schedule (pallas_ladder._make_ladder_kernel)
    replayed eagerly with its own bodies: table of j*base, beta-multiplied x
    table, then per window 4 doublings and two additions."""
    N_b, Np_b, b3_b, NS, NpS = _consts(jops)
    b3s = _b3s_for(jops)
    L = jops.fq.L
    one = np.ascontiguousarray(np.broadcast_to(jops.fq.one_mont_np, (L, TB))).astype(np.uint32)
    zero = np.zeros((L, TB), np.uint32)
    beta = np.ascontiguousarray(np.broadcast_to(np.asarray(jops._glv_beta).reshape(L, 1), (L, TB)))
    kadd = lambda p, q: _kadd(p, q, N_b, Np_b, b3_b, NS, NpS, TB, b3s)
    kdbl = lambda p: _kdbl(p, N_b, Np_b, b3_b, NS, NpS, TB, b3s)
    by = np.where(neg1 > 0, np.asarray(_fneg(pts["y"], N_b)), pts["y"])
    base = (pts["x"], by, pts["z"])
    table = [(zero, one, zero), base, kdbl(base)]
    for _ in range(3, 16):
        table.append(kadd(table[-1], base))
    t2x = [np.asarray(_fmul(t[0], beta, N_b, Np_b)) for t in table]

    def select(d, use_endo):
        out = [np.zeros((L, TB), np.uint32) for _ in range(3)]
        for j in range(16):
            row = (t2x[j] if use_endo else table[j][0], table[j][1], table[j][2])
            for c in range(3):
                out[c] = np.where(d == j, np.asarray(row[c]), out[c])
        return out

    acc = (zero, one, zero)
    for k in range(d1.shape[0]):
        for _ in range(4):
            acc = kdbl(acc)
        acc = kadd(acc, tuple(select(d1[k], False)))
        sx, sy, sz = select(d2[k], True)
        sy = np.where(flip > 0, np.asarray(_fneg(sy, N_b)), sy)
        acc = kadd(acc, (sx, sy, sz))
    return {k: np.asarray(v) for k, v in zip("xyz", acc)}


@pytest.mark.parametrize("curve,group", [("bls12_377", "g1")])
def test_plain_ladder_equals_reference_schedule_truncated(curve, group):
    """Truncated-window trick: scalars k = ±m1 ± m2*lambda with m1, m2 < 2^8
    decompose to those short halves, so only the last two windows are non-zero
    and a 2-window ladder computes the exact product. Both signs and the
    y-flip are exercised by hand-set masks; X, Y, Z compared limb for limb."""
    jops, tops = jax_curve_ops(curve, group), torch_curve_ops(curve, group)
    hc = jops.host_curve
    rng = np.random.default_rng(11)
    pts_host = [hc.mul(hc.generator, int(k)) for k in rng.integers(1, 1 << 28, TB)]
    pts_host[3] = JINF
    pts = jops.from_affine_host(pts_host)
    halves = rng.integers(0, 1 << 8, (TB, 2))
    halves[1] = (0, 0)
    d1 = np.stack([halves[:, 0] >> 4, halves[:, 0] & 15]).astype(np.uint32)
    d2 = np.stack([halves[:, 1] >> 4, halves[:, 1] & 15]).astype(np.uint32)
    neg1 = np.array([0, 1, 1, 0], np.uint32)
    flip = np.array([0, 0, 1, 1], np.uint32)
    want = _reference_ladder(jops, pts, d1, d2, neg1, flip)
    K = stacked_mul_for(tops.spec.q)
    before = (K.launches, K.plain_calls)
    got = glv_ladder_plain(
        tops, pointvec_from_reference(pts), planes_from_reference(d1), planes_from_reference(d2),
        planes_from_reference(neg1), planes_from_reference(flip),
    )
    # plain PyTorch throughout: every product is the stacked-product
    # wrapper's counted plain version, never a launch
    assert K.launches == before[0] and K.plain_calls > before[1]
    for k in "xyz":
        assert (planes_to_reference(got[k]) == want[k]).all(), k
    # and the value is the right group element
    lam, r = tops.glv.p.lam, tops.spec.r
    aff = tops.to_affine_host(got)
    for i, p in enumerate(pts_host):
        s1 = -1 if neg1[i] else 1
        s2 = -s1 if flip[i] else s1
        k = (s1 * int(halves[i, 0]) + s2 * int(halves[i, 1]) * lam) % r
        want_pt = hc.mul(p, k)
        assert aff[i].is_infinity == want_pt.is_infinity
        if not want_pt.is_infinity:
            assert (aff[i].x.v, aff[i].y.v) == (want_pt.x.v, want_pt.y.v)


@pytest.mark.parametrize("curve,group", GROUPS)
def test_scalar_mul_full_width_matches_host(curve, group):
    """CurveOps.scalar_mul on CPU tensors (digits + ladder plain versions)
    at full scalar width against host_curve.mul, including 0, 1, r-1 and an
    infinity input; the wrappers count a plain call and no launch."""
    tops = torch_curve_ops(curve, group)
    hc, r = tops.host_curve, tops.spec.r
    rng = np.random.default_rng(21)
    ks = [0, 1, r - 1] + [int.from_bytes(rng.bytes(64), "little") % r for _ in range(3)]
    pts = [hc.mul(hc.generator, 5 + i) for i in range(len(ks))]
    pts[5] = TINF
    raw = planes_from_reference(np.ascontiguousarray(ints_to_limbs_batch(ks, tops.fr.L).T))
    lad = fused_ladder_for(curve, group)
    before = (lad.launches, lad.plain_calls)
    out = tops.scalar_mul(tops.from_affine_host(pts, "cpu"), raw)
    assert (lad.launches, lad.plain_calls) == (before[0], before[1] + 1)
    assert tops.to_affine_host(out) == [hc.mul(p, k) for p, k in zip(pts, ks)]


def test_runtime_scalar_mul_is_the_glv_path_on_the_chosen_device():
    from snark_setup_tpu_torch.shard import runtime

    tops = torch_curve_ops("bls12_377", "g1")
    hc = tops.host_curve
    ks = [3, tops.spec.r - 2]
    pts = [hc.mul(hc.generator, 9), hc.mul(hc.generator, 10)]
    raw = planes_from_reference(np.ascontiguousarray(ints_to_limbs_batch(ks, tops.fr.L).T))
    pv = runtime.put_points(tops, tops.from_affine_host(pts, "cpu"), "cpu")
    out = runtime.scalar_mul(tops, pv, runtime.put_scalars(tops, raw, "cpu"), "cpu")
    assert out["x"].device.type == "cpu"
    assert tops.to_affine_host(out) == [hc.mul(p, k) for p, k in zip(pts, ks)]
    assert runtime.pad_width(17) == 17


def test_scalar_mul_windowed_matches_host():
    tops = torch_curve_ops("bls12_377", "g1")
    hc = tops.host_curve
    ks = [0, 1, 0xFFFF, 0xBEEF]
    pts = [hc.mul(hc.generator, 7 + i) for i in range(4)]
    raw = planes_from_reference(np.ascontiguousarray(ints_to_limbs_batch(ks, tops.fr.L).T))
    out = tops.scalar_mul_windowed(tops.from_affine_host(pts, "cpu"), raw, nbits=16)
    assert tops.to_affine_host(out) == [hc.mul(p, k) for p, k in zip(pts, ks)]
    digits = tops.scalar_digits_msb(raw, 4, 16)
    assert digits[:, 3].tolist() == [0xB, 0xE, 0xE, 0xF]


def test_ladder_wrapper_rejects_wrong_operands():
    tops = torch_curve_ops("bls12_377", "g1")
    lad = fused_ladder_for("bls12_377", "g1")
    p = tops.infinity((4,), "cpu")
    d = torch.zeros((33, 4), dtype=torch.int32)
    m = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(ValueError):
        lad(p, d, d, m.to(torch.int64), m)
    with pytest.raises(ValueError):
        lad(p, d, d[:, :3], m, m)
    with pytest.raises(ValueError):
        lad(PointVec(x=p["x"][:-1], y=p["y"], z=p["z"]), d, d, m, m)
