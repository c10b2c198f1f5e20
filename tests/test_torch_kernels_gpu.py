"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc: they are marked `gpu`, decide inside
the test whether a card is present, and skip without one. Run them on the
machine with the card:

    python -m pytest tests/test_torch_kernels_gpu.py -q -m gpu

(`chip_smoke.py` makes the same comparison at the main path's shapes.)
"""

import numpy as np
import pytest
import torch

from snark_setup_tpu_torch.curves.host import INFINITY
from snark_setup_tpu_torch.fields.limb import ints_to_limbs_batch
from snark_setup_tpu_torch.ops.cuda_glv import glv_digits_for, glv_digits_plain
from snark_setup_tpu_torch.ops.cuda_ladder import fused_ladder_for, glv_ladder_plain
from snark_setup_tpu_torch.ops.curve import PointVec, curve_ops

GROUPS = [("bls12_377", "g1"), ("bw6_761", "g1"), ("bw6_761", "g2"), ("bls12_381", "g1")]
# groups over Fp2: K3 feeds the ladder over the group law (K5 rounds) there
DIGITS_ONLY = [("bls12_377", "g2"), ("bls12_381", "g2")]


@pytest.mark.gpu
@pytest.mark.parametrize("curve,group", GROUPS)
def test_kernels_equal_plain_versions_on_the_card(curve, group):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    ops = curve_ops(curve, group)
    hc, r = ops.host_curve, ops.spec.r
    rng = np.random.default_rng(5)
    B = 257  # not a multiple of the block
    ks = [0, 1, r - 1] + [int.from_bytes(rng.bytes(64), "little") % r for _ in range(B - 3)]
    scalars = ops.fr.tensor(ints_to_limbs_batch(ks, ops.fr.L).T, dev)
    base = [hc.mul(hc.generator, 3 + i) for i in range(8)]
    base[5] = INFINITY
    p8 = ops.double(ops.from_affine_host(base, dev))
    idx = torch.arange(B, device=dev) % 8
    pts = PointVec({k: v[:, idx].contiguous() for k, v in p8.items()})

    dig, lad = glv_digits_for(curve, group), fused_ladder_for(curve, group)
    n_dig, n_lad = dig.launches, lad.launches
    got_d = dig(scalars)
    got_p = lad(pts, *got_d)
    torch.cuda.synchronize()
    assert (dig.launches, lad.launches) == (n_dig + 1, n_lad + 1)
    with torch.no_grad():
        want_d = glv_digits_plain(ops, scalars)
        want_p = glv_ladder_plain(ops, pts, *want_d)
    for a, b in zip(got_d, want_d):
        assert torch.equal(a, b)
    for k in "xyz":
        assert torch.equal(got_p[k], want_p[k]), k
    lanes = [0, 1, 2, 5, B - 1]
    aff = ops.to_affine_host(PointVec({k: v[:, lanes].contiguous() for k, v in got_p.items()}))
    for lane, pt in zip(lanes, aff):
        src = base[lane % 8]
        want = INFINITY if src.is_infinity else hc.mul(hc.double(src), ks[lane])
        assert pt == want, lane


# the stacked-product kernel K5 at the group law's shapes: (curve, group whose
# coordinate field it multiplies in, curve-level weights)
STACKED = [
    ("bls12_377", "g2", ((1, 0, 0), (0, 1, 0), (0, 0, 1))),
    ("bls12_377", "g1", ((1, 2, 0), (0, 0, 3))),
    ("mnt4_753", "g2", ((1, 1, 0), (0, 0, 2))),
    ("mnt6_753", "g2", ((1, 1, 0), (0, 1, 1))),
    ("bw6_761", "g1", ((1, 1, 1, 1),)),
    ("bls12_381", "g2", ((1, 0, 0), (0, 1, 0), (0, 0, 1))),
    ("bls12_381", "g1", ((1,),)),  # the square root's Fq product
]


@pytest.mark.gpu
@pytest.mark.parametrize("curve,group,weights", STACKED)
def test_stacked_mul_kernel_equals_plain_version_on_the_card(curve, group, weights):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from snark_setup_tpu_torch.fields.limb import int_to_limbs
    from snark_setup_tpu_torch.ops.cuda_mul import stacked_mul_for, stacked_mul_plain

    dev = torch.device("cuda")
    F = curve_ops(curve, group).field
    fq = F.fp
    S = len(weights[0])
    if F.degree == 1:
        comp, rows = weights, (tuple(range(S)),) * 2 + ((0,) * S,)
    else:
        comp, rows = F._flattened(weights, S)
    rng = np.random.default_rng(9)
    B = 257  # not a multiple of the block

    def planes():
        a = rng.integers(0, 1 << 16, size=(fq.L, F.degree * S, B), dtype=np.int64)
        a[-1] = rng.integers(0, int(fq.N[-1, 0]), size=a.shape[1:])
        for lane, v in enumerate((0, 1, fq.modulus - 1)):
            a[:, :, lane] = int_to_limbs(v, fq.L).astype(np.int64)[:, None]
        return torch.from_numpy(a.astype(np.int32)).to(dev)

    U, V = planes(), planes()
    K = stacked_mul_for(fq.modulus)
    n = K.launches
    got = K(U, V, comp, rows)
    torch.cuda.synchronize()
    assert K.launches == n + 1
    want = stacked_mul_plain(fq, *K.gather(U, V, rows), comp)
    assert torch.equal(got, want)
    assert torch.equal(K(*K.gather(U, V, rows), comp), want)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [4097, 16384])
@pytest.mark.parametrize("curve,group", GROUPS)
def test_group_op_kernels_equal_plain_version_on_the_card(curve, group, B):
    """K2 double / add against the plain group law: affine and projective
    operands, O + Q, P + O, P + P, P + (-P), a batch-1 second operand."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from snark_setup_tpu_torch.ops.cuda_group import group_ops_for
    from snark_setup_tpu_torch.ops.curve import plain_group_law

    dev = torch.device("cuda")
    ops = curve_ops(curve, group)
    hc = ops.host_curve
    rng = np.random.default_rng(7)
    base = [INFINITY] + [hc.mul(hc.generator, int(k)) for k in rng.integers(1, 1 << 30, 15)]
    table = ops.from_affine_host(base, dev)
    ip = torch.from_numpy(rng.integers(1, 16, B)).to(dev)
    iq = torch.from_numpy(rng.integers(1, 16, B)).to(dev)
    ip[0], iq[1], iq[2] = 0, 0, ip[2]  # O + Q, P + O, P + P
    P = PointVec({k: v[:, ip].contiguous() for k, v in table.items()})
    Q = PointVec({k: v[:, iq].contiguous() for k, v in table.items()})
    Q["x"][:, 3], Q["z"][:, 3] = P["x"][:, 3], P["z"][:, 3]
    Q["y"][:, 3] = ops.fq.neg(P["y"][:, 3:4])[:, 0]  # P + (-P)
    k2, plain = group_ops_for(curve, group), plain_group_law(ops)
    P2, Q2 = plain.double(P), plain.double(Q)  # Z != 1
    q1 = PointVec({k: v[:, 5:6] for k, v in Q2.items()})
    n_dbl, n_add = k2.dbl.launches, k2.add_k.launches
    with torch.no_grad():
        for p in (P, P2):
            got, want = k2.double(p), plain.double(p)
            for k in "xyz":
                assert torch.equal(got[k], want[k]), ("double", k)
        for p, q in ((P, Q), (P2, Q2), (P2, q1)):
            got, want = k2.add(p, q), plain.add(p, q)
            for k in "xyz":
                assert torch.equal(got[k], want[k]), ("add", k)
        # sum_reduce's strided even / odd lanes, read in place
        half = B // 2
        even = PointVec({k: v[:, 0:2 * half:2] for k, v in P2.items()})
        odd = PointVec({k: v[:, 1:2 * half:2] for k, v in P2.items()})
        got, want = k2.add(even, odd), plain.add(even, odd)
        for k in "xyz":
            assert torch.equal(got[k], want[k]), ("add even / odd", k)
    torch.cuda.synchronize()
    assert (k2.dbl.launches, k2.add_k.launches) == (n_dbl + 2, n_add + 4)
    lanes = [0, 1, 2, 3, B - 1]
    got = ops.to_affine_host(PointVec({k: v[:, lanes].contiguous() for k, v in k2.add(P, Q).items()}))
    for lane, pt in zip(lanes, got):
        assert pt == hc.add(base[int(ip[lane])] if lane != 3 else base[int(ip[3])],
                            base[int(iq[lane])] if lane != 3 else hc.neg(base[int(ip[3])])), lane


# the opt-in routes' kernels K6 (columns), K7 (Toeplitz REDC) and K8 (f32
# byte planes + Toeplitz REDC) at shapes of the group law: (curve, group
# whose coordinate field they multiply in, curve-level weights). K8 takes
# only weights that v2_bounds accepts: degree-1 rounds with small sums.
ROUTE_SHAPES = {
    "k6": [("bls12_377", "g2", ((1, 0, 0), (0, 1, 0), (0, 0, 1))),
           ("mnt4_753", "g2", ((1, 1, 0), (0, 0, 2))),
           ("mnt6_753", "g2", ((1, 1, 0), (0, 1, 1)))],
    "k7": [("bls12_377", "g2", ((1, 0, 0), (0, 1, 0), (0, 0, 1))),
           ("mnt4_753", "g2", ((1, 1, 0), (0, 0, 2))),
           ("mnt6_753", "g2", ((1, 1, 0), (0, 1, 1)))],
    "k8": [("bls12_377", "g1", tuple(tuple(int(i == j) for j in range(32)) for i in range(32))),
           ("bls12_377", "g1", ((1, 2, 0), (0, 0, 3))),
           ("mnt4_753", "g1", ((1, 1, 0, 0, 0, 0), (0, 0, 1, 1, 0, 0), (0, 0, 0, 0, 1, 1)))],
}


@pytest.mark.gpu
@pytest.mark.parametrize("B", [4097, 16384])
@pytest.mark.parametrize("route,curve,group,weights",
                         [(r, *shape) for r, shapes in ROUTE_SHAPES.items() for shape in shapes])
def test_route_kernels_equal_plain_versions_on_the_card(route, curve, group, weights, B):
    """K6, K7 and K8 against their plain versions (run on the card in lane
    chunks), lanes 0, 1, 2 holding 0, 1 and N - 1; K7 and K8 equal K5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from snark_setup_tpu_torch.fields.limb import int_to_limbs
    from snark_setup_tpu_torch.ops.cuda_routes import stacked_product_for

    dev = torch.device("cuda")
    F = curve_ops(curve, group).field
    fq = F.fp
    S = len(weights[0])
    if F.degree == 1:
        comp, rows = weights, (tuple(range(S)),) * 2 + ((0,) * S,)
    else:
        comp, rows = F._flattened(weights, S)
    rng = np.random.default_rng(13)

    def planes():
        a = rng.integers(0, 1 << 16, size=(fq.L, F.degree * S, B), dtype=np.int64)
        a[-1] = rng.integers(0, int(fq.N[-1, 0]), size=a.shape[1:])
        for lane, v in enumerate((0, 1, fq.modulus - 1)):
            a[:, :, lane] = int_to_limbs(v, fq.L).astype(np.int64)[:, None]
        return torch.from_numpy(a.astype(np.int32)).to(dev)

    U, V = planes(), planes()
    P = stacked_product_for(fq.modulus)
    K = getattr(P, route)
    n = K.launches
    with torch.no_grad():
        got = K(U, V, comp, rows)
        torch.cuda.synchronize()
        assert K.launches == n + 1
        Ug, Vg = K.gather(U, V, rows)
        chunk = 1024
        want = torch.cat([K.plain_fn(Ug[..., lo:lo + chunk], Vg[..., lo:lo + chunk], comp)
                          for lo in range(0, B, chunk)], dim=-1)
        assert got.dtype == want.dtype and torch.equal(got, want)
        if route != "k6":
            assert torch.equal(got, P.k5(U, V, comp, rows))


def _points_on_card(ops, n, rng, dev):
    """n seeded points, lane 0 the point at infinity, as projective Z != 1
    planes (doubled by the plain group law)."""
    from snark_setup_tpu_torch.ops.curve import plain_group_law

    hc = ops.host_curve
    base = [INFINITY] + [hc.mul(hc.generator, int(k)) for k in rng.integers(1, 1 << 30, 15)]
    table = ops.from_affine_host(base, dev)
    idx = torch.from_numpy(rng.integers(0, 16, n)).to(dev)
    return plain_group_law(ops).double(PointVec({k: v[:, idx].contiguous() for k, v in table.items()}))


@pytest.mark.gpu
@pytest.mark.parametrize("width", [1, 2, "T-1", "T+1", 31, 33])
@pytest.mark.parametrize("curve,group", GROUPS)
def test_group_op_kernels_at_narrow_widths_and_views_on_the_card(curve, group, width):
    """K2 at the verify path's narrow widths (the team size T of the limb
    count, T +- 1, a warp +- 1), on contiguous operands, a batch-1 second
    operand, sum_reduce's strided even / odd lanes of a (3, 2w + 1) batch,
    a Pippenger half of bucket rows and a row broadcast over windows;
    every result equal to the plain group law's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from snark_setup_tpu_torch.ops.cuda_group import group_ops_for
    from snark_setup_tpu_torch.ops.curve import plain_group_law

    dev = torch.device("cuda")
    ops = curve_ops(curve, group)
    k2, plain = group_ops_for(curve, group), plain_group_law(ops)
    rng = np.random.default_rng(11)
    with torch.no_grad():
        warm = _points_on_card(ops, 1, rng, dev)
        k2.double(warm)  # loads the library: k2.team
        T = k2.team
        w = {"T-1": T - 1, "T+1": T + 1}.get(width, width)
        P, Q = _points_on_card(ops, w, rng, dev), _points_on_card(ops, w, rng, dev)
        big = _points_on_card(ops, 3 * (2 * w + 1), rng, dev)
        rows = PointVec({k: v.reshape(ops.fq.L, 3, 2 * w + 1) for k, v in big.items()})
        buckets = PointVec({k: v.reshape(ops.fq.L, 3, 1, 2 * w + 1)[..., :2 * w] for k, v in big.items()})
        cases = [
            ("double", (P,)),
            ("add", (P, Q)),
            ("add", (P, PointVec({k: v[:, :1] for k, v in Q.items()}))),  # batch-1 q
            ("add", (PointVec({k: v[..., 0:2 * w:2] for k, v in rows.items()}),
                     PointVec({k: v[..., 1:2 * w:2] for k, v in rows.items()}))),  # even / odd
            ("add", (PointVec({k: v[..., :w] for k, v in buckets.items()}),
                     PointVec({k: v[..., w:2 * w] for k, v in buckets.items()}))),  # lane-merge halves
            ("add", (PointVec({k: v[:, None, :] .expand(ops.fq.L, 3, w) for k, v in P.items()}),
                     PointVec({k: v[..., :w] for k, v in rows.items()}))),  # broadcast over windows
            ("double", (PointVec({k: v[..., 1:2 * w:2] for k, v in rows.items()}),)),
        ]
        for kind, args in cases:
            got = getattr(k2, kind)(*args)
            want = getattr(plain, kind)(*args)
            for k in "xyz":
                assert got[k].shape == want[k].shape and torch.equal(got[k], want[k]), (kind, k)
    torch.cuda.synchronize()


STACKED_MAIN = [  # chip_smoke.py's STACKED shapes: (curve, group, weights)
    ("bls12_377", "g2", tuple(tuple(int(i == j) for j in range(6)) for i in range(6))),
    ("bls12_377", "g1", tuple(tuple(int(i == j) for j in range(32)) for i in range(32))),
    ("mnt4_753", "g1", ((1, 1, 0, 0, 0, 0), (0, 0, 1, 1, 1, 0), (0, 0, 0, 0, 0, 1))),
    ("mnt4_753", "g2", ((1, 1, 0, 0, 0, 0), (0, 0, 1, 1, 1, 0), (0, 0, 0, 0, 0, 1))),
    ("mnt6_753", "g2", tuple(tuple(int(i == j) for j in range(6)) for i in range(6))),
    ("mnt6_753", "g2", ((1, 1, 0, 0, 0, 0), (0, 0, 1, 1, 0, 0), (0, 0, 0, 0, 1, 1))),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 33, 4097])
@pytest.mark.parametrize("curve,group,weights", STACKED_MAIN)
def test_stacked_mul_kernel_at_the_main_path_shapes_on_the_card(curve, group, weights, B):
    """K5 at every shape chip_smoke.py holds it at, with the edge values 0,
    1 and N - 1 in lanes 0, 1, 2 of every row (as far as the width goes),
    equal to the plain version (run in lane chunks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from snark_setup_tpu_torch.fields.limb import int_to_limbs
    from snark_setup_tpu_torch.ops.cuda_mul import stacked_mul_for, stacked_mul_plain

    dev = torch.device("cuda")
    F = curve_ops(curve, group).field
    fq = F.fp
    S = len(weights[0])
    if F.degree == 1:
        comp, rows = weights, (tuple(range(S)),) * 2 + ((0,) * S,)
    else:
        comp, rows = F._flattened(weights, S)
    rng = np.random.default_rng(17)

    def planes():
        a = rng.integers(0, 1 << 16, size=(fq.L, F.degree * S, B), dtype=np.int64)
        a[-1] = rng.integers(0, int(fq.N[-1, 0]), size=a.shape[1:])
        for lane, v in enumerate((0, 1, fq.modulus - 1)[:B]):
            a[:, :, lane] = int_to_limbs(v, fq.L).astype(np.int64)[:, None]
        return torch.from_numpy(a.astype(np.int32)).to(dev)

    U, V = planes(), planes()
    K = stacked_mul_for(fq.modulus)
    with torch.no_grad():
        got = K(U, V, comp, rows)
        Ug, Vg = K.gather(U, V, rows)
        want = torch.cat([stacked_mul_plain(fq, Ug[..., lo:lo + 256], Vg[..., lo:lo + 256], comp)
                          for lo in range(0, B, 256)], dim=-1)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _glv_edge_scalars(ops):
    """0, 1, r - 1, a scalar with one non-zero window (k1 = k, k2 = 0), the
    eigenvalue lambda and r - lambda (k2 = +-1, k1 = 0), and one scalar for
    each (neg, flip) pair of the decomposition."""
    r, lam = ops.spec.r, ops.glv.p.lam
    ks = [0, 1, r - 1, 5 << 40, lam, r - lam]
    rng = np.random.default_rng(29)
    combos = {}
    while len(combos) < 4:
        k = int.from_bytes(rng.bytes(64), "little") % r
        k1, k2 = ops.glv.decompose_host(k)
        combos.setdefault((k1 < 0, (k1 < 0) != (k2 < 0)), k)
    return ks + [combos[c] for c in sorted(combos)]


@pytest.mark.gpu
@pytest.mark.parametrize("width", [1, 2, "T-1", "T+1", 33, 4097, 16384])
@pytest.mark.parametrize("curve,group", GROUPS)
def test_glv_kernels_at_widths_and_edge_scalars_on_the_card(curve, group, width):
    """K3 and K4 against their plain versions, limb for limb, at narrow
    widths around the ladder's team size T, a warp + 1, a ragged and the
    main path's batch; the lanes cycle through the edge scalars (0, 1,
    r - 1, one non-zero window, every neg / flip pair) and random ones, on
    projective points with the point at infinity in lane 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    ops = curve_ops(curve, group)
    dig, lad = glv_digits_for(curve, group), fused_ladder_for(curve, group)
    rng = np.random.default_rng(31)
    with torch.no_grad():
        warm = _points_on_card(ops, 1, rng, dev)
        lad(warm, *dig(ops.fr.tensor(ints_to_limbs_batch([1], ops.fr.L).T, dev)))  # loads the library: lad.team
        T = lad.team
        B = {"T-1": T - 1, "T+1": T + 1}.get(width, width)
        edge = _glv_edge_scalars(ops)
        r = ops.spec.r
        ks = [edge[i % len(edge)] if i < 2 * len(edge) else int.from_bytes(rng.bytes(64), "little") % r
              for i in range(B)]
        scalars = ops.fr.tensor(ints_to_limbs_batch(ks, ops.fr.L).T, dev)
        pts = _points_on_card(ops, B, rng, dev)
        n_dig, n_lad = dig.launches, lad.launches
        got_d = dig(scalars)
        got_p = lad(pts, *got_d)
        torch.cuda.synchronize()
        assert (dig.launches, lad.launches) == (n_dig + 1, n_lad + 1)
        want_d = glv_digits_plain(ops, scalars)
        for a, b in zip(got_d, want_d):
            assert torch.equal(a, b)
        want_p = glv_ladder_plain(ops, pts, *want_d)
        for k in "xyz":
            assert torch.equal(got_p[k], want_p[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("width", [1, 2, 33, 4097, 16384])
@pytest.mark.parametrize("curve,group", DIGITS_ONLY)
def test_glv_digits_on_fp2_groups_at_widths_and_edge_scalars_on_the_card(curve, group, width):
    """K3 alone (its library for the curve) against its plain version where
    no ladder kernel follows it, with the edge scalars of the test above."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    ops = curve_ops(curve, group)
    dig = glv_digits_for(curve, group)
    rng = np.random.default_rng(41)
    edge, r = _glv_edge_scalars(ops), ops.spec.r
    ks = [edge[i % len(edge)] if i < 2 * len(edge) else int.from_bytes(rng.bytes(64), "little") % r
          for i in range(width)]
    scalars = ops.fr.tensor(ints_to_limbs_batch(ks, ops.fr.L).T, dev)
    n_dig = dig.launches
    got_d = dig(scalars)
    torch.cuda.synchronize()
    assert dig.launches == n_dig + 1
    for a, b in zip(got_d, glv_digits_plain(ops, scalars)):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("curve,group", GROUPS)
def test_glv_kernels_on_non_contiguous_operands_on_the_card(curve, group):
    """Strided scalars, point coordinates and digit planes (every other lane
    of a wider batch) give what their contiguous copies give."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    ops = curve_ops(curve, group)
    dig, lad = glv_digits_for(curve, group), fused_ladder_for(curve, group)
    rng = np.random.default_rng(37)
    B = 65
    with torch.no_grad():
        ks = [int.from_bytes(rng.bytes(64), "little") % ops.spec.r for _ in range(2 * B)]
        wide = ops.fr.tensor(ints_to_limbs_batch(ks, ops.fr.L).T, dev)
        scalars = wide[:, ::2]
        assert not scalars.is_contiguous()
        got_d = dig(scalars)
        want_d = glv_digits_plain(ops, scalars.contiguous())
        for a, b in zip(got_d, want_d):
            assert torch.equal(a, b)
        pts2 = _points_on_card(ops, 2 * B, rng, dev)
        pts = PointVec({k: v[:, 1::2] for k, v in pts2.items()})
        d2 = [torch.stack([d, d], dim=-1).reshape(*d.shape[:-1], 2 * B)[..., ::2] for d in got_d]
        assert not pts["x"].is_contiguous() and not d2[0].is_contiguous()
        got_p = lad(pts, *d2)
        want_p = glv_ladder_plain(ops, PointVec({k: v.contiguous() for k, v in pts.items()}), *want_d)
        for k in "xyz":
            assert torch.equal(got_p[k], want_p[k]), k
    torch.cuda.synchronize()


# K7 and K8 at chip_smoke.py's ROUTE_SHAPES: K7 at every STACKED shape (the
# towers' row maps and negations come from F._flattened, the largest weights
# are MNT4-753 Fp2's 3 x 14), K8 at the degree-1 shapes v2_supported takes
_ID = lambda n: tuple(tuple(int(i == j) for j in range(n)) for i in range(n))
ROUTE_MAIN = [("k7", *shape) for shape in STACKED_MAIN] + [
    ("k8", "bls12_377", "g1", _ID(32)),
    ("k8", "mnt4_753", "g1", _ID(6)),
    ("k8", "mnt4_753", "g1", ((1, 1, 0, 0, 0, 0), (0, 0, 1, 1, 0, 0), (0, 0, 0, 0, 1, 1))),
]


def _route_planes(fq, S, B, rng):
    """(L, S, B) planes of values < N on the card, lanes 0, 1, 2 holding 0,
    1 and N - 1 (as far as the width goes)."""
    from snark_setup_tpu_torch.fields.limb import int_to_limbs

    a = rng.integers(0, 1 << 16, size=(fq.L, S, B), dtype=np.int64)
    a[-1] = rng.integers(0, int(fq.N[-1, 0]), size=a.shape[1:])
    for lane, v in enumerate((0, 1, fq.modulus - 1)[:B]):
        a[:, :, lane] = int_to_limbs(v, fq.L).astype(np.int64)[:, None]
    return torch.from_numpy(a.astype(np.int32)).to("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 2, 63, 65, 4097, 16384])
@pytest.mark.parametrize("route,curve,group,weights", ROUTE_MAIN)
def test_k7_k8_equal_plain_versions_at_the_main_path_shapes_on_the_card(route, curve, group, weights, B):
    """K7 / K8 against their own plain versions and K5's plain version (run
    on the card in lane chunks), limb for limb, at widths 1, 2, a warp's
    63 / 65 lanes, 4097 and 16384, with the edge values in lanes 0-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from snark_setup_tpu_torch.ops.cuda_mul import stacked_mul_plain
    from snark_setup_tpu_torch.ops.cuda_routes import stacked_product_for

    F = curve_ops(curve, group).field
    fq = F.fp
    S = len(weights[0])
    comp, rows = (weights, (tuple(range(S)),) * 2 + ((0,) * S,)) if F.degree == 1 else F._flattened(weights, S)
    rng = np.random.default_rng(41)
    U, V = _route_planes(fq, F.degree * S, B, rng), _route_planes(fq, F.degree * S, B, rng)
    K = getattr(stacked_product_for(fq.modulus), route)
    n = K.launches
    with torch.no_grad():
        got = K(U, V, comp, rows)
        torch.cuda.synchronize()
        assert K.launches == n + 1 and got.shape == (fq.L, len(comp), B)
        Ug, Vg = K.gather(U, V, rows)
        chunks = range(0, B, 1024)
        want = torch.cat([K.plain_fn(Ug[..., lo:lo + 1024], Vg[..., lo:lo + 1024], comp) for lo in chunks], dim=-1)
        k5 = torch.cat([stacked_mul_plain(fq, Ug[..., lo:lo + 1024], Vg[..., lo:lo + 1024], comp)
                        for lo in chunks], dim=-1)
    assert torch.equal(got, want)
    assert torch.equal(got, k5)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["k7", "k8"])
@pytest.mark.parametrize("curve", ["bls12_377", "mnt4_753"])
def test_k7_k8_row_maps_negation_views_and_refusals_on_the_card(curve, route):
    """Row maps that repeat and skip rows, negated operands (0 stays 0),
    a non-contiguous U: equal to K5's plain version on the gathered
    operands. Weights the wrapper refuses raise before any launch: the
    REDC bound (both), the 16-bit column bound (K7), v2_bounds (K8)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from snark_setup_tpu_torch.ops.cuda_mul import stacked_mul_plain
    from snark_setup_tpu_torch.ops.cuda_routes import stacked_product_for

    fq = curve_ops(curve, "g1").field.fp
    K = getattr(stacked_product_for(fq.modulus), route)
    rng = np.random.default_rng(43)
    B = 4097
    wide = _route_planes(fq, 3, 2 * B, rng)
    U = wide[..., ::2]  # lanes 0, 2, 4 of `wide`: 0, N - 1, ...
    assert not U.is_contiguous()
    V = _route_planes(fq, 3, B, rng)
    rows = ((2, 0, 1, 2), (1, 1, 0, 2), (1, 0, 1, 0))
    weights = ((1, 0, 1, 0), (0, 1, 0, 1))
    n = K.launches
    with torch.no_grad():
        got = K(U, V, weights, rows)
        torch.cuda.synchronize()
        want = stacked_mul_plain(fq, *K.gather(U.contiguous(), V, rows), weights)
    assert K.launches == n + 1
    assert torch.equal(got, want)
    redc = fq.spec.mont_r_pow // fq.modulus + 1
    too_big = [((redc,),)]
    if route == "k8":
        from snark_setup_tpu_torch.ops.toeplitz import v2_bounds

        too_big.append(((next(s for s in range(1, 64) if not v2_bounds(fq.L, ((s,),))[0]),),))
    else:
        too_big.append((((1 << 15) // fq.L + 1,),))
    for w in too_big:
        with pytest.raises(ValueError):
            K(U[:, :1], V[:, :1], w)
    assert K.launches == n + 1


def _k6_planes(fq, S, B, rng, limb=None):
    """`_route_planes`, or with `limb` every limb but the top (0) set to it:
    values below N whose products fill both 16-bit halves."""
    if limb is None:
        return _route_planes(fq, S, B, rng)
    a = np.full((fq.L, S, B), limb, np.int32)
    a[-1] = 0
    return torch.from_numpy(a).to("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 17, 33, 4097, 16384, 65536])
@pytest.mark.parametrize("curve,group,weights", STACKED_MAIN)
def test_k6_equals_plain_version_at_the_main_path_shapes_on_the_card(curve, group, weights, B):
    """K6 at every shape chip_smoke.py holds it at (ROUTE_SHAPES["k6"]),
    word for word against its plain version (run on the card in lane
    chunks), 32-bit columns in an int32 tensor, with the edge values in
    lanes 0-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from snark_setup_tpu_torch.ops.cuda_routes import stacked_product_for

    F = curve_ops(curve, group).field
    fq = F.fp
    S = len(weights[0])
    comp, rows = (weights, (tuple(range(S)),) * 2 + ((0,) * S,)) if F.degree == 1 else F._flattened(weights, S)
    rng = np.random.default_rng(47)
    U, V = _route_planes(fq, F.degree * S, B, rng), _route_planes(fq, F.degree * S, B, rng)
    K = stacked_product_for(fq.modulus).k6
    n = K.launches
    with torch.no_grad():
        got = K(U, V, comp, rows)
        torch.cuda.synchronize()
        assert K.launches == n + 1 and got.dtype == torch.int32 and got.shape == (2 * fq.L, len(comp), B)
        Ug, Vg = K.gather(U, V, rows)
        want = torch.cat([K.plain_fn(Ug[..., lo:lo + 1024], Vg[..., lo:lo + 1024], comp)
                          for lo in range(0, B, 1024)], dim=-1)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [33, 4097, 16384])
@pytest.mark.parametrize("curve,group,weights", STACKED_MAIN)
def test_mxu_route_equals_k5_at_the_main_path_shapes_on_the_card(curve, group, weights, B):
    """The SNARK_SETUP_MXU_STACKED route (K6, then the float64 reduction)
    gives K5's canonical products at every K6 shape of chip_smoke.py."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from snark_setup_tpu_torch.ops.cuda_routes import stacked_product_for

    F = curve_ops(curve, group).field
    fq = F.fp
    S = len(weights[0])
    comp, rows = (weights, (tuple(range(S)),) * 2 + ((0,) * S,)) if F.degree == 1 else F._flattened(weights, S)
    rng = np.random.default_rng(53)
    U, V = _route_planes(fq, F.degree * S, B, rng), _route_planes(fq, F.degree * S, B, rng)
    P = stacked_product_for(fq.modulus)
    n = P.k6.launches
    with torch.no_grad():
        got = P.mxu(U, V, comp, rows)
        want = P.k5(U, V, comp, rows)
    torch.cuda.synchronize()
    assert P.k6.launches == n + 1
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("curve", ["bls12_377", "mnt4_753"])
def test_k6_row_maps_negation_views_and_column_bound_on_the_card(curve):
    """Row maps that repeat and skip rows, negated operands (0 stays 0), a
    non-contiguous U, then weights at the largest sum the wrapper admits
    on limbs of 0xFF01 (MNT4-753: the column bound's 682, columns above
    2^31 that must read as unsigned): K6 equals its plain version on the
    gathered operands, and the MXU route K5's product. Weights past the
    bounds raise before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from snark_setup_tpu_torch.ops.cuda_routes import _check_columns, stacked_cols_plain, stacked_product_for

    fq = curve_ops(curve, "g1").field.fp
    P = stacked_product_for(fq.modulus)
    K = P.k6
    rng = np.random.default_rng(59)
    B = 4097
    wide = _route_planes(fq, 3, 2 * B, rng)
    U = wide[..., ::2]  # lanes 0, 2, 4 of `wide`: 0, N - 1, ...
    assert not U.is_contiguous()
    V = _route_planes(fq, 3, B, rng)
    rows = ((2, 0, 1, 2), (1, 1, 0, 2), (1, 0, 1, 0))
    weights = ((1, 0, 1, 0), (0, 1, 0, 1))
    n = K.launches
    with torch.no_grad():
        got = K(U, V, weights, rows)
        torch.cuda.synchronize()
        want = stacked_cols_plain(fq, *K.gather(U.contiguous(), V, rows), weights)
        assert K.launches == n + 1 and torch.equal(got, want)
        redc = fq.spec.mont_r_pow // fq.modulus  # the REDC bound's largest sum
        top = min(redc, ((1 << 32) - 1) // (2 * fq.L << 16))
        _check_columns(fq.L, ((top,),))
        Uf, Vf = _k6_planes(fq, 3, B, rng, 0xFF01), _k6_planes(fq, 3, B, rng, 0xFF01)
        bound = ((top - top // 2, top // 2, 0), (0, 1, top - 1))
        frows = ((0, 1, 2), (2, 1, 0), (0, 1, 0))
        got = K(Uf, Vf, bound, frows)
        want = stacked_cols_plain(fq, *K.gather(Uf, Vf, frows), bound)
        assert torch.equal(got, want)
        if curve == "mnt4_753":
            assert top == 682 and int(got.min()) < 0  # columns >= 2^31, as int32 words
        assert torch.equal(P.mxu(Uf, Vf, bound, frows), P.k5(Uf, Vf, bound, frows))
    n = K.launches
    for w in (((redc + 1,),), ((((1 << 32) - 1) // (2 * fq.L << 16) + 1,),)):
        with pytest.raises(ValueError):
            K(U[:, :1], V[:, :1], w)
    assert K.launches == n


SQRT_CURVES = ["bls12_377", "bls12_381", "bw6_761", "mnt4_753", "mnt6_753"]


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 33, 4097, 16385])
@pytest.mark.parametrize("curve", SQRT_CURVES)
def test_sqrt_kernel_equals_plain_version_on_the_card(curve, B):
    """The square-root kernel (csrc/fq_sqrt.cu) against `fq_sqrt_plain` on
    the card, root and mask limb for limb, on every base field (2-adicity
    1, 46, 15 and 30), with 0, 1, q - 1, the non-residue z and z times a
    square in lanes 0-4 (as far as the width goes) and random values,
    half of them squares, elsewhere. Through the codec's ExtSqrt it is one
    launch and no launch of the stacked-product kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from chip_smoke import sqrt_inputs
    from snark_setup_tpu_torch.ops.codec import batch_codec
    from snark_setup_tpu_torch.ops.cuda_sqrt import fq_sqrt_for, fq_sqrt_plain

    dev = torch.device("cuda")
    codec = batch_codec(curve, "g1", dev)
    fq, z = codec.fp, codec.sqrter.z_coeffs[0]
    q = fq.modulus
    a = sqrt_inputs(fq, z, B, np.random.default_rng(61 + B), dev)
    K = fq_sqrt_for(q, z)
    k5 = codec.F.product.k5
    n, n5 = K.launches, k5.launches
    with torch.no_grad():
        root, ok = codec.sqrter.sqrt(a)
        torch.cuda.synchronize()
        assert (K.launches, k5.launches) == (n + 1, n5)
        want_root, want_ok = fq_sqrt_plain(fq, z, a)
    assert torch.equal(root, want_root) and torch.equal(ok, want_ok)
    assert ok[: min(B, 5)].tolist() == [True, True, pow(q - 1, (q - 1) // 2, q) == 1, False, False][: min(B, 5)]
