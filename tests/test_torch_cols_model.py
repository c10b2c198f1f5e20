"""A numpy model of the stacked product-columns kernel K6
(snark_setup_tpu_torch/ops/csrc/stacked_cols.cu), checked on the CPU against
K6's plain version and the JAX package's PallasFieldMul.cols in interpret
mode.

The kernel cannot run here, so the model spells out its instruction
sequence in uint32 with wraparound, on what the wrapper hands a launch
(ops/cuda_routes.py: StackedCols, the by-value TcConsts words and the
int32 weight / row-map table): the rows with non-zero weights in the
order the warp's ballot gives them, the two 16-bit limbs of each packed word of
u_r and the limb shifted up 16 bits, the per-thread window of S_p
(mad.lo) and S_h (mad.hi on the shifted limb) sums over the thread's limbs
of v_r, the per-column combine S_p - 2^16 S_h + S_h[k-1] folded weighted
into the thread's column sums, the team's T6 + 1 rounds of adds into the
warp's column planes and the thread's stores. Every shared-memory round is
checked to touch disjoint columns across the team and, at the stride SK6,
distinct banks across the warp. Exact equality (tolerance 0): the columns
are integers, compared limb for limb as unsigned 32-bit words: with the
plain version at widths 1, 5 and 33 (BLS12-377, MNT4-753, MNT6-753), with the reference at 33 (each
interpret-mode trace costs seconds), with 0, 1 and N - 1 in lanes 0-2,
negated rows, repeated rows, and, against both, weights at the largest sum
the column bound admits, where some column is at or above 2^31. The
model's geometry is read from the kernel's source (its C6 and WARPS6).
"""

import os
import re

import numpy as np
import pytest
import torch

from snark_setup_tpu.ops.pallas_field import pallas_mul_for
from snark_setup_tpu_torch.curves.constants import get_curve
from snark_setup_tpu_torch.fields.limb import int_to_limbs
from snark_setup_tpu_torch.ops.convert import planes_to_reference
from snark_setup_tpu_torch.ops.cuda_routes import stacked_cols_plain, stacked_product_for
from snark_setup_tpu_torch.ops.fp import fp_ops

torch.set_num_threads(1)

CURVES = ["bls12_377", "mnt4_753"]  # NL 12 and NL 24
MODEL_CURVES = CURVES + ["mnt6_753"]  # and the route scalar-mul's other NL 24 modulus
M32 = np.uint64(0xFFFFFFFF)
ROWS = ((2, 0, 1, 2), (1, 1, 0, 2), (1, 0, 1, 0))  # urow, vrow, uneg: repeats, skips, negates
WEIGHTS = ((1, 0, 1, 0), (0, 2, 0, 1), (3, 1, 1, 1))
SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "snark_setup_tpu_torch", "ops", "csrc", "stacked_cols.cu")


def _source_constant(name: str) -> int:
    """A `constexpr int NAME = value;` of stacked_cols.cu."""
    with open(SOURCE) as f:
        return int(re.search(rf"^constexpr int {name} = (\d+);", f.read(), re.M).group(1))


class Geometry6:
    """stacked_cols.cu's compile-time shapes at NL 32-bit limbs, from the
    source's own C6 and WARPS6."""

    def __init__(self, NL: int):
        C6, warps = _source_constant("C6"), _source_constant("WARPS6")
        self.NL, self.L16, self.C6, self.warps = NL, 2 * NL, C6, warps
        self.T6 = self.L16 // C6
        assert self.T6 * C6 == self.L16 and 32 % self.T6 == 0
        self.LANES6 = 32 // self.T6
        self.LPB6 = warps * self.LANES6
        self.NACC = self.L16 + C6
        self.SK6 = self.plane_stride()

    def plane_stride(self) -> int:
        if self.T6 == 1:
            return 32
        sk = self.LANES6
        while (self.C6 * sk) % 32 % self.LANES6 != 0 or (self.C6 * sk) % 32 // self.LANES6 % 2 != 1:
            sk += 1
        return sk


def _cond_neg_model(u, neg: int, N):
    """cond_neg_n: u (NL, B) uint64 words, N (NL,) -> N - u where neg and
    u != 0, else u, by the kernel's borrow chain."""
    if not neg:
        return u
    c = np.zeros(u.shape[1], np.int64)
    d = np.empty_like(u)
    for j in range(u.shape[0]):
        c = c + np.int64(N[j]) - u[j].astype(np.int64)
        d[j] = (c & 0xFFFFFFFF).astype(np.uint64)
        c >>= 32
    return np.where((u != 0).any(axis=0), d, u)


def k6_model(K, U: np.ndarray, V: np.ndarray, weights, rows) -> np.ndarray:
    """K6 on (L16, SU, B) / (L16, SV, B) planes of 16-bit limbs: the
    (2 L16, G, B) uint32 columns, by the kernel's steps."""
    geo = Geometry6(K.NL)
    L16, NL, T6, C = geo.L16, geo.NL, geo.T6, geo.C6
    B = U.shape[2]
    table = K._table(weights, rows, "cpu").numpy()  # the launch's int32 table
    S = len(rows[0])
    G = len(weights)
    Wt, urow, vrow, uneg = table[:G * S].reshape(G, S), table[G * S:G * S + S], \
        table[G * S + S:G * S + 2 * S], table[G * S + 2 * S:]
    N = K.tc_consts.astype(np.uint64)  # TcConsts, by value
    assert N.size == NL
    U64, V64 = U.astype(np.uint64), V.astype(np.uint64)
    out = np.zeros((2 * L16, G, B), np.uint64)
    for g in range(G):
        acc = np.zeros((T6, geo.NACC, B), np.uint64)  # every thread's column sums
        # rows 32 at a time, the ballot's set bits in order (__ffs)
        live = [r0 + k for r0 in range(0, S, 32) for k in range(32) if r0 + k < S and Wt[g, r0 + k]]
        for r in live:
            w = np.uint64(np.uint32(Wt[g, r]))
            u = U64[0::2, urow[r]] | (U64[1::2, urow[r]] << np.uint64(16))  # load_planes
            u = _cond_neg_model(u, int(uneg[r]), N)
            for tm in range(T6):
                b = V64[tm * C:(tm + 1) * C, vrow[r]]  # this thread's limbs of v_r
                sp = np.zeros((C, B), np.uint64)
                sh = np.zeros((C, B), np.uint64)
                hprev = np.zeros(B, np.uint64)
                for j in range(L16):
                    x = u[j >> 1]
                    a = x >> np.uint64(16) if j & 1 else x & np.uint64(0xFFFF)
                    ah = x & np.uint64(0xFFFF0000) if j & 1 else (x << np.uint64(16)) & M32
                    sp = (sp + a * b) & M32  # mad.lo.u32
                    sh = (sh + ((ah * b) >> np.uint64(32))) & M32  # mad.hi.u32
                    col = (sp[0] + np.uint64(1 << 32) - ((sh[0] << np.uint64(16)) & M32) + hprev) & M32
                    acc[tm, j] = (acc[tm, j] + w * col) & M32
                    hprev = sh[0]
                    sp = np.concatenate([sp[1:], np.zeros((1, B), np.uint64)])
                    sh = np.concatenate([sh[1:], np.zeros((1, B), np.uint64)])
                for c in range(C - 1):
                    col = (sp[c] + np.uint64(1 << 32) - ((sh[c] << np.uint64(16)) & M32) + hprev) & M32
                    acc[tm, L16 + c] = (acc[tm, L16 + c] + w * col) & M32
                    hprev = sh[c]
                acc[tm, geo.NACC - 1] = (acc[tm, geo.NACC - 1] + w * hprev) & M32
        # the team's rounds into the warp's column planes (one plane row per
        # column, the lanes side by side), then each thread's 2 C6 columns
        planes = np.zeros((2 * L16, B), np.uint64)
        for s in range(T6 + 1):
            touched = [C * (tm + s) + c for tm in range(T6) for c in range(C)]
            assert len(set(touched)) == len(touched)  # disjoint across the team
            for tm in range(T6):
                for c in range(C):
                    k = C * (tm + s) + c
                    planes[k] = (planes[k] + acc[tm, C * s + c]) & M32
        for tm in range(T6):
            for k in range(2 * C * tm, 2 * C * (tm + 1)):
                out[k, g] = planes[k]
    return out.astype(np.uint32)


def _planes(fq, S, B, rng, limb=None):
    """(L, S, B) int64 planes of values < N: random limbs (or every limb
    `limb` below a zero top limb); lanes 0, 1, 2 hold 0, 1, N - 1."""
    if limb is None:
        a = rng.integers(0, 1 << 16, size=(fq.L, S, B), dtype=np.int64)
        a[-1] = rng.integers(0, int(fq.N[-1, 0]), size=(S, B))
    else:
        a = np.full((fq.L, S, B), limb, np.int64)
        a[-1] = 0
    for lane, v in enumerate((0, 1, fq.modulus - 1)[:B]):
        a[:, :, lane] = int_to_limbs(v, fq.L).astype(np.int64)[:, None]
    return a


def _reference_cols(fq, K, U, V, weights, rows):
    """PallasFieldMul.cols (interpret mode) on the operands the row maps
    name, gathered and negated by the port's wrapper."""
    Ug, Vg = K.gather(torch.from_numpy(U.astype(np.int32)), torch.from_numpy(V.astype(np.int32)), rows)
    return np.asarray(pallas_mul_for(fq.modulus).cols(planes_to_reference(Ug), planes_to_reference(Vg),
                                                      weights, interpret=True))


def _model_case(curve, B):
    fq = fp_ops(get_curve(curve).q)
    K = stacked_product_for(fq.modulus).k6
    rng = np.random.default_rng(61 + B)
    U, V = _planes(fq, 3, B, rng), _planes(fq, 3, B, rng)
    return fq, K, U, V, k6_model(K, U, V, WEIGHTS, ROWS)


@pytest.mark.parametrize("B", [1, 5, 33])
@pytest.mark.parametrize("curve", MODEL_CURVES)
def test_cols_model_equals_plain(curve, B):
    """The model of K6's steps and K6's plain version (through the wrapper
    on CPU tensors, row maps and all) agree word for word."""
    fq, K, U, V, got = _model_case(curve, B)
    plain = K(torch.from_numpy(U.astype(np.int32)), torch.from_numpy(V.astype(np.int32)), WEIGHTS, ROWS)
    assert plain.dtype == torch.int32 and plain.shape == (2 * fq.L, len(WEIGHTS), B)
    assert (plain.numpy().view(np.uint32) == got).all()


@pytest.mark.parametrize("curve", CURVES)
def test_cols_model_equals_reference(curve):
    """The model of K6's steps and the reference's columns kernel
    (interpret mode) agree word for word, at the widest of the model's
    widths (one interpret-mode trace a curve)."""
    fq, K, U, V, got = _model_case(curve, 33)
    want = _reference_cols(fq, K, U, V, WEIGHTS, ROWS)
    assert want.dtype == np.uint32 and (want == got).all()


@pytest.mark.parametrize("curve", CURVES)
def test_cols_model_at_the_column_bound(curve):
    """Weights whose largest row sum is the largest that the column bound
    (`_check_columns`: 2 L 2^16 sum W < 2^32) admits, on operands whose
    limbs are all 0xFF01 below a zero top limb (values < N, products with
    both 16-bit halves near 2^16): columns reach 2^31 and beyond, and the
    model, the plain version and the reference still agree as unsigned
    words. One row is negated."""
    fq = fp_ops(get_curve(curve).q)
    K = stacked_product_for(fq.modulus).k6
    top = ((1 << 32) - 1) // (2 * fq.L << 16)  # the largest admitted weight sum
    weights = ((top - top // 2, top // 2, 0), (0, 0, top))
    rows = ((0, 1, 0), (0, 1, 1), (0, 0, 1))
    rng = np.random.default_rng(67)
    U, V = _planes(fq, 2, 5, rng, limb=0xFF01), _planes(fq, 2, 5, rng, limb=0xFF01)
    got = k6_model(K, U, V, weights, rows)
    assert int(got.max()) >= 1 << 31  # the case the 32-bit words must read as unsigned
    Ug, Vg = K.gather(torch.from_numpy(U.astype(np.int32)), torch.from_numpy(V.astype(np.int32)), rows)
    plain = stacked_cols_plain(fq, Ug, Vg, weights)
    assert plain.dtype == torch.int32 and (plain.numpy().view(np.uint32) == got).all()
    want = _reference_cols(fq, K, U, V, weights, rows)
    assert (want == got).all()
    with pytest.raises(ValueError, match="column bound"):
        from snark_setup_tpu_torch.ops.cuda_routes import _check_columns

        _check_columns(fq.L, ((top + 1,),))


@pytest.mark.parametrize("NL", [12, 24])
def test_cols_geometry_lanes_and_banks(NL):
    """The launch geometry: every lane of a ragged batch belongs to exactly
    one (block, warp, lane of the warp) with T6 threads; in every round of
    the team's adds the warp's 32 threads hit 32 distinct banks."""
    geo = Geometry6(NL)
    B = 4 * geo.LPB6 + 3
    seen = np.zeros(B, np.int64)
    for blk in range(-(-B // geo.LPB6)):
        for tid in range(32 * geo.warps):
            lid, warp = tid % 32, tid // 32
            l, tm = lid % geo.LANES6, lid // geo.LANES6
            lane = blk * geo.LPB6 + warp * geo.LANES6 + l
            if lane < B and tm == 0:
                seen[lane] += 1
    assert (seen == 1).all()
    assert geo.SK6 >= geo.LANES6  # a column's lanes never reach the next column
    for s in range(geo.T6 + 1):
        for c in range(geo.C6):
            banks = {((geo.C6 * (tm + s) + c) * geo.SK6 + l) % 32
                     for tm in range(geo.T6) for l in range(geo.LANES6)}
            assert len(banks) == 32
