"""A numpy model of the tensor-core Montgomery reduction of kernels K7 and K8
(snark_setup_tpu_torch/ops/csrc/toeplitz_tc.cuh) and of K8's byte-plane
schoolbook (csrc/stacked_mul_v2.cu), checked on the CPU against the plain
versions.

The kernels cannot run here, so the model spells out what they do, step by
step, on what the wrappers hand a launch (ops/cuda_routes.py): the packed
tensor-core fragments (`StackedMulV3._fragments`, decoded here by the PTX
ISA's register layout of `mma.m16n8k32` for 8-bit types, independently of
the packer) and the by-value TcConsts words (`tc_consts`). A warp's byte
rows (padding filled with random bytes, which the zero columns of the
constant matrices must cancel), the B fragments each thread loads, the
compile-time k-step ranges of every tile, the D tiles written to and read
back from the warp's scratch, the byte carries into m and the word sums
into s: every s32 sum and every float32 partial sum is asserted to stay
exact. The reduction model must give `stacked_mul_plain`'s limbs (K5's
plain version) and Python-int Montgomery products on every curve, at edge
and random inputs and at the largest sum the REDC bound allows; K7's model
(K5's exact accumulation into it) `stacked_mul_v3_plain`'s; K8's model (the
team's window of column sums, added into the warp's planes in the kernel's
order, the combine, the resolve) `stacked_mul_v2_plain`'s. Exact equality:
integers mod N. No JAX; `torch.set_num_threads(1)` as in the other port
tests.
"""

import numpy as np
import pytest
import torch

from snark_setup_tpu_torch.curves.constants import get_curve
from snark_setup_tpu_torch.fields.limb import int_to_limbs, limbs_to_int
from snark_setup_tpu_torch.ops.cuda_mul import stacked_mul_plain
from snark_setup_tpu_torch.ops.cuda_routes import (
    stacked_mul_v2_plain,
    stacked_mul_v3_plain,
    stacked_product_for,
)
from snark_setup_tpu_torch.ops.fp import fp_ops
from snark_setup_tpu_torch.ops.toeplitz import tc_matrices, v2_bounds

torch.set_num_threads(1)

CURVES = ["bls12_377", "bls12_381", "bw6_761", "mnt4_753", "mnt6_753"]
M32 = (1 << 32) - 1


class Geometry:
    """toeplitz_tc.cuh's compile-time shapes at NL 32-bit limbs, 32 lanes a
    warp."""

    def __init__(self, NL: int):
        self.NL = NL
        self.CB = 4 * NL
        self.KS = -(-self.CB // 32)
        self.M1, self.M2 = self.CB // 16, 2 * self.CB // 16
        self.TL = self.M1 * self.KS * 512
        self.RB = 32 * self.KS + 16
        self.YS = 40
        self.NT = 4


def a_tile(frags: np.ndarray, off: int, j: int, ks: int, KS: int) -> np.ndarray:
    """The 16 x 32 A tile whose fragments thread lid holds at byte
    off + 512 (j KS + ks) + 16 lid: registers 0-3 are (row g, columns
    4 tig + e), (g + 8, 4 tig + e), (g, 16 + 4 tig + e), (g + 8, 16 + 4 tig + e)."""
    F = frags[off + 512 * (j * KS + ks): off + 512 * (j * KS + ks + 1)].reshape(32, 4, 4)
    A = np.zeros((16, 32), np.int64)
    for lid in range(32):
        g, tig = lid >> 2, lid & 3
        for reg, (row, col) in enumerate(((g, 4 * tig), (g + 8, 4 * tig), (g, 16 + 4 * tig), (g + 8, 16 + 4 * tig))):
            A[row, col:col + 4] = F[lid, reg]
    return A


def load_b(bc: np.ndarray, geo: Geometry) -> list:
    """Each thread's B registers as tc_load_b reads them: b[nt][ks] is
    (32 threads, 2 registers, 4 bytes) from lane row nt 8 + g, bytes
    32 ks + 4 tig and 16 further on."""
    b = []
    for nt in range(geo.NT):
        per_ks = []
        for ks in range(geo.KS):
            regs = np.zeros((32, 2, 4), np.int64)
            for lid in range(32):
                g, tig = lid >> 2, lid & 3
                o = 32 * ks + 4 * tig
                regs[lid, 0] = bc[nt * 8 + g, o:o + 4]
                regs[lid, 1] = bc[nt * 8 + g, o + 16:o + 20]
            per_ks.append(regs)
        b.append(per_ks)
    return b


def b_tile(regs: np.ndarray) -> np.ndarray:
    """The 32 x 8 B tile (k rows, lanes) from the threads' registers: thread
    (g, tig) holds column g, rows 4 tig + e (register 0) and 16 + 4 tig + e."""
    Bt = np.zeros((32, 8), np.int64)
    for lid in range(32):
        g, tig = lid >> 2, lid & 3
        Bt[4 * tig:4 * tig + 4, g] = regs[lid, 0]
        Bt[16 + 4 * tig:20 + 4 * tig, g] = regs[lid, 1]
    return Bt


def tc_tile(frags, off, j, klo, khi, b, geo: Geometry) -> np.ndarray:
    """tc_tile: the D tiles of tile j over k-steps klo .. khi, stored by the
    threads' accumulator layout into ys (16 x YS int32 words)."""
    ys = np.full((16, geo.YS), -1, np.int64)
    for nt in range(geo.NT):
        D = np.zeros((16, 8), np.int64)
        for ks in range(geo.KS):
            if klo <= ks <= khi:
                D += a_tile(frags, off, j, ks, geo.KS) @ b_tile(b[nt][ks])
        assert D.max() < 1 << 23  # exact in s32, as the header says
        for lid in range(32):
            g, tig = lid >> 2, lid & 3
            ys[g, nt * 8 + 2 * tig:nt * 8 + 2 * tig + 2] = D[g, 2 * tig:2 * tig + 2]
            ys[g + 8, nt * 8 + 2 * tig:nt * 8 + 2 * tig + 2] = D[g + 8, 2 * tig:2 * tig + 2]
    return ys


def tc_redc_model(cs: list[int], frags: np.ndarray, consts: np.ndarray, rng) -> list[int]:
    """tc_redc for one warp: `cs` (at most 32 exact sums < R N) -> the
    lanes' canonical results, as Python ints."""
    NL = consts.size
    geo = Geometry(NL)
    lanes = 32
    assert frags.size == (geo.M1 + geo.M2) * geo.KS * 512
    N = sum(int(w) << (32 * i) for i, w in enumerate(consts))
    n = len(cs)
    cs = list(cs) + [0] * (lanes - n)  # lanes past B reduce zeros
    words = [[(c >> (32 * k)) & M32 for k in range(2 * NL)] for c in cs]
    bc = rng.integers(0, 256, size=(lanes, geo.RB)).astype(np.int64)  # unwritten bytes: garbage
    for lane, c in enumerate(cs):
        bc[lane, :geo.CB] = np.frombuffer((c % (1 << (32 * NL))).to_bytes(geo.CB, "little"), np.uint8)
    b = load_b(bc, geo)
    carry = [0] * lanes
    for j in range(geo.M1):
        ys = tc_tile(frags, 0, j, 0, (16 * j + 15) // 32, b, geo)
        for lane in range(lanes):
            row = bytearray()
            for d in range(16):
                v = int(ys[d, lane]) + carry[lane]
                assert v < 1 << 32
                row.append(v & 0xFF)
                carry[lane] = v >> 8
            bc[lane, 16 * j:16 * j + 16] = np.frombuffer(bytes(row), np.uint8)
    b = load_b(bc, geo)
    sc = [0] * lanes
    res = [[0] * NL for _ in range(lanes)]
    for j in range(geo.M2):
        lo, hi = 16 * j - geo.CB + 1, (16 * j + 15) // 32
        ys = tc_tile(frags, geo.TL, j, lo // 32 if lo > 0 else 0, min(hi, geo.KS - 1), b, geo)
        for lane in range(lanes):
            for q in range(4):
                u = sum(int(ys[4 * q + e, lane]) << (8 * e) for e in range(4))
                sc[lane] += u + words[lane][4 * j + q]
                assert sc[lane] < 1 << 64
                if 4 * j + q >= NL:
                    res[lane][4 * j + q - NL] = sc[lane] & M32
                sc[lane] >>= 32
    out = []
    for lane in range(n):
        s = sum(w << (32 * i) for i, w in enumerate(res[lane]))
        assert sc[lane] == 0 and s < 2 * N
        out.append(s - N if s >= N else s)
    return out


def _planes(fq, S: int, B: int, rng, edge: bool = True) -> np.ndarray:
    """(L, S, B) int32 planes of values < N; lanes 0, 1, 2 hold 0, 1, N - 1."""
    a = rng.integers(0, 1 << 16, size=(fq.L, S, B), dtype=np.int64)
    a[-1] = rng.integers(0, int(fq.N[-1, 0]), size=(S, B))
    if edge:
        for lane, v in enumerate((0, 1, fq.modulus - 1)[:B]):
            a[:, :, lane] = int_to_limbs(v, fq.L).astype(np.int64)[:, None]
    return a.astype(np.int32)


def _ints(planes: np.ndarray) -> list[list[int]]:
    """(L, S, B) planes -> [S][B] Python ints."""
    L, S, B = planes.shape
    return [[limbs_to_int(planes[:, s, b]) for b in range(B)] for s in range(S)]


def _exact_sums(fq, U, V, weights) -> list[list[int]]:
    """[G][B] exact weighted sums sum_r W[g, r] u_r v_r (what K5's
    accumulation leaves in a thread's 2 NL + 1 words)."""
    u, v = _ints(U), _ints(V)
    B = U.shape[2]
    return [[sum(w * u[r][b] * v[r][b] for r, w in enumerate(g)) for b in range(B)] for g in weights]


def _planes_of(results: list[list[int]], L: int) -> torch.Tensor:
    """[G][B] ints -> (L, G, B) int32 limb planes."""
    return torch.from_numpy(np.stack([np.stack([int_to_limbs(x, L) for x in row], axis=1)
                                      for row in results], axis=1).astype(np.int32))


def _run_model(K, sums, rng) -> list[list[int]]:
    out = []
    for row in sums:
        got = []
        for lo in range(0, len(row), 32):
            got += tc_redc_model(row[lo:lo + 32], K._fragments, K.tc_consts, rng)
        out.append(got)
    return out


@pytest.mark.parametrize("curve", CURVES)
def test_tc_constants_are_the_modulus_and_its_toeplitz_matrices(curve):
    """The by-value words are N; the packed fragments decode (by the PTX
    register layout) to tc_matrices' T_low2 and T_full, zero-padded; the
    matrices turn bytes of c mod R into m = c N' mod R and bytes of m into
    m N."""
    q = get_curve(curve).q
    fq = fp_ops(q)
    K = stacked_product_for(q).k7
    NL, L = fq.L // 2, fq.L
    geo = Geometry(NL)
    assert K.tc_consts.dtype == np.uint32 and K.tc_consts.size == NL  # struct TcConsts { N[NL]; }
    assert int.from_bytes(K.tc_consts.tobytes(), "little") == q
    tl, tf = tc_matrices(q, fq.spec.n0_inv, L)
    for T, off, mt in ((tl, 0, geo.M1), (tf, geo.TL, geo.M2)):
        full = np.zeros((16 * mt, 32 * geo.KS), np.int64)
        for j in range(mt):
            for ks in range(geo.KS):
                full[16 * j:16 * j + 16, 32 * ks:32 * ks + 32] = a_tile(K._fragments, off, j, ks, geo.KS)
        assert (full[: T.shape[0], : T.shape[1]] == T).all()
        assert not full[T.shape[0]:].any() and not full[:, T.shape[1]:].any()
    R = 1 << (16 * L)
    rng = np.random.default_rng(3)
    for c in (0, 1, R - 1, int(rng.integers(0, 1 << 62)) * (q - 1)):
        cb = np.frombuffer((c % R).to_bytes(2 * L, "little"), np.uint8).astype(np.int64)
        y = tl.astype(np.int64) @ cb
        m = sum(int(d) << (8 * i) for i, d in enumerate(y)) % R
        assert (c + m * q) % R == 0
        mb = np.frombuffer(m.to_bytes(2 * L, "little"), np.uint8).astype(np.int64)
        assert sum(int(d) << (8 * i) for i, d in enumerate(tf.astype(np.int64) @ mb)) == m * q


@pytest.mark.parametrize("curve", CURVES)
def test_reduction_model_equals_montgomery_products(curve):
    """tc_redc's model over warps of 32 lanes, at c = 0, 1, N - 1, R - 1,
    N^2 - ..., the largest sum the REDC bound allows, values whose carries
    ripple through every digit, and random sums: (c R^{-1}) mod N,
    canonical."""
    q = get_curve(curve).q
    fq = fp_ops(q)
    K = stacked_product_for(q).k7
    R = fq.spec.mont_r_pow
    wmax = (R - 1) // q  # max_g sum W < R / N
    rng = np.random.default_rng(11)
    cs = [0, 1, q - 1, q, R - 1, R, (q - 1) ** 2, wmax * (q - 1) ** 2, R * (q - 1) + R - 1,
          (1 << (R.bit_length() + q.bit_length() - 2)) - 1]
    cs = [c for c in cs if c < R * q]
    while len(cs) < 32 + 3:
        cs.append(int.from_bytes(rng.bytes(2 * fq.L), "little") % (wmax * q * q))
    rinv = pow(R, -1, q)
    for lo in range(0, len(cs), 32):
        got = tc_redc_model(cs[lo:lo + 32], K._fragments, K.tc_consts, rng)
        assert got == [c * rinv % q for c in cs[lo:lo + 32]]


@pytest.mark.parametrize("curve", CURVES)
def test_k7_model_equals_plain_versions(curve):
    """K7 = K5's exact accumulation into the reduction: equal to
    stacked_mul_v3_plain and stacked_mul_plain, limb for limb, at the
    towers' weights (at NL 24 the largest, 3 x 14; within the REDC bound
    at NL 12),
    a ragged width, edge operands 0, 1, N - 1."""
    q = get_curve(curve).q
    fq = fp_ops(q)
    K = stacked_product_for(q).k7
    rng = np.random.default_rng(21)
    big = (3, 14) if fq.L == 48 else (2, 5)  # within the REDC bound (BLS12-381: sum W < 8)
    weights = ((1, 1, 0, 0, 0, 0), (0, 0, 1, 1, 1, 0), (0, 0, 0, 0, 0, 1), (*big, 0, 0, 0, 0))
    U, V = _planes(fq, 6, 37, rng), _planes(fq, 6, 37, rng)
    got = _planes_of(_run_model(K, _exact_sums(fq, U, V, weights), rng), fq.L)
    Ut, Vt = torch.from_numpy(U), torch.from_numpy(V)
    assert torch.equal(got, stacked_mul_v3_plain(fq, Ut, Vt, weights))
    assert torch.equal(got, stacked_mul_plain(fq, Ut, Vt, weights))


def k8_schoolbook_model(fq, U: np.ndarray, V: np.ndarray, weights) -> list[list[int]]:
    """K8's schoolbook per lane (vectorised over the lanes): per stacked row
    each team thread tm owns v's limbs 12 tm .. 12 tm + 11 as floats, takes
    u's limb i's bytes to weighted floats by the mantissa trick, keeps a
    window of 3 x 12 running column sums and adds its bottom column into the
    planes after each step (then the rest, after the last step); then the
    combine c[k] = A1[k] + 2^8 A2[k] + A3[k - 1] and the resolve into words.
    Every float32 value is checked to be the exact integer. Returns the
    [G][B] sums c."""
    L16 = fq.L
    C8, T8 = 12, fq.L // 12
    B = U.shape[2]
    f32 = np.float32

    def exact(x: np.ndarray) -> np.ndarray:
        assert x.dtype == f32 and (x < 1 << 24).all() and (x == np.floor(x)).all()
        return x

    def magic(limbs: np.ndarray, hi: bool, w: int) -> np.ndarray:
        byte = (limbs >> 8) if hi else (limbs & 0xFF)
        m = (np.uint32(0x4B000000) | byte.astype(np.uint32)).view(f32)  # 2^23 + byte
        out = (m.astype(np.float64) * w - 8388608.0 * w).astype(f32)  # one FMA, exact here
        assert (out == byte * w).all()
        return out

    sums = []
    for g_w in weights:
        planes = np.zeros((3, 2 * L16, B), f32)
        for r, w in enumerate(g_w):
            if not w:
                continue
            a = U[:, r].astype(np.int64)  # (L16, B) 16-bit limbs
            bl = (V[:, r] & 0xFF).astype(f32)
            bh = (V[:, r] >> 8).astype(f32)
            for tm in range(T8):
                win = np.zeros((3, C8, B), f32)
                for i in range(L16):
                    al, ah = magic(a[i], False, w), magic(a[i], True, w)
                    for c in range(C8):
                        j = tm * C8 + c
                        win[0, c] = exact(al * bl[j] + win[0, c])
                        win[1, c] = exact(al * bh[j] + win[1, c])
                        win[1, c] = exact(ah * bl[j] + win[1, c])
                        win[2, c] = exact(ah * bh[j] + win[2, c])
                    planes[:, i + tm * C8] = exact(planes[:, i + tm * C8] + win[:, 0])
                    win = np.concatenate([win[:, 1:], np.zeros((3, 1, B), f32)], axis=1)
                for c in range(C8 - 1):
                    planes[:, L16 + tm * C8 + c] = exact(planes[:, L16 + tm * C8 + c] + win[:, c])
        A = planes.astype(np.int64)
        cc = A[0] + (A[1] << 8) + np.concatenate([np.zeros((1, B), np.int64), A[2][:-1]])
        assert (cc < 1 << 32).all()
        sums.append([sum(int(cc[k, b]) << (16 * k) for k in range(2 * L16)) for b in range(B)])
    return sums


def _v2_weights(L: int) -> list:
    """Weights K8 takes at L: chip_smoke.py's degree-1 shapes and the
    largest weight sum v2_bounds accepts, in one row and spread."""
    top = max(s for s in range(1, 16) if v2_bounds(L, ((s,),))[0])
    return [
        tuple(tuple(int(i == j) for j in range(6)) for i in range(6)),
        ((1, 1, 0, 0, 0, 0), (0, 0, 1, 1, 0, 0), (0, 0, 0, 0, 1, 1)),
        ((top, 0, 0, 0, 0, 0), (0, 1, top - 1, 0, 0, 0), (0, 0, 0, 0, 0, 0)),
    ]


@pytest.mark.parametrize("curve", CURVES)
def test_k8_model_equals_v2_plain(curve):
    """K8's team schoolbook model into the reduction model over 32 lanes a
    warp (the kernel's reducing warps): equal to stacked_mul_v2_plain and
    K5's plain version, limb for limb; and to the exact sums before
    reduction."""
    q = get_curve(curve).q
    fq = fp_ops(q)
    K = stacked_product_for(q).k8
    rng = np.random.default_rng(31)
    U, V = _planes(fq, 6, 19, rng), _planes(fq, 6, 19, rng)
    Ut, Vt = torch.from_numpy(U), torch.from_numpy(V)
    for weights in _v2_weights(fq.L):
        sums = k8_schoolbook_model(fq, U, V, weights)
        assert sums == _exact_sums(fq, U, V, weights)
        got = _planes_of(_run_model(K, sums, rng), fq.L)
        assert torch.equal(got, stacked_mul_v2_plain(fq, Ut, Vt, weights))
        assert torch.equal(got, stacked_mul_plain(fq, Ut, Vt, weights))
