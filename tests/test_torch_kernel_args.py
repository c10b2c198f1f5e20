"""The Python side of the team-layer kernels, on the CPU: what the wrappers
hand a launch. The group-op kernel K2 (ops/cuda_group.py):

- `team_consts`: the by-value TeamConsts block of csrc/field_team.cuh, byte
  for byte against the Python integers N, R mod N and n0.
- `lane_layout` / `GroupOps.operand`: the (plane stride, inner, s1, s2)
  lane addressing of every operand K2 reads in place. A recorder stands in
  for the launch inside `sum_reduce` and a Pippenger MSM on the CPU, and
  checks for every operand those calls pass that the kernel's address
  arithmetic lands on the view's own elements, and which layouts are
  still copied (none of theirs).

The ladder K4 (ops/cuda_ladder.py) and the digits kernel K3
(ops/cuda_glv.py), whose constants reach the kernel by value:

- `ladder_consts`: beta (Montgomery form) then TeamConsts, word for word
  against the Python integers.
- `digits_consts`: the DigitsConsts block, read back by a Python model of
  the kernel's arithmetic at the library's compile-time geometry (zero
  padding and all), which must give `glv_digits_plain`'s digits and signs;
  and the build targets' geometry against every GLV curve's.

The stacked product K5 (ops/cuda_mul.py), whose modulus constants reach
the kernel by value since its redesign:

- `StackedMul._consts_np`: csrc/stacked_mul.cu's K5Consts block (N, n0),
  word for word against the Python integers, and handed to the launch as
  a host pointer (no device copy).

No JAX compiles; `torch.set_num_threads(1)` as in the other port tests.
"""

import math

import numpy as np
import pytest
import torch

from snark_setup_tpu_torch.curves.constants import get_curve
from snark_setup_tpu_torch.fields.limb import ints_to_limbs_batch
from snark_setup_tpu_torch.ops.build import TARGETS
from snark_setup_tpu_torch.ops.cuda_glv import GLVDigits, digits_consts, digits_geometry, glv_digits_plain
from snark_setup_tpu_torch.ops.cuda_group import GroupOps, group_ops_for, lane_layout, team_consts
from snark_setup_tpu_torch.ops.cuda_ladder import FusedGLVLadder, ladder_consts
from snark_setup_tpu_torch.ops.curve import PointVec, curve_ops
from snark_setup_tpu_torch.ops.fp import fp_ops
from snark_setup_tpu_torch.ops.pippenger import PippengerMSM

torch.set_num_threads(1)

CURVES = ["bls12_377", "bls12_381", "bw6_761", "mnt4_753", "mnt6_753"]


@pytest.mark.parametrize("curve", CURVES)
def test_team_consts_bytes_equal_the_python_integers(curve):
    q = get_curve(curve).q
    fq = fp_ops(q)
    NL = fq.L // 2
    R = 1 << (32 * NL)
    raw = team_consts(fq).tobytes()
    assert len(raw) == 4 * (2 * NL + 1)  # struct TeamConsts { N[NL]; one[NL]; n0; }: no padding
    assert int.from_bytes(raw[: 4 * NL], "little") == q
    assert int.from_bytes(raw[4 * NL : 8 * NL], "little") == R % q
    n0 = int.from_bytes(raw[8 * NL :], "little")
    assert (n0 * q) % (1 << 32) == (1 << 32) - 1  # n0 = -N^{-1} mod 2^32


def _layout_offsets(shape, strides):
    """Storage offsets of every lane of a batch view, the direct way."""
    idx = np.indices(shape).reshape(len(shape), -1)
    return (np.asarray(strides)[:, None] * idx).sum(0) if shape else np.zeros(1, np.int64)


@pytest.mark.parametrize("shape,strides,want", [
    ((7,), (1,), (7, 0, 1)),                 # a contiguous batch
    ((1,), (1,), (1, 0, 0)),                 # a batch-1 operand
    ((1, 1), (5, 1), (1, 0, 0)),
    ((4, 3), (3, 1), (12, 0, 1)),            # merges into one level
    ((64, 5), (11, 2), (5, 11, 2)),          # sum_reduce's even lanes of (64, 11)
    ((3, 9, 4), (9 * 8, 8, 1), (4, 8, 1)),   # a Pippenger half of (nwin, nb, 8)
    ((3,), (9,), (3, 0, 9)),                 # a bucket column of every window
    ((3, 8), (0, 1), (8, 0, 1)),             # a point row broadcast over the windows
    ((2, 3, 4), (24, 4, 2), None),           # three levels: copied first
])
def test_lane_layout_addresses_every_lane(shape, strides, want):
    got = lane_layout(shape, strides)
    assert got == want
    if got is not None:
        inner, s1, s2 = got
        b = np.arange(math.prod(shape))
        assert np.array_equal((b // inner) * s1 + (b % inner) * s2, _layout_offsets(shape, strides))


class _Recorder:
    """Stands in for K2's launch on CPU tensors: builds every operand's
    descriptor as a launch would, checks the kernel's address arithmetic
    against the view's elements, records the layouts, then runs the plain
    version."""

    def __init__(self, monkeypatch):
        self.seen = []
        rec = self
        orig_add, orig_dbl = GroupOps.add, GroupOps.double

        def add(self, p, q):
            batch = torch.broadcast_shapes(p["x"].shape[1:], q["x"].shape[1:])
            for t in (p, q):
                for k in "xyz":
                    rec.check(self, t[k], batch)
            return orig_add(self, p, q)

        def double(self, p):
            for k in "xyz":
                rec.check(self, p[k], p["x"].shape[1:])
            return orig_dbl(self, p)

        monkeypatch.setattr(GroupOps, "add", add)
        monkeypatch.setattr(GroupOps, "double", double)

    def check(self, k2, c, batch):
        v, (ptr, ps, inner, s1, s2) = k2.operand(c, batch)
        B = math.prod(batch)
        store = torch.tensor([], dtype=torch.int32).set_(v.untyped_storage())
        base = (ptr - store.data_ptr()) // 4
        b = torch.arange(B)
        lanes = base + (b // inner) * s1 + (b % inner) * s2
        addr = torch.arange(k2.L)[:, None] * ps + lanes[None, :]
        want = c.expand(k2.L, *batch).reshape(k2.L, B)
        assert torch.equal(store[addr], want)
        self.seen.append({"shape": tuple(c.shape[1:]), "batch": tuple(batch), "inner": inner,
                          "s1": s1, "s2": s2, "copied": v.untyped_storage().data_ptr() != c.untyped_storage().data_ptr()})


def _points(ops, n, seed):
    hc = ops.host_curve
    rng = np.random.default_rng(seed)
    base = [hc.mul(hc.generator, int(k)) for k in rng.integers(1, 1 << 20, n)]
    return ops.from_affine_host(base, "cpu")


def test_sum_reduce_views_go_to_the_kernel_in_place(monkeypatch):
    ops = curve_ops("bls12_377", "g1")
    rec = _Recorder(monkeypatch)
    pts = _points(ops, 7, 1)
    masked = PointVec({k: v.unsqueeze(1).expand(ops.fq.L, 3, 7).contiguous() for k, v in pts.items()})
    ops.sum_reduce(masked)
    assert rec.seen and not any(s["copied"] for s in rec.seen)
    # the first level: lanes 0, 2, 4 and 1, 3, 5 of each of the 3 rows of 7
    first = rec.seen[0]
    assert (first["batch"], first["inner"], first["s1"], first["s2"]) == ((3, 3), 3, 7, 2)


def test_pippenger_views_go_to_the_kernel_in_place(monkeypatch):
    ops = curve_ops("bls12_377", "g1")
    rec = _Recorder(monkeypatch)
    B, nbits = 8, 4
    msm = PippengerMSM(ops, B, nbits, c=3)
    pts = _points(ops, B, 2)
    rng = np.random.default_rng(3)
    ks = [int(k) for k in rng.integers(0, 1 << nbits, B)]
    got = msm(pts, np.ascontiguousarray(ints_to_limbs_batch(ks, 2).T))
    hc = ops.host_curve
    want = hc.mul(hc.generator, 0)
    for p, k in zip(ops.to_affine_host(pts), ks):
        want = hc.add(want, hc.mul(p, k))
    assert ops.to_affine_host(got)[0] == want
    assert rec.seen and not any(s["copied"] for s in rec.seen)
    kinds = {(s["inner"] == 1 and s["s1"] == 0 and s["s2"] == 0) for s in rec.seen}
    assert kinds == {True, False}  # batch-1 operands (the window combine) and strided ones
    assert any(s["s1"] == 0 and s["s2"] == 1 and len(s["batch"]) == 2 for s in rec.seen)  # broadcast rows
    assert any(s["s2"] == msm.nb for s in rec.seen)  # a bucket column of every window


def test_operand_copies_only_unmergeable_three_level_views():
    k2 = group_ops_for("bls12_377", "g1")
    L = k2.L
    c = torch.arange(L * 4 * 6 * 8, dtype=torch.int32).reshape(L, 4, 6, 8)
    v = c[:, ::2, ::2, ::2]  # (2, 3, 4) batch with strides (96, 16, 2): three levels
    t, desc = k2.operand(v, v.shape[1:])
    assert t.is_contiguous() and t.untyped_storage().data_ptr() != c.untyped_storage().data_ptr()
    assert desc[1:] == [t.stride(0), 2 * 3 * 4, 0, 1]
    t, desc = k2.operand(c[:, 1:3], c[:, 1:3].shape[1:])  # mergeable: in place
    assert t.untyped_storage().data_ptr() == c.untyped_storage().data_ptr()
    assert desc == [c[:, 1:3].data_ptr(), 4 * 6 * 8, 2 * 6 * 8, 0, 1]


LADDER_GROUPS = [("bls12_377", "g1"), ("bls12_381", "g1"), ("bw6_761", "g1"), ("bw6_761", "g2")]
GLV_GROUPS = LADDER_GROUPS + [("bls12_377", "g2"), ("bls12_381", "g2")]


@pytest.mark.parametrize("curve,group", LADDER_GROUPS)
def test_ladder_consts_words_equal_the_python_integers(curve, group):
    ops = curve_ops(curve, group)
    q, NL = ops.spec.q, ops.fq.L // 2
    words = FusedGLVLadder(ops)._consts_host
    assert words.dtype == np.uint32 and words.shape == (NL + 2 * NL + 1,)  # beta[NL] + TeamConsts
    raw = words.tobytes()
    beta = int.from_bytes(raw[: 4 * NL], "little")
    assert beta == ops.glv.p.beta * (1 << (32 * NL)) % q and pow(ops.glv.p.beta, 3, q) == 1
    assert raw[4 * NL:] == team_consts(ops.fq).tobytes()


def _digits_model(words: np.ndarray, geo: dict, k: int) -> tuple[list[int], list[int], int, int]:
    """csrc/glv_digits.cu's arithmetic on one scalar, in Python integers, from
    the packed DigitsConsts words: (d1, d2, neg, flip)."""
    MU, CO, LS, LC, LT, LH, NW = (geo[x] for x in ("MU", "CO", "LS", "LC", "LT", "LH", "NWIN"))
    mu = words[: 2 * MU].reshape(2, MU).astype(object)
    coeff = words[2 * MU : 2 * MU + 4 * CO].reshape(4, CO).astype(object)
    to_neg = words[2 * MU + 4 * CO:]
    assert len(to_neg) == 4
    kk = [(k >> (16 * i)) & 0xFFFF for i in range(LS)]
    S = LS + LC
    cs = []
    for m in range(2):
        acc, c = 0, []
        for col in range(S + LC):
            acc += sum(kk[i] * mu[m][col - i] for i in range(LS) if 0 <= col - i < MU)
            if col == S - 1:
                acc += 0x8000
            if col >= S:
                c.append(acc & 0xFFFF)
            acc >>= 16
        cs.append(c)
    mags, negs = [], []
    for o in range(2):
        P = (k if o == 0 else 0) + sum(
            sum(cs[s][i] * coeff[2 * o + s][j] << (16 * (i + j)) for i in range(LC) for j in range(CO))
            for s in range(2) if not to_neg[2 * o + s])
        N = sum(sum(cs[s][i] * coeff[2 * o + s][j] << (16 * (i + j)) for i in range(LC) for j in range(CO))
                for s in range(2) if to_neg[2 * o + s])
        P, N = P % (1 << (16 * LT)), N % (1 << (16 * LT))
        negs.append(int(P < N))
        mag = abs(P - N) % (1 << (16 * LH))
        mags.append([(mag >> (4 * (NW - 1 - r))) & 15 for r in range(NW)])
    return mags[0], mags[1], negs[0], negs[0] ^ negs[1]


@pytest.mark.parametrize("curve,group", GLV_GROUPS)
def test_digits_consts_give_the_plain_versions_digits(curve, group):
    ops = curve_ops(curve, group)
    w = GLVDigits(ops)
    words, geo = digits_consts(ops), w.geometry
    assert words.dtype == np.uint32 and words.shape == (2 * geo["MU"] + 4 * geo["CO"] + 4,)
    r = ops.spec.r
    rng = np.random.default_rng(23)
    ks = [0, 1, r - 1, 5 << 40] + [int.from_bytes(rng.bytes(64), "little") % r for _ in range(12)]
    d1, d2, neg, flip = glv_digits_plain(ops, torch.from_numpy(
        np.ascontiguousarray(ints_to_limbs_batch(ks, ops.fr.L).T.astype(np.int32))))
    for lane, k in enumerate(ks):
        m1, m2, n, f = _digits_model(words, geo, k)
        assert m1 == d1[:, lane].tolist() and m2 == d2[:, lane].tolist(), lane
        assert (n, f) == (int(neg[lane]), int(flip[lane])), lane


@pytest.mark.parametrize("curve", ["bls12_377", "bls12_381", "bw6_761"])
def test_digits_build_targets_carry_the_curves_geometry(curve):
    defines = dict(d[2:].split("=") for d in TARGETS[f"glv_digits_{curve_ops(curve, 'g1').spec.name}"][1])
    for group in ("g1", "g2"):
        assert {k: int(v) for k, v in defines.items()} == {
            f"DIG_{k}": v for k, v in digits_geometry(curve_ops(curve, group)).items()}


@pytest.mark.parametrize("curve", CURVES)
def test_stacked_mul_consts_bytes_equal_the_python_integers(curve):
    from snark_setup_tpu_torch.ops.cuda_mul import stacked_mul_for

    q = get_curve(curve).q
    K = stacked_mul_for(q)
    NL = K.NL
    raw = K._consts_np.tobytes()
    assert len(raw) == 4 * (NL + 1)  # struct K5Consts { N[NL]; n0; }: no padding
    assert int.from_bytes(raw[: 4 * NL], "little") == q
    n0 = int.from_bytes(raw[4 * NL :], "little")
    assert (n0 * q) % (1 << 32) == (1 << 32) - 1  # n0 = -N^{-1} mod 2^32
    assert K._consts_ptr(torch.device("cuda")) == K._consts_np.ctypes.data  # host memory, by value
