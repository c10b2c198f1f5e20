"""The square root over Fq (ops/cuda_sqrt.py): its plain version against the
JAX package's ExtSqrt.sqrt, and a Python-int model of the kernel's schedule
(csrc/fq_sqrt.cu) against host arithmetic.

The kernel itself runs only on the card (tests/test_torch_kernels_gpu.py
holds it against `fq_sqrt_plain` there). Here the same numpy-seeded inputs,
with 0, 1, q - 1 and non-squares among them, go through both packages'
square roots on all five base fields; roots and masks must be equal
exactly. The model reads the kernel's by-value parameter words as the
kernel unpacks them and runs its loops (the exponent's bits most
significant first, Tonelli-Shanks' i - 2 squarings for i = e .. 2, the
per-lane selects, the paired r c and c^2 products) on Python integers.
"""

import numpy as np
import pytest
import torch

from snark_setup_tpu.ops.codec_jax import batch_codec as jax_batch_codec
from snark_setup_tpu_torch.ops.codec import batch_codec
from snark_setup_tpu_torch.ops.cuda_sqrt import fq_sqrt_for, fq_sqrt_plain, sqrt_params, sqrt_schedule

# several pytest workers share the host: one intra-op thread each
torch.set_num_threads(1)

CURVES = ["bls12_377", "bls12_381", "bw6_761", "mnt4_753", "mnt6_753"]
M32 = (1 << 32) - 1


def _values(q: int, z: int, seed: int, n: int = 10) -> list[int]:
    """0, 1, q - 1, z (a non-residue), z times a square (another one), and
    random squares and random values from a numpy generator."""
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(q.bit_length() // 8 + 8), "little") % q for _ in range(n)]
    squares = [v * v % q for v in rand[: n // 2]]
    return [0, 1, q - 1, z, z * squares[0] % q, *squares, *rand[n // 2:]]


@pytest.mark.parametrize("curve", CURVES)
def test_fq_sqrt_plain_equals_the_reference(curve):
    codec = batch_codec(curve, "g1", "cpu")
    fq, sq = codec.fp, codec.sqrter
    q, z = fq.modulus, sq.z_coeffs[0]
    planes = fq.from_int(_values(q, z, seed=CURVES.index(curve)))  # (L, B) Montgomery, numpy
    root, ok = fq_sqrt_plain(fq, z, torch.from_numpy(planes.astype(np.int32)))
    want_root, want_ok = jax_batch_codec(curve, "g1").sqrter.sqrt(planes.astype(np.uint32))
    assert (root.numpy().astype(np.uint32) == np.asarray(want_root)).all()
    assert ok.tolist() == np.asarray(want_ok).tolist()
    assert ok.tolist()[:5] == [True, True, pow(q - 1, (q - 1) // 2, q) == 1, False, False]
    # the codec's square root is the wrapper, which runs this plain version on the CPU
    K = fq_sqrt_for(q, z)
    before = K.plain_calls
    r2, ok2 = sq.sqrt(torch.from_numpy(planes.astype(np.int32)))
    assert K.plain_calls == before + 1
    assert torch.equal(r2, root) and torch.equal(ok2, ok)


class KernelModel:
    """csrc/fq_sqrt.cu on Python integers: the parameter words unpacked as
    `fq_sqrt_launch` unpacks them, the products as the team layer returns
    them (canonical a b / R mod N), the loops and selects of the kernel."""

    def __init__(self, words: np.ndarray, NL: int):
        w = [int(x) for x in words]
        assert len(w) == 2 + 2 * NL + 2 * NL + 1  # SqrtParams' by-value words
        val = lambda ws: sum(x << (32 * i) for i, x in enumerate(ws))
        self.nbits, self.e = w[0], w[1]
        self.exp = w[2 : 2 + NL]
        self.c = val(w[2 + NL : 2 + 2 * NL])
        self.N = val(w[2 + 2 * NL : 2 + 3 * NL])
        self.one = val(w[2 + 3 * NL : 2 + 4 * NL])
        self.n0 = w[2 + 4 * NL]
        self.R = 1 << (32 * NL)
        assert self.n0 == (-pow(self.N, -1, 1 << 32)) % (1 << 32)
        self.rinv = pow(self.R, -1, self.N)
        self.products = 0

    def mont(self, a: int, b: int) -> int:
        assert a < self.N and b < self.N  # the layer's precondition
        self.products += 1
        return a * b * self.rinv % self.N

    def sqrt(self, a: int) -> tuple[int, bool]:
        acc = a
        for k in range(self.nbits - 2, -1, -1):
            acc = self.mont(acc, acc)
            if (self.exp[k >> 5] >> (k & 31)) & 1:
                acc = self.mont(acc, a)
        if self.e == 1:
            r = acc
        else:
            r = self.mont(a, acc)
            t = self.mont(r, acc)
            c = self.c
            for i in range(self.e, 1, -1):
                sq = t
                for _ in range(i - 2):
                    sq = self.mont(sq, sq)
                flip = sq != self.one
                rc, cc = self.mont(r, c), self.mont(c, c)  # one round loop for both
                r = rc if flip else r
                c = cc
                tc = self.mont(t, c)
                t = tc if flip else t
        rr = self.mont(r, r)
        return r, (rr == a) | (a == 0)


@pytest.mark.parametrize("curve", CURVES)
def test_kernel_schedule_model_equals_host_square_roots(curve):
    codec = batch_codec(curve, "g1", "cpu")
    fq, z = codec.fp, codec.sqrter.z_coeffs[0]
    q, NL = fq.modulus, fq.L // 2
    R = 1 << (32 * NL)
    model = KernelModel(sqrt_params(fq, z), NL)
    e, exponent, c = sqrt_schedule(q, z)
    assert (model.N, model.one, model.e, model.c) == (q, R % q, e, c * R % q)
    assert sum(x << (32 * i) for i, x in enumerate(model.exp)) == exponent
    assert e == codec.sqrter.e and (q - 1) >> e == codec.sqrter.s
    values = _values(q, z, seed=100 + CURVES.index(curve))
    K = fq_sqrt_for(q, z)
    roots = []
    for v in values:
        model.products = 0
        r_m, ok = model.sqrt(v * R % q)
        assert model.products == K.products()
        r = r_m * pow(R, -1, q) % q
        assert ok == (v == 0 or pow(v, (q - 1) // 2, q) == 1), v
        if ok:
            assert r * r % q == v
        roots.append(r_m)
    # and the plain version's roots, limb for limb
    root, ok = fq_sqrt_plain(fq, z, torch.from_numpy(fq.from_int(values).astype(np.int32)))
    assert fq.to_int(root) == [r * pow(R, -1, q) % q for r in roots]
