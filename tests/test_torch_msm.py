"""The port's public-scalar MSMs (ops/msm.py, ops/pippenger.py) against the
JAX package and the host oracle (Python-int curve arithmetic), on the CPU.
The JAX package's bucket MSM compiles one deep graph, which XLA:CPU can
abort on (KNOWN_ISSUES.md §3): it runs in a fresh interpreter, so an abort
fails one test instead of taking a pytest worker down.
Modular arithmetic: exact equality (tolerance 0)."""

import os
import pickle
import random
import subprocess
import sys
from functools import partial

import numpy as np
import pytest
import torch

from snark_setup_tpu.curves.host import INFINITY as JINF
from snark_setup_tpu.fields.limb import ints_to_limbs_batch
from snark_setup_tpu.ops import msm as jmsm
from snark_setup_tpu.ops.curve_jax import curve_ops as jax_curve_ops
from snark_setup_tpu.ops.pippenger import PippengerMSM as JPippenger, signed_digits_host as j_digits
from snark_setup_tpu_torch.ops import convert, msm as tmsm
from snark_setup_tpu_torch.ops.convert import pointvec_to_reference
from snark_setup_tpu_torch.ops.curve import curve_ops as torch_curve_ops
from snark_setup_tpu_torch.ops.pippenger import PippengerMSM, signed_digits_host

# The suite runs several pytest workers on one host: PyTorch's intra-op
# thread pool in each would oversubscribe the cores, and its idle threads'
# spinning slows the plain versions' small operators by orders of magnitude.
torch.set_num_threads(1)

pointvec_from_reference = partial(convert.pointvec_from_reference, device="cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _in_fresh_interpreter(name, *args):
    """`name(*args)` of this module, run in a new Python process set up as
    tests/conftest.py sets up this one; arguments and result pickled."""
    code = (
        "import pickle, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import tests.conftest\n"
        "import tests.test_torch_msm as m\n"
        f"out = m.{name}(*pickle.loads(sys.stdin.buffer.read()))\n"
        "sys.stdout.buffer.write(pickle.dumps(out))\n"
    )
    done = subprocess.run([sys.executable, "-c", code], input=pickle.dumps(args), capture_output=True,
                          cwd=REPO, timeout=1200)
    if done.returncode != 0:
        raise RuntimeError(f"{name} failed (rc {done.returncode}):\n{done.stderr.decode()[-3000:]}")
    return pickle.loads(done.stdout)  # written by this test run


def _jax_pippenger(curve, planes, sc, nbits):
    """The JAX package's PippengerMSM on numpy planes."""
    from snark_setup_tpu.ops.curve_jax import PointVec as JPointVec

    jops = jax_curve_ops(curve, "g1")
    out = JPippenger(jops, sc.shape[-1], nbits, c=8)(JPointVec(planes), sc)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("bits,L", [(128, 8), (253, 16), (377, 24)])
def test_signed_digits_equal_reference(bits, L):
    rnd = random.Random(bits)
    ks = [rnd.randrange(1 << bits) for _ in range(40)] + [0, 1, (1 << bits) - 1]
    sc = np.ascontiguousarray(ints_to_limbs_batch(ks, L).T)
    (ti, tn), (ji, jn) = signed_digits_host(sc, bits, c=8), j_digits(sc, bits, c=8)
    assert ti.dtype == ji.dtype and (ti == ji).all() and (tn == jn).all()
    for col, k in enumerate(ks):
        assert sum((-1 if tn[w, col] else 1) * int(ti[w, col]) << (8 * w) for w in range(ti.shape[0])) == k


def _batch(jops, B, seed):
    hc = jops.host_curve
    rnd = random.Random(seed)
    base = [hc.mul(hc.generator, rnd.randrange(1, jops.spec.r)) for _ in range(B - 1)] + [JINF]
    return base, rnd


def _oracle(hc, base, ks, r):
    acc = JINF
    for p, k in zip(base, ks):
        acc = hc.add(acc, hc.mul(p, k % r))
    return acc


def _pippenger_inputs(curve, nbits, L):
    jops, tops = jax_curve_ops(curve, "g1"), torch_curve_ops(curve, "g1")
    B = 24
    base, rnd = _batch(jops, B, 42)
    ks = [rnd.randrange(1 << nbits) for _ in range(B)]
    sc = np.ascontiguousarray(ints_to_limbs_batch(ks, L).T)
    pv = {k: np.asarray(v) for k, v in jops.from_affine_host(base).items()}
    got = PippengerMSM(tops, B, nbits, c=8)(pointvec_from_reference(pv), sc)
    assert repr(tops.to_affine_host(got)[0]) == repr(_oracle(jops.host_curve, base, ks, jops.spec.r))
    return pv, sc, got


@pytest.mark.parametrize("curve,nbits,L", [("bls12_377", 128, 8)])
def test_pippenger_equals_reference_and_host(curve, nbits, L):
    """B = 24 with an infinity point, the RLC width: the port's bucket MSM
    returns the JAX package's projective point limb for limb, and the host
    oracle's sum."""
    pv, sc, got = _pippenger_inputs(curve, nbits, L)
    want = _in_fresh_interpreter("_jax_pippenger", curve, pv, sc, nbits)
    g = pointvec_to_reference(got)
    assert all((g[k] == want[k]).all() for k in "xyz")


@pytest.mark.parametrize("curve,nbits,L", [("bls12_377", 253, 16)])
def test_pippenger_equals_host(curve, nbits, L):
    """B = 24 with an infinity point, scalars of the full Fr width (32
    windows): the port's bucket MSM against the host oracle (the JAX
    package's is compiled once, at the RLC width above)."""
    _pippenger_inputs(curve, nbits, L)


@pytest.mark.parametrize("curve,group", [("bls12_377", "g1"), ("bw6_761", "g2"), ("bls12_377", "g2")])
def test_msm_public_below_pippenger_min_equals_host(curve, group):
    """The windowed ladder + tree reduction below PIPPENGER_MIN, against the
    host oracle, with the RLC scalars the JAX package draws from the same
    seed."""
    tops = torch_curve_ops(curve, group)
    hc = tops.host_curve
    B = 5
    rnd = random.Random(11)
    base = [hc.mul(hc.generator, rnd.randrange(1, tops.spec.r)) for _ in range(B - 1)]
    from snark_setup_tpu_torch.curves.host import INFINITY

    base.append(INFINITY)
    sc = tmsm.rlc_scalars_padded(B - 2, B, rng=random.Random(3))
    assert (sc == jmsm.rlc_scalars_padded(B - 2, B, rng=random.Random(3))).all()
    assert B < tmsm.PIPPENGER_MIN
    from snark_setup_tpu_torch.fields.limb import limbs_batch_to_ints

    ks = limbs_batch_to_ints(sc.T)
    got = tmsm.msm_public(tops, tops.from_affine_host(base, "cpu"), sc, tmsm.RLC_BITS)
    want = INFINITY
    for p, k in zip(base, ks):
        want = hc.add(want, hc.mul(p, k))
    assert tops.to_affine_host(got) == [want]


@pytest.mark.parametrize("curve,group", [("bls12_377", "g1"), ("bw6_761", "g2")])
def test_curve_msm_equals_host(curve, group):
    """CurveOps.msm (the GLV scalar-mul of subgroup points, then the tree
    reduction) against the host oracle, scalars of the full Fr width."""
    tops = torch_curve_ops(curve, group)
    hc, r = tops.host_curve, tops.spec.r
    rnd = random.Random(5)
    base = [hc.mul(hc.generator, rnd.randrange(1, r)) for _ in range(3)]
    ks = [rnd.randrange(r) for _ in range(3)]
    from snark_setup_tpu_torch.fields.limb import ints_to_limbs_batch as t_limbs

    sc = torch.from_numpy(t_limbs(ks, tops.fr.L).T.astype(np.int32))
    got = tops.msm(tops.from_affine_host(base, "cpu"), sc)
    from snark_setup_tpu_torch.curves.host import INFINITY

    want = INFINITY
    for p, k in zip(base, ks):
        want = hc.add(want, hc.mul(p, k))
    assert tops.to_affine_host(got) == [want]
