"""The bounded dispatch pipelines (utils/pipeline.py) and what they rest on,
on the CPU.

- The helper: at most `depth` finishes pending, first in first out, a final
  flush; after an exception no pending finish runs.
- The loops run through it at the JAX package's depths: `computation` at 4
  and `_mul_query` at 4 (`flush(limit=3)`), with the scalar-mul replaced by
  the identity so that only reads and write-backs run, their bytes equal
  to the same loops at depth 1; `verification` and
  `aggregate_verification` at 3 (`limit=2`).
- The two-fault rejections: a response with a deferred fault (a point
  outside the subgroup in tau_g1, or two tau_g1 powers swapped) and a read
  fault (a point at infinity in the next section) raises the class the JAX
  package raises, the read's: its checks of a section run after the reads
  of the next two. The JAX side runs in a fresh interpreter (its compiles
  stay out of the pytest worker, as in tests/test_torch_verify.py).
- The inversion's plain chain (ops/cuda_sqrt.py: fq_pow_plain at q - 2)
  equals the host inversion that `FpOps.inv` keeps on the CPU, on all five
  base fields.
- `write_batch_start` then `write_batch_finish` gives `write_batch`'s bytes.

Exact equality throughout (bytes, limbs, exception classes).
"""

import os
import pickle
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from snark_setup_tpu_torch.curves.host import INFINITY, g1_curve, g2_curve
from snark_setup_tpu_torch.ops.codec import batch_codec
from snark_setup_tpu_torch.ops.cuda_sqrt import fq_inv_for, fq_pow_plain
from snark_setup_tpu_torch.phase1 import protocol
from snark_setup_tpu_torch.phase1.buffers import split
from snark_setup_tpu_torch.phase1.parameters import Phase1Parameters
from snark_setup_tpu_torch.phase1.protocol import Phase1
from snark_setup_tpu_torch.phase1.testing import generate_input, generate_output, two_fault_response
from snark_setup_tpu_torch.phase2 import chunked
from snark_setup_tpu_torch.serialize.arkworks import g1_codec, g2_codec
from snark_setup_tpu_torch.shard import runtime
from snark_setup_tpu_torch.transcript.hashing import blank_hash, derive_rng_from_seed
from snark_setup_tpu_torch.utils import enums as te
from snark_setup_tpu_torch.utils.pipeline import Pipeline, recording

# several pytest workers share the host: one intra-op thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CURVES = ["bls12_377", "bls12_381", "bw6_761", "mnt4_753", "mnt6_753"]
POWER, BATCH = 2, 4  # tau_g1 [0, 4) then [3, 7): one batch holds index 2 of every section
RLC_SEED = 7


# -- the helper --------------------------------------------------------------


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_pipeline_bounds_pending_finishes_in_fifo_order(depth):
    ran, seen = [], []
    with Pipeline(depth, "t") as pipe:
        for i in range(7):
            pipe.push(lambda i=i: ran.append(i))
            seen.append(len(pipe._pending))
            # the finish of push i - depth + 1 ran, no later one
            assert ran == list(range(max(0, i - depth + 2)))
    assert ran == list(range(7))
    assert max(seen) <= depth - 1 and pipe.high_water == depth and pipe.pushes == 7


def test_pipeline_drops_pending_finishes_after_an_exception():
    ran, out = [], bytearray(4)

    def write(i):
        def finish():
            if i == 1:
                raise ValueError("check of batch 1 failed")
            out[i] = 1
            ran.append(i)
        return finish

    with recording() as runs, pytest.raises(ValueError):
        with Pipeline(2, "t") as pipe:
            for i in range(4):
                pipe.push(write(i))
    assert ran == [0] and out == bytearray([1, 0, 0, 0])
    assert runs == [dict(name="t", depth=2, pushes=3, high_water=2, finish_seconds=runs[0]["finish_seconds"],
                         completed=False)]
    # an exception in the loop body itself: nothing pending runs
    ran.clear()
    with pytest.raises(KeyError):
        with Pipeline(3, "t") as pipe:
            pipe.push(lambda: ran.append(0))
            pipe.push(lambda: ran.append(1))
            raise KeyError("read failed")
    assert ran == []


# -- the loops at the reference's depths ---------------------------------------


def _identity_scalar_mul(monkeypatch):
    monkeypatch.setattr(runtime, "scalar_mul", lambda ops, pts, scalars, device=None: pts)


@pytest.mark.parametrize("compression", ["YES", "NO"])
def test_computation_runs_at_depth_4_and_writes_what_depth_1_writes(monkeypatch, compression):
    """With the scalar-mul as the identity every section of the response is
    its challenge's points re-encoded; at depth 4 and at depth 1 alike."""
    _identity_scalar_mul(monkeypatch)
    comp = te.UseCompression[compression]
    params = Phase1Parameters.new_full("bls12_377", te.ProvingSystem.GROTH16, POWER, BATCH)  # 5 batches
    inp = generate_input(params, comp)
    _, key = Phase1.key_generation(params.spec, derive_rng_from_seed(b"pipeline"), blank_hash())
    outs = []
    for depth in (protocol.PIPELINE_DEPTH, 1):
        monkeypatch.setattr(protocol, "PIPELINE_DEPTH", depth)
        out = generate_output(params, comp)
        with recording() as runs:
            Phase1.computation(inp, out, comp, comp, te.CheckForCorrectness.NO, te.BatchExpMode.AUTO, key,
                               params, device="cpu")
        (run,) = runs
        assert (run["name"], run["depth"], run["high_water"]) == ("computation", depth, depth)
        outs.append(bytes(out))
    assert protocol.PIPELINE_DEPTH == 1  # the first pass ran at the module's depth, 4
    assert outs[0] == outs[1]
    for name in ("tau_g1", "tau_g2", "alpha_g1", "beta_g1"):
        s = split(params, comp)[name]
        assert bytes(s.slice_of(outs[0])) == bytes(s.slice_of(inp)), name


def test_mul_query_runs_at_depth_4_and_writes_what_depth_1_writes(monkeypatch):
    """`_batched_mul_inplace` over 6 batches of one point vector, the
    scalar-mul as the identity: the buffer comes back unchanged."""
    _identity_scalar_mul(monkeypatch)
    spec = batch_codec("bls12_377", "g1", "cpu").spec
    hc, codec = g1_curve(spec), g1_codec(spec)
    pts = [hc.mul(hc.generator, 3 + i) for i in range(11)] + [INFINITY]
    buf = bytearray(b"\xab" * 5 + b"".join(codec.serialize(p, te.UseCompression.YES) for p in pts))
    span = chunked._VecSpan(offset=5, count=len(pts), el_size=codec.size(te.UseCompression.YES))
    before = bytes(buf)
    for depth in (chunked.MUL_QUERY_DEPTH, 1):
        monkeypatch.setattr(chunked, "MUL_QUERY_DEPTH", depth)
        with recording() as runs:
            chunked._batched_mul_inplace(spec, buf, span, 5, 2, te.UseCompression.YES, te.CheckForCorrectness.NO,
                                         "cpu")
        assert runs == [dict(name="mul_query", depth=depth, pushes=6, high_water=depth,
                             finish_seconds=runs[0]["finish_seconds"], completed=True)]
        assert bytes(buf) == before


# -- the two-fault rejections ---------------------------------------------------


def _raised(fn):
    try:
        fn()
    except Exception as e:  # the class is what both packages must agree on
        return e
    raise AssertionError("accepted")


def _classes(e) -> list[str]:
    return [c.__name__ for c in type(e).__mro__[:-2]]


def _port_rejection(kind: str, t: dict):
    from snark_setup_tpu_torch.phase1.keys import PublicKey

    params = Phase1Parameters.new_full("bls12_377", te.ProvingSystem.GROTH16, POWER, BATCH)
    if kind == "verification":
        return _raised(lambda: Phase1.verification(
            t["input"], t["output"], generate_output(params, te.UseCompression.NO),
            PublicKey.deserialize(params.spec, t["key"]), t["digest"],
            te.UseCompression.NO, te.UseCompression.YES, te.UseCompression.NO,
            te.CheckForCorrectness.NO, te.CheckForCorrectness.FULL, te.SubgroupCheckMode.AUTO, True, params,
            rlc_rng=random.Random(RLC_SEED), device="cpu"))
    return _raised(lambda: Phase1.aggregate_verification(
        t["output"], te.UseCompression.NO, te.CheckForCorrectness.FULL, params,
        rlc_rng=random.Random(RLC_SEED), device="cpu"))


def _jax_rejection(kind: str, t: dict) -> tuple[str, list[str]]:
    """The JAX package on the same response: (class name, MRO names)."""
    from snark_setup_tpu.phase1.keys import PublicKey
    from snark_setup_tpu.phase1.parameters import Phase1Parameters as JParams
    from snark_setup_tpu.phase1.protocol import Phase1 as JPhase1
    from snark_setup_tpu.utils import enums as je

    jp = JParams.new_full("bls12_377", je.ProvingSystem.GROTH16, POWER, BATCH)
    if kind == "verification":
        new = bytearray(jp.get_length(je.UseCompression.NO))
        e = _raised(lambda: JPhase1.verification(
            t["input"], t["output"], new, PublicKey.deserialize(jp.spec, t["key"]), t["digest"],
            je.UseCompression.NO, je.UseCompression.YES, je.UseCompression.NO,
            je.CheckForCorrectness.NO, je.CheckForCorrectness.FULL, je.SubgroupCheckMode.AUTO, True, jp,
            rlc_rng=random.Random(RLC_SEED)))
    else:
        e = _raised(lambda: JPhase1.aggregate_verification(
            t["output"], je.UseCompression.NO, je.CheckForCorrectness.FULL, jp, rlc_rng=random.Random(RLC_SEED)))
    return type(e).__name__, _classes(e)


def _in_fresh_interpreter(name, *args):
    """`name(*args)` of this module in a new Python process set up as
    tests/conftest.py sets up this one; arguments and result pickled."""
    code = (
        "import pickle, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import tests.conftest\n"
        "import tests.test_torch_pipeline as m\n"
        f"out = m.{name}(*pickle.loads(sys.stdin.buffer.read()))\n"
        "sys.stdout.buffer.write(pickle.dumps(out))\n"
    )
    done = subprocess.run([sys.executable, "-c", code], input=pickle.dumps(args), capture_output=True,
                          cwd=REPO, timeout=600)
    if done.returncode != 0:
        raise RuntimeError(f"{name} failed (rc {done.returncode}):\n{done.stderr.decode()[-3000:]}")
    return pickle.loads(done.stdout)  # written by this test run


@pytest.mark.parametrize("kind", ["verification", "aggregate_verification"])
def test_two_fault_rejection_raises_the_reference_exception_class(kind):
    t = two_fault_response(kind)
    want_name, want_mro = _in_fresh_interpreter("_jax_rejection", kind, t)
    with recording() as runs:
        et = _port_rejection(kind, t)
    assert want_name == "PointAtInfinityError"  # the read of the second section, in the JAX package
    assert type(et).__name__ == want_name, et
    assert _classes(et) == want_mro
    # the deferred check of the first section was queued, never run
    (run,) = runs
    assert (run["name"], run["depth"], run["pushes"], run["completed"]) == (kind, 3, 1, False)


# -- the inversion and the write-back halves -------------------------------------


@pytest.mark.parametrize("curve", CURVES)
def test_inversion_plain_chain_equals_the_host_inversion(curve):
    """fq_pow_plain at q - 2 (the kernel's chain) against FpOps.inv's host
    inversion on the CPU: 0, 1, q - 1 and random elements, two lanes a
    call (the kernel's callers invert one element or a few)."""
    fq = batch_codec(curve, "g1", "cpu").fp
    q = fq.modulus
    rng = np.random.default_rng(CURVES.index(curve))
    rand = [int.from_bytes(rng.bytes(q.bit_length() // 8 + 8), "little") % q for _ in range(2)]
    K = fq_inv_for(q)
    for pair in ([0, 1], [q - 1, rand[0]], [rand[1], 0]):
        a = fq.tensor(fq.from_int(pair), "cpu")
        want = fq.inv(a)
        assert torch.equal(fq_pow_plain(fq, q - 2, a), want)
        before = K.plain_calls
        assert torch.equal(K(a), want) and K.plain_calls == before + 1
    inv = fq.to_int(fq.inv(fq.tensor(fq.from_int([0, 1, q - 1, rand[0]]), "cpu")))
    assert inv[:3] == [0, 1, q - 1] and inv[3] * rand[0] % q == 1
    assert K.products() == (q - 2).bit_length() - 1 + bin(q - 2).count("1") - 1


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("compression", ["YES", "NO"])
def test_write_batch_halves_give_write_batch_bytes(group, compression):
    codec = batch_codec("bls12_377", group, "cpu")
    comp = te.UseCompression[compression]
    hc = g2_curve(codec.spec) if group == "g2" else g1_curve(codec.spec)
    pts = codec.ops.from_affine_host([hc.mul(hc.generator, 7 + i) for i in range(3)] + [INFINITY], "cpu")
    # projective with Z != 1: normalize runs its batch inversion
    z = codec.F.ones((4,), "cpu")
    z = codec.F.add(z, z)
    proj = type(pts)(x=codec.F.mul(pts["x"], z), y=codec.F.mul(pts["y"], z),
                     z=codec.F.select(codec.ops.is_infinity(pts), pts["z"], z))
    handle = codec.write_batch_start(proj)
    assert handle.event is None and handle.pool is None  # on the CPU: the outputs themselves
    got = codec.write_batch_finish(handle, comp, n_valid=3)
    assert got == codec.write_batch(proj, comp, n_valid=3)
    size = codec.size(comp)
    hostc = g2_codec(codec.spec) if group == "g2" else g1_codec(codec.spec)
    assert got == b"".join(hostc.serialize(hc.mul(hc.generator, 7 + i), comp) for i in range(3))
    assert len(got) == 3 * size
