"""The port's device mesh on the CPU: `shard/mesh.py` and the mesh half of
`shard/runtime.py`, the counterparts of tests/test_shard.py and
tests/test_shard_protocol.py.

A mesh of 8 entries of the CPU device (SNARK_SETUP_SHARD=1,
SNARK_SETUP_SHARD_DEVICES=8: the counterpart of the reference tests' eight
virtual CPU devices) runs the split, pad, placement, exchange and gather
code with the plain versions:
- the sharded step, scalar-mul and MSM against the host oracle, and lane for
  lane against the single-device scalar-mul, on a full and a ragged batch;
- the distributed inverse group FFT limb for limb against the single-device
  one;
- the mesh policy;
- a seeded phase-1 contribution and its verification (Direct and Batched
  subgroup checks, RLC power pairs as per-shard MSMs): the response and the new
  challenge byte-identical with and without the mesh (the single-device
  bytes are the ones tests/test_torch_contribute.py and
  tests/test_torch_verify.py hold to the JAX package);
- the same verification over the mesh rejecting a response with two tau_g1
  powers swapped, and its subgroup check rejecting an out-of-subgroup
  point, with the exception class and message one device raises.
Exact equality throughout (tolerance 0)."""

import random

import numpy as np
import pytest
import torch

from snark_setup_tpu_torch.fields.limb import ints_to_limbs_batch, limbs_to_int
from snark_setup_tpu_torch.ntt.group_fft import group_fft
from snark_setup_tpu_torch.ops.curve import curve_ops
from snark_setup_tpu_torch.ops.msm import rlc_scalars_padded
from snark_setup_tpu_torch.phase1.buffers import split
from snark_setup_tpu_torch.phase1.parameters import Phase1Parameters
from snark_setup_tpu_torch.ops.codec import batch_codec
from snark_setup_tpu_torch.phase1.protocol import (
    Phase1,
    _batched_subgroup_sums,
    _check_subgroup_device,
    _power_pairs_device,
)
from snark_setup_tpu_torch.phase1.testing import generate_output, setup_verify
from snark_setup_tpu_torch.shard import runtime
from snark_setup_tpu_torch.shard.mesh import (
    Mesh,
    Sharded,
    make_mesh,
    shard_points,
    sharded_batch_exp_fn,
    sharded_group_ifft_fn,
    sharded_msm_fn,
    sharded_step_fn,
)
from snark_setup_tpu_torch.utils.enums import CheckForCorrectness, ProvingSystem, SubgroupCheckMode, UseCompression

# The suite runs several pytest workers on one host: PyTorch's intra-op
# thread pool in each would oversubscribe the cores, and its idle threads'
# spinning slows the plain versions' small operators by orders of magnitude.
torch.set_num_threads(1)

CPU = "cpu"
N_DEV = 8
POWER, BATCH = 2, 4  # 7 tau_g1 powers in batches of 4: a ragged last batch
BATCHES = [8, 9]  # one point per shard; and a ragged batch padded to 16


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(N_DEV, device=CPU)


def _example(B):
    ops = curve_ops("bls12_377", "g1")
    hc = ops.host_curve
    base = [hc.mul(hc.generator, 3 + i) for i in range(B)]
    ks = [(123456789 + 987654321 * i) % ops.spec.r for i in range(B)]
    sc = ops.fr.tensor(ints_to_limbs_batch(ks, ops.fr.L).T, CPU)
    return ops, base, ops.from_affine_host(base, CPU), ks, sc


def _host_msm(hc, base, ks):
    total = None
    for p, k in zip(base, ks):
        t = hc.mul(p, k)
        total = t if total is None else hc.add(total, t)
    return total


def _same(a, b) -> bool:
    return all(torch.equal(a[k], b[k]) for k in ("x", "y", "z"))


@pytest.mark.parametrize("B", BATCHES)
def test_sharded_step_matches_host_and_single_device(mesh, B):
    ops, base, pts, ks, sc = _example(B)
    hc = ops.host_curve
    prods, total = sharded_step_fn(ops, mesh)(pts, sc)
    assert _same(prods, ops.scalar_mul(pts, sc))
    assert ops.to_affine_host(prods) == [hc.mul(p, k) for p, k in zip(base, ks)]
    assert ops.to_affine_host(total) == [_host_msm(hc, base, ks)]


@pytest.mark.parametrize("B", BATCHES)
def test_sharded_batch_exp_and_msm_separate(mesh, B):
    ops, base, pts, ks, sc = _example(B)
    hc = ops.host_curve
    out = sharded_batch_exp_fn(ops, mesh)(pts, sc)
    assert _same(out, ops.scalar_mul(pts, sc))
    assert ops.to_affine_host(sharded_msm_fn(ops, mesh)(pts, sc)) == [_host_msm(hc, base, ks)]


@pytest.mark.parametrize("n,shards", [(8, 8), (16, 4)])
def test_sharded_group_ifft_matches_single_device(n, shards):
    """Limb for limb: with 8 shards of one point every stage exchanges, with
    4 shards of 4 points two stages are shard-local."""
    ops = curve_ops("bls12_377", "g1")
    hc = ops.host_curve
    pts = ops.from_affine_host([hc.mul(hc.generator, 5 + 7 * i) for i in range(n)], CPU)
    want = group_fft("bls12_377", "g1", n).ifft(pts)
    assert _same(sharded_group_ifft_fn("bls12_377", "g1", n, make_mesh(shards, device=CPU))(pts), want)


def test_sharded_subset_sums_and_pairs_equal_single_device(mesh):
    """The runtime's cross-shard reductions on a ragged batch (9 points,
    padded to 16): the subset sums of the batched subgroup check equal the
    single-device sums, and the RLC power pairs (two public-scalar MSMs,
    sum s_i v_i and sum s_i v_(i+1)) equal the host oracle with and without
    the mesh."""
    ops, base, pts, ks, sc = _example(9)
    hc = ops.host_curve
    bits = np.random.default_rng(3).integers(0, 2, (5, 9)).astype(bool)
    single = _batched_subgroup_sums(ops, pts, bits)
    sharded = runtime.reduce_over(ops, lambda p, b: _batched_subgroup_sums(ops, p, b),
                                  shard_points(mesh, ops, pts), bits)
    assert ops.to_affine_host(sharded) == ops.to_affine_host(single)
    scalars = rlc_scalars_padded(8, 8, rng=random.Random(5))
    s = [limbs_to_int(scalars[:, i]) for i in range(8)]
    want = (_host_msm(hc, base[:-1], s), _host_msm(hc, base[1:], s))
    assert _power_pairs_device(ops, pts, scalars) == want
    assert _power_pairs_device(ops, shard_points(mesh, ops, pts), scalars) == want


@pytest.fixture
def sharded_env(monkeypatch):
    """A mesh of N_DEV entries of the CPU device for one test."""
    monkeypatch.setenv("SNARK_SETUP_SHARD", "1")
    monkeypatch.setenv("SNARK_SETUP_SHARD_DEVICES", str(N_DEV))
    runtime.reset_mesh_cache()
    yield
    monkeypatch.delenv("SNARK_SETUP_SHARD", raising=False)
    monkeypatch.delenv("SNARK_SETUP_SHARD_DEVICES", raising=False)
    runtime.reset_mesh_cache()


def test_mesh_activates_on_optin(sharded_env):
    m = runtime.active_mesh(CPU)
    assert isinstance(m, Mesh) and m.size == N_DEV
    assert runtime.mesh_size(CPU) == N_DEV
    assert runtime.pad_width(BATCH + 1, CPU) == 8
    ops, _, pts, _, sc = _example(9)
    placed = runtime.put_points(ops, pts, CPU)
    assert isinstance(placed, Sharded) and len(placed) == N_DEV and runtime.width(placed) == 9
    assert runtime._mesh.padded_width(placed) == 16
    assert _same(runtime.gather(placed), pts)
    assert _same(runtime.scalar_mul(ops, placed, runtime.put_scalars(ops, sc, CPU), CPU), ops.scalar_mul(pts, sc))


def test_mesh_policy(monkeypatch):
    """Off by default on the CPU, and with fewer than two devices; on cards
    under `auto` the largest power of two of them, bounded by
    SNARK_SETUP_SHARD_DEVICES; `0` switches it off everywhere."""
    for var in ("SNARK_SETUP_SHARD", "SNARK_SETUP_SHARD_DEVICES"):
        monkeypatch.delenv(var, raising=False)
    runtime.reset_mesh_cache()
    assert runtime.active_mesh(CPU) is None
    assert runtime.pad_width(BATCH + 1, CPU) == BATCH + 1
    monkeypatch.setenv("SNARK_SETUP_SHARD", "1")
    assert runtime._decide_mesh(torch.device(CPU)) is None  # one CPU entry
    monkeypatch.setenv("SNARK_SETUP_SHARD_DEVICES", "6")
    assert runtime._decide_mesh(torch.device(CPU)).size == 4
    card = torch.device("cuda", 0)
    monkeypatch.delenv("SNARK_SETUP_SHARD_DEVICES")
    monkeypatch.setenv("SNARK_SETUP_SHARD", "auto")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert runtime._decide_mesh(card) is None  # the one-card host
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert runtime._decide_mesh(card).devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert runtime._decide_mesh(card).size == 8
    monkeypatch.setenv("SNARK_SETUP_SHARD_DEVICES", "4")
    assert runtime._decide_mesh(card).size == 4
    monkeypatch.setenv("SNARK_SETUP_SHARD", "0")
    assert runtime._decide_mesh(card) is None
    assert make_mesh(devices=[card, card]).devices == (card, card)
    runtime.reset_mesh_cache()


def _contribution():
    """A seeded contribution on the CPU: (parameters, input, response, public
    key, digest)."""
    params = Phase1Parameters.new_full("bls12_377", ProvingSystem.GROTH16, POWER, BATCH)
    inp, out, pubkey, _, digest = setup_verify(UseCompression.NO, CheckForCorrectness.NO, UseCompression.YES,
                                               params, device=CPU)
    return params, inp, bytes(out), pubkey, digest


def _verify(t, out: bytes, mode: SubgroupCheckMode) -> bytes:
    """Verify `out` as the response to t's input; returns the new challenge."""
    params, inp, _, pubkey, digest = t
    new_challenge = generate_output(params, UseCompression.NO)
    Phase1.verification(inp, bytearray(out), new_challenge, pubkey, digest, UseCompression.NO, UseCompression.YES,
                        UseCompression.NO, CheckForCorrectness.NO, CheckForCorrectness.FULL, mode, True, params,
                        rlc_rng=random.Random(7), device=CPU)
    return bytes(new_challenge)


def _ceremony(mode: SubgroupCheckMode):
    """Seeded contribute + verify on the CPU; returns (response bytes, new
    challenge)."""
    t = _contribution()
    return t[2], _verify(t, t[2], mode)


@pytest.fixture(scope="module")
def single_device():
    """The contribution and its verification on one device."""
    runtime.reset_mesh_cache()
    t = _contribution()
    return t, (t[2], _verify(t, t[2], SubgroupCheckMode.AUTO))


@pytest.mark.parametrize("mode", ["AUTO", "BATCHED"])
def test_sharded_ceremony_bytes_identical(single_device, sharded_env, mode):
    """Over the mesh, with the Direct (AUTO below 2^12 points) or the
    Batched subgroup check: the same response and new challenge."""
    assert runtime.active_mesh(CPU).size == N_DEV
    sharded = _ceremony(SubgroupCheckMode[mode])
    assert sharded[0] == single_device[1][0], "response bytes differ under sharding"
    assert sharded[1] == single_device[1][1], "new challenge differs under sharding"


def _out_of_subgroup(spec, hc):
    """The smallest-x G1 point outside the order-r subgroup and not of
    order 2."""
    for x in range(1, 2000):
        p = hc.get_point_from_x(spec.fp(x), greatest=False)
        if p is not None and not p.y.is_zero() and not hc.in_subgroup(p):
            return p
    raise AssertionError("no out-of-subgroup point found")


def _raised(fn):
    try:
        fn()
    except Exception as e:  # class and message are what the two runs must agree on
        return type(e).__name__, str(e)
    raise AssertionError("accepted")


def test_sharded_verification_rejects_like_single_device(single_device, monkeypatch):
    """A response with tau_g1[2] and [3] swapped (in the first batch) is
    rejected over the mesh of 8 (per-shard RLC MSMs reduced across the
    shards) with the same exception class and message as on one device."""
    t = single_device[0]
    params, out = t[0], bytearray(t[2])
    sec = split(params, UseCompression.YES)["tau_g1"]
    a, b = bytes(sec.slice_of(out, 2, 3)), bytes(sec.slice_of(out, 3, 4))
    sec.slice_of(out, 2, 3)[:], sec.slice_of(out, 3, 4)[:] = b, a
    runtime.reset_mesh_cache()
    one = _raised(lambda: _verify(t, bytes(out), SubgroupCheckMode.AUTO))
    monkeypatch.setenv("SNARK_SETUP_SHARD", "1")
    monkeypatch.setenv("SNARK_SETUP_SHARD_DEVICES", str(N_DEV))
    runtime.reset_mesh_cache()
    try:
        assert runtime.active_mesh(CPU).size == N_DEV
        meshed = _raised(lambda: _verify(t, bytes(out), SubgroupCheckMode.AUTO))
    finally:
        monkeypatch.delenv("SNARK_SETUP_SHARD")
        monkeypatch.delenv("SNARK_SETUP_SHARD_DEVICES")
        runtime.reset_mesh_cache()
    assert one == ("InvalidRatioError", "invalid ratio: Power pairs tau_g1"), one
    assert meshed == one


@pytest.mark.parametrize("mode", ["DIRECT", "BATCHED"])
def test_sharded_subgroup_check_rejects_like_single_device(mesh, mode):
    """verification's subgroup check on a ragged batch of 9 points cut over
    the mesh of 8 (`all_over` of the Direct masks, or subset sums reduced
    across the shards): an out-of-subgroup point in the sixth shard raises
    what one device raises, and the subgroup points alone pass."""
    codec = batch_codec("bls12_377", "g1", CPU)
    ops = codec.ops
    hc = ops.host_curve
    good = [hc.mul(hc.generator, 5 + i) for i in range(9)]
    bad = good[:5] + [_out_of_subgroup(ops.spec, hc)] + good[6:]
    for pts, want in ((bad, ("IncorrectSubgroupError", None)), (good, None)):
        single = ops.from_affine_host(pts, CPU)
        check = lambda p: _check_subgroup_device(codec, p, SubgroupCheckMode[mode], 9)
        if want is None:
            check(single)
            check(shard_points(mesh, ops, single))
            continue
        one = _raised(lambda: check(single))
        assert one[0] == want[0], one
        assert _raised(lambda: check(shard_points(mesh, ops, single))) == one
