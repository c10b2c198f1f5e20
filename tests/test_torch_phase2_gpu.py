"""The phase-2 device paths on the card against their plain versions: the
group FFT (K3 + K4 on Fq coordinates, K3 + the ladder over the group law on
BLS12-377 G2; K2 or K5 rounds for the adds), the h-query, the QAP row sums
and the constant-time MSM, each equal limb for limb (tolerance 0) to the same
call with every kernel replaced by its plain PyTorch version on the same
CUDA tensors, and the transforms also to the host scalar oracle.

These tests need an NVIDIA GPU and nvcc: they are marked `gpu`, decide inside
the test whether a card is present, and skip without one. Also on the card:
the streaming contribution (`phase2/chunked.py`) equal byte for byte to the
same contribution on the CPU, and the device mesh over two entries of the
card (`shard/mesh.py`, and the runtime's mesh paths in a phase-1 ceremony
and a streaming phase-2 contribution) equal to the single-device results.
Run them on the machine with the card:

    python -m pytest tests/test_torch_phase2_gpu.py -q -m gpu
"""

import copy
import random

import pytest
import torch

from snark_setup_tpu_torch.curves.constants import get_curve
from snark_setup_tpu_torch.curves.host import INFINITY, g1_curve, g2_curve
from snark_setup_tpu_torch.fields.limb import ints_to_limbs_batch
from snark_setup_tpu_torch.ntt import GroupFFT, Radix2Domain, h_query_device
from snark_setup_tpu_torch.ops.cuda_glv import glv_digits_for, glv_digits_plain
from snark_setup_tpu_torch.ops.cuda_ladder import glv_ladder_plain
from snark_setup_tpu_torch.ops.curve import PointVec, curve_ops, plain_group_law
from snark_setup_tpu_torch.ops.msm import msm_secret
from snark_setup_tpu_torch.phase1.parameters import Phase1Parameters
from snark_setup_tpu_torch.phase1.protocol import Phase1
from snark_setup_tpu_torch.phase1.testing import generate_output, setup_verify
from snark_setup_tpu_torch.phase2 import chunked
from snark_setup_tpu_torch.phase2.keypair import Keypair, Phase2PublicKey
from snark_setup_tpu_torch.phase2.parameters import MPCParameters, ProvingKey, VerifyingKey
from snark_setup_tpu_torch.phase2.polynomial import dot_product_vec, process_matrix
from snark_setup_tpu_torch.phase2.r1cs import TestCircuit, TestParallelCircuit, circuit_to_qap
from snark_setup_tpu_torch.shard import mesh as mesh_mod
from snark_setup_tpu_torch.shard import runtime
from snark_setup_tpu_torch.shard.mesh import make_mesh, sharded_group_ifft_fn, sharded_step_fn
from snark_setup_tpu_torch.transcript.hashing import derive_rng_from_seed
from snark_setup_tpu_torch.utils.enums import CheckForCorrectness, ProvingSystem, SubgroupCheckMode, UseCompression

GROUPS = [("bw6_761", "g1"), ("bw6_761", "g2"), ("bls12_377", "g2")]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _plain(ops):
    """A copy of `ops` whose group law, products and scalar-mul are the plain
    versions on any device: no kernel launch."""
    plain = copy.copy(plain_group_law(ops))

    def scalar_mul(p, scalars):
        d1, d2, neg1, flip = glv_digits_plain(ops, scalars)
        if ops.field.degree == 1:
            return glv_ladder_plain(ops, p, d1, d2, neg1, flip)
        return plain._glv_ladder(p, d1, d2, neg1.bool(), flip.bool())

    plain.scalar_mul = scalar_mul
    return plain


def _oracle(ops, coeffs, dev) -> PointVec:
    """[c_j] G for every lane, by the card's batch scalar-mul."""
    hc = ops.host_curve
    g = ops.from_affine_host([hc.generator], dev)
    base = PointVec({k: v.expand(*v.shape[:-1], len(coeffs)).contiguous() for k, v in g.items()})
    return ops.scalar_mul(base, ops.fr.tensor(ints_to_limbs_batch(coeffs, ops.fr.L).T, dev))


def _equal(a: PointVec, b: PointVec) -> bool:
    return all(torch.equal(a[k], b[k]) for k in "xyz")


@pytest.mark.gpu
@pytest.mark.parametrize("n", [8, 1 << 12, 1 << 14])
@pytest.mark.parametrize("curve,group", GROUPS)
def test_group_fft_equals_plain_version_on_the_card(curve, group, n):
    dev = _card()
    ops = curve_ops(curve, group)
    dom = Radix2Domain(curve, n)
    rnd = random.Random(n)
    ks = [rnd.randrange(1, ops.spec.r) for _ in range(n)]
    with torch.no_grad():
        pts = _oracle(ops, ks, dev)
        f, fp = GroupFFT(ops, dom), GroupFFT(_plain(ops), dom)
        dig = glv_digits_for(curve, group)
        n_dig = dig.launches
        for direction, scalar in (("ifft", dom.ifft), ("fft", dom.fft)):
            got = getattr(f, direction)(pts)
            torch.cuda.synchronize()
            assert _equal(got, getattr(fp, direction)(pts)), direction
            assert ops.to_affine_host(ops.add(got, ops.neg(_oracle(ops, scalar(ks), dev)))) == [INFINITY] * n
        assert dig.launches > n_dig


@pytest.mark.gpu
@pytest.mark.parametrize("curve,group", [("bw6_761", "g1")])
def test_h_query_equals_plain_version_on_the_card(curve, group):
    dev = _card()
    ops = curve_ops(curve, group)
    m = 1 << 12
    rnd = random.Random(3)
    with torch.no_grad():
        pts = _oracle(ops, [rnd.randrange(ops.spec.r) for _ in range(2 * m - 1)], dev)
        assert _equal(h_query_device(ops, pts, m), h_query_device(_plain(ops), pts, m))


@pytest.mark.gpu
@pytest.mark.parametrize("circuit", [TestCircuit(), TestParallelCircuit(300)], ids=["x2", "parallel300"])
@pytest.mark.parametrize("curve,group", GROUPS)
def test_dot_product_vec_equals_plain_version_on_the_card(curve, group, circuit):
    dev = _card()
    ops = curve_ops(curve, group)
    cs = circuit_to_qap(circuit, ops.spec.r)
    a, b, _ = cs.to_matrices()
    nv = cs.num_instance_variables + cs.num_witness_variables
    m = Radix2Domain(curve, max(cs.num_constraints, nv)).size
    rnd = random.Random(9)
    with torch.no_grad():
        coeff_points = ops.to_affine_host(_oracle(ops, [rnd.randrange(1, ops.spec.r) for _ in range(m)], dev))
        for mat in (a, b):
            rows = process_matrix(mat, nv)
            assert dot_product_vec(ops, coeff_points, rows, dev) == dot_product_vec(
                _plain(ops), coeff_points, rows, dev)


@pytest.mark.gpu
@pytest.mark.parametrize("curve,group", GROUPS)
def test_msm_secret_equals_plain_version_on_the_card(curve, group):
    dev = _card()
    ops = curve_ops(curve, group)
    rnd = random.Random(11)
    B = 1000
    ks = [0, 1, ops.spec.r - 1] + [rnd.randrange(ops.spec.r) for _ in range(B - 3)]
    with torch.no_grad():
        pts = _oracle(ops, [rnd.randrange(1, ops.spec.r) for _ in range(B)], dev)
        raw = ints_to_limbs_batch(ks, ops.fr.L).T
        got = msm_secret(ops, pts, raw)
        assert _equal(got, msm_secret(_plain(ops), pts, raw))


def _mpc_file(curve: str, n: int, comp: UseCompression) -> bytes:
    """MPCParameters bytes with n h points and n - 1 L points (a walk of
    host additions from the generator), empty a / b queries."""
    spec = get_curve(curve)
    c1, c2 = g1_curve(spec), g2_curve(spec)
    step, p, walk = c1.mul(c1.generator, 7), c1.mul(c1.generator, 5), []
    for _ in range(2 * n - 1):
        walk.append(p)
        p = c1.add(p, step)
    vk = VerifyingKey(c1.generator, c2.generator, c2.generator, c2.generator, [c1.generator])
    pk = ProvingKey(vk, c1.generator, c1.generator, [], [], [], walk[:n], walk[n:])
    return MPCParameters(spec, pk, bytes(range(64)), []).write(comp, "cpu")


def _chunked_on(where, data: bytes, batch: int, comp: UseCompression):
    spec = get_curve("bls12_377")
    buf = bytearray(data)
    h = chunked.contribute(spec, buf, derive_rng_from_seed(SEED_CHUNKED), batch, comp, CheckForCorrectness.FULL,
                           device=where)
    return h, bytes(buf)


SEED_CHUNKED = b"\x11" * 32


@pytest.mark.gpu
@pytest.mark.parametrize("comp", ["NO", "YES"])
@pytest.mark.parametrize("n,batch", [(1, 4), (33, 16)])
def test_chunked_contribute_on_the_card_equals_the_cpu(n, batch, comp):
    """The streaming contribution on BLS12-377 (K3 + K4 on the card, the
    plain versions on the CPU) at 1 and 33 points, the last batch of the
    33 ragged (33 = 2 x 16 + 1): the same bytes and hash."""
    dev = _card()
    spec, c = get_curve("bls12_377"), UseCompression[comp]
    data = _mpc_file("bls12_377", n, c) + bytes(Phase2PublicKey.size(spec))
    dig = glv_digits_for("bls12_377", "g1")
    launches = dig.launches
    on_card = _chunked_on(dev, data, batch, c)
    assert dig.launches - launches == -(-n // batch) + -(-(n - 1) // batch)  # one per batch of h, L
    assert on_card == _chunked_on("cpu", data, batch, c)
    assert on_card[1] != data


@pytest.mark.gpu
@pytest.mark.parametrize("comp", ["NO", "YES"])
def test_chunked_contribute_on_the_card_at_4097_points(comp):
    """4097 h and 4096 L points in batches of 1024 (the last of h ragged):
    the same bytes and hash as the object API on the card (read,
    contribute, write: one slice of MAX_LANES), and h[i], L[i] =
    delta^-1 times the input at the first, the last and two inner indices
    (host oracle). The plain versions take minutes on the CPU at this
    width, so they are held against the kernels at 1 and 33 points above."""
    dev = _card()
    spec, c = get_curve("bls12_377"), UseCompression[comp]
    n = 4097
    data = _mpc_file("bls12_377", n, c)
    h, buf = _chunked_on(dev, data + bytes(Phase2PublicKey.size(spec)), 1024, c)
    obj = MPCParameters.read(spec, data, c, device=dev)
    before = MPCParameters.read(spec, data, c, device=dev)
    assert obj.contribute(derive_rng_from_seed(SEED_CHUNKED), dev) == h
    assert obj.write(c, dev) == buf
    kp = Keypair.new(spec, derive_rng_from_seed(SEED_CHUNKED), before.params.delta_g1, before.cs_hash, [])
    delta_inv = pow(kp.private_key.delta, -1, spec.r)
    g1 = g1_curve(spec)
    for i in (0, 1024, 2048, n - 2):
        assert obj.params.h_query[i] == g1.mul(before.params.h_query[i], delta_inv)
        assert obj.params.l_query[i] == g1.mul(before.params.l_query[i], delta_inv)
    assert obj.params.h_query[n - 1] == g1.mul(before.params.h_query[n - 1], delta_inv)


@pytest.mark.gpu
@pytest.mark.parametrize("curve,B", [("bls12_377", 16384), ("bls12_377", 16385), ("bw6_761", 33)])
def test_sharded_step_on_a_mesh_of_the_card_equals_one_device(curve, B):
    """sharded_step_fn over two entries of the one card: the products limb
    for limb, the total as a point, equal to the single-device ones."""
    dev = _card()
    ops = curve_ops(curve, "g1")
    rnd = random.Random(B)
    with torch.no_grad():
        pts = _oracle(ops, [rnd.randrange(1, ops.spec.r) for _ in range(B)], dev)
        sc = ops.fr.tensor(ints_to_limbs_batch([rnd.randrange(ops.spec.r) for _ in range(B)], ops.fr.L).T, dev)
        prods, total = sharded_step_fn(ops, make_mesh(devices=[dev, dev]))(pts, sc)
        single = ops.scalar_mul(pts, sc)
        assert _equal(prods, single)
        assert ops.to_affine_host(total) == ops.to_affine_host(ops.sum_reduce(single))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [8, 1 << 12])
def test_sharded_group_ifft_on_a_mesh_of_the_card_equals_one_device(n):
    dev = _card()
    ops = curve_ops("bw6_761", "g1")
    rnd = random.Random(n + 1)
    with torch.no_grad():
        pts = _oracle(ops, [rnd.randrange(1, ops.spec.r) for _ in range(n)], dev)
        want = GroupFFT(ops, Radix2Domain("bw6_761", n)).ifft(pts)
        assert _equal(sharded_group_ifft_fn("bw6_761", "g1", n, make_mesh(devices=[dev, dev]))(pts), want)


def _mesh_run(dev):
    """A phase-1 contribution on BLS12-377 (power 3: 15 tau_g1 powers in
    batches of 4, the last ragged), its verification with the Direct and the
    Batched subgroup checks, and a streaming phase-2 contribution at 33
    points: the response, both new challenges, and the phase-2 hash and
    bytes."""
    params = Phase1Parameters.new_full("bls12_377", ProvingSystem.GROTH16, 3, 4)
    inp, out, pubkey, _, digest = setup_verify(UseCompression.NO, CheckForCorrectness.NO, UseCompression.YES,
                                               params, device=dev)
    news = []
    for mode in (SubgroupCheckMode.DIRECT, SubgroupCheckMode.BATCHED):
        new_challenge = generate_output(params, UseCompression.NO)
        Phase1.verification(inp, out, new_challenge, pubkey, digest, UseCompression.NO, UseCompression.YES,
                            UseCompression.NO, CheckForCorrectness.NO, CheckForCorrectness.FULL, mode, True,
                            params, rlc_rng=random.Random(7), device=dev)
        news.append(bytes(new_challenge))
    spec = get_curve("bls12_377")
    data = _mpc_file("bls12_377", 33, UseCompression.YES) + bytes(Phase2PublicKey.size(spec))
    return bytes(out), news, _chunked_on(dev, data, 16, UseCompression.YES)


@pytest.mark.gpu
def test_runtime_on_a_mesh_of_the_card_equals_one_device(monkeypatch):
    """The runtime's mesh paths as a multi-card host runs them, over two
    entries of the one card: `scalar_mul` per shard (phase-1 contribute and
    chunked.contribute), and `put_points`, `all_over`, `reduce_over` and
    `gather` in phase-1 verification. The same bytes as on one device."""
    dev = _card()
    runtime.reset_mesh_cache()
    try:
        single = _mesh_run(dev)
        calls = {"shard_points": 0, "sharded_batch_exp_fn": 0, "reduce_partials": 0}
        for name in calls:
            orig = getattr(mesh_mod, name)

            def counted(*a, _orig=orig, _name=name, **k):
                calls[_name] += 1
                return _orig(*a, **k)

            monkeypatch.setattr(mesh_mod, name, counted)
        runtime._mesh_cache["cuda"] = make_mesh(devices=[dev, dev])
        assert runtime.mesh_size(dev) == 2
        meshed = _mesh_run(dev)
    finally:
        runtime.reset_mesh_cache()
    assert all(calls.values()), calls
    assert meshed == single


@pytest.mark.gpu
def test_bls12_377_sha256_chain_on_the_card(tmp_path):
    """The SHA-256 circuit's phase 2 on BLS12-377, the phase-2 CLI's default
    curve, through `chip_smoke.py`'s phases and checks: a power-16
    contribution through the phase-1 CLI, its verification
    (`verify-and-transform-pok-and-correctness` + `-ratios`), then
    `circuit_main create --complex`, `prepare_phase2` at domain 2^16, `new`
    in 2 chunks, two participants per chunk, verify, the response with one L
    point replaced rejected by the L ratio check, `combine` (Lagrange sums,
    h query, hash chain, combined contributions). K3 + K4 and K2 on G1, K3
    on G2 and K5 (G2 over Fp2) launch in the phase-2 steps. One JSON line a
    step on the standard output (run with -s for the walls)."""
    import time

    import chip_smoke as S
    from snark_setup_tpu_torch.ops.cuda_group import group_ops_for
    from snark_setup_tpu_torch.ops.cuda_ladder import fused_ladder_for
    from snark_setup_tpu_torch.ops.cuda_mul import stacked_mul_for

    dev = _card()
    power, work = 16, str(tmp_path)
    with torch.no_grad():
        S.contribute_phase(dev, "bls12_377", power, S.BATCH, {}, picks=2, workdir=work)
        t0 = time.perf_counter()
        S.verify_phase(dev, "bls12_377", power, S.BATCH, work, (), {})
        t_verify = time.perf_counter() - t0
        kernels = {"glv_digits[bls12_377/g1]": glv_digits_for("bls12_377", "g1"),
                   "glv_ladder[bls12_377/g1]": fused_ladder_for("bls12_377", "g1"),
                   "group_add[bls12_377/g1]": group_ops_for("bls12_377", "g1").add_k,
                   "glv_digits[bls12_377/g2]": glv_digits_for("bls12_377", "g2"),
                   "stacked_mul[bls12_377]": stacked_mul_for(curve_ops("bls12_377", "g2").fq.modulus)}
        before = {k: (w.launches, w.plain_calls) for k, w in kernels.items()}
        t0 = time.perf_counter()
        S.phase2_phase(dev, "bls12_377", power, S.BATCH, work, kernels, "sha256", participants=2)
        t_chain = time.perf_counter() - t0
    launched = {k: w.launches - before[k][0] for k, w in kernels.items()}
    S.emit({"phase": "bls12_377 sha256 chain", "verify_seconds": t_verify, "chain_seconds": t_chain,
            "verify_and_chain_seconds": t_verify + t_chain, "launches": launched})
    assert all(n > 0 for n in launched.values()), launched
    assert all(w.plain_calls == before[k][1] for k, w in kernels.items())
