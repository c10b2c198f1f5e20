"""The stacked product's three opt-in routes (ops/cuda_routes.py: kernels
K6, K7, K8 through their plain versions on the CPU; ops/fp.py:
redc_cols_matmul) against the JAX package's Pallas kernels in interpret mode
and its routed `mul_stacked`, and a contribution under each switch against
the JAX package's response. Exact equality (tolerance 0) throughout: these
are integers mod N and bytes."""

import hashlib
import os
import random

import numpy as np
import pytest
import torch
from filelock import FileLock

from snark_setup_tpu.ops import pallas_field
from snark_setup_tpu.ops.curve_jax import curve_ops as jax_curve_ops
from snark_setup_tpu.ops.fp_jax import fp_ops as jax_fp_ops
from snark_setup_tpu.ops.pallas_field import pallas_mul_for
from snark_setup_tpu.phase1.parameters import Phase1Parameters as JParams
from snark_setup_tpu.phase1.protocol import Phase1 as JPhase1
from snark_setup_tpu.transcript.hashing import derive_rng_from_seed as j_rng
from snark_setup_tpu.utils import enums as je
from snark_setup_tpu_torch.cli import phase1_main
from snark_setup_tpu_torch.curves.constants import get_curve
from snark_setup_tpu_torch.ops import toeplitz
from snark_setup_tpu_torch.ops.convert import planes_from_reference, planes_to_reference
from snark_setup_tpu_torch.ops.cuda_routes import (
    StackedProduct,
    stacked_cols_plain,
    stacked_mul_v2_plain,
    stacked_mul_v3_plain,
    stacked_product_for,
)
from snark_setup_tpu_torch.ops.curve import curve_ops as torch_curve_ops
from snark_setup_tpu_torch.ops.fp import fp_ops
from snark_setup_tpu_torch.phase1.parameters import Phase1Parameters as TParams
from snark_setup_tpu_torch.phase1.protocol import Phase1 as TPhase1
from snark_setup_tpu_torch.transcript.hashing import blank_hash, calculate_hash
from snark_setup_tpu_torch.utils import enums as te

# The suite runs several pytest workers on one host: PyTorch's intra-op
# thread pool in each would oversubscribe the cores, and its idle threads'
# spinning slows the plain versions' small operators by orders of magnitude.
torch.set_num_threads(1)

SWITCHES = {
    "v2": "SNARK_SETUP_KERNEL_V2",
    "v3": "SNARK_SETUP_KERNEL_V3",
    "mxu": "SNARK_SETUP_MXU_STACKED",
}
CURVES = ["bls12_377", "bw6_761"]  # L = 24 and L = 48
SEED = bytes(range(32))


@pytest.fixture(autouse=True)
def _no_switch(monkeypatch):
    """Every test starts on the default route, whatever the environment."""
    for name in SWITCHES.values():
        monkeypatch.delenv(name, raising=False)


def _planes(fq, S, B, seed):
    """(L, S, B) numpy Montgomery planes of seeded values; lane 0 holds 0,
    lane 1 the largest value N - 1."""
    rng = random.Random(seed)
    ints = [[rng.randrange(fq.modulus) for _ in range(B)] for _ in range(S)]
    for row in ints:
        row[0], row[1] = 0, fq.modulus - 1
    return np.stack([fq.from_int(row) for row in ints], axis=1)


def _operands(curve, S, B):
    fq = fp_ops(get_curve(curve).q)
    U, V = _planes(fq, S, B, 41), _planes(fq, S, B, 42)
    return fq, U, V, planes_from_reference(U, "cpu"), planes_from_reference(V, "cpu")


@pytest.mark.parametrize("curve", CURVES)
def test_cols_plain_equals_reference_cols(curve):
    """K6's plain version against PallasFieldMul.cols in interpret mode, as
    integers (the reference's uint32 columns: 32-bit words read as
    unsigned), and the wrapper on CPU tensors runs it."""
    fq, U, V, Ut, Vt = _operands(curve, 4, 40)
    weights = ((1, 1, 0, 0), (0, 0, 2, 1))
    want = np.asarray(pallas_mul_for(fq.modulus).cols(U, V, weights, interpret=True)).astype(np.int64)
    got = stacked_cols_plain(fq, Ut, Vt, weights)
    assert got.dtype == torch.int32 and got.shape == (2 * fq.L, 2, 40)
    assert (got.numpy().view(np.uint32) == want).all()
    K = stacked_product_for(fq.modulus).k6
    n = (K.launches, K.plain_calls)
    assert torch.equal(K(Ut, Vt, weights), got)
    assert (K.launches, K.plain_calls) == (n[0], n[1] + 1)


@pytest.mark.parametrize("nprod", [1, 4])
@pytest.mark.parametrize("curve", CURVES)
def test_redc_cols_matmul_equals_reference_and_redc_cols(curve, nprod):
    """The matrix-product reduction of K6's columns: equal to the JAX
    package's `redc_cols_matmul` and to the port's `redc_cols`."""
    fq, _, _, Ut, Vt = _operands(curve, 4, 24)
    weights = ((1, 0, 0, 0), (0, 0, 1, 0)) if nprod == 1 else ((1, 1, 1, 1), (0, 0, 2, 2))
    cols = stacked_cols_plain(fq, Ut, Vt, weights)
    got = fq.redc_cols_matmul(cols, nprod)
    want = np.asarray(jax_fp_ops(fq.modulus).redc_cols_matmul(cols.numpy().astype(np.uint32), nprod))
    assert (planes_to_reference(got) == want).all()
    assert torch.equal(got, fq.redc_cols(cols, nprod))
    with pytest.raises(ValueError, match="REDC bound"):
        fq.redc_cols_matmul(cols, fq.spec.mont_r_pow // fq.modulus + 1)


def test_mxu_route_reads_columns_at_and_above_2_31_as_unsigned():
    """K6's 32-bit columns at and above 2^31 (int32 words that read
    negative) through the MXU route: MNT4-753 operands below N whose limbs
    are all 0xFF01 below a zero top limb, weights whose largest sum is the
    largest the column bound admits (682). The route's product equals
    `redc_cols_matmul` on the same columns widened to int64, the JAX
    package's `redc_cols_matmul` on them as uint32, and K5's product."""
    fq = fp_ops(get_curve("mnt4_753").q)
    top = ((1 << 32) - 1) // (2 * fq.L << 16)
    assert top == 682
    U = np.full((fq.L, 3, 6), 0xFF01, np.uint32)
    U[-1] = 0
    U[:, :, 1] = fq.from_int([1] * 3)  # 1 in Montgomery form, and lane 2 holds N - 1
    U[:, :, 2] = fq.from_int([fq.modulus - 1] * 3)
    Ut, Vt = planes_from_reference(U, "cpu"), planes_from_reference(U[:, ::-1].copy(), "cpu")
    weights = ((341, 341, 0), (0, 1, top - 1))
    P = stacked_product_for(fq.modulus)
    cols = P.k6(Ut, Vt, weights)
    assert cols.dtype == torch.int32 and int(cols.min()) < 0  # some column >= 2^31
    got = P.mxu(Ut, Vt, weights)
    wide = cols.to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(got, fq.redc_cols_matmul(wide, top))
    want = np.asarray(jax_fp_ops(fq.modulus).redc_cols_matmul(cols.numpy().view(np.uint32), top))
    assert (planes_to_reference(got) == want).all()
    assert torch.equal(got, P.k5(Ut, Vt, weights))


@pytest.mark.parametrize("curve", CURVES)
def test_v3_plain_equals_reference_v3(curve):
    fq, U, V, Ut, Vt = _operands(curve, 4, 40)
    weights = ((1, 1, 0, 0), (0, 0, 2, 1))
    want = np.asarray(pallas_mul_for(fq.modulus).v3(U, V, weights, interpret=True))
    got = stacked_mul_v3_plain(fq, Ut, Vt, weights)
    assert (planes_to_reference(got) == want).all()
    assert torch.equal(got, stacked_product_for(fq.modulus).k5(Ut, Vt, weights))


@pytest.mark.parametrize("curve", CURVES)
def test_v2_plain_equals_reference_v2(curve):
    """The weights of the reference's own v2 test (sum of weights <= 2 at
    L = 48); the wrapper refuses weights that v2_bounds refuses."""
    fq, U, V, Ut, Vt = _operands(curve, 6, 40)
    if fq.L <= 24:
        weights = ((1, 1, 0, 0, 0, 0), (0, 0, 1, 1, 0, 0), (0, 0, 0, 0, 2, 1))
    else:
        weights = ((1, 1, 0, 0, 0, 0), (0, 0, 1, 1, 0, 0), (0, 0, 0, 0, 1, 1))
    want = np.asarray(pallas_mul_for(fq.modulus).v2(U, V, weights, interpret=True))
    got = stacked_mul_v2_plain(fq, Ut, Vt, weights)
    assert (planes_to_reference(got) == want).all()
    assert torch.equal(got, stacked_product_for(fq.modulus).k5(Ut, Vt, weights))
    too_big = ((3, 0, 0, 0, 0, 0),) if fq.L > 24 else ((6, 0, 0, 0, 0, 0),)
    with pytest.raises(ValueError, match="v2_bounds"):
        stacked_product_for(fq.modulus).k8(Ut, Vt, too_big)


def test_route_wrappers_check_their_bounds():
    """K6 and K7 refuse weights whose 16-bit-limb columns could reach 2^32
    (at L = 48 the REDC bound allows more), K8 weights v2_bounds refuses."""
    fq = fp_ops(get_curve("mnt4_753").q)
    P = stacked_product_for(fq.modulus)
    U = planes_from_reference(_planes(fq, 1, 3, 5), "cpu")
    limit = (1 << 15) // fq.L  # 2 L 2^16 sum W < 2^32
    assert limit * fq.modulus < fq.spec.mont_r_pow
    for K in (P.k6, P.k7):
        with pytest.raises(ValueError, match="column bound"):
            K(U, U, ((limit + 1,),))
    assert torch.equal(P.k7(U, U, ((limit - 1,),)), P.k5(U, U, ((limit - 1,),)))
    assert torch.equal(P.k8(U, U, ((2,),)), P.k5(U, U, ((2,),)))
    with pytest.raises(ValueError, match="v2_bounds"):
        P.k8(U, U, ((3,),))


def test_host_constants_equal_reference():
    """redc_matrices, v2_bounds and v2_supported on the grid L in {24, 48},
    weight sums 1-7 (one row, and spread over rows and columns)."""
    for curve in CURVES:
        q = get_curve(curve).q
        fq, pm = fp_ops(q), pallas_mul_for(q)
        for a, b in zip(toeplitz.redc_matrices(q, fq.spec.n0_inv, fq.L), pm._redc_matrices()):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        for total in range(1, 8):
            for weights in (((total,),), ((total - 1, 1), (1, 0)), ((1,) * total, (0,) * total)):
                assert toeplitz.v2_bounds(fq.L, weights) == pallas_field.v2_bounds(fq.L, weights)
                assert toeplitz.v2_supported(q, fq.L, weights) == pm.v2_supported(weights)


def test_v2_bounds_equal_reference_on_the_group_law_weights(monkeypatch):
    """Every composite weight matrix the port's group law, towers and
    endomorphism hand the product, on each curve and group (one add, one
    double and, where there is one, the endomorphism on two points): the
    port's v2_bounds / v2_supported equal the reference's."""
    seen = {}
    orig = StackedProduct.route

    def recording(self, weights):
        seen[(self.k5.fq.modulus, tuple(tuple(g) for g in weights))] = None
        return orig(self, weights)

    monkeypatch.setattr(StackedProduct, "route", recording)
    for curve in ("bls12_377", "bls12_381", "bw6_761", "mnt4_753", "mnt6_753"):
        for group in ("g1", "g2"):
            ops = torch_curve_ops(curve, group)
            hc = ops.host_curve
            p = ops.from_affine_host([hc.generator, hc.double(hc.generator)], "cpu")
            ops.add(p, ops.double(p))
            if ops.glv is not None:
                ops.endo(p)
    assert len({w for _, w in seen}) >= 8
    for q, weights in seen:
        L = fp_ops(q).L
        assert toeplitz.v2_bounds(L, weights) == pallas_field.v2_bounds(L, weights), weights
        assert toeplitz.v2_supported(q, L, weights) == pallas_mul_for(q).v2_supported(weights), weights


def _reference_routed(jF, U, V, weights, nprod, monkeypatch):
    """The JAX package's `mul_stacked` on its Pallas branch, every kernel
    in interpret mode (patched inside this call only)."""
    with monkeypatch.context() as m:
        m.setattr(pallas_field, "pallas_enabled", lambda: True)
        for name in ("__call__", "v2", "v3", "cols"):
            orig = getattr(pallas_field.PallasFieldMul, name)
            m.setattr(pallas_field.PallasFieldMul, name,
                      lambda self, u, v, w, interpret=False, _f=orig: _f(self, u, v, w, interpret=True))
        return np.asarray(jF.mul_stacked(U, V, weights, nprod))


@pytest.mark.parametrize("route", sorted(SWITCHES))
@pytest.mark.parametrize("curve", ["bls12_377", "mnt6_753"])
def test_routed_tower_mul_stacked_equals_reference(curve, route, monkeypatch):
    """F.mul_stacked on G2's coordinate field (Fp2 with a negative
    non-residue; Fp3) under each switch against the reference's routed
    `mul_stacked`, S = 3, B = 5: the composite weights pick the route on
    both sides (no tower product passes v2_supported, so the v2 switch
    falls through to K5 there, as in the reference)."""
    jF, tF = jax_curve_ops(curve, "g2").field, torch_curve_ops(curve, "g2").field
    d, S, B = jF.degree, 3, 5
    rng = random.Random(11)

    def rand_el():
        return tuple(rng.randrange(jF.fp.modulus) for _ in range(d))

    U = jF.from_coeffs([rand_el() for _ in range(S * B)]).reshape(jF.fp.L, d, S, B)
    V = jF.from_coeffs([rand_el() for _ in range(S * B)]).reshape(jF.fp.L, d, S, B)
    weights, nprod = ((1, 1, 0), (0, 0, 1)), 2 * jF.prod_nprod
    monkeypatch.setenv(SWITCHES[route], "1")
    want = _reference_routed(jF, U, V, weights, nprod, monkeypatch)
    P = stacked_product_for(tF.fp.modulus)
    comp, _ = tF._flattened(weights, S)
    wrapper = {"v2": P.k5, "v3": P.k7, "mxu": P.k6}[route]
    assert P.route(comp) is (P.mxu if route == "mxu" else wrapper)
    n = wrapper.plain_calls
    got = tF.mul_stacked(planes_from_reference(U, "cpu"), planes_from_reference(V, "cpu"), weights, nprod)
    assert wrapper.plain_calls == n + 1
    assert (planes_to_reference(got) == want).all()


@pytest.mark.parametrize("value,on", [("1", True), ("on", True), ("ON", True), ("True", True),
                                      ("0", False), ("off", False), (None, False)])
def test_switches_lower_case_their_value(value, on, monkeypatch):
    for name, gate in (("SNARK_SETUP_KERNEL_V2", toeplitz.kernel_v2_enabled),
                       ("SNARK_SETUP_KERNEL_V3", toeplitz.kernel_v3_enabled),
                       ("SNARK_SETUP_MXU_STACKED", toeplitz.mxu_stacked_forced)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
        assert gate() is on, (name, value)


# -- the slice as a whole: contributions through the CLI under each switch ---

POWER, BATCH = 2, 2


def _challenge(params):
    ch = bytearray(params.get_length(te.UseCompression.NO))
    ch[:64] = blank_hash()
    TPhase1.initialization(ch, te.UseCompression.NO, params)
    return bytes(ch)


@pytest.fixture(scope="session")
def bls_jax_response(tmp_path_factory):
    """The JAX package's BLS12-377 Groth16 response (power 2, batch 2) to
    the initial challenge with SEED's key: made once per test run, under a
    file lock in the directory the pytest workers share."""
    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    path = root / "torch_routes_bls12_377_jax_response.bin"
    with FileLock(str(path) + ".lock"):
        if not path.exists():
            jp = JParams.new_full("bls12_377", je.ProvingSystem.GROTH16, POWER, BATCH)
            challenge = _challenge(TParams.new_full("bls12_377", te.ProvingSystem.GROTH16, POWER, BATCH))
            j_pk, j_key = JPhase1.key_generation(jp.spec, j_rng(SEED), calculate_hash(challenge))
            want = bytearray(jp.contribution_size)
            JPhase1.computation(challenge, want, je.UseCompression.NO, je.UseCompression.YES,
                                je.CheckForCorrectness.NO, je.BatchExpMode.AUTO, j_key, jp)
            j_pk.write(want, je.UseCompression.YES, jp)
            path.write_bytes(bytes(want))
    return path.read_bytes()


def _cli_contribution(tmp_path, curve, power, batch):
    """`new` + `contribute` through the port's CLI on the CPU; the response."""
    seed_file = tmp_path / "seed"
    seed_file.write_text(SEED.hex())
    common = ["--curve-kind", curve, "--proving-system", "groth16", "--contribution-mode", "full",
              "--power", str(power), "--batch-size", str(batch), "--device", "cpu"]
    f = lambda name: str(tmp_path / name)
    assert phase1_main.main([*common, "new", "--challenge-fname", f("challenge"),
                             "--challenge-hash-fname", f("challenge.hash")]) == 0
    assert phase1_main.main([*common, "--seed", str(seed_file), "contribute",
                             "--challenge-fname", f("challenge"), "--challenge-hash-fname", f("challenge.hash2"),
                             "--response-fname", f("response"), "--response-hash-fname", f("response.hash")]) == 0
    challenge, response = (tmp_path / "challenge").read_bytes(), (tmp_path / "response").read_bytes()
    assert response[:64] == hashlib.blake2b(challenge, digest_size=64).digest()
    return response


@pytest.mark.parametrize("route", sorted(SWITCHES))
def test_bls12_377_contribution_under_each_switch_equals_jax_package(route, bls_jax_response,
                                                                     tmp_path, monkeypatch):
    """Power 2, batch 2, Groth16, full: the response under the switch is
    byte-identical to the JAX package's, and the route's plain version ran
    (K8 takes the Fq rounds of G1 and the endomorphism's beta planes)."""
    P = stacked_product_for(get_curve("bls12_377").q)
    wrapper = {"v2": P.k8, "v3": P.k7, "mxu": P.k6}[route]
    n = wrapper.plain_calls
    monkeypatch.setenv(SWITCHES[route], "on")
    response = _cli_contribution(tmp_path, "bls12_377", POWER, BATCH)
    assert wrapper.plain_calls > n
    assert len(response) == len(bls_jax_response) and response[64:] == bls_jax_response[64:]


def test_mnt4_contribution_under_v2_equals_default_route(tmp_path, monkeypatch):
    """MNT4-753 (power 1, batch 4): under SNARK_SETUP_KERNEL_V2, G1's rounds
    0 and 2 take K8 (at L = 48 only weight sums <= 2 pass), round 1 and every
    Fp2 product K5; the response equals the default route's byte for byte."""
    P = stacked_product_for(get_curve("mnt4_753").q)
    for name in ("default", "v2"):
        (tmp_path / name).mkdir()
    default = _cli_contribution(tmp_path / "default", "mnt4_753", 1, 4)
    n = (P.k8.plain_calls, P.k5.plain_calls)
    monkeypatch.setenv("SNARK_SETUP_KERNEL_V2", "1")
    response = _cli_contribution(tmp_path / "v2", "mnt4_753", 1, 4)
    assert P.k8.plain_calls > n[0] and P.k5.plain_calls > n[1]
    assert response == default
