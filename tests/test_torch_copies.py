"""The port's host-exact copies and re-derived constants equal the JAX
package's, and the port imports neither JAX nor the JAX package.

Exact equality throughout (integers and bytes; tolerance 0)."""

import os
import re

import numpy as np
import pytest
import torch

import snark_setup_tpu.curves.constants as jconst
import snark_setup_tpu.fields.limb as jlimb
import snark_setup_tpu.phase1.keys as jkeys
import snark_setup_tpu.phase1.parameters as jparams
import snark_setup_tpu.serialize.arkworks as jark
import snark_setup_tpu.transcript.hashing as jhash
import snark_setup_tpu.utils.enums as jenums
import snark_setup_tpu_torch.curves.constants as tconst
import snark_setup_tpu_torch.fields.limb as tlimb
import snark_setup_tpu_torch.phase1.keys as tkeys
import snark_setup_tpu_torch.phase1.parameters as tparams
import snark_setup_tpu_torch.serialize.arkworks as tark
import snark_setup_tpu_torch.transcript.hashing as thash
import snark_setup_tpu_torch.utils.enums as tenums

# The suite runs several pytest workers on one host: PyTorch's intra-op
# thread pool in each would oversubscribe the cores, and its idle threads'
# spinning slows the plain versions' small operators by orders of magnitude.
torch.set_num_threads(1)

CURVES = ["bw6_761", "bls12_377"]
ALL_CURVES = CURVES + ["mnt4_753", "mnt6_753"]
GROUPS = [("bls12_377", "g1"), ("bw6_761", "g1"), ("bw6_761", "g2")]
EXT_OR_A_GROUPS = [("bls12_377", "g2"), ("mnt4_753", "g1"), ("mnt4_753", "g2"), ("mnt6_753", "g1"),
                   ("mnt6_753", "g2")]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("curve", ALL_CURVES)
def test_limb_arrays_equal(curve):
    js, ts = jconst.get_curve(curve), tconst.get_curve(curve)
    rng = np.random.default_rng(1)
    for m in (js.q, js.r):
        a, b = jlimb.LimbSpec(m), tlimb.LimbSpec(m)
        assert (a.n_limbs, a.mont_r, a.mont_r2, a.n0_inv) == (b.n_limbs, b.mont_r, b.mont_r2, b.n0_inv)
        vals = [0, 1, m - 1] + [int.from_bytes(rng.bytes(120), "little") % m for _ in range(5)]
        ja, ta = jlimb.ints_to_limbs_batch(vals, a.n_limbs), tlimb.ints_to_limbs_batch(vals, b.n_limbs)
        assert ja.dtype == ta.dtype and (ja == ta).all()
        assert tlimb.limbs_batch_to_ints(ta) == vals
        assert (jlimb.int_to_limbs(m, a.n_limbs) == tlimb.int_to_limbs(m, b.n_limbs)).all()
    assert (ts.q, ts.r) == (js.q, js.r)


@pytest.mark.parametrize("curve", ALL_CURVES)
def test_curve_constants_equal(curve):
    js, ts = jconst.get_curve(curve), tconst.get_curve(curve)
    assert ts.name == js.name and ts.fp_bytes == js.fp_bytes
    for g in ("g1", "g2"):
        jg, tg = getattr(js, g), getattr(ts, g)
        assert (tg.field_kind, tuple(tg.a), tuple(tg.b)) == (jg.field_kind, tuple(jg.a), tuple(jg.b))
        assert tg.cofactor == jg.cofactor
    from snark_setup_tpu.curves.host import g1_curve as jg1, g2_curve as jg2
    from snark_setup_tpu_torch.curves.host import g1_curve as tg1, g2_curve as tg2

    for jc, tc in ((jg1(js), tg1(ts)), (jg2(js), tg2(ts))):
        jp, tp = jc.mul(jc.generator, 0xABCDEF12345), tc.mul(tc.generator, 0xABCDEF12345)
        assert repr(tp.x) == repr(jp.x) and repr(tp.y) == repr(jp.y)


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("compressed", ["YES", "NO"])
def test_arkworks_codec_bytes_equal(curve, compressed):
    js, ts = jconst.get_curve(curve), tconst.get_curve(curve)
    jc, tc = jenums.UseCompression[compressed], tenums.UseCompression[compressed]
    from snark_setup_tpu.curves.host import INFINITY as JINF
    from snark_setup_tpu_torch.curves.host import INFINITY as TINF

    for jcodec, tcodec in ((jark.g1_codec(js), tark.g1_codec(ts)), (jark.g2_codec(js), tark.g2_codec(ts))):
        for k in (1, 2, 0x1234567):
            jb = jcodec.serialize(jcodec.curve.mul(jcodec.curve.generator, k), jc)
            tb = tcodec.serialize(tcodec.curve.mul(tcodec.curve.generator, k), tc)
            assert jb == tb
            back = tcodec.deserialize(tb, tc, tenums.CheckForCorrectness.FULL)
            assert back == tcodec.curve.mul(tcodec.curve.generator, k)
        assert jcodec.serialize(JINF, jc) == tcodec.serialize(TINF, tc)


@pytest.mark.parametrize("curve", CURVES)
def test_key_generation_and_parameter_sizes_equal(curve):
    js, ts = jconst.get_curve(curve), tconst.get_curve(curve)
    digest = bytes(range(64))
    jpk, jsk = jkeys.key_generation(js, jhash.derive_rng_from_seed(b"\x05" * 32), digest)
    tpk, tsk = tkeys.key_generation(ts, thash.derive_rng_from_seed(b"\x05" * 32), digest)
    assert (tsk.tau, tsk.alpha, tsk.beta) == (jsk.tau, jsk.alpha, jsk.beta)
    assert tpk.serialize(ts) == jpk.serialize(js)
    for system in ("GROTH16", "MARLIN"):
        jp = jparams.Phase1Parameters.new_full(curve, jenums.ProvingSystem[system], 5, 8)
        tp = tparams.Phase1Parameters.new_full(curve, tenums.ProvingSystem[system], 5, 8)
        for attr in ("accumulator_size", "contribution_size", "public_key_size", "powers_length",
                     "powers_g1_length", "hash_size"):
            assert getattr(tp, attr) == getattr(jp, attr), attr
        for c in ("YES", "NO"):
            assert tp.get_length(tenums.UseCompression[c]) == jp.get_length(jenums.UseCompression[c])


@pytest.mark.parametrize("curve,group", GROUPS)
def test_rederived_device_constants_equal(curve, group):
    """N, N', R mod N, 3b, beta, and the GLV geometry and limb constants."""
    from snark_setup_tpu.ops.curve_jax import curve_ops as jops_for
    from snark_setup_tpu_torch.ops.curve import curve_ops as tops_for

    jops, tops = jops_for(curve, group), tops_for(curve, group)
    for jf, tf in ((jops.fq, tops.fq), (jops.fr, tops.fr)):
        assert tf.L == jf.L
        for name in ("N", "Nprime", "one_mont_np"):
            assert (np.asarray(getattr(tf, name)) == np.asarray(getattr(jf, name))).all(), name
    assert (tops.b3_np.reshape(-1) == np.asarray(jops.b3_dev).reshape(-1)).all()
    assert (tops.beta_np.reshape(-1) == np.asarray(jops._glv_beta).reshape(-1)).all()
    assert tops._b3_small == jops._b3_small
    jg, tg = jops.glv, tops.glv
    assert (tg.p.beta, tg.p.lam, tg.p.v1, tg.p.v2, tg.p.nbits) == (jg.p.beta, jg.p.lam, jg.p.v1, jg.p.v2, jg.p.nbits)
    assert (tg.Lc, tg.LT, tg.Lh, tg.S_limbs, tg.half_limb, tg.mu_sign) == (
        jg.Lc, jg.LT, jg.Lh, jg.S_limbs, jg.half_limb, jg.mu_sign)
    for a, b in zip(tg.mu, jg.mu):
        assert (a == b).all()
    for tt, jt in zip((*tg.k1_terms, *tg.k2_terms), (*jg.k1_terms, *jg.k2_terms)):
        assert (tt is None) == (jt is None)
        if tt is not None:
            assert tt[0] == jt[0] and (tt[1] == jt[1]).all()


@pytest.mark.parametrize("curve,group", EXT_OR_A_GROUPS)
def test_rederived_tower_and_curve_constants_equal(curve, group):
    """Tower non-residue, its expansion table and REDC bound, and a, b, 3b,
    -a^2 for the groups with Fp2 / Fp3 coordinates or a != 0."""
    from snark_setup_tpu.ops.curve_jax import curve_ops as jops_for
    from snark_setup_tpu_torch.ops.curve import curve_ops as tops_for

    jops, tops = jops_for(curve, group), tops_for(curve, group)
    jF, tF = jops.field, tops.field
    assert (tF.degree, tF.prod_nprod) == (jF.degree, jF.prod_nprod)
    if tF.degree > 1:
        assert tF.nr == jF.nr and tF._tower_products() == jF._tower_products()
    assert tops.a_is_zero == jops.a_is_zero and tops._b3_small == jops._b3_small
    names = [("a_np", "a_dev"), ("b3_np", "b3_dev")] + ([] if tops.a_is_zero else [("neg_a2_np", "neg_a2_dev")])
    for t_name, j_name in names:
        assert (np.asarray(getattr(tops, t_name)) == np.asarray(getattr(jops, j_name))).all(), t_name
    assert (tops.glv is None) == (jops.glv is None)
    if tops.glv is not None:
        from dataclasses import astuple

        assert astuple(tops.glv.p) == astuple(jops.glv.p)


@pytest.mark.parametrize("curve", ["bls12_377", "bls12_381", "bw6_761", "mnt4_753", "mnt6_753"])
def test_hash_to_g2_equals_reference(curve):
    """The port's hash_to_g2 pre-filters candidates on their top bytes; the
    point it returns is the reference's, candidate for candidate. On MNT6-753
    (Fp3: two unflagged coefficients filtered before the flagged one) a
    candidate survives the exact filter about once in 2^20, so the reference's
    loop takes minutes on most digests: this digest's first valid candidate is
    number 5741, in the reference's second chunk of 4096."""
    import hashlib

    js, ts = jconst.get_curve(curve), tconst.get_curve(curve)
    if curve == "mnt6_753":
        seeds = [(758).to_bytes(2, "little") + curve.encode()]
    else:
        seeds = [bytes([k]) + curve.encode() for k in range(2)]
    for seed in seeds:
        digest = hashlib.blake2b(seed, digest_size=64).digest()
        jp, tp = jhash.hash_to_g2(js, digest), thash.hash_to_g2(ts, digest)
        assert repr(tp.x) == repr(jp.x) and repr(tp.y) == repr(jp.y)


def test_hostmath_copy_equals_reference():
    import random

    from snark_setup_tpu.ops import hostmath as jhm
    from snark_setup_tpu_torch.ops import hostmath as thm

    rng = random.Random(3)
    for curve, d in (("bw6_761", 1), ("bls12_377", 2), ("mnt4_753", 2), ("mnt6_753", 3)):
        spec = tconst.get_curve(curve)
        q, nr = spec.q, (spec.ext_nonresidue if d > 1 else 0)
        assert thm.host_ext_one(d) == jhm.host_ext_one(d)
        for e in (0, 1, 2, 0xBEEF, q**d - 2):
            c = tuple(rng.randrange(q) for _ in range(d))
            assert thm.host_ext_pow(c, e, q, d, nr) == jhm.host_ext_pow(c, e, q, d, nr)


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "scripts", "torch_ceremony.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "snark_setup_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_neither_jax_nor_the_jax_package():
    pat = re.compile(
        r"^\s*(import\s+jax\b|from\s+jax\b|import\s+snark_setup_tpu\b(?!_)|from\s+snark_setup_tpu\b(?!_))",
        re.M,
    )
    files = _port_sources()
    assert len(files) > 30
    hits = [f for f in files if pat.search(open(f).read())]
    assert not hits, hits


def test_port_has_no_torch_compile():
    assert not [f for f in _port_sources() if "torch.compile" in open(f).read()
                and not f.endswith("chip_smoke.py")]


def test_entry_points_raise_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves")
    from snark_setup_tpu_torch.cli import phase1_main
    from snark_setup_tpu_torch.ops.codec import batch_codec
    from snark_setup_tpu_torch.ops.curve import curve_ops
    from snark_setup_tpu_torch.phase1.protocol import Phase1
    from snark_setup_tpu_torch.shard import runtime
    from snark_setup_tpu_torch.utils.device import resolve_device

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    for curve, group in (("bw6_761", "g1"), ("bls12_377", "g2"), ("mnt4_753", "g1"), ("mnt6_753", "g2")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            batch_codec(curve, group)
    from snark_setup_tpu_torch.ops import convert

    # the seam constructors default to the card as well
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.planes_from_reference(np.zeros((16, 2), np.uint32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.pointvec_from_reference({k: np.zeros((24, 2), np.uint32) for k in "xyz"})
    ops = curve_ops("bls12_377", "g1")
    # constructors of tensors take the device as a required argument
    for ctor in (ops.infinity, ops.fq.zeros, ops.fq.ones, ops.field.zeros, ops.field.ones):
        with pytest.raises(TypeError):
            ctor((2,))
    pts = ops.infinity((2,), "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.scalar_mul(ops, pts, torch.zeros((ops.fr.L, 2), dtype=torch.int32))
    for curve in ("bw6_761", "bls12_377", "mnt4_753", "mnt6_753"):
        tp = tparams.Phase1Parameters.new_full(curve, tenums.ProvingSystem.GROTH16, 2, 2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Phase1.computation(b"", bytearray(), tenums.UseCompression.NO, tenums.UseCompression.YES,
                               tenums.CheckForCorrectness.NO, tenums.BatchExpMode.AUTO, None, tp)
    g2 = curve_ops("mnt6_753", "g2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runtime.scalar_mul(g2, g2.infinity((2,), "cpu"), torch.zeros((g2.fr.L, 2), dtype=torch.int32))
    assert phase1_main.build_parser().parse_args(["new"]).device == "cuda"
    assert resolve_device("cpu").type == "cpu"


def test_unported_groups_and_commands_raise_not_implemented():
    """Every group and every phase-1 subcommand is ported now: the subgroup
    checks run and the verification subcommands reach their files. What
    still raises NotImplementedError is a kernel asked for outside its
    scope (the group-op and ladder kernels need Fq coordinates, a = 0)."""
    from snark_setup_tpu_torch.cli import phase1_main
    from snark_setup_tpu_torch.ops.codec import batch_codec
    from snark_setup_tpu_torch.ops.cuda_group import GroupOps
    from snark_setup_tpu_torch.ops.cuda_ladder import FusedGLVLadder
    from snark_setup_tpu_torch.ops.curve import curve_ops
    from snark_setup_tpu_torch.serialize.arkworks import g2_codec

    codec = batch_codec("bls12_377", "g2", "cpu")
    hc = codec.ops.host_curve
    data = g2_codec(codec.spec).serialize(hc.mul(hc.generator, 5), tenums.UseCompression.NO)
    p = codec.read_batch(data, tenums.UseCompression.NO, tenums.CheckForCorrectness.FULL)
    assert codec.ops.to_affine_host(p) == [hc.mul(hc.generator, 5)]
    for name in ("verify-and-transform-pok-and-correctness", "verify-and-transform-ratios", "combine", "split"):
        args = phase1_main.build_parser().parse_args(["--device", "cpu", name])
        with pytest.raises(FileNotFoundError):
            phase1_main.execute(args)
    for curve, group in (("bls12_377", "g2"), ("mnt4_753", "g1")):
        with pytest.raises(NotImplementedError):
            GroupOps(curve_ops(curve, group))
        with pytest.raises(NotImplementedError):
            FusedGLVLadder(curve_ops(curve, group))


@pytest.mark.parametrize("curve", ["bls12_377", "bw6_761", "bls12_381", "mnt4_753", "mnt6_753"])
def test_pairing_copies_equal_reference(curve):
    """curves/{tower,pairing}.py are host copies: the same pairing values
    (nested tuples of ints) and the same check_same_ratio decisions (the
    port's final exponentiation takes its easy part by conjugation and the
    rest by a sliding window: the reference's value by other means)."""
    from snark_setup_tpu.curves.host import g1_curve as jg1, g2_curve as jg2
    from snark_setup_tpu.curves.pairing import pairing_engine as j_engine
    from snark_setup_tpu.utils.errors import InvalidRatioError as JInvalidRatio
    from snark_setup_tpu_torch.curves.host import INFINITY, g1_curve as tg1, g2_curve as tg2
    from snark_setup_tpu_torch.curves.pairing import pairing_engine as t_engine
    from snark_setup_tpu_torch.utils.errors import InvalidRatioError as TInvalidRatio

    js, ts = jconst.get_curve(curve), tconst.get_curve(curve)
    je_, te_ = j_engine(curve), t_engine(curve)
    j1, j2, t1, t2 = jg1(js), jg2(js), tg1(ts), tg2(ts)
    jp, jq = j1.mul(j1.generator, 11), j2.mul(j2.generator, 13)
    tp, tq = t1.mul(t1.generator, 11), t2.mul(t2.generator, 13)
    assert te_.pairing_value(tp, tq) == je_.pairing_value(jp, jq)
    # (a, a^7) against (b, b^7): same ratio; against (b, b^8): not
    te_.check_same_ratio((tp, t1.mul(tp, 7)), (tq, t2.mul(tq, 7)), "same")
    je_.check_same_ratio((jp, j1.mul(jp, 7)), (jq, j2.mul(jq, 7)), "same")
    for t_pair, j_pair in (((tq, t2.mul(tq, 8)), (jq, j2.mul(jq, 8))), ((tq, INFINITY), None)):
        with pytest.raises(TInvalidRatio):
            te_.check_same_ratio((tp, t1.mul(tp, 7)), t_pair, "different")
        if j_pair is not None:
            with pytest.raises(JInvalidRatio):
                je_.check_same_ratio((jp, j1.mul(jp, 7)), j_pair, "different")


def test_verification_entry_points_raise_without_a_card():
    """The verification path runs on the card unless the caller asks for
    the CPU: without a card it raises before any work."""
    from snark_setup_tpu_torch.phase1.protocol import Phase1

    tp = tparams.Phase1Parameters.new_full("bls12_377", tenums.ProvingSystem.GROTH16, 2, 2)
    for call in (
        lambda: Phase1.aggregate_verification(b"", tenums.UseCompression.NO, tenums.CheckForCorrectness.NO, tp),
        lambda: Phase1.decompress(b"", bytearray(), tenums.CheckForCorrectness.NO, tp),
        lambda: Phase1.aggregation([], bytearray(), tenums.UseCompression.NO, tp),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("rel", ["ntt/domain.py", "phase2/r1cs.py", "phase2/sha256_circuit.py",
                                 "phase2/load_circuit.py", "phase2/keypair.py"])
def test_phase2_host_copies_are_byte_equal(rel):
    """The host-exact phase-2 modules are copies, byte for byte."""
    with open(os.path.join(REPO, "snark_setup_tpu", rel), "rb") as f:
        ref = f.read()
    with open(os.path.join(REPO, "snark_setup_tpu_torch", rel), "rb") as f:
        assert f.read() == ref


@pytest.mark.parametrize("rel", ["portable/__init__.py", "portable/contributor.py"])
def test_portable_copies_are_byte_equal_but_the_package_name(rel):
    """The portable contributor is a copy; only its `_main` docstring names
    the package it is run from."""
    with open(os.path.join(REPO, "snark_setup_tpu", rel), "rb") as f:
        ref = f.read()
    with open(os.path.join(REPO, "snark_setup_tpu_torch", rel), "rb") as f:
        got = f.read()
    name = b"python -m snark_setup_tpu.portable.contributor"
    assert ref.count(name) == (1 if rel.endswith("contributor.py") else 0)
    assert got == ref.replace(name, b"python -m snark_setup_tpu_torch.portable.contributor")


PHASE2_MODULES = [
    "ntt", "ntt.domain", "ntt.group_fft", "ops.lanes", "ops.msm", "phase2", "phase2.vecio", "phase2.lagrange",
    "phase2.polynomial", "phase2.parameters", "phase2.keypair", "phase2.r1cs", "phase2.load_circuit",
    "phase2.sha256_circuit", "phase2.groth16", "phase2.chunked", "cli.phase2_cmds", "cli.phase2_main",
    "cli.prepare_phase2_main", "cli.circuit_main", "shard", "shard.mesh", "shard.runtime", "portable",
    "portable.contributor",
]


def test_phase2_modules_import_without_jax():
    """Every phase-2 module of the port is among the files the import check
    above reads, and imports in an interpreter where `jax` and the JAX
    package cannot be imported."""
    import subprocess
    import sys

    files = set(_port_sources())
    for mod in PHASE2_MODULES:
        rel = mod.replace(".", os.sep)
        assert (os.path.join(REPO, "snark_setup_tpu_torch", rel + ".py") in files
                or os.path.join(REPO, "snark_setup_tpu_torch", rel, "__init__.py") in files), mod
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['snark_setup_tpu'] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import importlib\n"
        f"for m in {PHASE2_MODULES!r}:\n"
        "    importlib.import_module('snark_setup_tpu_torch.' + m)\n"
        "assert not [m for m, v in sys.modules.items() if v is not None\n"
        "            and (m in ('jax', 'snark_setup_tpu') or m.startswith(('jax.', 'snark_setup_tpu.')))]\n"
    )
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]


def test_portable_imports_without_torch():
    """The portable contributor (and the host modules it needs) imports in an
    interpreter where `torch`, `jax` and the JAX package cannot be
    imported."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "sys.modules['torch'] = None\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['snark_setup_tpu'] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from snark_setup_tpu_torch.portable import contribute_challenge\n"
        "import snark_setup_tpu_torch.portable.contributor\n"
    )
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
