"""The port's batched device codec against the host arkworks codec:
bytes -> points -> bytes, both compressions, infinity, bad flags, range and
curve checks. Bytes compared for exact equality."""

import numpy as np
import pytest
import torch

from snark_setup_tpu.ops.codec_jax import batch_codec as jax_batch_codec
from snark_setup_tpu.utils.enums import UseCompression as JUseCompression
from snark_setup_tpu_torch.curves.host import INFINITY
from snark_setup_tpu_torch.ops.codec import FLAG_INFINITY, FLAG_Y_NEG, batch_codec
from snark_setup_tpu_torch.ops.convert import planes_to_reference
from snark_setup_tpu_torch.serialize.arkworks import g1_codec, g2_codec
from snark_setup_tpu_torch.utils.enums import CheckForCorrectness, UseCompression
from snark_setup_tpu_torch.utils.errors import PointAtInfinityError, SerializationError

# The suite runs several pytest workers on one host: PyTorch's intra-op
# thread pool in each would oversubscribe the cores, and its idle threads'
# spinning slows the plain versions' small operators by orders of magnitude.
torch.set_num_threads(1)

GROUPS = [("bls12_377", "g1"), ("bw6_761", "g1"), ("bw6_761", "g2"),
          ("bls12_377", "g2"), ("mnt4_753", "g1"), ("mnt6_753", "g2")]


def _setup(curve, group, with_infinity=True):
    codec = batch_codec(curve, group, "cpu")
    host = g1_codec(codec.spec) if group == "g1" else g2_codec(codec.spec)
    hc = codec.ops.host_curve
    rng = np.random.default_rng(7)
    pts = [hc.mul(hc.generator, int(k)) for k in rng.integers(1, 1 << 40, 6)]
    pts[3] = hc.neg(pts[2])  # both signs of one y
    if with_infinity:
        pts[4] = INFINITY
    return codec, host, pts


@pytest.mark.parametrize("curve,group", GROUPS)
@pytest.mark.parametrize("compressed", ["YES", "NO"])
def test_bytes_points_bytes_roundtrip(curve, group, compressed):
    codec, host, pts = _setup(curve, group)
    comp = UseCompression[compressed]
    data = b"".join(host.serialize(p, comp) for p in pts)
    dev = codec.read_batch(data, comp)
    assert codec.ops.to_affine_host(dev) == pts
    assert codec.ops.is_infinity(dev).tolist() == [p.is_infinity for p in pts]
    assert bool(codec.on_curve_mask(dev).all())
    for out_comp in (UseCompression.YES, UseCompression.NO):
        want = b"".join(host.serialize(p, out_comp) for p in pts)
        assert codec.write_batch(dev, out_comp, normalized=True) == want
    # a projective batch (Z != 1) goes through the batched inversion
    doubled = codec.ops.double(dev)
    want = b"".join(host.serialize(host.curve.add(p, p), UseCompression.YES) for p in pts)
    assert codec.write_batch(doubled, UseCompression.YES) == want
    assert codec.write_batch(doubled, UseCompression.YES, n_valid=2) == want[: 2 * codec.compressed_size]


@pytest.mark.parametrize("compressed", ["YES", "NO"])
def test_read_batch_equals_reference_planes(compressed):
    """Same bytes through both packages' device codecs: the Montgomery limb
    planes of x, y, z are equal."""
    codec, host, pts = _setup("bw6_761", "g1")
    comp = UseCompression[compressed]
    data = b"".join(host.serialize(p, comp) for p in pts)
    got = codec.read_batch(data, comp, pad_to=8)
    want = jax_batch_codec("bw6_761", "g1").read_batch(data, JUseCompression[compressed], pad_to=8)
    for k in "xyz":
        assert (planes_to_reference(got[k]) == np.asarray(want[k])).all(), k


@pytest.mark.parametrize("curve,group", GROUPS)
def test_malformed_input_raises(curve, group):
    codec, host, pts = _setup(curve, group, with_infinity=False)
    good = bytearray(b"".join(host.serialize(p, UseCompression.YES) for p in pts))
    with pytest.raises(SerializationError, match="multiple"):
        codec.read_batch(bytes(good[:-1]), UseCompression.YES)
    bad = bytearray(good)
    bad[codec.compressed_size - 1] |= FLAG_INFINITY | FLAG_Y_NEG
    with pytest.raises(SerializationError, match="flags"):
        codec.read_batch(bytes(bad), UseCompression.YES)
    bad = bytearray(good)
    bad[: codec.compressed_size] = b"\xff" * (codec.compressed_size - 1) + b"\x3f"
    with pytest.raises(SerializationError, match="range"):
        codec.read_batch(bytes(bad), UseCompression.YES)
    # an x with no point on the curve
    hc, q = codec.ops.host_curve, codec.spec.q
    def el(v):
        return codec.spec.fp(v) if codec.deg == 1 else codec.spec.g2_field((v,) + (0,) * (codec.deg - 1))

    x = next(x for x in range(2, 200) if hc.solve_y(el(x)) is None)
    bad = bytearray(good)
    bad[: codec.compressed_size] = x.to_bytes(codec.compressed_size, "little")
    with pytest.raises(SerializationError, match="sqrt"):
        codec.read_batch(bytes(bad), UseCompression.YES)
    # an off-curve uncompressed point parses but fails the curve equation
    unc = bytearray(b"".join(host.serialize(p, UseCompression.NO) for p in pts))
    unc[0] ^= 1
    mask = codec.on_curve_mask(codec.read_batch(bytes(unc), UseCompression.NO))
    assert mask.tolist() == [False] + [True] * (len(pts) - 1)


@pytest.mark.parametrize("curve", ["bls12_377", "mnt6_753"])
def test_g2_codec_equals_reference(curve):
    """Fp2 (BLS12-377) and Fp3 (MNT6-753) G2 points with infinity, both
    signs of one y: the same compressed bytes through both packages' device
    codecs give the same Montgomery planes (decompression = the tower square
    root); on Fp2 the written bytes equal the JAX package's as well."""
    codec, host, pts = _setup(curve, "g2")
    jcodec = jax_batch_codec(curve, "g2")
    data = b"".join(host.serialize(p, UseCompression.YES) for p in pts)
    got = codec.read_batch(data, UseCompression.YES)
    want = jcodec.read_batch(data, JUseCompression.YES)
    for k in "xyz":
        assert (planes_to_reference(got[k]) == np.asarray(want[k])).all(), k
    if curve == "bls12_377":
        for comp in ("YES", "NO"):
            assert codec.write_batch(got, UseCompression[comp]) == jcodec.write_batch(
                want, JUseCompression[comp])


def test_checks_for_correctness():
    codec, host, pts = _setup("bw6_761", "g2")
    data = b"".join(host.serialize(p, UseCompression.YES) for p in pts)
    with pytest.raises(PointAtInfinityError):
        codec.read_batch(data, UseCompression.YES, CheckForCorrectness.ONLY_NON_ZERO)
    no_inf = b"".join(host.serialize(p, UseCompression.YES) for p in pts if not p.is_infinity)
    # padding rows are infinity and must not trip the non-zero check
    codec.read_batch(no_inf, UseCompression.YES, CheckForCorrectness.ONLY_NON_ZERO, pad_to=9)
    # FULL adds the subgroup check (Direct: [r]P == O on BW6-761) and, for
    # uncompressed input, the curve equation
    codec.read_batch(no_inf, UseCompression.YES, CheckForCorrectness.FULL, pad_to=9)
    with pytest.raises(PointAtInfinityError):
        codec.read_batch(data, UseCompression.YES, CheckForCorrectness.FULL)
    unc = bytearray(host.serialize(pts[0], UseCompression.NO))
    codec.read_batch(bytes(unc), UseCompression.NO, CheckForCorrectness.ONLY_IN_GROUP)
    unc[0] ^= 1  # x off by one: off the curve
    with pytest.raises(SerializationError, match="not on curve"):
        codec.read_batch(bytes(unc), UseCompression.NO, CheckForCorrectness.ONLY_IN_GROUP)



@pytest.mark.parametrize("curve,group", GROUPS)
def test_square_root_chain_runs_on_the_stacked_product(curve, group):
    """Decompression's square root: over Fq the whole chain is the
    square-root kernel's wrapper (on a CPU tensor its counted plain
    version, and no product of K5's); over Fp2 / Fp3 it multiplies through
    the field's stacked-product route (K5's counted plain version). The root
    of y^2 squares back to it, and a non-residue times y^2 is flagged as no
    square."""
    from snark_setup_tpu_torch.ops.cuda_sqrt import fq_sqrt_for

    codec, host, pts = _setup(curve, group, with_infinity=False)
    F = codec.F
    K = F.product.k5
    pv = codec.read_batch(b"".join(host.serialize(p, UseCompression.NO) for p in pts), UseCompression.NO)
    rhs = codec.rhs(pv["x"])
    before = K.plain_calls
    if F.degree == 1:
        chain = fq_sqrt_for(codec.sqrter.q, codec.sqrter.z_coeffs[0])
        chain_before = chain.plain_calls
    r, ok = codec.sqrter.sqrt(rhs)
    if F.degree == 1:
        assert chain.plain_calls == chain_before + 1
        assert K.plain_calls == before
    else:
        assert K.plain_calls > before
    assert bool(ok.all()) and bool(F.eq(F.mul(r, r), rhs).all())
    z = F.const(("test non-residue", curve, group), F.from_coeffs([codec.sqrter.z_coeffs]), rhs)
    _, ok = codec.sqrter.sqrt(F.mul(rhs, z.expand_as(rhs)))
    assert not bool(ok.any())
