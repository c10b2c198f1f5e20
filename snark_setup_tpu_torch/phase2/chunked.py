"""Streaming phase 2 over raw byte buffers (>50 GB ceremonies).

Reference: phase2/src/chunked_groth16.rs; the reference package's
`phase2/chunked.py`. `contribute` and `verify` work directly on serialized
MPCParameters buffers, batch by batch, so the query vectors never exist as
whole Python objects: each batch is read by the batch codec onto the device
(default: the card), multiplied (contribute: the GLV scalar-mul through
`shard/runtime.py`, K3 + K4 on the card) or merged (verify: two public-scalar
MSMs, Pippenger on K2) and written back.

Vector offsets honour `compressed` everywhere (the reference package's
improvement over upstream, whose seek math hardcodes compressed sizes:
chunked_groth16.rs:376-381).

A caller's `batch_size` is cut by `ops/lanes.py: MAX_LANES`, as the rest of
phase 2 is; slicing changes no byte. Each batch is written back before the
next is read (the reference overlaps the write-back of a batch with the next
batches' compute).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..curves.constants import CurveSpec
from ..curves.host import g1_curve, g2_curve
from ..curves.pairing import pairing_engine
from ..fields.limb import ints_to_limbs_batch
from ..ops.codec import batch_codec
from ..ops.lanes import MAX_LANES
from ..serialize.arkworks import g1_codec, g2_codec
from ..shard import runtime
from ..utils.device import resolve_device
from ..utils.enums import CheckForCorrectness, UseCompression
from ..utils.errors import InvalidLengthError, InvariantKind, NoContributionsError, SerializationError
from ..utils.pipeline import Pipeline
from ..utils.tracing import get_logger, info_span
from .keypair import Keypair, Phase2PublicKey
from .parameters import (
    VerifyingKey,
    ensure_unchanged,
    ensure_unchanged_vec,
    merge_point_pairs,
    verify_transcript,
)
from .vecio import Cursor, deser_element, ser_element

logger = get_logger("snark_setup_tpu_torch.phase2.chunked")

MUL_QUERY_DEPTH = 4
"""Batches of `_batched_mul_inplace` whose write-back may be pending (the
reference's `flush(limit=3)`)."""


def _element_check(check: CheckForCorrectness) -> CheckForCorrectness:
    """The chunked path mirrors the reference's `deserialize` (setup-utils
    elements.rs:104-113): only Full/No are accepted, and Full maps to ark
    Validate::Yes — on-curve + subgroup, infinity ALLOWED (a/b queries
    legitimately contain infinity for variables unused in A/B)."""
    if check is CheckForCorrectness.FULL:
        return CheckForCorrectness.ONLY_IN_GROUP
    if check is CheckForCorrectness.NO:
        return CheckForCorrectness.NO
    raise SerializationError(f"chunked mode rejects {check} (reference parity)")


@dataclass
class _VecSpan:
    """A u64-prefixed point vector's body location inside a buffer."""

    offset: int  # first element byte (after the length prefix)
    count: int
    el_size: int

    @property
    def end(self) -> int:
        return self.offset + self.count * self.el_size


def _el_size(spec: CurveSpec, group: str, compression: UseCompression) -> int:
    return (g1_codec(spec) if group == "g1" else g2_codec(spec)).size(compression)


def _walk_vec(spec: CurveSpec, group: str, cur: Cursor, compression: UseCompression) -> _VecSpan:
    n = cur.u64()
    span = _VecSpan(cur.pos, n, _el_size(spec, group, compression))
    cur.skip(n * span.el_size)
    return span


def _layout(spec: CurveSpec, data, compression: UseCompression):
    """Walk a serialized MPCParameters buffer; returns (beta_g1 offset,
    delta_g1 offset, spans dict, cs_hash offset)."""
    g1s = _el_size(spec, "g1", compression)
    g2s = _el_size(spec, "g2", compression)
    cur = Cursor(data)
    cur.skip(g1s + 3 * g2s)  # vk singles: alpha_g1, beta_g2, gamma_g2, delta_g2
    gamma_abc = _walk_vec(spec, "g1", cur, compression)
    beta_g1_off = cur.pos
    cur.skip(g1s)
    delta_g1_off = cur.pos
    cur.skip(g1s)
    spans = {"gamma_abc": gamma_abc}
    for name, grp in (
        ("a", "g1"),
        ("b_g1", "g1"),
        ("b_g2", "g2"),
        ("h", "g1"),
        ("l", "g1"),
    ):
        spans[name] = _walk_vec(spec, grp, cur, compression)
    return beta_g1_off, delta_g1_off, spans, cur.pos


def _batches(count: int, batch_size: int):
    """[lo, hi) batches of at most batch_size (cut by MAX_LANES) covering
    range(count)."""
    step = max(1, min(batch_size, MAX_LANES))
    return [(lo, min(lo + step, count)) for lo in range(0, count, step)]


def _batched_mul_inplace(
    spec: CurveSpec,
    buf: bytearray,
    span: _VecSpan,
    scalar: int,
    batch_size: int,
    compression: UseCompression,
    check: CheckForCorrectness,
    device,
) -> None:
    """mul_query over batches (chunked_groth16.rs:387-466): read, the GLV
    scalar-mul ([scalar mod r]P: the codec's subgroup check under `check`
    keeps the points in the subgroup), write back in place. The write-backs
    run through a pipeline of depth MUL_QUERY_DEPTH (the reference's
    `flush(limit=3)`): a batch's bytes are packed once three more batches'
    scalar-muls are queued."""
    codec = batch_codec(spec.name, "g1", device)
    ops = codec.ops
    raw = ints_to_limbs_batch([scalar], ops.fr.L).T  # (Ls, 1)
    with Pipeline(MUL_QUERY_DEPTH, "mul_query") as pipe:
        for lo, hi in _batches(span.count, batch_size):
            start = span.offset + lo * span.el_size
            end = span.offset + hi * span.el_size
            pts = codec.read_batch(bytes(buf[start:end]), compression, check)
            scalars = ops.fr.tensor(np.broadcast_to(raw, (ops.fr.L, hi - lo)), codec.device)
            out = runtime.scalar_mul(ops, pts, scalars, codec.device)
            handle = codec.write_batch_start(out)

            def finish(start=start, end=end, handle=handle, n=hi - lo):
                buf[start:end] = codec.write_batch_finish(handle, compression, n_valid=n)

            pipe.push(finish)


def contribute(
    spec: CurveSpec,
    buffer: bytearray,
    rng,
    batch_size: int,
    compressed: UseCompression,
    check_correctness: CheckForCorrectness,
    device=None,
) -> bytes:
    """In-place contribution (chunked_groth16.rs:237-373). The buffer must
    already be extended by Phase2PublicKey.size(spec) bytes. Runs on the
    card unless `device="cpu"`."""
    dev = resolve_device(device)
    with info_span("phase2-chunked-contribute", logger):
        check_correctness = _element_check(check_correctness)
        g1s = _el_size(spec, "g1", compressed)
        g2s = _el_size(spec, "g2", compressed)
        beta_off, delta_off, spans, cs_hash_off = _layout(spec, buffer, compressed)
        # vk.delta_g2 sits right before gamma_abc
        delta_g2_off = g1s + 2 * g2s
        cur = Cursor(buffer, delta_g2_off)
        delta_g2 = deser_element(spec, "g2", cur, compressed, check_correctness)
        cur = Cursor(buffer, delta_off)
        delta_g1 = deser_element(spec, "g1", cur, compressed, check_correctness)

        cs_hash = bytes(buffer[cs_hash_off : cs_hash_off + 64])
        contributions, _after = Phase2PublicKey.read_batch(spec, buffer, cs_hash_off + 64)

        kp = Keypair.new(spec, rng, delta_g1, cs_hash, contributions)
        delta = kp.private_key.delta
        delta_inv = pow(delta, -1, spec.r)

        # update delta_g1 and vk.delta_g2 in place
        buffer[delta_off : delta_off + g1s] = ser_element(
            spec, "g1", g1_curve(spec).mul(delta_g1, delta), compressed
        )
        buffer[delta_g2_off : delta_g2_off + g2s] = ser_element(
            spec, "g2", g2_curve(spec).mul(delta_g2, delta), compressed
        )
        logger.debug("updated delta g1 and vk delta g2")

        for name in ("h", "l"):
            _batched_mul_inplace(
                spec, buffer, spans[name], delta_inv, batch_size, compressed, check_correctness, dev
            )
        logger.debug("appending contribution...")

        count_off = cs_hash_off + 64
        buffer[count_off : count_off + 4] = (len(contributions) + 1).to_bytes(4, "big")
        pk_off = count_off + 4 + len(contributions) * Phase2PublicKey.size(spec)
        pk_bytes = kp.public_key.write(spec)
        buffer[pk_off : pk_off + len(pk_bytes)] = pk_bytes
        return kp.public_key.hash(spec)


def _read_span_batch(codec, buf, span: _VecSpan, lo: int, hi: int, compression, check):
    """Points lo..hi of a span, decoded onto the codec's device."""
    start = span.offset + lo * span.el_size
    end = span.offset + hi * span.el_size
    return codec.read_batch(bytes(buf[start:end]), compression, check)


def verify(
    spec: CurveSpec,
    before: bytes | bytearray,
    after: bytes | bytearray,
    batch_size: int,
    compressed: UseCompression,
    check_correctness: CheckForCorrectness,
    rlc_rng=None,
    device=None,
) -> list[bytes]:
    """Streaming verification (chunked_groth16.rs:41-231); returns the
    contribution hashes. The a / b queries are compared as decoded points
    (two encodings of one point are equal), the h / l queries by the RLC
    ratio check against the delta_g2 pair. Runs on the card unless
    `device="cpu"`."""
    dev = resolve_device(device)
    with info_span("phase2-chunked-verify", logger):
        check_correctness = _element_check(check_correctness)
        eng = pairing_engine(spec.name)
        cur_b = Cursor(before)
        vk_before = VerifyingKey.read(spec, cur_b, compressed, check_correctness, device=dev)
        beta_b = deser_element(spec, "g1", cur_b, compressed, check_correctness)
        cur_a = Cursor(after)
        vk_after = VerifyingKey.read(spec, cur_a, compressed, check_correctness, device=dev)
        beta_a = deser_element(spec, "g1", cur_a, compressed, check_correctness)
        delta_g1_after = deser_element(spec, "g1", cur_a, compressed, check_correctness)

        ensure_unchanged(vk_before.alpha_g1, vk_after.alpha_g1, InvariantKind.ALPHA_G1)
        ensure_unchanged(beta_b, beta_a, InvariantKind.BETA_G1)
        ensure_unchanged(vk_before.beta_g2, vk_after.beta_g2, InvariantKind.BETA_G2)
        ensure_unchanged(vk_before.gamma_g2, vk_after.gamma_g2, InvariantKind.GAMMA_G2)
        ensure_unchanged_vec(
            vk_before.gamma_abc_g1, vk_after.gamma_abc_g1, InvariantKind.GAMMA_ABC_G1
        )
        logger.debug("initial elements unchanged")

        _, _, spans_b, cs_off_b = _layout(spec, before, compressed)
        _, _, spans_a, cs_off_a = _layout(spec, after, compressed)

        for name, grp, kind in (
            ("a", "g1", InvariantKind.A_QUERY),
            ("b_g1", "g1", InvariantKind.B_G1_QUERY),
            ("b_g2", "g2", InvariantKind.B_G2_QUERY),
        ):
            sb, sa = spans_b[name], spans_a[name]
            if sb.count != sa.count:
                raise InvalidLengthError(sb.count, sa.count)
            codec = batch_codec(spec.name, grp, dev)
            for lo, hi in _batches(sb.count, batch_size):
                eb = _read_span_batch(codec, before, sb, lo, hi, compressed, check_correctness)
                ea = _read_span_batch(codec, after, sa, lo, hi, compressed, check_correctness)
                ensure_unchanged_vec(codec.ops.to_affine_host(eb), codec.ops.to_affine_host(ea), kind)

        codec = batch_codec(spec.name, "g1", dev)
        for name, err in (("h", "H_query ratio check failed"), ("l", "L_query ratio check failed")):
            sb, sa = spans_b[name], spans_a[name]
            if sb.count != sa.count:
                raise InvalidLengthError(sb.count, sa.count)
            for lo, hi in _batches(sb.count, batch_size):
                eb = _read_span_batch(codec, before, sb, lo, hi, compressed, check_correctness)
                ea = _read_span_batch(codec, after, sa, lo, hi, compressed, check_correctness)
                eng.check_same_ratio(
                    merge_point_pairs(codec.ops, eb, ea, rlc_rng),
                    (vk_after.delta_g2, vk_before.delta_g2),
                    err,
                )

        cs_before = bytes(before[cs_off_b : cs_off_b + 64])
        cs_after = bytes(after[cs_off_a : cs_off_a + 64])
        ensure_unchanged(cs_before, cs_after, InvariantKind.CS_HASH)
        logger.debug("cs hash was unchanged")

        contributions_before, _ = Phase2PublicKey.read_batch(spec, before, cs_off_b + 64)
        contributions_after, _ = Phase2PublicKey.read_batch(spec, after, cs_off_a + 64)
        ensure_unchanged(
            contributions_before,
            contributions_after[: len(contributions_before)],
            InvariantKind.CONTRIBUTIONS,
        )
        if not contributions_after:
            raise NoContributionsError("There were no contributions found")
        pub_key = contributions_after[-1]
        ensure_unchanged(pub_key.delta_after, delta_g1_after, InvariantKind.DELTA_G1)
        eng.check_same_ratio(
            (g1_curve(spec).generator, pub_key.delta_after),
            (g2_curve(spec).generator, vk_after.delta_g2),
            "Inconsistent G2 Delta",
        )
        logger.debug("public key was updated correctly")
        return verify_transcript(spec, cs_before, contributions_after)
