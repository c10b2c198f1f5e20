"""Phase 1 protocol operations over raw byte buffers, on the card.

Buffer-oriented API mirroring the reference's `Phase1` static methods
(phase1/src/{initialization,computation,verification,aggregation}.rs):
every operation takes `&[u8]`-style buffers so the CLI can hand it mmaps and
tests can hand it bytearrays.

Every curve of the CLI (BLS12-377/381, BW6-761, MNT4-753, MNT6-753). The hot
loops run on the device (the card unless the caller passes `device="cpu"`):
- computation: per batch, powers tau^i are generated there (vectorized
  square-and-multiply over the exponent bits), applied with the batched
  scalar-mul (the CUDA kernels of `ops/`), then batch-normalized and
  recompressed there; only byte packing runs on the host.
- verification: per batch, decompression, the subgroup check and the two
  random-linear-combination MSMs of the power-pair check run there; only
  the O(1) pairing ratio checks run on the host. Verification doubles as
  decompression: each verified batch is written into the new challenge.
"""

from __future__ import annotations

import secrets

import numpy as np
import torch

from ..curves.host import INFINITY, g1_curve, g2_curve
from ..curves.pairing import pairing_engine
from ..fields.limb import ints_to_limbs_batch
from ..ops import lanes
from ..ops.codec import BatchPointCodec, batch_codec
from ..ops.curve import CurveOps, PointVec
from ..ops.msm import RLC_BITS, msm_public, rlc_scalars_padded
from ..serialize.arkworks import g1_codec, g2_codec
from ..shard import runtime
from ..transcript.hashing import blank_hash, compute_g2_s
from ..utils.device import resolve_device, to_device
from ..utils.enums import (
    BatchExpMode,
    CheckForCorrectness,
    ContributionMode,
    ElementType,
    ProvingSystem,
    SubgroupCheckMode,
    UseCompression,
)
from ..utils.errors import (
    BatchTooSmallError,
    Error,
    IncorrectSubgroupError,
    InvalidGeneratorError,
)
from ..utils.pipeline import Pipeline
from ..utils.tracing import get_logger, info_span
from .buffers import Section, iter_chunk, split, split_at_chunk
from .keys import PrivateKey, PublicKey, key_generation
from .parameters import Phase1Parameters

logger = get_logger("snark_setup_tpu_torch.phase1")

PIPELINE_DEPTH = 4
"""Batches of `computation` whose write-back may be pending (the reference's
PIPELINE_DEPTH): their scalar-muls and write conversions are queued on the
card, and the byte packing of the oldest runs once a fourth is queued."""

VERIFY_PIPELINE_DEPTH = 3
"""Sections of `verification` (and of `aggregate_verification`) whose
checks may be pending (the reference's VERIFY_PIPELINE_DEPTH and
`vflush(limit=2)`): the subgroup flags, the ratio checks' MSMs and the new
challenge's write conversion are queued, and section i's host half (the
flag read-back, the pairings, the byte packing) runs after the reads of
sections i + 1 and i + 2."""

RECODE_BATCH = 1 << 16
"""Points per device batch of combine / split / decompress and of the test
helpers (de)serialize. The bound is the card's memory: decompressing a batch
keeps a few (2L, L, B) int64 product tables of the plain field layer alive,
~1.2 GB at L = 48 and B = 2^16, far below 80 GB."""

def _chunk_rel(parameters: Phase1Parameters, start: int, end: int) -> tuple[int, int]:
    if parameters.contribution_mode is ContributionMode.CHUNKED:
        base = parameters.chunk_index * parameters.chunk_size
        return start - base, end - base
    return start, end


def _end_in_powers(parameters: Phase1Parameters, start: int, end: int) -> int:
    """End of the batch [start, end) in the sections of powers_length
    elements (tau_g2, alpha_g1, beta_g1): the last batch reaching past that
    length (or past the chunk) ends at it."""
    if parameters.contribution_mode is ContributionMode.CHUNKED:
        mx = min((parameters.chunk_index + 1) * parameters.chunk_size, parameters.powers_length)
    else:
        mx = parameters.powers_length
    return mx if start + parameters.batch_size > mx else end


def _chunk_sections(chunk_params: Phase1Parameters, chunk_index: int, with_beta_g2: bool) -> list[str]:
    """Sections a chunk holds, for combine (beta_g2 from chunk 0 only) and
    split (beta_g2 in every chunk) — aggregation.rs."""
    start = chunk_index * chunk_params.chunk_size
    if chunk_params.proving_system is ProvingSystem.GROTH16:
        names = ["tau_g1"]
        if start < chunk_params.powers_length:
            names += ["tau_g2", "alpha_g1", "beta_g1"]
        if with_beta_g2:
            names.append("beta_g2")
        return names
    n = chunk_params.total_size_in_log2
    names = ["tau_g1"]
    if start < 2 + n:
        names.append("tau_g2")
    if start < 3 + 3 * n:
        names.append("alpha_g1")
    return names


class Phase1:
    """Container mirroring the reference Phase1 struct (host points); the
    static protocol methods operate directly on buffers."""

    def __init__(self, tau_powers_g1, tau_powers_g2, alpha_tau_powers_g1, beta_tau_powers_g1,
                 beta_g2, hash_bytes, parameters):
        self.tau_powers_g1 = tau_powers_g1
        self.tau_powers_g2 = tau_powers_g2
        self.alpha_tau_powers_g1 = alpha_tau_powers_g1
        self.beta_tau_powers_g1 = beta_tau_powers_g1
        self.beta_g2 = beta_g2
        self.hash = hash_bytes
        self.parameters = parameters

    def __eq__(self, other):
        return (
            self.tau_powers_g1 == other.tau_powers_g1
            and self.tau_powers_g2 == other.tau_powers_g2
            and self.alpha_tau_powers_g1 == other.alpha_tau_powers_g1
            and self.beta_tau_powers_g1 == other.beta_tau_powers_g1
            and self.beta_g2 == other.beta_g2
        )

    # ------------------------------------------------------------------
    # Key generation (phase1/src/key_generation.rs)
    # ------------------------------------------------------------------
    @staticmethod
    def key_generation(spec, rng, digest: bytes):
        return key_generation(spec, rng, digest)

    # ------------------------------------------------------------------
    # Initialization (phase1/src/initialization.rs:12-56)
    # ------------------------------------------------------------------
    @staticmethod
    def initialization(
        output: bytearray,
        compressed_output: UseCompression,
        parameters: Phase1Parameters,
    ) -> None:
        with info_span("phase1-initialization", logger):
            spec = parameters.spec
            sections = split(parameters, compressed_output)
            gen_bytes = {
                "g1": g1_codec(spec).serialize(g1_curve(spec).generator, compressed_output),
                "g2": g2_codec(spec).serialize(g2_curve(spec).generator, compressed_output),
            }
            out = np.frombuffer(memoryview(output), np.uint8)
            for name, sec in sections.items():
                if sec.num_elements == 0:
                    continue
                g = gen_bytes["g2"] if name in ("tau_g2", "beta_g2") else gen_bytes["g1"]
                tile = np.tile(np.frombuffer(g, np.uint8), sec.num_elements)
                out[sec.offset : sec.end] = tile

    # ------------------------------------------------------------------
    # Computation / contribute (phase1/src/computation.rs:16-308)
    # ------------------------------------------------------------------
    @staticmethod
    @torch.no_grad()
    def computation(
        input_buf,
        output: bytearray,
        compressed_input: UseCompression,
        compressed_output: UseCompression,
        check_input_for_correctness: CheckForCorrectness,
        batch_exp_mode: BatchExpMode,
        key: PrivateKey,
        parameters: Phase1Parameters,
        device=None,
    ) -> None:
        """Apply the private key to every element of the accumulator in
        `input_buf` and write the new accumulator into `output`. Runs on the
        card unless `device="cpu"` is passed."""
        dev = resolve_device(device)
        with info_span("phase1-computation", logger), Pipeline(PIPELINE_DEPTH, "computation") as pipe:
            spec = parameters.spec
            sec_in = split(parameters, compressed_input)
            sec_out = split(parameters, compressed_output)
            c1 = batch_codec(spec.name, "g1", dev)
            c2 = batch_codec(spec.name, "g2", dev)
            fr = c1.ops.fr

            def apply_powers(
                codec: BatchPointCodec,
                section_out: Section,
                section_in: Section,
                sc: int,
                ec: int,
                exp_ints: list[int] | None,
                exp_range: tuple[int, int] | None,
                coeff: int | None,
            ):
                """Read [sc,ec) of section, raise to powers, queue the
                write-back (its byte packing runs in the pipeline). Powers
                come either from explicit host ints (exp_ints) or a
                device-generated tau^i range (exp_range=(start,end))."""
                n = ec - sc
                pts = codec.read_batch(
                    bytes(section_in.slice_of(input_buf, sc, ec)),
                    compressed_input,
                    check_input_for_correctness,
                )
                if exp_ints is not None:
                    vals = list(exp_ints[:n])
                    if coeff is not None:
                        vals = [v * coeff % spec.r for v in vals]
                    raw = fr.tensor(ints_to_limbs_batch(vals, fr.L).T, dev)
                else:
                    s, _e = exp_range
                    raw = _tau_powers_raw(fr, key.tau, s, s + n, coeff, dev)
                prod = runtime.scalar_mul(codec.ops, pts, raw, dev)
                handle = codec.write_batch_start(prod)

                def finish():
                    section_out.slice_of(output, sc, ec)[:] = codec.write_batch_finish(
                        handle, compressed_output, n_valid=n
                    )

                pipe.push(finish)

            if parameters.proving_system is ProvingSystem.GROTH16:
                # beta_g2 single element
                hb = g2_codec(spec)
                beta_el = hb.deserialize(
                    bytes(sec_in["beta_g2"].slice_of(input_buf, 0, 1)),
                    compressed_input,
                    check_input_for_correctness,
                )
                beta_el = g2_curve(spec).mul(beta_el, key.beta)
                sec_out["beta_g2"].slice_of(output, 0, 1)[:] = hb.serialize(
                    beta_el, compressed_output
                )

                for start, end in iter_chunk(parameters):
                    sc, ec = _chunk_rel(parameters, start, end)
                    apply_powers(
                        c1, sec_out["tau_g1"], sec_in["tau_g1"], sc, ec, None, (start, end), None
                    )
                    if start < parameters.powers_length:
                        end2 = _end_in_powers(parameters, start, end)
                        sc2, ec2 = _chunk_rel(parameters, start, end2)
                        apply_powers(
                            c2, sec_out["tau_g2"], sec_in["tau_g2"], sc2, ec2, None, (start, end2), None
                        )
                        apply_powers(
                            c1, sec_out["alpha_g1"], sec_in["alpha_g1"], sc2, ec2, None,
                            (start, end2), key.alpha,
                        )
                        apply_powers(
                            c1, sec_out["beta_g1"], sec_in["beta_g1"], sc2, ec2, None,
                            (start, end2), key.beta,
                        )
            else:  # Marlin
                n = parameters.total_size_in_log2
                if parameters.chunk_index == 0:
                    r = spec.r
                    degree_bound_powers = [
                        pow(key.tau, parameters.powers_length - 1 - (1 << i) + 2, r)
                        for i in range(n)
                    ]
                    g2_inverse_powers = [pow(p, -1, r) for p in degree_bound_powers]
                    apply_powers(
                        c2, sec_out["tau_g2"], sec_in["tau_g2"], 2, n + 2, g2_inverse_powers, None, None
                    )
                    g1_degree_powers = []
                    for f in degree_bound_powers:
                        g1_degree_powers += [f, f * key.tau % r, f * pow(key.tau, 2, r) % r]
                    apply_powers(
                        c1, sec_out["alpha_g1"], sec_in["alpha_g1"], 3, 3 + 3 * n,
                        g1_degree_powers, None, key.alpha,
                    )
                    alpha_powers = [pow(key.tau, i, r) for i in range(3)]
                    apply_powers(
                        c1, sec_out["alpha_g1"], sec_in["alpha_g1"], 0, 3, alpha_powers, None, key.alpha
                    )
                    tau01 = [1, key.tau % r]
                    apply_powers(
                        c2, sec_out["tau_g2"], sec_in["tau_g2"], 0, 2, tau01, None, None
                    )
                for start, end in iter_chunk(parameters):
                    sc, ec = _chunk_rel(parameters, start, end)
                    apply_powers(
                        c1, sec_out["tau_g1"], sec_in["tau_g1"], sc, ec, None, (start, end), None
                    )

    # ------------------------------------------------------------------
    # Verification (phase1/src/verification.rs:26-500)
    # ------------------------------------------------------------------
    @staticmethod
    @torch.no_grad()
    def verification(
        input_buf,
        output_buf,
        new_challenge: bytearray,
        key: PublicKey,
        digest: bytes,
        compressed_input: UseCompression,
        compressed_output: UseCompression,
        compressed_new_challenge: UseCompression,
        check_input_for_correctness: CheckForCorrectness,
        check_output_for_correctness: CheckForCorrectness,
        subgroup_check_mode: SubgroupCheckMode,
        ratio_check: bool,
        parameters: Phase1Parameters,
        rlc_rng=None,
        device=None,
    ) -> None:
        """Verify the contribution `output_buf` made to `input_buf` under
        `key` and write the verified points into `new_challenge`. Raises on
        the first failed check. Runs on the card unless `device="cpu"`;
        `rlc_rng` (a `random.Random`) makes the ratio checks' scalars
        reproducible.

        The sections run through a bounded pipeline of depth
        VERIFY_PIPELINE_DEPTH, as the reference's do: a section's read
        raises at once (a point at infinity, off the curve, malformed), its
        subgroup and ratio checks and its write into the new challenge run
        after the next two sections' reads. Same checks, same exceptions in
        the same order, same new challenge."""
        dev = resolve_device(device)
        with info_span("phase1-verification", logger):
            spec = parameters.spec
            eng = pairing_engine(spec.name)
            sec_out = split(parameters, compressed_output)
            sec_new = split(parameters, compressed_new_challenge)
            hc1, hc2 = g1_codec(spec), g2_codec(spec)
            g1c, g2c = g1_curve(spec), g2_curve(spec)

            def read_initial(section: Section, buf, compressed, check, codec, amount=2):
                return [
                    codec.deserialize(bytes(section.slice_of(buf, i, i + 1)), compressed, check)
                    for i in range(amount)
                ]

            # g1/g2 check pairs from the OUTPUT's first two tau elements
            try:
                after_g1 = read_initial(
                    sec_out["tau_g1"], output_buf, compressed_output, check_output_for_correctness, hc1
                )
                after_g2 = read_initial(
                    sec_out["tau_g2"], output_buf, compressed_output, check_output_for_correctness, hc2
                )
                g1_check = (after_g1[0], after_g1[1])
                g2_check = (after_g2[0], after_g2[1])
            except Error:
                g1_check = (INFINITY, INFINITY)
                g2_check = (INFINITY, INFINITY)
                ratio_check = False

            if parameters.contribution_mode is ContributionMode.FULL or parameters.chunk_index == 0:
                sec_in = split(parameters, compressed_input)
                tau_g2_s = compute_g2_s(spec, digest, key.tau_g1[0], key.tau_g1[1], 0)
                alpha_g2_s = compute_g2_s(spec, digest, key.alpha_g1[0], key.alpha_g1[1], 1)
                beta_g2_s = compute_g2_s(spec, digest, key.beta_g1[0], key.beta_g1[1], 2)

                tau_single_g2 = (tau_g2_s, key.tau_g2)
                alpha_single_g2 = (alpha_g2_s, key.alpha_g2)
                beta_single_g1 = (key.beta_g1[0], key.beta_g1[1])
                beta_single_g2 = (beta_g2_s, key.beta_g2)

                # proof-of-knowledge ratio checks
                eng.check_same_ratio((key.tau_g1[0], key.tau_g1[1]), tau_single_g2, "Tau G1<>G2")
                eng.check_same_ratio((key.alpha_g1[0], key.alpha_g1[1]), alpha_single_g2, "Alpha G1<>G2")
                eng.check_same_ratio(beta_single_g1, beta_single_g2, "Beta G1<>G2")
                logger.debug("key ratios were correctly produced")

                # initial-element spot checks
                before_g1 = read_initial(
                    sec_in["tau_g1"], input_buf, compressed_input, check_input_for_correctness, hc1
                )
                after_g1 = read_initial(
                    sec_out["tau_g1"], output_buf, compressed_output, check_output_for_correctness, hc1
                )
                if after_g1[0] != g1c.generator:
                    raise InvalidGeneratorError(ElementType.TAU_G1)
                eng.check_same_ratio((before_g1[1], after_g1[1]), tau_single_g2, "Before-After: tau_g1")
                before_g2 = read_initial(
                    sec_in["tau_g2"], input_buf, compressed_input, check_input_for_correctness, hc2
                )
                after_g2 = read_initial(
                    sec_out["tau_g2"], output_buf, compressed_output, check_output_for_correctness, hc2
                )
                if after_g2[0] != g2c.generator:
                    raise InvalidGeneratorError(ElementType.TAU_G2)
                eng.check_same_ratio(
                    (key.tau_g1[0], key.tau_g1[1]), (before_g2[1], after_g2[1]), "Before-After: tau_g2"
                )
                checks = [("alpha_g1", alpha_single_g2)]
                if parameters.proving_system is ProvingSystem.GROTH16:
                    checks.append(("beta_g1", beta_single_g2))
                for sec_name, check in checks:
                    b = read_initial(
                        sec_in[sec_name], input_buf, compressed_input, check_input_for_correctness, hc1
                    )
                    a = read_initial(
                        sec_out[sec_name], output_buf, compressed_output, check_output_for_correctness, hc1
                    )
                    eng.check_same_ratio((b[0], a[0]), check, "Before-After: alpha_g1[0] / beta_g1[0]")
                if parameters.proving_system is ProvingSystem.GROTH16:
                    before_beta_g2 = hc2.deserialize(
                        bytes(sec_in["beta_g2"].slice_of(input_buf, 0, 1)),
                        compressed_input,
                        check_input_for_correctness,
                    )
                    after_beta_g2 = hc2.deserialize(
                        bytes(sec_out["beta_g2"].slice_of(output_buf, 0, 1)),
                        compressed_output,
                        check_output_for_correctness,
                    )
                    sec_new["beta_g2"].slice_of(new_challenge, 0, 1)[:] = hc2.serialize(
                        after_beta_g2, compressed_new_challenge
                    )
                    eng.check_same_ratio(
                        beta_single_g1, (before_beta_g2, after_beta_g2), "Before-After: beta_g2[0]"
                    )

            logger.debug("initial elements were computed correctly")

            dc1 = batch_codec(spec.name, "g1", dev)
            dc2 = batch_codec(spec.name, "g2", dev)
            pipe = Pipeline(VERIFY_PIPELINE_DEPTH, "verification")

            def process_section(codec: BatchPointCodec, sec_name: str, sc: int, ec: int, do_ratio: bool,
                                check_pair_g2=None, check_pair_g1=None):
                """Nonzero + subgroup check, optional RLC power-pair ratio
                check, and write-through into the new challenge."""
                n = ec - sc
                pad = runtime.pad_width(parameters.batch_size + 1, dev)
                pts = codec.read_batch(
                    bytes(sec_out[sec_name].slice_of(output_buf, sc, ec)),
                    compressed_output,
                    CheckForCorrectness.ONLY_NON_ZERO,
                    pad_to=pad,
                )
                pts = runtime.put_points(codec.ops, pts, dev)
                sg = _subgroup_start(codec, pts, subgroup_check_mode, n)
                pp = None
                if do_ratio:
                    scalars = rlc_scalars_padded(n - 1, pad - 1, rng=rlc_rng)
                    pp = _power_pairs_start(codec.ops, pts, scalars)
                handle = codec.write_batch_start(runtime.gather(pts), normalized=True)

                def finish():
                    _subgroup_finish(sg)
                    if pp is not None:
                        s_pt, sx_pt = _power_pairs_finish(codec.ops, pp)
                        if check_pair_g2 is not None:
                            eng.check_same_ratio((s_pt, sx_pt), check_pair_g2, f"Power pairs {sec_name}")
                        else:
                            eng.check_same_ratio(check_pair_g1, (s_pt, sx_pt), f"Power pairs {sec_name}")
                    sec_new[sec_name].slice_of(new_challenge, sc, ec)[:] = codec.write_batch_finish(
                        handle, compressed_new_challenge, n_valid=n
                    )

                pipe.push(finish)

            with pipe:
                for start, end in iter_chunk(parameters):
                    sc, ec = _chunk_rel(parameters, start, end)
                    if ratio_check and end <= start + 1:
                        raise BatchTooSmallError()
                    if parameters.proving_system is ProvingSystem.GROTH16:
                        process_section(dc1, "tau_g1", sc, ec, ratio_check, check_pair_g2=g2_check)
                        if start < parameters.powers_length:
                            end2 = _end_in_powers(parameters, start, end)
                            sc2, ec2 = _chunk_rel(parameters, start, end2)
                            if end2 > start + 1:
                                process_section(dc2, "tau_g2", sc2, ec2, ratio_check, check_pair_g1=g1_check)
                                process_section(dc1, "alpha_g1", sc2, ec2, ratio_check, check_pair_g2=g2_check)
                                process_section(dc1, "beta_g1", sc2, ec2, ratio_check, check_pair_g2=g2_check)
                    else:  # Marlin
                        process_section(dc1, "tau_g1", sc, ec, False)
                        if start == 0:
                            n = parameters.total_size_in_log2
                            process_section(dc1, "alpha_g1", 0, 3 + 3 * n, False)
                            process_section(dc2, "tau_g2", 0, n + 2, False)

    # ------------------------------------------------------------------
    # Aggregate verification (verification.rs:505-769)
    # ------------------------------------------------------------------
    @staticmethod
    @torch.no_grad()
    def aggregate_verification(
        output_buf,
        compressed_output: UseCompression,
        check_output_for_correctness: CheckForCorrectness,
        parameters: Phase1Parameters,
        rlc_rng=None,
        device=None,
    ) -> None:
        """RLC ratio checks over a whole (combined) accumulator, batch by
        batch, on the card unless `device="cpu"`. The MSMs of a section are
        queued and its pairings run after the next two sections' reads
        (the pipeline of `verification`)."""
        dev = resolve_device(device)
        with info_span("phase1-aggregate-verification", logger):
            spec = parameters.spec
            eng = pairing_engine(spec.name)
            sec = split(parameters, compressed_output)
            hc1, hc2 = g1_codec(spec), g2_codec(spec)
            dc1 = batch_codec(spec.name, "g1", dev)
            dc2 = batch_codec(spec.name, "g2", dev)

            def read_el(codec, section, i, check=check_output_for_correctness):
                return codec.deserialize(bytes(section.slice_of(output_buf, i, i + 1)), compressed_output, check)

            g1_check = (read_el(hc1, sec["tau_g1"], 0), read_el(hc1, sec["tau_g1"], 1))
            g2_check = (read_el(hc2, sec["tau_g2"], 0), read_el(hc2, sec["tau_g2"], 1))
            alpha_check = (read_el(hc1, sec["alpha_g1"], 0), read_el(hc1, sec["alpha_g1"], 1))
            pipe = Pipeline(VERIFY_PIPELINE_DEPTH, "aggregate_verification")

            def ratio_section(codec, sec_name, s, e, check_pair_g2=None, check_pair_g1=None):
                n = e - s
                pad = runtime.pad_width(parameters.batch_size + 1, dev)
                pts = codec.read_batch(
                    bytes(sec[sec_name].slice_of(output_buf, s, e)),
                    compressed_output,
                    check_output_for_correctness,
                    subgroup_mode=SubgroupCheckMode.NO,
                    pad_to=pad,
                )
                pts = runtime.put_points(codec.ops, pts, dev)
                scalars = rlc_scalars_padded(n - 1, pad - 1, rng=rlc_rng)
                pp = _power_pairs_start(codec.ops, pts, scalars)

                def finish():
                    s_pt, sx_pt = _power_pairs_finish(codec.ops, pp)
                    if check_pair_g2 is not None:
                        eng.check_same_ratio((s_pt, sx_pt), check_pair_g2, f"Power pairs {sec_name}")
                    else:
                        eng.check_same_ratio(check_pair_g1, (s_pt, sx_pt), f"Power pairs {sec_name}")

                pipe.push(finish)

            with pipe:
                if parameters.proving_system is ProvingSystem.GROTH16:
                    for start, end in iter_chunk(parameters):
                        ratio_section(dc1, "tau_g1", start, end, check_pair_g2=g2_check)
                        if start < parameters.powers_length:
                            end2 = (
                                parameters.powers_length
                                if start + parameters.batch_size > parameters.powers_length
                                else end
                            )
                            if end2 > start + 1:
                                ratio_section(dc2, "tau_g2", start, end2, check_pair_g1=g1_check)
                                ratio_section(dc1, "alpha_g1", start, end2, check_pair_g2=g2_check)
                                ratio_section(dc1, "beta_g1", start, end2, check_pair_g2=g2_check)
                else:  # Marlin
                    n = parameters.total_size_in_log2
                    for start, end in iter_chunk(parameters):
                        ratio_section(dc1, "tau_g1", start, end, check_pair_g2=g2_check)
                        powers_in_range = [(i, parameters.powers_length - 1 - (1 << i) + 2) for i in range(n)]
                        for i, p in [(i, p) for i, p in powers_in_range if start <= p < end]:
                            g1_el = read_el(hc1, sec["tau_g1"], p)
                            g2_el = read_el(hc2, sec["tau_g2"], 2 + i)
                            eng.check_same_ratio(
                                (g1_el, g1_curve(spec).generator), (g2_curve(spec).generator, g2_el), "G1<>G2"
                            )
                            a0 = read_el(hc1, sec["alpha_g1"], 3 + 3 * i)
                            a1 = read_el(hc1, sec["alpha_g1"], 3 + 3 * i + 1)
                            a2 = read_el(hc1, sec["alpha_g1"], 3 + 3 * i + 2)
                            eng.check_same_ratio((a0, a1), g2_check, "alpha_g1 ratio 1")
                            eng.check_same_ratio((a1, a2), g2_check, "alpha_g1 ratio 2")
                            eng.check_same_ratio(
                                (a0, alpha_check[0]), (g2_curve(spec).generator, g2_el), "alpha consistent"
                            )
                        if start == 0:
                            ratio_section(dc1, "alpha_g1", 0, 3, check_pair_g2=g2_check)
                            ratio_section(dc2, "tau_g2", 0, 2, check_pair_g1=g1_check)

    # ------------------------------------------------------------------
    # Aggregation / combine (aggregation.rs:11-180)
    # ------------------------------------------------------------------
    @staticmethod
    @torch.no_grad()
    def aggregation(
        inputs: list[tuple[bytes, UseCompression]],
        output: bytearray,
        compressed_output: UseCompression,
        parameters: Phase1Parameters,
        device=None,
    ) -> None:
        """Combine per-chunk accumulators into one full accumulator."""
        dev = resolve_device(device)
        with info_span("phase1-aggregation", logger):
            for chunk_index, (input_buf, compressed_input) in enumerate(inputs):
                chunk_params = parameters.into_chunk_parameters(
                    parameters.contribution_mode, chunk_index, parameters.chunk_size
                )
                sec_in = split(chunk_params, compressed_input)
                sec_out = split_at_chunk(chunk_params, compressed_output)
                for name in _chunk_sections(chunk_params, chunk_index, with_beta_g2=chunk_index == 0):
                    _recode_section(chunk_params, name, input_buf, sec_in[name], compressed_input,
                                    output, sec_out[name], compressed_output, device=dev)

    # ------------------------------------------------------------------
    # Split (aggregation.rs:183-352)
    # ------------------------------------------------------------------
    @staticmethod
    @torch.no_grad()
    def split(
        input_buf,
        compressed_input: UseCompression,
        outputs: list[tuple[bytearray, UseCompression]],
        parameters: Phase1Parameters,
        device=None,
    ) -> None:
        """Cut a full accumulator into per-chunk accumulators."""
        dev = resolve_device(device)
        with info_span("phase1-split", logger):
            for chunk_index, (output, compressed_output) in enumerate(outputs):
                chunk_params = parameters.into_chunk_parameters(
                    parameters.contribution_mode, chunk_index, parameters.chunk_size
                )
                sec_in = split_at_chunk(chunk_params, compressed_input)
                sec_out = split(chunk_params, compressed_output)
                for name in _chunk_sections(chunk_params, chunk_index, with_beta_g2=True):
                    _recode_section(chunk_params, name, input_buf, sec_in[name], compressed_input,
                                    output, sec_out[name], compressed_output, device=dev)

    # ------------------------------------------------------------------
    # Decompress (accumulator.rs:200-301)
    # ------------------------------------------------------------------
    @staticmethod
    @torch.no_grad()
    def decompress(
        input_buf,
        output: bytearray,
        check_input_for_correctness: CheckForCorrectness,
        parameters: Phase1Parameters,
        device=None,
    ) -> None:
        dev = resolve_device(device)
        sec_in = split(parameters, UseCompression.YES)
        sec_out = split(parameters, UseCompression.NO)
        for name in ("tau_g1", "tau_g2", "alpha_g1", "beta_g1", "beta_g2"):
            if sec_in[name].num_elements == 0:
                continue
            _recode_section(parameters, name, input_buf, sec_in[name], UseCompression.YES, output,
                            sec_out[name], UseCompression.NO, check=check_input_for_correctness,
                            device=dev)

    # ------------------------------------------------------------------
    # Host (de)serialization for tests (serialization.rs)
    # ------------------------------------------------------------------
    @staticmethod
    @torch.no_grad()
    def deserialize(
        input_buf,
        compression: UseCompression,
        check_input_for_correctness: CheckForCorrectness,
        parameters: Phase1Parameters,
        device=None,
    ) -> "Phase1":
        dev = resolve_device(device)
        spec = parameters.spec
        sec = split(parameters, compression)
        dc1 = batch_codec(spec.name, "g1", dev)
        dc2 = batch_codec(spec.name, "g2", dev)
        B = min(parameters.batch_size, RECODE_BATCH)

        def read_vec(codec, s: Section):
            out = []
            for off in range(0, s.num_elements, B):
                hi = min(off + B, s.num_elements)
                pts = codec.read_batch(
                    bytes(s.slice_of(input_buf, off, hi)), compression, check_input_for_correctness,
                    subgroup_mode=SubgroupCheckMode.AUTO,
                )
                out.extend(codec.ops.to_affine_host(pts))
            return out

        beta_g2 = read_vec(dc2, sec["beta_g2"])
        return Phase1(
            read_vec(dc1, sec["tau_g1"]),
            read_vec(dc2, sec["tau_g2"]),
            read_vec(dc1, sec["alpha_g1"]),
            read_vec(dc1, sec["beta_g1"]),
            beta_g2[0] if beta_g2 else None,
            blank_hash(),
            parameters,
        )

    @staticmethod
    @torch.no_grad()
    def serialize_accumulator(
        acc: "Phase1", output: bytearray, compression: UseCompression, parameters: Phase1Parameters,
        device=None,
    ) -> None:
        dev = resolve_device(device)
        spec = parameters.spec
        sec = split(parameters, compression)
        dc1 = batch_codec(spec.name, "g1", dev)
        dc2 = batch_codec(spec.name, "g2", dev)
        B = min(parameters.batch_size, RECODE_BATCH)

        def write_vec(codec, s: Section, pts):
            # synchronous, as the reference's: the pipeline at depth 1
            with Pipeline(1, "serialize_accumulator") as pipe:
                for off in range(0, len(pts), B):
                    chunk = pts[off : off + B]
                    _write_back(pipe, codec, codec.ops.from_affine_host(chunk, dev), compression,
                                s.slice_of(output, off, off + len(chunk)))

        write_vec(dc1, sec["tau_g1"], acc.tau_powers_g1)
        write_vec(dc2, sec["tau_g2"], acc.tau_powers_g2)
        write_vec(dc1, sec["alpha_g1"], acc.alpha_tau_powers_g1)
        write_vec(dc1, sec["beta_g1"], acc.beta_tau_powers_g1)
        if acc.beta_g2 is not None:
            write_vec(dc2, sec["beta_g2"], [acc.beta_g2])


# ----------------------------------------------------------------------
# device helpers
# ----------------------------------------------------------------------


def _tau_powers_raw(fr, tau: int, start: int, end: int, coeff: int | None, device) -> torch.Tensor:
    """Raw (standard-form) limb scalars tau^i (optionally * coeff) for
    i in [start, end), generated on `device`: (Ls, end-start) int32.

    Replaces generate_powers_of_tau (helpers.rs:32-37)."""
    tau_mont = fr.tensor(fr.from_int(tau)[:, None], device)
    exps = torch.arange(start, end, dtype=torch.int64, device=device)
    cm = fr.tensor(fr.from_int(coeff)[:, None] if coeff is not None else fr.one_mont_np, device)
    return _pow_u32(fr, tau_mont, exps, cm, max(end - 1, 0))


def _pow_u32(
    fr, base_mont: torch.Tensor, exps: torch.Tensor, coeff_mont: torch.Tensor, max_exp: int
) -> torch.Tensor:
    """(base^e * coeff) in standard form for a batch of exponents
    <= max_exp < 2^32 (int64 tensor): square-and-multiply with a per-lane
    select, over as many bits as `max_exp` has (host-known, so nothing waits
    for the device). The exponents are the public indices i of tau^i."""
    nbits = max(1, max_exp.bit_length())
    if nbits > 32:
        raise ValueError("exponent does not fit 32 bits")
    acc = fr.ones((exps.shape[0],), exps.device)
    for b in range(nbits - 1, -1, -1):
        acc = fr.mont_sqr(acc)
        bit = ((exps >> b) & 1).bool()
        acc = fr.select(bit, fr.mont_mul(acc, base_mont), acc)
    return fr.from_mont(fr.mont_mul(acc, coeff_mont))


def _power_pairs_start(ops: CurveOps, pts, scalars_raw: np.ndarray):
    """merge_pairs(v[:-1], v[1:]) with shared random scalars
    (helpers.rs:371-390): two MSMs over public scalars on the points'
    device. Returns the two 1-point sums without waiting for the device.

    Both MSMs run over the whole batch, v[:-1] as the scalars with a 0
    appended and v[1:] as a 0 followed by the scalars (one lane more than
    slicing the points, with a zero scalar). On a batch cut over a mesh
    (shard/runtime.py) each is a per-shard partial MSM added across the
    shards: no shard needs a neighbour's points."""
    zero = np.zeros((scalars_raw.shape[0], 1), scalars_raw.dtype)
    msm = lambda p, s: msm_public(ops, p, s, RLC_BITS)
    return (runtime.reduce_over(ops, msm, pts, np.concatenate([scalars_raw, zero], axis=1)),
            runtime.reduce_over(ops, msm, pts, np.concatenate([zero, scalars_raw], axis=1)))


def _power_pairs_finish(ops: CurveOps, handle):
    """Host half of _power_pairs_start: the two sums as host affine points."""
    s, sx = handle
    return ops.to_affine_host(s)[0], ops.to_affine_host(sx)[0]


def _power_pairs_device(ops: CurveOps, pts, scalars_raw: np.ndarray):
    """Both halves of the merge-pairs MSM in one call."""
    return _power_pairs_finish(ops, _power_pairs_start(ops, pts, scalars_raw))


SUBGROUP_BATCH_ROUNDS = 64
"""Soundness parameter of the batched subgroup check: the number of
independent random-subset rounds. Escape probability <= 2^-ROUNDS."""


def _batched_subgroup_sums(ops: CurveOps, pts: PointVec, bits_host: np.ndarray) -> PointVec:
    """ROUNDS random-subset sums of the point batch: sums[j] = sum over
    {i : bits[j, i]} of P_i, as a (L[, d], ROUNDS) point batch.

    All rounds run at once, one round per row of a (rounds, B) point array
    reduced by one tree reduction over its last axis: the same pairing order
    per round as the reference's sequential scan over rounds, so the same
    projective sums, in log2(B) batched additions instead of ROUNDS x
    log2(B) narrow ones."""
    dev = pts["x"].device
    bits = to_device(np.ascontiguousarray(bits_host, bool), dev)
    inf = ops.infinity((1, 1), dev)
    F = ops.field
    # lanes in slices of MAX_LANES (a power of two): the (rounds, B) array of
    # a 2^21-lane BW6-761 batch would take 77 GB at once. The tree adds
    # lanes 2i and 2i + 1, so reducing each slice and then the slices' sums
    # pairs the lanes as one reduction over the whole batch does.
    sums = ops.sum_reduce(lanes.cat([
        ops.sum_reduce(PointVec({k: F.select(bits[:, lo:hi], pts[k][..., lo:hi].unsqueeze(-2), inf[k])
                                 for k in "xyz"}))
        for lo, hi in lanes.spans(pts["x"].shape[-1])]))
    return PointVec({k: v[..., 0] for k, v in sums.items()})


def _check_subgroup_device(codec: BatchPointCodec, pts: PointVec, mode: SubgroupCheckMode, n: int) -> None:
    """Subgroup check of a batch whose points are already known nonzero.
    Direct: [r]P == O (or phi(P) == [e]P) per element. Auto: Direct up to
    2^12 elements, else Batched (accumulator.rs:109-119 crossover).

    Batched soundness (why one random linear combination is NOT enough):
    with P_i = S_i + T_i, S_i in the order-r subgroup and T_i in the
    cofactor group, a single combination sum t_i P_i escapes when
    sum t_i T_i = 0, which for a torsion component of small prime order l
    happens with probability 1/l however wide the t_i. So the check runs
    SUBGROUP_BATCH_ROUNDS independent random-subset rounds, and each
    subset sum gets the Direct check (r is coprime to the cofactor, so any
    surviving torsion component fails it): escape probability
    <= 2^-ROUNDS for every cofactor prime.

    The Direct check on the sums MUST NOT use the GLV ladder (only
    [k mod r]-correct inside the subgroup, the very property under test):
    codec.subgroup_mask uses the raw windowed ladder. Padding lanes
    beyond n hold infinity and add the identity to every subset sum."""
    _subgroup_finish(_subgroup_start(codec, pts, mode, n))


def _subgroup_start(codec: BatchPointCodec, pts, mode: SubgroupCheckMode, n: int):
    """Device half of _check_subgroup_device: the all-ok flag as a device
    tensor (no wait for the device), with the kind of check. On a batch cut
    over a mesh the Direct masks run per shard, and the subset sums are
    per-shard partial sums added across the shards."""
    if mode is SubgroupCheckMode.NO:
        return None
    batched = mode is SubgroupCheckMode.BATCHED or (mode is SubgroupCheckMode.AUTO and n > (1 << 12))
    ops = codec.ops
    if not batched:
        return ("direct", runtime.all_over(lambda p: codec.subgroup_mask(p) | ops.is_infinity(p), pts))
    pad = runtime.width(pts)
    rounds = SUBGROUP_BATCH_ROUNDS
    raw = np.frombuffer(secrets.token_bytes(rounds * pad), np.uint8)
    bits = (raw.reshape(rounds, pad) & 1).astype(bool)
    sums = runtime.reduce_over(ops, lambda p, b: _batched_subgroup_sums(ops, p, b), pts, bits)
    # an empty subset's sum is infinity, which the Direct mask accepts; a
    # sum that hit the formulas' exceptional case, (0 : 0 : 0), it rejects
    # (the reference's `| is_infinity(sums)` would accept it: Z = 0)
    ok = codec.subgroup_mask(sums)
    return ("batched", ok.all())


def _subgroup_finish(handle) -> None:
    """Host half of _subgroup_start: waits for the flag, raises on failure."""
    if handle is None:
        return
    kind, ok = handle
    if not bool(ok):
        if kind == "direct":
            raise IncorrectSubgroupError("element not in prime-order subgroup")
        raise IncorrectSubgroupError("batched subgroup check failed")


def _recode_section(
    parameters: Phase1Parameters,
    name: str,
    input_buf,
    s_in: Section,
    comp_in: UseCompression,
    output,
    s_out: Section,
    comp_out: UseCompression,
    check: CheckForCorrectness = CheckForCorrectness.NO,
    device=None,
) -> None:
    """Copy a section between buffers, re-coding its compression where the
    two differ (or checking it where asked), in device batches of at most
    RECODE_BATCH points: a section of a large ceremony never becomes one
    device array."""
    if s_in.num_elements == 0:
        return
    if comp_in is comp_out and check is CheckForCorrectness.NO:
        s_out.slice_of(output)[:] = s_in.slice_of(input_buf)
        return
    group = "g2" if name in ("tau_g2", "beta_g2") else "g1"
    codec = batch_codec(parameters.spec.name, group, device)
    n = s_in.num_elements
    B = min(n, RECODE_BATCH)
    # synchronous, as the reference's: the pipeline at depth 1
    with Pipeline(1, "recode_section") as pipe:
        for off in range(0, n, B):
            hi = min(off + B, n)
            pts = codec.read_batch(bytes(s_in.slice_of(input_buf, off, hi)), comp_in, check)
            _write_back(pipe, codec, pts, comp_out, s_out.slice_of(output, off, hi))


def _write_back(pipe: Pipeline, codec: BatchPointCodec, pts: PointVec, compression: UseCompression,
                dest) -> None:
    """Queue the write of an affine point batch into the buffer view `dest`
    on `pipe`."""
    handle = codec.write_batch_start(pts, normalized=True)

    def finish():
        dest[:] = codec.write_batch_finish(handle, compression)

    pipe.push(finish)
