"""Phase 1 protocol operations over raw byte buffers, on the card.

Buffer-oriented API mirroring the reference's `Phase1` static methods
(phase1/src/{initialization,computation}.rs): every operation takes
`&[u8]`-style buffers so the CLI can hand it mmaps and tests can hand it
bytearrays.

Ported so far: key generation, initialization and computation (contribute)
on every curve of the CLI (BLS12-377/381, BW6-761, MNT4-753, MNT6-753). The
hot loop of computation runs on the device: per batch, powers tau^i are
generated there (vectorized square-and-multiply over the exponent bits),
applied with the batched scalar-mul (the CUDA kernels of `ops/`), then
batch-normalized and recompressed there; only byte packing runs on the host.
Verification, aggregation, split and decompress are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..curves.host import g1_curve, g2_curve
from ..fields.limb import ints_to_limbs_batch
from ..ops.codec import BatchPointCodec, batch_codec
from ..serialize.arkworks import g1_codec, g2_codec
from ..shard import runtime
from ..utils.device import resolve_device
from ..utils.enums import (
    BatchExpMode,
    CheckForCorrectness,
    ContributionMode,
    ProvingSystem,
    UseCompression,
)
from ..utils.tracing import get_logger, info_span
from .buffers import Section, iter_chunk, split
from .keys import PrivateKey, key_generation
from .parameters import Phase1Parameters

logger = get_logger("snark_setup_tpu_torch.phase1")

def _chunk_rel(parameters: Phase1Parameters, start: int, end: int) -> tuple[int, int]:
    if parameters.contribution_mode is ContributionMode.CHUNKED:
        base = parameters.chunk_index * parameters.chunk_size
        return start - base, end - base
    return start, end


class Phase1:
    """Static protocol methods operating directly on buffers."""

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
        with info_span("phase1-computation", logger):
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
                """Read [sc,ec) of section, raise to powers, write the
                result back (a synchronous copy per batch; overlapping it with
                the next batch's work is left until the copy shows in the wall
                time). Powers come either from explicit host ints
                (exp_ints) or a device-generated tau^i range
                (exp_range=(start,end))."""
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
                section_out.slice_of(output, sc, ec)[:] = codec.write_batch(
                    prod, compressed_output, n_valid=n
                )

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
                        if parameters.contribution_mode is ContributionMode.CHUNKED:
                            mx = min(
                                (parameters.chunk_index + 1) * parameters.chunk_size,
                                parameters.powers_length,
                            )
                        else:
                            mx = parameters.powers_length
                        end2 = mx if start + parameters.batch_size > mx else end
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
