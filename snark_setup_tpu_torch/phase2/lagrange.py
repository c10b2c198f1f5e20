"""Groth16Params — phase-1 powers → Lagrange coefficient form (prepare_phase2).

Reference: setup-utils/src/groth16_utils.rs. The four IFFTs over group
elements and the h-query elementwise subtraction are the hot loops
(groth16_utils.rs:44-63); they run on the chosen device (default: the card)
through ntt/group_fft.py. Wire format (SURVEY §2.9.3): [alpha_g1 ‖ beta_g1 ‖
beta_g2 ‖ coeffs_g1 ‖ coeffs_g2 ‖ alpha_coeffs_g1 ‖ beta_coeffs_g1 ‖ h_g1],
no length prefixes; vectors are `size` long except h (`size`−1).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves.constants import CurveSpec, get_curve
from ..curves.host import AffinePoint
from ..ntt.domain import Radix2Domain
from ..ntt.group_fft import group_fft, h_query_device
from ..ops.codec import batch_codec
from ..ops.curve import PointVec, curve_ops
from ..ops.lanes import cat, spans
from ..serialize.arkworks import g1_codec, g2_codec
from ..utils.device import resolve_device
from ..utils.enums import CheckForCorrectness, UseCompression
from ..utils.tracing import get_logger, info_span
from .vecio import Cursor, deser_element, deser_vec, ser_element, ser_vec

logger = get_logger("snark_setup_tpu_torch.phase2.lagrange")


def _check_lengths(m: int, tau_g1: int, tau_g2: int, alpha_g1: int, beta_g1: int) -> None:
    """The reference's slice-index panic, as an error."""
    if m > tau_g2 or 2 * m - 1 > tau_g1 or m > alpha_g1 or m > beta_g1:
        raise ValueError(f"phase2 domain size {m} exceeds phase-1 vector lengths")


@dataclass
class Groth16Params:
    spec: CurveSpec
    alpha_g1: AffinePoint
    beta_g1: AffinePoint
    beta_g2: AffinePoint
    coeffs_g1: list[AffinePoint]
    coeffs_g2: list[AffinePoint]
    alpha_coeffs_g1: list[AffinePoint]
    beta_coeffs_g1: list[AffinePoint]
    h_g1: list[AffinePoint]

    def __eq__(self, other):
        return (
            self.alpha_g1 == other.alpha_g1
            and self.beta_g1 == other.beta_g1
            and self.beta_g2 == other.beta_g2
            and self.coeffs_g1 == other.coeffs_g1
            and self.coeffs_g2 == other.coeffs_g2
            and self.alpha_coeffs_g1 == other.alpha_coeffs_g1
            and self.beta_coeffs_g1 == other.beta_coeffs_g1
            and self.h_g1 == other.h_g1
        )

    # ------------------------------------------------------------------
    @classmethod
    def new(
        cls,
        curve_name: str,
        phase2_size: int,
        tau_powers_g1: list[AffinePoint],
        tau_powers_g2: list[AffinePoint],
        alpha_tau_powers_g1: list[AffinePoint],
        beta_tau_powers_g1: list[AffinePoint],
        beta_g2: AffinePoint,
        device=None,
    ) -> "Groth16Params":
        """Four device IFFTs + the h-query (groth16_utils.rs:81-131).

        Raises if the (rounded-up) domain exceeds any input vector, like the
        reference's slice-index panic."""
        with info_span("groth16-params-new", logger):
            dev = resolve_device(device)
            spec = get_curve(curve_name)
            m = Radix2Domain(curve_name, phase2_size).size
            _check_lengths(m, len(tau_powers_g1), len(tau_powers_g2), len(alpha_tau_powers_g1),
                           len(beta_tau_powers_g1))
            g1, g2 = curve_ops(curve_name, "g1"), curve_ops(curve_name, "g2")
            f1, f2 = group_fft(curve_name, "g1", m), group_fft(curve_name, "g2", m)

            def ifft(ops, fft, pts):
                return ops.to_affine_host(fft.ifft(ops.from_affine_host(pts[:m], dev)))

            coeffs_g1 = ifft(g1, f1, tau_powers_g1)
            coeffs_g2 = ifft(g2, f2, tau_powers_g2)
            alpha_coeffs_g1 = ifft(g1, f1, alpha_tau_powers_g1)
            beta_coeffs_g1 = ifft(g1, f1, beta_tau_powers_g1)
            hq_in = g1.from_affine_host(tau_powers_g1[: 2 * m - 1], dev)
            h_g1 = g1.to_affine_host(h_query_device(g1, hq_in, m))
            return cls(spec, alpha_tau_powers_g1[0], beta_tau_powers_g1[0], beta_g2, coeffs_g1, coeffs_g2,
                       alpha_coeffs_g1, beta_coeffs_g1, h_g1)

    # ------------------------------------------------------------------
    def write(self, compression: UseCompression, device=None) -> bytes:
        """groth16_utils.rs:134-169 layout (write_elements_exact: no
        prefixes)."""
        spec = self.spec
        parts = [
            ser_element(spec, "g1", self.alpha_g1, compression),
            ser_element(spec, "g1", self.beta_g1, compression),
            ser_element(spec, "g2", self.beta_g2, compression),
            ser_vec(spec, "g1", self.coeffs_g1, compression, prefix=False, device=device),
            ser_vec(spec, "g2", self.coeffs_g2, compression, prefix=False, device=device),
            ser_vec(spec, "g1", self.alpha_coeffs_g1, compression, prefix=False, device=device),
            ser_vec(spec, "g1", self.beta_coeffs_g1, compression, prefix=False, device=device),
            ser_vec(spec, "g1", self.h_g1, compression, prefix=False, device=device),
        ]
        return b"".join(parts)

    @classmethod
    def read(
        cls,
        curve_name: str,
        data,
        compression: UseCompression,
        check: CheckForCorrectness,
        domain_size: int,
        phase1_size: int | None = None,
        device=None,
    ) -> "Groth16Params":
        """groth16_utils.rs:173-233: reads the first `domain_size`
        coefficients of a transcript holding `phase1_size` per section
        (equal when reading a transcript prepared at the same size)."""
        with info_span("groth16-params-read", logger):
            spec = get_curve(curve_name)
            if phase1_size is None:
                phase1_size = domain_size
            cur = Cursor(data)
            alpha_g1 = deser_element(spec, "g1", cur, compression, check)
            beta_g1 = deser_element(spec, "g1", cur, compression, check)
            beta_g2 = deser_element(spec, "g2", cur, compression, check)
            g1_size = g1_codec(spec).size(compression)
            g2_size = g2_codec(spec).size(compression)
            skip1 = (phase1_size - domain_size) * g1_size
            skip2 = (phase1_size - domain_size) * g2_size

            def vec(group, count):
                return deser_vec(spec, group, cur, compression, check, count=count, device=device)

            coeffs_g1 = vec("g1", domain_size)
            cur.skip(skip1)
            coeffs_g2 = vec("g2", domain_size)
            cur.skip(skip2)
            alpha_coeffs_g1 = vec("g1", domain_size)
            cur.skip(skip1)
            beta_coeffs_g1 = vec("g1", domain_size)
            cur.skip(skip1)
            h_g1 = vec("g1", domain_size - 1)
            return cls(spec, alpha_g1, beta_g1, beta_g2, coeffs_g1, coeffs_g2, alpha_coeffs_g1,
                       beta_coeffs_g1, h_g1)


def prepare_transcript_device(
    curve_name: str,
    phase2_size: int,
    response,
    parameters,
    compression_in: UseCompression = UseCompression.NO,
    check: CheckForCorrectness = CheckForCorrectness.NO,
    compression_out: UseCompression = UseCompression.NO,
    device=None,
) -> bytes:
    """Device-resident prepare_phase2: bytes -> device reads -> IFFTs and
    the h-query on the device -> writes, with no vector ever held as Python
    AffinePoint objects (its host footprint is the bytes and one batch of
    limb planes). Reads and writes go in slices of at most MAX_LANES points.

    Byte-identical to Groth16Params.new(...).write(compression_out).
    Reference: phase2-cli/src/prepare_phase2.rs:16-69,
    groth16_utils.rs:44-131."""
    from ..phase1.buffers import split as p1_split

    with info_span("prepare-phase2-device", logger):
        dev = resolve_device(device)
        spec = get_curve(curve_name)
        m = Radix2Domain(curve_name, phase2_size).size
        sec = p1_split(parameters, compression_in)
        _check_lengths(m, sec["tau_g1"].num_elements, sec["tau_g2"].num_elements,
                       sec["alpha_g1"].num_elements, sec["beta_g1"].num_elements)
        c1, c2 = batch_codec(curve_name, "g1", dev), batch_codec(curve_name, "g2", dev)
        hc1, hc2 = g1_codec(spec), g2_codec(spec)

        def read_dev(codec, s, count) -> PointVec:
            return cat([codec.read_batch(bytes(s.slice_of(response, lo, hi)), compression_in, check)
                        for lo, hi in spans(count)])

        def write_dev(codec, pts) -> bytes:
            return b"".join(codec.write_batch(PointVec({k: v[..., lo:hi] for k, v in pts.items()}),
                                              compression_out)
                            for lo, hi in spans(pts["x"].shape[-1]))

        def read_one(codec, s):
            return codec.deserialize(bytes(s.slice_of(response, 0, 1)), compression_in, check)

        f1, f2 = group_fft(curve_name, "g1", m), group_fft(curve_name, "g2", m)
        alpha_g1 = read_one(hc1, sec["alpha_g1"])
        beta_g1 = read_one(hc1, sec["beta_g1"])
        beta_g2 = read_one(hc2, sec["beta_g2"])

        tau1_full = read_dev(c1, sec["tau_g1"], 2 * m - 1)
        h_bytes = write_dev(c1, h_query_device(c1.ops, tau1_full, m))
        tau1_m = PointVec({k: v[..., :m] for k, v in tau1_full.items()})
        del tau1_full
        coeffs_g1 = write_dev(c1, f1.ifft(tau1_m))
        del tau1_m
        coeffs_g2 = write_dev(c2, f2.ifft(read_dev(c2, sec["tau_g2"], m)))
        alpha_coeffs = write_dev(c1, f1.ifft(read_dev(c1, sec["alpha_g1"], m)))
        beta_coeffs = write_dev(c1, f1.ifft(read_dev(c1, sec["beta_g1"], m)))
        return b"".join([
            hc1.serialize(alpha_g1, compression_out),
            hc1.serialize(beta_g1, compression_out),
            hc2.serialize(beta_g2, compression_out),
            coeffs_g1,
            coeffs_g2,
            alpha_coeffs,
            beta_coeffs,
            h_bytes,
        ])
