"""arkworks (ark-serialize 0.4) compatible wire encodings — host side.

This is the interop-critical layer (SURVEY.md §2.9): little-endian field
bytes with SWFlags packed into the top two bits of an element's final byte:

    bit 7: y-is-negative (y lexicographically largest)
    bit 6: point-at-infinity

Layouts (matching ark-ec 0.4 short_weierstrass serialization):
    compressed:   x with flags
    uncompressed: x plain || y with flags
    infinity:     zero coordinates, infinity flag set

Extension fields serialize c0 || c1 (|| c2), flags on the final coefficient's
last byte; lexicographic order compares the highest coefficient first.

Reference behavior cited from the reference's use sites:
setup-utils/src/io/{read,write}.rs, phase1/src/objects/parameters.rs:312-317
(size asserts), setup-utils/src/elements.rs (Validate policy).
"""

from __future__ import annotations

import functools

from ..curves.constants import CurveSpec
from ..curves.host import INFINITY, AffinePoint, HostCurve, g1_curve, g2_curve
from ..utils.enums import CheckForCorrectness, UseCompression
from ..utils.errors import (
    IncorrectSubgroupError,
    PointAtInfinityError,
    SerializationError,
)

FLAG_Y_NEG = 1 << 7
FLAG_INFINITY = 1 << 6


def _fp_to_bytes(v: int, nbytes: int) -> bytes:
    return int(v).to_bytes(nbytes, "little")


def _fp_from_bytes(b: bytes, p: int, mask_flags: bool):
    """Returns (value, flags). Raises SerializationError if value >= p."""
    raw = bytearray(b)
    flags = raw[-1] & (FLAG_Y_NEG | FLAG_INFINITY)
    if mask_flags:
        raw[-1] &= ~(FLAG_Y_NEG | FLAG_INFINITY) & 0xFF
    v = int.from_bytes(bytes(raw), "little")
    if v >= p:
        raise SerializationError(f"field element out of range")
    return v, flags


class PointCodec:
    """(De)serializer for one group of one curve."""

    def __init__(self, spec: CurveSpec, curve: HostCurve, ext_degree: int):
        self.spec = spec
        self.curve = curve
        self.ext_degree = ext_degree  # coords per field element (1, 2, or 3)
        self.fp_bytes = spec.fp_bytes
        self.compressed_size = ext_degree * self.fp_bytes
        self.uncompressed_size = 2 * self.compressed_size

    def size(self, compression: UseCompression) -> int:
        return (
            self.compressed_size
            if compression is UseCompression.YES
            else self.uncompressed_size
        )

    # -- coordinate helpers -----------------------------------------------
    def _coord_values(self, c) -> list[int]:
        if self.ext_degree == 1:
            return [c.v]
        return [x.v for x in c.coeffs]

    def _coord_from_values(self, vals):
        if self.ext_degree == 1:
            return self.spec.fp(vals[0])
        return self.spec.g2_field(tuple(vals))

    def _ser_coord(self, c, flags: int) -> bytes:
        vals = self._coord_values(c)
        out = b"".join(_fp_to_bytes(v, self.fp_bytes) for v in vals[:-1])
        last = bytearray(_fp_to_bytes(vals[-1], self.fp_bytes))
        last[-1] |= flags
        return out + bytes(last)

    def _deser_coord(self, b: bytes, with_flags: bool = True) -> tuple[object, int]:
        vals = []
        flags = 0
        for i in range(self.ext_degree):
            chunk = b[i * self.fp_bytes : (i + 1) * self.fp_bytes]
            mask = with_flags and i == self.ext_degree - 1
            v, f = _fp_from_bytes(chunk, self.spec.q, mask_flags=mask)
            if mask:
                flags = f
            vals.append(v)
        return self._coord_from_values(vals), flags

    # -- serialization -----------------------------------------------------
    def serialize(self, p: AffinePoint, compression: UseCompression) -> bytes:
        if p.is_infinity:
            zero = self._coord_from_values([0] * self.ext_degree)
            if compression is UseCompression.YES:
                return self._ser_coord(zero, FLAG_INFINITY)
            return self._ser_coord(zero, 0)[: self.compressed_size] + self._ser_coord(
                zero, FLAG_INFINITY
            )
        flags = FLAG_Y_NEG if p.y.is_geq_neg() else 0
        if compression is UseCompression.YES:
            return self._ser_coord(p.x, flags)
        return self._ser_coord(p.x, 0) + self._ser_coord(p.y, flags)

    # -- deserialization ---------------------------------------------------
    def deserialize(
        self,
        b: bytes,
        compression: UseCompression,
        check: CheckForCorrectness = CheckForCorrectness.NO,
    ) -> AffinePoint:
        p = self._parse(b, compression)
        self.validate(p, check)
        return p

    def _parse(self, b: bytes, compression: UseCompression) -> AffinePoint:
        if compression is UseCompression.YES:
            if len(b) != self.compressed_size:
                raise SerializationError(
                    f"expected {self.compressed_size} bytes, got {len(b)}"
                )
            x, flags = self._deser_coord(b)
            if flags & FLAG_INFINITY:
                if flags & FLAG_Y_NEG:
                    raise SerializationError("invalid flags (both set)")
                return INFINITY
            pt = self.curve.get_point_from_x(x, greatest=bool(flags & FLAG_Y_NEG))
            if pt is None:
                raise SerializationError("x not on curve")
            return pt
        if len(b) != self.uncompressed_size:
            raise SerializationError(
                f"expected {self.uncompressed_size} bytes, got {len(b)}"
            )
        x, _ = self._deser_coord(b[: self.compressed_size], with_flags=False)
        y, flags = self._deser_coord(b[self.compressed_size :])
        if flags & FLAG_INFINITY:
            if flags & FLAG_Y_NEG:
                raise SerializationError("invalid flags (both set)")
            return INFINITY
        return AffinePoint(x, y)

    def validate(self, p: AffinePoint, check: CheckForCorrectness) -> None:
        """Maps CheckForCorrectness to validation work (elements.rs:36-43 +
        read paths). ONLY_NON_ZERO rejects infinity; FULL/ONLY_IN_GROUP run
        on-curve + subgroup checks; FULL also rejects infinity."""
        if check is CheckForCorrectness.NO:
            return
        if check in (CheckForCorrectness.FULL, CheckForCorrectness.ONLY_NON_ZERO):
            if p.is_infinity:
                raise PointAtInfinityError("point at infinity")
        if check in (CheckForCorrectness.FULL, CheckForCorrectness.ONLY_IN_GROUP):
            if not p.is_infinity:
                if not self.curve.is_on_curve(p):
                    raise SerializationError("point not on curve")
                if not self.curve.in_subgroup(p):
                    raise IncorrectSubgroupError("point not in prime-order subgroup")

    # -- arkworks from_random_bytes (hash_to_g2's parser) ------------------
    def from_random_bytes(self, b: bytes) -> AffinePoint | None:
        """ark-ec 0.4 AffineRepr::from_random_bytes: parse compressed-size
        bytes with flags; rejects out-of-range coords and invalid flags;
        NOTE greatest := y_is_positive here (unlike deserialize)."""
        if len(b) != self.compressed_size:
            return None
        try:
            x, flags = self._deser_coord(b)
        except SerializationError:
            return None
        if flags & FLAG_Y_NEG and flags & FLAG_INFINITY:
            return None
        x_zero = all(v == 0 for v in self._coord_values(x))
        if x_zero and flags & FLAG_INFINITY:
            return INFINITY
        if flags & FLAG_INFINITY:
            return None
        y_is_positive = not (flags & FLAG_Y_NEG)
        return self.curve.get_point_from_x(x, greatest=y_is_positive)


_codec_cache: dict = {}


def _codecs(spec: CurveSpec):
    if spec.name not in _codec_cache:
        _codec_cache[spec.name] = (
            PointCodec(spec, g1_curve(spec), 1),
            PointCodec(spec, g2_curve(spec), spec.ext_degree),
        )
    return _codec_cache[spec.name]


def g1_codec(spec: CurveSpec) -> PointCodec:
    return _codecs(spec)[0]


def g2_codec(spec: CurveSpec) -> PointCodec:
    return _codecs(spec)[1]


def buffer_size(codec: PointCodec, compression: UseCompression) -> int:
    """Reference: setup-utils/src/io/mod.rs:13-15."""
    return codec.size(compression)


def serialize_fr(spec: CurveSpec, v: int) -> bytes:
    """Scalar field element, LE bytes, ceil(bits/8)."""
    nbytes = (spec.r.bit_length() + 7) // 8
    return int(v % spec.r).to_bytes(nbytes, "little")


def deserialize_fr(spec: CurveSpec, b: bytes) -> int:
    v = int.from_bytes(b, "little")
    if v >= spec.r:
        raise SerializationError("scalar out of range")
    return v


def write_to_file(path, data: bytes) -> None:
    """Reference: setup-utils/src/io/mod.rs:17-21 (incl. fsync)."""
    import os

    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
